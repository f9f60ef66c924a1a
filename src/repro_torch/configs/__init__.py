"""Config registry: ``get_config(name)`` / ``list_archs()`` /
``get_graph_config`` (the counterpart of ``repro.configs``)."""
from __future__ import annotations

from repro_torch.configs import (
    asymp_graphs,
    chameleon_34b,
    chatglm3_6b,
    deepseek_v3,
    glm4_9b,
    granite_20b,
    hymba_1p5b,
    mamba2_780m,
    phi35_moe,
    qwen3_4b,
    whisper_medium,
)
from repro_torch.configs.base import SHAPES, GraphConfig, ModelConfig, ShapeConfig

_ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in [
        hymba_1p5b.CONFIG,
        phi35_moe.CONFIG,
        deepseek_v3.CONFIG,
        chatglm3_6b.CONFIG,
        granite_20b.CONFIG,
        glm4_9b.CONFIG,
        qwen3_4b.CONFIG,
        chameleon_34b.CONFIG,
        mamba2_780m.CONFIG,
        whisper_medium.CONFIG,
    ]
}

# Short aliases accepted by --arch.
_ALIASES = {
    "hymba": "hymba-1.5b",
    "phi3.5-moe": "phi3.5-moe-42b-a6.6b",
    "phi35-moe": "phi3.5-moe-42b-a6.6b",
    "deepseek-v3": "deepseek-v3-671b",
    "chatglm3": "chatglm3-6b",
    "granite": "granite-20b",
    "glm4": "glm4-9b",
    "qwen3": "qwen3-4b",
    "chameleon": "chameleon-34b",
    "mamba2": "mamba2-780m",
    "whisper": "whisper-medium",
}


def list_archs() -> list[str]:
    return sorted(_ARCHS)


def get_config(name: str) -> ModelConfig:
    name = _ALIASES.get(name, name)
    if name not in _ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {list_archs()}")
    return _ARCHS[name]


def get_graph_config(name: str) -> GraphConfig:
    if name not in asymp_graphs.CONFIGS:
        raise KeyError(
            f"unknown graph config {name!r}; available: {sorted(asymp_graphs.CONFIGS)}")
    return asymp_graphs.CONFIGS[name]


def list_graph_configs() -> list[str]:
    return sorted(asymp_graphs.CONFIGS)


__all__ = [
    "ModelConfig", "GraphConfig", "ShapeConfig", "SHAPES",
    "get_config", "list_archs", "get_graph_config", "list_graph_configs",
]
