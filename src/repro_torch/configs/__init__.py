"""Graph-config registry: ``get_graph_config`` / ``list_graph_configs``."""
from __future__ import annotations

from repro_torch.configs import asymp_graphs
from repro_torch.configs.base import GraphConfig


def get_graph_config(name: str) -> GraphConfig:
    if name not in asymp_graphs.CONFIGS:
        raise KeyError(
            f"unknown graph config {name!r}; available: {sorted(asymp_graphs.CONFIGS)}")
    return asymp_graphs.CONFIGS[name]


def list_graph_configs() -> list[str]:
    return sorted(asymp_graphs.CONFIGS)


__all__ = ["GraphConfig", "get_graph_config", "list_graph_configs"]
