"""Decoder-LM assembly, the dense stack (the counterpart of
``repro.models.transformer``).

A :class:`ModelPlan` (static, derived from the config) describes the
layer stacks.  The reference runs a stack of >= ``MIN_SCAN`` layers
under ``lax.scan`` over parameters and caches stacked along a leading
layer dim; the port runs every stack as a loop over :class:`Block`
modules, and keeps the reference's cache layout (``StackPlan.scan``: one
:class:`LayerCache` of ``[L, ...]`` tensors, else a tuple of per-layer
caches) so caches cross between the packages as they are.
:func:`params_from_numpy` carries the reference's parameter tree, stacked
or per layer, into the port's modules.

Only the dense family is ported (``family`` "dense" or "vlm" with no
MoE, SSM, MLA, encoder-decoder, sliding-window or MTP flag);
:func:`build_plan` raises ``NotImplementedError`` for the others, naming
the ROADMAP slice that ports them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import (apply_mlp, init_embedding, init_mlp,
                                       init_norm, mk, rms_norm)

MIN_SCAN = 8


# ======================================================================
# Plan
# ======================================================================
@dataclass(frozen=True)
class StackPlan:
    kind: str  # dense
    n: int
    scan: bool  # parameters and caches stacked along a leading layer dim
    d_ff: int


@dataclass(frozen=True)
class ModelPlan:
    stacks: tuple


def _unported(cfg: ModelConfig) -> Optional[str]:
    """What of ``cfg`` this package does not run yet, and the slice of
    ROADMAP queue 1 item 14 that ports it."""
    if cfg.encdec:
        return "encoder-decoder waits for item 14 slice 5"
    if cfg.use_mla or cfg.mtp_depth:
        return "MLA and MTP wait for item 14 slice 4"
    if cfg.is_moe:
        return "MoE waits for item 14 slice 2"
    if cfg.family in ("ssm", "hybrid") or cfg.attn_type == "swa":
        return "SSM, hybrid and sliding-window attention wait for item 14 slice 3"
    return None


def build_plan(cfg: ModelConfig) -> ModelPlan:
    missing = _unported(cfg)
    if missing:
        raise NotImplementedError(f"{cfg.name}: {missing} (ROADMAP.md)")
    L = cfg.num_layers
    return ModelPlan((StackPlan("dense", L, L >= MIN_SCAN, cfg.d_ff),))


# ======================================================================
# Per-layer cache container
# ======================================================================
class LayerCache(NamedTuple):
    kv: Any  # KVCache | None
    ssm: Any  # None until the SSM slice


def init_layer_cache(cfg: ModelConfig, batch: int, s_max: int,
                     device=None) -> LayerCache:
    return LayerCache(attn_mod.init_kv_cache(cfg, batch, s_max, device), None)


def init_cache(cfg: ModelConfig, batch: int, s_max: int,
               device: DeviceLike = None):
    """Full-model cache: one entry per stack (``[L, ...]`` tensors for a
    scan stack, as the reference's)."""
    dev = resolve_device(device)
    caches = []
    for sp in build_plan(cfg).stacks:
        if sp.scan:
            per = init_layer_cache(cfg, batch, s_max, dev)
            caches.append(LayerCache(attn_mod.KVCache(
                *(t.expand((sp.n,) + t.shape).clone() for t in per.kv)),
                None))
        else:
            caches.append(tuple(init_layer_cache(cfg, batch, s_max, dev)
                                for _ in range(sp.n)))
    return tuple(caches)


# ======================================================================
# Modules
# ======================================================================
def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Block(nn.Module):
    """One dense decoder layer: pre-norm attention, then the MLP, each
    added to the residual stream."""

    def __init__(self, norm1: torch.Tensor, attn: dict, norm2: torch.Tensor,
                 mlp: dict):
        super().__init__()
        self.norm1 = _frozen(norm1)
        self.attn = nn.ParameterDict({k: _frozen(v) for k, v in attn.items()})
        self.norm2 = _frozen(norm2)
        self.mlp = nn.ParameterDict({k: _frozen(v) for k, v in mlp.items()})


class LM(nn.Module):
    """The decoder LM: embedding, stacks of :class:`Block`, final norm
    and the head (the embedding's transpose when tied)."""

    def __init__(self, cfg: ModelConfig, embed: torch.Tensor,
                 final_norm: torch.Tensor, stacks: list[list[Block]],
                 head: Optional[torch.Tensor] = None):
        super().__init__()
        self.cfg = cfg
        self.embed = _frozen(embed)
        self.final_norm = _frozen(final_norm)
        self.stacks = nn.ModuleList(nn.ModuleList(s) for s in stacks)
        self.head = None if head is None else _frozen(head)

    def forward(self, tokens, positions=None, mode: str = "train",
                caches=None, compute_logits: bool = True):
        return forward(self, self.cfg, tokens, positions, mode, caches,
                       compute_logits)


def init_block(gen: torch.Generator, cfg: ModelConfig, d_ff: int,
               device=None) -> Block:
    d = cfg.d_model
    return Block(init_norm(d, device),
                 attn_mod.init_attention(gen, cfg, device),
                 init_norm(d, device),
                 init_mlp(gen, d, d_ff, cfg.gated_mlp, device))


def init_lm(cfg: ModelConfig, seed: int = 0,
            device: DeviceLike = None) -> LM:
    """Random weights from a ``torch.Generator`` seeded with ``seed``,
    drawn on ``device`` (``"meta"`` builds the shapes and allocates
    nothing)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev if dev.type == "cuda" else "cpu")
    gen.manual_seed(seed)
    plan = build_plan(cfg)
    embed = init_embedding(gen, cfg.vocab_size, cfg.d_model, dev)
    stacks = [[init_block(gen, cfg, sp.d_ff, dev) for _ in range(sp.n)]
              for sp in plan.stacks]
    head = None
    if not cfg.tie_embeddings:
        head = mk(gen, (cfg.d_model, cfg.vocab_size), scale=0.02, device=dev)
    return LM(cfg, embed, init_norm(cfg.d_model, dev), stacks, head)


def _tensor(a) -> torch.Tensor:
    """A numpy array as a tensor; a bfloat16 array (``ml_dtypes``, which
    ``torch.from_numpy`` refuses) crosses as its uint16 bits."""
    if torch.is_tensor(a):
        return a
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # torch.from_numpy shares the buffer
        a = a.copy()
    if a.dtype.kind == "V" or str(a.dtype) == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(cfg: ModelConfig, tree: dict,
                      device: DeviceLike = None) -> LM:
    """The reference's value tree (``split_params(init_lm(key, cfg))[0]``
    as numpy arrays) as the port's :class:`LM` on ``device``: a scan
    stack's ``[L, ...]`` leaves are split into ``L`` blocks, a tuple
    stack is taken layer by layer."""
    dev = resolve_device(device)

    def t(a) -> torch.Tensor:
        return _tensor(a).to(dev)

    def block(layer: dict) -> Block:
        return Block(t(layer["norm1"]),
                     {k: t(v) for k, v in layer["attn"].items()},
                     t(layer["norm2"]),
                     {k: t(v) for k, v in layer["mlp"].items()})

    def layer_of(stack: dict, i: int) -> dict:
        return {k: layer_of(v, i) if isinstance(v, dict) else v[i]
                for k, v in stack.items()}

    stacks = []
    for sp, stack in zip(build_plan(cfg).stacks, tree["stacks"]):
        layers = ([layer_of(stack, i) for i in range(sp.n)] if sp.scan
                  else list(stack))
        stacks.append([block(layer) for layer in layers])
    head = t(tree["head"]) if "head" in tree else None
    return LM(cfg, t(tree["embed"]), t(tree["final_norm"]), stacks, head)


# ======================================================================
# Apply
# ======================================================================
def apply_block(p: Block, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, mode: str,
                cache: LayerCache) -> tuple[torch.Tensor, LayerCache]:
    h = rms_norm(x, p.norm1, cfg.norm_eps)
    a_out, new_kv = attn_mod.attention_layer(p.attn, cfg, h, positions,
                                             cache=cache.kv, mode=mode)
    x = x + a_out
    y = apply_mlp(p.mlp, rms_norm(x, p.norm2, cfg.norm_eps), cfg.act)
    return x + y, LayerCache(new_kv, cache.ssm)


def apply_stacks(params: LM, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor, mode: str, caches):
    """Run all stacks. caches: the tree from init_cache (or None)."""
    plan = build_plan(cfg)
    new_caches = []
    for si, (sp, blocks) in enumerate(zip(plan.stacks, params.stacks)):
        cache_s = caches[si] if caches is not None else None
        if cache_s is None:
            for blk in blocks:
                x, _ = apply_block(blk, cfg, x, positions, mode,
                                   LayerCache(None, None))
            new_caches.append(None)
        elif sp.scan:  # layer li's cache is row li of the stacked tensors
            k, v, pos = cache_s.kv
            new_pos = []
            for li, blk in enumerate(blocks):
                cl = LayerCache(attn_mod.KVCache(k[li], v[li], pos[li]), None)
                x, nc = apply_block(blk, cfg, x, positions, mode, cl)
                new_pos.append(nc.kv.pos)  # K/V were written in place
            new_caches.append(LayerCache(
                attn_mod.KVCache(k, v, torch.stack(new_pos)), cache_s.ssm))
        else:
            ncs = []
            for blk, cl in zip(blocks, cache_s):
                x, nc = apply_block(blk, cfg, x, positions, mode, cl)
                ncs.append(nc)
            new_caches.append(tuple(ncs))
    return x, tuple(new_caches)


def embed_tokens(params: LM, cfg: ModelConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens, params.embed)


def lm_logits(params: LM, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    head = params.embed.T if cfg.tie_embeddings else params.head
    return x @ head


def forward(params: LM, cfg: ModelConfig, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None, mode: str = "train",
            caches=None, compute_logits: bool = True):
    """tokens [B,S] -> (logits [B,S,V], new_caches, aux_loss, hidden);
    ``aux_loss`` is 0 (the dense stack has no router loss)."""
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    x = embed_tokens(params, cfg, tokens)
    x, new_caches = apply_stacks(params, cfg, x, positions, mode, caches)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if not compute_logits:
        return None, new_caches, aux, x
    return lm_logits(params, cfg, x), new_caches, aux, x
