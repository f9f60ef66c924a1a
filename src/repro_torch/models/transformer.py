"""Decoder-LM assembly: the dense, MoE, SSM and hybrid stacks (the
counterpart of ``repro.models.transformer``).

A :class:`ModelPlan` (static, derived from the config) describes the
layer stacks.  The reference runs a stack of >= ``MIN_SCAN`` layers
under ``lax.scan`` over parameters and caches stacked along a leading
layer dim; the port runs every stack as a loop over its layers, and
keeps the reference's layouts (``StackPlan.scan``): a scan stack is one
:class:`StackedBlocks` whose parameters are ``[L, ...]`` tensors and one
:class:`LayerCache` of ``[L, ...]`` tensors, any other stack a list of
:class:`Block` modules and a tuple of per-layer caches.  So
``param_dict`` has the reference's leaves, the optimizer's per-leaf rules
(weight decay on ``ndim >= 2``, Adafactor's factoring, int8 scales) see
the shapes the reference's see, and parameters, moments and caches cross
between the packages as they are (:func:`params_from_numpy`,
:func:`params_to_numpy`, :func:`to_tree`, :func:`from_tree`).

Training: :func:`lm_loss` (the chunked loss over the final norm's output)
and :func:`_remat_wrap` (``cfg.remat``: ``"full"`` recomputes a whole
block in the backward, ``"dots"`` keeps the no-batch-dim products, i.e.
``aten.mm``, and recomputes the rest, ``bmm`` included).

Grad mode: :func:`init_lm` and :func:`params_from_numpy` give frozen
weights (``requires_grad=False``), so a forward builds no autograd
graph; the train step (``train/trainer.py``) unfreezes the model it
trains.  The serving steps (``serve/engine.py``) run under
``torch.no_grad()``, so a model the trainer has unfrozen still serves
without a graph.

The families: dense (every layer sliding-window when
``attn_type == "swa"``); MoE (an optional stack of ``first_k_dense``
dense layers, then a stack of MoE layers whose block runs
``models/moe.py``; the router's aux loss is summed over the layers into
``forward``'s and ``lm_loss``'s ``aux``; deepseek-v3's layers run MLA,
``models/attention.py``, and its MTP head, :class:`MTP`, adds the
loss of the token after next to ``lm_loss``); SSM (mamba2: one stack of SSD
blocks, ``models/ssm.py``, no attention and no KV cache); hybrid (hymba:
attention and SSD heads in parallel in each block, global attention in
layers 0, L/2 and L-1 and a sliding window elsewhere, so the stack is
never stacked: its layers' caches differ in length).  :func:`param_axes`
gives the reference's logical-axes tree (``split_params(init_lm(...))[1]``),
which ``dist/sharding.py::ShardingRules`` resolves and the optimizers'
``state_axes`` map.  The encoder-decoder (whisper) is ``models/encdec.py``.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (apply_mlp, chunked_softmax_xent,
                                       init_embedding, init_mlp, init_norm,
                                       mk, rms_norm)

MIN_SCAN = 8


# ======================================================================
# Plan
# ======================================================================
@dataclass(frozen=True)
class StackPlan:
    kind: str  # dense | moe | ssm | hybrid
    n: int
    windows: tuple  # per-layer sliding window (0 = global); len == n
    scan: bool  # parameters and caches stacked along a leading layer dim
    d_ff: int


@dataclass(frozen=True)
class ModelPlan:
    stacks: tuple


def build_plan(cfg: ModelConfig) -> ModelPlan:
    L = cfg.num_layers
    if cfg.family == "ssm":
        return ModelPlan((StackPlan("ssm", L, (0,) * L, L >= MIN_SCAN, 0),))
    if cfg.family == "hybrid":
        # global attention on the first, middle and last layer, SWA elsewhere
        glob = {0, L // 2, L - 1}
        wins = tuple(0 if i in glob else cfg.sliding_window for i in range(L))
        return ModelPlan((StackPlan("hybrid", L, wins, False, cfg.d_ff),))
    if cfg.is_moe:
        stacks = []
        if cfg.first_k_dense:
            k = cfg.first_k_dense
            stacks.append(StackPlan("dense", k, (0,) * k, False,
                                    cfg.dense_d_ff or cfg.d_ff))
        m = L - cfg.first_k_dense
        stacks.append(StackPlan("moe", m, (0,) * m, m >= MIN_SCAN, cfg.d_ff))
        return ModelPlan(tuple(stacks))
    wins = (cfg.sliding_window,) * L if cfg.attn_type == "swa" else (0,) * L
    return ModelPlan((StackPlan("dense", L, wins, L >= MIN_SCAN, cfg.d_ff),))


# ======================================================================
# Per-layer cache container
# ======================================================================
class LayerCache(NamedTuple):
    kv: Any  # KVCache | None
    ssm: Any  # SSMCache | None


def init_layer_cache(cfg: ModelConfig, kind: str, batch: int, s_max: int,
                     window: int, device=None) -> LayerCache:
    """A layer's cache: a KV cache for attention (``min(s_max, window)``
    positions under a window), an SSM cache for the SSD."""
    kv = s = None
    if kind in ("dense", "moe", "hybrid"):
        kv = attn_mod.init_kv_cache(cfg, batch, s_max, device, window)
    if kind in ("ssm", "hybrid"):
        s = ssm_mod.init_ssm_cache(cfg, batch, device)
    return LayerCache(kv, s)


def _stack_cache(per: LayerCache, n: int) -> LayerCache:
    """``n`` copies of a layer's cache as ``[n, ...]`` tensors."""
    def stacked(c):
        return None if c is None else type(c)(
            *(None if t is None else t.expand((n,) + t.shape).clone()
              for t in c))
    return LayerCache(stacked(per.kv), stacked(per.ssm))


def init_cache(cfg: ModelConfig, batch: int, s_max: int,
               device: DeviceLike = None):
    """Full-model cache: one entry per stack (``[L, ...]`` tensors for a
    scan stack, as the reference's)."""
    dev = resolve_device(device)
    caches = []
    for sp in build_plan(cfg).stacks:
        if sp.scan:
            caches.append(_stack_cache(init_layer_cache(
                cfg, sp.kind, batch, s_max, sp.windows[0], dev), sp.n))
        else:
            caches.append(tuple(init_layer_cache(cfg, sp.kind, batch, s_max,
                                                 w, dev)
                                for w in sp.windows))
    return tuple(caches)


def _layer_cache_axes(cfg: ModelConfig, kind: str, stacked: bool,
                      slots: bool = False) -> LayerCache:
    """The logical axes of :func:`init_layer_cache`'s tree (``[L, ...]``
    leaves lead with ``None`` when ``stacked``): the reference's.  A
    ``pos`` is 0-d as ``init_kv_cache`` makes it; ``slots`` gives the
    slot server's ``[num_slots]`` position a row (``serve/engine.py``,
    the port's repair of the reference's shared position) ``("batch",)``."""
    pre = (None,) if stacked else ()
    pos = pre + (("batch",) if slots else ())
    kv = s = None
    if kind in ("dense", "moe", "hybrid"):
        if cfg.use_mla:
            kv = attn_mod.KVCache(pre + ("batch", "kv_seq", None), None, pos)
        else:
            kv = attn_mod.KVCache(pre + ("batch", "kv_seq", "kv_heads", None),
                                  pre + ("batch", "kv_seq", "kv_heads", None),
                                  pos)
    if kind in ("ssm", "hybrid"):
        s = ssm_mod.SSMCache(pre + ("batch", "ssm_heads", None, None),
                             pre + ("batch", None, "ssm_inner"))
    return LayerCache(kv, s)


def cache_axes(cfg: ModelConfig, slots: bool = False):
    """The logical axes of :func:`init_cache`'s tree, for
    ``dist/sharding.py::ShardingRules`` (``slots``: see
    :func:`_layer_cache_axes`)."""
    out = []
    for sp in build_plan(cfg).stacks:
        if sp.scan:
            out.append(_layer_cache_axes(cfg, sp.kind, True, slots))
        else:
            out.append(tuple(_layer_cache_axes(cfg, sp.kind, False, slots)
                             for _ in range(sp.n)))
    return tuple(out)


# ======================================================================
# Modules
# ======================================================================
def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


_BLOCK_LEAVES = ("norm1", "attn", "norm2", "mlp", "moe", "ssm", "norm_attn",
                 "norm_ssm")


class Block(nn.Module):
    """One decoder layer, its kind given by the leaves it holds (the
    reference's block dicts): dense ``norm1, attn, norm2, mlp``; MoE
    ``moe`` instead of ``mlp``; SSM ``norm1, ssm``; hybrid ``norm1, attn,
    norm2, ssm, norm_attn, norm_ssm, mlp``.  A leaf the kind lacks is
    ``None``."""

    def __init__(self, norm1: torch.Tensor, attn: Optional[dict] = None,
                 norm2: Optional[torch.Tensor] = None,
                 mlp: Optional[dict] = None, moe: Optional[dict] = None,
                 ssm: Optional[dict] = None,
                 norm_attn: Optional[torch.Tensor] = None,
                 norm_ssm: Optional[torch.Tensor] = None):
        super().__init__()
        given = dict(norm1=norm1, attn=attn, norm2=norm2, mlp=mlp, moe=moe,
                     ssm=ssm, norm_attn=norm_attn, norm_ssm=norm_ssm)
        for name in _BLOCK_LEAVES:
            val = given[name]
            if val is None:
                setattr(self, name, None)
            elif isinstance(val, dict):
                setattr(self, name, nn.ParameterDict(
                    {k: _frozen(v) for k, v in val.items()}))
            else:
                setattr(self, name, _frozen(val))


class LayerParams(NamedTuple):
    """One layer of a :class:`StackedBlocks`: views of its ``[L, ...]``
    parameters, with a :class:`Block`'s attribute names."""
    norm1: torch.Tensor
    attn: Optional[dict]
    norm2: Optional[torch.Tensor]
    mlp: Optional[dict]
    moe: Optional[dict]
    ssm: Optional[dict]
    norm_attn: Optional[torch.Tensor]
    norm_ssm: Optional[torch.Tensor]


class StackedBlocks(Block):
    """A scan stack's layers, every parameter ``[L, ...]`` as in the
    reference's stacked tree.  Indexing or iterating gives
    :class:`LayerParams` views; each leaf is split with one ``unbind``, so
    the backward stacks that leaf's per-layer gradients once (indexing
    layer by layer would scatter each into a zero tensor of the whole
    leaf)."""

    def __len__(self) -> int:
        return self.norm1.shape[0]

    def layers(self) -> list[LayerParams]:
        def split(leaf):
            if leaf is None:
                return None
            if isinstance(leaf, nn.ParameterDict):
                return {k: v.unbind(0) for k, v in leaf.items()}
            return leaf.unbind(0)

        def pick(parts, i):
            if parts is None:
                return None
            if isinstance(parts, dict):
                return {k: v[i] for k, v in parts.items()}
            return parts[i]
        parts = [split(getattr(self, name)) for name in _BLOCK_LEAVES]
        return [LayerParams(*(pick(x, i) for x in parts))
                for i in range(len(self))]

    def __iter__(self):
        return iter(self.layers())

    def __getitem__(self, i: int) -> LayerParams:
        return self.layers()[i]


def stack_layers(layers, n: int) -> dict:
    """``n`` per-layer parameter dicts (leaves and dicts of leaves), taken
    one at a time from the iterable ``layers``, copied into ``[n, ...]``
    leaves (no second copy of the stack is ever live)."""
    stacked = None
    for i, layer in enumerate(layers):
        if stacked is None:
            stacked = _map_tree(lambda t: t.new_empty((n,) + t.shape), layer)
        for key, val in layer.items():
            if isinstance(val, dict):
                for k, v in val.items():
                    stacked[key][k][i].copy_(v)
            else:
                stacked[key][i].copy_(val)
    return stacked


def _stacked(layers, n: int) -> StackedBlocks:
    """A scan stack of ``n`` layers (``norm1``, ``attn``, ``norm2``,
    ``mlp`` or ``moe``): :func:`stack_layers` as a :class:`StackedBlocks`."""
    return StackedBlocks(**stack_layers(layers, n))


class MTP(nn.Module):
    """deepseek's multi-token-prediction head (depth 1): ``proj [2d, d]``
    of the normed hidden state beside the next token's embedding, its
    ``norm``, and one dense ``block`` (MLA attention, ``dense_d_ff``)."""

    def __init__(self, proj: torch.Tensor, norm: torch.Tensor, block: dict):
        super().__init__()
        self.proj = _frozen(proj)
        self.norm = _frozen(norm)
        self.block = Block(**block)


class LM(nn.Module):
    """The decoder LM: embedding, stacks of layers (a list of
    :class:`Block` or one :class:`StackedBlocks`), final norm, the head
    (the embedding's transpose when tied) and, for ``cfg.mtp_depth``, the
    :class:`MTP` head."""

    def __init__(self, cfg: ModelConfig, embed: torch.Tensor,
                 final_norm: torch.Tensor, stacks: list,
                 head: Optional[torch.Tensor] = None,
                 mtp: Optional[dict] = None):
        super().__init__()
        self.cfg = cfg
        self.embed = _frozen(embed)
        self.final_norm = _frozen(final_norm)
        self.stacks = nn.ModuleList(
            s if isinstance(s, StackedBlocks) else nn.ModuleList(s)
            for s in stacks)
        self.head = None if head is None else _frozen(head)
        self.mtp = None if mtp is None else MTP(**mtp)

    def forward(self, tokens, positions=None, mode: str = "train",
                caches=None, compute_logits: bool = True):
        return forward(self, self.cfg, tokens, positions, mode, caches,
                       compute_logits)


def _init_layer(gen: torch.Generator, cfg: ModelConfig, kind: str,
                d_ff: int, device=None) -> dict:
    d = cfg.d_model
    layer = {"norm1": init_norm(d, device)}
    if kind == "ssm":
        layer["ssm"] = ssm_mod.init_ssm(gen, cfg, device)
        return layer
    layer["attn"] = attn_mod.init_attention(gen, cfg, device)
    layer["norm2"] = init_norm(d, device)
    if kind == "moe":
        layer["moe"] = moe_mod.init_moe(gen, cfg, device)
    elif kind == "hybrid":
        layer["ssm"] = ssm_mod.init_ssm(gen, cfg, device)
        layer["norm_attn"] = init_norm(d, device)
        layer["norm_ssm"] = init_norm(d, device)
        layer["mlp"] = init_mlp(gen, d, d_ff, cfg.gated_mlp, device)
    else:
        layer["mlp"] = init_mlp(gen, d, d_ff, cfg.gated_mlp, device)
    return layer


def init_block(cfg: ModelConfig, kind: str, d_ff: int, seed: int = 0,
               device: DeviceLike = None) -> Block:
    """One layer of ``kind`` outside any stack (frozen weights from
    ``seed``, ``"meta"`` allocating nothing), the leaves
    :func:`_block_axes` names: what the roofline's probes and the card's
    per-layer timings run."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev if dev.type == "cuda" else "cpu")
    gen.manual_seed(seed)
    return Block(**_init_layer(gen, cfg, kind, d_ff, dev))


def init_lm(cfg: ModelConfig, seed: int = 0,
            device: DeviceLike = None) -> LM:
    """Random frozen weights from a ``torch.Generator`` seeded with
    ``seed``, drawn on ``device`` layer by layer (``"meta"`` builds the
    shapes and allocates nothing); a scan stack's layers are copied into
    its ``[L, ...]`` leaves as they are drawn."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev if dev.type == "cuda" else "cpu")
    gen.manual_seed(seed)
    plan = build_plan(cfg)
    embed = init_embedding(gen, cfg.vocab_size, cfg.d_model, dev)
    stacks = []
    for sp in plan.stacks:
        layers = (_init_layer(gen, cfg, sp.kind, sp.d_ff, dev)
                  for _ in range(sp.n))
        stacks.append(_stacked(layers, sp.n) if sp.scan
                      else [Block(**layer) for layer in layers])
    head = None
    if not cfg.tie_embeddings:
        head = mk(gen, (cfg.d_model, cfg.vocab_size), scale=0.02, device=dev)
    mtp = None
    if cfg.mtp_depth:
        d = cfg.d_model
        mtp = {"proj": mk(gen, (2 * d, d), device=dev),
               "norm": init_norm(d, dev),
               "block": _init_layer(gen, cfg, "dense",
                                    cfg.dense_d_ff or cfg.d_ff, dev)}
    return LM(cfg, embed, init_norm(cfg.d_model, dev), stacks, head, mtp)


def _tensor(a) -> torch.Tensor:
    """A numpy array as a tensor; a bfloat16 array (``ml_dtypes``, which
    ``torch.from_numpy`` refuses) crosses as its uint16 bits."""
    if torch.is_tensor(a):
        return a
    a = np.asarray(a)
    if not a.flags.c_contiguous:  # (ascontiguousarray would make 0-d 1-d)
        a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # torch.from_numpy shares the buffer
        a = a.copy()
    if a.dtype.kind == "V" or str(a.dtype) == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(cfg: ModelConfig, tree: dict,
                      device: DeviceLike = None) -> LM:
    """The reference's value tree (``split_params(init_lm(key, cfg))[0]``,
    numpy arrays or tensors) as the port's frozen :class:`LM` on
    ``device``: a scan stack's ``[L, ...]`` leaves become a
    :class:`StackedBlocks` as they are, a tuple stack a list of
    :class:`Block`."""
    dev = resolve_device(device)

    def t(a) -> torch.Tensor:
        return _tensor(a).to(dev)

    def layer(d: dict) -> dict:
        return {key: ({k: t(v) for k, v in val.items()}
                      if isinstance(val, dict) else t(val))
                for key, val in d.items()}

    stacks = []
    for sp, stack in zip(build_plan(cfg).stacks, tree["stacks"]):
        stacks.append(StackedBlocks(**layer(stack)) if sp.scan
                      else [Block(**layer(d)) for d in stack])
    head = t(tree["head"]) if "head" in tree else None
    mtp = None
    if "mtp" in tree:
        mtp = {"proj": t(tree["mtp"]["proj"]), "norm": t(tree["mtp"]["norm"]),
               "block": layer(tree["mtp"]["block"])}
    return LM(cfg, t(tree["embed"]), t(tree["final_norm"]), stacks, head,
              mtp)


def param_dict(model: LM) -> dict[str, torch.Tensor]:
    """The model's parameters by name, in the reference's leaf layout:
    the dict that the optimizer, the gradient compression and the train
    step walk (``"stacks.0.attn.w_q"`` is a scan stack's ``[L, ...]``
    leaf, ``"stacks.0.1.attn.w_q"`` layer 1's of a tuple stack)."""
    return dict(model.named_parameters())


def to_tree(named: dict) -> dict:
    """A dict keyed as :func:`param_dict` (parameters, gradients or
    moments) as the reference's value tree: nested dicts, with
    ``"stacks"`` and a tuple stack's layers as tuples."""
    root: dict = {}
    for name, x in named.items():
        node = root
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = x

    def tuples(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return tuple(tuples(node[str(i)]) for i in range(len(node)))
        return {k: tuples(v) for k, v in node.items()}
    return tuples(root)


def from_tree(tree: dict) -> dict:
    """Invert :func:`to_tree`: the reference's value tree (of tensors) as
    a dict keyed as :func:`param_dict`."""
    out = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}{k}.", v)
        elif isinstance(node, (tuple, list)):
            for i, v in enumerate(node):
                walk(f"{prefix}{i}.", v)
        else:
            out[prefix[:-1]] = node
    walk("", tree)
    return out


def _numpy(x: torch.Tensor) -> np.ndarray:
    """A host array of ``x``; bfloat16 as an ``ml_dtypes`` array (the
    dtype the JAX package's arrays have), imported only here."""
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        import ml_dtypes
        return x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return x.numpy()


def params_to_numpy(model: LM) -> dict:
    """The inverse of :func:`params_from_numpy`: the reference's value
    tree of host arrays (stacked ``[L, ...]`` leaves for a scan stack)."""
    return _map_tree(_numpy, to_tree(param_dict(model)))


def _block_axes(cfg: ModelConfig, kind: str) -> dict:
    """The logical axes of one layer's leaves, as the reference's ``mk``
    calls name them."""
    if kind == "ssm":
        return {"norm1": (None,), "ssm": ssm_mod.ssm_axes()}
    if cfg.use_mla:
        attn = {"q_down": ("fsdp", "lora"), "q_down_norm": (None,),
                "q_up": ("lora", "q_proj"), "kv_down": ("fsdp", "lora"),
                "kv_down_norm": (None,), "k_up": ("lora", "q_proj"),
                "v_up": ("lora", "q_proj"), "w_o": ("q_proj", "fsdp")}
    else:
        attn = {"w_q": ("fsdp", "q_proj"), "w_k": ("fsdp", "kv_proj"),
                "w_v": ("fsdp", "kv_proj"), "w_o": ("q_proj", "fsdp")}
        if cfg.qk_norm:
            attn.update(q_norm=(None,), k_norm=(None,))
    block = {"norm1": (None,), "attn": attn, "norm2": (None,)}
    if kind == "hybrid":
        block.update(ssm=ssm_mod.ssm_axes(), norm_attn=(None,),
                     norm_ssm=(None,))
    if kind == "moe":
        expert = ("experts", "fsdp", None)
        moe = {"router": (None, None), "w_in": expert, "w_gate": expert,
               "w_out": expert}
        if cfg.num_shared_experts:
            moe.update(shared_w_in=("fsdp", "mlp"),
                       shared_w_gate=("fsdp", "mlp"),
                       shared_w_out=("mlp", "fsdp"))
        block["moe"] = moe
    else:
        mlp = {"w_in": ("fsdp", "mlp"), "w_out": ("mlp", "fsdp")}
        if cfg.gated_mlp:
            mlp["w_gate"] = ("fsdp", "mlp")
        block["mlp"] = mlp
    return block


def param_axes(cfg: ModelConfig) -> dict:
    """The reference's logical-axes tree of the parameters
    (``split_params(init_lm(key, cfg))[1]``): nested dicts, ``"stacks"``
    and a tuple stack's layers as tuples, each leaf a tuple of logical
    axis names (``None``: replicated); a scan stack's leaves lead with
    ``None`` (the layer dim)."""
    def stacked(node):
        if isinstance(node, dict):
            return {k: stacked(v) for k, v in node.items()}
        return (None,) + node

    stacks = []
    for sp in build_plan(cfg).stacks:
        block = _block_axes(cfg, sp.kind)
        stacks.append(stacked(block) if sp.scan
                      else tuple(block for _ in range(sp.n)))
    tree = {"embed": ("vocab", "fsdp"), "final_norm": (None,),
            "stacks": tuple(stacks)}
    if not cfg.tie_embeddings:
        tree["head"] = ("fsdp", "vocab")
    if cfg.mtp_depth:
        tree["mtp"] = {"proj": ("fsdp", None), "norm": (None,),
                       "block": _block_axes(cfg, "dense")}
    return tree


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_map_tree(fn, v) for v in tree)
    return fn(tree)


# ======================================================================
# Apply
# ======================================================================
def apply_block(p, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, mode: str, cache: LayerCache,
                window: int = 0
                ) -> tuple[torch.Tensor, LayerCache, torch.Tensor]:
    """One layer; ``p`` is a :class:`Block` or a :class:`LayerParams`,
    ``window`` its attention's sliding window (0: global).  Returns (x,
    new_cache, aux_loss): the router's loss of an MoE layer, else 0."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rms_norm(x, p.norm1, cfg.norm_eps)
    if p.attn is None:  # ssm
        y, new_ssm = ssm_mod.apply_ssm(p.ssm, cfg, h, cache.ssm, mode)
        return x + y, LayerCache(cache.kv, new_ssm), aux
    a_out, new_kv = attn_mod.attention_layer(
        p.attn, cfg, h, positions, layer_window=window, cache=cache.kv,
        mode=mode)
    if p.ssm is not None:  # hybrid: attention and SSD heads in parallel
        s_out, new_ssm = ssm_mod.apply_ssm(p.ssm, cfg, h, cache.ssm, mode)
        y = (rms_norm(a_out, p.norm_attn, cfg.norm_eps)
             + rms_norm(s_out, p.norm_ssm, cfg.norm_eps)) * 0.5
        x = x + y
        x = x + apply_mlp(p.mlp, rms_norm(x, p.norm2, cfg.norm_eps), cfg.act)
        return x, LayerCache(new_kv, new_ssm), aux
    x = x + a_out
    h2 = rms_norm(x, p.norm2, cfg.norm_eps)
    if p.moe is not None:
        y, aux = moe_mod.apply_moe(p.moe, cfg, h2)
    else:
        y = apply_mlp(p.mlp, h2, cfg.act)
    return x + y, LayerCache(new_kv, cache.ssm), aux


def _save_mm(ctx, op, *args, **kwargs):
    """``"dots"``: keep the outputs of ``aten.mm`` (the products with no
    batch dim, as ``dots_with_no_batch_dims_saveable`` does), recompute
    every other op, ``bmm`` included."""
    if op == torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_wrap(fn, cfg: ModelConfig, mode: str):
    """``fn`` under ``cfg.remat`` in train mode: ``"full"`` checkpoints
    the whole call (only its inputs are saved), ``"dots"`` saves the
    ``aten.mm`` outputs (:func:`_save_mm`), ``"none"`` is ``fn``."""
    if mode != "train" or cfg.remat == "none":
        return fn
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_mm)
    return functools.partial(checkpoint, fn, use_reentrant=False, **kw)


def apply_stacks(params: LM, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor, mode: str, caches):
    """Run all stacks. caches: the tree from init_cache (or None).
    Returns (x, new_caches, aux_loss summed over the layers)."""
    plan = build_plan(cfg)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches = []
    for si, (sp, blocks) in enumerate(zip(plan.stacks, params.stacks)):
        cache_s = caches[si] if caches is not None else None
        if cache_s is None:
            def layer_fn(xc, pl, window):
                xo, _, aux = apply_block(pl, cfg, xc, positions, mode,
                                         LayerCache(None, None), window)
                return xo, aux
            layer_fn = _remat_wrap(layer_fn, cfg, mode)
            for blk, window in zip(blocks, sp.windows):
                x, aux = layer_fn(x, blk, window)
                aux_total = aux_total + aux
            new_caches.append(None)
        elif sp.scan:  # layer li's cache is row li of the stacked tensors
            kv, sc = cache_s
            new_pos = []
            for li, blk in enumerate(blocks):
                cl = LayerCache(
                    None if kv is None else attn_mod.KVCache(
                        kv.k[li], None if kv.v is None else kv.v[li],
                        kv.pos[li]),
                    None if sc is None else ssm_mod.SSMCache(
                        sc.state[li], sc.conv[li]))
                x, nc, aux = apply_block(blk, cfg, x, positions, mode, cl,
                                         sp.windows[li])
                aux_total = aux_total + aux
                if kv is not None:
                    new_pos.append(nc.kv.pos)  # K/V were written in place
                if sc is not None:  # the SSD returns new tensors
                    sc.state[li].copy_(nc.ssm.state)
                    sc.conv[li].copy_(nc.ssm.conv)
            new_caches.append(LayerCache(
                None if kv is None else kv._replace(
                    pos=torch.stack(new_pos)), sc))
        else:
            ncs = []
            for blk, cl, window in zip(blocks, cache_s, sp.windows):
                x, nc, aux = apply_block(blk, cfg, x, positions, mode, cl,
                                         window)
                aux_total = aux_total + aux
                ncs.append(nc)
            new_caches.append(tuple(ncs))
    return x, tuple(new_caches), aux_total


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
    ``aux_loss`` is the MoE layers' router loss summed (0 for a dense
    model)."""
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    x = embed_tokens(params, cfg, tokens)
    x, new_caches, aux = apply_stacks(params, cfg, x, positions, mode,
                                      caches)
    if not compute_logits:
        return None, new_caches, aux, x
    return lm_logits(params, cfg, x), new_caches, aux, x


# ======================================================================
# Training loss
# ======================================================================
MTP_WEIGHT = 0.3


def lm_loss(params: LM, cfg: ModelConfig, tokens: torch.Tensor,
            labels: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """``(total, {"nll", "aux", ["mtp",] "loss"})``: the chunked softmax
    cross-entropy of the final norm's output against ``labels`` plus the
    aux loss (the MoE layers' router loss; 0 for a dense model), plus
    ``MTP_WEIGHT`` times the MTP head's loss when the model has one: the
    token after next predicted from ``(rms_norm(hidden_t),
    embed(label_t))`` through its dense block (not rematerialised, as in
    the reference), against the labels shifted by one, the last
    repeated."""
    _, _, aux, hidden = forward(params, cfg, tokens, mode="train",
                                compute_logits=False)
    head = params.embed.T if cfg.tie_embeddings else params.head
    h_norm = rms_norm(hidden, params.final_norm, cfg.norm_eps)
    loss = chunked_softmax_xent(h_norm, head, labels)
    metrics = {"nll": loss, "aux": aux}
    total = loss + aux
    mp = params.mtp
    if cfg.mtp_depth and mp is not None:
        h = torch.cat([rms_norm(hidden, mp.norm, cfg.norm_eps),
                       embed_tokens(params, cfg, labels)], dim=-1) @ mp.proj
        B, S = tokens.shape
        positions = torch.arange(S, device=tokens.device)[None, :].expand(
            B, S)
        h, _, _ = apply_block(mp.block, cfg, h, positions, "train",
                              LayerCache(None, None))
        h = rms_norm(h, params.final_norm, cfg.norm_eps)
        mtp_labels = torch.cat([labels[:, 1:], labels[:, -1:]], dim=1)
        mtp_loss = chunked_softmax_xent(h, head, mtp_labels)
        metrics["mtp"] = mtp_loss
        total = total + MTP_WEIGHT * mtp_loss
    metrics["loss"] = total
    return total, metrics
