"""Whisper-style encoder-decoder backbone, the conv mel frontend stubbed
(the counterpart of ``repro.models.encdec``).

Encoder: bidirectional dense blocks over precomputed frame embeddings
(``features`` [B, enc_seq, D], what the two conv layers would produce),
the sinusoidal table added first.  Decoder: learned positions
(``dec_pos``), causal self-attention with a KV cache, cross-attention to
the encoder's output, the tied head (``embed.T``).  Cross-K/V are
computed once at prefill and carried in the cache.

:class:`EncDec` holds the reference's tree: ``embed``, ``dec_pos``,
``encoder`` and ``decoder`` (a :class:`Stack` each: every leaf ``[L,
...]``, as the reference's stacked scan parameters), ``enc_norm`` and
``final_norm``; ``transformer.param_dict``, ``to_tree`` and ``from_tree``
walk it as they walk an ``LM``, so the optimizer, the train step and
checkpoints take it as they are.  The cache is one :class:`DecLayerCache`
of ``[L, ...]`` tensors; prefill writes the self-attention K/V and the
cross K/V into it in place.  Decode reads its position from the cache's
stacked per-layer ``pos`` (a scalar for the batch, as ``generate``
keeps it, or one a row).

Training runs each encoder and decoder layer under ``cfg.remat`` as the
LM's stacks do (``transformer._remat_wrap``; whisper's config says
``"full"``): it moves no value, only what the backward keeps (at batch 8
the encoder's fp32 scores alone are 1.7 GB a layer).  The reference runs
its ``lax.scan`` without a checkpoint and leaves memory to XLA.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import transformer as T
from repro_torch.models.layers import (apply_mlp, chunked_softmax_xent,
                                       init_embedding, init_mlp, init_norm,
                                       mk, rms_norm, sinusoidal_positions)


class DecLayerCache(NamedTuple):
    kv_self: Any  # KVCache
    k_cross: Any  # [B, enc_seq, Hkv, hd]
    v_cross: Any


# ======================================================================
# Parameters
# ======================================================================
class Stack(nn.Module):
    """Layers stacked along a leading dim: each leaf ``[L, ...]`` (a dict
    of leaves a ``ParameterDict``), named as the reference's stacked
    tree.  :meth:`layers` splits every leaf with one ``unbind``, so the
    backward stacks each leaf's per-layer gradients once."""

    def __init__(self, leaves: dict):
        super().__init__()
        self._names = tuple(leaves)
        for name, val in leaves.items():
            if isinstance(val, dict):
                setattr(self, name, nn.ParameterDict(
                    {k: T._frozen(v) for k, v in val.items()}))
            else:
                setattr(self, name, T._frozen(val))

    def __len__(self) -> int:
        first = getattr(self, self._names[0])
        return (next(iter(first.values())) if isinstance(
            first, nn.ParameterDict) else first).shape[0]

    def layers(self) -> list[dict]:
        parts = {}
        for name in self._names:
            leaf = getattr(self, name)
            parts[name] = ({k: v.unbind(0) for k, v in leaf.items()}
                           if isinstance(leaf, nn.ParameterDict)
                           else leaf.unbind(0))
        return [{name: ({k: v[i] for k, v in part.items()}
                        if isinstance(part, dict) else part[i])
                 for name, part in parts.items()} for i in range(len(self))]


class EncDec(nn.Module):
    """The encoder-decoder: ``embed`` [V, D] (also the tied head),
    ``dec_pos`` [max_position, D], the ``encoder`` and ``decoder``
    :class:`Stack`, ``enc_norm`` and ``final_norm``."""

    def __init__(self, cfg: ModelConfig, embed: torch.Tensor,
                 dec_pos: torch.Tensor, encoder: dict,
                 enc_norm: torch.Tensor, decoder: dict,
                 final_norm: torch.Tensor):
        super().__init__()
        self.cfg = cfg
        self.embed = T._frozen(embed)
        self.dec_pos = T._frozen(dec_pos)
        self.encoder = Stack(encoder)
        self.enc_norm = T._frozen(enc_norm)
        self.decoder = Stack(decoder)
        self.final_norm = T._frozen(final_norm)


def _init_cross_attn(gen: torch.Generator, cfg: ModelConfig,
                     device=None) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    return {"w_q": mk(gen, (d, cfg.num_heads * hd), device=device),
            "w_k": mk(gen, (d, cfg.num_kv_heads * hd), device=device),
            "w_v": mk(gen, (d, cfg.num_kv_heads * hd), device=device),
            "w_o": mk(gen, (cfg.num_heads * hd, d), device=device)}


def _init_enc_layer(gen: torch.Generator, cfg: ModelConfig,
                    device=None) -> dict:
    d = cfg.d_model
    return {"norm1": init_norm(d, device),
            "attn": attn_mod.init_attention(gen, cfg, device),
            "norm2": init_norm(d, device),
            "mlp": init_mlp(gen, d, cfg.d_ff, cfg.gated_mlp, device)}


def _init_dec_layer(gen: torch.Generator, cfg: ModelConfig,
                    device=None) -> dict:
    d = cfg.d_model
    return {"norm1": init_norm(d, device),
            "attn": attn_mod.init_attention(gen, cfg, device),
            "norm_x": init_norm(d, device),
            "cross": _init_cross_attn(gen, cfg, device),
            "norm2": init_norm(d, device),
            "mlp": init_mlp(gen, d, cfg.d_ff, cfg.gated_mlp, device)}


def init_encdec(cfg: ModelConfig, seed: int = 0,
                device: DeviceLike = None) -> EncDec:
    """Random frozen weights from a ``torch.Generator`` seeded with
    ``seed``, drawn on ``device`` (``"meta"`` allocates nothing), each
    stack's layers copied into its ``[L, ...]`` leaves as they are
    drawn."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev if dev.type == "cuda" else "cpu")
    gen.manual_seed(seed)
    embed = init_embedding(gen, cfg.vocab_size, cfg.d_model, dev)
    dec_pos = mk(gen, (cfg.max_position, cfg.d_model), scale=0.02,
                 device=dev)
    encoder = T.stack_layers((_init_enc_layer(gen, cfg, dev)
                              for _ in range(cfg.enc_layers)),
                             cfg.enc_layers)
    decoder = T.stack_layers((_init_dec_layer(gen, cfg, dev)
                              for _ in range(cfg.num_layers)),
                             cfg.num_layers)
    return EncDec(cfg, embed, dec_pos, encoder, init_norm(cfg.d_model, dev),
                  decoder, init_norm(cfg.d_model, dev))


def params_from_numpy(cfg: ModelConfig, tree: dict,
                      device: DeviceLike = None) -> EncDec:
    """The reference's value tree (``split_params(init_encdec(key,
    cfg))[0]``, numpy arrays or tensors) as the port's frozen
    :class:`EncDec` on ``device``."""
    dev = resolve_device(device)
    t = lambda a: T._tensor(a).to(dev)  # noqa: E731

    def stack(d: dict) -> dict:
        return {k: ({kk: t(vv) for kk, vv in v.items()}
                    if isinstance(v, dict) else t(v)) for k, v in d.items()}
    return EncDec(cfg, t(tree["embed"]), t(tree["dec_pos"]),
                  stack(tree["encoder"]), t(tree["enc_norm"]),
                  stack(tree["decoder"]), t(tree["final_norm"]))


def params_to_numpy(model: EncDec) -> dict:
    """The inverse of :func:`params_from_numpy`: the reference's value
    tree of host arrays."""
    return T._map_tree(T._numpy, T.to_tree(T.param_dict(model)))


def param_axes(cfg: ModelConfig) -> dict:
    """The reference's logical-axes tree of the parameters
    (``split_params(init_encdec(key, cfg))[1]``); the stacks' leaves lead
    with ``None`` (the layer dim)."""
    attn = {"w_q": ("fsdp", "q_proj"), "w_k": ("fsdp", "kv_proj"),
            "w_v": ("fsdp", "kv_proj"), "w_o": ("q_proj", "fsdp")}
    self_attn = dict(attn)
    if cfg.qk_norm:
        self_attn.update(q_norm=(None,), k_norm=(None,))
    mlp = {"w_in": ("fsdp", "mlp"), "w_out": ("mlp", "fsdp")}
    if cfg.gated_mlp:
        mlp["w_gate"] = ("fsdp", "mlp")
    enc = {"norm1": (None,), "attn": self_attn, "norm2": (None,), "mlp": mlp}
    dec = {"norm1": (None,), "attn": self_attn, "norm_x": (None,),
           "cross": attn, "norm2": (None,), "mlp": mlp}

    def stacked(node):
        if isinstance(node, dict):
            return {k: stacked(v) for k, v in node.items()}
        return (None,) + node
    return {"embed": ("vocab", "fsdp"), "dec_pos": (None, "fsdp"),
            "encoder": stacked(enc), "enc_norm": (None,),
            "decoder": stacked(dec), "final_norm": (None,)}


# ======================================================================
# Apply
# ======================================================================
def _enc_layer(x: torch.Tensor, pl: dict, cfg: ModelConfig,
               positions: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, pl["norm1"], cfg.norm_eps)
    a, _ = attn_mod.attention_layer(pl["attn"], cfg, h, positions,
                                    mode="train", causal=False)
    x = x + a
    return x + apply_mlp(pl["mlp"], rms_norm(x, pl["norm2"], cfg.norm_eps),
                         cfg.act)


def encode(params: EncDec, cfg: ModelConfig, features: torch.Tensor,
           mode: str = "train") -> torch.Tensor:
    """features [B, enc_seq, D] (the stub frontend's output) -> the
    encoder's states [B, enc_seq, D]; ``mode="train"`` runs each layer
    under ``cfg.remat``."""
    B, S, D = features.shape
    x = features + sinusoidal_positions(S, D, features.device).to(
        features.dtype)[None]
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    layer = T._remat_wrap(_enc_layer, cfg, mode)
    for pl in params.encoder.layers():
        x = layer(x, pl, cfg, positions)
    return rms_norm(x, params.enc_norm, cfg.norm_eps)


def _dec_layer(pl: dict, cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor, enc_out: Optional[torch.Tensor],
               cache: Optional[DecLayerCache], mode: str):
    """One decoder layer.  ``enc_out`` is None when the cross K/V come
    from the cache (decode)."""
    h = rms_norm(x, pl["norm1"], cfg.norm_eps)
    a, new_kv = attn_mod.attention_layer(
        pl["attn"], cfg, h, positions,
        cache=cache.kv_self if cache is not None else None, mode=mode)
    x = x + a
    h = rms_norm(x, pl["norm_x"], cfg.norm_eps)
    if cache is not None and enc_out is None:
        kc, vc = cache.k_cross, cache.v_cross
    else:
        B, Se, _ = enc_out.shape
        shape = (B, Se, cfg.num_kv_heads, cfg.head_dim)
        kc = (enc_out @ pl["cross"]["w_k"]).reshape(shape)
        vc = (enc_out @ pl["cross"]["w_v"]).reshape(shape)
    c, _ = attn_mod.attention_layer(pl["cross"], cfg, h, positions,
                                    cross_kv=(kc, vc), mode="train")
    x = x + c
    x = x + apply_mlp(pl["mlp"], rms_norm(x, pl["norm2"], cfg.norm_eps),
                      cfg.act)
    new_cache = DecLayerCache(new_kv, kc, vc) if cache is not None else None
    return x, new_cache


def decode_stack(params: EncDec, cfg: ModelConfig, tokens: torch.Tensor,
                 positions: torch.Tensor, enc_out: Optional[torch.Tensor],
                 caches: Optional[DecLayerCache], mode: str,
                 return_hidden: bool = False):
    """The decoder over ``tokens`` [B, S] at ``positions`` [B, S]:
    (logits [B, S, V] or, with ``return_hidden``, the final norm's output,
    new_caches).  With ``caches`` the self K/V are written in place and,
    when ``enc_out`` is given (prefill), the cross K/V too."""
    x = F.embedding(tokens, params.embed) + F.embedding(positions,
                                                        params.dec_pos)
    layers = params.decoder.layers()
    if caches is None:
        def layer_fn(xc, pl):
            return _dec_layer(pl, cfg, xc, positions, enc_out, None, mode)[0]
        layer_fn = T._remat_wrap(layer_fn, cfg, mode)
        for pl in layers:
            x = layer_fn(x, pl)
        new_caches = None
    else:
        kv = caches.kv_self
        new_pos = []
        for li, pl in enumerate(layers):
            cl = DecLayerCache(attn_mod.KVCache(kv.k[li], kv.v[li],
                                                kv.pos[li]),
                               caches.k_cross[li], caches.v_cross[li])
            x, nc = _dec_layer(pl, cfg, x, positions, enc_out, cl, mode)
            new_pos.append(nc.kv_self.pos)  # self K/V written in place
            if enc_out is not None:
                caches.k_cross[li].copy_(nc.k_cross)
                caches.v_cross[li].copy_(nc.v_cross)
        new_caches = caches._replace(kv_self=kv._replace(
            pos=torch.stack(new_pos)))
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    if return_hidden:
        return x, new_caches
    return x @ params.embed.T, new_caches


def dec_cache_axes(cfg: ModelConfig) -> DecLayerCache:
    """The logical axes of :func:`init_dec_cache`'s tree (stacked over
    the decoder's layers), the reference's."""
    kv = attn_mod.KVCache((None, "batch", "kv_seq", "kv_heads", None),
                          (None, "batch", "kv_seq", "kv_heads", None),
                          (None,))
    cross = (None, "batch", None, "kv_heads", None)
    return DecLayerCache(kv, cross, cross)


def init_dec_cache(cfg: ModelConfig, batch: int, s_max: int,
                   device: DeviceLike = None) -> DecLayerCache:
    """The decoder's cache, ``[L, ...]`` tensors: the self-attention K/V
    of ``s_max`` positions and the cross K/V of ``enc_seq``."""
    dev = resolve_device(device)
    cross = (batch, cfg.enc_seq, cfg.num_kv_heads, cfg.head_dim)
    per = DecLayerCache(
        attn_mod.init_kv_cache(cfg, batch, s_max, dev),
        torch.zeros(cross, dtype=torch.bfloat16, device=dev),
        torch.zeros(cross, dtype=torch.bfloat16, device=dev))
    L = cfg.num_layers

    def stacked(t):
        return t.expand((L,) + t.shape).clone()
    return DecLayerCache(attn_mod.KVCache(*map(stacked, per.kv_self)),
                         stacked(per.k_cross), stacked(per.v_cross))


# ======================================================================
def encdec_loss(params: EncDec, cfg: ModelConfig, features: torch.Tensor,
                tokens: torch.Tensor, labels: torch.Tensor):
    """The teacher-forced loss: ``(loss, {"nll", "loss"})``."""
    enc_out = encode(params, cfg, features)
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    hidden, _ = decode_stack(params, cfg, tokens, positions, enc_out, None,
                             "train", return_hidden=True)
    loss = chunked_softmax_xent(hidden, params.embed.T, labels)
    return loss, {"nll": loss, "loss": loss}


def encdec_prefill(params: EncDec, cfg: ModelConfig, features: torch.Tensor,
                   tokens: torch.Tensor, caches: DecLayerCache):
    """Encode ``features``, fill the cache from ``tokens``: (the last
    position's logits [B, 1, V], the cache)."""
    enc_out = encode(params, cfg, features, mode="prefill")
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    logits, new_caches = decode_stack(params, cfg, tokens, positions,
                                      enc_out, caches, "prefill")
    return logits[:, -1:], new_caches


def encdec_decode(params: EncDec, cfg: ModelConfig, token: torch.Tensor,
                  caches: DecLayerCache):
    """One token a row at the cache's position (layer 0's ``pos``: a
    scalar, or one a row)."""
    pos = caches.kv_self.pos[0]
    positions = pos.reshape(-1, 1).expand(token.shape[0], 1)
    return decode_stack(params, cfg, token, positions, None, caches,
                        "decode")
