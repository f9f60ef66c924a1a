"""Attention flavours with a KV cache: GQA/MQA, sliding-window, MLA and
cross-attention, in train, prefill and decode (the counterpart of
``repro.models.attention``).

Three execution paths for causal attention, chosen by shape:
  * dense masked attention — sequences up to ``FLASH_THRESHOLD``, and
    decode (a dense read over the KV cache);
  * flash attention        — longer train and prefill sequences: a loop
    over KV chunks with an online-softmax carry (live memory
    O(Sq * chunk), not O(Sq * Sk)), and the FlashAttention-2 backward as
    a ``torch.autograd.Function`` (the reference's ``jax.custom_vjp``):
    the forward saves (q, k, v, out, lse) and the backward recomputes
    each chunk's scores from them;
  * blocked sliding window — a layer with a window shorter than the
    sequence: a loop over query tiles of ``SWA_QTILE``, each attending to
    the ``W + Tq`` keys that can reach it (O(S * (W + Tq)) products).

A sliding-window layer's cache holds ``min(s_max, window)`` positions.
When that is at most the window it is a ring: decode writes position
``pos`` at slot ``pos % w`` and attends to the ``min(pos + 1, w)`` filled
slots, and a prefill longer than the ring keeps its last ``w`` keys,
rolled so that position ``p`` sits at slot ``p % w``.

The arithmetic is the reference's, in torch ops: scores in fp32 scaled
by ``1/sqrt(hd)``, masked with ``NEG_INF``, an fp32 softmax, and the
probabilities cast to the value dtype before the value product.

The cache's ``pos`` is a scalar (one length for the batch, as in the
reference and ``generate``) or a ``[B]`` int32 tensor (one per row, for
the slot server): decode writes each row at its own position (its own
ring slot) and masks each row by its own length (its own filled share
of the ring, its own window).  Prefill and decode write K/V into the cache
tensors in place and return a cache holding them with the new ``pos``.

MLA (deepseek-v3, ``cfg.use_mla``) caches the compressed stream: one
packed ``[B, S, kv_lora + rope]`` bf16 row a position (``KVCache.v`` is
``None``).  Train and prefill materialise per-head K/V from it (the rope
key broadcast over the heads; dense up to ``FLASH_THRESHOLD``, flash
above, with q and k 192 wide and v 128); decode is the absorbed fp32
form: ``q_nope`` folded through ``k_up``, scores taken against the
compressed rows and the rope rows, the context lifted through ``v_up``.
Decode writes each row at its own ``pos`` and masks it to its own
length, as the GQA cache does.

Cross-attention (the encoder-decoder's, ``cross_kv``) projects only the
queries and attends without a mask to the given K/V; ``causal=False``
(the encoder) attends without a mask to the layer's own K/V.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_rope, f32_recip, mk, rms_norm

FLASH_THRESHOLD = 2048  # above this, causal attention runs the flash path
FLASH_CHUNK = 512
NEG_INF = -1e30


# ======================================================================
# Parameter init
# ======================================================================
def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   device=None) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    if cfg.use_mla:
        H, r, dr = cfg.num_heads, cfg.kv_lora_rank, cfg.qk_rope_head_dim
        dn, dv = cfg.qk_nope_head_dim, cfg.v_head_dim
        return {
            "q_down": mk(gen, (d, cfg.q_lora_rank), device=device),
            "q_down_norm": torch.ones((cfg.q_lora_rank,),
                                      dtype=torch.float32, device=device),
            "q_up": mk(gen, (cfg.q_lora_rank, H * (dn + dr)), device=device),
            "kv_down": mk(gen, (d, r + dr), device=device),
            "kv_down_norm": torch.ones((r,), dtype=torch.float32,
                                       device=device),
            "k_up": mk(gen, (r, H * dn), device=device),
            "v_up": mk(gen, (r, H * dv), device=device),
            "w_o": mk(gen, (H * dv, d), device=device),
        }
    p = {
        "w_q": mk(gen, (d, cfg.num_heads * hd), device=device),
        "w_k": mk(gen, (d, cfg.num_kv_heads * hd), device=device),
        "w_v": mk(gen, (d, cfg.num_kv_heads * hd), device=device),
        "w_o": mk(gen, (cfg.num_heads * hd, d), device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=torch.float32, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=torch.float32, device=device)
    return p


# ======================================================================
# Caches
# ======================================================================
class KVCache(NamedTuple):
    k: torch.Tensor  # [B, S_max, Hkv, hd]   (MLA: [B, S_max, kv_lora+rope])
    v: Optional[torch.Tensor]  # None for MLA (the cache is compressed)
    pos: torch.Tensor  # int32: scalar (uniform batch) or [B] (per row)


def init_kv_cache(cfg: ModelConfig, batch: int, s_max: int,
                  device=None, window: int = 0) -> KVCache:
    """A zero cache of ``s_max`` positions, ``min(s_max, window)`` for a
    sliding-window layer; MLA's is the packed compressed stream."""
    s = min(s_max, window) if window else s_max
    if cfg.use_mla:
        c = torch.zeros((batch, s, cfg.kv_lora_rank + cfg.qk_rope_head_dim),
                        dtype=torch.bfloat16, device=device)
        return KVCache(c, None, torch.zeros((), dtype=torch.int32,
                                            device=device))
    shape = (batch, s, cfg.num_kv_heads, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=torch.bfloat16, device=device),
                   torch.zeros(shape, dtype=torch.bfloat16, device=device),
                   torch.zeros((), dtype=torch.int32, device=device))


# ======================================================================
# Core score/value computation (GQA-aware)
# ======================================================================
def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q [B,Sq,Hq,hd], k [B,Sk,Hkv,hd] -> scores [B,Hkv,rep,Sq,Sk] (f32)."""
    B, Sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    qr = q.reshape(B, Sq, Hkv, Hq // Hkv, hd)
    s = torch.einsum("bqhrd,bkhd->bhrqk", qr, k)
    return s.float() * f32_recip(hd ** 0.5)


def _gqa_values(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p [B,Hkv,rep,Sq,Sk], v [B,Sk,Hkv,hd] -> [B,Sq,Hq,hd]."""
    B, Hkv, rep, Sq, Sk = p.shape
    out = torch.einsum("bhrqk,bkhd->bqhrd", p.to(v.dtype), v)
    return out.reshape(B, Sq, Hkv * rep, -1)


def dense_attention(q, k, v, mask) -> torch.Tensor:
    """mask [B,1,1,Sq,Sk] or broadcastable; True = attend."""
    s = _gqa_scores(q, k)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return _gqa_values(p, v)


def _chunk_mask(ci: int, chunk: int, Sk: int, q_pos: torch.Tensor,
                causal: bool) -> torch.Tensor:
    """Valid-key mask of KV chunk ``ci``: [Sq, chunk] (causal) or
    [chunk]."""
    kv_pos = ci * chunk + torch.arange(chunk, device=q_pos.device)
    valid = kv_pos < Sk
    if causal:
        return valid[None, :] & (kv_pos[None, :] <= q_pos[:, None])
    return valid


def _pad_keys(k, v, chunk: int):
    n_chunks = -(-k.shape[1] // chunk)
    pad = n_chunks * chunk - k.shape[1]
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    return k, v, n_chunks


def _flash_scan(q, k, v, causal: bool, q_offset: int, chunk: int):
    """Online-softmax forward over KV chunks of ``chunk`` keys.  Returns
    (out [B,Sq,Hq,dv], lse [B,Hkv,rep,Sq] fp32)."""
    B, Sq, Hq, hd = q.shape
    Sk, Hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    rep = Hq // Hkv
    k, v, n_chunks = _pad_keys(k, v, chunk)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    m = torch.full((B, Hkv, rep, Sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Hkv, rep, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hkv, rep, Sq, dv), dtype=torch.float32,
                      device=q.device)
    for ci in range(n_chunks):
        kb = k[:, ci * chunk:(ci + 1) * chunk]
        vb = v[:, ci * chunk:(ci + 1) * chunk]
        s = _gqa_scores(q, kb)  # [B,Hkv,rep,Sq,chunk] f32
        s = torch.where(_chunk_mask(ci, chunk, Sk, q_pos, causal), s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bhrqk,bkhd->bhrqd", p.to(vb.dtype), vb).float()
        acc = acc * alpha[..., None] + pv
        m = m_new
    l_safe = torch.clamp_min(l, 1e-30)
    out = acc / l_safe[..., None]
    lse = m + torch.log(l_safe)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, dv).to(q.dtype)
    return out, lse


def _flash_bwd(causal: bool, q_offset: int, chunk: int, res, dout):
    """FlashAttention-2 backward: D = rowsum(dout * out), then the scores
    recomputed per KV chunk from the saved (q, k, v, out, lse); dq is
    accumulated over the chunks, dk and dv are each chunk's.  Never
    materializes the [Sq, Sk] matrix: O(Sq * chunk) live memory."""
    q, k, v, out, lse = res
    B, Sq, Hq, hd = q.shape
    Sk, Hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    rep = Hq // Hkv
    scale = 1.0 / math.sqrt(hd)
    f32 = torch.float32
    k, v, n_chunks = _pad_keys(k, v, chunk)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    do_r = dout.reshape(B, Sq, Hkv, rep, dv).to(f32)
    q_r = q.reshape(B, Sq, Hkv, rep, hd).to(f32)
    D = torch.einsum("bqhrd,bqhrd->bhrq", do_r,
                     out.reshape(B, Sq, Hkv, rep, dv).to(f32))
    dq = torch.zeros((B, Sq, Hkv, rep, hd), dtype=f32, device=q.device)
    dks, dvs = [], []
    for ci in range(n_chunks):
        kb = k[:, ci * chunk:(ci + 1) * chunk]
        vb = v[:, ci * chunk:(ci + 1) * chunk]
        s = _gqa_scores(q, kb)  # f32, already scaled
        s = torch.where(_chunk_mask(ci, chunk, Sk, q_pos, causal), s, NEG_INF)
        p = torch.exp(s - lse[..., None])  # [B,Hkv,rep,Sq,C]
        dvs.append(torch.einsum("bhrqk,bqhrd->bkhd", p, do_r))
        dp = torch.einsum("bqhrd,bkhd->bhrqk", do_r, vb.to(f32))
        ds = p * (dp - D[..., None]) * scale  # grad wrt the raw q.k
        dq = dq + torch.einsum("bhrqk,bkhd->bqhrd", ds, kb.to(f32))
        dks.append(torch.einsum("bhrqk,bqhrd->bkhd", ds, q_r))
    dk = torch.cat(dks, dim=1)[:, :Sk]
    dvv = torch.cat(dvs, dim=1)[:, :Sk]
    return (dq.reshape(B, Sq, Hq, hd).to(q.dtype), dk.to(k.dtype),
            dvv.to(v.dtype))


class _Flash(torch.autograd.Function):
    """The reference's ``jax.custom_vjp`` pair: the forward saves
    (q, k, v, out, lse), the backward is :func:`_flash_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, chunk):
        out, lse = _flash_scan(q, k, v, causal, q_offset, chunk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, q_offset, chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        return _flash_bwd(*ctx.args, ctx.saved_tensors, dout) + (None,) * 3


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                    chunk: int = FLASH_CHUNK) -> torch.Tensor:
    """Memory-bounded attention: the online-softmax forward and the FA2
    backward, out [B,Sq,Hq,dv].  Live memory is O(Sq * chunk) per head in
    both passes instead of O(Sq * Sk)."""
    return _Flash.apply(q, k, v, causal, q_offset, chunk)


SWA_QTILE = 256


def swa_attention_blocked(q, k, v, window: int) -> torch.Tensor:
    """Causal sliding-window attention as a loop over query tiles of
    ``Tq = min(SWA_QTILE, S)``: tile ``t`` attends to the keys in
    ``[t Tq - W, (t + 1) Tq)`` (the keys padded with W zeros in front so
    every window is a slice), masked to ``q - W < k <= q``.  Live memory
    is one [B, H, Tq, W + Tq] score tile."""
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    W = window
    Tq = min(SWA_QTILE, S)
    nt = -(-S // Tq)
    pad = nt * Tq - S
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
    rep = Hq // Hkv
    kp = F.pad(k, (0, 0, 0, 0, W, 0))
    vp = F.pad(v, (0, 0, 0, 0, W, 0))
    scale = float(np.float32(1.0 / math.sqrt(hd)))
    ar_q = torch.arange(Tq, device=q.device)[:, None]
    ar_k = torch.arange(W + Tq, device=q.device)[None, :]
    outs = []
    for t in range(nt):
        qr = q[:, t * Tq:(t + 1) * Tq].reshape(B, Tq, Hkv, rep, hd)
        kw = kp[:, t * Tq: t * Tq + W + Tq]
        vw = vp[:, t * Tq: t * Tq + W + Tq]
        s = torch.einsum("bqhrd,bkhd->bhrqk", qr, kw).float() * scale
        q_pos = t * Tq + ar_q  # absolute positions
        k_pos = t * Tq - W + ar_k
        allow = ((k_pos <= q_pos) & (q_pos - k_pos < W) & (k_pos >= 0)
                 & (q_pos < S))
        s = torch.where(allow, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        ob = torch.einsum("bhrqk,bkhd->bqhrd", p.to(vw.dtype), vw)
        outs.append(ob.reshape(B, Tq, Hq, hd))
    return torch.cat(outs, dim=1)[:, :S]


# ======================================================================
# Full attention layer (projections + rope + cache handling)
# ======================================================================
def attention_layer(
    p,
    cfg: ModelConfig,
    x: torch.Tensor,  # [B, S, D]
    positions: torch.Tensor,  # [B, S]
    *,
    layer_window: int = 0,  # 0 = global; > 0 = sliding window
    cache: Optional[KVCache] = None,  # decode/prefill cache
    mode: str = "train",  # train | prefill | decode
    cross_kv: Optional[tuple] = None,  # (k, v) for cross-attention
    causal: bool = True,
) -> tuple[torch.Tensor, Optional[KVCache]]:
    if cfg.use_mla:
        return _mla_layer(p, cfg, x, positions, cache=cache, mode=mode)
    B, S, D = x.shape
    hd = cfg.head_dim
    q = (x @ p["w_q"]).reshape(B, S, cfg.num_heads, hd)
    if cross_kv is None:
        k = (x @ p["w_k"]).reshape(B, S, cfg.num_kv_heads, hd)
        v = (x @ p["w_v"]).reshape(B, S, cfg.num_kv_heads, hd)
        if cfg.qk_norm:
            q = rms_norm(q, p["q_norm"], cfg.norm_eps)
            k = rms_norm(k, p["k_norm"], cfg.norm_eps)
        q = apply_rope(q, positions, fraction=cfg.rope_fraction,
                       theta=cfg.rope_theta)
        k = apply_rope(k, positions, fraction=cfg.rope_fraction,
                       theta=cfg.rope_theta)
    else:
        k, v = cross_kv
        causal = False

    new_cache = None
    if not causal:  # the encoder, or cross-attention: no mask
        out = dense_attention(q, k, v, torch.ones(
            (1, 1, 1, S, k.shape[1]), dtype=torch.bool, device=x.device))
    elif mode == "decode":
        if cache is None:
            raise ValueError("decode needs a KV cache")
        kc, vc, pos = cache
        w = kc.shape[1]
        ring = bool(layer_window) and w <= layer_window
        steps = torch.arange(S, device=x.device)
        kv_pos = torch.arange(w, device=x.device)
        # ring: all filled slots attendable; else the positions written
        # so far (and, under a window, the last ``layer_window`` of them)
        if pos.ndim == 0:
            slots = (pos + steps) % w if ring else pos + steps
            kc.index_copy_(1, slots, k)
            vc.index_copy_(1, slots, v)
            end = torch.clamp(pos + S, max=w) if ring else pos + S
            mask = kv_pos < end
            if layer_window and not ring:
                mask = mask & (kv_pos >= pos + S - layer_window)
        else:  # one length a row
            rows = torch.arange(B, device=x.device)[:, None]
            slots = pos[:, None] + steps
            if ring:
                slots = slots % w
            kc[rows, slots] = k
            vc[rows, slots] = v
            end = torch.clamp(pos + S, max=w) if ring else pos + S
            mask = kv_pos[None, :] < end[:, None]
            if layer_window and not ring:
                mask = mask & (kv_pos[None, :]
                               >= (pos + S - layer_window)[:, None])
            mask = mask[:, None, None, None]
        new_cache = KVCache(kc, vc, pos + S)
        out = dense_attention(q, kc, vc, mask)
    else:
        if mode == "prefill" and cache is not None:
            w = cache.k.shape[1]
            if w >= S:
                cache.k[:, :S] = k
                cache.v[:, :S] = v
            elif layer_window:  # a window cache smaller than the prompt:
                # its last w keys, position p at slot p % w
                cache.k.copy_(torch.roll(k[:, S - w:], (S - w) % w, dims=1))
                cache.v.copy_(torch.roll(v[:, S - w:], (S - w) % w, dims=1))
            else:
                raise ValueError(f"a prompt of {S} tokens does not fit a "
                                 f"cache of {w} positions")
            new_cache = KVCache(cache.k, cache.v,
                                torch.full_like(cache.pos, S))
        out = _prefill_attention(q, k, v, layer_window, S)

    out = out.reshape(B, S, cfg.num_heads * hd)
    return out @ p["w_o"], new_cache


def _prefill_attention(q, k, v, layer_window: int, S: int) -> torch.Tensor:
    if layer_window and S > layer_window:
        return swa_attention_blocked(q, k, v, layer_window)
    if S > FLASH_THRESHOLD:
        return flash_attention(q, k, v)
    pos = torch.arange(S, device=q.device)
    mask = (pos[None, :] <= pos[:, None])[None, None, None]
    if layer_window:
        mask = mask & (pos[:, None] - pos[None, :] < layer_window
                       )[None, None, None]
    return dense_attention(q, k, v, mask)


# ======================================================================
# MLA (deepseek-v3)
# ======================================================================
def _mla_qkv(p, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor):
    """(q_nope [B,S,H,dn], q_rope [B,S,H,dr], c_kv [B,S,r], k_rope
    [B,S,dr]): the low-rank q, the normed compressed kv and the
    decoupled rope key (one for all heads)."""
    B, S, _ = x.shape
    H, dn, dr = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    r = cfg.kv_lora_rank
    cq = rms_norm(x @ p["q_down"], p["q_down_norm"], cfg.norm_eps)
    q = (cq @ p["q_up"]).reshape(B, S, H, dn + dr)
    q_nope = q[..., :dn]
    q_rope = apply_rope(q[..., dn:], positions, theta=cfg.rope_theta)
    ckv_full = x @ p["kv_down"]  # [B, S, r + dr]
    c_kv = rms_norm(ckv_full[..., :r], p["kv_down_norm"], cfg.norm_eps)
    k_rope = apply_rope(ckv_full[..., r:][:, :, None, :], positions,
                        theta=cfg.rope_theta)[:, :, 0, :]
    return q_nope, q_rope, c_kv, k_rope


def _mla_write(cache: KVCache, packed: torch.Tensor) -> torch.Tensor:
    """Write the packed rows [B, S, r + dr] of a decode step into the
    compressed cache in place, each row at its own ``pos``; returns the
    key mask [B or 1, 1, 1, S_max]: each row's written positions."""
    ck, pos = cache.k, cache.pos
    B, S = packed.shape[:2]
    steps = torch.arange(S, device=ck.device)
    kv_pos = torch.arange(ck.shape[1], device=ck.device)
    if pos.ndim == 0:
        ck.index_copy_(1, pos + steps, packed)
        return (kv_pos < pos + S)[None, None, None]
    rows = torch.arange(B, device=ck.device)[:, None]
    ck[rows, pos[:, None] + steps] = packed
    return (kv_pos[None, :] < (pos + S)[:, None])[:, None, None]


def _mla_layer(p, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
               *, cache: Optional[KVCache], mode: str
               ) -> tuple[torch.Tensor, Optional[KVCache]]:
    B, S, D = x.shape
    H, dn, dr = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    dv, r = cfg.v_head_dim, cfg.kv_lora_rank
    f32 = torch.float32
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, cfg, x, positions)

    if mode == "decode":
        if cache is None:
            raise ValueError("decode needs a KV cache")
        packed = torch.cat([c_kv, k_rope], dim=-1).to(cache.k.dtype)
        mask = _mla_write(cache, packed)
        new_cache = KVCache(cache.k, None, cache.pos + S)
        ckv_all = cache.k[..., :r].to(f32)
        kr_all = cache.k[..., r:].to(f32)
        # absorbed: q' = q_nope @ k_up^T per head -> [B, S, H, r] (bf16)
        q_abs = torch.einsum("bshd,rhd->bshr", q_nope,
                             p["k_up"].reshape(r, H, dn))
        scale = float(np.float32(1.0 / math.sqrt(dn + dr)))
        s = (torch.einsum("bshr,btr->bhst", q_abs.to(f32), ckv_all)
             + torch.einsum("bshd,btd->bhst", q_rope.to(f32), kr_all)) * scale
        s = torch.where(mask, s, NEG_INF)
        pr = torch.softmax(s, dim=-1)
        # the context in the compressed space, lifted through v_up
        ctx = torch.einsum("bhst,btr->bshr", pr, ckv_all)
        out = torch.einsum("bshr,rhd->bshd", ctx,
                           p["v_up"].reshape(r, H, dv).to(f32))
        out = out.reshape(B, S, H * dv).to(x.dtype)
        return out @ p["w_o"], new_cache

    # train / prefill: per-head K/V materialised from the compressed stream
    k_nope = (c_kv @ p["k_up"]).reshape(B, S, H, dn)
    v = (c_kv @ p["v_up"]).reshape(B, S, H, dv)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, dr)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    new_cache = None
    if mode == "prefill" and cache is not None:
        if cache.k.shape[1] < S:
            raise ValueError(f"a prompt of {S} tokens does not fit a "
                             f"cache of {cache.k.shape[1]} positions")
        cache.k[:, :S] = torch.cat([c_kv, k_rope], dim=-1).to(cache.k.dtype)
        new_cache = KVCache(cache.k, None, torch.full_like(cache.pos, S))
    out = _prefill_attention(q, k, v, 0, S)
    return out.reshape(B, S, H * dv) @ p["w_o"], new_cache
