"""GQA/MQA attention with a KV cache: train, prefill and decode (the
counterpart of the non-MLA half of ``repro.models.attention``).

Two execution paths for causal attention, chosen by shape:
  * dense masked attention — sequences up to ``FLASH_THRESHOLD``, and
    decode (a dense read over the KV cache);
  * flash forward          — longer prefill: a loop over KV chunks with
    an online-softmax carry (live memory O(Sq * chunk), not O(Sq * Sk)).

The arithmetic is the reference's, in torch ops: scores in fp32 scaled
by ``1/sqrt(hd)``, masked with ``NEG_INF``, an fp32 softmax, and the
probabilities cast to the value dtype before the value product.

The cache's ``pos`` is a scalar (one length for the batch, as in the
reference and ``generate``) or a ``[B]`` int32 tensor (one per row, for
the slot server): decode writes each row at its own position and masks
each row by its own length.  Prefill and decode write K/V into the cache
tensors in place and return a cache holding them with the new ``pos``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

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
    k: torch.Tensor  # [B, S_max, Hkv, hd]
    v: torch.Tensor
    pos: torch.Tensor  # int32: scalar (uniform batch) or [B] (per row)


def init_kv_cache(cfg: ModelConfig, batch: int, s_max: int,
                  device=None) -> KVCache:
    shape = (batch, s_max, cfg.num_kv_heads, cfg.head_dim)
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


def flash_attention(q, k, v, chunk: int = FLASH_CHUNK) -> torch.Tensor:
    """Causal online-softmax forward over KV chunks of ``chunk`` keys
    (the reference's ``_flash_scan``): out [B,Sq,Hq,dv]."""
    B, Sq, Hq, hd = q.shape
    Sk, Hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    rep = Hq // Hkv
    n_chunks = -(-Sk // chunk)
    pad = n_chunks * chunk - Sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    q_pos = torch.arange(Sq, device=q.device)
    m = torch.full((B, Hkv, rep, Sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Hkv, rep, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hkv, rep, Sq, dv), dtype=torch.float32,
                      device=q.device)
    for ci in range(n_chunks):
        kb = k[:, ci * chunk:(ci + 1) * chunk]
        vb = v[:, ci * chunk:(ci + 1) * chunk]
        kv_pos = ci * chunk + torch.arange(chunk, device=q.device)
        mask = (kv_pos < Sk)[None, :] & (kv_pos[None, :] <= q_pos[:, None])
        s = _gqa_scores(q, kb)  # [B,Hkv,rep,Sq,chunk] f32
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bhrqk,bkhd->bhrqd", p.to(vb.dtype), vb).float()
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, dv).to(q.dtype)


# ======================================================================
# Full attention layer (projections + rope + cache handling)
# ======================================================================
def attention_layer(
    p,
    cfg: ModelConfig,
    x: torch.Tensor,  # [B, S, D]
    positions: torch.Tensor,  # [B, S]
    *,
    cache: Optional[KVCache] = None,  # decode/prefill cache
    mode: str = "train",  # train | prefill | decode
) -> tuple[torch.Tensor, Optional[KVCache]]:
    B, S, D = x.shape
    hd = cfg.head_dim
    q = (x @ p["w_q"]).reshape(B, S, cfg.num_heads, hd)
    k = (x @ p["w_k"]).reshape(B, S, cfg.num_kv_heads, hd)
    v = (x @ p["w_v"]).reshape(B, S, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, fraction=cfg.rope_fraction, theta=cfg.rope_theta)
    k = apply_rope(k, positions, fraction=cfg.rope_fraction, theta=cfg.rope_theta)

    new_cache = None
    if mode == "decode":
        if cache is None:
            raise ValueError("decode needs a KV cache")
        kc, vc, pos = cache
        steps = torch.arange(S, device=x.device)
        kv_pos = torch.arange(kc.shape[1], device=x.device)
        if pos.ndim == 0:
            kc.index_copy_(1, pos + steps, k)
            vc.index_copy_(1, pos + steps, v)
            mask = kv_pos < pos + S
        else:  # one length a row
            rows = torch.arange(B, device=x.device)[:, None]
            kc[rows, pos[:, None] + steps] = k
            vc[rows, pos[:, None] + steps] = v
            mask = (kv_pos[None, :] < (pos + S)[:, None])[:, None, None, None]
        new_cache = KVCache(kc, vc, pos + S)
        out = dense_attention(q, kc, vc, mask)
    else:
        if mode == "prefill" and cache is not None:
            if cache.k.shape[1] < S:
                raise ValueError(f"a prompt of {S} tokens does not fit a "
                                 f"cache of {cache.k.shape[1]} positions")
            cache.k[:, :S] = k
            cache.v[:, :S] = v
            new_cache = KVCache(cache.k, cache.v,
                                torch.full_like(cache.pos, S))
        out = _prefill_attention(q, k, v, S)

    out = out.reshape(B, S, cfg.num_heads * hd)
    return out @ p["w_o"], new_cache


def _prefill_attention(q, k, v, S: int) -> torch.Tensor:
    if S > FLASH_THRESHOLD:
        return flash_attention(q, k, v)
    pos = torch.arange(S, device=q.device)
    mask = (pos[None, :] <= pos[:, None])[None, None, None]
    return dense_attention(q, k, v, mask)
