"""Mamba2's SSD layer (state-space duality): the chunked scan for train and
prefill, its sequence-parallel form, and the O(1) recurrent decode (the
counterpart of ``repro.models.ssm``).

The SSD of arXiv:2405.21060 §6, chunkwise: the diagonal blocks are
attention-like within a chunk of ``Q`` tokens; the off-diagonal blocks
flow through a per-chunk state of size ``[H, N, P]`` carried from chunk
to chunk in fp32.  Decode is one recurrent update of that state, so a
token costs the same at any position.

The arithmetic is the reference's, in torch ops:

  * ``softplus`` is ``jax.nn.softplus`` (``logaddexp(x, 0)``:
    ``max(x, 0) + log1p(exp(-|x|))``) with the ``exp`` and ``log1p`` that
    XLA compiles for the tensor's device: on the CPU, Cephes polynomials
    with fused multiply-adds (each fused step done in float64 and rounded
    once), so ``dt`` is bitwise the reference's there; on CUDA, the
    device's ``expf``/``log1pf``, which XLA calls there too.
    ``torch.nn.functional.softplus`` switches to ``x`` above 20 and differs
    by up to 9.5e-7.  Its gradient is ``logaddexp``'s rule,
    ``exp(x - softplus(x))``.
  * ``_segsum`` masks with ``-inf`` before the ``exp``, so the backward
    never multiplies an overflowed ``exp`` by a zero.
  * The casts stay where the reference has them: the masked scores cast
    to ``x.dtype`` before the diagonal product, the chunk states, the
    inter-chunk carry and the off-diagonal term in fp32.

The reference's prefill keeps only the conv tail of a given cache and
starts the scan from a zero state (``cache.state`` is not ``s0``); the
port keeps that (ROADMAP.md §3).

**Under a mesh** (``dist/sharding.py::use_mesh_rules``) each rank holds
its block of the tokens (``moe_a2a.rank_block``: batch over the data
axes, sequence over ``model``).  In train mode with a model axis > 1 and
whole chunks a rank, :func:`apply_ssm` runs the reference's
sequence-parallel SSD: the causal conv takes its first ``W - 1`` rows
from the previous rank's block, and :func:`_ssd_seq_parallel_call` gathers
the per-rank (final state, decay product) pairs over ``model``
(``dist/exchange.py::all_gather``, which carries gradients) and reruns
the rank's scan from its exclusive prefix state.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import exchange as ex_mod
from repro_torch.dist.sharding import current_mesh
from repro_torch.models.layers import act_fn, f32_recip, mk


class SSMCache(NamedTuple):
    state: torch.Tensor  # [B, H, N, P] fp32
    conv: torch.Tensor  # [B, W-1, conv_channels]


def conv_channels(cfg: ModelConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_state  # x, B, C streams


def init_ssm(gen: torch.Generator, cfg: ModelConfig, device=None) -> dict:
    """The reference's leaves: ``in_proj [D, 2 di + 2 N + H]`` (order z,
    x, B, C, dt), ``conv_w [W, cc]`` (scale 0.5), ``conv_b``, ``a_log``,
    ``dt_bias``, ``d_skip`` and ``out_norm`` in fp32, ``out_proj [di,
    D]``."""
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    cc = conv_channels(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": mk(gen, (d, 2 * di + 2 * n + h), device=device),
        "conv_w": mk(gen, (cfg.ssm_conv_width, cc), scale=0.5, device=device),
        "conv_b": torch.zeros((cc,), **f32),
        "a_log": torch.zeros((h,), **f32),
        "dt_bias": torch.zeros((h,), **f32),
        "d_skip": torch.ones((h,), **f32),
        "out_norm": torch.ones((di,), **f32),
        "out_proj": mk(gen, (di, d), device=device),
    }


def ssm_axes() -> dict:
    """The logical axes of :func:`init_ssm`'s leaves, as the reference's
    ``mk`` and ``Param`` calls name them."""
    return {"in_proj": ("fsdp", "ssm_inner"), "conv_w": (None, "ssm_inner"),
            "conv_b": ("ssm_inner",), "a_log": ("ssm_heads",),
            "dt_bias": ("ssm_heads",), "d_skip": ("ssm_heads",),
            "out_norm": ("ssm_inner",), "out_proj": ("ssm_inner", "fsdp")}


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    di, n = cfg.d_inner, cfg.ssm_state
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di: 2 * di + 2 * n]
    dt = zxbcdt[..., 2 * di + 2 * n:]
    return z, xbc, dt


# ----------------------------------------------------------------------
# softplus as XLA compiles jax.nn.softplus on the CPU
# ----------------------------------------------------------------------
def _c(v: float) -> float:
    """A constant as XLA holds it: rounded to float32."""
    return float(np.float32(v))


def _fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once (the product of two float32
    values is exact in float64)."""
    return (a.double() * b + c).float()


def _xla_exp(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``exp``: Cephes' range reduction and polynomial, each
    step a fused multiply-add; 2^n built from the exponent bits (n = -127
    gives 0: denormals are flushed)."""
    x = torch.clamp(x, _c(-88.8), _c(88.8))
    n = torch.floor(_fma(x, _c(1.44269504088896341), 0.5)).clamp(-127, 127)
    a = _fma(n, _c(-0.693359375), x)
    a = _fma(n, _c(2.12194440e-4), a)
    z = _fma(a, _c(1.9875691500e-4), _c(1.3981999507e-3))
    for c in (8.3334519073e-3, 4.1665795894e-2, 1.6666665459e-1,
              5.0000001201e-1):
        z = _fma(z, a, _c(c))
    z = _fma(z, a * a, a)
    z = 1.0 + z
    bits = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return z * bits


_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)


def _horner(x, coeffs) -> torch.Tensor:
    p = torch.zeros_like(x)
    for c in coeffs:
        p = _fma(p, x, _c(c))
    return p


def _xla_log(v: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log`` of ``v >= 1`` (Cephes' logf, each step a
    fused multiply-add where LLVM contracts one)."""
    m, e = torch.frexp(v)
    e = e.float()
    small = m < _c(0.707106781186547524)
    x = m - 1.0
    e = e - small.float()
    x = x + torch.where(small, m, torch.zeros_like(m))
    x2 = x * x
    x3 = x2 * x
    p = [_c(c) for c in _LOG_P]
    y = _fma(x, p[0], p[1])
    y1 = _fma(x, p[3], p[4])
    y2 = _fma(x, p[6], p[7])
    y = _fma(y, x, p[2])
    y1 = _fma(y1, x, p[5])
    y2 = _fma(y2, x, p[8])
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, e * _c(-2.12194440e-4))
    x = _fma(-x2, 0.5, x)
    x = x + y
    return _fma(e, _c(0.693359375), x)


def _xla_log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log1p`` of ``x >= 0``: Cephes' rational form below
    sqrt(2) - 1, ``log(1 + x)`` above."""
    x2 = x * x
    r = _horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN)
    small = x + _fma(x2, -0.5, (x * x2) * r)
    return torch.where(x.abs() < _c(0.41421356237309504880), small,
                       _xla_log(x + 1.0))


def _exp(x: torch.Tensor) -> torch.Tensor:
    return _xla_exp(x) if x.device.type == "cpu" else torch.exp(x)


def _log1p(x: torch.Tensor) -> torch.Tensor:
    return _xla_log1p(x) if x.device.type == "cpu" else torch.log1p(x)


class _Softplus(torch.autograd.Function):
    """``jax.nn.softplus`` on float32, bitwise the jitted reference on the
    CPU; the backward is ``logaddexp``'s rule ``g * exp(x - out)``."""

    @staticmethod
    def forward(ctx, x):
        out = torch.clamp_min(x, 0.0) + _log1p(_exp(-x.abs()))
        out = torch.where(torch.isnan(x), x, out)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        x, out = (torch.where(torch.isposinf(t), 0.0, t) for t in (x, out))
        return g * _exp(x - out)


def softplus(x: torch.Tensor) -> torch.Tensor:
    return _Softplus.apply(x)


# ----------------------------------------------------------------------
# The chunked scan
# ----------------------------------------------------------------------
def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv. xbc [B,S,C]; w [W,C]; prev [B,W-1,C] or
    zeros.  The taps are summed in ``xbc``'s dtype in the reference's
    order."""
    W = w.shape[0]
    S = xbc.shape[1]
    if prev is None:
        prev = xbc.new_zeros((xbc.shape[0], W - 1, xbc.shape[2]))
    xp = torch.cat([prev, xbc], dim=1)
    out = xp[:, 0:S] * w[0]
    for i in range(1, W):
        out = out + xp[:, i: i + S] * w[i]
    return act_fn("silu")(out + b.to(out.dtype))


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x [..., L] -> [..., L, L] lower-triangular pairwise cumulative sums,
    ``-inf`` above the diagonal (masked before any ``exp``)."""
    L = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]  # sum over (j, i]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    return torch.where(mask, diff, -torch.inf)


def ssd_chunked(x, dt, a, B, C, chunk: int, s0=None,
                states_only: bool = False):
    """SSD scan. x [b,S,H,P]; dt [b,S,H] (>0); a [H] (<0); B,C [b,S,N].

    s0: optional initial state [b,H,N,P] (the sequence-parallel ranks
    chain through it).  states_only skips the diagonal blocks and returns
    (None, s_final).  Returns y [b,S,H,P] in x's dtype and the final
    state [b,H,N,P] fp32."""
    b, S, H, P = x.shape
    N = B.shape[-1]
    Q = chunk
    nc = S // Q
    if S % Q:
        raise ValueError(f"a sequence of {S} is not whole chunks of {Q}")
    f32 = torch.float32
    xr = x.reshape(b, nc, Q, H, P)
    dtr = dt.reshape(b, nc, Q, H)
    Br = B.reshape(b, nc, Q, N)
    Cr = C.reshape(b, nc, Q, N)
    da = dtr * a  # [b,nc,Q,H] negative
    da_cum = torch.cumsum(da, dim=2)  # within-chunk
    da_total = da_cum[:, :, -1]  # [b,nc,H]
    xdt = xr * dtr[..., None]  # [b,nc,Q,H,P], fp32 (dt is)

    if not states_only:
        # 1) diagonal: y_ij = C_i.B_j * exp(da_cum_i - da_cum_j) * dt_j x_j
        Lmat = torch.exp(_segsum(da.permute(0, 1, 3, 2)))  # [b,nc,H,Q,Q]
        scores = torch.einsum("bcin,bcjn->bcij", Cr, Br)  # across heads
        sx = scores[:, :, None] * Lmat  # [b,nc,H,Q,Q]
        y_diag = torch.einsum("bchij,bcjhp->bcihp",
                              sx.to(x.dtype).to(xdt.dtype), xdt)

    # 2) per-chunk states:
    #    S_c = sum_j B_j (x) (dt_j x_j) exp(da_total - da_cum_j)
    decay_to_end = torch.exp(da_total[:, :, None] - da_cum)  # [b,nc,Q,H]
    states = torch.einsum("bcjn,bcjh,bcjhp->bchnp", Br.to(f32),
                          decay_to_end.to(f32), xdt.to(f32))
    if states_only:
        s_run = s0 if s0 is not None else x.new_zeros((b, H, N, P),
                                                      dtype=f32)
        for c in range(nc):
            s_run = (s_run * torch.exp(da_total[:, c])[..., None, None]
                     + states[:, c])
        return None, s_run

    # 3) inter-chunk recurrence over the chunks (fp32 carry)
    s = s0 if s0 is not None else x.new_zeros((b, H, N, P), dtype=f32)
    prevs = []
    for c in range(nc):
        prevs.append(s)
        s = s * torch.exp(da_total[:, c])[..., None, None] + states[:, c]
    s_prevs = torch.stack(prevs, dim=1)  # [b,nc,H,N,P] entering each chunk

    # 4) off-diagonal contribution: y_i += C_i . s_prev * exp(da_cum_i)
    y_off = torch.einsum("bcin,bcih,bchnp->bcihp", Cr.to(f32),
                         torch.exp(da_cum).to(f32), s_prevs)
    y = (y_diag.to(f32) + y_off).reshape(b, S, H, P)
    return y.to(x.dtype), s


# ----------------------------------------------------------------------
# The sequence-parallel SSD
# ----------------------------------------------------------------------
def _ssd_seq_parallel_call(xs, dt, a, Bv, Cv, chunk: int, mesh):
    """The reference's ``shard_map`` call, seen from one rank: ``xs``,
    ``dt``, ``Bv``, ``Cv`` are this rank's blocks as ``x_spec``/``vspec``
    cut the global arrays (``moe_a2a.rank_block``: the sequence over
    ``model``), ``a`` whole; returns this rank's block of y.  The rank's
    states-only pass from 0, the per-rank (final state, decay product)
    all-gathered over ``model``, its exclusive prefix state, and its scan
    rerun from it."""
    _, s_fin = ssd_chunked(xs, dt, a, Bv, Cv, chunk, states_only=True)
    dprod = torch.exp(torch.sum(dt * a, dim=1))  # [b,H] the block's decay
    group = mesh.group("model")
    tp = mesh.shape["model"]
    idx = mesh.coords["model"]
    # one gather of both summaries: a rank's backward runs the collectives
    # of its graph in the graph's order, which differs by rank
    b, H, N, P = s_fin.shape
    packed = torch.cat([s_fin.reshape(b, H, N * P), dprod[..., None]], -1)
    gathered = ex_mod.all_gather(packed[None], group)  # [tp, b,H,N*P+1]
    s_all = gathered[..., :-1].reshape(tp, b, H, N, P)
    d_all = gathered[..., -1]  # [tp, b,H]
    # exclusive prefix: s0 = sum_{q<p} s_q * prod_{q<r<p} d_r, every
    # summary weighted (0 past this rank, as the reference's masks do), so
    # every rank's backward joins the gather's reduce-scatter
    s0 = torch.zeros_like(s_fin)
    for q in range(tp):
        decay_qp = torch.ones_like(dprod)
        for r in range(q + 1, tp):
            decay_qp = decay_qp * (d_all[r] if r < idx else 1.0)
        contrib = s_all[q] * decay_qp[..., None, None]
        s0 = s0 + (1.0 if q < idx else 0.0) * contrib
    y, _ = ssd_chunked(xs, dt, a, Bv, Cv, chunk, s0=s0)
    return y


def _conv_halo(xbc: torch.Tensor, W: int, mesh) -> torch.Tensor:
    """The ``W - 1`` rows before this rank's block of the sequence: the
    previous model rank's last rows (zeros on the first rank, as the
    gathered rows times 0, so its backward joins the gather's
    reduce-scatter too)."""
    tails = ex_mod.all_gather(xbc[None, :, -(W - 1):], mesh.group("model"))
    idx = mesh.coords["model"]
    return tails[idx - 1] if idx else tails[0] * 0.0


# ----------------------------------------------------------------------
# The layer
# ----------------------------------------------------------------------
def apply_ssm(p, cfg: ModelConfig, u: torch.Tensor,
              cache: Optional[SSMCache] = None, mode: str = "train"
              ) -> tuple[torch.Tensor, Optional[SSMCache]]:
    """u [B,S,D] -> y [B,S,D]. train/prefill run the chunked scan (padded
    to whole chunks); decode runs the O(1) recurrent update; all three end
    with the gated RMS norm and ``out_proj``.  Prefill returns
    ``SSMCache(s_final, the last W - 1 conv inputs)``."""
    Bsz, S, D = u.shape
    di, n, h, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    W = cfg.ssm_conv_width
    f32 = torch.float32
    zxbcdt = u @ p["in_proj"]
    z, xbc, dt = _split_proj(cfg, zxbcdt)
    a = -torch.exp(p["a_log"])  # [h]
    dt = softplus(dt.to(f32) + p["dt_bias"])  # [B,S,h]

    if mode == "decode":
        if cache is None or S != 1:
            raise ValueError("decode needs an SSM cache and one token")
        conv_in = torch.cat([cache.conv, xbc], dim=1)  # [B,W,cc]
        # XLA reduces the bf16 taps' products in fp32 and rounds once
        taps = conv_in.float() * p["conv_w"].to(conv_in.dtype).float()
        xbc_c = act_fn("silu")(
            torch.sum(taps, dim=1).to(conv_in.dtype)
            + p["conv_b"].to(conv_in.dtype))  # [B,cc]
        new_conv = conv_in[:, 1:]
        xs = xbc_c[..., :di].reshape(Bsz, h, P)
        Bv = xbc_c[..., di: di + n]
        Cv = xbc_c[..., di + n:]
        dts = dt[:, 0]  # [B,h]
        decay = torch.exp(dts * a)  # [B,h]
        upd = torch.einsum("bn,bh,bhp->bhnp", Bv.to(f32), dts, xs.to(f32))
        state = cache.state * decay[..., None, None] + upd
        y = torch.einsum("bn,bhnp->bhp", Cv.to(f32), state)
        y = y + p["d_skip"][None, :, None] * xs.to(f32)
        y = y.reshape(Bsz, 1, di)
        new_cache = SSMCache(state, new_conv)
    else:
        mesh = current_mesh()
        tp = mesh.shape.get("model", 1) if mesh is not None else 1
        prev = cache.conv if cache is not None else None
        if tp > 1:
            chunk = min(cfg.ssm_chunk, S * tp)
            if mode != "train" or S % chunk:
                raise NotImplementedError(
                    f"{cfg.name}: under a mesh with a model axis of {tp} "
                    f"the SSM runs train mode on whole chunks of {chunk} a "
                    f"rank (got {mode}, {S} tokens a rank)")
            prev = _conv_halo(xbc, W, mesh)
        xbc_c = _causal_conv(xbc, p["conv_w"].to(xbc.dtype), p["conv_b"],
                             prev)
        xs = xbc_c[..., :di].reshape(Bsz, S, h, P)
        Bv = xbc_c[..., di: di + n]
        Cv = xbc_c[..., di + n:]
        s_final = None
        if tp > 1:  # the sequence-parallel SSD
            y = _ssd_seq_parallel_call(xs, dt, a, Bv, Cv, chunk, mesh)
        else:
            chunk = min(cfg.ssm_chunk, S)
            pad = (-S) % chunk
            xsp, Bp, Cp, dtp = xs, Bv, Cv, dt
            if pad:
                xsp = F.pad(xs, (0, 0, 0, 0, 0, pad))
                Bp = F.pad(Bv, (0, 0, 0, pad))
                Cp = F.pad(Cv, (0, 0, 0, pad))
                dtp = F.pad(dt, (0, 0, 0, pad))
            y, s_final = ssd_chunked(xsp, dtp, a, Bp, Cp, chunk)
        y = y[:, :S]
        y = y + p["d_skip"][None, None, :, None] * xs.to(f32)
        y = y.reshape(Bsz, S, di)
        new_cache = None
        if mode == "prefill":
            tail = (xbc[:, -(W - 1):].clone() if S >= W - 1
                    else F.pad(xbc, (0, 0, W - 1 - S, 0)))
            new_cache = SSMCache(s_final, tail)

    # gated output norm (mamba2's RMSNorm(y * silu(z)))
    y = y * act_fn("silu")(z.to(f32))
    var = torch.sum(y * y, dim=-1, keepdim=True) * f32_recip(di)
    y = y * torch.rsqrt(var + cfg.norm_eps) * p["out_norm"]
    return y.to(u.dtype) @ p["out_proj"], new_cache


def init_ssm_cache(cfg: ModelConfig, batch: int, device=None) -> SSMCache:
    return SSMCache(
        torch.zeros((batch, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim),
                    dtype=torch.float32, device=device),
        torch.zeros((batch, cfg.ssm_conv_width - 1, conv_channels(cfg)),
                    dtype=torch.bfloat16, device=device))
