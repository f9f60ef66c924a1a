"""Shared layer primitives (the counterpart of ``repro.models.layers``).

The dtypes are the reference's: bf16 weights, fp32 norm scales;
``rms_norm`` and RoPE compute in fp32 and cast back to the input's
dtype; ``x @ w`` multiplies bf16 by bf16 to a bf16 result.  Random
init draws from an explicit ``torch.Generator`` (``mk``); the values
differ from the JAX package's keys, so parity tests carry the JAX
weights across (``transformer.params_from_numpy``).

The losses (``cross_entropy``, ``chunked_softmax_xent``) are the
reference's fp32 NLL plus z-loss.  The reference's ``shard()``
annotations on the loss chunks have no counterpart on one card.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

PARAM_DTYPE = torch.bfloat16


def f32_recip(v: float) -> float:
    """The float32 reciprocal of ``float32(v)``: XLA compiles a division
    by a constant as a product with it, so the port multiplies by the
    same number (a true division is an ulp off for some ``v``)."""
    return float(np.float32(1.0) / np.float32(v))


DRAW_PIECE = 1 << 26  # elements of a leaf drawn at once (256 MiB in fp32)


def mk(gen: torch.Generator, shape: Sequence[int],
       scale: Optional[float] = None, dtype=PARAM_DTYPE,
       device=None) -> torch.Tensor:
    """A normal(0, scale) draw in fp32 cast to ``dtype``; the default
    scale is ``1/sqrt(fan_in)`` (``shape[0]``).  A leaf of more than
    ``DRAW_PIECE`` elements is drawn in pieces along dim 0, so its fp32
    draw is never whole (deepseek's ``[256, 7168, 2048]`` expert leaf
    would take 15 GB); a ``"meta"`` leaf, which holds no data, at once."""
    if scale is None:
        scale = 1.0 / math.sqrt(shape[0]) if len(shape) > 1 else 1.0
    shape = tuple(shape)
    if len(shape) == 0 or scale == 0.0:
        return torch.zeros(shape, dtype=dtype, device=device)
    meta = device is not None and torch.device(device).type == "meta"
    if math.prod(shape) <= DRAW_PIECE or meta:
        v = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device)
        return (v * scale).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    rows = max(1, DRAW_PIECE // (math.prod(shape) // shape[0]))
    for piece in out.split(rows, 0):
        piece.copy_(torch.randn(piece.shape, generator=gen,
                                dtype=torch.float32, device=device) * scale)
    return out


# ----------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.sum(xf * xf, dim=-1, keepdim=True) * f32_recip(x.shape[-1])
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


# The reference's activations are jnp expressions, and on bf16 every jnp op
# rounds to bf16; these repeat them op by op, each constant rounded to
# the input's dtype as a weak-typed jnp constant is.
class _SiLU(torch.autograd.Function):
    """``jax.nn.silu``: ``x * sigmoid(x)``, the sigmoid lowered as
    ``1 / (exp(-x) + 1)``.  The backward is ``lax.logistic``'s rule,
    ``ct * s + (ct * x) * (s * (1 - s))``: autograd through the forward's
    ops would multiply a zero by ``exp(-x) = inf`` where ``x < -88.7``
    (a NaN; MoE experts reach such inputs at full width)."""

    @staticmethod
    def forward(ctx, x):
        s = 1.0 / (torch.exp(-x) + 1.0)
        ctx.save_for_backward(x, s)
        return x * s

    @staticmethod
    def backward(ctx, ct):
        x, s = ctx.saved_tensors
        return ct * s + (ct * x) * (s * (1.0 - s))


def _silu(x: torch.Tensor) -> torch.Tensor:
    return _SiLU.apply(x)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu's default (tanh) form."""
    def c(v: float) -> float:
        return float(torch.tensor(v, dtype=x.dtype))
    inner = (x + x * x * x * c(0.044715)) * c(math.sqrt(2 / math.pi))
    return x * ((torch.tanh(inner) + 1.0) * 0.5)


def act_fn(name: str):
    return {"silu": _silu, "gelu": _gelu_tanh, "relu": F.relu}[name]


# ----------------------------------------------------------------------
# RoPE with partial-rotation support (chatglm/glm "2d" RoPE rotates half).
def rope_freqs(head_dim: int, fraction: float, theta: float,
               device=None) -> torch.Tensor:
    rot = int(head_dim * fraction)
    rot -= rot % 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (exps * f32_recip(rot)))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               fraction: float = 1.0, theta: float = 10000.0) -> torch.Tensor:
    """x: [B, S, H, hd]; positions: [B, S] (int)."""
    if theta <= 0:
        return x  # absolute-position archs (whisper)
    hd = x.shape[-1]
    inv = rope_freqs(hd, fraction, theta, x.device)  # [rot/2]
    rot = inv.shape[0] * 2
    ang = positions[..., None].float() * inv  # [B,S,rot/2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2].float(), xr[..., 1::2].float()
    o1 = x1 * cos - x2 * sin
    o2 = x1 * sin + x2 * cos
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape).to(x.dtype)
    return torch.cat([out, xp], dim=-1) if rot < hd else out


def sinusoidal_positions(num_pos: int, dim: int,
                         device=None) -> torch.Tensor:
    """Whisper-style sinusoidal absolute embeddings [num_pos, dim] fp32:
    ``sin`` then ``cos`` of ``p * exp(-ln(10000) i / (dim/2 - 1))``.

    The frequencies are bitwise the jitted reference's: XLA folds the two
    constants into one (rounded once) and, on the CPU, runs its own
    ``exp`` (``ssm._exp`` spells it; on CUDA both take the device's).
    ``sin`` and ``cos`` are torch's: XLA's CPU ones are another
    approximation, one float32 ulp off on a share of the entries."""
    from repro_torch.models.ssm import _exp  # (ssm imports this module)
    half = dim // 2
    i = torch.arange(half, dtype=torch.float32, device=device)
    inv = _exp(i * float(np.float32(-math.log(10000.0) / max(half - 1, 1))))
    ang = (torch.arange(num_pos, dtype=torch.float32, device=device)[:, None]
           * inv[None, :])
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ----------------------------------------------------------------------
def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, gated: bool,
             device=None) -> dict:
    p = {"w_in": mk(gen, (d_model, d_ff), device=device),
         "w_out": mk(gen, (d_ff, d_model), device=device)}
    if gated:
        p["w_gate"] = mk(gen, (d_model, d_ff), device=device)
    return p


def apply_mlp(p, x: torch.Tensor, act: str) -> torch.Tensor:
    h = x @ p["w_in"]
    if "w_gate" in p:
        h = act_fn(act)(x @ p["w_gate"]) * h
    else:
        h = act_fn(act)(h)
    return h @ p["w_out"]


def init_norm(shape_d: int, device=None) -> torch.Tensor:
    return torch.ones((shape_d,), dtype=torch.float32, device=device)


def init_embedding(gen: torch.Generator, vocab: int, d_model: int,
                   device=None) -> torch.Tensor:
    return mk(gen, (vocab, d_model), scale=0.02, device=device)


# ----------------------------------------------------------------------
def _chunk_nll_sum(h_c: torch.Tensor, head: torch.Tensor, y_c: torch.Tensor,
                   z_loss: float) -> torch.Tensor:
    logits = (h_c @ head).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, y_c[..., None].long())[..., 0]
    nll = lse - ll
    if z_loss:
        nll = nll + z_loss * lse ** 2
    return torch.sum(nll)


def chunked_softmax_xent(hidden: torch.Tensor, head: torch.Tensor,
                         labels: torch.Tensor, *, chunk: int = 512,
                         z_loss: float = 1e-4) -> torch.Tensor:
    """Mean token NLL (fp32) + z-loss without materializing the full
    [B, S, V] fp32 logits.

    A loop over sequence chunks of ``c`` tokens (the largest divisor of S
    up to ``chunk``, found as the reference does); each chunk's body runs
    under ``torch.utils.checkpoint``, so its logits are recomputed in the
    backward and live logits stay O(c * V)."""
    B, S, D = hidden.shape
    c = min(chunk, S)
    while S % c:
        c -= 1
    hs = hidden.reshape(B, S // c, c, D)
    ys = labels.reshape(B, S // c, c)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(S // c):
        total = total + checkpoint(_chunk_nll_sum, hs[:, i], head, ys[:, i],
                                   z_loss, use_reentrant=False)
    return total * f32_recip(B * S)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  z_loss: float = 1e-4) -> torch.Tensor:
    """Mean token NLL (fp32) + z-loss. logits [..., V]; labels [...] int."""
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    nll = lse - ll
    if z_loss:
        nll = nll + z_loss * lse ** 2
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.sum(nll) * f32_recip(nll.numel())
