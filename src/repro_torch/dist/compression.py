"""Message and gradient compression: quantized buffers and a compressed
all-reduce (the counterpart of ``repro.dist.compression``).

Two consumers, one toolbox:

  * the trainer's gradient exchange: :func:`compressed_psum` (an int8
    error-feedback mean all-reduce over a ``torch.distributed`` group)
    and :func:`ef_compress_tree` (the same quantize/dequantize round trip
    with a carried residual, which the microbatch loop of
    ``train/trainer.py`` runs where the per-microbatch reduction would go
    on the wire).  Whole-tensor int8 on a symmetric 127-level grid; the
    decode's ``scale / 127`` is a product with the float32 reciprocal of
    127, as XLA compiles the reference under ``jit``;
  * the engine's message buffers (``quantize_rows``, ``dequantize_rows``,
    ``narrow_int``, ``widen_int``), which ``repro_torch.dist.exchange``
    runs on every send buffer when the wire mode is ``int16`` or ``int8``:

  * float payloads (SSSP distances, widest-path widths) quantize per
    destination row against the row's largest finite magnitude, rounded
    in the aggregator's direction: *ceil* for min-monotone programs so a
    decoded value never under-estimates, *floor* for max-monotone ones so
    it never over-estimates.  Non-finite entries (an infinite identity)
    take the sentinel code ``qmax + 1``;
  * int payloads (labels, hops, reachability bits) narrow losslessly
    below a sentinel code that decodes back to the aggregation identity.

The arithmetic is spelled as the JAX package's engine computes it under
``jit`` on the CPU, so both packages put the same bits on the wire:
``vals / scale`` is a true division by the row scale, and the decode's
``scale / qmax`` is a product with the float32 reciprocal of ``qmax``
(XLA rewrites a division by a constant so; 126 and 32766 are not powers
of two, so the two spellings differ by an ulp).  A product with that
reciprocal is also what the card computes for a division by a host
scalar, so the decode is device-independent as written.

Layer contract: imports only torch and numpy; ``repro_torch.dist.exchange``
and ``repro_torch.train.trainer`` are its consumers.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

_EPS = 1e-30
_R127 = float(np.float32(1.0) / np.float32(127.0))  # XLA's scale / 127.0


# ======================================================================
# Whole-tensor quantization (gradients)
# ======================================================================
def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x -> (int8 codes, float32 0-d scale); symmetric 127-level grid."""
    scale = torch.clamp(torch.amax(torch.abs(x)), min=_EPS).to(torch.float32)
    q = torch.round(x.to(torch.float32) / scale * 127.0)
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape,
                    dtype: torch.dtype) -> torch.Tensor:
    return (q.to(torch.float32) * (scale * _R127)).reshape(shape).to(dtype)


def ef_compress(x: torch.Tensor, error: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback round trip: returns (decoded, new residual).

    ``decoded`` is what the wire would deliver; the residual (what
    quantization dropped) is for the caller to add into the next round's
    input, which keeps compressed reductions unbiased over time."""
    if error is not None:
        x = x + error
    q, s = quantize_int8(x)
    decoded = dequantize_int8(q, s, x.shape, x.dtype)
    return decoded, _residual(x, q, s)


def _residual(x, q, scale) -> torch.Tensor:
    """``x - q * (scale / 127)`` with one rounding (XLA's fused form)."""
    return torch.addcmul(x.to(torch.float32), q.to(torch.float32),
                         scale * _R127, value=-1).to(x.dtype)


def ef_compress_tree(grads: dict, errors: Optional[dict]
                     ) -> Tuple[dict, dict]:
    """:func:`ef_compress` over every leaf of a dict (the port's parameter
    dict, ``transformer.param_dict``); ``errors=None`` starts at zero."""
    decoded, new_err = {}, {}
    for k, g in grads.items():
        decoded[k], new_err[k] = ef_compress(
            g, torch.zeros_like(g) if errors is None else errors[k])
    return decoded, new_err


def compressed_psum(x: torch.Tensor, group=None,
                    error: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 error-feedback mean all-reduce over the ranks of ``group``.

    Every rank quantizes against a shared scale (an ``all_reduce`` MAX),
    sums the codes as int32 and dequantizes the sum: 1 byte an element on
    the wire plus one float32 scale.  Returns (mean, residual); callers
    carry the residual into the next call."""
    if error is not None:
        x = x + error
    scale = torch.amax(torch.abs(x)).to(torch.float32).reshape(1)
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp(scale[0], min=_EPS)
    q = torch.clamp(torch.round(x.to(torch.float32) / scale * 127.0),
                    -127, 127).to(torch.int8)
    n = torch.ones(1, dtype=torch.float32, device=x.device)
    dist.all_reduce(n, group=group)
    total = q.to(torch.int32)
    dist.all_reduce(total, group=group)
    out = (total.to(torch.float32) * (scale * _R127) / n[0]).to(x.dtype)
    return out, _residual(x, q, scale)


# ======================================================================
# Row-quantized buffers (engine wire format for float payloads)
# ======================================================================


def _qmax(bits: int) -> int:
    assert bits in (8, 16), bits
    return (1 << (bits - 1)) - 2  # 126 / 32766; qmax + 1 is the inf sentinel


def _narrow_dtype(bits: int) -> torch.dtype:
    return torch.int8 if bits == 8 else torch.int16


def quantize_rows(vals: torch.Tensor, bits: int, direction: str = "up"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 ``[..., cap]`` -> (intN codes, float32 ``[..., 1]`` row
    scales).  ``direction`` ``"up"`` (ceil): decoded >= original;
    ``"down"`` (floor): decoded <= original."""
    assert direction in ("up", "down"), direction
    qmax = _qmax(bits)
    finite = torch.isfinite(vals)
    mag = torch.where(finite, torch.abs(vals), 0.0)
    scale = torch.clamp(torch.amax(mag, dim=-1, keepdim=True), min=_EPS)
    # rounding in the signed domain keeps the guarantee for every sign
    rnd = torch.ceil if direction == "up" else torch.floor
    q = rnd(vals / scale * qmax)
    q = torch.where(finite, torch.clamp(q, -qmax, qmax), float(qmax + 1))
    return q.to(_narrow_dtype(bits)), scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor, bits: int,
                    identity, dtype: torch.dtype) -> torch.Tensor:
    qmax = _qmax(bits)
    recip = float(np.float32(1.0) / np.float32(qmax))
    v = q.to(torch.float32) * (scale * recip)
    return torch.where(q == qmax + 1, float(identity), v).to(dtype)


def narrow_int(vals: torch.Tensor, bits: int) -> torch.Tensor:
    """int32 -> intN with the top code (127 / 32767) reserved as the
    sentinel.  Lossless iff every real value is below it (the wire gate,
    ``exchange.effective_compression``, checks that bound); a value at or
    above it saturates to the sentinel, which decodes to the identity.
    Negative identities (max's -1) fit the narrow formats directly."""
    sentinel = (1 << (bits - 1)) - 1
    return torch.where(vals >= sentinel, sentinel, vals).to(
        _narrow_dtype(bits))


def widen_int(q: torch.Tensor, bits: int, identity,
              dtype: torch.dtype) -> torch.Tensor:
    sentinel = (1 << (bits - 1)) - 1
    wide = q.to(torch.int32)
    return torch.where(wide == sentinel, int(identity), wide).to(dtype)
