"""The engine's wire formats: row-quantized floats and narrowed ints.

Counterpart of the message half of ``repro.dist.compression``
(``quantize_rows``, ``dequantize_rows``, ``narrow_int``, ``widen_int``),
which ``repro_torch.dist.exchange`` runs on every send buffer when the
wire mode is ``int16`` or ``int8``:

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

The gradient half (``ef_compress``, ``compressed_psum``) is not ported
(ROADMAP queue 1, item 14).

Layer contract: imports only torch and numpy; ``repro_torch.dist.exchange``
is its only consumer.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

_EPS = 1e-30


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
