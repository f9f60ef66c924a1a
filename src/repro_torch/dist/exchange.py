"""The exchange substrate: the wire-mode gate, the codec and the local transport.

Counterpart of ``repro.dist.exchange``.  The engine produces, per shard, a
pair of send buffers ``(values [Pn, cap], ids [Pn, cap])`` — row ``q``
holds the messages bound for shard ``q``, ``ids`` are destination-local
vertex slots (-1 = empty).  Delivery is a shard transpose: receiver ``q``
ends with row ``p`` from every sender ``p``.

This slice ports the **local** transport (all shards in one ``[P, Pn, cap]``
tensor, delivered by ``transpose(0, 1)``) and the raw wire mode ``none``.
``effective_compression`` — the single wire-safety decision point — is
ported whole, so configs gate to the same mode as in the JAX package; a
codec whose gated mode is ``int16``/``int8`` refuses to encode instead of
shipping raw data (ROADMAP queue 1, item 6).  The multi-rank transport and
the deferred-delivery ring wait for their slices (items 12 and 8).

Layer contract: ``repro_torch.dist`` sits below ``repro_torch.core`` and
imports nothing above it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

_INT_SENTINEL = {8: 127, 16: 32767}


def effective_compression(requested: str, value_kind: str,
                          max_int_value: int = 0,
                          idempotent: bool = True) -> str:
    """Gate a requested wire mode against what the payload can carry.

    * an unknown mode is a config typo -> ``ValueError``;
    * a non-idempotent aggregator (``idempotent=False``) admits no lossy
      mode -> ``"none"``;
    * int payloads only narrow when every real value stays below the
      sentinel code (an int8 request whose labels fit int16 degrades to
      int16) -> otherwise ``"none"``;
    * float payloads under an idempotent aggregator always admit
      quantization.
    """
    if requested in (None, "", "none"):
        requested = "none"
    elif requested not in ("int8", "int16"):
        raise ValueError(
            f"unknown wire_compression {requested!r}; "
            f"valid modes: 'none', 'int16', 'int8'")
    if requested == "none" or not idempotent:
        return "none"
    if value_kind == "float32":
        return requested
    bits = 8 if requested == "int8" else 16
    if max_int_value < _INT_SENTINEL[bits]:
        return requested
    if max_int_value < _INT_SENTINEL[16]:
        return "int16"  # requested int8 can't hold the labels; int16 can
    return "none"


@dataclasses.dataclass(frozen=True)
class WireCodec:
    """Static description of one exchange's wire format."""
    num_shards: int
    capacity: int
    compression: str  # effective: "none" | "int16" | "int8"
    value_kind: str  # "int32" | "float32"
    identity: float  # decode target for the sentinel code
    compress_ids: bool  # ids as int16 (requires vs <= 32766)
    quantize_direction: str = "up"

    def _require_raw(self) -> None:
        if self.compression != "none":
            raise NotImplementedError(
                f"wire mode {self.compression!r} is not ported yet "
                "(ROADMAP queue 1, item 6: dist/compression.py); only "
                "'none' encodes")

    def encode(self, vals: torch.Tensor
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        self._require_raw()
        return vals, None

    def decode(self, payload: torch.Tensor,
               scales: Optional[torch.Tensor]) -> torch.Tensor:
        self._require_raw()
        return payload

    def encode_ids(self, ids: torch.Tensor) -> torch.Tensor:
        self._require_raw()
        return ids

    def decode_ids(self, ids: torch.Tensor) -> torch.Tensor:
        self._require_raw()
        return ids


def make_wire_codec(num_shards: int, capacity: int, vs: int,
                    requested: str, value_kind: str, identity,
                    max_int_value: int = 0,
                    quantize_direction: str = "up",
                    idempotent: bool = True) -> WireCodec:
    mode = effective_compression(requested, value_kind, max_int_value,
                                 idempotent)
    return WireCodec(
        num_shards=num_shards, capacity=capacity, compression=mode,
        value_kind=value_kind, identity=float(identity)
        if value_kind == "float32" else int(identity),
        compress_ids=(mode != "none" and vs <= _INT_SENTINEL[16] - 1),
        quantize_direction=quantize_direction)


def exchange_local(codec: WireCodec, send_vals: torch.Tensor,
                   send_ids: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[P, Pn, cap] send buffers -> [Pn, P, cap] receive buffers.

    The encode/decode round-trip runs even though no wire is crossed, as
    in the JAX package, so a later multi-rank transport with the same
    codec stays bit-identical to this one."""
    enc_v, scales = codec.encode(send_vals)
    enc_i = codec.encode_ids(send_ids)
    rv = enc_v.transpose(0, 1)
    ri = enc_i.transpose(0, 1)
    rs = scales.transpose(0, 1) if scales is not None else None
    return codec.decode(rv, rs), codec.decode_ids(ri)
