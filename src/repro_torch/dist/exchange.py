"""The exchange substrate: the wire-mode gate, the codec and the local transports.

Counterpart of ``repro.dist.exchange``.  The engine produces, per shard, a
pair of send buffers ``(values [Pn, cap], ids [Pn, cap])`` — row ``q``
holds the messages bound for shard ``q``, ``ids`` are destination-local
vertex slots (-1 = empty).  Delivery is a shard transpose: receiver ``q``
ends with row ``p`` from every sender ``p``.

Ported here: the **local** transport (all shards in one ``[P, Pn, cap]``
tensor, delivered by ``transpose(0, 1)``), its deferred-delivery flavour
for crowded-cluster emulation (``DelayRing``, ``exchange_local_delayed``)
and the whole wire codec: ``none`` (raw int32 values and ids) and
``int16``/``int8`` (ints narrowed losslessly below a sentinel, floats
row-quantized in the aggregator's rounding direction, ids as int16 when
the shard width fits; ``dist/compression.py``).
``effective_compression`` is the single wire-safety decision point.

The **dist** transports (``exchange_dist``, ``exchange_dist_delayed``) run
one shard per rank of a ``torch.distributed`` process group: a rank's
``[Pn, cap]`` sends cross ``all_to_all_single`` (JAX's tiled
``all_to_all`` over the ``workers`` axis), through the same codec as the
local transport, so the two deliver the same bits in the same row order.
Neither gloo nor NCCL carries int16, so a payload of a dtype outside
``_NATIVE`` travels as its bytes (a ``uint8`` view, viewed back on
arrival).  A :class:`ShapeOnlyGroup` stands in for a process group where
only shapes matter (``core.engine.lower_tick_for_mesh``).

**Gradients.**  :func:`all_to_all`, :func:`all_gather` and
:func:`all_reduce_sum` are ``torch.autograd.Function``s, as JAX
differentiates its collectives under ``shard_map``: the all-to-all's
backward is the same all-to-all (equal splits make it its own adjoint),
the tiled all-gather's a reduce-scatter (sum) of the gradient, the
all-reduce's an all-reduce of the gradient.  The wire view is only the
forward's transport: a gradient crosses a permutation as its bytes, and
is summed in its own float dtype.

**Deferred delivery.**  A send buffer produced at tick ``t`` for link
``p -> q`` is parked in a :class:`DelayRing` and delivered at tick
``t + delays[p, q]``.  The ring is indexed by send tick modulo its length
with an explicit due tick per row, so time-varying delays never overwrite
a message in flight.  Messages are only deferred, never dropped, so the
self-stabilizing programs converge to the same fixpoint.  The ring is
kept functional (each tick builds new tensors, nothing is written in
place), so a snapshot that holds a ring holds it as it stood.

Layer contract: ``repro_torch.dist`` sits below ``repro_torch.core`` and
imports nothing above it.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.dist import compression as C

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

    @property
    def bits(self) -> int:
        return 8 if self.compression == "int8" else 16

    def encode(self, vals: torch.Tensor
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        if self.compression == "none":
            return vals, None
        if self.value_kind == "int32":
            return C.narrow_int(vals, self.bits), None
        return C.quantize_rows(vals, self.bits, self.quantize_direction)

    def decode(self, payload: torch.Tensor,
               scales: Optional[torch.Tensor]) -> torch.Tensor:
        if self.compression == "none":
            return payload
        if self.value_kind == "int32":
            return C.widen_int(payload, self.bits, self.identity,
                               torch.int32)
        return C.dequantize_rows(payload, scales, self.bits, self.identity,
                                 torch.float32)

    def encode_ids(self, ids: torch.Tensor) -> torch.Tensor:
        return ids.to(torch.int16) if self.compress_ids else ids

    def decode_ids(self, ids: torch.Tensor) -> torch.Tensor:
        return ids.to(torch.int32) if self.compress_ids else ids

    def wire_bytes_per_tick(self) -> int:
        """Bytes crossing the wire per tick, all shard pairs: every slot of
        the fixed-capacity buffers ships, and so does the float scale
        sidecar."""
        slots = self.num_shards * self.num_shards * self.capacity
        if self.compression == "none":
            val_b, id_b, scale_b = 4, 4, 0
        else:
            val_b = 1 if self.compression == "int8" else 2
            id_b = 2 if self.compress_ids else 4
            scale_b = 4 if self.value_kind == "float32" else 0
        return (slots * (val_b + id_b)
                + self.num_shards * self.num_shards * scale_b)


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


# ======================================================================
# The dist transport: one shard per rank of a process group
# ======================================================================
# the dtypes both backends carry as they are (gloo refuses int16; NCCL has
# no int16 and no bool type); any other payload rides as its bytes
_NATIVE = (torch.uint8, torch.int8, torch.int32, torch.int64, torch.float32,
           torch.float64)


class ShapeOnlyGroup(NamedTuple):
    """A stand-in for a process group of ``size`` ranks, seen from
    ``rank``, whose collectives move no data: an all-to-all returns an
    uninitialised buffer of the right shape, a sum returns its input.
    Only for tracing shapes (``lower_tick_for_mesh`` under fake tensors),
    never for a run.  Each collective appends ``(op, result_bytes,
    size)`` to ``log``, when there is one (HLO's op names;
    ``roofline.analysis.fold_collectives`` counts them)."""
    rank: int
    size: int
    log: Optional[list] = None


def _note(group: ShapeOnlyGroup, op: str, result: torch.Tensor) -> None:
    if group.log is not None:
        group.log.append((op, result.numel() * result.element_size(),
                          group.size))


def group_rank(group) -> int:
    if isinstance(group, ShapeOnlyGroup):
        return group.rank
    return dist.get_rank(group)


def group_size(group) -> int:
    if isinstance(group, ShapeOnlyGroup):
        return group.size
    return dist.get_world_size(group)


def as_wire(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a backend can carry it: contiguous, and a dtype outside
    ``_NATIVE`` viewed as its bytes along the last axis."""
    x = x.contiguous()
    return x if x.dtype in _NATIVE else x.view(torch.uint8)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    if isinstance(group, ShapeOnlyGroup):
        _note(group, "all-to-all", x)
        return torch.empty_like(x)
    wire = as_wire(x)
    out = torch.empty_like(wire)
    dist.all_to_all_single(out, wire, group=group)
    return out if out.dtype == x.dtype else out.view(x.dtype)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Rows ``[size * k, ...]`` -> rows ``[size * k, ...]``: block ``q`` of
    the result is the block this rank's peer ``q`` addressed to it (equal
    splits on dim 0).  Differentiable: the gradient takes the same
    route back."""
    return _AllToAll.apply(x, group)


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    wire = as_wire(x)
    parts = [torch.empty_like(wire) for _ in range(group_size(group))]
    dist.all_gather(parts, wire, group=group)
    return torch.cat([p if p.dtype == x.dtype else p.view(x.dtype)
                      for p in parts], dim)


def _reduce_scatter(g: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The sum over the group of each rank's ``g``, block ``group_rank``
    of it along ``dim`` (the tiled all-gather's adjoint), in ``g``'s
    dtype."""
    n = group_size(group)
    blocks = g.movedim(dim, 0).contiguous()
    out = blocks.new_empty((blocks.shape[0] // n,) + blocks.shape[1:])
    dist.reduce_scatter_tensor(out, blocks, op=dist.ReduceOp.SUM,
                               group=group)
    return out.movedim(0, dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` joined along ``dim`` in group-rank order (JAX's
    tiled ``all_gather``); a dtype outside ``_NATIVE`` crosses as its
    bytes (``as_wire``).  A group of one rank returns ``x`` (no copy
    through the backend, as XLA elides a gather over an axis of 1).
    Differentiable: the gradient is reduce-scattered (summed) back."""
    if group_size(group) == 1:
        return x
    return _AllGather.apply(x, group, dim % x.ndim)


def _all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    if isinstance(group, ShapeOnlyGroup):
        _note(group, "all-reduce", x)
        return x
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_sum(g, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group's ranks (``x`` is left as it was).
    Differentiable: each rank's gradient is the sum of every rank's (the
    adjoint of ``psum`` when each rank's loss holds its share)."""
    return _AllReduceSum.apply(x, group)


def exchange_dist(codec: WireCodec, send_vals: torch.Tensor,
                  send_ids: torch.Tensor, group
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One rank's ``[Pn, cap]`` send buffers -> its ``[Pn, cap]`` receive
    buffers over ``group`` (row ``q`` of the result is sender ``q``'s
    buffer for this rank).  The codec's round trip is
    :func:`exchange_local`'s, so the two transports deliver the same
    bits."""
    enc_v, scales = codec.encode(send_vals)
    rv = all_to_all(enc_v, group)
    ri = all_to_all(codec.encode_ids(send_ids), group)
    rs = all_to_all(scales, group) if scales is not None else None
    return codec.decode(rv, rs), codec.decode_ids(ri)


# ======================================================================
# Deferred delivery (crowded-cluster emulation — see module docstring)
# ======================================================================
class DelayRing(NamedTuple):
    """In-flight messages of the delayed transports (``due == -1``: an
    empty or delivered row).  Local: ``vals/ids [ring_len, P, Pn, cap]``,
    ``due [ring_len, P, Pn]``.  Dist: one rank rings only its own sends,
    ``vals/ids [ring_len, Pn, cap]``, ``due [ring_len, Pn]``."""

    vals: torch.Tensor
    ids: torch.Tensor
    due: torch.Tensor


def init_delay_ring(max_delay: int, num_senders: int, num_shards: int,
                    capacity: int, identity, dtype: torch.dtype,
                    device=None) -> DelayRing:
    """An empty ring able to carry any per-link delay <= ``max_delay``.
    ``num_senders`` is ``P`` for the local transport and ``0`` for one
    rank of the dist transport (the sender axis dropped)."""
    L1 = max_delay + 1
    lead = (L1, num_senders) if num_senders else (L1,)
    return DelayRing(
        torch.full(lead + (num_shards, capacity), identity, dtype=dtype,
                   device=device),
        torch.full(lead + (num_shards, capacity), -1, dtype=torch.int32,
                   device=device),
        torch.full(lead + (num_shards,), -1, dtype=torch.int32,
                   device=device))


def ring_pending(ring: DelayRing) -> torch.Tensor:
    """Messages still in flight (valid ids in rows not yet delivered)."""
    return ((ring.ids >= 0) & (ring.due >= 0)[..., None]).sum()


def _ring_push_pop(ring: DelayRing, send_vals, send_ids, tick, delays,
                   identity, recv_gate=None):
    """Park this tick's sends in slot ``tick % ring_len`` and surface every
    row whose due tick has arrived (masked to empty otherwise), retiring
    it.  ``recv_gate [Pn]`` (async schedule) surfaces a due row only on a
    step its receiver fires; otherwise it stays parked.  Returns
    ``(deliver_vals, deliver_ids, ring', pending)``; the deliverables keep
    the full ring extent, with identity values and ids of -1 in rows not
    due."""
    L1 = ring.vals.shape[0]
    slot = (tick % L1).reshape(1).to(torch.int64)
    vals = ring.vals.index_copy(0, slot, send_vals[None])
    ids = ring.ids.index_copy(0, slot, send_ids[None])
    due = ring.due.index_copy(
        0, slot, (tick + torch.clamp(delays, max=L1 - 1))[None].to(
            torch.int32))
    ready = (due >= 0) & (due <= tick)
    if recv_gate is not None:
        ready = ready & recv_gate  # [Pn] broadcasts onto the receiver axis
    dv = torch.where(ready[..., None], vals, identity)
    di = torch.where(ready[..., None], ids, -1)
    ring = DelayRing(vals, ids, torch.where(ready, -1, due))
    return dv, di, ring, ring_pending(ring)


def exchange_local_delayed(codec: WireCodec, ring: DelayRing,
                           send_vals: torch.Tensor, send_ids: torch.Tensor,
                           tick, delays, identity, recv_gate=None
                           ) -> Tuple[torch.Tensor, torch.Tensor, DelayRing,
                                      torch.Tensor]:
    """Deferred-delivery local transport.

    ``send_vals/send_ids [P, Pn, cap]`` are parked in ``ring`` and every
    due row is delivered through the same wire codec as the immediate
    transport: receiver ``q`` gets ``[ring_len * P, cap]`` buffers whose
    row ``l * P + p`` is sender ``p``'s buffer from ring slot ``l`` (the
    demotion reads the sender as ``row % P``).  ``delays [P, Pn]`` may
    change tick to tick; values above the ring's capacity clamp.
    Returns ``(recv_vals, recv_ids, ring', pending)``."""
    dv, di, ring, pending = _ring_push_pop(ring, send_vals, send_ids, tick,
                                           delays, identity, recv_gate)
    L1, P_ = dv.shape[0], dv.shape[1]
    rv, ri = exchange_local(codec, dv.reshape((L1 * P_,) + dv.shape[2:]),
                            di.reshape((L1 * P_,) + di.shape[2:]))
    return rv, ri, ring, pending


def exchange_dist_delayed(codec: WireCodec, ring: DelayRing,
                          send_vals: torch.Tensor, send_ids: torch.Tensor,
                          tick, delays_row, group, identity, recv_gate=None
                          ) -> Tuple[torch.Tensor, torch.Tensor, DelayRing,
                                     torch.Tensor]:
    """Deferred-delivery dist transport with a sender-side ring.

    A rank parks its own ``[Pn, cap]`` sends (``delays_row [Pn]``: its
    outgoing row of the delay matrix) and ships every ring slot each tick,
    due rows filled and the rest empty, so shapes stay static.  The result
    is ``[ring_len * Pn, cap]`` with row ``l * Pn + q`` = sender ``q``'s
    slot ``l``: the row order of :func:`exchange_local_delayed`, which the
    demotion reads the sender from (``row % Pn``).  ``recv_gate [Pn]``
    rides replicated: every sender gates its rows on the whole firing
    vector.  ``pending`` counts this rank's parked messages only."""
    dv, di, ring, pending = _ring_push_pop(ring, send_vals, send_ids, tick,
                                           delays_row, identity, recv_gate)
    # the collective splits dim 0, so the receiver axis goes first
    # ([Pn, L1, cap]) and comes back to [L1, Pn, cap] (senders) after it
    front = lambda x: x.permute(1, 0, 2)  # noqa: E731
    enc_v, scales = codec.encode(dv)
    rv = front(all_to_all(front(enc_v), group))
    ri = front(all_to_all(front(codec.encode_ids(di)), group))
    rs = (front(all_to_all(front(scales), group)) if scales is not None
          else None)
    rv, ri = codec.decode(rv, rs), codec.decode_ids(ri)
    L1, Pn = rv.shape[0], rv.shape[1]
    return (rv.reshape((L1 * Pn,) + rv.shape[2:]),
            ri.reshape((L1 * Pn,) + ri.shape[2:]), ring, pending)
