"""Roofline terms of a step on one NVIDIA H100 (the counterpart of
``repro.roofline.analysis``).

  compute    = FLOPs / PEAK_FLOPS
  memory     = bytes / HBM_BW
  collective = ring-model bytes on the wire / (links * LINK_BW)

The reference reads its FLOPs and bytes from XLA's ``cost_analysis`` of a
compiled step and its collectives from the optimized HLO text.  The port
has no compiler: its FLOPs and bytes are counted op by op while the step
runs on shape-only tensors (``roofline/probes.py``), and its collectives
are explicit calls, which a :class:`~repro_torch.dist.exchange.
ShapeOnlyGroup` with a ``log`` records as ``(op, result_bytes,
group_size)`` (``core.engine.lower_tick_for_mesh(..., log=[])``);
:func:`fold_collectives` counts them into the same
:class:`CollectiveStats` list that :func:`parse_collectives` builds from
HLO text.  :func:`parse_collectives` is kept as the reference's, to read
the HLO text a JAX dry-run record holds.

**The card's peaks** (NVIDIA's H100 SXM data sheet, dense rates at the
full 700 W power limit):
``PEAK_FLOPS`` is bf16 on the tensor cores, ``HBM_BW`` the device
memory's rate, ``LINK_BW`` NVLink to the other cards of one host, each
way.  A card set below 700 W runs slower under load.

**The link model.**  A 16 x 16 mesh of H100s is 32 hosts of 8 cards; the
``model`` axis of 16 crosses hosts, whose network is slower than NVLink.
The collective term prices every byte at NVLink's rate, so it is a lower
bound on the wire time, not a prediction; no inter-host model is made
up here.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional

PEAK_FLOPS = 989e12  # bf16 dense, tensor cores, per card
HBM_BW = 3.35e12  # bytes/s per card
LINK_BW = 450e9  # bytes/s per card each way, NVLink within a host

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_GROUPS_BRACE_RE = re.compile(r"replica_groups=\{\{([^}]*)\}")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]<=")

COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                  "collective-permute")


@dataclasses.dataclass
class CollectiveStats:
    op: str
    result_bytes: int
    group_size: int
    wire_bytes: float  # ring-model per-device bytes on wire
    count: int = 1


def _shape_bytes(dtype: str, dims: str) -> int:
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return n * _DTYPE_BYTES.get(dtype, 4)


def _group_size(line: str) -> int:
    m = _GROUPS_IOTA_RE.search(line)
    if m:
        return int(m.group(2))
    m = _GROUPS_BRACE_RE.search(line)
    if m:
        return len(m.group(1).split(","))
    return 1


def _wire_bytes(op: str, result_bytes: int, n: int) -> float:
    """Per-device ring-model bytes on wire."""
    if n <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * result_bytes * (n - 1) / n
    if op == "all-gather":  # result is the gathered (big) buffer
        return result_bytes * (n - 1) / n
    if op == "reduce-scatter":  # result is the scattered (small) shard
        return result_bytes * (n - 1)
    if op == "all-to-all":
        return result_bytes * (n - 1) / n
    if op == "collective-permute":
        return float(result_bytes)
    return 0.0


def fold_collectives(entries) -> list[CollectiveStats]:
    """``(op, result_bytes, group_size)`` entries as one
    :class:`CollectiveStats` a distinct key, counted and summed."""
    out: dict[tuple, CollectiveStats] = {}
    for op, rbytes, n in entries:
        key = (op, rbytes, n)
        if key in out:
            out[key].count += 1
            out[key].wire_bytes += _wire_bytes(op, rbytes, n)
        else:
            out[key] = CollectiveStats(op, rbytes, n,
                                       _wire_bytes(op, rbytes, n))
    return list(out.values())


def parse_collectives(hlo_text: str) -> list[CollectiveStats]:
    """The collectives of an optimized HLO text (a JAX dry-run record's),
    as the reference parses them."""
    entries = []
    for line in hlo_text.splitlines():
        stripped = line.strip()
        op_found: Optional[str] = None
        for op in COLLECTIVE_OPS:
            token = f" {op}("
            if token in stripped or stripped.startswith(f"{op}("):
                # exclude -start/-done duplicates (count the -start only)
                if f"{op}-done" in stripped:
                    op_found = None
                    break
                op_found = op
                break
        if not op_found:
            continue
        # result shapes: everything left of the op token
        lhs = stripped.split(f"{op_found}(")[0]
        shapes = _SHAPE_RE.findall(lhs)
        rbytes = sum(_shape_bytes(dt, dims) for dt, dims in shapes)
        if rbytes == 0:
            continue
        entries.append((op_found, rbytes, _group_size(stripped)))
    return fold_collectives(entries)


@dataclasses.dataclass
class Roofline:
    flops: float  # per-device
    bytes_accessed: float  # per-device HBM traffic
    collective_wire_bytes: Optional[float]  # per-device; None: not modelled
    compute_s: float
    memory_s: float
    collective_s: Optional[float]
    dominant: str
    collectives: list

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["collectives"] = [dataclasses.asdict(c) for c in self.collectives]
        return d


def analyze(cost: dict, *, links: int = 1) -> Roofline:
    """The roofline of a cost record ``{"flops", "bytes", "collectives"}``
    (a probe's, or the dry run's of a tick): ``collectives`` a list of
    :class:`CollectiveStats`, or ``None`` where the port models no wire
    (its collective term is then ``None`` and cannot dominate).  ``links``
    is the NVLink directions a ring uses at once (one: a ring sends to
    one neighbour)."""
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes", 0.0))
    cols = cost.get("collectives")
    wire = None if cols is None else sum(c.wire_bytes for c in cols)
    compute_s = flops / PEAK_FLOPS
    memory_s = byts / HBM_BW
    collective_s = None if wire is None else wire / (links * LINK_BW)
    terms = {"compute": compute_s, "memory": memory_s}
    if collective_s is not None:
        terms["collective"] = collective_s
    dominant = max(terms, key=terms.get)
    return Roofline(flops, byts, wire, compute_s, memory_s, collective_s,
                    dominant, cols or [])


def model_flops(cfg, shape, kind: str) -> float:
    """MODEL_FLOPS = 6·N(_active)·tokens for train; 2·N·tokens for inference."""
    n_active = cfg.active_param_count()
    if kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch  # decode: one token per sequence
    return 2.0 * n_active * tokens
