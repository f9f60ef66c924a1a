"""The engine tick's create on the card: select, fetch, create and route.

Counterpart of ``repro.core.engine._phase1_create`` for the idempotent
programs (cc, sssp, bfs, reachability, widest_path, labelprop), XLA code
there; no Pallas kernel is replaced.  ``create`` takes the arguments of
``core/engine.py::_phase1_create`` without ``aux`` and returns what it
returns: ``(active, cursor, send_vals [P, Pn, cap], send_ids [P, Pn, cap],
sent [P], fetched [P], values, None)``, bitwise the same, with ``values``
handed back as it came.  The inputs are left as they are: ``active`` and
``cursor`` come out as new tensors (a forked session may share its
state's tensors with its parent).

``_phase1_create``'s plain code is the plain version: it stays the path
on the CPU (fake tensors included) and for push-mode programs on every
device.  At the benchmark's shapes it ran some 160 torch ops over every
padded ``[P, M, D]`` fetch slot, 2.74 ms a tick in WCC and about 5 ms in
SSSP (PERF.md), where a few thousand slots carry a message.  The kernels
of ``csrc/engine_create.cu`` touch the ``[P, vs]`` planes a fixed number
of times, the selected vertices' edge windows and the send buffers, which
they fill once; six launches in one C call, no sort, a few MB of scratch.

For a CUDA tensor ``create`` launches them or raises; there is no
fallback to the plain version.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

# the kernel's combine codes (csrc/engine_create.cu) of the six programs:
# copy, float add (the weight, or 1.0), int add 1, float min (the weight,
# or 1.0)
_COMBINE = {"cc": 0, "reachability": 0, "labelprop": 0, "sssp": 1,
            "bfs": 2, "widest_path": 3}
_PRIORITY = {"disabled": 0, "linear": 1, "log": 2}
# the aggregators' priority_key: pv (min) or scale - pv (max, or)
_KEY_INVERT = {"min": 0, "max": 1, "or": 1}


@functools.lru_cache(maxsize=64)
def _constants(prog, ep) -> tuple:
    """The launch's program and parameter codes: ``(key_invert, priority,
    demote_by, combine, identity bits)`` and ``(scale, 1 / scale, rho)``
    rounded to float32 as torch's float32 ops round them."""
    np_dtype = np.int32 if prog.tdtype == torch.int32 else np.float32
    ident = int(np.array(prog.identity, np_dtype).view(np.uint32))
    scale = np.float32(ep.priority_scale)
    return ((_KEY_INVERT[prog.aggregator.name], _PRIORITY[ep.priority],
             ep.straggler_demote, _COMBINE[prog.name], ident),
            (float(scale), float(np.float32(1.0) / scale),
             float(np.float32(ep.enforce_fraction))))


@functools.lru_cache(maxsize=None)
def _workspace_bytes(P: int, vs: int, M: int, D: int, Pn: int) -> int:
    from repro_torch.kernels import _build
    return int(_build.load("engine_create").engine_create_workspace_bytes(
        P, vs, M, D, Pn))


def create(prog, ep, values, active, cursor, row_ptr, col_idx, weights,
           throttle=None, demote=None, stream_window=None):
    """``_phase1_create`` of an idempotent program on the card: ``(active,
    cursor, send_vals, send_ids, sent, fetched, values, None)``.
    ``throttle``, ``demote`` and ``stream_window`` are optional, as
    there."""
    if not prog.aggregator.idempotent or prog.bucketize is not None:
        raise ValueError(f"the create kernel takes an idempotent program "
                         f"with the engine's buckets, got {prog.name!r}")
    if prog.name not in _COMBINE:
        raise ValueError(f"no create kernel for the program {prog.name!r}; "
                         f"it knows {sorted(_COMBINE)}")
    if ep.priority not in _PRIORITY:
        raise ValueError(f"unknown priority {ep.priority!r}")
    P, vs = values.shape
    M, D, Pn, cap = (ep.max_vertices_per_tick, ep.degree_window,
                     ep.num_shards, ep.route_capacity)
    if vs != ep.vs:
        raise ValueError(f"values hold {vs} vertices a shard, the params "
                         f"{ep.vs}")
    if values.dtype != prog.tdtype:
        raise TypeError(f"{prog.name} values are {prog.tdtype}, got "
                        f"{values.dtype}")
    if active.dtype != torch.bool or cursor.dtype != torch.int32:
        raise TypeError("active must be bool and cursor int32")
    if row_ptr.dtype != torch.int32 or col_idx.dtype != torch.int32:
        raise TypeError("row_ptr and col_idx must be int32")
    if weights is not None and weights.dtype != torch.float32:
        raise TypeError(f"weights must be float32, got {weights.dtype}")
    es = col_idx.shape[-1]
    if active.shape != (P, vs) or cursor.shape != (P, vs) \
            or row_ptr.shape != (P, vs + 1) or col_idx.shape != (P, es) \
            or (weights is not None and weights.shape != (P, es)):
        raise ValueError("values, active and cursor must be [P, vs], "
                         "row_ptr [P, vs + 1], col_idx and weights [P, es]")
    demote = demote if ep.straggler_demote else None
    if demote is not None and (demote.dtype != torch.bool
                               or demote.shape != (P, vs)):
        raise ValueError("demote must be a bool [P, vs] plane")
    for name, x in (("throttle", throttle), ("stream_window", stream_window)):
        if x is not None and x.shape != (P,):
            raise ValueError(f"{name} must be [P], got {tuple(x.shape)}")
    if min(M, D, cap) <= 0:
        raise ValueError(f"M, D and cap must be positive, got {M}, {D}, "
                         f"{cap}")
    if not 0 < Pn <= 512 or P > 65535:
        raise ValueError(f"the create kernel routes to 1-512 shards from at "
                         f"most 65,535, got {Pn} and {P}")
    device = values.device
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    inputs = [values, active, cursor, row_ptr, col_idx, weights, throttle,
              demote, stream_window]
    for t in inputs:
        if t is not None and t.device != device:
            raise ValueError("all inputs must be on one device")
    (vals, active, cursor, row_ptr, col_idx, weights, throttle, demote,
     stream_window) = [t if t is None else t.contiguous() for t in inputs]
    if throttle is not None:
        throttle = throttle.to(torch.int32)
    if stream_window is not None:
        stream_window = stream_window.to(torch.int32)

    from repro_torch.kernels import _build
    lib = _build.load("engine_create")
    ws_bytes = _workspace_bytes(P, vs, M, D, Pn)
    active_out = torch.empty_like(active)
    cursor_out = torch.empty_like(cursor)
    send_vals = torch.empty((P, Pn, cap), dtype=vals.dtype, device=device)
    send_ids = torch.empty((P, Pn, cap), dtype=torch.int32, device=device)
    counts = torch.empty((2, P), dtype=torch.int64, device=device)
    workspace = torch.empty((ws_bytes,), dtype=torch.uint8, device=device)
    codes, reals = _constants(prog, ep)
    ints = (ctypes.c_longlong * 13)(
        P, vs, M, D, Pn, cap, es, int(vals.dtype == torch.float32), *codes)
    floats = (ctypes.c_float * 3)(*reals)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    ptrs = (ctypes.c_void_p * 15)(*map(ptr, (
        vals, active, cursor, row_ptr, col_idx, weights, throttle, demote,
        stream_window, active_out, cursor_out, send_vals, send_ids, counts,
        workspace)))
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    stream = torch.cuda.current_stream(index).cuda_stream
    err = lib.engine_create_launch(index, ints, floats, ptrs, ws_bytes,
                                   ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"engine_create kernels' launch failed: CUDA error "
                           f"{err} ({_build.error_string(lib, err)})")
    create.launches += 1
    return (active_out, cursor_out, send_vals, send_ids, counts[0],
            counts[1], values, None)


# calls that launched the CUDA kernels in this process, one a tick (CPU
# calls never count)
create.launches = 0
