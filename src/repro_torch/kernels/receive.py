"""The engine tick's receive: deliver a tick's messages into the state.

Counterpart of the delivery in ``repro.core.engine._phase2_receive``, an
XLA scatter there; no Pallas kernel is replaced.  ``deliver`` takes the
receive buffers ``[P, R, C]`` (any row strides, each row's ids
contiguous: the transposed views of ``dist/exchange.py::exchange_local``
are taken as they are) and applies
the aggregator's idempotent ⊕ (min, max, or) for every live slot
(``id >= 0``) of shard ``p`` into its row of the state:

    values'  = values ⊕ every message
    changed  = improves(values', values)
    active'  = active | changed;  cursor' = where(changed, 0, cursor)
    accepted = per shard, the messages with improves(val, values[id])

The inputs are left as they are: the outputs are new tensors (a forked
session may share its state's tensors with its parent, and the crowded
tick's demotion compares the planes before and after).

For CUDA tensors the kernel ``csrc/engine_receive.cu`` computes it in one
launch.  The plain version below (``deliver_ref``), one
``scatter_reduce_`` over every padded slot, sweeps all ``P x R x C``
slots and aims each empty one at one spare index a row; at the
benchmark's shape (``[8, 8, 255 k]``, about 9 k live slots) that took
7.45 ms of an 11.0 ms tick (PERF.md).  The kernel is bound by the id scan
(4 bytes a slot, 65 MB there, 20 us at 3.35 TB/s): it reads every id once
as 16-byte vectors, and loads a value, reads the old plane and applies an
atomic only for a live slot; float min and max are exact atomics for every
non-NaN value.  ⊕ and ``improves``
are independent of order, so both versions give the same bits.  It
allocates nothing of the padded size.

``deliver`` launches the kernel for CUDA tensors and takes the plain
version only for tensors on the CPU; there is no fallback from one to the
other.
"""
from __future__ import annotations

import ctypes

import torch

# the C entry point's aggregator and dtype codes (csrc/engine_receive.cu);
# or is max over {0, 1}
_AGG_CODE = {"min": 0, "max": 1, "or": 1}
_DTYPE_CODE = {torch.int32: 0, torch.float32: 1}


def deliver_ref(agg, old, active, cursor, recv_vals, recv_ids):
    """The plain version: one scatter-⊕ over every padded slot."""
    vs = old.shape[-1]
    P = old.shape[0]
    ids = recv_ids.reshape(P, -1)
    vals = recv_vals.reshape(P, -1).to(old.dtype)
    valid = ids >= 0
    idx = torch.where(valid, ids, vs)  # vs -> dropped (out of bounds)
    values = agg.scatter(old, idx, vals)
    prev = torch.gather(old, 1, torch.clamp(idx, 0, vs - 1).to(torch.int64))
    accepted = (valid & agg.improves(vals, prev)).sum(dim=1)
    changed = agg.improves(values, old)
    active = active | changed
    cursor = torch.where(changed, 0, cursor)
    return values, active, cursor, accepted


def deliver(agg, old, active, cursor, recv_vals, recv_ids):
    """``(values', active', cursor', accepted [P] int64)`` after delivering
    ``recv_vals`` / ``recv_ids [P, R, C]`` (int32 ids, -1 = empty) into
    the ``[P, vs]`` planes ``old`` (values), ``active`` (bool) and
    ``cursor`` (int32), with the idempotent aggregator ``agg``."""
    if old.device.type == "cpu":
        return deliver_ref(agg, old, active, cursor, recv_vals, recv_ids)
    if old.device.type != "cuda":
        raise ValueError(f"no kernel for device {old.device}")
    if agg.name not in _AGG_CODE:
        raise ValueError(f"the receive kernel takes an idempotent aggregator "
                         f"(min, max, or), got {agg.name!r}")
    if old.dtype not in _DTYPE_CODE or recv_vals.dtype != old.dtype:
        raise TypeError(f"values must be int32 or float32 and the messages "
                        f"of the same dtype, got {old.dtype} and "
                        f"{recv_vals.dtype}")
    if recv_ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {recv_ids.dtype}")
    if active.dtype != torch.bool or cursor.dtype != torch.int32:
        raise TypeError("active must be bool and cursor int32")
    P, vs = old.shape
    if active.shape != old.shape or cursor.shape != old.shape:
        raise ValueError("values, active and cursor must share one shape")
    if recv_ids.dim() != 3 or recv_ids.shape != recv_vals.shape \
            or recv_ids.shape[0] != P:
        raise ValueError(f"receive buffers must be [P, R, C] of one shape "
                         f"with P = {P}, got {tuple(recv_ids.shape)} and "
                         f"{tuple(recv_vals.shape)}")
    for t in (active, cursor, recv_vals, recv_ids):
        if t.device != old.device:
            raise ValueError("all inputs must be on one device")
    R, C = recv_ids.shape[1], recv_ids.shape[2]
    if recv_ids.stride(-1) != 1 and C > 1:
        raise ValueError(f"the receive kernel reads each row's ids as one "
                         f"run: their innermost stride must be 1, got "
                         f"{recv_ids.stride(-1)}")
    if P * R > 65535:
        raise ValueError(f"at most 65,535 receive rows, got {P * R}")
    fmt = torch.contiguous_format
    values = old.clone(memory_format=fmt)
    active = active.clone(memory_format=fmt)
    cursor = cursor.clone(memory_format=fmt)
    accepted = torch.zeros((P,), dtype=torch.int64, device=old.device)
    old = old.contiguous()

    from repro_torch.kernels import _build
    lib = _build.load("engine_receive")
    device = old.device
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    stream = torch.cuda.current_stream(index).cuda_stream
    strides = ctypes.c_longlong * 3
    err = lib.engine_receive_launch(
        index, _AGG_CODE[agg.name], _DTYPE_CODE[old.dtype],
        ctypes.c_void_p(recv_ids.data_ptr()),
        ctypes.c_void_p(recv_vals.data_ptr()),
        strides(*recv_ids.stride()), strides(*recv_vals.stride()),
        P, R, C, ctypes.c_void_p(old.data_ptr()),
        ctypes.c_void_p(values.data_ptr()),
        ctypes.c_void_p(active.data_ptr()),
        ctypes.c_void_p(cursor.data_ptr()), vs,
        ctypes.c_void_p(accepted.data_ptr()), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"engine_receive kernel launch failed: CUDA error "
                           f"{err} ({_build.error_string(lib, err)})")
    deliver.launches += 1
    return values, active, cursor, accepted


# launches of the CUDA kernel in this process (CPU calls never count)
deliver.launches = 0
