"""Shared by the receive tests (``test_torch_receive.py`` on the CPU,
``test_torch_gpu.py`` on the card): receive buffers in the layouts the
engine hands ``kernels/receive.py::deliver``, and a reference that
delivers one message at a time."""
import numpy as np
import torch

from repro_torch.core.semiring import AGGREGATORS
from repro_torch.dist import exchange as ex_mod

# (aggregator, dtype): every idempotent form the engine's programs use
FORMS = [("min", torch.int32), ("min", torch.float32),
         ("max", torch.int32), ("max", torch.float32),
         ("or", torch.int32)]
LAYOUTS = ["contiguous", "exchange_view", "holes", "all_empty",
           "duplicates", "ties", "last_id"]

P, CAP, VS = 3, 37, 50  # an odd cap: the exchange view's rows sit unaligned


def form_id(form) -> str:
    name, dtype = form
    return f"{name}-{str(dtype).replace('torch.', '')}"


def _draw(rng, name, dtype, shape):
    """Values from a small set, negative floats included for min and max,
    so that ties and duplicates are common."""
    if name == "or":
        return rng.integers(0, 2, shape).astype(np.int32)
    if dtype == torch.int32:
        return rng.integers(-1 if name == "max" else 0, 40,
                            shape).astype(np.int32)
    return (rng.integers(-40, 40, shape) / 2).astype(np.float32)


def make_case(form, layout, device, seed=0, shape=(P, P, CAP), vs=VS,
              live=0.3):
    """``(old, active, cursor, recv_vals, recv_ids)`` on ``device``: the
    state planes ``[P, vs]`` and receive buffers ``[P, R, C]`` in
    ``layout``, the same numbers on every device for one seed."""
    name, dtype = form
    agg = AGGREGATORS[name]
    kind = "float32" if dtype == torch.float32 else "int32"
    identity = agg.identity(kind)
    rng = np.random.default_rng(seed)
    p, r, c = shape
    old = _draw(rng, name, dtype, (p, vs))
    active = rng.random((p, vs)) < 0.2
    cursor = rng.integers(0, 9, (p, vs)).astype(np.int32)
    ids = np.where(rng.random(shape) < live,
                   rng.integers(0, vs, shape), -1).astype(np.int32)
    vals = _draw(rng, name, dtype, shape)
    if layout == "holes":  # a live prefix with holes, then an empty tail
        ids = rng.integers(0, vs, shape).astype(np.int32)
        ids[..., ::3] = -1
        ids[..., 2 * c // 3:] = -1
    elif layout == "all_empty":
        ids[:] = -1
    elif layout == "duplicates":  # a handful of targets, many messages each
        ids = np.where(ids >= 0, rng.integers(0, 4, shape), -1
                       ).astype(np.int32)
    elif layout == "ties":  # half the live messages equal the old value
        rows = np.broadcast_to(np.arange(p)[:, None, None], shape)
        tie = (ids >= 0) & (rng.random(shape) < 0.5)
        vals = np.where(tie, old[rows, np.maximum(ids, 0)], vals)
    elif layout == "last_id":
        ids = np.where(ids >= 0, np.where(rng.random(shape) < 0.5, vs - 1,
                                          ids), -1).astype(np.int32)
    vals = np.where(ids >= 0, vals, np.asarray(identity, vals.dtype))
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    state = (put(old), put(active), put(cursor))
    if layout == "exchange_view":
        # the engine's send buffers ([P, Pn, cap] views of [P, Pn, cap + 1]
        # with one spare slot a row), crossed by the local exchange:
        # [Pn, P, cap] transposed views, not copies
        send_v = torch.full((p, r, c + 1), identity, dtype=dtype,
                            device=device)
        send_i = torch.full((p, r, c + 1), -1, dtype=torch.int32,
                            device=device)
        send_v[:, :, :c] = put(vals.transpose(1, 0, 2))
        send_i[:, :, :c] = put(ids.transpose(1, 0, 2))
        codec = ex_mod.make_wire_codec(
            num_shards=p, capacity=c, vs=vs, requested="none",
            value_kind=kind, identity=identity)
        rv, ri = ex_mod.exchange_local(codec, send_v[:, :, :c],
                                       send_i[:, :, :c])
        assert not ri.is_contiguous()
        return (*state, rv, ri)
    return (*state, put(vals), put(ids))


def deliver_loop(name, old, active, cursor, recv_vals, recv_ids):
    """One message at a time, in slot order: the reference ``deliver`` is
    held to (numpy on the host)."""
    better = (lambda a, b: a < b) if name == "min" else (lambda a, b: a > b)
    old = old.cpu().numpy()
    new = old.copy()
    act = active.cpu().numpy().copy()
    cur = cursor.cpu().numpy().copy()
    n = old.shape[0]
    ids = recv_ids.cpu().reshape(n, -1).numpy()
    vals = recv_vals.cpu().reshape(n, -1).numpy()
    accepted = np.zeros(n, np.int64)
    for p in range(n):
        for i, v in zip(ids[p], vals[p]):
            if i < 0:
                continue
            if better(v, old[p, i]):
                accepted[p] += 1
            if better(v, new[p, i]):
                new[p, i] = v
    changed = better(new, old)
    act |= changed
    cur[changed] = 0
    return tuple(torch.from_numpy(a) for a in (new, act, cur, accepted))
