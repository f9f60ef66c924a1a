"""The cases of ``tests/test_torch_dist.py``, shared by its two sides: the
JAX package's dist ticks on a 4-device CPU mesh (``_dist_jax_ref.py``, in
a subprocess) and the port's on 4 gloo ranks (``_dist_ranks.py``).  Plain
data and numpy only: each side builds its own configs and programs.

Every tick, each side records the global counters and, for every rank, a
digest of each state field's rows (dtype and bytes), so the two compare
bitwise without storing every tick's state.
"""
import hashlib

import numpy as np

WORKERS = 4
# tests/conftest.py::rmat_cc_graph's graph; pagerank on a smaller one, with
# a coarser push threshold, as tests/test_torch_crowded.py runs it
BASE = dict(name="t", num_vertices=1024, avg_degree=8, generator="rmat",
            num_shards=WORKERS, priority="log", enforce_fraction=0.5,
            source=5)
PAGERANK = dict(BASE, algorithm="pagerank", num_vertices=256, avg_degree=4,
                source=0, enforce_fraction=1.0)
PUSH_EPS = 1e-4
# sender 1's outgoing links are slow (a straggler), and it is throttled
DELAYS = [[0, 0, 0, 0], [2, 0, 2, 2], [0, 0, 0, 0], [0, 0, 0, 0]]
MAX_DELAY = 2
THROTTLE = [1, 4, 1, 1]
RATES = [2, 1, 1, 1]  # async firing rates: shard 0 fires every other step
MAX_TICKS = 5000

CASES = {
    "cc": dict(kind="plain", cfg=dict(BASE, algorithm="cc")),
    "cc_int16": dict(kind="plain", cfg=dict(BASE, algorithm="cc",
                                            wire_compression="int16")),
    "sssp_int16": dict(kind="plain", cfg=dict(
        BASE, algorithm="sssp", weighted=True, wire_compression="int16")),
    "pagerank": dict(kind="plain", cfg=PAGERANK),
    "crowded_cc": dict(kind="crowded", cfg=dict(BASE, algorithm="cc")),
    "crowded_sssp_int16": dict(kind="crowded", cfg=dict(
        BASE, algorithm="sssp", weighted=True, wire_compression="int16")),
    "async_cc": dict(kind="async", cfg=dict(BASE, algorithm="cc")),
    "async_pagerank": dict(kind="async", cfg=PAGERANK),
}

# the transports alone: random send buffers through every codec
T_CAP, T_VS, T_TICKS = 8, 200, 6
CODECS = {
    "raw": dict(requested="none", value_kind="int32",
                identity=2 ** 31 - 1, quantize_direction="up"),
    "int16_int": dict(requested="int16", value_kind="int32",
                      identity=2 ** 31 - 1, quantize_direction="up"),
    "int16_float_up": dict(requested="int16", value_kind="float32",
                           identity=float("inf"), quantize_direction="up"),
    "int8_float_down": dict(requested="int8", value_kind="float32",
                            identity=0.0, quantize_direction="down"),
}


def program(PR, cfg):
    """The case's program from a package's ``core.programs`` module."""
    if cfg.algorithm == "pagerank":
        return PR.pagerank(push_eps=PUSH_EPS)
    return PR.get_program(cfg)


def state_fields(state) -> list:
    """A state's fields in the order both sides record them (either
    package's ``EngineState``, ``CrowdedState`` or ``AsyncState``)."""
    core = getattr(state, "core", state)
    out = [core.values, core.active, core.cursor, core.tick]
    out += [core.aux] if core.aux is not None else []
    if hasattr(state, "ring"):
        out += [*state.ring, state.demote]
    if hasattr(state, "clock"):
        out.append(state.clock)
    return out


def digest(a) -> str:
    a = np.ascontiguousarray(a)
    return hashlib.sha1(a.dtype.str.encode() + a.tobytes()).hexdigest()


def transport_inputs(value_kind: str) -> dict:
    """``T_TICKS`` ticks of global send buffers ``[P, Pn, cap]``, delay
    rows up to ``MAX_DELAY + 1`` (clamped by the ring) and receive gates."""
    rng = np.random.default_rng(7)
    shape = (T_TICKS, WORKERS, WORKERS, T_CAP)
    if value_kind == "int32":
        vals = rng.integers(0, T_VS * WORKERS, shape).astype(np.int32)
    else:
        vals = rng.uniform(0.0, 50.0, shape).astype(np.float32)
        vals[rng.random(shape) < 0.1] = np.inf
    ids = rng.integers(-1, T_VS, shape).astype(np.int32)
    return dict(
        vals=vals, ids=ids,
        delays=rng.integers(0, MAX_DELAY + 2,
                            (T_TICKS, WORKERS, WORKERS)).astype(np.int32),
        gate=rng.random((T_TICKS, WORKERS)) < 0.7)
