"""Port parity: the int16/int8 wire codec.

The same seeded payloads go through the JAX package's codec under
``jax.jit`` (as its engine runs it, on the CPU) and the port's
(``dist/compression.py``, ``dist/exchange.py``): encode and decode of
narrowed ints and of row-quantized floats in both rounding directions —
values on and next to the grid points, the sentinels, ±inf identities and
all-identity rows — the int16 ids, the wire byte count, and the
``asymp_*_wire`` configs run to convergence, all bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers at once
torch.set_num_threads(1)

from repro.configs import asymp_graphs as j_cfgs  # noqa: E402
from repro.configs.base import GraphConfig as JCfg  # noqa: E402
from repro.core import engine as JE  # noqa: E402
from repro.core import graph as JG  # noqa: E402
from repro.core import programs as JP  # noqa: E402
from repro.dist import compression as JC  # noqa: E402
from repro.dist import exchange as JX  # noqa: E402
from repro_torch.configs import asymp_graphs as t_cfgs  # noqa: E402
from repro_torch.configs.base import GraphConfig as TCfg  # noqa: E402
from repro_torch.core import engine as TE  # noqa: E402
from repro_torch.core import graph as TG  # noqa: E402
from repro_torch.core import programs as TP  # noqa: E402
from repro_torch.dist import compression as TC  # noqa: E402
from repro_torch.dist import exchange as TX  # noqa: E402

WIRE_CONFIGS = sorted(n for n in j_cfgs.CONFIGS
                      if "wire" in n and not n.endswith("_prod"))


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _bitwise(a, b, what):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype)
    assert a.tobytes() == b.tobytes(), what


def _floats(seed, rows=64, cap=48):
    """Rows of floats with values on the quantization grid of each bit
    width and one ulp either side, signs mixed, ±inf, zeros, one
    all-inf row, one all-zero row and one row of subnormal-free tiny
    magnitudes."""
    rng = np.random.default_rng(seed)
    v = rng.uniform(-50, 50, (rows, cap)).astype(np.float32)
    for r, qmax in ((0, 126), (1, 32766), (2, 126), (3, 32766)):
        scale = np.float32(rng.uniform(0.5, 40))
        k = rng.integers(-qmax, qmax + 1, cap).astype(np.float32)
        grid = (k * (scale * np.float32(1 / qmax))).astype(np.float32)
        grid[0] = scale  # the row's magnitude sets the scale
        if r >= 2:  # one ulp off the grid, both ways
            grid = np.nextafter(grid, np.where(k % 2 == 0, np.inf,
                                               -np.inf).astype(np.float32))
        v[r] = grid
    v[4, ::3] = np.inf
    v[5, 1::4] = -np.inf
    v[6] = np.inf
    v[7] = 0.0
    v[8] = rng.uniform(-1e-20, 1e-20, cap).astype(np.float32)
    v[9, :5] = 0.0
    return v


# ======================================================================
# the row quantizer and the int narrowing
# ======================================================================
@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("direction", ["up", "down"])
@pytest.mark.parametrize("identity", [np.inf, -np.inf, 0.0])
def test_quantize_roundtrip_bitwise(bits, direction, identity):
    """Codes and scales, then the decode, each bitwise the JAX package's
    jitted call (its decode multiplies by the float32 reciprocal of qmax,
    as XLA compiles it).  The decoded value keeps the rounding direction
    to within one float32 ulp: the code rounds in the direction, but the
    decode's product rounds to nearest, in both packages alike."""
    for seed in range(3):
        v = _floats(seed)
        for shape in ((64, 48), (4, 16, 48)):
            vals = v.reshape(shape)
            jq, js = jax.jit(lambda x: JC.quantize_rows(x, bits, direction))(
                vals)
            tq, ts = TC.quantize_rows(torch.from_numpy(vals), bits,
                                      direction)
            _bitwise(jq, tq, "codes")
            _bitwise(js, ts, "scales")
            jd = jax.jit(lambda q, s: JC.dequantize_rows(
                q, s, bits, identity, jnp.float32))(jq, js)
            td = TC.dequantize_rows(tq, ts, bits, identity, torch.float32)
            _bitwise(jd, td, "decoded")
            fin = np.isfinite(vals)
            d = td.numpy()
            toward = np.float32(-np.inf if direction == "up" else np.inf)
            bound = np.nextafter(vals[fin], toward)  # one ulp of slack
            if direction == "up":
                assert (d[fin] >= bound).all()
            else:
                assert (d[fin] <= bound).all()
            assert (d[~fin] == np.float32(identity)).all()


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("identity", [2 ** 31 - 1, -1, 0])
def test_narrow_widen_bitwise(bits, identity):
    """Ints below, at and above the sentinel, negatives and the identity
    itself: narrowed codes and widened values bitwise the JAX package's."""
    sentinel = (1 << (bits - 1)) - 1
    rng = np.random.default_rng(bits)
    vals = np.concatenate([
        np.arange(-3, sentinel + 3), [identity, 2 ** 31 - 1, -1],
        rng.integers(-1, sentinel, 500)]).astype(np.int32).reshape(1, -1)
    jq = jax.jit(lambda x: JC.narrow_int(x, bits, identity))(vals)
    tq = TC.narrow_int(torch.from_numpy(vals), bits)
    _bitwise(jq, tq, "codes")
    jw = jax.jit(lambda q: JC.widen_int(q, bits, identity, jnp.int32))(jq)
    tw = TC.widen_int(tq, bits, identity, torch.int32)
    _bitwise(jw, tw, "widened")
    below = (vals >= -1) & (vals < sentinel)
    assert (tw.numpy()[below] == vals[below]).all()  # lossless below


# ======================================================================
# the codec and the exchange
# ======================================================================
CODECS = [("int32", 2 ** 31 - 1, "up", 100), ("int32", -1, "down", 100),
          ("int32", 2 ** 31 - 1, "up", 40_000), ("float32", np.inf, "up", 0),
          ("float32", 0.0, "down", 0)]


@pytest.mark.parametrize("mode", ["none", "int16", "int8"])
@pytest.mark.parametrize("kind,identity,direction,bound", CODECS)
@pytest.mark.parametrize("vs", [100, 40_000])
def test_codec_and_exchange_bitwise(mode, kind, identity, direction, bound,
                                    vs):
    """``make_wire_codec`` gates to the same mode, ``bits`` and
    ``wire_bytes_per_tick`` agree, and the local exchange through it
    (encode, transpose, decode, values and ids) is bitwise the JAX
    package's; ids ride int16 iff the shard width fits."""
    args = dict(num_shards=4, capacity=16, vs=vs, requested=mode,
                value_kind=kind, identity=identity, max_int_value=bound,
                quantize_direction=direction, idempotent=True)
    jc, tc = JX.make_wire_codec(**args), TX.make_wire_codec(**args)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert tc.wire_bytes_per_tick() == jc.wire_bytes_per_tick()
    if tc.compression != "none":
        assert tc.bits == jc.bits
        assert tc.compress_ids == (vs <= 32766)
    rng = np.random.default_rng(3)
    if kind == "int32":
        sv = rng.integers(-1, 120, (4, 4, 16)).astype(np.int32)
        sv[0, 0, :4] = identity
    else:
        sv = _floats(4, rows=16, cap=16).reshape(4, 4, 16)
    si = rng.integers(-1, min(vs, 30_000), (4, 4, 16)).astype(np.int32)
    jv, ji = jax.jit(lambda v, i: JX.exchange_local(jc, v, i))(sv, si)
    tv, ti = TX.exchange_local(tc, torch.from_numpy(sv),
                               torch.from_numpy(si))
    _bitwise(jv, tv.contiguous(), "exchanged values")
    _bitwise(ji, ti.contiguous(), "exchanged ids")
    enc = tc.encode_ids(torch.from_numpy(si))
    assert enc.dtype == (torch.int16 if tc.compress_ids else torch.int32)
    _bitwise(si, tc.decode_ids(enc), "ids round trip")


def test_int16_halves_the_wire_bytes():
    """``asymp_cc_wire``'s codec next to ``asymp_cc_small``'s, at a
    graph's derived params: 2-byte labels and ids against 4 + 4."""
    for name in ("asymp_cc_wire", "asymp_cc_small"):
        cfg = t_cfgs.CONFIGS[name]
        prog = TP.get_program(cfg)
        ep = TE.derive_params(cfg, num_shards=8, vs=2048, es=9000,
                              num_vertices=cfg.num_vertices, prog=prog)
        jep = JE.derive_params(j_cfgs.CONFIGS[name], num_shards=8, vs=2048,
                               es=9000, num_vertices=cfg.num_vertices,
                               prog=JP.get_program(j_cfgs.CONFIGS[name]))
        n = TE.wire_codec(prog, ep).wire_bytes_per_tick()
        assert n == JE.wire_codec(JP.get_program(j_cfgs.CONFIGS[name]),
                                  jep).wire_bytes_per_tick()
        slots = 8 * 8 * ep.route_capacity
        assert n == slots * (4 if name == "asymp_cc_wire" else 8)


# ======================================================================
# wire configs, per tick
# ======================================================================
def _graphs(jc, tc):
    jg = JG.build_sharded_graph(jc)
    tg = TG.ShardedGraph.from_arrays(
        jg.row_ptr, jg.col_idx, jg.weights, jg.edge_counts, jg.boundary,
        num_real_vertices=jg.num_real_vertices)
    return jg, tg


def _tick_both(jc, tc):
    """Tick the JAX and the port engine to quiescence, the state and the
    send buffers bitwise equal after every tick."""
    jg, tg = _graphs(jc, tc)
    jp, tp = JP.get_program(jc), TP.get_program(tc)
    jep, tep = JE.default_params(jc, jg, jp), TE.default_params(tc, tg, tp)
    assert dataclasses.asdict(jep) == dataclasses.asdict(tep)
    jtick = JE.make_local_tick(jp, jep, jp.weighted)
    ttick = TE.make_local_tick(tp, tep, tp.weighted)
    jgd, tgd = JE.to_device_graph(jg), TE.to_device_graph(tg, device="cpu")
    js, ts = JE.init_state(jp, jg), TE.init_state(tp, tg, device="cpu")
    for t in range(5000):
        js, jstats, (jsv, jsi) = jtick(js, jgd)
        ts, tstats, (tsv, tsi) = ttick(ts, tgd)
        for f in ("values", "active", "cursor", "tick"):
            _bitwise(getattr(js, f), getattr(ts, f), f"tick {t}: {f}")
        _bitwise(jsv, tsv.contiguous(), f"tick {t}: send_vals")
        _bitwise(jsi, tsi.contiguous(), f"tick {t}: send_ids")
        for f in TE.TickStats._fields:
            assert int(getattr(jstats, f)) == int(getattr(tstats, f)), f
        if int(jstats.active) == 0:
            return tep, ts, tg, tp
    raise AssertionError("no convergence")


@pytest.mark.parametrize("name", WIRE_CONFIGS)
def test_wire_config_bitwise_every_tick(name):
    """Every ``asymp_*_wire`` config (reduced): lossless int labels and
    reachability bits, floor-quantized widths."""
    ep, _, _, _ = _tick_both(j_cfgs.CONFIGS[name].reduced(),
                             t_cfgs.CONFIGS[name].reduced())
    assert ep.wire_compression == j_cfgs.CONFIGS[name].wire_compression


@pytest.mark.parametrize("mode", ["int16", "int8"])
def test_sssp_quantized_wire_bitwise_every_tick(mode):
    """SSSP distances ceil-quantized on the wire, on the 1024-vertex
    graph: bitwise the JAX package every tick, and never below the
    raw-wire distances (the relaxation is safe from above)."""
    kw = dict(name="t", algorithm="sssp", num_vertices=1024, avg_degree=8,
              generator="rmat", num_shards=4, priority="log",
              enforce_fraction=0.5, weighted=True, source=5,
              wire_compression=mode)
    ep, ts, tg, tp = _tick_both(JCfg(**kw), TCfg(**kw))
    assert ep.wire_compression == mode
    raw, _ = TE.run_to_convergence(TCfg(**dict(kw, wire_compression="none")),
                                   graph=tg, device="cpu")
    assert (ts.values >= raw.values).all()


def test_wire_labels_equal_raw_labels():
    """``asymp_cc_wire`` reduced: int16 labels are lossless, so the
    fixpoint is the raw wire's."""
    cfg = t_cfgs.CONFIGS["asymp_cc_wire"].reduced()
    g = TG.build_sharded_graph(cfg)
    wire, wt = TE.run_to_convergence(cfg, graph=g, device="cpu")
    raw, rt = TE.run_to_convergence(
        dataclasses.replace(cfg, wire_compression="none"), graph=g,
        device="cpu")
    assert wt["converged"] and torch.equal(wire.values, raw.values)
