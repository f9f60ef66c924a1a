"""The port on the card: the CUDA semiring SpMV kernels (the scalar forms,
on random and on destination-sorted streams, and the tensor-core
``plus_times`` on random, sorted and crafted dst layouts) against their
plain version, the main
path against its CPU run, pagerank against its verdict, fault recovery
against its CPU run, the crowded and async ticks against their CPU runs,
the int16/int8 wire codec against its CPU calls, the engine tick's receive
kernel against its plain version (every form and layout of
``tests/_receive_cases.py``, and the benchmark's shape), the engine tick's
create kernels against the plain create and its loop (every case of
``tests/_create_cases.py``) and in whole WCC and SSSP sessions, a forked
session that
must leave its primary's tensors untouched, a small serving plane
(CC + SSSP, one edge delta) against its CPU run, and the dense LM: the
reduced archs' logits against the CPU, the slot server against
``generate``, the flash prefill against the dense path, and a cache
checkpoint's round trip; the MoE layer; and the SSM and hybrid families:
softplus and the chunked SSD with its gradients against the CPU, the
reduced mamba2 and hymba logits against the CPU, and their slot servers
(SSD states, rings past the window) against ``generate``; the dry run's
per-rank bytes allocated on the card.

Every test carries the ``gpu`` marker and skips on a host without a CUDA
card (decided in the ``cuda`` fixture, not at import).  On a machine with
one card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import GraphConfig  # noqa: E402
from repro_torch.core import engine as E  # noqa: E402
from repro_torch.core import faults as F  # noqa: E402
from repro_torch.core import graph as G  # noqa: E402
from repro_torch.core import merger as M  # noqa: E402
from repro_torch.core import programs as PG  # noqa: E402
from repro_torch.core.semiring import AGGREGATORS  # noqa: E402
from repro_torch.dist import compression as C  # noqa: E402
from repro_torch.kernels import create as CK  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import receive as RK  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402
from repro_torch.kernels import semiring_spmv as K  # noqa: E402
from repro_torch.serve import graph as S  # noqa: E402

import _create_cases as CC  # noqa: E402
import _receive_cases as RC  # noqa: E402

pytestmark = pytest.mark.gpu

SWEEP = [("min", torch.int32), ("min", torch.float32),
         ("min_plus", torch.float32), ("max", torch.int32),
         ("max", torch.float32), ("max_min", torch.float32),
         ("or", torch.int32), ("plus_times", torch.float32)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(seed, n, dtype, device):
    rng = np.random.default_rng(seed)
    if dtype == torch.int32:
        vals = rng.integers(0, 10_000, n).astype(np.int32)
    else:
        vals = rng.uniform(0.0, 10.0, n).astype(np.float32)
    dst = rng.integers(-1, K.TILE, n).astype(np.int32)
    w = rng.uniform(0.1, 1.0, n).astype(np.float32)
    put = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return put(vals), put(dst), put(w)


def _launches():
    return sum(K.spmv_partials.launches_by_form.values())


def _check(kp, rp, semiring):
    assert kp.shape == rp.shape and kp.dtype == rp.dtype
    if semiring == "plus_times":  # sum order differs from the plain version
        torch.testing.assert_close(kp, rp, rtol=1e-5, atol=1e-5)
    else:  # idempotent reduces are exact
        assert torch.equal(kp, rp)


@pytest.mark.parametrize("semiring,dtype", SWEEP)
@pytest.mark.parametrize("n_blocks", [1, 3, 8])
@pytest.mark.parametrize("weighted", [True, False])
def test_kernel_matches_plain(cuda, semiring, dtype, n_blocks, weighted):
    vals, dst, w = _inputs(n_blocks, n_blocks * K.EDGE_BLOCK, dtype, cuda)
    w = w if weighted else None
    before = _launches()
    kp = K.spmv_partials(vals, dst, w, semiring=semiring)
    torch.cuda.synchronize()
    assert _launches() == before + 1
    _check(kp, R.spmv_partials_ref(vals, dst, w, semiring=semiring),
           semiring)


def _sorted_dst(name):
    """dst streams on which every warp takes the kernel's sorted path (the
    last case mixes in one warp that does not), as numpy int32."""
    rng = np.random.default_rng(7)
    eb = K.EDGE_BLOCK
    pad = lambda a: np.concatenate(  # noqa: E731
        [a, np.full(-len(a) % eb, -1)]).astype(np.int32)
    if name == "rmat_pulled":
        cfg = GraphConfig(name="t", algorithm="cc", num_vertices=1024,
                          avg_degree=8, generator="rmat", num_shards=4)
        return ops.build_pulled_graph(G.build_sharded_graph(cfg)) \
            .edge_dst_local
    if name == "one_lane":  # one run across all four warps
        return np.full(eb, 77, np.int32)
    if name == "hub":  # a run over three blocks, then the tile's other lanes
        return pad(np.concatenate([np.full(1300, 5),
                                   np.sort(rng.integers(6, K.TILE, 200))]))
    if name == "tail_padding":  # the tile's last block is mostly padding
        return pad(np.sort(rng.integers(0, K.TILE, eb + 7)))
    # runs of 1-7 edges, so most 4-edge groups straddle a key change
    runs = np.repeat(np.arange(K.TILE), rng.choice([1, 2, 3, 5, 6, 7], K.TILE))
    if name == "straddle":
        return pad(runs)
    mixed = pad(runs[:eb])  # "mixed": warp 1 of the block is unsorted
    mixed[128:256] = rng.permutation(mixed[128:256])
    return mixed


SORTED_CASES = ["rmat_pulled", "one_lane", "hub", "tail_padding", "straddle",
                "mixed"]


@pytest.mark.parametrize("case", SORTED_CASES)
@pytest.mark.parametrize("semiring,dtype", SWEEP)
@pytest.mark.parametrize("weighted", [True, False])
def test_kernel_matches_plain_on_sorted_streams(cuda, case, semiring, dtype,
                                                weighted):
    """Destination-sorted blocks (the stream's own layout) take the
    kernel's segmented scan: idempotent forms exactly, plus_times within
    rtol/atol 1e-5 of the plain version."""
    d = _sorted_dst(case)
    vals, _, w = _inputs(11, len(d), dtype, cuda)
    dst = torch.from_numpy(d).to(cuda)
    w = w if weighted else None
    before = _launches()
    kp = K.spmv_partials(vals, dst, w, semiring=semiring)
    torch.cuda.synchronize()
    assert _launches() == before + 1
    _check(kp, R.spmv_partials_ref(vals, dst, w, semiring=semiring),
           semiring)


@pytest.mark.parametrize("use_mxu", [False, True])
@pytest.mark.parametrize("weighted", [True, False])
def test_plus_times_is_deterministic(cuda, use_mxu, weighted):
    """No atomics: two launches on the same sorted or unsorted input give
    the same bits, and on a stream whose every k-step spans all eight M
    tiles (the tensor-core form's worst case)."""
    sorted_d = torch.from_numpy(_sorted_dst("rmat_pulled")).to(cuda)
    vals, rand_d, w = _inputs(12, len(sorted_d), torch.float32, cuda)
    w = w if weighted else None
    worst_d = torch.from_numpy(np.resize(_mxu_dst("span_worst"),
                                         len(sorted_d))).to(cuda)
    for dst in (sorted_d, rand_d, worst_d):
        a = K.spmv_partials(vals, dst, w, semiring="plus_times",
                            use_mxu=use_mxu)
        b = K.spmv_partials(vals, dst, w, semiring="plus_times",
                            use_mxu=use_mxu)
        assert torch.equal(a, b)


@pytest.mark.parametrize("semiring,use_mxu", [("min", False),
                                              ("plus_times", True)])
def test_wrapper_refuses_misaligned_inputs(cuda, semiring, use_mxu):
    """Both kernels read 16-byte vectors: an input that does not start on a
    16-byte boundary raises, whichever input it is."""
    vals, dst, w = _inputs(13, K.EDGE_BLOCK + 1, torch.float32, cuda)
    args = [vals[:-1], dst[:-1], w[:-1]]
    K.spmv_partials(*args, semiring=semiring, use_mxu=use_mxu)  # launches
    for i, t in enumerate((vals, dst, w)):
        bad = list(args)
        bad[i] = t[1:]
        assert bad[i].data_ptr() % 16
        with pytest.raises(ValueError, match="16-byte"):
            K.spmv_partials(*bad, semiring=semiring, use_mxu=use_mxu)


@pytest.mark.parametrize("semiring", ["min", "max", "or"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_ignored_weights_are_not_passed(cuda, semiring, dtype):
    """min, max and or ignore the weights: the wrapper gives the kernel
    none, and the output is bitwise the unweighted call's and the plain
    version's."""
    d = torch.from_numpy(_sorted_dst("rmat_pulled")).to(cuda)
    vals, rand_d, w = _inputs(14, len(d), dtype, cuda)
    for dst in (d, rand_d):
        kw = K.spmv_partials(vals, dst, w, semiring=semiring)
        assert torch.equal(kw, K.spmv_partials(vals, dst, None,
                                               semiring=semiring))
        assert torch.equal(kw, R.spmv_partials_ref(vals, dst, w,
                                                   semiring=semiring))


def test_max_clamps_at_identity(cuda):
    vals = torch.full((K.EDGE_BLOCK,), -5.0, device=cuda)
    dst = torch.zeros((K.EDGE_BLOCK,), dtype=torch.int32, device=cuda)
    k = K.spmv_partials(vals, dst, None, semiring="max")
    assert torch.equal(k, R.spmv_partials_ref(vals, dst, None,
                                              semiring="max"))
    assert float(k[0, 0]) == 0.0


def test_all_padding_block(cuda):
    vals = torch.zeros((K.EDGE_BLOCK,), device=cuda)
    dst = torch.full((K.EDGE_BLOCK,), -1, dtype=torch.int32, device=cuda)
    assert bool(torch.isinf(K.spmv_partials(vals, dst, None,
                                            semiring="min")).all())


def _mxu_dst(case):
    """dst layouts for the tensor-core form, which issues its products only
    for the M tiles (16 lanes) in each k-step's (16 edges') span of dst,
    as numpy int32."""
    eb = K.EDGE_BLOCK
    rng = np.random.default_rng(21)
    if case.startswith("random-"):  # every k-step spans nearly all tiles
        return rng.integers(-1, K.TILE, int(case[7:]) * eb).astype(np.int32)
    if case == "rmat_pulled":  # the stream's layout: ~1 tile a k-step
        return _sorted_dst("rmat_pulled")
    if case == "span_worst":  # every k-step holds dst 0 and dst 127
        return np.tile(np.repeat(np.array([0, K.TILE - 1], np.int32), 8),
                       2 * eb // 16)
    if case == "warp_boundary":  # runs across the 128-edge warp boundaries
        a = np.repeat(np.array([3, 17, 40, 77, 126]), 100)
        b = np.repeat(np.arange(0, K.TILE, 12), 45)[:eb]
        return np.concatenate([a, np.full(eb - len(a), -1), b,
                               np.full(eb - len(b), -1)]).astype(np.int32)
    # "padding_mid": all-padding k-steps inside the block, between hits
    d = np.sort(rng.integers(0, K.TILE, 2 * eb)).astype(np.int32)
    ks = np.arange(2 * eb) // 16
    d[np.isin(ks % 32, [5, 6, 7, 8, 9, 20, 21, 31])] = -1
    return d


MXU_CASES = ["random-1", "random-3", "random-8", "rmat_pulled", "span_worst",
             "warp_boundary", "padding_mid"]


@pytest.mark.parametrize("case", MXU_CASES)
@pytest.mark.parametrize("weighted", [True, False])
def test_mxu_form_matches_plain(cuda, case, weighted):
    """The tensor-core plus_times: within rtol/atol 1e-5 of the plain
    version (fp32 accumulation of an exact three-term bf16 split) on random
    dst, the sorted stream and crafted layouts of the M-tile skip, two
    launches bitwise equal, counted under its own key."""
    d = _mxu_dst(case)
    n_blocks = len(d) // K.EDGE_BLOCK
    vals, _, w = _inputs(10 + n_blocks, len(d), torch.float32, cuda)
    dst = torch.from_numpy(d).to(cuda)
    w = w if weighted else None
    before = K.spmv_partials.launches_by_form.get("plus_times_mxu/float32", 0)
    kp = K.spmv_partials(vals, dst, w, semiring="plus_times", use_mxu=True)
    torch.cuda.synchronize()
    assert K.spmv_partials.launches_by_form["plus_times_mxu/float32"] == \
        before + 1
    _check(kp, R.spmv_partials_ref(vals, dst, w, semiring="plus_times"),
           "plus_times")
    assert torch.equal(kp, K.spmv_partials(vals, dst, w,
                                           semiring="plus_times",
                                           use_mxu=True))
    pad_d = torch.full_like(dst, -1)
    assert torch.equal(K.spmv_partials(vals, pad_d, w, semiring="plus_times",
                                       use_mxu=True),
                       torch.zeros((n_blocks, K.TILE), device=cuda))


def test_wrapper_refuses(cuda):
    vals, dst, w = _inputs(0, K.EDGE_BLOCK, torch.float32, cuda)
    with pytest.raises(TypeError):  # the tensor-core form is float32 only
        K.spmv_partials(vals.int(), dst, None, semiring="plus_times",
                        use_mxu=True)
    with pytest.raises(ValueError):
        K.spmv_partials(vals[:100], dst[:100], None, semiring="min")
    with pytest.raises(TypeError):
        K.spmv_partials(vals, dst.long(), None, semiring="min")


def test_main_path_matches_cpu(cuda):
    cfg = GraphConfig(name="t", algorithm="cc", num_vertices=1024,
                      avg_degree=8, generator="rmat", num_shards=4,
                      priority="log", enforce_fraction=0.5)
    g = G.build_sharded_graph(cfg)
    before = _launches()
    lab_gpu, st_gpu = ops.bsp_connected_components(g, device=cuda)
    assert _launches() - before == st_gpu["rounds"]
    lab_cpu, st_cpu = ops.bsp_connected_components(g, device="cpu")
    assert st_gpu == st_cpu and torch.equal(lab_gpu.cpu(), lab_cpu)
    receives, creates = RK.deliver.launches, CK.create.launches
    s_gpu, t_gpu = E.run_to_convergence(cfg, graph=g, device=cuda)
    assert RK.deliver.launches - receives == t_gpu["ticks"]
    assert CK.create.launches - creates == t_gpu["ticks"]
    s_cpu, t_cpu = E.run_to_convergence(cfg, graph=g, device="cpu")
    for k in ("ticks", "sent", "accepted", "fetched", "converged"):
        assert t_gpu[k] == t_cpu[k], k
    for f in ("values", "active", "cursor"):
        assert torch.equal(getattr(s_gpu, f).cpu(), getattr(s_cpu, f))


def test_pagerank_verdict_on_card(cuda):
    """Push-mode pagerank on the card: its float scatter-add is atomic, so
    the bits may move from the CPU run's; the verdict holds either way."""
    cfg = GraphConfig(name="t-pr", algorithm="pagerank", num_vertices=512,
                      avg_degree=5, generator="rmat", num_shards=4,
                      enforce_fraction=0.5, checkpoint_every=4)
    g = G.build_sharded_graph(cfg)
    oracle = ops.pagerank(g, damping=0.85, iters=80, dangling="absorb",
                          device="cpu").numpy().astype(np.float64)
    plan = F.FaultPlan(0.5, start_tick=4, every=6)
    for fault_plan in (None, plan):
        state, totals = E.run_to_convergence(cfg, graph=g, device=cuda,
                                             fault_plan=fault_plan)
        assert totals["converged"] and totals["replayed"] == 0
        ranks = state.values.cpu().numpy().reshape(-1)[: g.num_real_vertices]
        assert np.abs(ranks / g.num_real_vertices - oracle).sum() < 1e-3
        assert abs(M.mass_balance(state, g) - 1.0) < 1e-5
        assert bool((state.aux[:, 1] == 0).all())
        assert bool((state.aux[:, 0] <= 1e-5).all())
    assert totals["failures"] > 0


def test_cc_faults_match_cpu(cuda):
    """Replay recovery on the card: CC is integer and idempotent, so the
    run under rolling kills equals the CPU run exactly."""
    cfg = GraphConfig(name="t", algorithm="cc", num_vertices=1024,
                      avg_degree=8, generator="rmat", num_shards=4,
                      priority="log", enforce_fraction=0.5)
    g = G.build_sharded_graph(cfg)
    plan = F.FaultPlan(1.0, start_tick=4, every=6)
    receives, creates = RK.deliver.launches, CK.create.launches
    s_gpu, t_gpu = E.run_to_convergence(cfg, graph=g, device=cuda,
                                        fault_plan=plan)
    assert RK.deliver.launches - receives == t_gpu["ticks"]
    assert CK.create.launches - creates == t_gpu["ticks"]
    s_cpu, t_cpu = E.run_to_convergence(cfg, graph=g, device="cpu",
                                        fault_plan=plan)
    for k in ("ticks", "sent", "failures", "replayed", "converged"):
        assert t_gpu[k] == t_cpu[k], k
    assert t_gpu["failures"] == 4 and t_gpu["replayed"] > 0
    assert torch.equal(s_gpu.values.cpu(), s_cpu.values)


def test_undirected_sssp_on_card_matches_reference(cuda):
    """Graph500 kernel 3's weights (one an undirected edge, in [0, 1)) on
    the card: the float-min receive kernel takes every tick, and the job
    equals the plain float32 min-plus fixpoint, which is unique, exactly."""
    cfg = GraphConfig(name="t-g500", algorithm="sssp", num_vertices=4096,
                      avg_degree=16, generator="rmat",
                      rmat_abcd=(0.57, 0.19, 0.19, 0.05), num_shards=8,
                      weighted=True, weight_rule="undirected", source=0,
                      seed=2 ** 31 + 11)
    g = G.build_sharded_graph(cfg)
    receives = RK.deliver.launches
    state, totals = E.run_to_convergence(cfg, graph=g, device=cuda)
    assert RK.deliver.launches - receives == totals["ticks"]
    assert totals["converged"] and totals["edges"] == g.num_edges
    got = M.extract(state, g, PG.get_program(cfg))
    edges, w = G.edge_list(g, with_weights=True)
    src, dst = (torch.from_numpy(edges[:, i]) for i in (0, 1))
    w = torch.from_numpy(w)
    dist = torch.full((g.num_real_vertices,), float("inf"))
    dist[0] = 0.0
    while True:  # synchronous rounds to the fixpoint
        nxt = dist.scatter_reduce(0, dst, dist[src] + w, "amin")
        if torch.equal(nxt, dist):
            break
        dist = nxt
    assert np.array_equal(got, dist.numpy())
    assert np.isfinite(got).sum() > 1000


@pytest.mark.parametrize("algorithm", ["cc", "sssp"])
@pytest.mark.parametrize("schedule", ["sync", "async"])
@pytest.mark.parametrize("faults", [False, True])
def test_crowded_and_async_match_cpu(cuda, algorithm, schedule, faults):
    """The crowded tick (sync) and the async tick on the card, healthy or
    under kills and slowdowns: min scatters are exact, so the totals with
    their per-tick log and the final state equal the CPU run's."""
    cfg = GraphConfig(name="t", algorithm=algorithm, num_vertices=1024,
                      avg_degree=8, generator="rmat", num_shards=4,
                      priority="log", enforce_fraction=0.5, source=5,
                      weighted=algorithm == "sssp",
                      latency_profile="stragglers", schedule=schedule)
    g = G.build_sharded_graph(cfg)
    plan = (F.FaultPlan(0.5, start_tick=4, every=6, slow_fraction=0.5,
                        slow_delay=3, slow_intensity=4) if faults else None)
    receives, creates = RK.deliver.launches, CK.create.launches
    s_gpu, t_gpu = E.run_to_convergence(cfg, graph=g, device=cuda,
                                        fault_plan=plan, collect_log=True)
    assert RK.deliver.launches - receives == t_gpu["ticks"]
    assert CK.create.launches - creates == t_gpu["ticks"]
    s_cpu, t_cpu = E.run_to_convergence(cfg, graph=g, device="cpu",
                                        fault_plan=plan, collect_log=True)
    assert t_gpu == t_cpu and t_gpu["converged"] and t_gpu["pending"] == 0
    for f in ("values", "active", "cursor", "tick"):
        assert torch.equal(getattr(s_gpu, f).cpu(), getattr(s_cpu, f)), f
    if faults:
        assert t_gpu["failures"] == 2 and t_gpu["replayed"] > 0


@pytest.mark.parametrize("bits", [8, 16])
def test_wire_codec_on_card_matches_cpu(cuda, bits):
    """Row quantization (both directions, ±inf, all-inf and all-zero rows)
    and int narrowing on the card give the CPU's bits."""
    rng = np.random.default_rng(bits)
    vals = rng.uniform(-50, 50, (256, 96)).astype(np.float32)
    vals[0, ::3], vals[1, 1::4], vals[2], vals[3] = np.inf, -np.inf, np.inf, 0
    v_cpu = torch.from_numpy(vals)
    for direction in ("up", "down"):
        q_cpu, s_cpu = C.quantize_rows(v_cpu, bits, direction)
        q_gpu, s_gpu = C.quantize_rows(v_cpu.to(cuda), bits, direction)
        assert torch.equal(q_gpu.cpu(), q_cpu)
        assert torch.equal(s_gpu.cpu(), s_cpu)
        d_cpu = C.dequantize_rows(q_cpu, s_cpu, bits, np.inf, torch.float32)
        d_gpu = C.dequantize_rows(q_gpu, s_gpu, bits, np.inf, torch.float32)
        assert torch.equal(d_gpu.cpu(), d_cpu)
    ints = torch.from_numpy(rng.integers(-1, 40_000, (64, 96))
                            .astype(np.int32))
    n_cpu = C.narrow_int(ints, bits)
    n_gpu = C.narrow_int(ints.to(cuda), bits)
    assert torch.equal(n_gpu.cpu(), n_cpu)
    assert torch.equal(C.widen_int(n_gpu, bits, 2 ** 31 - 1,
                                   torch.int32).cpu(),
                       C.widen_int(n_cpu, bits, 2 ** 31 - 1, torch.int32))


def _deliver_both(form, case):
    """The kernel and the plain version on one case: the kernel launched
    once, the inputs untouched, the four outputs bitwise equal."""
    agg = AGGREGATORS[form[0]]
    before = [t.clone() for t in case]
    launches = RK.deliver.launches
    got = RK.deliver(agg, *case)
    torch.cuda.synchronize()
    assert RK.deliver.launches == launches + 1
    want = RK.deliver_ref(agg, *case)
    for g, w, field in zip(got, want, ("values", "active", "cursor",
                                       "accepted")):
        assert g.dtype == w.dtype and torch.equal(g, w), field
    for b, t in zip(before, case):
        assert torch.equal(b, t)
    return got


@pytest.mark.parametrize("layout", RC.LAYOUTS)
@pytest.mark.parametrize("form", RC.FORMS, ids=RC.form_id)
def test_receive_kernel_matches_plain(cuda, form, layout):
    """Every form and layout of the CPU tests: the kernel equals the plain
    version and the one-message-at-a-time loop."""
    case = RC.make_case(form, layout, cuda, seed=RC.LAYOUTS.index(layout))
    got = _deliver_both(form, case)
    for g, w in zip(got, RC.deliver_loop(form[0], *case)):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("form", RC.FORMS, ids=RC.form_id)
def test_receive_kernel_at_benchmark_shape(cuda, form):
    """The benchmark's receive: the exchange's [8, 8, 255 k] views of 8
    shards of 65,536 vertices, about 9 k live slots."""
    case = RC.make_case(form, "exchange_view", cuda, seed=28,
                        shape=(8, 8, 255_000), vs=65_536, live=5.5e-4)
    live = int((case[4] >= 0).sum())
    assert 8_000 < live < 10_000
    got = _deliver_both(form, case)
    assert 0 < int(got[3].sum()) <= live


def test_receive_wrapper_refuses(cuda):
    case = RC.make_case(RC.FORMS[0], "contiguous", cuda)
    old, active, cursor, vals, ids = case
    with pytest.raises(ValueError):  # not idempotent
        RK.deliver(AGGREGATORS["sum"], *case)
    with pytest.raises(TypeError):
        RK.deliver(AGGREGATORS["min"], old, active, cursor, vals,
                   ids.long())
    with pytest.raises(TypeError):
        RK.deliver(AGGREGATORS["min"], old, active, cursor, vals.float(),
                   ids)
    with pytest.raises(ValueError):
        RK.deliver(AGGREGATORS["min"], old, active, cursor, vals[:2],
                   ids[:2])
    with pytest.raises(ValueError):  # a row's ids not one contiguous run
        RK.deliver(AGGREGATORS["min"], old, active, cursor,
                   vals.repeat_interleave(2, -1)[..., ::2],
                   ids.repeat_interleave(2, -1)[..., ::2])


@pytest.mark.parametrize("case", CC.CASES, ids=CC.case_id)
def test_create_kernel_matches_plain(cuda, case):
    """Every case of the CPU tests on the card: the kernels launched once,
    bitwise the plain create on the card and the loop, the inputs
    untouched."""
    prog, ep, args, kwargs = CC.make_case(case, cuda,
                                          seed=CC.CASES.index(case))
    before = [t.clone() for t in args if t is not None]
    launches = CK.create.launches
    got = E._phase1_create(prog, ep, *args, **kwargs)
    torch.cuda.synchronize()
    assert CK.create.launches == launches + 1
    CC.assert_same(got, E._create_plain(prog, ep, *args, **kwargs),
                   f"{case.name}: plain")
    CC.assert_same(got, CC.create_loop(prog, ep, *args, **kwargs),
                   f"{case.name}: loop")
    assert got[6] is args[0]
    for b, t in zip(before, [t for t in args if t is not None]):
        assert torch.equal(b, t)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_create_kernel_at_block_edges(cuda, seed):
    """Shapes that cut the kernels' blocks unevenly: more than one select
    block a shard (vs > 1,024), route blocks of several slots with ties
    across them, a wide window, a frontier above M and a cap that drops."""
    case = CC.Case(f"blocks{seed}", ["cc", "sssp", "labelprop"][seed],
                   weighted=seed == 1, P=5, Pn=5, vs=2_500, M=1_500,
                   D=[16, 7, 300][seed], cap=[4_000, 900, 6_000][seed],
                   rho=[0.2, 1.0, 0.6][seed], live=0.7,
                   priority=["log", "log", "linear"][seed])
    prog, ep, args, kwargs = CC.make_case(case, cuda, seed=seed)
    got = E._phase1_create(prog, ep, *args, **kwargs)
    CC.assert_same(got, E._create_plain(prog, ep, *args, **kwargs),
                   case.name)


def test_create_wrapper_refuses_on_card(cuda):
    case = next(c for c in CC.CASES if c.name == "cc")
    prog, ep, args, _ = CC.make_case(case, cuda)
    values, active, cursor, row_ptr, col_idx, weights = args
    with pytest.raises(ValueError):  # inputs on two devices
        CK.create(prog, ep, values, active, cursor.cpu(), row_ptr, col_idx,
                  weights)
    with pytest.raises(ValueError):  # push mode
        CK.create(PG.get_program("pagerank"), ep, *args)


@pytest.mark.parametrize("algorithm", ["cc", "sssp"])
def test_create_sessions_match_cpu(cuda, algorithm):
    """Whole WCC and SSSP jobs on a small Graph500-like graph: every tick's
    create is the kernels' (launches equal the ticks), and the totals, the
    per-tick log and the fixpoint equal the CPU run's."""
    cfg = GraphConfig(name="t-g500", algorithm=algorithm, num_vertices=8192,
                      avg_degree=16, generator="rmat",
                      rmat_abcd=(0.57, 0.19, 0.19, 0.05), num_shards=8,
                      priority="log", enforce_fraction=0.1, source=0,
                      weighted=algorithm == "sssp",
                      weight_rule="undirected", seed=2 ** 31 + 30)
    g = G.build_sharded_graph(cfg)
    creates = CK.create.launches
    s_gpu, t_gpu = E.run_to_convergence(cfg, graph=g, device=cuda,
                                        collect_log=True)
    assert CK.create.launches - creates == t_gpu["ticks"]
    s_cpu, t_cpu = E.run_to_convergence(cfg, graph=g, device="cpu",
                                        collect_log=True)
    assert t_gpu == t_cpu and t_gpu["converged"]
    for f in ("values", "active", "cursor", "tick"):
        assert torch.equal(getattr(s_gpu, f).cpu(), getattr(s_cpu, f)), f


def _session_tensors(sess) -> dict:
    """Every tensor a session holds: core, ring, demotion and clock
    planes, the ring checkpoint, the fault manager's snapshots and log."""
    out = {}

    def add(path, obj):
        if torch.is_tensor(obj):
            out[path] = obj
        elif isinstance(obj, (tuple, list)):
            for i, x in enumerate(obj):
                add(f"{path}.{i}", x)

    for name in ("_state", "_cstate", "_astate", "_ring_ckpt", "g"):
        add(name, getattr(sess, name, None))
    for p, snap in sorted(sess.fault_mgr.ckpt.items()):
        add(f"ckpt{p}", snap)
    for t, bufs in sorted(sess.fault_mgr.msg_log.items()):
        add(f"log{t}", bufs)
    return out


@pytest.mark.parametrize("algorithm,schedule,slow", [
    ("cc", "sync", 0.0), ("cc", "async", 0.5), ("pagerank", "sync", 0.5)])
def test_fork_does_not_alias_on_card(cuda, algorithm, schedule, slow):
    """A fork ticked 30 steps under kills (replay for CC, the global
    restore with its ring for pagerank) leaves the primary's tensors
    bitwise as they were; the primary then converges as an un-forked
    twin does."""
    cfg = GraphConfig(name="t", algorithm=algorithm, num_vertices=512,
                      avg_degree=5, generator="rmat", num_shards=4,
                      priority="log", enforce_fraction=1.0, schedule=schedule)
    g = G.build_sharded_graph(cfg)

    def session():
        plan = F.FaultPlan(1.0, start_tick=3, every=3, slow_fraction=slow,
                           slow_delay=2, slow_intensity=2)
        return E.EngineSession(cfg, graph=g, fault_plan=plan, device=cuda)

    prim, twin = session(), session()
    for s in (prim, twin):
        for _ in range(5):
            s.step()
    before = {k: v.clone() for k, v in _session_tensors(prim).items()}
    fork = prim.fork()
    for _ in range(30):
        fork.step()
    torch.cuda.synchronize()
    assert fork.totals["failures"] >= 3 and prim.totals["failures"] == 1
    after = _session_tensors(prim)
    assert sorted(after) == sorted(before)
    for k, v in before.items():
        assert torch.equal(after[k], v), k
    tp, tt = prim.tick_until_quiescent(), twin.tick_until_quiescent()
    assert tp["converged"] and tt["converged"]
    if algorithm == "cc":  # min scatters are exact: the same bits
        assert tp == tt
        assert torch.equal(prim.state.values, twin.state.values)


def test_serving_plane_matches_cpu(cuda, tmp_path):
    """CC + SSSP served on the card, one mixed edge delta streamed through
    a transaction with a query batch between steps: states, delta stats,
    answers and the published epoch equal the CPU port's."""
    cfg = GraphConfig(name="t-serve", algorithm="cc", num_vertices=1024,
                      avg_degree=8, generator="rmat", num_shards=4,
                      priority="log", enforce_fraction=0.5, weighted=True)
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        srv = S.GraphServer(cfg, programs=("cc", "sssp"),
                            store_dir=str(tmp_path / dev.type), device=dev)
        totals = srv.converge()
        qs = S.QueryServer(srv, num_slots=8)
        edges = G.edge_list(srv.graph)
        txn = srv.begin_delta(insertions=[(3, 1000), (17, 512)],
                              deletions=[tuple(edges[5]), tuple(edges[99])])
        for rid, v in enumerate(range(0, 1024, 64)):
            qs.submit(S.GraphQuery(rid, ("component_of", "distance")[rid % 2],
                                   v))
        while not txn.step(2):
            qs.step()
        stats = txn.commit()
        qs.run()
        runs[dev.type] = (srv, totals, stats, dict(qs.done), qs.stats())
    (gs, gt, gd, ga, gq), (cs, ct, cd, ca, cq) = runs["cuda"], runs["cpu"]
    assert gt == ct and gd == cd and ga == ca and gq == cq
    assert gq["freshness_lag_max"] == 1 and gs.epoch == cs.epoch == 2
    for name in ("cc", "sssp"):
        for f in ("values", "active", "cursor", "tick"):
            assert torch.equal(getattr(gs.sessions[name].state, f).cpu(),
                               getattr(cs.sessions[name].state, f)), (name, f)
    ids = np.arange(1024)
    with gs.reader() as gv, cs.reader() as cv:
        for name in ("cc", "sssp"):
            assert np.array_equal(gv.lookup(name, ids), cv.lookup(name, ids))


def test_exchange_dist_nccl_int16_one_rank(cuda, tmp_path):
    """``exchange_dist`` and ``exchange_dist_delayed`` on a 1-rank NCCL
    group with int16 codecs (NCCL has no int16: the payload crosses as
    its bytes) deliver the local transport's bits, rings included."""
    import torch.distributed as dist

    from repro_torch.dist import exchange as X
    from repro_torch.launch import mesh as MS
    group, dev = MS.make_worker_group(
        0, 1, backend="nccl", init_method=f"file://{tmp_path / 'store'}",
        timeout_s=120)
    try:
        rng = np.random.default_rng(9)
        for kind, ident in (("int32", 2 ** 31 - 1), ("float32", np.inf)):
            codec = X.make_wire_codec(
                num_shards=1, capacity=512, vs=20_000, requested="int16",
                value_kind=kind, identity=ident, max_int_value=30_000,
                idempotent=True)
            assert codec.compression == "int16" and codec.compress_ids
            dtype = torch.int32 if kind == "int32" else torch.float32
            ring = X.init_delay_ring(2, 0, 1, 512, ident, dtype, dev)
            local = X.init_delay_ring(2, 1, 1, 512, ident, dtype, dev)
            for t in range(5):
                vals = torch.from_numpy(
                    rng.integers(0, 30_000, (1, 512)).astype(np.int32)
                    if kind == "int32" else
                    rng.uniform(0, 99, (1, 512)).astype(np.float32)).to(dev)
                ids = torch.from_numpy(rng.integers(
                    -1, 20_000, (1, 512)).astype(np.int32)).to(dev)
                rv, ri = X.exchange_dist(codec, vals, ids, group)
                lv, li = X.exchange_local(codec, vals[None], ids[None])
                assert torch.equal(rv, lv[0]) and torch.equal(ri, li[0])
                tick = torch.tensor(t, dtype=torch.int32, device=dev)
                delays = torch.tensor([t % 3], dtype=torch.int32, device=dev)
                rv, ri, ring, pend = X.exchange_dist_delayed(
                    codec, ring, vals, ids, tick, delays, group, ident)
                lv, li, local, lpend = X.exchange_local_delayed(
                    codec, local, vals[None], ids[None], tick, delays[None],
                    ident)
                assert torch.equal(rv, lv[0]) and torch.equal(ri, li[0])
                assert int(pend) == int(lpend)
                for a, b in zip(ring, local):
                    assert torch.equal(a, b[:, 0])
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------- dense LM
LM_DENSE = ["qwen3-4b", "glm4-9b", "chatglm3-6b", "granite-20b",
            "chameleon-34b"]
LM_GAP = 0.15  # a bf16 near tie (tests/test_serve.py)


def _lm(dev, arch="qwen3-4b", **kw):
    """The reduced ``arch`` on the CPU and the same weights on ``dev``."""
    import copy
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_config(arch).reduced(), **kw)
    host = T.init_lm(cfg, seed=0, device="cpu")
    return cfg, host, copy.deepcopy(host).to(dev)


@pytest.mark.parametrize("arch", LM_DENSE)
def test_lm_logits_on_card_match_cpu(cuda, arch):
    """Train and prefill logits of each dense arch reduced: the card
    against the CPU within chip_smoke.py's ``LM_CARD_TOL`` of max|logit|
    (the port's 2-layer tolerance against the JAX package)."""
    from repro_torch.models import transformer as T
    cfg, host, card = _lm(cuda, arch)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)))
    for mode in ("train", "prefill"):
        hc = T.init_cache(cfg, 2, 20, "cpu") if mode == "prefill" else None
        gc = T.init_cache(cfg, 2, 20, cuda) if mode == "prefill" else None
        lh = T.forward(host, cfg, tokens, mode=mode, caches=hc)[0].float()
        lg = T.forward(card, cfg, tokens.to(cuda), mode=mode,
                       caches=gc)[0].float().cpu()
        assert (lg - lh).abs().max() <= 5.0e-2 * lh.abs().max(), mode


@pytest.mark.parametrize("layers", [2, 8])
def test_lm_slot_server_on_card_matches_generate(cuda, layers):
    """5 requests on 2 slots, staggered: each equals the card's
    ``generate`` of its prompt alone, or differs first at a bf16 near
    tie under the card's full forward."""
    from repro_torch.models import transformer as T
    from repro_torch.serve import engine as SE
    cfg, _, card = _lm(cuda, num_layers=layers)
    rng = np.random.default_rng(3)
    reqs = [SE.Request(rid, rng.integers(0, cfg.vocab_size, n)
                       .astype(np.int32), m)
            for rid, (n, m) in enumerate(zip([12, 9, 16, 10, 14],
                                             [5, 3, 7, 4, 6]))]
    server = SE.SlotServer(card, cfg, num_slots=2, s_max=31)
    for r in reqs:
        server.submit(r)
    done = server.run()
    for r in reqs:
        got = done[r.rid]
        alone = SE.generate(card, cfg, r.prompt[None], r.max_new)[0]
        diff = np.flatnonzero(alone[len(r.prompt):] != got)
        if diff.size:
            i = int(diff[0])
            prefix = np.concatenate([r.prompt, got[:i]])[None]
            last = T.forward(card, cfg, torch.as_tensor(prefix, device=cuda)
                             )[0][0, -1].float().cpu()
            assert abs(float(last[got[i]] - last[alone[len(r.prompt) + i]])
                       ) < LM_GAP, (r.rid, i)


def test_lm_flash_prefill_on_card_matches_dense(cuda):
    """S = 2,304 > FLASH_THRESHOLD: the flash path against the dense
    path on the card, within tests/test_torch_lm.py's 2.4e-2 of max|out|."""
    from repro_torch.models import attention as TA
    S = 2304
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, S, h, 16)))
               .to(cuda, torch.bfloat16) for h in (4, 2, 2))
    flash = TA.flash_attention(q, k, v).float()
    causal = torch.tril(torch.ones(S, S, dtype=torch.bool, device=cuda))
    dense = TA.dense_attention(q, k, v, causal[None, None, None]).float()
    assert (flash - dense).abs().max() <= 2.4e-2 * dense.abs().max()


@pytest.mark.parametrize("layers", [2, 8])
def test_lm_cache_checkpoint_round_trip_on_card(cuda, tmp_path, layers):
    """A prefilled cache saved by ``CheckpointManager`` restores on the
    card as ``LayerCache``/``KVCache`` with equal tensors, and decodes."""
    from repro_torch.ft import checkpoint as CK
    from repro_torch.models import attention as TA
    from repro_torch.models import transformer as T
    from repro_torch.serve import engine as SE
    cfg, _, card = _lm(cuda, num_layers=layers)
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 8))).to(cuda)
    _, caches = SE.make_prefill_step(cfg)(card, {"tokens": tokens},
                                          T.init_cache(cfg, 2, 12, cuda))
    CK.CheckpointManager(str(tmp_path)).save(1, caches)
    tree, _ = CK.CheckpointManager(str(tmp_path)).restore(device=cuda)
    for (sa, a), (sb, b) in zip(SE._kv_caches(caches), SE._kv_caches(tree)):
        assert sa == sb and isinstance(b, TA.KVCache)
        for x, y in zip(a, b):
            assert y.device.type == "cuda" and torch.equal(x, y)
    assert all(isinstance(s, T.LayerCache) if layers == 8 else
               all(isinstance(lc, T.LayerCache) for lc in s) for s in tree)
    logits, _ = SE.make_decode_step(cfg)(card, tokens[:, -1:], tree)
    assert torch.isfinite(logits.float()).all()


# ------------------------------------------------------------- LM training
def test_lm_flash_gradients_on_card_match_dense(cuda):
    """qwen3-4b's heads (32 on 8 KV heads of 128) at 2,304 tokens: the
    flash ``autograd.Function``'s dq, dk, dv against autograd through the
    dense path on the card, within tests/test_torch_train.py's 3.2e-2 of
    max|grad| (chip_smoke.py's ``LM_FLASH_GRAD_TOL``)."""
    from repro_torch.models import attention as TA
    S = 2304
    rng = np.random.default_rng(0)

    def leaf(h):
        return torch.from_numpy(rng.standard_normal((1, S, h, 128))).to(
            cuda, torch.bfloat16).requires_grad_()
    q, k, v = leaf(32), leaf(8), leaf(8)
    dout = torch.from_numpy(rng.standard_normal((1, S, 32, 128))).to(
        cuda, torch.bfloat16)
    flash = torch.autograd.grad(TA.flash_attention(q, k, v), (q, k, v), dout)
    causal = torch.tril(torch.ones(S, S, dtype=torch.bool, device=cuda))
    dense = torch.autograd.grad(TA.dense_attention(
        q, k, v, causal[None, None, None]), (q, k, v), dout)
    for a, b in zip(flash, dense):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        assert (a.float() - b.float()).abs().max() <= \
            3.2e-2 * b.float().abs().max()


def test_lm_train_steps_on_card_match_cpu(cuda):
    """The 8-layer reduced qwen3-4b (the stacked layout) trained 2 steps
    from the same weights and batches on the card and on the CPU: loss
    and grad norm within chip_smoke.py's ``LM_TRAIN_CARD_TOL`` (1e-2,
    relative), every parameter within 4 x lr a step plus one bf16 ulp of
    the largest weight (an update whose direction flipped)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.ft import checkpoint as CK
    from repro_torch.models import transformer as T
    from repro_torch.train import trainer as TR
    cfg = dataclasses.replace(get_config("qwen3-4b").reduced(), num_layers=8)
    step = TR.make_train_step(cfg)
    rng = np.random.default_rng(0)
    batches = [{"tokens": rng.integers(0, cfg.vocab_size, (4, 32)),
                "labels": rng.integers(0, cfg.vocab_size, (4, 32))}
               for _ in range(2)]
    host = TR.init_state(cfg, 0, "cpu")
    card = TR.from_checkpoint(cfg, CK._map_leaves(
        lambda t: t.clone(), TR.to_checkpoint(host)), cuda)
    assert card.params.embed.device.type == "cuda"
    for b in batches:
        host, mh = step(host, b)
        card, mc = step(card, b)
        for key in ("loss", "grad_norm"):
            h, c = float(mh[key]), float(mc[key])
            assert abs(h - c) <= 1e-2 * abs(h), key
    hp, cp = T.param_dict(host.params), T.param_dict(card.params)
    ulp = max(float(p.detach().abs().max()) for p in hp.values()) * 2.0 ** -8
    for k, p in hp.items():
        assert (cp[k].detach().cpu().float() - p.detach().float()
                ).abs().max() <= 4 * 3e-4 * len(batches) + ulp, k


# ---------------------------------------------------------------- MoE
def _share_within(a, b, tol) -> float:
    """The share of rows (last dim reduced) of ``b`` within ``tol`` of
    max|a| of ``a`` (a routing flip moves a whole row)."""
    a, b = a.float().cpu(), b.float().cpu()
    per = (a - b).abs().amax(-1) / a.abs().max()
    return float((per <= tol).float().mean())


@pytest.mark.parametrize("shape", [(4, 32), (16, 1), (2, 1)])
def test_moe_layer_on_card_matches_cpu(cuda, shape):
    """The reduced phi3.5-moe layer 0 (4 experts top-2) in prefill (4
    groups of 32), decode of 16 rows and of 2 rows (C = 1: drops): the
    card against the CPU on the same weights, >= 90% of the rows within
    chip_smoke.py's ``LM_CARD_TOL`` of max|out| (the rest routing flips
    at bf16 near ties of the router logits), the aux within 1e-3."""
    from repro_torch.models import moe
    cfg, host, card = _lm(cuda, "phi3.5-moe-42b-a6.6b")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        shape + (cfg.d_model,))).to(torch.bfloat16)
    yh, ah = moe.apply_moe(dict(host.stacks[0][0].moe), cfg, x)
    yc, ac = moe.apply_moe(dict(card.stacks[0][0].moe), cfg, x.to(cuda))
    assert yc.device.type == "cuda" and yc.dtype == torch.bfloat16
    assert _share_within(yh, yc, 5.0e-2) >= 0.9
    assert abs(float(ah) - float(ac)) <= 1e-3 * float(ah)


def test_moe_a2a_one_nccl_rank(cuda, tmp_path):
    """``apply_moe_a2a`` on a 1 x 1 mesh whose groups are one NCCL rank
    (both all-to-alls cross NCCL, bf16 as its bytes; the gather over the
    1-rank data axis returns its input)
    against the same call over a gloo group on the CPU: >= 90% of the
    rows within 5e-2 of max|out|."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import Mesh, use_mesh_rules
    from repro_torch.launch import mesh as MS
    from repro_torch.models import moe, moe_a2a
    from repro_torch.models import transformer as T
    cfg = get_config("phi3.5-moe-42b-a6.6b").reduced()
    p = dict(T.init_lm(cfg, 0, "cpu").stacks[0][0].moe)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 16, cfg.d_model))).to(torch.bfloat16)
    _, gate, sel = moe.route(p, cfg, x)
    group, dev = MS.make_worker_group(
        0, 1, backend="nccl", init_method=f"file://{tmp_path / 'store'}",
        timeout_s=120)
    try:
        host = dist.new_group([0], backend="gloo")
        out = {}
        for g, d in ((group, dev), (host, torch.device("cpu"))):
            mesh = Mesh({"data": 1, "model": 1}, 0, {
                ("data",): g, ("model",): g, ("data", "model"): g})
            with use_mesh_rules(mesh):
                assert moe_a2a.fsdp_axes(mesh, cfg, cfg.d_model) == ("data",)
                out[d.type] = moe_a2a.apply_moe_a2a(
                    {k: v.to(d) for k, v in p.items()}, cfg, x.to(d),
                    gate.reshape(4, 16, 2).to(d),
                    sel.reshape(4, 16, 2).to(d))
    finally:
        dist.destroy_process_group()
    assert out["cuda"].device.type == "cuda"
    assert _share_within(out["cpu"], out["cuda"], 5.0e-2) >= 0.9


# ------------------------------------------------------ SSM and hybrid
SSM_CASES = [("mamba2-780m", 2), ("hymba-1.5b", 4)]


def test_softplus_on_card_matches_cpu(cuda):
    """``models/ssm.py::softplus`` on the card (the device's ``expf`` and
    ``log1pf``, as XLA calls them there) against the CPU's (XLA's CPU
    polynomials spelled out): forward and gradient within 8 float32 ulps
    of each value (the same libm formula on the CPU is within 2.1 and 2.7
    ulps of the spelling on these inputs)."""
    from repro_torch.models import ssm
    rng = np.random.default_rng(0)
    x = torch.from_numpy(np.concatenate([
        np.linspace(-30, 40, 20001), rng.standard_normal(20000) * 8
    ]).astype(np.float32))
    out = []
    for dev in ("cpu", cuda):
        t = x.to(dev).clone().requires_grad_()
        y = ssm.softplus(t)
        y.sum().backward()
        out.append((y.detach().cpu(), t.grad.cpu()))
    (yc, gc), (yg, gg) = out
    for c, g in ((yc, yg), (gc, gg)):
        assert ((c - g).abs() <= 8 * 2.0 ** -23 * c.abs()).all()


def test_ssd_chunked_on_card_matches_cpu(cuda):
    """The chunked scan in fp32 (4 chunks of 16) and its gradients: the
    card against the CPU within 1e-5 of each max (tests/test_torch_ssm.py's
    tolerance against the JAX package)."""
    from repro_torch.models import ssm
    rng = np.random.default_rng(0)
    shapes = ((2, 64, 4, 8), (2, 64, 4), (4,), (2, 64, 8), (2, 64, 8))
    args = [torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
            for sh in shapes]
    args[1] = torch.nn.functional.softplus(args[1])
    args[2] = -args[2].abs() - 0.5
    ct = torch.from_numpy(rng.standard_normal(shapes[0]).astype(np.float32))
    got = []
    for dev in ("cpu", cuda):
        leaves = [a.to(dev).clone().requires_grad_() for a in args]
        y, s = ssm.ssd_chunked(*leaves, 16)
        torch.sum(y * ct.to(dev)).backward()
        got.append([y.detach().cpu(), s.detach().cpu()] + [
            t.grad.cpu() for t in leaves])
    for a, b in zip(*got):
        assert (a - b).abs().max() <= 1e-5 * a.abs().max()


@pytest.mark.parametrize("arch,layers", SSM_CASES)
def test_ssm_logits_on_card_match_cpu(cuda, arch, layers):
    """Train and prefill logits of reduced mamba2 and hymba (4 layers:
    layer 1 windowed) over 40 tokens, past hymba's window of 32: the card
    against the CPU within chip_smoke.py's ``LM_CARD_TOL`` of max|logit|."""
    from repro_torch.models import transformer as T
    cfg, host, card = _lm(cuda, arch, num_layers=layers)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 40)))
    for mode in ("train", "prefill"):
        hc = T.init_cache(cfg, 2, 48, "cpu") if mode == "prefill" else None
        gc = T.init_cache(cfg, 2, 48, cuda) if mode == "prefill" else None
        lh = T.forward(host, cfg, tokens, mode=mode, caches=hc)[0].float()
        lg = T.forward(card, cfg, tokens.to(cuda), mode=mode,
                       caches=gc)[0].float().cpu()
        assert (lg - lh).abs().max() <= 5.0e-2 * lh.abs().max(), mode


@pytest.mark.parametrize("arch,layers", SSM_CASES)
def test_ssm_slot_server_on_card_matches_generate(cuda, arch, layers):
    """5 requests on 2 slots, prompts of 9-40 tokens (hymba's ring rolled
    for two), staggered: each equals the card's ``generate`` of its prompt
    alone, or differs first at a bf16 near tie under the card's full
    forward."""
    from repro_torch.models import transformer as T
    from repro_torch.serve import engine as SE
    cfg, _, card = _lm(cuda, arch, num_layers=layers)
    rng = np.random.default_rng(3)
    reqs = [SE.Request(rid, rng.integers(0, cfg.vocab_size, n)
                       .astype(np.int32), m)
            for rid, (n, m) in enumerate(zip([12, 9, 40, 10, 36],
                                             [5, 3, 7, 4, 6]))]
    server = SE.SlotServer(card, cfg, num_slots=2, s_max=55)
    for r in reqs:
        server.submit(r)
    done = server.run()
    for r in reqs:
        got = done[r.rid]
        alone = SE.generate(card, cfg, r.prompt[None], r.max_new)[0]
        diff = np.flatnonzero(alone[len(r.prompt):] != got)
        if diff.size:
            i = int(diff[0])
            prefix = np.concatenate([r.prompt, got[:i]])[None]
            last = T.forward(card, cfg, torch.as_tensor(prefix, device=cuda)
                             )[0][0, -1].float().cpu()
            assert abs(float(last[got[i]] - last[alone[len(r.prompt) + i]])
                       ) < LM_GAP, (r.rid, i)


# ------------------------------------------- MLA and MTP; encoder-decoder
def _mla(dev, **kw):
    return _lm(dev, "deepseek-v3-671b", **kw)


def _hold_rows(got, want, tol=5.0e-2, share=0.75):
    """Logits [B, S, V]: at least ``share`` of the positions within
    ``tol`` of max|logit| (the rest are routing flips at router near
    ties), none off by more than the largest logit."""
    per = (got - want).abs().amax(-1) / want.abs().max()
    assert float((per <= tol).float().mean()) >= share, per
    assert float(per.max()) <= 1.0, per


@pytest.mark.parametrize("layers", [2, 9])
def test_mla_logits_on_card_match_cpu(cuda, layers):
    """The reduced deepseek (MLA, a dense and MoE layers; 9: a stacked
    MoE stack and compressed cache): train and prefill logits, then 3
    decode steps, the card against the CPU (``chip_smoke.py``'s rule for
    the MoE family: 75% of the positions within 5e-2 of max|logit|)."""
    from repro_torch.models import transformer as T
    cfg, host, card = _mla(cuda, num_layers=layers, capacity_factor=16.0)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 12)))
    hc, gc = T.init_cache(cfg, 2, 16, "cpu"), T.init_cache(cfg, 2, 16, cuda)
    for mode in ("train", "prefill"):
        lh, hc2, _, _ = T.forward(host, cfg, tokens, mode=mode,
                                  caches=hc if mode == "prefill" else None)
        lg, gc2, _, _ = T.forward(card, cfg, tokens.to(cuda), mode=mode,
                                  caches=gc if mode == "prefill" else None)
        _hold_rows(lg.float().cpu(), lh.float())
    hs, gs = [], []
    for t in range(3):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 1)))
        pos = torch.full((2, 1), 12 + t)
        lh, hc2, _, _ = T.forward(host, cfg, tok, pos, "decode", hc2)
        lg, gc2, _, _ = T.forward(card, cfg, tok.to(cuda), pos.to(cuda),
                                  "decode", gc2)
        hs.append(lh.float())
        gs.append(lg.float().cpu())
    _hold_rows(torch.cat(gs, 1), torch.cat(hs, 1), share=0.5)


def test_mla_slot_server_on_card_matches_generate(cuda):
    """5 requests on 2 slots, staggered, through the packed per-slot
    compressed cache (no pair dropped: capacity factor 16): each equals
    the card's ``generate`` of its prompt alone, or differs first at a
    bf16 near tie under the card's full forward."""
    from repro_torch.models import transformer as T
    from repro_torch.serve import engine as SE
    cfg, _, card = _mla(cuda, capacity_factor=16.0)
    rng = np.random.default_rng(3)
    reqs = [SE.Request(rid, rng.integers(0, cfg.vocab_size, n)
                       .astype(np.int32), m)
            for rid, (n, m) in enumerate(zip([12, 9, 16, 10, 14],
                                             [5, 3, 7, 4, 6]))]
    server = SE.SlotServer(card, cfg, num_slots=2, s_max=31)
    assert server.caches[0][0].kv.v is None
    for r in reqs:
        server.submit(r)
    done = server.run()
    for r in reqs:
        got = done[r.rid]
        alone = SE.generate(card, cfg, r.prompt[None], r.max_new)[0]
        diff = np.flatnonzero(alone[len(r.prompt):] != got)
        if diff.size:
            i = int(diff[0])
            prefix = np.concatenate([r.prompt, got[:i]])[None]
            last = T.forward(card, cfg, torch.as_tensor(prefix, device=cuda)
                             )[0][0, -1].float().cpu()
            assert abs(float(last[got[i]] - last[alone[len(r.prompt) + i]])
                       ) < LM_GAP, (r.rid, i)


def test_mla_absorbed_decode_on_card_matches_cpu(cuda):
    """One reduced MLA layer: a 12-token prefill, then 4 absorbed decode
    steps (fp32 scores against the compressed and rope rows), the card
    against the CPU within 1e-2 of max|out|, the packed caches within
    one bf16 ulp."""
    from repro_torch.models import attention as TA
    cfg, host, card = _mla(cuda)
    ph = dict(host.stacks[0][0].attn.items())
    pg = dict(card.stacks[0][0].attn.items())
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 16, cfg.d_model))
                         ).to(torch.bfloat16)
    pos = torch.arange(16)[None].expand(2, 16)
    ch, cg = TA.init_kv_cache(cfg, 2, 16, "cpu"), TA.init_kv_cache(
        cfg, 2, 16, cuda)
    _, ch = TA.attention_layer(ph, cfg, x[:, :12], pos[:, :12], cache=ch,
                               mode="prefill")
    _, cg = TA.attention_layer(pg, cfg, x[:, :12].to(cuda),
                               pos[:, :12].to(cuda), cache=cg, mode="prefill")
    for t in range(12, 16):
        oh, ch = TA.attention_layer(ph, cfg, x[:, t:t + 1], pos[:, t:t + 1],
                                    cache=ch, mode="decode")
        og, cg = TA.attention_layer(pg, cfg, x[:, t:t + 1].to(cuda),
                                    pos[:, t:t + 1].to(cuda), cache=cg,
                                    mode="decode")
        assert (og.float().cpu() - oh.float()).abs().max() <= (
            1e-2 * oh.float().abs().max())
    assert cg.v is None and int(cg.pos) == 16
    diff = (cg.k.float().cpu() - ch.k.float()).abs()
    assert float(diff.max()) <= 2 ** -7 * float(ch.k.float().abs().max())


def test_mla_flash_gradients_on_card_match_dense(cuda):
    """MLA's shapes at 2,304 tokens: q and k 24 wide, v 16 (dv != hd):
    the flash forward and its backward against autograd through the
    dense path, within 2.4e-2 (out) and 3.2e-2 (each grad) of max."""
    from repro_torch.models import attention as TA
    S = 2304
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, S, 4, d)))
               .to(cuda, torch.bfloat16).requires_grad_(True)
               for d in (24, 24, 16))
    ct = torch.from_numpy(rng.standard_normal((1, S, 4, 16))).to(cuda)
    flash = TA.flash_attention(q, k, v)
    fg = torch.autograd.grad((flash.float() * ct).sum(), (q, k, v))
    causal = torch.tril(torch.ones(S, S, dtype=torch.bool, device=cuda))
    dense = TA.dense_attention(q, k, v, causal[None, None, None])
    dg = torch.autograd.grad((dense.float() * ct).sum(), (q, k, v))
    assert flash.shape == (1, S, 4, 16)
    assert (flash.float() - dense.float()).abs().max() <= (
        2.4e-2 * dense.float().abs().max())
    for a, b in zip(fg, dg):
        assert (a.float() - b.float()).abs().max() <= (
            3.2e-2 * b.float().abs().max())


def test_encdec_on_card_matches_cpu(cuda):
    """The reduced whisper: ``encode``, the prefill's and 3 decode steps'
    logits, the card against the CPU within 5e-2 of max; ``generate``
    with features on the card equal to the CPU's, or a near tie."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.models import encdec as ED
    from repro_torch.serve import engine as SE
    cfg = get_config("whisper-medium").reduced()
    host = ED.init_encdec(cfg, seed=0, device="cpu")
    card = copy.deepcopy(host).to(cuda)
    rng = np.random.default_rng(2)
    f = torch.from_numpy(rng.standard_normal((2, cfg.enc_seq, cfg.d_model))
                         ).to(torch.bfloat16)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8)))
    eh, eg = ED.encode(host, cfg, f), ED.encode(card, cfg, f.to(cuda))
    assert (eg.float().cpu() - eh.float()).abs().max() <= (
        5e-2 * eh.float().abs().max())
    ch, cg = ED.init_dec_cache(cfg, 2, 12, "cpu"), ED.init_dec_cache(
        cfg, 2, 12, cuda)
    lh, ch = ED.encdec_prefill(host, cfg, f, tok, ch)
    lg, cg = ED.encdec_prefill(card, cfg, f.to(cuda), tok.to(cuda), cg)
    for t in range(4):
        assert (lg.float().cpu() - lh.float()).abs().max() <= (
            5e-2 * lh.float().abs().max()), t
        nxt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 1)))
        lh, ch = ED.encdec_decode(host, cfg, nxt, ch)
        lg, cg = ED.encdec_decode(card, cfg, nxt.to(cuda), cg)
    oh = SE.generate(host, cfg, tok.numpy(), 6, features=f)
    og = SE.generate(card, cfg, tok.numpy(), 6, features=f.to(cuda))
    for r in range(2):
        diff = np.flatnonzero(oh[r] != og[r])
        if diff.size:
            i = int(diff[0])
            pos = torch.arange(i)[None]
            last = ED.decode_stack(host, cfg, torch.from_numpy(oh[r:r + 1, :i]),
                                   pos, ED.encode(host, cfg, f[r:r + 1]),
                                   None, "prefill")[0][0, -1].float()
            assert abs(float(last[oh[r, i]] - last[og[r, i]])) < LM_GAP


def test_adafactor_pieces_on_card_match_cpu(cuda, monkeypatch):
    """Adafactor with ``PIECE`` at 48 elements (a stacked factored leaf in
    whole matrices, a two-dim leaf in row blocks, an unfactored one):
    3 steps on the card against the CPU, parameters within one bf16 ulp
    of their max, moments within 1e-5 relative."""
    from repro_torch.train import optimizer as TO
    monkeypatch.setattr(TO, "PIECE", 48)
    g = torch.Generator().manual_seed(0)
    shapes = {"stack": (6, 5, 7), "rows": (40, 9), "vec": (300,)}
    params = {k: torch.randn(s, generator=g).to(torch.bfloat16)
              for k, s in shapes.items()}
    grads = {k: torch.randn(s, generator=g).to(torch.bfloat16)
             for k, s in shapes.items()}
    out = {}
    for dev in ("cpu", cuda):
        p = {k: v.clone().to(dev) for k, v in params.items()}
        opt = TO.Adafactor()
        st = opt.init(p)
        for i in range(3):
            opt.update({k: (v.float() * (i + 1)).to(torch.bfloat16).to(dev)
                        for k, v in grads.items()}, st, p,
                       torch.tensor(1e-2, device=dev))
        out[str(dev)] = (p, st)
    (ph, sh), (pg, sg) = out["cpu"], out[str(cuda)]
    for k in shapes:
        a, b = pg[k].float().cpu(), ph[k].float()
        assert (a - b).abs().max() <= 2 ** -7 * b.abs().max(), k
        for field in ("vr", "vc", "v"):
            x, y = getattr(sg, field)[k].cpu(), getattr(sh, field)[k]
            assert (x - y).abs().max() <= 1e-5 * y.abs().max() + 1e-30, k


# ----------------------------------------------------------------------
# The dry run's per-rank bytes on the card
# ----------------------------------------------------------------------
def test_dryrun_rank_bytes_on_card(cuda):
    """Rank 0's block of every input of qwen3-4b's ``train_4k`` cell on
    the 16 x 16 mesh allocated on the card: ``memory_allocated`` rises by
    the blocks' bytes, each rounded up to the allocator's 512 B, and the
    blocks add up to the dry run's ``argument_bytes``."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun as DR
    cfg = get_config("qwen3-4b")
    mesh = DR.make_production_mesh()
    ci = DR.cell_inputs(cfg, SHAPES["train_4k"], mesh,
                        DR.rules_for(cfg, mesh))
    want = sum(DR.rank_bytes(t, sh) for t, sh in ci.trees)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        before = torch.cuda.memory_allocated(cuda)
        blocks = DR.rank_blocks(ci.trees, cuda)
        rise = torch.cuda.memory_allocated(cuda) - before
    finally:
        torch.cuda.memory._set_allocator_settings("expandable_segments:False")
    nbytes = [t.numel() * t.element_size() for t in blocks]
    assert sum(nbytes) == want
    assert rise == sum(-(-n // 512) * 512 for n in nbytes)
    del blocks
    torch.cuda.empty_cache()
