"""The engine tick's create on the CPU: the plain ``_phase1_create`` against
a loop that selects, fetches, creates and routes one vertex and one edge
at a time (``tests/_create_cases.py``), bitwise on every output, in every
case of the table; and the refusals of ``kernels/create.py::create`` that
need no card.  The CUDA kernels are held to the plain version on the card
(``test_torch_gpu.py``)."""
import dataclasses
import os
import time

import pytest

torch = pytest.importorskip("torch")

import _create_cases as CC  # noqa: E402
from repro_torch.core import engine as E  # noqa: E402
from repro_torch.core import programs as PG  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import create as CK  # noqa: E402


@pytest.mark.parametrize("case", CC.CASES, ids=CC.case_id)
def test_plain_create_matches_loop(case):
    prog, ep, args, kwargs = CC.make_case(case, "cpu",
                                          seed=CC.CASES.index(case))
    before = [t.clone() for t in args if t is not None]
    launches = CK.create.launches
    got = E._phase1_create(prog, ep, *args, **kwargs)
    CC.assert_same(got, CC.create_loop(prog, ep, *args, **kwargs), case.name)
    assert got[6] is args[0]  # values pass through
    for b, t in zip(before, [t for t in args if t is not None]):
        assert torch.equal(b, t)  # the inputs are left as they were
    assert CK.create.launches == launches  # the CPU never launches
    sent, fetched = int(got[4].sum()), int(got[5].sum())
    if case.cap < 8:
        assert sent < fetched  # the cap drops messages; cursors retry
    elif case.name == "empty_frontier":
        assert fetched == 0 and not bool(got[0].any())
    else:
        assert 0 < sent == fetched


def test_frontier_above_m_selects_m():
    """A frontier above M is cut to M vertices a shard, the lowest buckets
    first (the loop's ordering, checked bitwise above)."""
    case = next(c for c in CC.CASES if c.name == "frontier_above_m")
    prog, ep, args, kwargs = CC.make_case(case, "cpu", seed=1)
    active, cursor = args[1], args[2]
    got = E._phase1_create(prog, ep, *args, **kwargs)
    touched = (got[0] != active) | (got[1] != cursor)
    assert int(active.sum(dim=1).min()) > case.M
    assert bool((touched.sum(dim=1) <= case.M).all())


def _card_free_case(name="cc"):
    case = next(c for c in CC.CASES if c.name == name)
    return CC.make_case(case, "cpu", seed=0)


def test_create_wrapper_refuses_push_mode_and_unknown_programs():
    prog, ep, args, kwargs = _card_free_case()
    with pytest.raises(ValueError, match="idempotent"):
        CK.create(PG.get_program("pagerank"), ep, *args)
    alias = dataclasses.replace(prog, name="cc_custom")
    with pytest.raises(ValueError, match="no create kernel"):
        CK.create(alias, ep, *args)
    with pytest.raises(ValueError, match="priority"):
        CK.create(prog, dataclasses.replace(ep, priority="fifo"), *args)


def test_create_wrapper_refuses_bad_inputs():
    prog, ep, args, _ = _card_free_case()
    values, active, cursor, row_ptr, col_idx, weights = args
    with pytest.raises(TypeError):
        CK.create(prog, ep, values.float(), *args[1:])
    with pytest.raises(TypeError):
        CK.create(prog, ep, values, active.int(), *args[2:])
    with pytest.raises(TypeError):
        CK.create(prog, ep, values, active, cursor, row_ptr.long(), col_idx,
                  weights)
    with pytest.raises(ValueError):  # params of another shard size
        CK.create(prog, dataclasses.replace(ep, vs=ep.vs + 1), *args)
    with pytest.raises(ValueError):
        CK.create(prog, ep, values, active, cursor, row_ptr[:, :-1],
                  col_idx, weights)
    with pytest.raises(ValueError):
        CK.create(prog, ep, *args, throttle=torch.ones(7, dtype=torch.int32))
    with pytest.raises(ValueError):
        CK.create(prog, dataclasses.replace(ep, num_shards=513), *args)


def test_create_wrapper_has_no_cpu_path():
    """For CPU tensors the engine takes the plain version itself; the
    wrapper refuses them rather than fall back, and counts nothing."""
    prog, ep, args, kwargs = _card_free_case()
    launches = CK.create.launches
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        CK.create(prog, ep, *args, **kwargs)
    assert CK.create.launches == launches


def test_push_mode_keeps_the_plain_create():
    """pagerank (aux given, a SUM aggregator) never reaches the wrapper: its
    create is the plain one on every device."""
    assert not PG.get_program("pagerank").aggregator.idempotent
    assert all(PG.get_program(name).aggregator.idempotent
               for name in CK._COMBINE)


def test_engine_kernels_build_together(tmp_path, monkeypatch):
    """The first use of either engine kernel builds both, their nvcc runs
    at once (a stand-in nvcc that takes a second here); a second build
    finds both libraries."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\nsleep 1\nwhile [ \"$1\" != -o ]; do shift; "
                    "done\n: > \"$2\"\necho 'ptxas info : Used 8 registers'\n")
    fake.chmod(0o755)
    for name in _build._ENGINE:
        (tmp_path / f"{name}.cu").write_text(f"// {name}\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc", lambda: str(fake))
    assert set(_build._TOGETHER["engine_create"]) == set(_build._ENGINE)
    assert set(_build._TOGETHER["engine_receive"]) == set(_build._ENGINE)
    t0 = time.perf_counter()
    built = _build.build_together(_build._ENGINE)
    assert time.perf_counter() - t0 < 1.9  # one second, not two
    for name, out in built.items():
        assert not out["cached"] and "Used 8 registers" in out["report"]
        assert os.path.exists(out["path"]) and name in out["path"]
    again = _build.build_together(_build._ENGINE)
    assert all(out["cached"] and out["path"] == built[name]["path"]
               for name, out in again.items())
