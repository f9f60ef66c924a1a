"""Port parity for LM serving: ``generate`` against the JAX package's,
the slot server against the port's ``generate`` of each prompt alone,
the per-row cache position, cache checkpoints written by the JAX
package, and the ``serve`` launcher; for the dense family and for the
SSM and hybrid ones (mamba2: SSD states and conv rows a slot, no KV
cache; hymba: a ring of 32 keys beside global caches).

Token sequences are held by the near-tie rules of ``tests/test_serve.py``
(``_lm_cases.teacher_forced``, ``_lm_cases.same_or_near_tie``).  The
JAX package's ``SlotServer`` is not the reference here: it keeps one
cache position for every slot and decodes admitted requests from the
wrong one (ROADMAP.md §3).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers at once
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.ft import checkpoint as JC  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import engine as JE  # noqa: E402
from repro_torch.ft import checkpoint as TC  # noqa: E402
from repro_torch.launch import serve as LS  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import engine as E  # noqa: E402

from _lm_cases import (J_FWD, carried, f32, jax_logits,  # noqa: E402
                       port_logits, same_or_near_tie, teacher_forced)

LAYOUTS = [{}, {"num_layers": 8}]  # per-layer caches; stacked [L, ...]
IDS = ["2layers", "8layers"]


@pytest.mark.parametrize("kw", LAYOUTS, ids=IDS)
def test_generate_matches_jax(kw):
    B, S, new = 2, 8, 6
    cfg, tcfg, params, model = carried("qwen3-4b", 0, **kw)
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    jout = JE.generate(params, cfg, jnp.asarray(prompt), max_new=new)
    tout = E.generate(model, tcfg, prompt, max_new=new)
    assert tout.shape == (B, S + new) and tout.dtype == np.int32
    assert np.array_equal(tout[:, :S], prompt)
    same_or_near_tie(jax_logits(params, cfg), jout, tout, S)
    teacher_forced(port_logits(model, tcfg), tout, S)


def test_generate_samples_from_its_generator():
    _, tcfg, _, model = carried()
    prompt = np.random.default_rng(1).integers(0, 256, (2, 8))
    outs = [E.generate(model, tcfg, prompt, max_new=5, temperature=1.0,
                       generator=torch.Generator().manual_seed(s))
            for s in (7, 7, 8)]
    assert np.array_equal(outs[0], outs[1])
    assert outs[0].shape == (2, 13) and (outs[0] < tcfg.vocab_size).all()
    greedy = E.generate(model, tcfg, prompt, max_new=5)
    assert not all(np.array_equal(o, greedy) for o in outs)


@pytest.mark.parametrize("kw", LAYOUTS, ids=IDS)
def test_slot_server_matches_generate_alone(kw):
    """5 requests on 2 slots with uneven prompts and ``max_new`` of 3-7:
    a slot is refilled while the other is mid-decode, and every request
    gets what ``generate`` gives its prompt alone."""
    _, tcfg, _, model = carried("qwen3-4b", 0, **kw)
    rng = np.random.default_rng(3)
    lens, news = [12, 9, 16, 10, 14], [5, 3, 7, 4, 6]
    reqs = [E.Request(rid, rng.integers(0, tcfg.vocab_size, n)
                      .astype(np.int32), m)
            for rid, (n, m) in enumerate(zip(lens, news))]
    server = E.SlotServer(model, tcfg, num_slots=2, s_max=16 + 7 + 8)
    for r in reqs:
        server.submit(r)
    steps, staggered = 0, 0
    while server.queue or server.active:
        before = {s: st["rid"] for s, st in server.active.items()}
        server.step()
        steps += 1
        staggered += any(st["rid"] != before.get(s) for s, st in
                         server.active.items()) and bool(before)
    assert sorted(server.done) == list(range(5))
    assert steps < sum(news) - len(news)  # the slots decoded together
    assert staggered  # a slot refilled while the other was mid-decode
    logits = port_logits(model, tcfg)
    for r in reqs:
        got = server.done[r.rid]
        assert len(got) == r.max_new
        alone = E.generate(model, tcfg, r.prompt[None], max_new=r.max_new)
        same_or_near_tie(logits, alone,
                         np.concatenate([r.prompt, got])[None], len(r.prompt))


@pytest.mark.parametrize("kw", LAYOUTS, ids=IDS)
def test_vector_pos_decode_is_bitwise_scalar(kw):
    """A ``[B]`` cache position with equal entries decodes bitwise what
    the scalar position does: logits, K/V and the new positions."""
    cfg, tcfg, _, model = carried("qwen3-4b", 0, **kw)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 10)))
    caches = T.init_cache(tcfg, 2, 16, "cpu")
    _, caches = E.make_prefill_step(tcfg)(model, {"tokens": tokens}, caches)
    decode = E.make_decode_step(tcfg)
    tok = tokens[:, -1:]

    def with_pos(vector):
        def kv(c):
            pos = c.pos.clone()
            if vector:
                pos = pos[..., None].expand(pos.shape + (2,)).clone()
            return TA.KVCache(c.k.clone(), c.v.clone(), pos)
        return tuple(T.LayerCache(kv(s.kv), None)
                     if isinstance(s, T.LayerCache)
                     else tuple(T.LayerCache(kv(lc.kv), None) for lc in s)
                     for s in caches)

    ls, cs = decode(model, tok, with_pos(False))
    lv, cv = decode(model, tok, with_pos(True))
    assert torch.equal(ls, lv)
    for (_, a), (_, b) in zip(E._kv_caches(cs), E._kv_caches(cv)):
        assert torch.equal(a.k, b.k) and torch.equal(a.v, b.v)
        assert torch.equal(a.pos[..., None].expand(b.pos.shape), b.pos)
        assert b.pos.shape[-1] == 2 and int(b.pos.flatten()[0]) == 11


@pytest.mark.parametrize("kw", LAYOUTS, ids=IDS)
def test_vector_pos_rows_decode_as_alone(kw):
    """Two prompts of 12 and 7 tokens prefilled alone and written into
    their slots: one decode at their ``[2]`` positions gives each row the
    logits of that row decoded alone at its scalar position (seeds 0-4:
    bitwise equal), so each row writes and masks at its own length."""
    _, tcfg, _, model = carried("qwen3-4b", 0, **kw)
    rng = np.random.default_rng(0)
    prefill, decode = E.make_prefill_step(tcfg), E.make_decode_step(tcfg)
    caches = E._slot_positions(T.init_cache(tcfg, 2, 20, "cpu"), 2)
    alone = []
    for slot, n in enumerate((12, 7)):
        one = T.init_cache(tcfg, 1, 20, "cpu")
        _, one = prefill(model, {"tokens": torch.as_tensor(
            rng.integers(0, tcfg.vocab_size, n))[None]}, one)
        E._write_slot(caches, one, slot)
        alone.append(decode(model, torch.tensor([[5 + slot]]), one)[0][0])
    both, caches = decode(model, torch.tensor([[5], [6]]), caches)
    assert torch.equal(both[0], alone[0]) and torch.equal(both[1], alone[1])
    assert E._cache_pos(caches).tolist() == [13, 8]


def test_slot_server_backpressure():
    _, tcfg, _, model = carried()
    server = E.SlotServer(model, tcfg, num_slots=1, s_max=16, max_queue=2)
    prompt = np.arange(4, dtype=np.int32)
    server.submit(E.Request(0, prompt, 2))
    server.submit(E.Request(1, prompt, 1))
    with pytest.raises(E.QueueFullError):
        server.submit(E.Request(2, prompt, 2))
    done = server.run()
    assert server.rejected == 1 and sorted(done) == [0, 1]
    assert len(done[0]) == 2 and len(done[1]) == 1


@pytest.mark.parametrize("kw", LAYOUTS, ids=IDS)
def test_jax_cache_checkpoint_restores_as_port_types(tmp_path, kw):
    """A prefilled cache tree saved by the JAX package's
    ``CheckpointManager`` restores in the port as ``LayerCache`` and
    ``KVCache`` with equal tensors, and the port decodes from it."""
    cfg, tcfg, params, model = carried("qwen3-4b", 0, **kw)
    tokens = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32)
    _, jc = J_FWD(params, cfg, tokens, "prefill", JT.init_cache(cfg, 2, 12))
    JC.CheckpointManager(str(tmp_path)).save(3, jc)
    tree, _ = TC.CheckpointManager(str(tmp_path)).restore(device="cpu")
    stack, = tree
    if kw:
        assert isinstance(stack, T.LayerCache)
        assert isinstance(stack.kv, TA.KVCache) and stack.ssm is None
    else:
        assert all(isinstance(lc, T.LayerCache)
                   and isinstance(lc.kv, TA.KVCache) for lc in stack)
    jleaves = jax.tree.leaves(jc)
    tleaves = [b for _, kv in E._kv_caches(tree) for b in kv]
    assert len(jleaves) == len(tleaves)
    for a, b in zip(jleaves, tleaves):
        assert b.dtype == (torch.bfloat16 if a.ndim > 1 else torch.int32)
        assert np.array_equal(f32(a), f32(b))
    logits, _ = E.make_decode_step(tcfg)(
        model, torch.from_numpy(tokens[:, -1:]), tree)
    assert torch.isfinite(logits.float()).all()


def test_serve_launcher_on_cpu(capsys):
    LS.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "qwen3-4b-smoke: 6 requests, 2 slots" in out and "device=cpu" in out
    reqs = [ln for ln in out.splitlines() if ln.startswith("  req ")]
    assert len(reqs) == 6 and all("(12 tokens)" in ln for ln in reqs)
    assert "72 tokens in" in out


# ---------------------------------------------------- the SSM and hybrid
SSM_ARCHS = [("mamba2-780m", {}), ("mamba2-780m", {"num_layers": 8}),
             ("hymba-1.5b", {"num_layers": 4})]
SSM_IDS = ["mamba2", "mamba2-8layers", "hymba-4layers"]


def _decode_logits(model, cfg, out: np.ndarray, S: int) -> np.ndarray:
    """The logits ``generate``'s steps saw for ``out`` [B, S + new]: a
    prefill of the prompt, then one decode step a generated token."""
    prefill, decode = E.make_prefill_step(cfg), E.make_decode_step(cfg)
    caches = T.init_cache(cfg, out.shape[0], out.shape[1], "cpu")
    tok = torch.from_numpy(out)
    logits, caches = prefill(model, {"tokens": tok[:, :S]}, caches)
    got = [logits[:, -1]]
    for t in range(S, out.shape[1] - 1):
        logits, caches = decode(model, tok[:, t:t + 1], caches)
        got.append(logits[:, -1])
    return f32(torch.stack(got, dim=1))


@pytest.mark.parametrize("arch,kw", SSM_ARCHS, ids=SSM_IDS)
def test_ssm_hybrid_generate_matches_jax(arch, kw):
    """Prompts of 36 tokens (past hymba's window of 32: its ring rolled),
    6 new: the tokens against the JAX package's ``generate`` (equal, or a
    bf16 near tie at the first difference), and the logits each step saw
    against the full forward's on the same tokens (the recurrent decode
    and the ring against the chunked scan and the blocked window; seeds
    0-4: within 5.1e-2 of max|logit|)."""
    B, S, new = 2, 36, 6
    cfg, tcfg, params, model = carried(arch, 0, **kw)
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    jout = JE.generate(params, cfg, jnp.asarray(prompt), max_new=new)
    tout = E.generate(model, tcfg, prompt, max_new=new)
    assert tout.shape == (B, S + new) and np.array_equal(tout[:, :S], prompt)
    same_or_near_tie(jax_logits(params, cfg), jout, tout, S)
    full = port_logits(model, tcfg)(tout)[:, S - 1:-1]
    steps = _decode_logits(model, tcfg, tout, S)
    assert float(np.abs(full - steps).max() / np.abs(full).max()) <= 1.0e-1


@pytest.mark.parametrize("arch,kw", SSM_ARCHS, ids=SSM_IDS)
def test_ssm_hybrid_slot_server_matches_generate_alone(arch, kw):
    """5 requests on 2 slots (prompts of 9-40 tokens: hymba's ring rolled
    for two), refilled mid-decode: each request's SSD state and conv rows,
    ring and global K/V are its slot's row, so it gets what ``generate``
    gives its prompt alone."""
    _, tcfg, _, model = carried(arch, 0, **kw)
    rng = np.random.default_rng(3)
    lens, news = [12, 9, 40, 10, 36], [5, 3, 7, 4, 6]
    reqs = [E.Request(rid, rng.integers(0, tcfg.vocab_size, n)
                      .astype(np.int32), m)
            for rid, (n, m) in enumerate(zip(lens, news))]
    server = E.SlotServer(model, tcfg, num_slots=2, s_max=40 + 7 + 8)
    for r in reqs:
        server.submit(r)
    done = server.run()
    assert sorted(done) == list(range(5))
    logits = port_logits(model, tcfg)
    for r in reqs:
        got = done[r.rid]
        assert len(got) == r.max_new
        alone = E.generate(model, tcfg, r.prompt[None], max_new=r.max_new)
        same_or_near_tie(logits, alone,
                         np.concatenate([r.prompt, got])[None], len(r.prompt))


@pytest.mark.parametrize("arch,kw", SSM_ARCHS, ids=SSM_IDS)
def test_ssm_hybrid_rows_decode_as_alone(arch, kw):
    """Prompts of 40 and 7 tokens prefilled alone and written into their
    slots (state, conv rows, ring, K/V and position): one decode step of
    both rows gives each the logits of that row decoded alone (seeds 0-4:
    bitwise), and an SSM model's position is 0 (it has no KV cache)."""
    _, tcfg, _, model = carried(arch, 0, **kw)
    rng = np.random.default_rng(0)
    prefill, decode = E.make_prefill_step(tcfg), E.make_decode_step(tcfg)
    caches = E._slot_positions(T.init_cache(tcfg, 2, 48, "cpu"), 2)
    alone = []
    for slot, n in enumerate((40, 7)):
        one = T.init_cache(tcfg, 1, 48, "cpu")
        _, one = prefill(model, {"tokens": torch.as_tensor(
            rng.integers(0, tcfg.vocab_size, n))[None]}, one)
        E._write_slot(caches, one, slot)
        alone.append(decode(model, torch.tensor([[5 + slot]]), one)[0][0])
    both, caches = decode(model, torch.tensor([[5], [6]]), caches)
    assert torch.equal(both[0], alone[0]) and torch.equal(both[1], alone[1])
    pos = E._cache_pos(caches)
    assert pos.tolist() == ([41, 8] if tcfg.num_heads else 0)


@pytest.mark.parametrize("arch,kw", SSM_ARCHS, ids=SSM_IDS)
def test_ssm_cache_checkpoint_restores_as_port_types(tmp_path, arch, kw):
    """A prefilled SSM or hybrid cache tree saved by the JAX package's
    ``CheckpointManager`` restores in the port as ``LayerCache``,
    ``SSMCache`` and ``KVCache`` with equal tensors, and the port decodes
    from it."""
    from repro_torch.models import ssm as TM
    cfg, tcfg, params, model = carried(arch, 0, **kw)
    tokens = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 36)).astype(np.int32)
    _, jc = J_FWD(params, cfg, tokens, "prefill", JT.init_cache(cfg, 2, 40))
    JC.CheckpointManager(str(tmp_path)).save(3, jc)
    tree, _ = TC.CheckpointManager(str(tmp_path)).restore(device="cpu")
    layers = [lc for _, lc in E._layer_caches(tree)]
    assert all(isinstance(lc, T.LayerCache)
               and isinstance(lc.ssm, TM.SSMCache) for lc in layers)
    assert all((lc.kv is None) == (tcfg.num_heads == 0) for lc in layers)
    jleaves = jax.tree.leaves(jc)
    tleaves = [t for t in TC._flatten_with_paths(tree).values()
               if t is not None]
    assert len(jleaves) == len(tleaves)
    for a, b in zip(jleaves, tleaves):
        assert np.array_equal(f32(a), f32(b))
    logits, _ = E.make_decode_step(tcfg)(
        model, torch.from_numpy(tokens[:, -1:]), tree)
    assert torch.isfinite(logits.float()).all()


@pytest.mark.parametrize("arch", ["mamba2-780m", "hymba-1.5b"])
def test_serve_launcher_serves_ssm_and_hybrid(capsys, arch):
    LS.main(["--device", "cpu", "--arch", arch])
    out = capsys.readouterr().out
    assert f"{arch}-smoke: 6 requests, 2 slots" in out
    reqs = [ln for ln in out.splitlines() if ln.startswith("  req ")]
    assert len(reqs) == 6 and all("(12 tokens)" in ln for ln in reqs)
