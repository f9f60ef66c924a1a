"""Ranks for the multi-rank engine ticks: process groups, row cuts, pools.

The production and local meshes (:func:`make_production_mesh`,
:func:`make_local_mesh`) are ``dist.sharding.Mesh`` objects.

Counterpart of ``repro.launch.mesh.make_worker_mesh``: where the JAX
package lays a 1-D ``workers`` mesh over its devices and lets
``shard_map``'s ``P("workers")`` specs cut and join the per-shard arrays,
the port starts one process per shard, joins them in a
``torch.distributed`` group (:func:`make_worker_group`), cuts a global
state to a rank's rows (:func:`rank_rows`) and gathers it back
(:func:`gather_rows`).

The backend is the caller's choice and is never switched: ``"nccl"`` is
the production transport, one rank per card (NCCL refuses two ranks on
one device); ``"gloo"`` runs ranks on the CPU, or several ranks sharing
one card, where it stages CUDA tensors through the host.

:class:`RankPool` keeps ``world_size`` spawned rank processes alive across
several collective jobs, so that torch and CUDA start once.  A rank that
raises, dies or outlives the timeout ends the pool and raises in the
parent: nothing is retried.
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import queue
import time
import traceback
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.dist import exchange as ex_mod
from repro_torch.dist import sharding as sh_mod

BACKENDS = ("nccl", "gloo")


def make_production_mesh(*, multi_pod: bool = False) -> sh_mod.Mesh:
    """The dry run's target layout as a shape-only mesh (no groups, which
    ``ShardingRules.resolve`` does not read): one pod is 16 x 16 (data,
    model); two pods add a leading ``pod`` axis, an outer data-parallel
    dimension."""
    if multi_pod:
        return sh_mod.Mesh({"pod": 2, "data": 16, "model": 16})
    return sh_mod.Mesh({"data": 16, "model": 16})


def make_local_mesh(model: int = 1) -> sh_mod.Mesh:
    """``{"data": n // model, "model": model}`` over the initialised
    world of ``n`` ranks (its groups built: every rank calls it), or over
    this one process when no group is initialised."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if model < 1 or n % model:
        raise ValueError(f"model {model} does not divide {n} ranks")
    shape = {"data": n // model, "model": model}
    if not dist.is_initialized():
        return sh_mod.Mesh(shape)
    return sh_mod.Mesh.build(shape, dist.get_rank())


def make_worker_group(rank: int, world_size: int, *, backend: str,
                      init_method: str, device: DeviceLike = None,
                      timeout_s: float = 300.0):
    """Join this process to the ``world_size``-rank group as ``rank``;
    returns ``(group, device)``.

    ``device=None`` (or ``"cuda"`` with no index) means card
    ``rank % device_count`` (raises without a card); only an explicit
    ``"cpu"`` puts the rank on the host.
    ``init_method`` is a ``file://`` or ``tcp://host:port`` rendezvous;
    ``timeout_s`` bounds the rendezvous and every collective, so a rank
    that never arrives fails the others instead of hanging them."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; valid: {BACKENDS}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the nccl backend needs a CUDA device, got {dev}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dist.group.WORLD, dev


def rank_rows(tree, rank: int):
    """A rank's rows of a global ``EngineState`` / ``ShardGraph`` /
    ``CrowdedState`` / ``AsyncState`` (torch tensors or numpy arrays):
    every per-shard field cut to ``[rank:rank + 1]``, a ``DelayRing`` in
    the dist layout ``[P, ring_len, Pn, ...]`` to its ``[rank]`` entry, a
    0-d field (the tick) kept as it is, as JAX's ``P("workers")`` and
    ``P()`` specs cut them."""
    if tree is None:
        return None
    if isinstance(tree, ex_mod.DelayRing):
        return ex_mod.DelayRing(*(x[rank] for x in tree))
    if isinstance(tree, tuple):
        return type(tree)(*(rank_rows(x, rank) for x in tree))
    return tree if tree.ndim == 0 else tree[rank:rank + 1]


def gather_rows(tree, group):
    """The inverse of :func:`rank_rows` over ``group`` (every rank calls it
    and every rank gets the global tree): per-shard fields joined along
    dim 0, ring fields stacked, 0-d fields as this rank holds them."""
    if tree is None:
        return None
    if isinstance(tree, ex_mod.DelayRing):
        return ex_mod.DelayRing(*(torch.stack(_all_gather(x, group))
                                  for x in tree))
    if isinstance(tree, tuple):
        return type(tree)(*(gather_rows(x, group) for x in tree))
    return tree if tree.dim() == 0 else torch.cat(_all_gather(tree, group))


def _all_gather(x: torch.Tensor, group) -> list:
    wire = ex_mod.as_wire(x)
    parts = [torch.empty_like(wire)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, wire, group=group)
    return [p if p.dtype == x.dtype else p.view(x.dtype) for p in parts]


# ======================================================================
# A pool of spawned rank processes
# ======================================================================
class RankContext(NamedTuple):
    """What a job function gets on its rank."""
    rank: int
    world_size: int
    group: Any
    device: torch.device


def _rank_main(rank, world_size, backend, init_method, device, timeout_s,
               tasks, results) -> None:
    ok = False
    try:
        # ranks share the host's cores
        torch.set_num_threads(1)
        group, dev = make_worker_group(
            rank, world_size, backend=backend, init_method=init_method,
            device=device, timeout_s=timeout_s)
        ctx = RankContext(rank, world_size, group, dev)
        results.put((rank, "ready", None))
        while True:
            task = tasks.get()
            if task is None:
                break
            fn, args = task
            results.put((rank, "done", fn(ctx, *args)))
        ok = True
    except BaseException:  # reported to the parent, then the rank exits
        results.put((rank, "error", traceback.format_exc()))
        raise
    finally:
        if ok and dist.is_initialized():
            dist.destroy_process_group()


class RankPool:
    """``world_size`` spawned processes, one rank each of one process
    group, that run jobs together: :meth:`run` calls ``fn(ctx, *args)`` on
    every rank (``fn`` a module-level function, as the spawn start method
    pickles it by name) and returns the results by rank.

    A rank that raises or dies, or a job that outlasts ``timeout_s``,
    kills every rank and raises ``RuntimeError`` in the parent with the
    rank's traceback.  Use as a context manager, or call :meth:`close`."""

    def __init__(self, world_size: int, *, backend: str, init_method: str,
                 device: DeviceLike = None, timeout_s: float = 300.0):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; "
                             f"valid: {BACKENDS}")
        ctx = mp.get_context("spawn")
        self.world_size = world_size
        self.timeout_s = timeout_s
        self._tasks = [ctx.Queue() for _ in range(world_size)]
        self._results = ctx.Queue()
        self._procs = [ctx.Process(
            target=_rank_main, name=f"rank{r}", daemon=True,
            args=(r, world_size, backend, init_method,
                  None if device is None else str(device), timeout_s,
                  self._tasks[r], self._results))
            for r in range(world_size)]
        for p in self._procs:
            p.start()
        self._ready = self._closed = False

    def _collect(self, kind: str, timeout_s: float) -> list:
        out: list = [None] * self.world_size
        seen = 0
        deadline = time.monotonic() + timeout_s
        while seen < self.world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                self.close(kill=True)
                raise RuntimeError(f"rank pool: no {kind!r} from every rank "
                                   f"within {timeout_s} s")
            try:
                rank, got, value = self._results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [p.name for p in self._procs if p.exitcode is not None]
                if dead:
                    self.close(kill=True)
                    raise RuntimeError(f"rank pool: {dead} exited") from None
                continue
            if got == "error":
                self.close(kill=True)
                raise RuntimeError(f"rank pool: rank {rank} failed:\n{value}")
            out[rank] = value
            seen += 1
        return out

    def run(self, fn: Callable, *args, timeout_s: Optional[float] = None
            ) -> list:
        """``fn(ctx, *args)`` on every rank; the results, by rank."""
        timeout_s = self.timeout_s if timeout_s is None else timeout_s
        if not self._ready:
            self._collect("ready", timeout_s)
            self._ready = True
        for q in self._tasks:
            q.put((fn, args))
        return self._collect("done", timeout_s)

    def close(self, kill: bool = False) -> None:
        """Stop the ranks (``kill``: at once, else after their jobs) and
        join them."""
        if self._closed:
            return
        self._closed = True
        for q in self._tasks:
            if not kill:
                q.put(None)
        deadline = time.monotonic() + (0 if kill else 30)
        for p in self._procs:
            if kill:
                p.kill()
            while p.is_alive() and time.monotonic() < deadline:
                self._drain()  # a rank may be blocked writing a result
                p.join(timeout=0.1)
            if p.is_alive():
                p.kill()
            p.join()
        self._drain()
        for q in self._tasks + [self._results]:
            # a killed rank never reads its queue: do not wait to flush it
            q.cancel_join_thread()
            q.close()

    def _drain(self) -> None:
        while True:
            try:
                self._results.get_nowait()
            except queue.Empty:
                return

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close(kill=exc[0] is not None)


def to_device(tree, device: DeviceLike):
    """A tree of host arrays (numpy arrays, read-only memory maps included)
    or tensors as tensors on ``device``; cut it with :func:`rank_rows`
    first, and only a rank's rows are read."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        return type(tree)(*(to_device(x, device) for x in tree))
    dev = resolve_device(device)
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    return torch.from_numpy(np.array(tree)).to(dev)
