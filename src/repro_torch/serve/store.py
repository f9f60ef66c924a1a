"""Sharded fixpoint store: converged engine output as a query-able,
epoch-versioned artifact (the serving plane's read path).

Counterpart of ``repro.serve.store``, with the same on-disk layout, so a
store written by either package reads in the other.  ``publish`` takes
the engine's tensors (on any device) and copies each plane to the host
once; reads are host numpy.

ASYMP's converged outputs (CC labels, ranks, distances) feed downstream
serving systems — they are read millions of times, not once.  This
module persists a converged ``EngineState``'s ``values`` (and push-mode
``aux`` planes) per vertex shard and serves batched point lookups:

  * layout — ``<dir>/epoch_<E>/<program>/shard_<p>.npz`` + one
    ``manifest.json`` per epoch, written LAST as the commit point (the
    same manifest-commit protocol as ``ft/checkpoint.CheckpointManager``,
    whose ``pack_arrays``/``unpack_arrays`` codec handles npz-hostile
    dtypes);
  * sharding — the vertex-to-file mapping is ``dist.sharding
    .vertex_partition``, the SAME rule the engine computes with, so the
    store and the engine can never disagree on ownership;
  * epochs — every publish is a new epoch; streaming deltas re-publish
    and old epochs are retained (``keep``) then garbage-collected, so a
    reader holding an epoch open never sees a torn update;
  * reader pinning — ``FixpointView`` loads shard files LAZILY, so a
    long-lived view is a promise to read files that keep-N GC would
    otherwise be free to delete.  Views
    therefore pin their epoch on open; ``_gc`` skips pinned epochs, and
    ``close()`` releases the pin and sweeps.  Pin state is refcounted
    and lock-guarded, so concurrent readers and a publisher thread
    compose (the double-buffered serving path in ``serve/graph.py``
    holds epoch N open for queries while epoch N+1 is being ticked).

``FixpointView`` is the read handle: per-(program, shard) files load
lazily and cache, so a point query touches exactly the shards its
vertices live in.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.dist.sharding import VertexPartition, vertex_partition
from repro_torch.ft.checkpoint import pack_arrays, unpack_arrays


def _host(x) -> np.ndarray:
    """One device-to-host copy of a plane (numpy arrays pass through)."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class FixpointStore:
    """Epoch-versioned, manifest-committed fixpoint snapshots."""

    def __init__(self, directory: str, keep: int = 2):
        self.dir = directory
        self.keep = keep
        self._lock = threading.RLock()
        self._pins: dict[int, int] = {}  # epoch -> reader refcount
        os.makedirs(directory, exist_ok=True)

    # -- reader pinning ------------------------------------------------
    def pin(self, epoch: int) -> bool:
        """Take a GC pin on ``epoch``.  Returns False (no pin taken) if
        the epoch is no longer committed on disk — the caller should
        retry against a newer epoch."""
        with self._lock:
            if not os.path.exists(os.path.join(
                    self.dir, f"epoch_{epoch:010d}", "manifest.json")):
                return False
            self._pins[epoch] = self._pins.get(epoch, 0) + 1
            return True

    def unpin(self, epoch: int) -> None:
        """Release one pin; the last release sweeps GC so an epoch held
        open past its retention window is collected promptly."""
        with self._lock:
            left = self._pins.get(epoch, 0) - 1
            if left > 0:
                self._pins[epoch] = left
                return
            self._pins.pop(epoch, None)
            self._gc()

    def pinned(self) -> set[int]:
        with self._lock:
            return {e for e, n in self._pins.items() if n > 0}

    # ------------------------------------------------------------------
    def publish(self, fixpoints: dict[str, dict], part: VertexPartition,
                meta: Optional[dict] = None) -> int:
        """Write one epoch.  ``fixpoints``: program name -> {"values":
        [P, vs] tensor or array, "aux": [P, C, vs] tensor, array or None}.
        Returns the epoch id (monotonic).  Crash-safe: a failure before
        the manifest lands leaves only an ignored temp directory."""
        epoch = (self.latest_epoch() or 0) + 1
        tmp = os.path.join(self.dir, f".tmp_epoch_{epoch}_{time.time_ns()}")
        os.makedirs(tmp, exist_ok=True)
        programs: dict[str, dict] = {}
        for name, planes in fixpoints.items():
            pdir = os.path.join(tmp, name)
            os.makedirs(pdir, exist_ok=True)
            values = _host(planes["values"])
            aux = planes.get("aux")
            aux = _host(aux) if aux is not None else None
            assert values.shape[:1] == (part.num_shards,), (
                name, values.shape, part)
            dtypes_all: dict[str, str] = {}
            for p in range(part.num_shards):
                arrays = {"values": values[p]}
                if aux is not None:
                    arrays["aux"] = aux[p]
                packed, dtypes = pack_arrays(arrays)
                dtypes_all.update(dtypes)
                np.savez(os.path.join(pdir, f"shard_{p:05d}.npz"), **packed)
            programs[name] = {"dtypes": dtypes_all,
                              "aux_channels": (0 if aux is None
                                               else int(aux.shape[1]))}
        final = os.path.join(self.dir, f"epoch_{epoch:010d}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        manifest = {"epoch": epoch, "num_shards": part.num_shards,
                    "vs": part.vs, "num_vertices": part.num_vertices,
                    "programs": programs, "meta": meta or {},
                    "time": time.time()}
        # manifest written last = commit point
        with open(os.path.join(final, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        self._gc()
        return epoch

    def _gc(self) -> None:
        """Keep-N retention, EXCEPT epochs a live reader has pinned: a
        lazily-loading view must be able to finish its read no matter
        how many publishes land while it is open.  The skipped epoch is
        collected by the pin-release sweep in :meth:`unpin`."""
        with self._lock:
            pinned = self.pinned()
            for e in self.epochs()[: -self.keep]:
                if e in pinned:
                    continue
                shutil.rmtree(os.path.join(self.dir, f"epoch_{e:010d}"),
                              ignore_errors=True)

    # ------------------------------------------------------------------
    def epochs(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("epoch_") and os.path.exists(
                    os.path.join(self.dir, name, "manifest.json")):
                out.append(int(name[6:]))
        return sorted(out)

    def latest_epoch(self) -> Optional[int]:
        es = self.epochs()
        return es[-1] if es else None

    def view(self, epoch: Optional[int] = None) -> "FixpointView":
        """Open a pinned read handle on ``epoch`` (default: latest).
        The view holds a GC pin until :meth:`FixpointView.close` — a
        reader's lazy shard loads can never race epoch retention."""
        with self._lock:
            epoch = epoch if epoch is not None else self.latest_epoch()
            if epoch is None:
                raise FileNotFoundError(f"no committed epoch in {self.dir}")
            if not self.pin(epoch):
                raise FileNotFoundError(
                    f"epoch {epoch} is no longer committed in {self.dir}")
        d = os.path.join(self.dir, f"epoch_{epoch:010d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        return FixpointView(d, manifest, store=self)


class FixpointView:
    """Lazy read handle on one committed epoch: per-(program, shard)
    files load on first touch and cache, so batched point queries do
    shard-local gathers only where their vertices actually live.

    Opened through :meth:`FixpointStore.view` the handle owns one GC
    pin on its epoch; release it with :meth:`close` (idempotent, also a
    context manager) once the reader is done."""

    def __init__(self, directory: str, manifest: dict,
                 store: Optional[FixpointStore] = None):
        self.dir = directory
        self.manifest = manifest
        self.epoch = int(manifest["epoch"])
        self.part = vertex_partition(int(manifest["num_vertices"]),
                                     int(manifest["num_shards"]))
        self._cache: dict[tuple[str, int], dict[str, np.ndarray]] = {}
        self._store = store

    def close(self) -> None:
        """Release this view's GC pin (idempotent)."""
        store, self._store = self._store, None
        if store is not None:
            store.unpin(self.epoch)

    def __enter__(self) -> "FixpointView":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def programs(self) -> list[str]:
        return sorted(self.manifest["programs"])

    def _shard(self, name: str, p: int) -> dict[str, np.ndarray]:
        key = (name, p)
        if key not in self._cache:
            if name not in self.manifest["programs"]:
                raise KeyError(f"program {name!r} not in epoch {self.epoch}; "
                               f"have {self.programs}")
            dtypes = self.manifest["programs"][name]["dtypes"]
            path = os.path.join(self.dir, name, f"shard_{p:05d}.npz")
            with np.load(path) as z:
                self._cache[key] = unpack_arrays(z, dtypes)
        return self._cache[key]

    def lookup(self, name: str, vertex_ids, channel: Optional[int] = None
               ) -> np.ndarray:
        """Batched point query: values (or ``aux[channel]``) for global
        vertex ids, resolved through the engine's own shard rule."""
        ids = np.atleast_1d(np.asarray(vertex_ids, np.int64))
        shards, local = self.part.locate(ids)
        out = None
        for p in np.unique(shards):
            planes = self._shard(name, int(p))
            plane = (planes["values"] if channel is None
                     else planes["aux"][channel])
            if out is None:
                out = np.empty(ids.shape, plane.dtype)
            m = shards == p
            out[m] = plane[local[m]]
        if out is None:
            out = np.empty(0, np.float32)
        return out
