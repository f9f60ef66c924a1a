"""Asynchronous, manifest-committed checkpoints (paper §3.4, framework-wide).

Counterpart of ``repro.ft.checkpoint`` with the same on-disk format, so a
checkpoint written by either package loads in the other:
``<dir>/step_<N>/arrays.npz`` holds one entry per tree leaf, keyed by its
path, and ``manifest.json`` — written LAST, the commit point — holds the
tree's structure, the user metadata and a dtype map.  A failure mid-write
leaves the previous checkpoint intact.

``CheckpointManager.save(..., blocking=False)`` copies the tree to the
host at once and writes on a background thread (at most one write in
flight); ``restore(device=...)`` puts every leaf on ``device`` as a
tensor.  Trees are dicts, tuples, lists and NamedTuples of tensors or
arrays.  A NamedTuple is rebuilt only if its type is registered here:
the LM cache types (``KVCache``, ``LayerCache``, ``SSMCache``, the
encoder-decoder's ``DecLayerCache``) and the training state
(``TrainState``, ``AdamWState``, ``AdafactorState``), of the JAX
package's registry; any other, an engine state among them, restores as a
dict of its fields, as it does there.  A training checkpoint holds the
reference's trees (``train/trainer.py::to_checkpoint``), so one written
by either package restores in the other.

npz has no bfloat16: such a leaf is stored as its bit-exact ``uint16``
view and the dtype map says ``"bfloat16"``; reading it back gives a
``torch.bfloat16`` tensor on the same bits (numpy itself has no such
dtype).  ``pack_arrays`` / ``unpack_arrays`` are that codec, shared with
the serving plane's ``FixpointStore`` (``serve/store.py``).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.models.attention import KVCache
from repro_torch.models.encdec import DecLayerCache
from repro_torch.models.ssm import SSMCache
from repro_torch.models.transformer import LayerCache
from repro_torch.train.optimizer import AdafactorState, AdamWState
from repro_torch.train.trainer import TrainState

SEP = "/"


def _join(prefix: str, key) -> str:
    return f"{prefix}{SEP}{key}" if prefix else str(key)


def _flatten_with_paths(tree) -> dict[str, Any]:
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(_join(prefix, k), node[k])
        elif isinstance(node, (list, tuple)) and not hasattr(node, "_fields"):
            for i, v in enumerate(node):
                walk(_join(prefix, i), v)
        elif hasattr(node, "_fields"):  # NamedTuple
            for k in node._fields:
                walk(_join(prefix, k), getattr(node, k))
        elif node is None:
            flat[prefix + "::none"] = None
        else:
            flat[prefix] = node

    walk("", tree)
    return flat


def _tree_structure(tree):
    """JSON-serializable structure descriptor (the JAX package's)."""
    if isinstance(tree, dict):
        return {"__kind__": "dict",
                "items": {k: _tree_structure(v) for k, v in tree.items()}}
    if hasattr(tree, "_fields"):
        return {"__kind__": "namedtuple", "name": type(tree).__name__,
                "fields": {k: _tree_structure(getattr(tree, k))
                           for k in tree._fields}}
    if isinstance(tree, (list, tuple)):
        return {"__kind__": "tuple",
                "items": [_tree_structure(v) for v in tree]}
    if tree is None:
        return {"__kind__": "none"}
    return {"__kind__": "leaf"}


# NamedTuple types restore() rebuilds (the JAX package's registry); an
# unregistered one comes back as a dict of its fields.  A ``None`` field
# (MLA's ``KVCache.v``) is kept as such.
NAMED_TUPLES: dict[str, type] = {
    c.__name__: c for c in (KVCache, LayerCache, SSMCache, DecLayerCache,
                            TrainState, AdamWState, AdafactorState)}


def _rebuild(struct, leaves: dict, prefix=""):
    kind = struct["__kind__"]
    if kind == "dict":
        return {k: _rebuild(v, leaves, _join(prefix, k))
                for k, v in struct["items"].items()}
    if kind == "namedtuple":
        cls = NAMED_TUPLES.get(struct["name"])
        vals = {k: _rebuild(v, leaves, _join(prefix, k))
                for k, v in struct["fields"].items()}
        return cls(**vals) if cls else vals
    if kind == "tuple":
        return tuple(_rebuild(v, leaves, _join(prefix, i))
                     for i, v in enumerate(struct["items"]))
    if kind == "none":
        return None
    return leaves[prefix]


def _to_numpy(x) -> np.ndarray:
    """A host array of a leaf; a bfloat16 tensor as its uint16 bits."""
    if torch.is_tensor(x):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    return np.asarray(x)


def pack_arrays(arrays: dict) -> tuple[dict[str, np.ndarray], dict[str, str]]:
    """npz-safe packing of tensors or arrays: bit-exact uint16 views for
    bfloat16 plus a dtype map to invert them (the JAX package's codec)."""
    dtypes = {}
    packed = {}
    for k, v in arrays.items():
        bf16 = torch.is_tensor(v) and v.dtype == torch.bfloat16
        a = _to_numpy(v)
        dtypes[k] = "bfloat16" if bf16 else str(a.dtype)
        if a.dtype.kind == "V" or str(a.dtype) == "bfloat16":
            a = a.view(np.uint16)
            dtypes[k] = "bfloat16"
        packed[k] = a
    return packed, dtypes


def unpack_arrays(npz, dtypes: dict[str, str]) -> dict:
    """Invert :func:`pack_arrays` over an open npz (or any mapping): numpy
    arrays, except that a bfloat16 entry comes back as a ``torch.bfloat16``
    tensor on the stored bits."""
    leaves = {}
    for k in npz.files if hasattr(npz, "files") else npz:
        a = npz[k]
        if dtypes.get(k) == "bfloat16":
            a = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)
                                 ).view(torch.bfloat16)
        leaves[k] = a
    return leaves


def _map_leaves(fn, tree):
    """``fn`` over every array or tensor leaf of a dict / tuple / list /
    NamedTuple tree (None stays None)."""
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_map_leaves(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    if tree is None:
        return None
    return fn(tree)


def _host_copy(x):
    """A leaf as a host array that later writes to ``x`` cannot change
    (a CPU tensor's ``numpy()`` shares its memory); bfloat16 tensors stay
    tensors, for :func:`pack_arrays`."""
    if torch.is_tensor(x):
        x = x.detach().to("cpu", copy=True)
        return x if x.dtype == torch.bfloat16 else x.numpy()
    return np.array(x)


class CheckpointManager:
    """Async, manifest-committed checkpoints with retention (keep the
    newest ``keep``)."""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    def save(self, step: int, tree, metadata: Optional[dict] = None,
             blocking: bool = True) -> None:
        """Snapshot to host now; write to disk (a)synchronously."""
        host = _map_leaves(_host_copy, tree)
        struct = _tree_structure(tree)
        if blocking:
            self._write(step, host, struct, metadata or {})
        else:
            self.wait()  # at most one in-flight write (bounded, like ASYMP)
            self._thread = threading.Thread(
                target=self._write, args=(step, host, struct, metadata or {}),
                daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host_tree, struct, metadata: dict) -> None:
        with self._lock:
            tmp = os.path.join(self.dir, f".tmp_step_{step}_{time.time_ns()}")
            os.makedirs(tmp, exist_ok=True)
            flat = _flatten_with_paths(host_tree)
            arrays = {k: v for k, v in flat.items() if v is not None}
            packed, dtypes = pack_arrays(arrays)
            metadata = dict(metadata)
            metadata["__dtypes__"] = dtypes
            np.savez(os.path.join(tmp, "arrays.npz"), **packed)
            final = os.path.join(self.dir, f"step_{step:010d}")
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            manifest = {"step": step, "structure": struct,
                        "metadata": metadata, "time": time.time()}
            # manifest written last = commit point
            with open(os.path.join(final, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, name, "manifest.json")):
                out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None,
                device: DeviceLike = None) -> tuple[Any, dict]:
        """Returns ``(tree, metadata)`` with every leaf a tensor on
        ``device`` (``None``: the CUDA card)."""
        dev = resolve_device(device)
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        dtypes = manifest["metadata"].get("__dtypes__", {})
        with np.load(os.path.join(d, "arrays.npz")) as z:
            leaves = unpack_arrays(z, dtypes)
        tree = _rebuild(manifest["structure"], leaves)
        tree = _map_leaves(lambda x: (x if torch.is_tensor(x)
                                      else torch.from_numpy(np.array(x))
                                      ).to(dev), tree)
        return tree, manifest["metadata"]
