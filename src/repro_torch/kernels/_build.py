"""Build and load the port's CUDA kernels (plain C interface + ctypes).

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library under ``build/repro_torch/`` at the repository root
(listed in ``.gitignore``), at its first use in a process.  The library's
file name carries a hash of the source and the flags, so an edited source
is rebuilt and a stale library is never loaded.  The engine tick's two
sources are built together at the first use of either, in two ``nvcc``
processes at once.  Nothing here runs at import time: the CPU test suite
imports every module, and has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_c = ctypes
# exported C functions of each source: name -> (argtypes, restype)
SIGNATURES = {
    "semiring_spmv": {
        "spmv_partials_launch": ([_c.c_int, _c.c_int, _c.c_int, _c.c_int,
                                  _c.c_void_p, _c.c_void_p, _c.c_void_p,
                                  _c.c_void_p, _c.c_int, _c.c_void_p],
                                 _c.c_int),
        "cuda_error_string": ([_c.c_int], _c.c_char_p),
    },
    "engine_receive": {
        "engine_receive_launch": ([_c.c_int, _c.c_int, _c.c_int,
                                   _c.c_void_p, _c.c_void_p,
                                   _c.POINTER(_c.c_longlong),
                                   _c.POINTER(_c.c_longlong), _c.c_int,
                                   _c.c_int, _c.c_longlong, _c.c_void_p,
                                   _c.c_void_p, _c.c_void_p, _c.c_void_p,
                                   _c.c_int, _c.c_void_p, _c.c_void_p],
                                  _c.c_int),
        "cuda_error_string": ([_c.c_int], _c.c_char_p),
    },
    "engine_create": {
        "engine_create_workspace_bytes": ([_c.c_int, _c.c_int, _c.c_int,
                                           _c.c_int, _c.c_int],
                                          _c.c_longlong),
        "engine_create_launch": ([_c.c_int, _c.POINTER(_c.c_longlong),
                                  _c.POINTER(_c.c_float),
                                  _c.POINTER(_c.c_void_p), _c.c_longlong,
                                  _c.c_void_p], _c.c_int),
        "cuda_error_string": ([_c.c_int], _c.c_char_p),
    },
}

_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _paths(name: str) -> tuple[Path, Path, Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return (src, BUILD_DIR / f"lib{name}-{digest}.so",
            BUILD_DIR / f"{name}-{digest}.ptxas.txt")


def _start(name: str):
    """nvcc started on ``csrc/<name>.cu``: ``(process, temporary output,
    start time)``, or None when a library of the same source and flags
    exists."""
    src, lib, report = _paths(name)
    if lib.exists() and report.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.Popen([nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, tmp, time.perf_counter()


def _finish(name: str, started) -> dict:
    src, lib, report = _paths(name)
    if started is None:
        return {"path": str(lib), "seconds": 0.0, "cached": True,
                "report": report.read_text()}
    proc, tmp, t0 = started
    stdout, stderr = proc.communicate()
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):\n"
                           f"{stdout}\n{stderr}")
    os.replace(tmp, lib)
    text = stdout + stderr
    report.write_text(text)
    return {"path": str(lib), "seconds": seconds, "cached": False,
            "report": text}


def build(name: str) -> dict:
    """Compile ``csrc/<name>.cu`` unless a library of the same source and
    flags exists.  Returns ``{"path", "seconds", "report", "cached"}``;
    ``report`` is nvcc's ``-Xptxas -v`` output (registers, shared memory,
    spills per kernel)."""
    return _finish(name, _start(name))


def build_together(names) -> dict:
    """:func:`build` of several sources, their nvcc processes run at once:
    ``{name: build's result}``."""
    started = {name: _start(name) for name in names}
    out, failed = {}, None
    for name, run in started.items():  # wait for every process
        try:
            out[name] = _finish(name, run)
        except RuntimeError as e:
            failed = failed or e
    if failed is not None:
        raise failed
    return out


# the sources that the engine tick launches together: the first use of
# either builds both at once, so a job's set-up waits for one nvcc run
_ENGINE = ("engine_create", "engine_receive")
_TOGETHER = {name: _ENGINE for name in _ENGINE}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    if name not in _LOADED:
        todo = [n for n in _TOGETHER.get(name, (name,)) if n not in _LOADED]
        for n, built in build_together(todo).items():
            lib = ctypes.CDLL(built["path"])
            for fn, (argtypes, restype) in SIGNATURES[n].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _LOADED[n] = lib
    return _LOADED[name]


def error_string(lib: ctypes.CDLL, err: int) -> str:
    return lib.cuda_error_string(err).decode()
