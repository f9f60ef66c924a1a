"""Build and load the port's CUDA kernels (plain C interface + ctypes).

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library under ``build/repro_torch/`` at the repository root
(listed in ``.gitignore``), at its first use in a process.  The library's
file name carries a hash of the source and the flags, so an edited source
is rebuilt and a stale library is never loaded.  Nothing here runs at
import time: the CPU test suite imports every module, and has no ``nvcc``.
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


def build(name: str) -> dict:
    """Compile ``csrc/<name>.cu`` unless a library of the same source and
    flags exists.  Returns ``{"path", "seconds", "report", "cached"}``;
    ``report`` is nvcc's ``-Xptxas -v`` output (registers, shared memory,
    spills per kernel)."""
    src, lib, report = _paths(name)
    if lib.exists() and report.exists():
        return {"path": str(lib), "seconds": 0.0, "cached": True,
                "report": report.read_text()}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                          capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    text = proc.stdout + proc.stderr
    report.write_text(text)
    return {"path": str(lib), "seconds": seconds, "cached": False,
            "report": text}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(name)["path"])
        for fn, (argtypes, restype) in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _LOADED[name] = lib
    return lib


def error_string(lib: ctypes.CDLL, err: int) -> str:
    return lib.cuda_error_string(err).decode()
