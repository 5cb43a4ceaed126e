"""Build and load the Hopper pair-pass kernels (``csrc/pair_pass.cu``).

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ctypes. The library is cached under
``sph_tpu_torch/_build/`` keyed by a hash of the source and the flags, so a
changed source rebuilds. Nothing is built at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

SRC = Path(__file__).resolve().parent / "csrc" / "pair_pass.cu"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC"]
KINDS = ("density", "rho_star", "viscsurf", "paccel", "boundary", "spring",
         "membrane")

_lib = None


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path() -> Path:
    key = hashlib.sha256(SRC.read_bytes() + " ".join(FLAGS).encode())
    return BUILD_DIR / f"libsph_pair_{key.hexdigest()[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile the library if it is not cached; returns (path, compiler
    output — ptxas register/shared-memory report — or "" when cached)."""
    so = library_path()
    if so.exists():
        return so, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run([_nvcc(), *FLAGS, "-o", tmp, str(SRC)],
                             capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}):\n{res.stdout}{res.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so, res.stdout + res.stderr


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        so, _ = build()
        lib = ctypes.CDLL(str(so))
        p, i64, i32, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_float)
        for kind in KINDS:
            fn = getattr(lib, "sph_pair_" + kind)
            fn.argtypes = [p, i64, p, i64, p, p, p, p, p, p, i32, p, i32,
                           i32, i32, f, f, f, f, i32, p]
            fn.restype = i32
        lib.sph_cuda_error_string.argtypes = [i32]
        lib.sph_cuda_error_string.restype = ctypes.c_void_p
        _lib = lib
    return _lib
