"""Build and load the Hopper kernels (``csrc/*.cu``).

Each source is compiled with ``nvcc`` for ``sm_90a`` into an object, all of
them at once (one ``nvcc`` process a source, started together), and the
objects are linked into one shared library with a plain C interface, loaded
with ctypes. The library is cached under ``sph_tpu_torch/_build/`` keyed by
a hash of every source and the flags, so a changed source rebuilds; the
compiler's report (``-Xptxas -v``: registers, spills, shared memory of each
kernel) is kept beside it. The ring driver's configuration
(``pair_kernels.RING``, and the box cull's ``CHUNK``) is compiled in as
``-DSPH_<KIND>_<FIELD>`` (and ``-DSPH_RING_CHUNK``) defines, so the hash
covers it too. Nothing is built at import time.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

from .pair_kernels import CHUNK, RING

CSRC = Path(__file__).resolve().parent / "csrc"
SRCS = (CSRC / "pair_pass.cu", CSRC / "pack.cu")
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
RING_DEFINES = [f"-DSPH_{kind.upper()}_{field.upper()}={int(value)}"
                for kind, ring in RING.items()
                for field, value in dataclasses.asdict(ring).items()]
RING_DEFINES.append(f"-DSPH_RING_CHUNK={CHUNK}")
FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xptxas", "-v", "-Xcompiler", "-fPIC",
         *RING_DEFINES]
# the pair-pass entry points (the spring pass's list kernel has its own)
KINDS = ("density", "rho_star", "viscsurf", "paccel", "boundary", "membrane")
# the first designs of the redesigned kernels and the ring kernels without
# their box cull, for chip_smoke.py's comparisons only
PREV = ("density_prev", "rho_star_prev", "paccel_prev", "viscsurf_prev",
        "spring_prev", "boundary_prev", "membrane_prev")
NOCULL = tuple(k + "_nocull" for k in KINDS)

_lib = None


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path() -> Path:
    key = hashlib.sha256(" ".join(FLAGS).encode())
    for src in SRCS:
        key.update(src.name.encode() + src.read_bytes())
    return BUILD_DIR / f"libsph_kernels_{key.hexdigest()[:16]}.so"


def _run(cmd):
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{res.stdout}{res.stderr}")
    return res.stdout + res.stderr


def build() -> tuple[Path, str]:
    """Compile the library if it is not cached; returns (path, compiler
    output: the ptxas register/shared-memory report, kept beside a cached
    library)."""
    so = library_path()
    log_path = so.with_suffix(".log")
    if so.exists():
        return so, log_path.read_text() if log_path.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in SRCS]
        procs = [subprocess.Popen([nvcc, *FLAGS, "-c", "-o", obj, str(src)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(SRCS, objs)]
        logs, failed = [], []
        for src, proc in zip(SRCS, procs):
            try:
                out, _ = proc.communicate(timeout=600)
            except subprocess.TimeoutExpired:
                for p in procs:
                    p.kill()
                raise
            logs.append(out)
            if proc.returncode != 0:
                failed.append(f"{src.name} ({proc.returncode}):\n{out}")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        lib = os.path.join(tmp, "lib.so")
        logs.append(_run([nvcc, *ARCH, "-shared", "-o", lib, *objs]))
        log = "".join(logs)
        log_path.write_text(log)
        os.replace(lib, so)
    return so, log


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        so, _ = build()
        lib = ctypes.CDLL(str(so))
        p, i64, i32, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_float)
        pair_args = [p, i64, p, i64, p, p, p, p, p, p, i32, p, i32, i32,
                     i32, f, f, f, f, i32, p]
        for kind in KINDS + PREV + NOCULL:
            fn = getattr(lib, "sph_pair_" + kind)
            # the ring kinds' own entry points: the box cull's boxes, cull
            # reach and counters besides
            fn.argtypes = pair_args + ([p, f, p] if kind in KINDS else [])
            fn.restype = i32
        lib.sph_pair_spring.argtypes = [p, i64, p, i64, p, p, p, p, i32, f,
                                        f, f, f, i32, p]
        lib.sph_pair_spring.restype = i32
        lib.sph_pack_rows.argtypes = [p, i32, i64, p, p]
        lib.sph_pack_rows.restype = i32
        lib.sph_cuda_error_string.argtypes = [i32]
        lib.sph_cuda_error_string.restype = ctypes.c_void_p
        _lib = lib
    return _lib


def error_string(err: int) -> str:
    """cudaGetErrorString of a code the library returned."""
    return ctypes.string_at(load().sph_cuda_error_string(err)).decode()
