"""ctypes bindings to the native (C++) scene builder (counterpart of
``sph_tpu/scene/native.py``).

``csrc/scene_builder.cpp`` holds the heavy emission loops (pool, wall box,
inner worm liquid) and the cell-binned spring-graph search. It is compiled
at first use with ``g++`` and the flags below (``-ffp-contract=off``: no
FMA contraction, so the float32 loops round as the NumPy path's do) into
``sph_tpu_torch/_build/``, under a name keyed by a hash of the source and
the flags; the compile runs in a temporary directory and ends with an
``os.replace``, so processes that build at once each see a whole library.

``available()`` is False only where no ``g++`` is found (and no library is
cached): ``scene.worm`` then takes its NumPy path. A compiler that fails,
or a library that does not load, raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "csrc" / "scene_builder.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
FLAGS = ["-O2", "-std=c++17", "-fPIC", "-ffp-contract=off", "-Wall",
         "-shared"]

_lib = None


def library_path() -> Path:
    key = hashlib.sha256(" ".join(FLAGS).encode() + SRC.read_bytes())
    return BUILD_DIR / f"libsphscene_{key.hexdigest()[:16]}.so"


def build() -> Path | None:
    """The library's path, compiled if it is not cached; None where no
    ``g++`` is found. Raises with the compiler's output if it fails."""
    so = library_path()
    if so.exists():
        return so
    cxx = shutil.which("g++")
    if cxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib = os.path.join(tmp, "lib.so")
        res = subprocess.run([cxx, *FLAGS, "-o", lib, str(SRC)],
                             capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed ({res.returncode}) on {SRC}:\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(lib, so)
    return so


def _load():
    global _lib
    if _lib is None:
        so = build()
        if so is None:
            return None
        lib = ctypes.CDLL(str(so))
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.sph_pool_liquid.restype = ctypes.c_int64
        lib.sph_pool_liquid.argtypes = [ctypes.c_float] * 5 + [
            f32p, ctypes.c_int64]
        lib.sph_boundary_box.restype = ctypes.c_int64
        lib.sph_boundary_box.argtypes = [ctypes.c_float] * 4 + [
            f32p, f32p, ctypes.c_int64]
        lib.sph_inner_worm_liquid.restype = ctypes.c_int64
        lib.sph_inner_worm_liquid.argtypes = [ctypes.c_float] * 4 + [
            f32p, ctypes.c_int64]
        lib.sph_spring_graph.restype = ctypes.c_int64
        lib.sph_spring_graph.argtypes = [
            f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_float, ctypes.c_float, ctypes.c_int32, i32p, f32p,
        ]
        _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _need():
    lib = _load()
    if lib is None:
        raise RuntimeError("the native scene builder needs g++, which was "
                           "not found")
    return lib


def _fp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def pool_liquid(r0, x_max, y_max, z_max, fill):
    lib = _need()
    n = lib.sph_pool_liquid(r0, x_max, y_max, z_max, fill, None, 0)
    out = np.empty((n, 3), np.float32)
    lib.sph_pool_liquid(r0, x_max, y_max, z_max, fill, _fp(out), n)
    return out


def boundary_box(r0, x_max, y_max, z_max):
    lib = _need()
    n = lib.sph_boundary_box(r0, x_max, y_max, z_max, None, None, 0)
    pos = np.empty((n, 3), np.float32)
    nrm = np.empty((n, 3), np.float32)
    lib.sph_boundary_box(r0, x_max, y_max, z_max, _fp(pos), _fp(nrm), n)
    return pos, nrm


def inner_worm_liquid(r0, x_max, y_max, z_max):
    lib = _need()
    n = lib.sph_inner_worm_liquid(r0, x_max, y_max, z_max, None, 0)
    out = np.empty((n, 3), np.float32)
    lib.sph_inner_worm_liquid(r0, x_max, y_max, z_max, _fp(out), n)
    return out


def spring_graph(pos, n_elastic, n_liquid, r0, scale, max_n):
    """Returns (idx [Ne,max_n] i32 -1-padded, rest [Ne,max_n] f32)."""
    lib = _need()
    pos = np.ascontiguousarray(pos, np.float32)
    idx = np.full((n_elastic, max_n), -1, np.int32)
    rest = np.zeros((n_elastic, max_n), np.float32)
    lib.sph_spring_graph(
        _fp(pos), len(pos), n_elastic, n_liquid,
        np.float32(r0), np.float32(scale), max_n,
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), _fp(rest),
    )
    return idx, rest
