"""Procedural scene generators (counterpart of ``sph_tpu/scene/worm.py``).

Only the pure-liquid box is ported so far: the pool and the boundary box,
as the NumPy loops of the original with its float32 rounding kept, so the
generated scene is bitwise equal to ``sph_tpu``'s. The worm generators are
ROADMAP Queue 1 (worm slice).
"""
from __future__ import annotations

import math

import numpy as np

from ..config import SimParams
from .scene import Scene

f32 = np.float32


def _pool_liquid(params: SimParams, fill: float = 0.15):
    """Rectangular swimming pool below y = YMAX*fill (owHelper.cpp:673-691)."""
    r0 = f32(params.r0)
    pts = []
    x = f32(3.0 * float(r0))
    while x < params.x_max - 3.0 * float(r0):
        y = f32(3.0 * float(r0))
        while y < params.y_max * fill:
            z = f32(3.0 * float(r0))
            while z < params.z_max - 3.0 * float(r0):
                pts.append((x, y, z))
                z = f32(z + r0)
            y = f32(y + r0)
        x = f32(x + r0)
    return np.asarray(pts, np.float32).reshape(-1, 3)


def _boundary_box(params: SimParams):
    """Single-layer box walls at r0 spacing; normals averaged at edges and
    corners. The reference's non-unit normals on the x-extreme columns of the
    y-walls (magnitude 1/sqrt(2), owHelper.cpp:864-876) are kept verbatim."""
    r0 = float(f32(params.r0))
    nx = int(float(params.x_max - params.x_min) / r0)
    ny = int(float(params.y_max - params.y_min) / r0)
    nz = int(float(params.z_max - params.z_min) / r0)
    s2, s3 = 1.0 / math.sqrt(2.0), 1.0 / math.sqrt(3.0)

    pos, nrm = [], []

    def emit(px, py, pz, n):
        pos.append((px * r0 + r0 / 2, py * r0 + r0 / 2, pz * r0 + r0 / 2))
        nrm.append(n)

    # z = near/far faces (incl. box edges and corners)
    for ix in range(nx):
        for iy in range(ny):
            x_ext, y_ext = ix in (0, nx - 1), iy in (0, ny - 1)
            sx = (ix == 0) - (ix == nx - 1)
            sy = (iy == 0) - (iy == ny - 1)
            if x_ext and y_ext:
                emit(ix, iy, 0, (sx * s3, sy * s3, s3))
                emit(ix, iy, nz - 1, (sx * s3, sy * s3, -s3))
            elif x_ext or y_ext:
                emit(ix, iy, 0, (sx * s2, sy * s2, s2))
                emit(ix, iy, nz - 1, (sx * s2, sy * s2, -s2))
            else:
                emit(ix, iy, 0, (0.0, 0.0, 1.0))
                emit(ix, iy, nz - 1, (0.0, 0.0, -1.0))

    # y = bottom/top faces
    for ix in range(nx):
        for iz in range(1, nz - 1):
            if ix in (0, nx - 1):
                emit(ix, 0, iz, (0.0, s2, 0.0))
                emit(ix, ny - 1, iz, (0.0, -s2, 0.0))
            else:
                emit(ix, 0, iz, (0.0, 1.0, 0.0))
                emit(ix, ny - 1, iz, (0.0, -1.0, 0.0))

    # x = left/right faces
    for iy in range(1, ny - 1):
        for iz in range(1, nz - 1):
            emit(0, iy, iz, (1.0, 0.0, 0.0))
            emit(nx - 1, iy, iz, (-1.0, 0.0, 0.0))

    return (np.asarray(pos, np.float32).reshape(-1, 3),
            np.asarray(nrm, np.float32).reshape(-1, 3))


def generate_liquid_box_scene(
    params: SimParams = None,
    fill_fraction: float = 0.15,
) -> Scene:
    """Pure-liquid box: boundary walls + pool filling the bottom
    ``fill_fraction`` of the box (no elastic matter)."""
    if params is None:
        params = SimParams()

    lpos = _pool_liquid(params, fill=fill_fraction)

    bpos, bnorm = _boundary_box(params)
    n_l, n_b = len(lpos), len(bpos)
    n = n_l + n_b

    pos = np.concatenate([lpos, bpos])
    color = np.concatenate([
        np.full(n_l, 1.1, np.float32), np.full(n_b, 3.0, np.float32)
    ])
    normal = np.zeros((n, 3), np.float32)
    normal[n_l:] = bnorm

    return Scene(
        pos=pos, vel=np.zeros((n, 3), np.float32),
        color=color, normal=normal,
    )
