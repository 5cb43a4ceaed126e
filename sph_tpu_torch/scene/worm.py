"""Procedural scene generators (counterpart of ``sph_tpu/scene/worm.py``):
the C. elegans worm in its pool, n worms side by side in one widened pool,
and the pure-liquid box.

Two paths, as in ``sph_tpu``. Where ``native.available()`` (a ``g++`` is
found: the default, as in ``sph_tpu``), the inner worm liquid, the pool,
the wall box and the spring-graph search come from the native builder
(``scene/native.py``); the worm shell, the membranes and the muscle windows
stay NumPy. Otherwise all of it is NumPy: the loops of the original with
its float32 rounding kept where it decides particle counts (slice radii,
angle stepping, grid-extent divisions). Each path's scenes are bitwise
equal to those of ``sph_tpu``'s same path. The two paths differ: the native
builder takes the box extents as float32 and makes 101,332 walls on the
full box where the NumPy path makes 102,408 (the full worm: 231,811
particles against 232,887), and its inner liquid differs from the NumPy
one in the last place of some coordinates (libm's sin and cos).

The muscle-window cascade of the reference is the data tables
``_DORSAL_WINDOWS`` / ``_VENTRAL_WINDOWS`` (one row per y-band x z-window)
consumed by one vectorized matcher: later windows override earlier ones,
unmatched gated springs keep the 1.1 code (-> muscle id 1), as upstream.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
from scipy.spatial import cKDTree

from ..config import SimParams
from ..constants import MAX_NEIGHBORS
from . import native
from .scene import Scene

f32 = np.float32


# ---------------------------------------------------------------------------
# Worm shell (elastic particles + membrane mesh)  [owHelper.cpp:104-545]
# ---------------------------------------------------------------------------

def _slice_pair(q: int, start: int, count: int) -> tuple[int, int]:
    """Edge (ii, jj) walked along one cross-slice ring
    (owHelper.cpp:417-431): the first two particles sit at ring angle 0/pi,
    greens come in quads, so ring-adjacency is index arithmetic."""
    if count == 4:  # head/tail tip
        return [(0, 2), (0, 3), (1, 2), (1, 3)][q][0] + start, \
               [(0, 2), (0, 3), (1, 2), (1, 3)][q][1] + start
    if q == 0:
        return start, start + 2
    if q == 1:
        return start, start + 3
    if q == 2:
        return start + 1, start + 4
    if q == 3:
        return start + 1, start + 5
    return start + q - 2, start + q + 2 * (q + 2 < count)


def _stitch(pts, prev_start, prev_count, cur_start, cur_count, r0):
    """Triangles joining two adjacent slices by nearest-midpoint matching,
    both directions (owHelper.cpp:416-514). Pass 1 uses ``<=`` (last minimum
    wins), pass 2 uses ``<`` (first wins) — kept verbatim, it changes tie
    resolution."""
    tris = []
    p = np.asarray(pts, dtype=np.float32)

    for q in range(prev_count):
        ii, jj = _slice_pair(q, prev_start, prev_count)
        mid = (p[ii] + p[jj]) * f32(0.5)
        d = np.sqrt(((p[cur_start:cur_start + cur_count] - mid) ** 2)
                    .sum(axis=1))
        best, kk = f32(10.0 * r0), -1
        for w in range(cur_count):
            if d[w] <= best:
                best, kk = d[w], cur_start + w
        if kk >= 0:  # no slice point within 10*r0: drop, never emit -1
            tris.append((ii, jj, kk))

    for q in range(cur_count):
        ii, jj = _slice_pair(q, cur_start, cur_count)
        mid = (p[ii] + p[jj]) * f32(0.5)
        d = np.sqrt(((p[prev_start:prev_start + prev_count] - mid) ** 2)
                    .sum(axis=1))
        best, kk = f32(10.0 * r0), -1
        for w in range(prev_count):
            if d[w] < best:
                best, kk = d[w], prev_start + w
        if kk >= 0:
            tris.append((ii, jj, kk))
    return tris


def _worm_shell(params: SimParams):
    """Elastic shell: 199 cross-slices, radius profile
    6*r0*sqrt(1 - 1e-4 j^2), muscle-capable 'green' (2.2) arcs within 0.89 rad
    of the horizontal axis, 'yellow' (2.1) elsewhere, membranes over the outer
    layer only. Returns (positions [P,3], colors [P], tris list)."""
    r0 = f32(params.r0)
    xc = f32(params.x_max * 0.5)
    yc = f32(params.y_max * 0.3)
    zc = f32(params.z_max * 0.5)
    pi_f = f32(3.1415926536)

    pts: list[tuple] = []
    colors: list[float] = []
    tris: list[tuple] = []

    def emit(x, y, z, c):
        pts.append((f32(x), f32(y), f32(z)))
        colors.append(c)

    jmin, jmax = -100, 98
    prev_start = prev_count = 0

    for j in range(jmin, jmax + 1):
        cur_start = len(pts)
        radius = f32(f32(6.0) * r0
                     * f32(math.sqrt(max(1.0 - f32(1.0e-4) * j * j, 0.0))))
        tip = False
        if float(r0) * 0.707 < radius < float(r0) * 1.0:
            radius = f32(1.0) * r0
        if radius < 0.707 * float(r0):
            tip = True
            radius = f32(0.707) * r0

        zj = f32(zc + r0 * j)
        emit(xc + radius, yc, zj, 2.1)
        emit(xc - radius, yc, zj, 2.1)
        if tip:
            emit(xc, yc + radius, zj, 2.1)
            emit(xc, yc - radius, zj, 2.1)

        layer = 1
        while layer <= 2:
            if layer == 2 and j == jmin:
                emit(xc, yc, zc + r0 * (j - 1), 2.1)
            if radius > 0 and layer >= 2:
                if radius > float(r0) * 1.0:
                    emit(xc + radius, yc, zj, 2.1)
                    emit(xc - radius, yc, zj, 2.1)
                elif radius < float(r0) * (1.0 - 0.707):
                    emit(xc, yc, zj, 2.1)

            if radius < float(r0) * 0.707:
                break

            alpha = f32(2.0 * math.asin(0.5 * r0 / radius))
            angle = alpha
            while angle < 0.89:
                ca, sa = radius * math.cos(angle), radius * math.sin(angle)
                emit(xc + ca, yc + sa, zj, 2.2)
                emit(xc + ca, yc - sa, zj, 2.2)
                emit(xc - ca, yc + sa, zj, 2.2)
                emit(xc - ca, yc - sa, zj, 2.2)
                angle = f32(angle + alpha)

            angle = f32(angle - alpha)
            nma = f32(pi_f - f32(2.0) * angle)
            n_nm = int(math.floor(nma / alpha)) - 1
            if n_nm > 0:
                beta = f32(nma / (n_nm + 1))
                nmp = 0
                for _ in range((n_nm + 1) // 2):
                    angle = f32(angle + beta)
                    ca = radius * math.cos(angle)
                    sa = radius * math.sin(angle)
                    emit(xc + ca, yc + sa, zj, 2.1)
                    emit(xc + ca, yc - sa, zj, 2.1)
                    nmp += 2
                    if nmp // 2 == n_nm:
                        break
                    emit(xc - ca, yc + sa, zj, 2.1)
                    emit(xc - ca, yc - sa, zj, 2.1)
                    nmp += 2

            if layer == 1:
                cur_count = len(pts) - cur_start
                if j == jmin and cur_count == 4:
                    tris += [(0, 1, 2), (0, 1, 3)]
                if j == jmax and cur_count == 6:
                    s = cur_start
                    tris += [(s, s + 2, s + 6), (s, s + 3, s + 6),
                             (s + 2, s + 4, s + 6), (s + 3, s + 5, s + 6),
                             (s + 1, s + 4, s + 6), (s + 1, s + 5, s + 6)]
                if j > jmin:
                    tris += _stitch(pts, prev_start, prev_count,
                                    cur_start, cur_count, float(r0))
                prev_start, prev_count = cur_start, cur_count

            radius = f32(radius - r0)
            layer += 1

    return (np.asarray(pts, np.float32),
            np.asarray(colors, np.float32),
            tris)


# ---------------------------------------------------------------------------
# Liquid: worm interior rings + swimming pool  [owHelper.cpp:547-706]
# ---------------------------------------------------------------------------

def _inner_worm_liquid(params: SimParams):
    r0 = f32(params.r0)
    if native.available():
        return native.inner_worm_liquid(
            r0, params.x_max, params.y_max, params.z_max
        )
    xc = f32(params.x_max * 0.5)
    yc = f32(params.y_max * 0.3)
    zc = f32(params.z_max * 0.5)
    pi_f = f32(3.1415926536)
    pts = []

    j = f32(-100.0)
    while j <= f32(100.0):
        radius = f32(f32(6.0) * r0
                     * f32(math.sqrt(max(1.0 - f32(1.0e-4) * j * j, 0.0)))
                     - float(r0) * (1.0 + 0.85))
        zj = f32(zc + r0 * j)
        while True:
            if radius > 0.707 * float(r0):
                pts.append((f32(xc), f32(yc + radius), zj))
                pts.append((f32(xc), f32(yc - radius), zj))
            else:
                break
            alpha = f32(2.0 * math.asin(0.5 * r0 / radius))
            angle = f32(0.0)
            nma = f32(pi_f - f32(2.0) * angle)
            n_nm = int(math.floor(nma / (alpha * f32(0.85)))) - 1
            beta = f32(nma / (n_nm + 1))
            for _ in range(n_nm):
                angle = f32(angle + beta)
                sa = radius * math.sin(angle)
                ca = radius * math.cos(angle)
                pts.append((f32(xc + sa), f32(yc + ca), zj))
                pts.append((f32(xc - sa), f32(yc + ca), zj))
            radius = f32(radius - float(r0) * 0.85)
        j = f32(j + f32(0.85))

    return np.asarray(pts, np.float32).reshape(-1, 3)


def _pool_liquid(params: SimParams, fill: float = 0.15):
    """Rectangular swimming pool below y = YMAX*fill (owHelper.cpp:673-691)."""
    r0 = f32(params.r0)
    if native.available():
        return native.pool_liquid(
            r0, params.x_max, params.y_max, params.z_max, fill
        )
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
    if native.available():
        return native.boundary_box(
            f32(params.r0), params.x_max, params.y_max, params.z_max
        )
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


# ---------------------------------------------------------------------------
# Muscle atlas  [owHelper.cpp:1004-1384]
# ---------------------------------------------------------------------------
# One row per window: (muscle_no 1..24, y_band_lo, y_band_hi, z_lo, z_hi).
# y condition (on particle i only): dq*y in (dq*WYC - hi*r0, dq*WYC - lo*r0);
# z condition (on BOTH endpoints):  z  in (WZC + z_lo*r0, WZC + z_hi*r0).
# Quadrant bases: dorsal (x > WXC): dq=+1 -> 0 (MDR), dq=-1 -> 72 (MDL);
# ventral: dq=+1 -> 24 (MVR), dq=-1 -> 48 (MVL). Later rows override earlier.

_DORSAL_WINDOWS = [
    (1, 0, 1, 85.9, 97.0), (2, 1, 2, 83.5, 95.0), (3, 0, 1, 77.5, 86.5),
    (4, 1, 2, 76.5, 84.5), (4, 2, 3, 72.5, 82.5),
    (5, 0, 1, 66.9, 78.5), (5, 1, 2, 65.9, 77.5),
    (6, 2, 3, 55.0, 74.0), (6, 3, 4, 54.5, 74.0),
    (7, 0, 1, 51.0, 68.5), (7, 1, 2, 49.5, 66.5),
    (8, 2, 3, 40.0, 56.5), (8, 3, 4, 38.5, 55.5),
    (9, 0, 1, 33.5, 52.1), (9, 1, 2, 32.5, 50.5),
    (10, 2, 3, 22.5, 41.1), (10, 3, 4, 21.5, 40.0), (10, 4, 5, 20.5, 40.0),
    (11, 0, 1, 15.5, 34.5), (11, 1, 2, 14.5, 33.5),
    (12, 2, 3, 8.5, 23.5), (12, 3, 4, 7.5, 22.5), (12, 4, 5, 6.5, 21.5),
    (13, 0, 1, 1.5, 16.5), (13, 1, 2, 0.5, 15.5),
    (14, 2, 3, -2.5, 9.0), (14, 3, 4, -3.5, 8.5), (14, 4, 5, -4.5, 7.5),
    (15, 0, 1, -14.5, 2.0), (15, 1, 2, -15.5, 1.5),
    (16, 2, 3, -21.5, -1.5), (16, 3, 4, -22.5, -2.5), (16, 4, 5, -23.5, -3.5),
    (17, 0, 1, -34.5, -14.0), (17, 1, 2, -35.5, -14.7),
    (18, 2, 3, -40.5, -20.0), (18, 3, 4, -41.5, -21.5), (18, 4, 5, -34.5, -22.5),
    (19, 0, 1, -54.5, -34.0), (19, 1, 2, -55.5, -34.5),
    (20, 2, 3, -50.5, -39.5), (20, 3, 4, -51.5, -40.5),
    (21, 0, 1, -71.5, -53.0), (21, 1, 2, -72.5, -54.0),
    (22, 2, 3, -63.5, -50.0), (22, 3, 4, -64.5, -50.5),
    (23, 0, 1, -92.0, -70.0),
    (24, 1, 2, -92.0, -71.5), (24, 2, 3, -82.5, -62.5), (24, 3, 4, -66.5, -63.5),
]

_VENTRAL_WINDOWS = [
    (1, 0, 1, 85.9, 97.0), (2, 1, 2, 83.5, 95.0), (3, 0, 1, 77.5, 86.5),
    (4, 1, 2, 76.5, 84.5), (4, 2, 3, 72.5, 82.5),
    (5, 0, 1, 66.9, 78.0), (5, 1, 2, 65.9, 77.5),
    (6, 2, 3, 55.0, 74.0), (6, 3, 4, 54.5, 74.0),
    (7, 0, 1, 51.0, 68.5), (7, 1, 2, 49.5, 66.5),
    (8, 2, 3, 40.0, 56.5), (8, 3, 4, 38.5, 55.5),
    (9, 0, 1, 33.5, 51.5), (9, 1, 2, 33.0, 50.0),
    (10, 2, 3, 22.5, 40.5), (10, 3, 4, 21.5, 40.0), (10, 4, 5, 20.5, 40.0),
    (11, 0, 1, 15.5, 34.5), (11, 1, 2, 14.5, 33.5),
    (12, 2, 3, 8.5, 23.5), (12, 3, 4, 7.5, 22.5), (12, 4, 5, 6.5, 21.5),
    (13, 0, 1, 1.5, 16.0), (13, 1, 2, 0.5, 15.5),
    (14, 2, 3, -2.5, 9.0), (14, 3, 4, -3.5, 8.5), (14, 4, 5, -4.5, 7.5),
    (15, 0, 1, -14.5, 2.0), (15, 1, 2, -15.5, 1.0),
    (16, 2, 3, -21.5, -1.5), (16, 3, 4, -22.5, -2.5), (16, 4, 5, -23.5, -3.5),
    (17, 0, 1, -34.5, -14.0), (17, 1, 2, -35.5, -15.0),
    (18, 2, 3, -40.5, -20.0), (18, 3, 4, -41.5, -21.5), (18, 4, 5, -34.5, -22.5),
    (19, 0, 1, -54.5, -34.0), (19, 1, 2, -55.5, -34.5),
    (20, 2, 3, -50.5, -39.5), (20, 3, 4, -51.5, -40.5),
    (21, 0, 1, -71.5, -53.0), (21, 1, 2, -72.5, -54.0),
    (22, 2, 3, -63.5, -50.0), (22, 3, 4, -64.5, -51.0),
    (23, 0, 1, -91.5, -70.0),
    (24, 1, 2, -91.5, -71.5), (24, 2, 3, -82.5, -62.5), (24, 3, 4, -66.0, -63.5),
]

# render-color fraction per muscle number (cycle red/magenta/orange/violet)
_MUSCLE_FRACTION = (0.2, 0.4, 0.3, 0.5)


def _assign_muscles(pi, pj, color_i, color_j, params: SimParams):
    """Vectorized muscle-id assignment for candidate springs.

    pi/pj: [S,3] endpoint positions; returns [S] float spring-type codes
    (0 = plain spring; else quadrant_base + muscle_no + color fraction;
    1.1 for gated-but-unmatched springs, as upstream)."""
    r0 = float(f32(params.r0))
    wxc = params.x_max * 0.5
    wyc = params.y_max * 0.3
    wzc = params.z_max * 0.5

    dx2 = (pi[:, 0] - pj[:, 0]) ** 2
    dy2 = (pi[:, 1] - pj[:, 1]) ** 2
    dz2 = (pi[:, 2] - pj[:, 2]) ** 2
    zi, zj = pi[:, 2], pj[:, 2]
    yi = pi[:, 1]

    gate = (
        (zi < wzc + r0 * 95) & (zj < wzc + r0 * 95)
        & (zi > wzc - r0 * 92) & (zj > wzc - r0 * 92)
        & (np.abs(color_i - 2.2) <= 0.05) & (np.abs(color_j - 2.2) <= 0.05)
        & (dz2 > 4 * dx2) & (dz2 > 4 * dy2) & (dx2 > 4 * dy2)
    )
    out = np.zeros(len(pi), np.float32)
    # gated-but-unmatched default (owHelper.cpp:1011,1198): type 1.1
    out[gate] = f32(1.1)

    dorsal = pi[:, 0] > wxc
    for windows, is_dorsal in ((_DORSAL_WINDOWS, True),
                               (_VENTRAL_WINDOWS, False)):
        side = gate & (dorsal if is_dorsal else ~dorsal)
        for dq, base in (((1, 0) if is_dorsal else (1, 24)),
                         ((-1, 72) if is_dorsal else (-1, 48))):
            for m, blo, bhi, zlo, zhi in windows:
                sel = (
                    side
                    & (yi * dq < wyc * dq - blo * r0)
                    & (yi * dq > wyc * dq - bhi * r0)
                    & (zi < wzc + r0 * zhi) & (zj < wzc + r0 * zhi)
                    & (zi > wzc + r0 * zlo) & (zj > wzc + r0 * zlo)
                )
                out[sel] = f32(base + m + _MUSCLE_FRACTION[(m - 1) % 4])
    return out


# ---------------------------------------------------------------------------
# Spring graph  [owHelper.cpp:973-1391]
# ---------------------------------------------------------------------------

def _spring_graph(pos, colors, n_elastic, n_liquid, params: SimParams):
    """Connect each elastic particle to elastic/boundary particles within
    r0*sqrt(2.7); rest length = r_ij * scale * 0.95; assign muscle windows."""
    n = len(pos)
    r0 = float(f32(params.r0))
    scale = f32(params.simulation_scale)
    cutoff = r0 * math.sqrt(2.7)

    # candidates: elastic block + boundary block (liquid skipped, :986);
    # block order == ascending absolute id, so sorted KDTree hits reproduce
    # the reference's scan order exactly.
    cand = np.concatenate([
        np.arange(n_elastic), np.arange(n_elastic + n_liquid, n)
    ]).astype(np.int64)
    cpos = pos[cand]

    idx = np.full((n_elastic, MAX_NEIGHBORS), -1, np.int32)
    rest = np.zeros((n_elastic, MAX_NEIGHBORS), np.float32)
    stype = np.zeros((n_elastic, MAX_NEIGHBORS), np.float32)

    if native.available():
        idx, rest = native.spring_graph(
            pos, n_elastic, n_liquid, r0, float(scale), MAX_NEIGHBORS,
        )
        r_idx, s_idx = np.nonzero(idx >= 0)
        if len(r_idx):
            codes = _assign_muscles(
                pos[r_idx], pos[idx[r_idx, s_idx]],
                colors[r_idx], colors[idx[r_idx, s_idx]], params,
            )
            stype[r_idx, s_idx] = codes
        return idx, rest, stype

    tree = cKDTree(cpos.astype(np.float64))
    hits = tree.query_ball_point(
        pos[:n_elastic].astype(np.float64), cutoff * 1.0001
    )

    all_i, all_slot, all_j = [], [], []
    for i in range(n_elastic):
        rows = np.sort(np.asarray(hits[i], dtype=np.int64))
        js_all = cand[rows]
        d = cpos[rows] - pos[i]
        # refine with the reference's f32 comparison (owHelper.cpp:993-996)
        r = np.sqrt(f32((d * d).sum(axis=1)))
        sel = (r <= cutoff) & (js_all != i)
        js = js_all[sel]
        rs = r[sel]
        k = min(len(js), MAX_NEIGHBORS)
        idx[i, :k] = js[:k]
        rest[i, :k] = f32(rs[:k] * scale * f32(0.95))
        all_i.extend([i] * k)
        all_slot.extend(range(k))
        all_j.extend(js[:k].tolist())

    if all_i:
        ai = np.asarray(all_i)
        aslot = np.asarray(all_slot)
        aj = np.asarray(all_j)
        codes = _assign_muscles(
            pos[ai], pos[aj], colors[ai], colors[aj], params
        )
        stype[ai, aslot] = codes

    return idx, rest, stype


# ---------------------------------------------------------------------------
# Public generators
# ---------------------------------------------------------------------------

def generate_worm_scene(params: SimParams = None) -> Scene:
    """The full worm-in-pool scene: elastic shell + membranes, inner liquid,
    swimming pool, boundary box, spring graph with 96-muscle atlas
    (owHelper.cpp:709-1429). Memory order: elastic, liquid, boundary."""
    if params is None:
        params = SimParams()

    shell_pos, shell_color, tris = _worm_shell(params)
    inner = _inner_worm_liquid(params)
    pool = _pool_liquid(params)
    bpos, bnorm = _boundary_box(params)

    n_e = len(shell_pos)
    n_l = len(inner) + len(pool)
    n_b = len(bpos)
    n = n_e + n_l + n_b

    pos = np.concatenate([shell_pos, inner, pool, bpos])
    color = np.concatenate([
        shell_color,
        np.full(n_l, 1.1, np.float32),
        np.full(n_b, 3.0, np.float32),
    ])
    normal = np.zeros((n, 3), np.float32)
    normal[n_e + n_l:] = bnorm
    vel = np.zeros((n, 3), np.float32)

    sidx, srest, stype = _spring_graph(pos, color, n_e, n_l, params)

    return Scene(
        pos=pos, vel=vel, color=color, normal=normal,
        spring_rows=np.arange(n_e, dtype=np.int32),
        spring_idx=sidx, spring_rest=srest, spring_type=stype,
        tris=np.asarray(tris, np.int32).reshape(-1, 3),
        muscle_model=True,
    )


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


def generate_multi_worm_scene(
    n_worms: int = 2,
    params: SimParams = None,
) -> Scene:
    """``n_worms`` worms side by side along x, sharing one widened pool.

    Stress configuration beyond the reference (which hard-codes one worm,
    owHelper.cpp:709): the single-worm lane (the reference's 30h-wide box,
    owPhysicsConstant.h) is tiled n times along x, so worms sit a full
    lane (~30h) apart — far beyond the spring-search cutoff r0*sqrt(2.7)
    (owHelper.cpp:1392), so the combined spring graph cannot connect
    worms. The scene is built against the widened world box — pass
    ``generate_multi_worm_params(n_worms, params)`` as the Simulator's
    params. Memory order stays elastic (all worms) | liquid (inner
    liquids, then pool) | boundary. All worms share the single 96-muscle
    activation atlas, so they undulate in phase.
    """
    if params is None:
        params = SimParams()
    wide = generate_multi_worm_params(n_worms, params)

    shell_pos, shell_color, tris = _worm_shell(params)
    inner = _inner_worm_liquid(params)
    lane = float(params.x_max - params.x_min)

    shells, colors, triss, inners = [], [], [], []
    n_e1 = len(shell_pos)
    for k in range(n_worms):
        dx = np.array([k * lane, 0.0, 0.0], np.float32)
        shells.append(shell_pos + dx)
        colors.append(shell_color)
        triss.append(np.asarray(tris, np.int32).reshape(-1, 3) + k * n_e1)
        inners.append(inner + dx)

    pool = _pool_liquid(wide)
    bpos, bnorm = _boundary_box(wide)

    n_e = n_worms * n_e1
    n_l = n_worms * len(inner) + len(pool)
    n_b = len(bpos)
    n = n_e + n_l + n_b

    pos = np.concatenate(shells + inners + [pool, bpos])
    color = np.concatenate(
        colors
        + [np.full(n_l, 1.1, np.float32), np.full(n_b, 3.0, np.float32)]
    )
    normal = np.zeros((n, 3), np.float32)
    normal[n_e + n_l:] = bnorm

    sidx, srest, stype = _spring_graph(pos, color, n_e, n_l, wide)

    return Scene(
        pos=pos, vel=np.zeros((n, 3), np.float32), color=color,
        normal=normal,
        spring_rows=np.arange(n_e, dtype=np.int32),
        spring_idx=sidx, spring_rest=srest, spring_type=stype,
        tris=np.concatenate(triss, axis=0),
        muscle_model=True,
    )


def generate_multi_worm_params(
    n_worms: int, params: SimParams = None
) -> SimParams:
    """The widened world box for generate_multi_worm_scene: one reference
    lane (x extent) per worm."""
    if params is None:
        params = SimParams()
    lane = float(params.x_max - params.x_min)
    return dataclasses.replace(
        params, x_max=float(params.x_min) + lane * n_worms
    )
