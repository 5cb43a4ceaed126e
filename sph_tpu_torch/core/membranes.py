"""Liquid <-> membrane interaction of the exact engine (counterpart of
``sph_tpu/core/membranes.py``).

The reference's three-kernel group ``clearMembraneBuffers`` /
``computeInteractionWithMembranes`` / ``..._finalize``
(`sphFluid.cl:1214-1682`) runs *after* integration on the updated
positions: each liquid particle collects the membrane triangles of its
elastic neighbours, averages oriented plane normals per neighbour, and
applies an Ihmsen-style position projection. Here it is one functional
update.

As in ``sph_tpu``, the reference's per-(particle, neighbour, triangle)
Cramer projection (cl:1229-1308) is replaced by the triangle's unit plane
normal oriented toward x_i by the sign of a dot product (the same vector).

Two evaluation modes: the liquid particles as a contiguous slice (single
device; the reference's type check, cl:1393-1395, for free), or every row
with a liquid mask against global positions.

Documented deviations (those of ``sph_tpu``): the true 3D
particle-to-neighbour distance (the reference zeroes z, cl:1437, a likely
``.w`` typo), and degenerate cases (zero-area triangle, particle exactly
in-plane; the reference aborts, cl:1468-1472/1501-1505) masked out.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import SimParams
from ..constants import ELASTIC_PARTICLE, LIQUID_PARTICLE
from .neighbors import NeighborList
from .pcisph import dot, norm2
from .state import Membranes


def triangle_normals(pos_g: torch.Tensor, membranes: Membranes
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Unit plane normals and reference vertex positions, [M, 3] each."""
    tris = membranes.tris.long()
    va, vb, vc = pos_g[tris[:, 0]], pos_g[tris[:, 1]], pos_g[tris[:, 2]]
    ab, ac = vb - va, vc - va
    n = torch.stack([
        ab[:, 1] * ac[:, 2] - ab[:, 2] * ac[:, 1],
        ab[:, 2] * ac[:, 0] - ab[:, 0] * ac[:, 2],
        ab[:, 0] * ac[:, 1] - ab[:, 1] * ac[:, 0],
    ], dim=1)
    n2 = norm2(n)
    inv = torch.where(n2 > 0.0, torch.rsqrt(torch.clamp(n2, min=1e-30)), 0.0)
    return n * inv[:, None], va


def _membrane_delta(x_i: torch.Tensor, liquid_mask: torch.Tensor,
                    idx: torch.Tensor, valid: torch.Tensor,
                    pos_g: torch.Tensor, ptype_g: torch.Tensor,
                    membranes: Membranes, params: SimParams) -> torch.Tensor:
    """Position correction [R, 3] of the given rows."""
    n_plane, ref_a = triangle_normals(pos_g, membranes)

    j = torch.clamp(idx, min=0).long()
    elastic_j = valid & (ptype_g[j] == ELASTIC_PARTICLE) \
        & liquid_mask[:, None]

    # 3D particle-to-neighbour distance (see the module doc).
    dist_ij = torch.sqrt(norm2(x_i[:, None, :] - pos_g[j]))   # [R, 32]

    # Triangles of each elastic neighbour: a loop over the 7 slots keeps
    # every temporary at [R, 32] (x 3).
    cnt = torch.zeros(j.shape, dtype=torch.int32, device=j.device)
    n_avg_acc = None
    for c in range(membranes.particle_tris.shape[1]):
        t = membranes.particle_tris[j, c]                      # [R, 32]
        t_ok = elastic_j & (t >= 0)
        t_safe = torch.clamp(t, min=0).long()
        n_t = n_plane[t_safe]                                  # [R, 32, 3]
        a_t = ref_a[t_safe]

        # Orient each plane normal toward the liquid particle (the
        # reference's normalize(x_i - projection), cl:1477-1483).
        s = dot(x_i[:, None, :] - a_t, n_t)
        contrib_ok = t_ok & (s != 0.0) & (norm2(n_t) > 0.0)
        sgn = torch.where(contrib_ok, torch.sign(s), 0.0)

        cnt = cnt + contrib_ok.to(torch.int32)
        term = n_t * sgn[..., None]
        n_avg_acc = term if n_avg_acc is None else n_avg_acc + term

    inv_cnt = 1.0 / torch.clamp(cnt, min=1).to(torch.float32)
    n_avg = n_avg_acc * inv_cnt[..., None]

    is_entry = cnt > 0                          # neighbour in >= 1 membrane
    r0 = float(np.float32(params.r0))
    w = torch.where(is_entry, torch.clamp((r0 - dist_ij) / r0, min=0.0), 0.0)
    n_ci = (n_avg * w[..., None]).sum(dim=1)
    w_sum = w.sum(dim=1)
    w2_sum = (w * (r0 - dist_ij) * is_entry).sum(dim=1)

    n_len2 = norm2(n_ci)
    has = (n_len2 > 0.0) & liquid_mask
    inv_len = torch.rsqrt(torch.clamp(n_len2, min=1e-30))
    coef = torch.where(
        has, inv_len * w2_sum / torch.clamp(w_sum, min=1e-30), 0.0)
    return n_ci * coef[:, None]


def membrane_position_correction(
    pos_l: torch.Tensor,
    ptype_l: torch.Tensor,
    nbrs: NeighborList,
    membranes: Membranes,
    params: SimParams,
    liquid_range: tuple[int, int] | None = None,
    pos_g: torch.Tensor | None = None,
    ptype_g: torch.Tensor | None = None,
) -> torch.Tensor:
    """Updated local positions after membrane interaction."""
    if membranes.n_tris == 0:
        return pos_l
    pos_is_global = pos_g is None
    pos_g = pos_l if pos_g is None else pos_g
    ptype_g = ptype_l if ptype_g is None else ptype_g

    if liquid_range is not None and pos_is_global:
        lo, hi = liquid_range
        if hi <= lo:
            return pos_l
        delta = _membrane_delta(
            pos_l[lo:hi],
            torch.ones(hi - lo, dtype=torch.bool, device=pos_l.device),
            nbrs.idx[lo:hi], nbrs.valid[lo:hi], pos_g, ptype_g, membranes,
            params)
        out = pos_l.clone()
        out[lo:hi] = pos_l[lo:hi] + delta
        return out

    liquid_mask = ptype_l == LIQUID_PARTICLE
    delta = _membrane_delta(pos_l, liquid_mask, nbrs.idx, nbrs.valid,
                            pos_g, ptype_g, membranes, params)
    return pos_l + delta
