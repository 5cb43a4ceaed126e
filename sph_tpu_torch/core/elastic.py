"""Elastic (spring) and muscle contraction forces by gather (counterpart of
``sph_tpu/core/elastic.py``).

The exact engine's spring forces (``add_elastic_forces``), and the fast
engine's fallback for scenes whose springs anchor outside the elastic block
(to walls, say), where the compact-slab spring pass cannot address the
partner rows: per elastic row, walk its padded spring list;
Hooke acceleration ``-(r_hat) * (r - r0) * k`` plus a contraction term
``-(r_hat) * signal * muscle_force`` when the spring's muscle is active. The
activation is a gather from the activation table where sph_tpu contracts a
one-hot matrix with it at full precision: the same f32 values.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import SimParams
from .state import Springs


def elastic_accel(pos: torch.Tensor, springs: Springs,
                  activation: torch.Tensor, params: SimParams
                  ) -> torch.Tensor:
    """Spring + muscle acceleration per spring row, [Ne, 3].

    ``pos`` [N, 3] (every id of ``springs`` indexes it; the fast engine
    passes sorted positions and springs translated to sorted ids);
    ``activation`` [MUSCLE_COUNT]."""
    i = springs.row_ids.long()                       # [Ne]
    j = torch.clamp(springs.idx, min=0).long()
    return spring_accel(pos[i], pos[j], springs, activation, params)


def spring_accel(p_row: torch.Tensor, p_end: torch.Tensor, springs: Springs,
                 activation: torch.Tensor, params: SimParams
                 ) -> torch.Tensor:
    """``elastic_accel`` from the rows' positions ``p_row`` [Ne, 3] and
    their partners' ``p_end`` [Ne, 32, 3] (any value in unused slots); the
    halo engine passes positions gathered across ranks."""
    valid = springs.idx >= 0                         # [Ne, 32]
    scale = float(np.float32(params.simulation_scale))
    d = (p_row[:, None, :] - p_end) * scale          # [Ne, 32, 3], meters
    r = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
                   + d[..., 2] * d[..., 2])
    ok = valid & (r != 0.0)
    inv_r = 1.0 / torch.clamp(r, min=1e-30)

    stretch = r - springs.rest
    coef = torch.where(ok, -stretch * float(np.float32(params.k_spring)),
                       0.0)

    mid = springs.muscle.long()                      # [Ne, 32], 0 = plain
    n_act = activation.shape[0]
    known = (mid >= 1) & (mid <= n_act)              # other ids drive nothing
    act = torch.cat([activation.new_zeros(1), activation])[
        torch.where(known, mid, 0)]
    m_on = ok & known & (act > 0.0)
    coef = coef + torch.where(
        m_on, -act * float(np.float32(params.muscle_force)), 0.0)

    return (d * (coef * inv_r)[..., None]).sum(dim=1)


def add_elastic_forces(a_ext: torch.Tensor, pos_g: torch.Tensor,
                       springs: Springs, activation: torch.Tensor,
                       params: SimParams,
                       local_offset: int = 0) -> torch.Tensor:
    """``a_ext`` [n_local, 3] plus the spring + muscle acceleration of each
    spring row (``index_add``; the row ids are distinct).

    ``local_offset``: global id of a_ext's row 0 (shard start); rows outside
    the local range go to a scratch row past the end and are dropped, as
    ``sph_tpu``'s scatter drops them (no host sync)."""
    if springs.n_elastic == 0:
        return a_ext
    a = elastic_accel(pos_g, springs, activation, params)
    n_loc = a_ext.shape[0]
    i_loc = springs.row_ids.long() - local_offset
    i_safe = torch.where((i_loc >= 0) & (i_loc < n_loc), i_loc, n_loc)
    out = torch.cat([a_ext, a_ext.new_zeros(1, 3)]).index_add_(0, i_safe, a)
    return out[:n_loc]
