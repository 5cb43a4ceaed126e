"""Fixed-capacity neighbour search on the hash grid (counterpart of
``sph_tpu/core/neighbors.py``).

Replaces the reference's two-pass histogram kernel (`sphFluid.cl:207-329`):
all candidates of the same 2x2x2 corner cell block are gathered at once and
the **exact** 32 nearest within radius ``h`` are kept, in a fixed
``[Nq, 32]`` list (-1 ids in empty slots; distances stored as ``q = r/h``).

Which 32 are kept where more than 32 lie within h is decided as in
``sph_tpu``: the candidate matrix is built in its order (the corner cells of
``_CORNER_COMBOS``, then the slots of each cell), and among equal distances
the earlier candidate wins — ``jax.lax.top_k``'s rule, here a stable sort of
the keys (``torch.topk`` promises no order among ties). Generated scenes
are lattices with many exactly equal distances, so the rule decides real
lists.

Local/global split: the query rows may be a subset of the particles while
the grid and position table are global; single-device callers pass the same
tensor for both.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import SimParams
from .grid import Grid, cell_coords_of, linear_cell_id

# The 8 searched cells: own cell + 7 toward the nearest cell corner
# (sphFluid.cl:266-308). Each entry selects which axes apply the +-1 delta.
_CORNER_COMBOS = (
    (0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1),
    (1, 1, 0), (1, 0, 1), (0, 1, 1), (1, 1, 1),
)


class NeighborList(NamedTuple):
    idx: torch.Tensor    # [Nq,32] i32 neighbour ids in GLOBAL index space, -1 pad
    q: torch.Tensor      # [Nq,32] f32 r/h in [0,1], 0 where padded
    valid: torch.Tensor  # [Nq,32] bool


def _f32(x) -> float:
    return float(np.float32(x))


def pair_d2(query: torch.Tensor, pos_t: torch.Tensor, j: torch.Tensor
            ) -> torch.Tensor:
    """Squared distances between query rows [Nq, 3] and ``j`` [Nq, K]
    (indices into the [3, N] component planes ``pos_t``), summed x, y, z in
    that order as ``sph_tpu`` does."""
    d2 = None
    for k in range(3):
        d = query[:, k:k + 1] - pos_t[k][j]
        d2 = d * d if d2 is None else d2 + d * d
    return d2


def find_neighbors(query: torch.Tensor, query_ids: torch.Tensor,
                   pos: torch.Tensor, grid: Grid,
                   params: SimParams) -> NeighborList:
    """Neighbours of ``query`` rows [Nq, 3] against the global ``pos``
    [N, 3] / ``grid``. ``query_ids``: global ids of the query rows (for
    self-exclusion). Single device: query = pos, query_ids = arange(N)."""
    n_glob = pos.shape[0]
    k_cap = params.cell_capacity
    m = params.max_neighbors
    dev = query.device
    dims = torch.tensor(params.grid_dims, dtype=torch.int32, device=dev)
    box_min = torch.tensor(params.box_min, dtype=torch.float32, device=dev)

    qc = cell_coords_of(query, params)                       # [Nq, 3]
    # Direction of the nearest cell corner per axis: the interaction radius
    # h is half the cell edge, so candidates fit in own cell + that corner
    # block (lo test at sphFluid.cl:266-271).
    frac = (query - box_min) - qc.to(torch.float32) * _f32(params.cell_size)
    delta = torch.where(frac < _f32(params.h), -1, 1).to(torch.int32)
    combos = torch.tensor(_CORNER_COMBOS, dtype=torch.int32, device=dev)
    cc = qc[:, None, :] + delta[:, None, :] * combos         # [Nq, 8, 3]
    in_range = ((cc >= 0) & (cc < dims)).all(dim=2)          # [Nq, 8]
    lin = linear_cell_id(torch.minimum(torch.clamp(cc, min=0), dims - 1),
                         params)                              # [Nq, 8]
    start = grid.cell_start[lin]
    count = torch.clamp(grid.cell_start[lin + 1] - start, max=k_cap)
    slots = torch.arange(k_cap, dtype=torch.int32, device=dev)
    slot_ok = (slots < count[..., None]) & in_range[..., None]
    gather_at = torch.clamp(start[..., None] + slots, max=n_glob - 1)
    cand = torch.where(slot_ok, grid.order[gather_at], -1)
    cand = cand.reshape(query.shape[0], 8 * k_cap)           # [Nq, 8K] i32
    del slot_ok, gather_at

    d2 = pair_d2(query, pos.t().contiguous(), torch.clamp(cand, min=0))
    ok = (cand >= 0) & (cand != query_ids[:, None]) & (
        d2 <= _f32(params.h * params.h))
    key = torch.where(ok, d2, torch.inf)
    del d2, ok
    key, sel = torch.sort(key, dim=1, stable=True)
    nbr_d2, sel = key[:, :m], sel[:, :m]
    del key
    found = torch.isfinite(nbr_d2)
    nbr_idx = torch.where(found, torch.gather(cand, 1, sel), -1).to(
        torch.int32)
    q = torch.where(
        found,
        torch.sqrt(torch.clamp(nbr_d2, min=0.0)) * _f32(1.0 / params.h),
        0.0)
    return NeighborList(idx=nbr_idx, q=q, valid=found)


def neighbor_overflow(nbrs: NeighborList) -> torch.Tensor:
    """Count of particles with all 32 slots filled (possible truncation).

    The reference truncates silently (`sphFluid.cl:169`); we expose it."""
    return nbrs.valid.all(dim=1).sum()
