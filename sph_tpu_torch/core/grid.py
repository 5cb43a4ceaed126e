"""Uniform hash grid on the device (counterpart of ``sph_tpu/core/grid.py``).

One stable ``argsort`` of the full-precision linear cell ids and one
``searchsorted`` give a CSR cell -> particle map with no sentinel holes (the
reference's five-stage host-synchronising build, `owOpenCLSolver.cpp:
229-319`, has no counterpart). Cell ids are exact: the reference's 16-bit
truncation (`sphFluid.cl:377`) is not reproduced. Positions are ``[N, 3]``;
the f32 arithmetic per component is ``sph_tpu``'s, so cell coordinates,
``order`` and ``cell_start`` are equal element for element.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import SimParams


@dataclasses.dataclass
class Grid:
    """CSR cell->particle map in original-index space."""

    ccx: torch.Tensor         # [N] i32 cell x-coordinate per particle
    ccy: torch.Tensor         # [N] i32
    ccz: torch.Tensor         # [N] i32
    order: torch.Tensor       # [N] i32 particle ids sorted by linear cell id
    cell_start: torch.Tensor  # [n_cells+1] i32 offsets into ``order``


def _f32(x) -> float:
    return float(np.float32(x))


def cell_coords_of(pos: torch.Tensor, params: SimParams) -> torch.Tensor:
    """Integer cell coordinates [N, 3] i32, clipped into the grid.

    Matches ``cellFactors`` (`sphFluid.cl:187-201`): plain truncation of
    (pos - box_min) * (1 / (2h)); positions are box-clamped by the
    integrator, so the clip is a no-op in normal operation."""
    inv = _f32(1.0 / params.cell_size)
    cols = []
    for k, (b, n) in enumerate(zip(params.box_min, params.grid_dims)):
        c = ((pos[:, k] - _f32(b)) * inv).to(torch.int32)
        cols.append(torch.clamp(c, 0, n - 1))
    return torch.stack(cols, dim=1)


def linear_cell_id(c: torch.Tensor, params: SimParams) -> torch.Tensor:
    """x-major linearisation of [..., 3] cell coordinates, the layout of
    ``cellId`` (`sphFluid.cl:332-342`)."""
    nx, ny, _ = params.grid_dims
    return c[..., 0] + nx * (c[..., 1] + ny * c[..., 2])


def build_grid(pos: torch.Tensor, params: SimParams) -> Grid:
    c = cell_coords_of(pos, params)
    cell_ids = linear_cell_id(c, params)
    order = torch.argsort(cell_ids, stable=True)
    sorted_ids = cell_ids[order].contiguous()
    cell_start = torch.searchsorted(
        sorted_ids,
        torch.arange(params.n_cells + 1, dtype=sorted_ids.dtype,
                     device=pos.device),
        side="left",
    ).to(torch.int32)
    return Grid(ccx=c[:, 0], ccy=c[:, 1], ccz=c[:, 2],
                order=order.to(torch.int32), cell_start=cell_start)


def max_cell_occupancy(pos, params: SimParams) -> int:
    """Max 2h-cell occupancy of the given positions (host-side NumPy)."""
    nx, ny, nz = params.grid_dims
    p = np.asarray(pos, np.float64) - np.asarray(params.box_min)
    c = np.clip((p / params.cell_size).astype(np.int64),
                0, [nx - 1, ny - 1, nz - 1])
    cid = c[:, 0] + nx * (c[:, 1] + ny * c[:, 2])
    return int(np.bincount(cid).max()) if len(cid) else 0


def measured_cell_capacity(pos, params: SimParams,
                           margin: float = 1.25) -> int:
    """Scene-derived ``cell_capacity``: max 2h-cell occupancy of the given
    positions times a safety margin, rounded up to a multiple of 16 and never
    below the params default. Host-side; run once at scene build."""
    occ = max_cell_occupancy(pos, params)
    need = -(-int(occ * margin) // 16) * 16
    return max(need, params.cell_capacity)


def cell_occupancy_overflow(grid: Grid, params: SimParams) -> torch.Tensor:
    """Total particles beyond ``cell_capacity`` in their cell (diagnostic).

    The reference silently truncates neighbour candidates
    (`sphFluid.cl:169`); the count surfaces capacity overflow instead."""
    counts = grid.cell_start[1:] - grid.cell_start[:-1]
    return torch.clamp(counts - params.cell_capacity, min=0).sum()
