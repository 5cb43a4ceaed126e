"""Device-side simulation state as dataclasses of tensors.

Counterpart of ``sph_tpu/core/state.py``: the same fields, shapes and index
conventions (every particle reference uses original particle ids), held as
``torch`` tensors on an explicit device.
"""
from __future__ import annotations

import dataclasses

import torch

from ..constants import MAX_MEMBRANES_PER_PARTICLE, MAX_NEIGHBORS


@dataclasses.dataclass
class FluidState:
    """Per-particle dynamic state. Shapes: N = total particle count."""

    pos: torch.Tensor            # [N,3] f32, sim units
    vel: torch.Tensor            # [N,3] f32, scaled SI (m/s)
    ptype: torch.Tensor          # [N]   i32, LIQUID/ELASTIC/BOUNDARY
    normal: torch.Tensor         # [N,3] f32, outward wall normal
    muscle_activation: torch.Tensor  # [MUSCLE_COUNT] f32 in [0,1]
    step: torch.Tensor           # []    i32, completed-step counter

    @property
    def n_particles(self) -> int:
        return self.pos.shape[0]


@dataclasses.dataclass
class Springs:
    """Elastic connection graph, padded to MAX_NEIGHBORS per elastic row."""

    row_ids: torch.Tensor  # [Ne]    i32 absolute particle id owning the row
    idx: torch.Tensor      # [Ne,32] i32 absolute neighbor ids, -1 pad
    rest: torch.Tensor     # [Ne,32] f32 rest length, scaled SI meters
    muscle: torch.Tensor   # [Ne,32] i32 muscle id 1..96, 0 = plain spring

    @property
    def n_elastic(self) -> int:
        return self.row_ids.shape[0]


@dataclasses.dataclass
class Membranes:
    """Triangular membrane mesh over elastic particles."""

    tris: torch.Tensor           # [M,3] i32 vertex particle ids
    particle_tris: torch.Tensor  # [N,7] i32 triangle ids, -1 pad

    @property
    def n_tris(self) -> int:
        return self.tris.shape[0]


def empty_springs(device) -> Springs:
    z = torch.zeros((0, MAX_NEIGHBORS), dtype=torch.int32, device=device)
    return Springs(
        row_ids=torch.zeros((0,), dtype=torch.int32, device=device),
        idx=z,
        rest=torch.zeros((0, MAX_NEIGHBORS), dtype=torch.float32,
                         device=device),
        muscle=z,
    )


def empty_membranes(n_particles: int, device) -> Membranes:
    return Membranes(
        tris=torch.zeros((0, 3), dtype=torch.int32, device=device),
        particle_tris=torch.full(
            (n_particles, MAX_MEMBRANES_PER_PARTICLE), -1,
            dtype=torch.int32, device=device,
        ),
    )
