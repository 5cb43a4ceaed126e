"""Device-side simulation state as dataclasses of tensors.

Counterpart of ``sph_tpu/core/state.py``: the same fields, shapes and index
conventions (every particle reference uses original particle ids), held as
``torch`` tensors on an explicit device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..constants import (BOUNDARY_PARTICLE, MAX_MEMBRANES_PER_PARTICLE,
                         MAX_NEIGHBORS, MUSCLE_COUNT)


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


def make_state(pos, vel, ptype, normal=None, device="cuda") -> FluidState:
    """Build a FluidState from host arrays on ``device``, at step 0 with no
    muscle activation.

    ``vel`` rows for boundary particles are interpreted as wall normals (the
    reference's storage trick, `sphFluid.cl:860`) **only** if ``normal`` is
    not given; pass ``normal`` explicitly for new-style scenes.
    """
    pos = np.asarray(pos, dtype=np.float32)
    vel = np.asarray(vel, dtype=np.float32)
    ptype = np.asarray(ptype, dtype=np.int32)
    if normal is None:
        is_b = (ptype == BOUNDARY_PARTICLE)[:, None]
        normal = np.where(is_b, vel, 0.0).astype(np.float32)
        vel = np.where(is_b, 0.0, vel).astype(np.float32)
    else:
        normal = np.asarray(normal, dtype=np.float32)

    def t(a):       # a copy, as jnp.asarray makes: the state owns its data
        return torch.tensor(a, device=device)

    return FluidState(
        pos=t(pos), vel=t(vel), ptype=t(ptype), normal=t(normal),
        muscle_activation=torch.zeros(MUSCLE_COUNT, dtype=torch.float32,
                                      device=device),
        step=torch.zeros((), dtype=torch.int32, device=device),
    )
