"""The exact engine's step and the static scene layout (counterpart of
``sph_tpu/core/step.py``).

One step is the reference's stage order (`owPhysicsFluidSimulator.cpp:
79-149`): grid build, neighbour search, density, external and elastic
forces, the PCISPH loop, integration, membranes and the muscle signal.
``sph_tpu`` jit-compiles it and scans it; here it is a sequence of eager
device ops and the multi-step drivers are host loops; nothing in a step
reads a value back to the host, so the loops only queue work.

State crosses the API boundary as ``[N, 3]`` tensors, and stays so inside.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import SimParams
from ..models import muscle
from .elastic import add_elastic_forces
from .grid import build_grid, cell_occupancy_overflow
from .membranes import membrane_position_correction
from .neighbors import (NeighborList, find_neighbors, neighbor_overflow,
                        pair_d2)
from .pcisph import (compute_density, compute_external_forces, integrate,
                     pcisph_pressure_loop)
from .state import FluidState, Membranes, Springs


@dataclasses.dataclass(frozen=True)
class SceneLayout:
    """Static layout facts about a scene (hashable).

    Particle classes are stored contiguously — the generator emits
    elastic/liquid/boundary, the file loader boundary/elastic/liquid.
    """

    n_particles: int
    liquid_range: tuple[int, int] = (0, 0)
    elastic_range: tuple[int, int] = (0, 0)
    boundary_range: tuple[int, int] = (0, 0)
    muscle_model: bool = False  # drive activations from the wave model
    # every spring endpoint lies in elastic_range
    springs_elastic_only: bool = True
    # highest used partner slot across the spring table (rounded up to 4)
    spring_slots: int = 32
    # every spring endpoint is elastic or boundary (never liquid)
    springs_anchors_static: bool = True

    @property
    def n_liquid(self) -> int:
        return self.liquid_range[1] - self.liquid_range[0]

    @property
    def n_elastic(self) -> int:
        return self.elastic_range[1] - self.elastic_range[0]

    @property
    def n_boundary(self) -> int:
        return self.boundary_range[1] - self.boundary_range[0]


def _ids(state: FluidState) -> torch.Tensor:
    return torch.arange(state.pos.shape[0], dtype=torch.int32,
                        device=state.pos.device)


def neighbor_list(state: FluidState, params: SimParams) -> NeighborList:
    """The neighbour phase: grid build + search over every particle."""
    return find_neighbors(state.pos, _ids(state), state.pos,
                          build_grid(state.pos, params), params)


def step_fn(state: FluidState, springs: Springs, membranes: Membranes,
            params: SimParams, layout: SceneLayout) -> FluidState:
    """One PCISPH step, same stage order as
    `owPhysicsFluidSimulator.cpp:79-149`."""
    return step_core(state, springs, membranes, params, layout,
                     neighbor_list(state, params))


def step_core(state: FluidState, springs: Springs, membranes: Membranes,
              params: SimParams, layout: SceneLayout,
              nbrs: NeighborList) -> FluidState:
    """The step stages after the neighbour phase (everything consumes the
    NeighborList). Split out so ``multi_step_cached`` can run them against
    a cached-index list with freshened distances."""
    pos, vel, normal, ptype = state.pos, state.vel, state.normal, state.ptype

    # -- forces at time t --
    rho = compute_density(nbrs, params)
    a_ext = compute_external_forces(pos, vel, rho, ptype, nbrs, params,
                                    normal_g=normal)
    a_ext = add_elastic_forces(a_ext, pos, springs, state.muscle_activation,
                               params)

    # -- PCISPH prediction-correction --
    res = pcisph_pressure_loop(pos, vel, ptype, nbrs, params)

    # -- integrate + membrane interaction --
    pos1, vel1 = integrate(pos, vel, ptype, a_ext, res.a_p, nbrs, params,
                           normal_g=normal)
    pos2 = membrane_position_correction(pos1, ptype, nbrs, membranes, params,
                                        liquid_range=layout.liquid_range)

    # -- muscle signal for the next step --
    if layout.muscle_model:
        activation = muscle.next_activation(state.step)
    else:
        activation = state.muscle_activation

    return FluidState(pos=pos2, vel=vel1, ptype=ptype, normal=normal,
                      muscle_activation=activation, step=state.step + 1)


def simulation_step(state: FluidState, springs: Springs,
                    membranes: Membranes, params: SimParams,
                    layout: SceneLayout) -> FluidState:
    """Advance the simulation by one PCISPH step."""
    return step_fn(state, springs, membranes, params, layout)


def multi_step(state: FluidState, springs: Springs, membranes: Membranes,
               params: SimParams, layout: SceneLayout,
               n_steps: int) -> FluidState:
    """Run ``n_steps`` steps (a host loop; no host synchronisation)."""
    for _ in range(int(n_steps)):
        state = step_fn(state, springs, membranes, params, layout)
    return state


def _freshen_neighbors(s: FluidState, idx: torch.Tensor,
                       params: SimParams) -> NeighborList:
    """Rebuild a NeighborList from cached neighbour INDICES and the state's
    CURRENT positions: distances are exact, pairs drifted beyond h are
    invalidated (kernel support stays exact). Same f32 arithmetic as the
    neighbour search, so a fresh-index freshen equals ``find_neighbors``'s
    output bit for bit."""
    d2 = pair_d2(s.pos, s.pos.t().contiguous(), torch.clamp(idx, min=0))
    valid = (idx >= 0) & (d2 <= float(np.float32(params.h * params.h)))
    q = torch.where(
        valid,
        torch.sqrt(torch.clamp(d2, min=0.0)) * float(np.float32(
            1.0 / params.h)),
        0.0)
    return NeighborList(idx=torch.where(valid, idx, -1), q=q, valid=valid)


def neighbor_indices(state: FluidState, params: SimParams,
                     layout: SceneLayout) -> torch.Tensor:
    """The neighbour phase alone: [N, max_neighbors] int32 indices."""
    return neighbor_list(state, params).idx


def step_cached(state: FluidState, springs: Springs, membranes: Membranes,
                params: SimParams, layout: SceneLayout,
                idx: torch.Tensor) -> FluidState:
    """One step against cached neighbour indices (distances freshened from
    current positions)."""
    return step_core(state, springs, membranes, params, layout,
                     _freshen_neighbors(state, idx, params))


def multi_step_cached(state: FluidState, springs: Springs,
                      membranes: Membranes, params: SimParams,
                      layout: SceneLayout, n_steps: int,
                      refresh_every: int = 10) -> FluidState:
    """``multi_step`` with CACHED neighbour indices: the candidate gather
    and selection run once per ``refresh_every`` steps (at steps 0,
    refresh_every, 2 refresh_every, ...); between refreshes only the
    [N, 32] pair distances are recomputed from current positions (pairs
    drifting beyond h are invalidated, so the kernel support stays exact).
    At ``refresh_every=1`` it equals ``multi_step`` bit for bit. A
    practical-cost oracle for deviation studies, not a fast path."""
    idx = None
    for k in range(int(n_steps)):
        if k % max(1, refresh_every) == 0:
            idx = neighbor_indices(state, params, layout)
        state = step_cached(state, springs, membranes, params, layout, idx)
    return state


def multi_step_unrolled_cached(state: FluidState, springs: Springs,
                               membranes: Membranes, params: SimParams,
                               layout: SceneLayout, n_steps: int,
                               refresh_every: int = 10) -> FluidState:
    """``sph_tpu``'s step-by-step dispatch of ``multi_step_cached`` (a TPU
    workaround there). Both are host loops here: the same computation."""
    return multi_step_cached(state, springs, membranes, params, layout,
                             n_steps, refresh_every)


def diagnostics(state: FluidState, params: SimParams) -> dict:
    """Density/pressure/neighbour diagnostics for the state API
    (counterparts of getDensity_cpp / getParticleIndex_cpp etc.,
    `owPhysicsFluidSimulator.h:14-21`): the exact engine's neighbour
    search and PCISPH loop on the state as it is. Tensors on the state's
    device."""
    grid = build_grid(state.pos, params)
    nbrs = find_neighbors(state.pos, _ids(state), state.pos, grid, params)
    res = pcisph_pressure_loop(state.pos, state.vel, state.ptype, nbrs,
                               params)
    return {
        "rho": compute_density(nbrs, params),
        "pressure": res.pressure,
        "neighbor_count": nbrs.valid.sum(dim=1),
        "neighbor_overflow": neighbor_overflow(nbrs),
        "cell_overflow": cell_occupancy_overflow(grid, params),
    }
