"""The all-gather sharded step (counterpart of
``sph_tpu/parallel/sharded.py``): the multi-GPU correctness oracle.

Particle-sharded data parallelism with replicated reads: each rank owns a
contiguous block of particle rows and computes neighbour search and every
force for its block only; what is read through neighbour indices
(positions, velocities, densities, the loop's predicted state) is
re-globalised by an all-gather. The exact engine's stages already take
local/global pairs and a ``gather`` callable (``core/pcisph.py``,
``core/elastic.py``'s ``local_offset``), so the sharded and single-device
trajectories agree to the last ulp modulo reduction layout. The halo
engine (``parallel/halo.py``) is held to it.
"""
from __future__ import annotations

import torch

from ..config import SimParams
from ..core.elastic import add_elastic_forces
from ..core.grid import build_grid
from ..core.membranes import membrane_position_correction
from ..core.neighbors import find_neighbors
from ..core.pcisph import (compute_density, compute_external_forces,
                           integrate, pcisph_pressure_loop)
from ..core.state import FluidState
from ..core.step import SceneLayout
from ..models import muscle
from .comm import Comm

_ROW_FIELDS = ("pos", "vel", "ptype", "normal")


def shard_state(state: FluidState, comm: Comm) -> FluidState:
    """This rank's contiguous rows of every per-particle field (the
    activation and step replicated). The particle count must divide
    across the ranks (``pad_scene_to_devices``)."""
    n = state.pos.shape[0]
    if n % comm.world:
        raise ValueError(f"{n} particles do not divide across {comm.world} "
                         "ranks; pad the scene with pad_scene_to_devices")
    n_loc = n // comm.world
    rows = slice(comm.rank * n_loc, (comm.rank + 1) * n_loc)
    return FluidState(
        **{f: getattr(state, f)[rows].contiguous() for f in _ROW_FIELDS},
        muscle_activation=state.muscle_activation, step=state.step)


def gather_state(state: FluidState, comm: Comm) -> FluidState:
    """Every rank's rows of a sharded state, on every rank."""
    return FluidState(
        **{f: comm.all_gather(getattr(state, f)) for f in _ROW_FIELDS},
        muscle_activation=state.muscle_activation, step=state.step)


def make_sharded_step(comm: Comm, params: SimParams, layout: SceneLayout,
                      n_steps: int = 1):
    """``fn(state, springs, membranes) -> state`` over ``n_steps`` exact
    steps, ``state`` this rank's shard (:func:`shard_state`), springs and
    membranes replicated."""
    gather = comm.all_gather

    def one_step(state: FluidState, springs, membranes) -> FluidState:
        pos_l, vel_l, ptype_l = state.pos, state.vel, state.ptype
        n_loc = ptype_l.shape[0]
        off = comm.rank * n_loc
        ids_l = off + torch.arange(n_loc, dtype=torch.int32,
                                   device=pos_l.device)

        pos_g = gather(pos_l)
        vel_g = gather(vel_l)
        ptype_g = gather(ptype_l)
        normal_g = gather(state.normal)

        grid = build_grid(pos_g, params)
        nbrs = find_neighbors(pos_l, ids_l, pos_g, grid, params)

        rho_l = compute_density(nbrs, params)
        rho_g = gather(rho_l)
        a_ext = compute_external_forces(
            pos_l, vel_l, rho_l, ptype_l, nbrs, params,
            pos_g=pos_g, vel_g=vel_g, rho_g=rho_g, ptype_g=ptype_g,
            normal_g=normal_g)
        a_ext = add_elastic_forces(a_ext, pos_g, springs,
                                   state.muscle_activation, params,
                                   local_offset=off)

        res = pcisph_pressure_loop(pos_l, vel_l, ptype_l, nbrs, params,
                                   pos_g=pos_g, gather=gather)

        pos1_l, vel1_l = integrate(
            pos_l, vel_l, ptype_l, a_ext, res.a_p, nbrs, params,
            ptype_g=ptype_g, normal_g=normal_g, pos0_g=pos_g)

        if membranes.n_tris > 0:
            pos2_l = membrane_position_correction(
                pos1_l, ptype_l, nbrs, membranes, params,
                pos_g=gather(pos1_l), ptype_g=ptype_g)
        else:
            pos2_l = pos1_l

        if layout.muscle_model:
            activation = muscle.next_activation(state.step)
        else:
            activation = state.muscle_activation

        return FluidState(pos=pos2_l, vel=vel1_l, ptype=ptype_l,
                          normal=state.normal, muscle_activation=activation,
                          step=state.step + 1)

    def stepper(state, springs, membranes):
        for _ in range(n_steps):
            state = one_step(state, springs, membranes)
        return state

    return stepper
