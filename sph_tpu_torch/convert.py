"""Carry parameters and state across from ``sph_tpu`` to the port.

Plain data only: this module imports neither package's engines, so a test
can hand the identical inputs to both sides.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import SimParams
from .constants import MUSCLE_COUNT
from .core.state import FluidState, Membranes, Springs


def params_from(jax_params) -> SimParams:
    """The port's SimParams with every dataclass field of ``jax_params``
    (a ``sph_tpu.config.SimParams``); derived coefficients recompute."""
    return SimParams(**{
        f.name: getattr(jax_params, f.name)
        for f in dataclasses.fields(SimParams)
    })


def state_from_numpy(pos, vel, ptype, normal, muscle_activation=None,
                     step=0, device="cpu") -> FluidState:
    """A FluidState from plain numpy arrays (copied onto ``device``)."""
    def t(a, dtype):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    if muscle_activation is None:
        muscle_activation = np.zeros(MUSCLE_COUNT, np.float32)
    return FluidState(
        pos=t(pos, torch.float32),
        vel=t(vel, torch.float32),
        ptype=t(ptype, torch.int32),
        normal=t(normal, torch.float32),
        muscle_activation=t(muscle_activation, torch.float32),
        step=torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                          device=device),
    )


def springs_from_numpy(row_ids, idx, rest, muscle, device="cpu") -> Springs:
    """A Springs table from plain numpy arrays (``sph_tpu``'s ``Springs``
    fields, copied onto ``device``)."""
    def t(a, dtype):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    return Springs(row_ids=t(row_ids, torch.int32), idx=t(idx, torch.int32),
                   rest=t(rest, torch.float32),
                   muscle=t(muscle, torch.int32))


def membranes_from_numpy(tris, particle_tris, device="cpu") -> Membranes:
    """A Membranes mesh from plain numpy arrays (``sph_tpu``'s ``Membranes``
    fields, copied onto ``device``)."""
    def t(a):
        return torch.as_tensor(np.array(a), dtype=torch.int32, device=device)

    return Membranes(tris=t(tris), particle_tris=t(particle_tris))
