"""sph_tpu_torch — the PCISPH framework on PyTorch and CUDA (NVIDIA Hopper).

A port of ``sph_tpu`` that mirrors its module names. It imports ``torch``
and never ``jax``; the pair-interaction passes of the wall-compact engine
are hand-written CUDA kernels (``ops/csrc/pair_pass.cu``) with plain
PyTorch versions for CPU tensors.
"""
from .config import DEFAULT_PARAMS, SimParams
from .constants import (
    BOUNDARY_PARTICLE,
    ELASTIC_PARTICLE,
    LIQUID_PARTICLE,
    MAX_NEIGHBORS,
    MUSCLE_COUNT,
)
from .core.state import FluidState, Membranes, Springs, make_state
from .core.step import SceneLayout, multi_step, simulation_step

__version__ = "0.1.0"

__all__ = [
    "DEFAULT_PARAMS",
    "SimParams",
    "FluidState",
    "Springs",
    "Membranes",
    "SceneLayout",
    "make_state",
    "simulation_step",
    "multi_step",
    "LIQUID_PARTICLE",
    "ELASTIC_PARTICLE",
    "BOUNDARY_PARTICLE",
    "MAX_NEIGHBORS",
    "MUSCLE_COUNT",
]
