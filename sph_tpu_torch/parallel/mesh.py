"""Rank chains and scene padding for the multi-GPU engines (counterpart of
``sph_tpu/parallel/mesh.py``).

``sph_tpu`` builds a 1-D ``jax.sharding.Mesh`` over the particle axis; the
port's counterpart is a :class:`~sph_tpu_torch.parallel.comm.Comm` over a
process group's ranks, in rank order. The engines' communication is a 1-D
neighbour chain over sorted z-slabs, so a two-level (slices x chips)
topology is a rank ORDER: slice-major, rank i and i + 1 share a slice
except at the ``n_slices - 1`` slice boundaries.
"""
from __future__ import annotations

import numpy as np
import torch.distributed as dist

from ..constants import BOUNDARY_PARTICLE
from ..scene.scene import Scene
from .comm import Comm


def make_mesh(n_devices: int | None = None, backend: str | None = None,
              device="cuda") -> Comm:
    """The rank chain over the default process group's ranks, in rank
    order (a world of one when no group is initialized). ``n_devices``,
    when given, must be the group's size: ranks join a group when they
    start, so a chain over fewer of them is a smaller launch, not a
    slice. ``backend``, when given, must be the group's. ``device``: this
    rank's device (the card unless the caller names the CPU)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices not in (None, world):
        raise ValueError(f"a chain of {n_devices} ranks in a world of "
                         f"{world}: start {n_devices} ranks")
    return Comm(device=device, backend=backend)


def make_mesh2(n_slices: int, chips_per_slice: int,
               backend: str | None = None, device="cuda") -> Comm:
    """Two-level (slices x chips) chain for multi-host runs, flattened
    SLICE-MAJOR: rank k * chips_per_slice + c is chip c of slice k. A
    launcher numbers one host's ranks together, so the chain is the
    group's ranks in rank order; ``dcn_edges`` names the edges that cross
    a slice boundary."""
    return make_mesh(n_slices * chips_per_slice, backend=backend,
                     device=device)


def dcn_edges(n_slices: int, chips_per_slice: int) -> list[tuple[int, int]]:
    """The (rank, rank+1) halo-exchange edges that cross a slice boundary
    under the slice-major order of :func:`make_mesh2`."""
    return [
        (k * chips_per_slice - 1, k * chips_per_slice)
        for k in range(1, n_slices)
    ]


def pad_scene_to_devices(scene: Scene, n_devices: int) -> Scene:
    """Pad the particle count to a multiple of ``n_devices`` (bitwise
    ``sph_tpu``'s padding).

    Padding particles are frozen BOUNDARY particles parked on a line along
    the top-far box edge at r0-ish spacing so they don't stack in one cell.
    They carry the inward edge normal of that corner (like a real wall-edge
    particle) rather than a zero normal: a zero-normal boundary row would
    still inflate the Ihmsen w/w2 sums while contributing nothing to n_ci,
    biasing the position projection of any liquid that came within r0.
    """
    n = scene.n_particles
    pad = (-n) % n_devices
    if pad == 0:
        return scene
    x_hi = scene.pos[:, 0].max()
    y_hi = scene.pos[:, 1].max()
    z_lo = scene.pos[:, 2].min()
    z_hi = scene.pos[:, 2].max()
    zs = z_lo + (np.arange(pad) + 0.5) * (z_hi - z_lo) / pad
    ppos = np.stack(
        [np.full(pad, x_hi), np.full(pad, y_hi), zs], axis=1
    ).astype(np.float32)
    s = np.float32(-1.0 / np.sqrt(2.0))
    pnorm = np.tile(np.array([[s, s, 0.0]], np.float32), (pad, 1))
    return Scene(
        pos=np.concatenate([scene.pos, ppos]),
        vel=np.concatenate([scene.vel, np.zeros((pad, 3), np.float32)]),
        color=np.concatenate(
            [scene.color, np.full(pad, float(BOUNDARY_PARTICLE), np.float32)]
        ),
        normal=np.concatenate([scene.normal, pnorm]),
        spring_rows=scene.spring_rows,
        spring_idx=scene.spring_idx,
        spring_rest=scene.spring_rest,
        spring_type=scene.spring_type,
        tris=scene.tris,
        muscle_model=scene.muscle_model,
    )
