"""A cell's inputs: the configuration's scene and the seeded jitter of its
liquid's velocities, one set for the program and the reference alike.

The scene comes from the program's own generator named in the
configuration (``scene.generator`` in ``sph_tpu_torch.scene.worm``), at the
configuration's parameters; the run checks its counts against those the
configuration states. The seed moves only the liquid's initial velocities,
uniform in [-amplitude, amplitude] m/s on each axis, drawn on the run's
device in one call: no count, size or rest length depends on it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

LIQUID = 1


def sim_params(config: dict):
    from sph_tpu_torch.config import SimParams

    p = dict(config["params"])
    p["gravity"] = tuple(p["gravity"])
    return SimParams(**p)


def make_scene(config: dict, seed: int, device):
    """The program's Scene for ``config`` with the seed's liquid velocities
    (host arrays, as ``Simulator`` takes them)."""
    from sph_tpu_torch.scene import worm

    gen = config["scene"]
    scene = getattr(worm, gen["generator"])(sim_params(config),
                                            **gen.get("args", {}))
    counts = {k: int(v) for k, v in scene.counts.items()}
    if counts != config["counts"]:
        raise RuntimeError(f"the generated scene's counts {counts} are not "
                           f"the configuration's {config['counts']}")
    liquid = np.flatnonzero(scene.ptype == LIQUID)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    amp = float(config["jitter_m_s"])
    jitter = (torch.rand((len(liquid), 3), generator=g, device=device)
              * (2 * amp) - amp)
    vel = scene.vel.copy()
    vel[liquid] = jitter.cpu().numpy()
    return dataclasses.replace(scene, vel=vel)


def topology_arrays(scene) -> dict:
    """What the reference needs of the scene besides positions and
    velocities, as host arrays."""
    return dict(ptype=scene.ptype, normal=scene.normal,
                spring_rows=scene.spring_rows, spring_idx=scene.spring_idx,
                spring_rest=scene.spring_rest, spring_type=scene.spring_type,
                tris=scene.tris, muscle_model=scene.muscle_model)
