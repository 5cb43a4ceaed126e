"""True checkpoint/resume (counterpart of ``sph_tpu/runtime/checkpoint.py``).

A checkpoint is the complete simulation state (positions, velocities,
types, normals, muscle phase, step counter, spring graph, membranes, scene
colors) in one npz archive, so a restored run continues bit for bit. The
keys and dtypes are sph_tpu's (:data:`KEYS`), so a checkpoint written by
either package loads in the other: that is how a ``sph_tpu`` state becomes
this package's state, and the reverse.
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import MUSCLE_COUNT
from ..core.state import FluidState, Membranes, Springs
from .async_io import save_npz_atomic

# the archive's keys, in sph_tpu's order; ``color`` and ``extra_<name>``
# are optional
KEYS = ("pos", "vel", "ptype", "normal", "muscle_activation", "step",
        "spring_rows", "spring_idx", "spring_rest", "spring_muscle",
        "tris", "particle_tris")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_checkpoint(
    path: str,
    state: FluidState,
    springs: Springs,
    membranes: Membranes,
    color: np.ndarray | None = None,
    extra: dict | None = None,
) -> None:
    """Write the archive atomically (``.npz`` appended where missing). The
    fields may be tensors on any device or NumPy arrays."""
    values = (state.pos, state.vel, state.ptype, state.normal,
              state.muscle_activation, state.step, springs.row_ids,
              springs.idx, springs.rest, springs.muscle, membranes.tris,
              membranes.particle_tris)
    payload = {k: _np(v) for k, v in zip(KEYS, values)}
    if color is not None:
        payload["color"] = _np(color)
    for k, v in (extra or {}).items():
        payload[f"extra_{k}"] = _np(v)
    # atomic: a crash mid-write (or a kill while the async IO thread is
    # saving) can never leave a truncated archive at the target path
    save_npz_atomic(path if path.endswith(".npz") else path + ".npz",
                    **payload)


def load_checkpoint(path: str, device="cuda"):
    """Returns (state, springs, membranes, color-or-None), the tensors on
    ``device`` in this package's dtypes."""
    z = np.load(path)

    def t(key, dtype, default=None):
        a = z[key] if key in z else default
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    f32, i32 = torch.float32, torch.int32
    state = FluidState(
        pos=t("pos", f32), vel=t("vel", f32), ptype=t("ptype", i32),
        normal=t("normal", f32),
        muscle_activation=t("muscle_activation", f32,
                            np.zeros(MUSCLE_COUNT, np.float32)),
        step=t("step", i32),
    )
    springs = Springs(row_ids=t("spring_rows", i32), idx=t("spring_idx", i32),
                      rest=t("spring_rest", f32),
                      muscle=t("spring_muscle", i32))
    membranes = Membranes(tris=t("tris", i32),
                          particle_tris=t("particle_tris", i32))
    color = z["color"] if "color" in z else None
    return state, springs, membranes, color
