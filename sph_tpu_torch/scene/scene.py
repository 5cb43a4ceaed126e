"""Host-side scene container and device conversion.

Counterpart of ``sph_tpu/scene/scene.py``: the full initial condition in
NumPy, with ``device_state(device)`` building the torch state.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..constants import (
    BOUNDARY_PARTICLE,
    ELASTIC_PARTICLE,
    LIQUID_PARTICLE,
    MAX_MEMBRANES_PER_PARTICLE,
    MAX_NEIGHBORS,
    MUSCLE_COUNT,
)
from ..core.state import FluidState, Membranes, Springs
from ..core.step import SceneLayout


def _contiguous_range(ptype: np.ndarray, kind: int) -> tuple[int, int]:
    idx = np.nonzero(ptype == kind)[0]
    if len(idx) == 0:
        return (0, 0)
    lo, hi = int(idx[0]), int(idx[-1]) + 1
    if hi - lo != len(idx):
        raise ValueError(
            f"particles of type {kind} are not contiguous; "
            "class-sliced kernels require contiguous layout"
        )
    return (lo, hi)


@dataclasses.dataclass
class Scene:
    """Initial condition: positions in sim units, velocities in scaled SI."""

    pos: np.ndarray          # [N,3] f32
    vel: np.ndarray          # [N,3] f32
    color: np.ndarray        # [N]   f32 reference type codes (1.1, 2.2, 3 ...)
    normal: np.ndarray       # [N,3] f32 boundary normals

    # spring graph (rows aligned with spring_rows particle ids)
    spring_rows: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int32))
    spring_idx: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, MAX_NEIGHBORS), np.int32))
    spring_rest: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, MAX_NEIGHBORS), np.float32))
    spring_type: np.ndarray = dataclasses.field(  # float codes (5.2 etc.)
        default_factory=lambda: np.zeros((0, MAX_NEIGHBORS), np.float32))

    tris: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 3), np.int32))

    muscle_model: bool = False

    @property
    def ptype(self) -> np.ndarray:
        return self.color.astype(np.int32)

    @property
    def n_particles(self) -> int:
        return len(self.pos)

    @property
    def counts(self) -> dict:
        t = self.ptype
        return {
            "liquid": int((t == LIQUID_PARTICLE).sum()),
            "elastic": int((t == ELASTIC_PARTICLE).sum()),
            "boundary": int((t == BOUNDARY_PARTICLE).sum()),
            "springs": int((self.spring_idx >= 0).sum()),
            "membranes": len(self.tris),
        }

    def layout(self) -> SceneLayout:
        t = self.ptype
        return SceneLayout(
            n_particles=self.n_particles,
            liquid_range=_contiguous_range(t, LIQUID_PARTICLE),
            elastic_range=_contiguous_range(t, ELASTIC_PARTICLE),
            boundary_range=_contiguous_range(t, BOUNDARY_PARTICLE),
            muscle_model=self.muscle_model,
            springs_elastic_only=self._springs_elastic_only(),
            spring_slots=self._spring_slots(),
            springs_anchors_static=self._springs_anchors_static(),
        )

    def _springs_anchors_static(self) -> bool:
        """True when every spring endpoint is elastic or boundary."""
        if not len(self.spring_rows):
            return True
        t = self.ptype
        lq0, lq1 = _contiguous_range(t, LIQUID_PARTICLE)
        used = self.spring_idx[self.spring_idx >= 0]
        ends = np.concatenate([self.spring_rows, used])
        return not bool(((ends >= lq0) & (ends < lq1)).any())

    def _spring_slots(self) -> int:
        """Highest used partner slot + 1, rounded up to a multiple of 4;
        32 when there are no springs."""
        used = self.spring_idx >= 0
        if not used.any():
            return 32
        last = int(np.max(np.where(used, np.arange(used.shape[1]), -1))) + 1
        return -(-last // 4) * 4

    def _springs_elastic_only(self) -> bool:
        if not len(self.spring_rows):
            return True
        e0, e1 = _contiguous_range(self.ptype, ELASTIC_PARTICLE)
        idx = self.spring_idx
        used = idx[idx >= 0]
        rows_ok = bool(
            ((self.spring_rows >= e0) & (self.spring_rows < e1)).all()
        )
        return rows_ok and bool(((used >= e0) & (used < e1)).all())

    def particle_tris(self) -> np.ndarray:
        """Invert ``tris`` into the per-particle membrane list (first-free
        slot fill, capped at 7, indexed by absolute particle id)."""
        out = np.full(
            (self.n_particles, MAX_MEMBRANES_PER_PARTICLE), -1, np.int32
        )
        fill = np.zeros(self.n_particles, np.int32)
        for t_i, tri in enumerate(self.tris):
            for v in tri:
                if fill[v] < MAX_MEMBRANES_PER_PARTICLE:
                    out[v, fill[v]] = t_i
                    fill[v] += 1
        return out

    def device_state(self, device) -> tuple[FluidState, Springs, Membranes]:
        def t(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=device)

        state = FluidState(
            pos=t(self.pos, torch.float32),
            vel=t(self.vel, torch.float32),
            ptype=t(self.ptype, torch.int32),
            normal=t(self.normal, torch.float32),
            muscle_activation=torch.zeros(MUSCLE_COUNT, dtype=torch.float32,
                                          device=device),
            step=torch.zeros((), dtype=torch.int32, device=device),
        )
        springs = Springs(
            row_ids=t(self.spring_rows, torch.int32),
            idx=t(self.spring_idx, torch.int32),
            rest=t(self.spring_rest, torch.float32),
            muscle=t(self.spring_type.astype(np.int32), torch.int32),
        )
        membranes = Membranes(
            tris=t(self.tris, torch.int32),
            particle_tris=t(self.particle_tris(), torch.int32),
        )
        return state, springs, membranes
