"""High-level simulation driver (counterpart of
``sph_tpu/runtime/simulator.py``).

Owns the device state, steps the physics (the fast engines in chunks of
one resort period), and surfaces the engine's overflow diagnostics loudly.
The exact, fast and wall-compact (fastw) engines are ported; on the card
the fast engines replay each resort period from a CUDA graph
(``core.graphed``). Trajectory dumps, checkpoints, the adaptive resort
ladder and the multi-GPU engine are not ported yet (ROADMAP Queue 1).
"""
from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from ..config import SimParams
from ..constants import MUSCLE_COUNT
from ..scene.scene import Scene
from .timing import StepTimer

logger = logging.getLogger("sph_tpu_torch")

# engines of sph_tpu not ported yet -> the feature that ports them
_NOT_PORTED = {
    "halo": "multi-GPU, ROADMAP Queue 1",
}


def resolve_auto_engine(layout) -> str:
    """engine="auto": the wall-compact fastw engine for scenes with >= 25 %
    frozen wall and elastic-only springs, the fast engine otherwise — the
    rule of ``sph_tpu``'s ``resolve_auto_engine`` on an accelerator. (That
    rule sends CPU runs to the exact engine because the Pallas kernels only
    run interpreted there; the port's CPU path is its plain PyTorch pair
    passes, so the rule does not depend on the device.)"""
    b0, b1 = layout.boundary_range
    wall_frac = (b1 - b0) / max(1, layout.n_particles)
    if wall_frac >= 0.25 and layout.springs_elastic_only:
        return "fastw"
    return "fast"


class Simulator:
    def __init__(
        self,
        scene: Scene,
        params: SimParams | None = None,
        engine: str = "auto",
        device="cuda",
        fast_config: dict | None = None,
        dump_dir: str | None = None,
        adaptive_resort: bool = False,
        cuda_graph: bool = True,
    ):
        """engine: "auto" (see :func:`resolve_auto_engine`), "exact" (the
        neighbour-list engine, the reference's nearest 32 within h;
        core/step.py), "fast" (the blocked pair engine, walls in the carry;
        core/fast.py) or "fastw" (the wall-compact engine; core/fastw.py);
        "halo" raises NotImplementedError naming its ROADMAP queue.
        device: a torch device; "cuda" runs the pair passes as Hopper
        kernels, "cpu" as their plain PyTorch versions. fast_config:
        keyword overrides for ``compute_fast_config`` (fast:
        block/ccol/ccol_c/resort_every/sub) or ``compute_fastw_config``
        (fastw: block/ccol/ccol_c/resort_every/dilate/shell_margin).
        cuda_graph: on the card, the fast engines replay each resort
        period from a CUDA graph captured at its first step
        (``core.graphed``); False, or the CPU, steps the eager loop. The
        exact engine has no graph."""
        if dump_dir is not None:
            raise NotImplementedError(
                "trajectory dumps: ROADMAP Queue 1 (trajectory I/O)")
        if adaptive_resort:
            raise NotImplementedError(
                "adaptive resort: ROADMAP Queue 1 (the adaptive resort "
                "ladder)")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is "
                               "not available")
        self.params = params or SimParams()
        self.scene = scene
        self.layout = scene.layout()
        if engine == "auto":
            engine = resolve_auto_engine(self.layout)
        if engine in _NOT_PORTED:
            raise NotImplementedError(
                f"engine {engine!r} is not ported yet: {_NOT_PORTED[engine]}")
        if engine not in ("exact", "fast", "fastw"):
            raise ValueError(f"unknown engine {engine!r}")
        self._cuda_graph = cuda_graph
        self.engine = engine

        fck = dict(fast_config or {})
        if engine == "exact":
            # Scene-derived cell capacity: the default silently truncates
            # neighbour candidates on dense scenes (the reference's failure
            # mode, sphFluid.cl:169); measure the real occupancy instead.
            from ..core.grid import measured_cell_capacity

            cap = measured_cell_capacity(scene.pos, self.params)
            if cap > self.params.cell_capacity:
                self.params = dataclasses.replace(self.params,
                                                  cell_capacity=cap)
        elif engine == "fast":
            from ..core.fast import compute_fast_config

            self._fast_cfg = compute_fast_config(scene.pos, self.params,
                                                 **fck)
        else:
            from ..core.fastw import (compute_fastw_config,
                                      precompute_wall_static)

            self._fast_cfg = compute_fastw_config(
                scene.pos, self.params, self.layout, ptype=scene.ptype,
                device=self.device, **fck)
            # walls never move: their sort + mutual density sums are
            # hoisted
            self._wall_static = precompute_wall_static(
                scene.pos, scene.normal, self.params, self.layout,
                self._fast_cfg)
        if engine != "exact":
            # one resort period a chunk, so every chunk re-sorts exactly
            # once
            self._fast_chunk = max(1, self._fast_cfg.resort_every)
            self._fast_runs = {}
            # build the period runner now: a scene the engine cannot step
            # fails here, not at the first step
            self._fast_run_for(self._fast_chunk)
        self.state, self.springs, self.membranes = scene.device_state(
            self.device)
        self._reset_diag()
        self.timer = StepTimer(device=self.device)

    def _reset_diag(self):
        z = torch.zeros((), dtype=torch.int32, device=self.device)
        self._shell_overflow = z
        self._tile_overflow = z
        self._window_drift = torch.zeros((), dtype=torch.float32,
                                         device=self.device)

    # ------------------------------------------------------------------
    # stepping
    # ------------------------------------------------------------------

    @property
    def step_count(self) -> int:
        return int(self.state.step)

    def _fast_run_for(self, n: int):
        """run(state, springs, membranes) -> (state, diag) over n steps;
        diag holds device tensors (fast: the window drift only)."""
        if n not in self._fast_runs:
            if self.engine == "fast":
                from ..core.fast import make_fast_multi_step

                fast_run = make_fast_multi_step(
                    self.params, self.layout, self._fast_cfg, n,
                    return_drift=True, cuda_graph=self._cuda_graph)

                def run(state, springs, membranes, _f=fast_run):
                    out, drift = _f(state, springs, membranes)
                    return out, dict(window_drift=drift)
            else:
                from ..core.fastw import make_fastw_multi_step

                run = make_fastw_multi_step(
                    self.params, self.layout, self._fast_cfg, n,
                    return_diag=True, wall_static=self._wall_static,
                    cuda_graph=self._cuda_graph,
                )
            self._fast_runs[n] = run
        return self._fast_runs[n]

    def _run(self, n: int):
        if self.engine == "exact":
            from ..core.step import multi_step

            return multi_step(self.state, self.springs, self.membranes,
                              self.params, self.layout, n)
        # chunks of one resort period (+ single steps for the remainder),
        # so every chunk re-sorts exactly once, as in sph_tpu
        state = self.state
        remaining = n
        while remaining > 0:
            size = self._fast_chunk if remaining >= self._fast_chunk else 1
            state, diag = self._fast_run_for(size)(
                state, self.springs, self.membranes)
            remaining -= size
            # device-side max across chunks, no host sync (per chunk: the
            # drift of each resort period, as sph_tpu's _track_drift)
            for k in ("shell_overflow", "tile_overflow", "window_drift"):
                if k in diag:
                    setattr(self, "_" + k, torch.maximum(
                        getattr(self, "_" + k), diag[k]))
        # fastw's shell overflow = moving-wall pairs DROPPED (wrong forces
        # near the wall with no other signal) — loud at the run site: one
        # scalar host sync per user-level step() call
        ovf_s = int(self._shell_overflow) if self.engine == "fastw" else 0
        if ovf_s:
            logger.error(
                "fastw shell overflowed by %d wall row(s) by step %d — "
                "moving-wall pairs are being dropped; raise "
                "shell_margin/dilate in compute_fastw_config",
                ovf_s, int(state.step),
            )
        return state

    def step(self, n: int = 1) -> None:
        """Advance n steps."""
        self.state = self._run(n)

    def step_blocking(self, n: int = 1) -> float:
        """Step and wait for the device; returns wall-clock milliseconds."""
        self.timer.refresh()
        self.step(n)
        return self.timer.elapsed_ms

    def check_overflow(self) -> dict:
        """Read-and-reset diagnostics since the last check. The exact
        engine: ``cell_overflow``, particles beyond ``cell_capacity`` in
        their 2h cell at the current positions (dropped neighbour
        candidates). The fast engines: tile overflow (tiles the TPU
        kernels' static caps would drop: fastw counts its tables of every
        resort, fast the main tables at the current positions,
        ``tile_table_stats``, as sph_tpu does), fastw's shell overflow
        (dropped moving-wall pairs), and the worst per-resort-period
        pair-approach bound in units of h (2x the summed per-step max
        displacement). Warns on any overflow and on drift > 0.25 h."""
        if self.engine == "exact":
            from ..core.grid import max_cell_occupancy

            out = {"cell_overflow": max(
                0, max_cell_occupancy(self.get_position(), self.params)
                - self.params.cell_capacity)}
            if out["cell_overflow"]:
                logger.warning(
                    "capacity overflow at step %d: %s — neighbour "
                    "candidates are being dropped; raise cell_capacity",
                    self.step_count, out)
            return out
        out = {"cell_overflow": 0}
        if self.engine == "fast":
            from ..core.fast import tile_caps, tile_table_stats

            cfg = self._fast_cfg
            tmax, ttot = tile_table_stats(self.get_position(), self.params,
                                          cfg)
            smax, per_block = tile_caps(cfg.ccol)
            out["tile_overflow"] = (max(0, tmax - smax)
                                    + max(0, ttot - cfg.n_blocks * per_block))
        else:
            out["shell_overflow"] = int(self._shell_overflow)
            out["tile_overflow"] = int(self._tile_overflow)
        out["window_drift_h"] = 2.0 * float(self._window_drift) / self.params.h
        self._reset_diag()
        bad = {k: v for k, v in out.items()
               if k.endswith("overflow") and v > 0}
        if bad:
            logger.warning(
                "capacity overflow at step %d: %s — pair candidates are "
                "being dropped; rebuild with larger capacities",
                self.step_count, bad,
            )
        if out["window_drift_h"] > 0.25:
            logger.warning(
                "window drift %.2f h within a resort period at step %d — "
                "marginal pairs may be missed; lower resort_every for "
                "these dynamics", out["window_drift_h"], self.step_count,
            )
        return out

    # ------------------------------------------------------------------
    # state API
    # ------------------------------------------------------------------

    def get_position(self) -> np.ndarray:
        return self.state.pos.cpu().numpy()

    def get_velocity(self) -> np.ndarray:
        return self.state.vel.cpu().numpy()

    def get_density(self) -> np.ndarray:
        return self.get_diagnostics()["rho"]

    def get_pressure(self) -> np.ndarray:
        return self.get_diagnostics()["pressure"]

    def get_diagnostics(self) -> dict:
        """The exact engine's neighbour search and PCISPH loop on the
        current state, on every engine (as in sph_tpu): rho, pressure,
        neighbor_count, neighbor_overflow, cell_overflow."""
        from ..core.step import diagnostics

        return {k: v.cpu().numpy()
                for k, v in diagnostics(self.state, self.params).items()}

    def get_muscle_activation(self) -> np.ndarray:
        return self.state.muscle_activation.cpu().numpy()

    def set_muscle_activation(self, values) -> None:
        """Manual override of the activation vector (shorter inputs are
        zero-padded). Only meaningful when the scene's wave model is off,
        otherwise the next step overwrites it."""
        act = np.zeros(MUSCLE_COUNT, np.float32)
        values = np.asarray(values, np.float32).ravel()
        act[: len(values)] = values
        self.state = dataclasses.replace(
            self.state,
            muscle_activation=torch.as_tensor(act, device=self.device))

    def save(self, path: str, wait: bool = True) -> None:
        raise NotImplementedError("checkpoints: ROADMAP Queue 1 "
                                  "(checkpoints)")

    def restore(self, path: str) -> None:
        raise NotImplementedError("checkpoints: ROADMAP Queue 1 "
                                  "(checkpoints)")
