"""High-level simulation driver (counterpart of
``sph_tpu/runtime/simulator.py``).

Owns the device state, steps the physics (the fast engines in chunks of
one resort period), surfaces the engine's overflow diagnostics loudly,
drives trajectory dumps every ``dump_interval`` steps (through the async
writer, ``runtime.async_io``), saves and restores checkpoints that load in
either package (``runtime.checkpoint``) and moves the resort period along
the adaptive ladder. The exact, fast, wall-compact (fastw) and multi-GPU
halo engines are ported; on the card the single-device fast engines replay
each resort period from a CUDA graph (``core.graphed``), one graph a period
length.

The halo engine (``parallel/halo.py``) shards the fast engine over the
ranks of the process group (a world of one without a group). Every rank
builds the Simulator from the same scene and makes the same calls: its
state holds the rank's rows, the getters and ``save`` gather every rank's
(collectives), ``save`` is written by rank 0 only and ``restore`` reads the
file on every rank.
"""
from __future__ import annotations

import dataclasses
import logging
import math

import numpy as np
import torch

from .. import trace
from ..config import SimParams
from ..constants import MUSCLE_COUNT
from ..scene.io import TrajectoryDumper
from ..scene.scene import Scene
from .checkpoint import load_checkpoint, save_checkpoint
from .timing import StepTimer

logger = logging.getLogger("sph_tpu_torch")


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
        dump_interval: int = 10,
        async_io: bool = True,
        drift_threshold_h: float = 0.25,
        distributed_resort: bool = False,
    ):
        """engine: "auto" (see :func:`resolve_auto_engine`), "exact" (the
        neighbour-list engine, the reference's nearest 32 within h;
        core/step.py), "fast" (the blocked pair engine, walls in the carry;
        core/fast.py), "fastw" (the wall-compact engine; core/fastw.py)
        or "halo" (the fast engine sharded over the process group's ranks
        with z-slab halo exchange, parallel/halo.py; pads the scene to
        ranks x block with frozen wall rows).
        device: a torch device; "cuda" runs the pair passes as Hopper
        kernels, "cpu" as their plain PyTorch versions (the halo engine:
        this rank's device). fast_config: keyword overrides for
        ``compute_fast_config`` (fast and halo:
        block/ccol/ccol_c/resort_every/sub) or ``compute_fastw_config``
        (fastw: block/ccol/ccol_c/resort_every/dilate/shell_margin).
        cuda_graph: on the card, the fast engines replay each resort
        period from a CUDA graph captured at its first step
        (``core.graphed``); False, or the CPU, steps the eager loop. The
        exact and halo engines have no graph (the halo engine's steps
        need collectives).

        distributed_resort (halo engine): the O(cells) distributed resort
        instead of the replicated all-gather one; ``check_overflow`` then
        reports ``resort_overflow`` too.

        dump_dir: write ``position_buffer.txt`` (and the spring and
        membrane buffers) there, a frame at step 0 and every
        ``dump_interval`` steps (``scene.io.TrajectoryDumper``). async_io
        (default True): frames and ``save(wait=False)`` checkpoints are
        written by a side thread (``runtime.async_io``), the device->host
        copy enqueued at submit; ``flush()`` drains it. False writes
        synchronously.

        adaptive_resort (fast/fastw engines): after each chunk longer than
        one step the simulator reads the chunk's pair-approach bound (2x
        the summed per-step max displacement, in h) and halves the resort
        period while it exceeds ``drift_threshold_h``, doubling it back
        when it falls below 0.4x the threshold. The period moves between
        resort_every, /2 and /4; on the card each level is one period
        graph. Costs one host read per chunk.

        The tracer (``sph_tpu_torch.trace``), when on, records the
        facade's spans (``sim.step``, ``sim.sync`` a blocking scalar read,
        ``sim.diag``, ``sim.read`` and ``sim.read.copy``,
        ``sim.check_overflow``, ``sim.dump``), its counters
        (``sim.host_syncs``, ``sim.read_bytes``) and device marks
        (``facade.eager`` for the diagnostics' maxima, ``read.copy`` for
        the copy into host memory)."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is "
                               "not available")
        self.params = params or SimParams()
        self.scene = scene
        self.layout = scene.layout()
        if engine == "auto":
            engine = resolve_auto_engine(self.layout)
        if engine not in ("exact", "fast", "fastw", "halo"):
            raise ValueError(f"unknown engine {engine!r}")
        self._cuda_graph = cuda_graph
        self.engine = engine
        self.dump_interval = dump_interval
        self._comm = None
        self._distributed_resort = bool(distributed_resort)

        fck = dict(fast_config or {})
        if engine == "halo":
            from ..core.fast import compute_fast_config
            from ..parallel import make_mesh, pad_scene_to_devices

            self._comm = make_mesh(device=self.device)
            ndev = self._comm.world
            # blocks must divide across the ranks
            fck["block_multiple"] = math.lcm(8, ndev)
            block = compute_fast_config(scene.pos, self.params, **fck).block
            scene = pad_scene_to_devices(scene, ndev * block)
            self.scene = scene
            self.layout = scene.layout()
        if engine == "exact":
            # Scene-derived cell capacity: the default silently truncates
            # neighbour candidates on dense scenes (the reference's failure
            # mode, sphFluid.cl:169); measure the real occupancy instead.
            from ..core.grid import measured_cell_capacity

            cap = measured_cell_capacity(scene.pos, self.params)
            if cap > self.params.cell_capacity:
                self.params = dataclasses.replace(self.params,
                                                  cell_capacity=cap)
        elif engine in ("fast", "halo"):
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
        self._adaptive = adaptive_resort and engine != "exact"
        self._drift_threshold_h = float(drift_threshold_h)
        if engine != "exact":
            # one resort period a chunk, so every chunk re-sorts exactly
            # once
            self._fast_chunk = max(1, self._fast_cfg.resort_every)
            self._fast_runs = {}
            # build the period runner now: a scene the engine cannot step
            # fails here, not at the first step
            self._fast_run_for(self._fast_chunk)
        if self._adaptive:
            # descending period ladder: resort_every, /2, /4 (>= 1)
            self._chunk_levels = sorted(
                {max(1, self._fast_chunk >> k) for k in range(3)},
                reverse=True)
        self.state, self.springs, self.membranes = scene.device_state(
            self.device)
        if self._comm is not None:
            from ..parallel import shard_state

            self.state = shard_state(self.state, self._comm)
        self._reset_diag()
        self.timer = StepTimer(device=self.device)
        # the files are written by one rank (rank 0 of the halo engine)
        self._writes = self._comm is None or self._comm.rank == 0
        self._dumping = bool(dump_dir)
        self._dumper = (TrajectoryDumper(dump_dir, scene)
                        if dump_dir and self._writes else None)
        self._writer = None
        if async_io:
            from .async_io import AsyncWriter

            self._writer = AsyncWriter()
        if self._dumping:
            self._dump_frame(check=False)

    def _reset_diag(self):
        z = torch.zeros((), dtype=torch.int32, device=self.device)
        self._shell_overflow = z
        self._tile_overflow = z
        self._window_drift = torch.zeros((), dtype=torch.float32,
                                         device=self.device)
        self._halo_overflow = self._resort_overflow = z

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
            self._fast_runs[n] = self._make_run(n, self.layout)
        return self._fast_runs[n]

    def _make_run(self, n: int, layout):
        """A new period runner of ``n`` steps for ``layout``; assigns
        nothing, so a layout the engine refuses raises with the Simulator
        unchanged."""
        if self.engine == "halo":
            return self._make_halo_run(n, layout)
        if self.engine == "fast":
            from ..core.fast import make_fast_multi_step

            fast_run = make_fast_multi_step(
                self.params, layout, self._fast_cfg, n,
                return_drift=True, cuda_graph=self._cuda_graph)

            def run(state, springs, membranes):
                out, drift = fast_run(state, springs, membranes)
                return out, dict(window_drift=drift)
            return run
        from ..core.fastw import make_fastw_multi_step

        return make_fastw_multi_step(
            self.params, layout, self._fast_cfg, n, return_diag=True,
            wall_static=self._wall_static, cuda_graph=self._cuda_graph)

    def _make_halo_run(self, n: int, layout):
        """The halo engine's runner: the scene-measured halo band and
        migration buffers, clamped to the rows of one rank (the overflow
        counts still surface any resort-time violation)."""
        from ..parallel import (make_halo_fast_multi_step, measure_halo_pad,
                                measure_migration_pad)

        cfg = self._fast_cfg
        per_dev = cfg.n_blocks // self._comm.world * cfg.block
        pos = self.scene.pos
        return make_halo_fast_multi_step(
            self._comm, self.params, layout, cfg, n,
            halo_pad=min(measure_halo_pad(pos, self.params, cfg), per_dev),
            distributed_resort=self._distributed_resort,
            mig_cap=min(measure_migration_pad(pos, self.params, cfg),
                        per_dev) if self._distributed_resort else None)

    def _run(self, n: int):
        if self.engine == "exact":
            from ..core.step import multi_step

            return multi_step(self.state, self.springs, self.membranes,
                              self.params, self.layout, n)
        # chunks of one resort period (+ single steps for the remainder),
        # so every chunk re-sorts exactly once, as in sph_tpu; the adaptive
        # ladder moves the period between chunks
        state = self.state
        remaining = n
        while remaining > 0:
            chunk = self._fast_chunk
            size = chunk if remaining >= chunk else 1
            state, diag = self._fast_run_for(size)(
                state, self.springs, self.membranes)
            remaining -= size
            # device-side max across chunks, no host sync (per chunk: the
            # drift of each resort period, as sph_tpu's _track_drift)
            with trace.span("sim.diag"), trace.mark("facade.eager",
                                                     self.device):
                for k in ("shell_overflow", "tile_overflow", "halo_overflow",
                          "resort_overflow", "window_drift"):
                    if k in diag:
                        setattr(self, "_" + k, torch.maximum(
                            getattr(self, "_" + k), diag[k]))
            self._last_drift = diag["window_drift"]
            if self._adaptive and size > 1:
                self._climb_ladder(chunk)
        # fastw's shell overflow = moving-wall pairs DROPPED (wrong forces
        # near the wall with no other signal) — loud at the run site: one
        # scalar host sync per user-level step() call
        ovf_s = self._sync(self._shell_overflow) if self.engine == "fastw" \
            else 0
        if ovf_s:
            logger.error(
                "fastw shell overflowed by %d wall row(s) by step %d — "
                "moving-wall pairs are being dropped; raise "
                "shell_margin/dilate in compute_fastw_config",
                ovf_s, int(state.step),
            )
        if self.engine == "halo":
            # particle LOSS is loud at the run site, not only in a pollable
            # diagnostic: the distributed resort drops rows that overrun its
            # migration buffers, and clipped halo windows drop pairs. Every
            # rank holds the same counts, so every rank logs
            ovf_r = self._sync(self._resort_overflow)
            if ovf_r:
                logger.error(
                    "distributed resort DROPPED %d particle(s) by step %d "
                    "(migration buffers overran mig_cap) — mass is lost; "
                    "raise mig_cap (see measure_migration_pad) or lower "
                    "resort_every", ovf_r, int(state.step))
            ovf_h = self._sync(self._halo_overflow)
            if ovf_h:
                logger.error(
                    "halo windows clipped %d row(s) by step %d — pairs are "
                    "being dropped; raise halo_pad (see measure_halo_pad)",
                    ovf_h, int(state.step))
        return state

    def _sync(self, value: torch.Tensor):
        """A device scalar read into host memory: a host sync, traced as
        ``sim.sync``; the stream is idle after it, so it anchors the
        tracer's device marks."""
        with trace.span("sim.sync"):
            trace.count("sim.host_syncs")
            out = value.item()
            trace.anchor(self.device)
        return out

    def _climb_ladder(self, chunk: int) -> None:
        """One scalar host read a chunk: the chunk's pair-approach bound
        decides the NEXT period (sph_tpu's rule, hysteresis included)."""
        ratio = 2.0 * self._sync(self._last_drift) / self.params.h
        lv = self._chunk_levels
        i = lv.index(chunk) if chunk in lv else 0
        if ratio > self._drift_threshold_h and i + 1 < len(lv):
            self._fast_chunk = lv[i + 1]
            logger.info("adaptive resort: drift bound %.2f h > %.2f — "
                        "period %d -> %d", ratio, self._drift_threshold_h,
                        chunk, lv[i + 1])
        elif ratio < 0.4 * self._drift_threshold_h and i > 0:
            # doubling the period roughly doubles the bound: step up only
            # when even 2x stays clearly under the threshold
            self._fast_chunk = lv[i - 1]

    def step(self, n: int = 1) -> None:
        """Advance n steps; with a ``dump_dir``, run to each dump boundary
        and dump a frame there (as sph_tpu does: an interval shorter than
        the resort period makes every chunk of the run shorter too)."""
        with trace.span("sim.step"):
            self._step(n)

    def _step(self, n: int) -> None:
        if not self._dumping:
            self.state = self._run(n)
            return
        done = 0
        while done < n:
            upto = min(
                n - done,
                self.dump_interval - self.step_count % self.dump_interval,
            )
            self.state = self._run(upto)
            done += upto
            if self.step_count % self.dump_interval == 0:
                self._dump_frame()

    def _dump_frame(self, check: bool = True) -> None:
        """Append the current positions to the trajectory; with ``check``,
        read the overflow diagnostics too (the positions are on the host
        then anyway)."""
        with trace.span("sim.dump"):
            self._dump(check)

    def _dump(self, check: bool) -> None:
        if self._writer is not None:
            # the frame's formatting overlaps the next chunk on the IO thread
            pos = self._full_state().pos
            if self._dumper:
                self._writer.submit(self._dumper.append, pos)
            if check:
                self.check_overflow()
        else:
            pos = self.get_position()
            if self._dumper:
                self._dumper.append(pos)
            if check:
                self.check_overflow(pos)

    def step_blocking(self, n: int = 1) -> float:
        """Step and wait for the device; returns wall-clock milliseconds."""
        self.timer.refresh()
        self.step(n)
        return self.timer.elapsed_ms

    def check_overflow(self, pos: np.ndarray | None = None) -> dict:
        """Read-and-reset diagnostics since the last check. The exact
        engine: ``cell_overflow``, particles beyond ``cell_capacity`` in
        their 2h cell at the current positions (dropped neighbour
        candidates). The fast engines: tile overflow (tiles the TPU
        kernels' static caps would drop: fastw counts its tables of every
        resort, fast the main tables at the current positions,
        ``tile_table_stats``, as sph_tpu does), fastw's shell overflow
        (dropped moving-wall pairs), and the worst per-resort-period
        pair-approach bound in units of h (2x the summed per-step max
        displacement). Warns on any overflow and on drift > 0.25 h. The
        halo engine: the fast engine's counts plus ``halo_overflow``
        (window bounds the halo band clipped: dropped pairs) and, with the
        distributed resort, ``resort_overflow`` (dropped particles).
        ``pos``: the current positions on the host, where the caller has
        them."""
        with trace.span("sim.check_overflow"):
            return self._check_overflow(pos)

    def _check_overflow(self, pos) -> dict:
        if pos is None and self.engine in ("exact", "fast", "halo"):
            pos = self.get_position()
        if self.engine == "exact":
            from ..core.grid import max_cell_occupancy

            out = {"cell_overflow": max(
                0, max_cell_occupancy(pos, self.params)
                - self.params.cell_capacity)}
            if out["cell_overflow"]:
                logger.warning(
                    "capacity overflow at step %d: %s — neighbour "
                    "candidates are being dropped; raise cell_capacity",
                    self.step_count, out)
            return out
        out = {"cell_overflow": 0}
        if self.engine == "halo":
            out["halo_overflow"] = int(self._halo_overflow)
            if self._distributed_resort:
                out["resort_overflow"] = int(self._resort_overflow)
        if self.engine in ("fast", "halo"):
            from ..core.fast import tile_caps, tile_table_stats

            cfg = self._fast_cfg
            tmax, ttot = tile_table_stats(pos, self.params, cfg)
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

    def _full_state(self):
        """The state of every particle (the halo engine: every rank's rows
        gathered; a collective, so every rank calls it)."""
        if self._comm is None:
            return self.state
        from ..parallel.sharded import gather_state

        return gather_state(self.state, self._comm)

    def get_position(self) -> np.ndarray:
        with trace.span("sim.read"):
            pos = self._full_state().pos
            with trace.span("sim.read.copy"), trace.mark("read.copy",
                                                         self.device):
                out = pos.cpu().numpy()
            trace.count("sim.read_bytes", out.nbytes)
            trace.anchor(self.device)
        return out

    def get_velocity(self) -> np.ndarray:
        return self._full_state().vel.cpu().numpy()

    def get_density(self) -> np.ndarray:
        return self.get_diagnostics()["rho"]

    def get_pressure(self) -> np.ndarray:
        return self.get_diagnostics()["pressure"]

    def get_diagnostics(self) -> dict:
        """The exact engine's neighbour search and PCISPH loop on the
        current state, on every engine (as in sph_tpu): rho, pressure,
        neighbor_count, neighbor_overflow, cell_overflow."""
        from ..core.step import diagnostics

        return {k: v.cpu().numpy() for k, v in diagnostics(
            self._full_state(), self.params).items()}

    def get_elastic_connections(self):
        """(partner ids, rest lengths, muscle ids), each [Ne, 32]."""
        return (self.springs.idx.cpu().numpy(),
                self.springs.rest.cpu().numpy(),
                self.springs.muscle.cpu().numpy())

    def get_membranes(self) -> np.ndarray:
        return self.membranes.tris.cpu().numpy()

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

    # ------------------------------------------------------------------
    # checkpoint / resume
    # ------------------------------------------------------------------

    def save(self, path: str, wait: bool = True) -> None:
        """Checkpoint the full state (atomic write; sph_tpu's npz keys).
        ``wait=False`` hands the write to the async IO thread (with
        ``async_io=True``): the device->host copy is enqueued now, the npz
        compression overlaps further stepping; call :meth:`flush` before
        reading the file. The halo engine gathers every rank's rows (every
        rank calls ``save``) and rank 0 writes."""
        args = (path, self._full_state(), self.springs, self.membranes)
        if not self._writes:
            return
        if not wait and self._writer is not None:
            self._writer.submit(save_checkpoint, *args,
                                color=self.scene.color)
            return
        save_checkpoint(*args, color=self.scene.color)

    def flush(self) -> None:
        """Drain pending async trajectory/checkpoint writes (re-raises
        any IO error from the worker thread)."""
        if self._writer is not None:
            self._writer.flush()

    def restore(self, path: str) -> None:
        """Continue from a checkpoint of either package. The engine's
        configuration, ``wall_static`` and period graphs were built from
        this Simulator's scene, so:

        (a) a checkpoint whose particle count, types (``ptype``) or
        ``normal`` differ, or whose walls (the boundary range's positions)
        sit elsewhere, raises ValueError naming what differs (its wall
        constants would be stale);
        (b) otherwise, where its springs or membranes differ, they replace
        this Simulator's and the period runners are built anew (the next
        step captures new graphs); springs the engine refuses (fastw:
        anchored to walls) raise, and the Simulator keeps its state,
        springs, membranes, layout and runners;
        (c) otherwise the Simulator keeps its own reference tensors and
        takes only ``pos``, ``vel``, ``muscle_activation`` and ``step``, so
        its period graphs replay on. The halo engine: every rank reads the
        file and keeps its own rows."""
        state, springs, membranes, color = load_checkpoint(path, "cpu")
        self._check_restorable(state)
        # everything that can fail is built before anything is assigned: a
        # refused checkpoint leaves the Simulator stepping its old state
        if self._comm is not None:
            from ..parallel import shard_state

            state = shard_state(state, self._comm)
        fields = {f: getattr(state, f).to(self.device)
                  for f in ("pos", "vel", "muscle_activation", "step")}
        if not (_same(springs, self.springs)
                and _same(membranes, self.membranes)):
            self._replace_elastic(springs, membranes)
        self.state = dataclasses.replace(self.state, **fields)
        if color is not None:
            self.scene.color = color

    def _check_restorable(self, state) -> None:
        sc = self.scene
        what = []
        if state.pos.shape != (sc.n_particles, 3):
            raise ValueError(
                f"checkpoint holds {state.pos.shape[0]} particles, this "
                f"Simulator's scene {sc.n_particles}")
        if not np.array_equal(state.ptype.numpy(), sc.ptype):
            what.append("ptype (the particle types and their ranges)")
        b0, b1 = self.layout.boundary_range
        if not np.array_equal(state.pos[b0:b1].numpy(), sc.pos[b0:b1]):
            what.append(f"the wall positions (rows {b0}:{b1})")
        if not np.array_equal(state.normal.numpy(),
                              np.asarray(sc.normal, np.float32)):
            what.append("normal")
        if what:
            raise ValueError(
                "checkpoint differs from the scene this Simulator's engine "
                f"was built from in {', '.join(what)}: its wall constants "
                "and period graphs would be stale; build a Simulator from "
                "the checkpoint's scene")

    def _replace_elastic(self, springs, membranes) -> None:
        """New springs or membranes: the layout's spring facts anew, the
        period runners dropped and the current one built. The layout, the
        moved tensors and the runner are built first and swapped in only
        when all exist: a scene the engine cannot step (fastw: springs
        anchored to walls) raises with the Simulator unchanged."""
        sc = self.scene
        layout = dataclasses.replace(
            sc, spring_rows=springs.row_ids.numpy(),
            spring_idx=springs.idx.numpy(),
            spring_rest=springs.rest.numpy(),
            spring_type=springs.muscle.numpy().astype(np.float32),
            tris=membranes.tris.numpy()).layout()
        springs, membranes = (
            dataclasses.replace(obj, **{
                f.name: getattr(obj, f.name).to(self.device)
                for f in dataclasses.fields(obj)})
            for obj in (springs, membranes))
        runs = ({} if self.engine == "exact" else
                {self._fast_chunk: self._make_run(self._fast_chunk, layout)})
        self.springs, self.membranes, self.layout = springs, membranes, layout
        if self.engine != "exact":
            self._fast_runs = runs


def _same(a, b) -> bool:
    """Two Springs (or Membranes) hold equal tensors, field for field."""
    return all(
        torch.equal(getattr(a, f.name), getattr(b, f.name).cpu())
        for f in dataclasses.fields(a))
