"""One run of one cell: set-up, the window (traced or not), the metrics, the
check, and the result line."""
from __future__ import annotations

import subprocess
import sys
import time

import numpy as np

from . import check, inputs, spec, trace, window

# modules whose presence after the window refuses the run (compared by the
# whole top-level name: the program's package name begins with the last)
FORBIDDEN = ("jax", "jaxlib", "flax", "sph_tpu")


def forbidden_modules() -> list:
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def power_limit_w():
    """The card's power limit in watts as ``nvidia-smi`` reads it, or None
    where it cannot."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20, check=True)
        return float(out.stdout.splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def setup(cfg: dict, seed: int, dev, k: int, marks: dict | None = None):
    """(scene, Simulator, the first frame, whether it failed): the inputs,
    ``Simulator(scene)`` as the configuration builds it, and one frame of
    ``k`` steps, which captures the period graph the window replays.
    ``marks``: receives the clock after each part (``import``, ``scene``,
    ``simulator``, ``first_frame``)."""
    import torch
    from sph_tpu_torch.runtime.simulator import Simulator

    marks = {} if marks is None else marks
    marks["import"] = time.perf_counter()
    scene = inputs.make_scene(cfg, seed, dev)
    marks["scene"] = time.perf_counter()
    sim = Simulator(scene, inputs.sim_params(cfg), engine=cfg["engine"],
                    device=dev, fast_config=cfg.get("fast_config"))
    marks["simulator"] = time.perf_counter()
    if sim.engine != cfg["expect_engine"]:
        raise RuntimeError(f"engine {sim.engine!r} resolved, the "
                           f"configuration states {cfg['expect_engine']!r}")
    start = sim.state
    sim.step(k)
    pos = sim.get_position()
    first = window.Frame(start, sim.state, pos)
    failed = (not np.isfinite(pos).all()) or window.overflow_failed(
        sim.check_overflow(pos))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    marks["first_frame"] = time.perf_counter()
    return scene, sim, first, failed


def run_cell(root, workload: str, seed: int, seconds: float, traced: bool,
             t0: float, device_name: str = "cuda", log=None):
    """(exit code, result dict or None). ``t0``: the process's first
    clock reading, from which set-up is timed. ``device_name`` "cpu" (the
    harness's tests) skips the look for a card."""
    import torch

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cell = spec.load_cell(root, workload)
    dev = torch.device(device_name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            log("benchmark: CUDA is not available")
            return 2, None
        if torch.cuda.device_count() < cell.chips:
            log(f"benchmark: {workload} needs {cell.chips} card(s), "
                f"{torch.cuda.device_count()} found")
            return 2, None
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    cfg, traffic = cell.config, cell.traffic
    k = int(traffic["steps_per_frame"])

    marks = {}
    scene, sim, first, first_failed = setup(cfg, seed, dev, k, marks)
    setup_s = time.perf_counter() - t0
    # set-up by part, in seconds (for the records: no metric)
    setup_parts, last = {}, t0
    for part, t in marks.items():
        setup_parts[part] = t - last
        last = t

    # ---- the window ----
    sampler = window.Sampler(int(traffic["check_frames"]), seed)
    rec = dict(setup_s=setup_s, n_particles=scene.n_particles)
    if not traced:
        w = window.run(sim, k, seconds=seconds, sampler=sampler)
        frames_run, failed = len(w.arrivals), w.failed
        rec.update(arrivals=w.arrivals, window_wall_s=w.arrivals[-1],
                   frames=len(w.arrivals), steps=len(w.arrivals) * k)
    else:
        # the user's loop under the profiler; then as many frames again,
        # unprofiled, with the card drained before each read, which the
        # host clock times: the copy, not the wait for the period
        n = int(traffic["trace_frames"])
        tw, prof = trace.profiled(
            lambda span: window.run(sim, k, frames=n, sampler=sampler,
                                    span=span), dev)
        rec.update(trace.summarise(prof))
        w = window.run(sim, k, frames=n, sampler=sampler, sync=sync)
        rec.update(read_ms=[1e3 * s for s in w.reads],
                   pair_kernels=spec.data("pair_kernels.txt", cell.bench_dir),
                   peaks=spec.data("peaks.json", cell.bench_dir))
        frames_run = len(tw.arrivals) + len(w.arrivals)
        failed = tw.failed + w.failed
        rec.update(frames=len(tw.arrivals), steps=len(tw.arrivals) * k)
    if window.close(sim, w):
        failed = frames_run            # dropped pairs: every frame fails
    peak = int(torch.cuda.max_memory_allocated()) if dev.type == "cuda" \
        else 0
    if traced:
        from . import work

        rec["work"] = work.count(
            torch.as_tensor(w.last_pos, device=dev),
            torch.as_tensor(scene.ptype, device=dev).long(),
            torch.as_tensor(scene.spring_idx, device=dev).long(),
            work.in_triangles(scene.tris, scene.n_particles, dev),
            float(cfg["params"]["h"]))

    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        v = cell.reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # ---- the check, on the card once the program's state is freed ----
    frames = check.frames_for_check((scene.pos, scene.vel), first, w.sample)
    attempted = frames_run
    del sim, first, w, sampler
    t_check = time.perf_counter()
    numbers = check.judge(frames, k, inputs.topology_arrays(scene),
                          cfg["params"], dev)
    check_s = time.perf_counter() - t_check
    limits = cell.limits
    correct = (check.verdict(numbers, limits) and failed == 0
               and not first_failed)

    bad = forbidden_modules()
    if bad:
        log(f"benchmark: the process loaded {', '.join(bad)}; no result")
        return 3, None

    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
              "count": cell.chips, "memory_peak_bytes": peak}
    if dev.type == "cuda":
        device["power_limit_w"] = power_limit_w()
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": device}
    if traced:
        device.update(busy_s=rec["busy_s"], window_s=rec["window_s"])
        result["breakdown"] = {"device_ops": rec["device_ops"],
                               "idle_gaps": rec["idle_gaps"]}
    result["setup_parts"] = setup_parts
    result["checked_frames"] = len(frames)
    result["check_s"] = check_s
    # each number beside its limit; null where the frames gave no number
    # (no row of that set) or where a number has no limit
    checks = {n: {"value": numbers.get(n), "limit": limits.get(n)}
              for n in list(limits) + [n for n in numbers if n not in limits]}
    checks["failed_frames"] = {"value": failed + int(first_failed),
                               "limit": 0}
    result["checks"] = checks
    for n, c in checks.items():
        log(f"check {n}: {c['value']!r} limit {c['limit']!r}")
    return 0, result
