"""The port's headline benchmark: PCISPH particle-steps/sec on the full worm
scene, on one CUDA card (counterpart of the repository's ``bench.py``).

    python -m sph_tpu_torch.bench

Prints ONE JSON line on stdout, always:

  {"metric": "pcisph_particle_steps_per_sec_worm", "value": N,
   "unit": "particle-steps/s/chip", "vs_baseline": N, "compile_s": N,
   "engine": "..."[, "reason": "..."]}

``vs_baseline`` divides the value by the north-star target of
``BASELINE.json``, 5e7 particle-steps/s/chip: a target, not a speed any
chip has reached. ``compile_s`` is the first chunk's seconds (the kernel
build, when the library is not cached, the first resort and the capture of
the period's CUDA graph).

Configuration: the full worm from ``generate_worm_scene(SimParams())``
(231,811 particles) on the values of ``results/r5/best_config.json``,
carried here as defaults (``BEST``; its TPU-only DMA ``depth`` has no
counterpart): engine fastw, block 256, ccol 512, ccol_c 256, resort_every
30. ``SPH_BENCH_ENGINE`` (fastw, fast or exact) and ``SPH_BENCH_SUB`` (the
fast engine's subgroup size) override them. Chunks of 30 steps (one resort
period each, replayed from one CUDA graph on the card) on the host clock,
each ending in a device synchronise: one untimed chunk, then at least 5
timed chunks within a 90 s budget, then the fast engines continue to step
500 for the integrity gate.

Physics gates (a failure zeroes the value):
  1. ``gate_box_equivalence``: the measured engine against the port's exact
     engine on a 2,744-particle box, 10 steps, on the same device:
     max |dpos| <= 1e-4 at resort_every 1 and <= 5e-3 at resort_every 3
     (the stale-window envelope).
  2. ``gate_worm_integrity`` after ~500 steps: finite state, max spring
     strain < 0.5, mean liquid rho/rho0 in [0.5, 2] from the exact engine's
     ``diagnostics``.

No engine fallback: where ``bench.py`` retries a failed fastw run on the
fast engine and then on the exact one, a failure of the configured engine
here emits 0.0 with the error as the reason, so a number is never
published from an engine other than the one named.

No CPU number: without CUDA the line carries 0.0 and a reason, unless
``SPH_BENCH_FORCE=1`` (then it runs on the CPU). A watchdog emits the zero
line and exits if the run overruns ``SPH_BENCH_WATCHDOG_S`` (default 1200
s); ``main()`` starts it, importing this module runs nothing.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback

import numpy as np
import torch

TARGET = 50e6  # particle-steps/s/chip north-star target (BASELINE.json)
# results/r5/best_config.json (the TPU-only DMA ring depth left out)
BEST = dict(engine="fastw", block=256, ccol=512, ccol_c=256, resort_every=30)
CHUNK = 30
BUDGET_S = 90.0
GATE_STEPS = 500

_emitted = threading.Event()


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def emit(value, reason=None, **extra):
    """Print THE json line exactly once (watchdog and main path race)."""
    if _emitted.is_set():
        return
    _emitted.set()
    rec = {
        "metric": "pcisph_particle_steps_per_sec_worm",
        "value": round(float(value), 1),
        "unit": "particle-steps/s/chip",
        "vs_baseline": round(float(value) / TARGET, 4),
    }
    rec.update(extra)
    if reason:
        rec["reason"] = reason
    print(json.dumps(rec), flush=True)


def _watchdog(limit_s):
    emit(0.0, reason=f"watchdog: bench exceeded {limit_s:.0f}s wall budget")
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def probe_cuda():
    """None if one tiny op runs right on the card, else the reason."""
    try:
        x = torch.ones((128, 128), dtype=torch.float32, device="cuda")
        v = float((x @ x).sum())
    except Exception as e:
        return f"CUDA probe failed: {type(e).__name__}: {str(e)[:200]}"
    if v != 128.0 ** 3:
        return f"CUDA probe computed {v}, expected {128.0 ** 3}"
    return None


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def gate_box_scene(params):
    """(box params, scene) of the box gate: a 14^3 lattice at 1.25 r0
    spacing (2,744 particles, jittered, small random velocities) in a 10h
    box, seeded; the spacing keeps every particle under the exact engine's
    32-neighbour cap, where the all-pairs engines and exact agree."""
    from .config import SimParams
    from .scene.scene import Scene

    h = params.h
    p = SimParams(x_max=10 * h, y_max=10 * h, z_max=10 * h,
                  cell_capacity=96)
    rng = np.random.default_rng(7)
    r0 = p.r0 * 1.25
    ax = np.arange(14) * r0
    g = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
    pos = (2.0 + g + rng.uniform(-0.05, 0.05, g.shape) * r0).astype(
        np.float32)
    vel = rng.normal(scale=0.05, size=pos.shape).astype(np.float32)
    return p, Scene(pos=pos, vel=vel,
                    color=np.full(len(pos), 1.1, np.float32),
                    normal=np.zeros_like(pos))


def gate_box_equivalence(params, sub=None, engine="fastw", device="cuda"):
    """The measured engine against the port's exact engine on the gate box,
    10 steps on ``device``: resort_every 1 (fresh windows every step, the
    exact engine's own rebuild rate) within 1e-4, and resort_every 3 (stale
    windows) within 5e-3."""
    from .core.step import multi_step

    p, scene = gate_box_scene(params)
    layout = scene.layout()
    state, springs, membranes = scene.device_state(device)
    ref = multi_step(state, springs, membranes, p, layout, 10)
    if engine == "fastw":
        from .core.fastw import (compute_fastw_config, make_fastw_multi_step,
                                 precompute_wall_static)

        def build(r_every):
            cfg = compute_fastw_config(scene.pos, p, layout,
                                       ptype=scene.ptype, device=device,
                                       resort_every=r_every)
            return make_fastw_multi_step(
                p, layout, cfg, 10,
                wall_static=precompute_wall_static(
                    scene.pos, scene.normal, p, layout, cfg))
    else:
        from .core.fast import compute_fast_config, make_fast_multi_step

        def build(r_every):
            cfg = compute_fast_config(scene.pos, p, sub=sub,
                                      resort_every=r_every)
            return make_fast_multi_step(p, layout, cfg, 10)

    ok_all = True
    for r_every, bound, what in ((1, 1e-4, f"{engine}-vs-exact"),
                                 (3, 5e-3, "stale-window")):
        out = build(r_every)(state, springs, membranes)
        d = float((out.pos - ref.pos).abs().max())
        ok = bool(np.isfinite(d)) and d <= bound
        ok_all = ok_all and ok
        log(f"# GATE box {what} ({len(scene.pos)} particles, 10 steps, "
            f"resort_every={r_every}, sub={sub}, {device}): "
            f"max|dpos|={d:.2e} (<= {bound:g}) -> "
            f"{'PASS' if ok else 'FAIL'}")
    return ok_all


def gate_worm_integrity(scene, params, state):
    """Invariants after ~500 steps: finite, springs hold, density sane."""
    from .core.step import diagnostics

    pos = state.pos.cpu().numpy()
    ok = bool(np.isfinite(pos).all())
    strain = 0.0
    if len(scene.spring_rows):
        idx = scene.spring_idx
        used = idx >= 0
        a = pos[np.repeat(scene.spring_rows, idx.shape[1])[used.ravel()]]
        b = pos[idx[used]]
        r = np.linalg.norm(a - b, axis=1) * params.simulation_scale
        rest = scene.spring_rest[used]
        strain = float(np.max(np.abs(r - rest) / np.maximum(rest, 1e-9)))
        ok = ok and strain < 0.5
    rho = diagnostics(state, params)["rho"].cpu().numpy()
    lq0, lq1 = scene.layout().liquid_range
    mean_rho = float(rho[lq0:lq1].mean() if lq1 > lq0 else rho.mean())
    ok = ok and 0.5 * params.rho0 <= mean_rho <= 2.0 * params.rho0
    log(f"# GATE worm integrity (step {int(state.step)}): "
        f"max strain={strain:.3f} (<0.5), mean liquid rho/rho0="
        f"{mean_rho / params.rho0:.3f} (in [0.5,2.0]) -> "
        f"{'PASS' if ok else 'FAIL'}")
    return ok


def run_engine(engine, scene, params, chunk, budget_s, device, sub=None,
               block=256, ccol=512, ccol_c=256, resort_every=30):
    """(timed steps, their wall seconds, first-chunk seconds, end state)."""
    state, springs, membranes = scene.device_state(device)
    layout = scene.layout()
    diag = {}
    if engine == "fastw":
        from .core.fastw import (compute_fastw_config, make_fastw_multi_step,
                                 precompute_wall_static)

        cfg = compute_fastw_config(scene.pos, params, layout,
                                   ptype=scene.ptype, device=device,
                                   block=block, ccol=ccol, ccol_c=ccol_c,
                                   resort_every=resort_every)
        run = make_fastw_multi_step(
            params, layout, cfg, chunk, return_diag=True,
            wall_static=precompute_wall_static(
                scene.pos, scene.normal, params, layout, cfg))

        def advance(s):
            s, d = run(s, springs, membranes)
            for k, v in d.items():
                diag[k] = torch.maximum(diag[k], v) if k in diag else v
            return s
    elif engine == "fast":
        from .core.fast import compute_fast_config, make_fast_multi_step

        cfg = compute_fast_config(scene.pos, params, sub=sub, block=block,
                                  ccol=ccol, ccol_c=ccol_c,
                                  resort_every=resort_every)
        run = make_fast_multi_step(params, layout, cfg, chunk)

        def advance(s):
            return run(s, springs, membranes)
    elif engine == "exact":
        from .core.step import multi_step

        def advance(s):
            return multi_step(s, springs, membranes, params, layout, chunk)
    else:
        raise ValueError(f"unknown engine {engine!r}")

    t0 = time.time()
    state = advance(state)
    _sync(device)
    compile_s = time.time() - t0

    from .ops import pair_kernels as pk

    for k in pk.LAUNCHES:
        pk.LAUNCHES[k] = 0
    steps = 0
    t0 = time.time()
    while steps < 5 * chunk and time.time() - t0 < budget_s:
        state = advance(state)
        _sync(device)
        steps += chunk
    wall = time.time() - t0
    log(f"# pair-kernel launches in the {steps} timed steps: "
        + json.dumps({k: v for k, v in pk.LAUNCHES.items() if v}))

    # continue toward GATE_STEPS for the integrity gate, wall-bounded and
    # on the fast engines only (the exact engine is the slow reference)
    done = steps + chunk
    if engine in ("fast", "fastw"):
        t_gate = time.time()
        while done < GATE_STEPS and time.time() - t_gate < 2 * budget_s:
            state = advance(state)
            done += chunk
        _sync(device)
        if done < GATE_STEPS:
            log(f"# integrity continuation wall-bounded at step {done}")
    if diag:
        log("# fastw diagnostics over the run: "
            + ", ".join(f"{k}={float(v):.4g}" for k, v in diag.items()))
    return steps, wall, compile_s, state


def _bench() -> int:
    force = os.environ.get("SPH_BENCH_FORCE", "") == "1"
    if torch.cuda.is_available():
        err = probe_cuda()
        if err is not None:
            log(f"# {err}")
            emit(0.0, reason=err)
            return 0
        device = "cuda"
        log(f"# device: {torch.cuda.get_device_name(0)}")
    elif force:
        device = "cpu"
        log("# no CUDA device; SPH_BENCH_FORCE=1: running on the CPU")
    else:
        reason = ("no CUDA device (torch.cuda.is_available() is False) — "
                  "the metric is per-chip; refusing to publish a CPU number")
        log(f"# {reason}")
        emit(0.0, reason=reason)
        return 0

    engine = os.environ.get("SPH_BENCH_ENGINE", BEST["engine"])
    sub_env = os.environ.get("SPH_BENCH_SUB", "0")
    sub = int(sub_env) if sub_env.isdigit() and int(sub_env) > 0 else None
    cfg = {k: v for k, v in BEST.items() if k != "engine"}
    log(f"# config: engine={engine} sub={sub} {cfg}")
    try:
        from .config import SimParams
        from .scene import generate_worm_scene

        params = SimParams()
        t0 = time.time()
        scene = generate_worm_scene(params)
        build_s = time.time() - t0
        n = scene.n_particles
        try:
            steps, wall, compile_s, end_state = run_engine(
                engine, scene, params, CHUNK, BUDGET_S, device, sub=sub,
                **cfg)
        except Exception as e:
            traceback.print_exc(file=sys.stderr)
            reason = (f"{engine} engine failed: {type(e).__name__}: "
                      f"{str(e)[:200]}")
            log(f"# {reason} — no fallback to another engine")
            emit(0.0, reason=reason, engine=engine)
            return 0

        gate_ok = True
        try:
            gate_ok = gate_worm_integrity(scene, params, end_state)
            if engine in ("fast", "fastw"):
                gate_ok = gate_box_equivalence(
                    params, sub=sub, engine=engine, device=device) and gate_ok
        except Exception:
            traceback.print_exc(file=sys.stderr)
            log("# GATE crashed -> FAIL")
            gate_ok = False

        pps = n * steps / wall
        log(f"# worm scene ({engine} engine): {n} particles {scene.counts}; "
            f"build {build_s:.1f}s, first chunk {compile_s:.1f}s, {steps} "
            f"steps in {wall:.3f}s ({wall / steps * 1e3:.4f} ms/step), "
            f"device={device}")
        extra = dict(compile_s=round(compile_s, 1), engine=engine)
        if not gate_ok:
            log("# PHYSICS GATE FAILED — metric zeroed")
            emit(0.0, reason="physics gate failed", **extra)
            return 0
        emit(pps, **extra)
        return 0
    except Exception as e:
        traceback.print_exc(file=sys.stderr)
        emit(0.0, reason=f"bench crashed: {type(e).__name__}: {str(e)[:200]}",
             engine=engine)
        return 0


def main() -> int:
    limit_s = float(os.environ.get("SPH_BENCH_WATCHDOG_S", "1200"))
    watchdog = threading.Timer(limit_s, _watchdog, args=(limit_s,))
    watchdog.daemon = True
    watchdog.start()
    # one parallel CPU op first: on some hosts the first parallel op of a
    # process that takes a square root has returned low-precision results
    torch.rand(1 << 20).mul_(2.0)
    try:
        return _bench()
    finally:
        watchdog.cancel()


if __name__ == "__main__":
    sys.exit(main())
