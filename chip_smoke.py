#!/usr/bin/env python3
"""GPU smoke check of the PyTorch port (``sph_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--profile-steps N]

Phases (any failure raises and exits nonzero, printing no result):

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles the Hopper pair-pass kernels from ``sph_tpu_torch/ops/
   csrc`` (nvcc, sm_90a) and prints the build seconds;
3. kernel vs plain (small): a small box (8h, fill 0.5) is stepped until its
   pool rests on the floor; the packs and tables that one more sort + step
   hand to each pair pass, from that state with a seeded downward velocity
   kick (so the pool hits the walls), are recorded, and each kernel's
   outputs are held against its plain PyTorch version on the same inputs on
   the card: |diff| <= 1e-5 * max|plain| per output, the max taken over the
   components of the output's vector (both are f32 sums; only the summation
   order and FMA contraction differ, and one component of a vector sum may
   cancel to far below its terms), and some output of every pass nonzero;
4. engine vs plain: from phase 3's settled state with a gentler kick
   (0.3 m/s: the pool reaches the walls' r0 band and builds pressure at
   step 2, while 1-ulp differences stay below 1e-4 over 10 steps; phase
   3's 1 m/s kick amplifies them past it), the small box stepped 10 steps
   at resort_every 1 and 3 on cuda (kernels) and on cpu (plain versions),
   max |dpos| <= 1e-4, with the liquid's largest displacement printed
   beside it (the bound must be far below the motion);
5. main path: ``Simulator(generate_liquid_box_scene(SimParams()),
   engine="auto", device="cuda")`` (the 30h x 20h x 250h box), one resort
   period of warm-up, then 300 timed steps; checks finite state, walls
   bitwise still, liquid inside the box, no shell or tile overflow, the
   window drift within the shell's capture bound (displacement per resort
   period < dilate - 1 cells), and the per-step kernel launch counts
   (launches are counted over these 300 steps only). With
   ``--profile-steps N``, N more steps then run under torch.profiler and
   the device-time breakdown is printed;
6. kernel vs plain (full): phase 3's check on the inputs of one more step
   from the main path's final state with phase 3's kick, then both
   versions timed with CUDA events at those shapes.

Ends with a JSON line of per-kernel results and, last, the one-line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from sph_tpu_torch import SimParams
from sph_tpu_torch.constants import BOUNDARY_PARTICLE
from sph_tpu_torch.core import fastw as W
from sph_tpu_torch.ops import _build
from sph_tpu_torch.ops import pair_kernels as pk
from sph_tpu_torch.runtime import Simulator
from sph_tpu_torch.scene import generate_liquid_box_scene

H = 3.34
STEPS = 300
KERNEL_TOL = 1e-5
ENGINE_TOL = 1e-4
SETTLE = 300  # small-box steps before its kernel check: the pool is on the floor
# per-step launches of each kernel on the liquid box: rho* = 3 column sets
# x (time-t density + 3 PCISPH iterations); paccel = 2 x 3 iterations
PER_STEP = {"rho_star": 12, "paccel": 6, "viscsurf": 2, "boundary": 1}
# pass name -> kernel kind, per-step launches of that pass
PASSES = {
    "raw_mm": ("rho_star", 4), "raw_ms": ("rho_star", 4),
    "raw_sm": ("rho_star", 4), "visc_mm": ("viscsurf", 1),
    "visc_ms": ("viscsurf", 1), "pacc_mm": ("paccel", 3),
    "pacc_ms": ("paccel", 3), "bnd_ms": ("boundary", 1),
}
REPLACES = {
    "rho_star": "sph_tpu/ops/pair_kernels.py:878",
    "viscsurf": "sph_tpu/ops/pair_kernels.py:799",
    "paccel": "sph_tpu/ops/pair_kernels.py:926",
    "boundary": "sph_tpu/ops/pair_kernels.py:1075",
}
SOURCE = "sph_tpu_torch/ops/csrc/pair_pass.cu"


def check(ok, msg):
    if not ok:
        raise RuntimeError(msg)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0].strip()


def box_setup(params, fill, device, **cfg_kw):
    scene = generate_liquid_box_scene(params, fill_fraction=fill)
    layout = scene.layout()
    cfg = W.compute_fastw_config(scene.pos, params, layout,
                                 ptype=scene.ptype, device=device, **cfg_kw)
    ws = W.precompute_wall_static(scene.pos, scene.normal, params, layout,
                                  cfg)
    return scene, layout, cfg, ws


def kicked(state, speed=1.0, noise=0.3, seed=0):
    """``state`` with a seeded velocity kick of the moving particles: down at
    ``speed`` m/s (1 m/s is 2.5 sim units a step) with Gaussian ``noise``.
    At the defaults one step drives the pool's bottom layer into the walls'
    r0 band (the resting pool sits ~h above them and the boundary pass
    would sum zeros) and compresses it (nonzero pressure)."""
    rng = np.random.default_rng(seed)
    moving = (state.ptype != BOUNDARY_PARTICLE).cpu().numpy()
    kick = (rng.normal(0.0, noise, (int(moving.sum()), 3))
            + (0.0, -speed, 0.0))
    vel = state.vel.cpu().numpy().copy()
    vel[moving] += kick.astype(np.float32)
    return dataclasses.replace(
        state, vel=torch.as_tensor(vel, device=state.vel.device))


def to_device(obj, device):
    """A state dataclass with every tensor moved to ``device``."""
    return type(obj)(**{f.name: getattr(obj, f.name).to(device)
                        for f in dataclasses.fields(obj)})


def record_step_inputs(params, layout, cfg, ws, state, springs, membranes):
    """(pass, tables, own, slab) of the last call of each pair pass in one
    sort + one step of the fastw engine from ``state``."""
    parts = W._make_step_parts_w(params, layout, cfg, wall_static=ws)
    calls = W.record_step_inputs(parts, state, springs, membranes)
    check(set(calls) == set(PASSES), f"passes called: {sorted(calls)}")
    return calls


def compare(calls, label):
    """Kernel vs plain on each recorded pass; returns name -> max abs err."""
    errs = {}
    for name, (p, tables, own, slab) in sorted(calls.items()):
        k = p.kernel(tables, own, slab)
        r = p.plain(tables, own, slab)
        torch.cuda.synchronize()
        k = k if isinstance(k, tuple) else (k,)
        r = r if isinstance(r, tuple) else (r,)
        err = top = 0.0
        for i, (a, b) in enumerate(zip(k, r)):
            check(bool(torch.isfinite(a).all()), f"{label} {name}[{i}]: "
                  "kernel output not finite")
        for group in pk.OUTPUT_GROUPS[p.kind]:
            scale = max(float(r[i].abs().max()) for i in group)
            top = max(top, scale)
            for i in group:
                e = float((k[i] - r[i]).abs().max())
                check(e <= KERNEL_TOL * scale,
                      f"{label} {name}[{i}]: |kernel - plain| {e:.3e} > "
                      f"{KERNEL_TOL} * max|plain| {scale:.3e}")
                err = max(err, e)
        # all-zero outputs would make the comparison vacuous
        check(top > 0.0, f"{label} {name}: every output is zero")
        errs[name] = err
        print(f"  {label:5s} {name:8s} {p.kind:9s} blocks {p.n_blocks:4d} "
              f"ccol {p.ccol}: max|diff| {err:.3e}, max|plain| {top:.3e}",
              flush=True)
    return errs


def time_ms(fn, reps):
    """Mean device milliseconds per call, CUDA events around reps calls."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def engine_vs_plain(params, start, springs, membranes):
    """The engine on cuda (kernels) and on cpu (plain versions), 10 steps
    from ``start``."""
    moving = (start.ptype != BOUNDARY_PARTICLE).cpu().numpy()
    pos0 = start.pos.cpu().numpy()
    for r_every in (1, 3):
        pos, vel = {}, {}
        for dev in ("cuda", "cpu"):
            scene, layout, cfg, ws = box_setup(params, 0.5, dev,
                                               resort_every=r_every)
            run = W.make_fastw_multi_step(params, layout, cfg, 10,
                                          return_diag=True, wall_static=ws)
            out, diag = run(to_device(start, dev),
                            to_device(springs, dev),
                            to_device(membranes, dev))
            check(int(diag["shell_overflow"]) == 0
                  and int(diag["tile_overflow"]) == 0,
                  f"overflow on {dev}: {diag}")
            pos[dev] = out.pos.cpu().numpy()
            vel[dev] = out.vel.cpu().numpy()
        d = float(np.abs(pos["cuda"] - pos["cpu"]).max())
        dv = float(np.abs(vel["cuda"] - vel["cpu"]).max())
        moved = float(np.linalg.norm(pos["cpu"] - pos0, axis=1)[moving].max())
        print(f"  resort_every {r_every}: max|dpos| cuda vs cpu {d:.3e} "
              f"(max|dvel| {dv:.3e}); largest liquid displacement "
              f"{moved:.3e}", flush=True)
        check(np.isfinite(pos["cuda"]).all() and d <= ENGINE_TOL,
              f"engine cuda vs cpu max|dpos| {d} > {ENGINE_TOL}")
        check(moved > 100 * ENGINE_TOL,
              f"the liquid moved only {moved}: the check is vacuous")


def profile(sim, steps, card):
    """``steps`` main-path steps under torch.profiler: device busy share,
    the pair kernels' share of device time, top device and host ops."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.step(steps)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in events if e.device_type == cuda]
    dev_us = sum(e.self_device_time_total for e in kernels)
    pair_us = sum(e.self_device_time_total for e in kernels
                  if "pair_pass" in e.key)
    print(f"profile: {steps} steps, wall {wall_us / steps / 1e3:.4f} "
          f"ms/step (profiler on) [{card}]", flush=True)
    if dev_us == 0:
        print("  device time: not measured (the profiler recorded no CUDA "
              "kernels)", flush=True)
        return
    print(f"  device busy {dev_us / steps / 1e3:.4f} ms/step = "
          f"{dev_us / wall_us:.3f} of wall; pair kernels "
          f"{pair_us / steps / 1e3:.4f} ms/step = {pair_us / dev_us:.3f} "
          f"of device time; {len(kernels)} kernel names", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"  {e.self_device_time_total / steps:10.1f} us/step "
              f"{e.count / steps:6.1f} launches/step  {e.key[:90]}",
              flush=True)
    host = [e for e in events if e.device_type != cuda]
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:10]:
        print(f"  host {e.self_cpu_time_total / steps:10.1f} us/step "
              f"{e.count / steps:6.1f} calls/step  {e.key[:90]}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile-steps", type=int, default=0,
                    help="main-path steps to run under torch.profiler "
                         "after the timed run (0: none)")
    args = ap.parse_args(argv)

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device 0: {name}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    so, log = _build.build()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {so.name}",
          flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  " + line.strip(), flush=True)

    # 3. kernel vs plain on the small box, from its resting pool
    print("kernel vs plain:", flush=True)
    small = SimParams(x_max=8 * H, y_max=8 * H, z_max=8 * H)
    scene, layout, cfg, ws = box_setup(small, 0.5, "cuda")
    springs, membranes = scene.device_state("cuda")[1:]
    state = W.make_fastw_multi_step(small, layout, cfg, SETTLE,
                                    wall_static=ws)(
        scene.device_state("cuda")[0], springs, membranes)
    start = kicked(state)
    compare(record_step_inputs(small, layout, cfg, ws, start, springs,
                               membranes), "small")

    # 4. engine vs plain, from the settled state kicked gently
    print("engine vs plain (8h box, 10 steps from the settled state kicked "
          "down at 0.3 m/s):", flush=True)
    engine_vs_plain(small, kicked(state, speed=0.3, noise=0.05), springs,
                    membranes)

    # 5. main path
    params = SimParams()
    scene = generate_liquid_box_scene(params)
    sim = Simulator(scene, params, engine="auto", device="cuda")
    check(sim.engine == "fastw", f"auto resolved to {sim.engine}")
    n = scene.n_particles
    print(f"main path: {scene.counts}, n {n}, engine {sim.engine}, "
          f"cfg {sim._fast_cfg}", flush=True)
    sim.step(sim._fast_cfg.resort_every)           # warm-up period
    torch.cuda.synchronize()
    for k in pk.LAUNCHES:
        pk.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    sim.step(STEPS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(pk.LAUNCHES)
    ms_step = dt * 1e3 / STEPS
    pos, vel = sim.get_position(), sim.get_velocity()
    check(np.isfinite(pos).all() and np.isfinite(vel).all(),
          "non-finite state")
    b0, b1 = sim.layout.boundary_range
    check(np.array_equal(pos[b0:b1], scene.pos[b0:b1]), "walls moved")
    l0, l1 = sim.layout.liquid_range
    lo, hi = np.asarray(params.box_min), np.asarray(params.box_max)
    check(bool(((pos[l0:l1] >= lo) & (pos[l0:l1] <= hi)).all()),
          "liquid left the box")
    ovf = sim.check_overflow()
    check(ovf["shell_overflow"] == 0 and ovf["tile_overflow"] == 0,
          f"overflow: {ovf}")
    # the shell holds every wall within reach while no particle moves more
    # than dilate - 1 cells (h each) in a resort period; window_drift_h is
    # twice that displacement bound, in h
    shell_bound = sim._fast_cfg.dilate - 1
    check(ovf["window_drift_h"] / 2 < shell_bound,
          f"window drift {ovf['window_drift_h']} h: a particle may have "
          f"moved past the shell's {shell_bound}-cell capture bound")
    for kind, per in PER_STEP.items():
        check(launches[kind] == per * STEPS,
              f"{kind}: {launches[kind]} launches in {STEPS} steps, "
              f"expected {per * STEPS}")
    print(f"main path: {STEPS} steps in {dt:.3f} s: {ms_step:.4f} ms/step, "
          f"{n * 1e3 / ms_step:.6g} particle-steps/s, window drift "
          f"{ovf['window_drift_h']:.4f} h (shell bound {2 * shell_bound} h), "
          f"launches {launches} [{card}]", flush=True)
    if args.profile_steps > 0:
        profile(sim, args.profile_steps, card)

    # 6. kernel vs plain at the main path's shapes, from its final state
    full_calls = record_step_inputs(params, sim.layout, sim._fast_cfg,
                                    sim._wall_static, kicked(sim.state),
                                    sim.springs, sim.membranes)
    full_err = compare(full_calls, "full")
    per_kind = {k: dict(err=0.0, ms=0.0, plain_ms=0.0) for k in PER_STEP}
    for pname, (p, tables, own, slab) in sorted(full_calls.items()):
        kind, mult = PASSES[pname]
        ms = time_ms(lambda: p.kernel(tables, own, slab), 20)
        plain_ms = time_ms(lambda: p.plain(tables, own, slab), 3)
        print(f"  full  {pname:8s} kernel {ms:9.4f} ms  plain "
              f"{plain_ms:9.3f} ms  (x{mult}/step) [{card}]", flush=True)
        acc = per_kind[kind]
        acc["err"] = max(acc["err"], full_err[pname])
        acc["ms"] += mult * ms
        acc["plain_ms"] += mult * plain_ms

    kernels = [dict(
        name=kind, route="cuda", source=SOURCE, replaces=REPLACES[kind],
        launches=launches[kind], max_abs_err=per_kind[kind]["err"],
        ms=per_kind[kind]["ms"], plain_ms=per_kind[kind]["plain_ms"],
        ms_scope="one step's launches at the full-box shapes",
    ) for kind in PER_STEP]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
