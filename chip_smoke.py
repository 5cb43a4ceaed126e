#!/usr/bin/env python3
"""GPU smoke check of the PyTorch port (``sph_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--profile-steps N] [--only PHASE,...]

Phases (any failure raises and exits nonzero, printing no result):

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles the Hopper pair-pass kernels from ``sph_tpu_torch/ops/
   csrc`` (nvcc, sm_90a) and prints the build seconds;
3. kernel vs plain (small): a small box (8h, fill 0.5) is stepped until its
   pool rests on the floor; the packs and tables that one more sort + step
   hand to each pair pass, from that state with a seeded downward velocity
   kick (so the pool hits the walls), are recorded, and each kernel's
   outputs are held against its plain PyTorch version on the same inputs on
   the card: |diff| <= 1e-5 * the pass's own rounding scale per output
   (``PairPass.rounding_scale``: the largest row sum of the absolute pair
   terms, a factor that vanishes at its cutoff counted at the cutoff's
   magnitude), the max taken over the components of the output's vector
   (both are f32 sums; only the summation order and FMA contraction differ,
   and one component of a vector sum may cancel to far below its terms).
   Every output vector of every pass must reach 100 times its tolerance, or
   the check is vacuous and fails;
4. engine vs plain: from phase 3's settled state with a gentler kick
   (0.3 m/s: the pool reaches the walls' r0 band and builds pressure at
   step 2, while 1-ulp differences stay below 1e-4 over 10 steps; phase
   3's 1 m/s kick amplifies them past it), the small box stepped 10 steps
   at resort_every 1 and 3 on cuda (kernels) and on cpu (plain versions),
   max |dpos| <= 1e-4, with the liquid's largest displacement printed
   beside it (the bound must be far below the motion);
5. liquid-box path: ``Simulator(generate_liquid_box_scene(SimParams()),
   engine="auto", device="cuda")`` (the 30h x 20h x 250h box), 210 steps of
   warm-up (the pool settles on the floor, which phase 6 needs), then 120
   timed steps (whole resort periods, 330 steps in all); checks finite
   state, walls bitwise still, liquid inside the box, no shell or tile overflow, the
   window drift within the shell's capture bound (displacement per resort
   period < dilate - 1 cells), and the per-step kernel launch counts
   (launches are counted over these 120 steps only);
6. kernel vs plain (full box): phase 3's check on the inputs of one more
   step from the box path's final state with phase 3's kick, then both
   versions timed with CUDA events at those shapes;
7. kernel vs plain (reduced worm): the worm at full length in a narrower
   pool (10h x 20h x 108h: every spring anchor stays elastic, which the
   engine requires) is stepped 60 steps on the card, so the muscles are
   active and liquid touches the membrane; all ten pass instances are held
   against their plain versions as in phase 3 (the spring and membrane
   inputs from the state as it is, the liquid passes from the kicked
   state). The spring inputs must hold nonzero activation terms and the
   membrane inputs a liquid-elastic pair within r0 whose column counts two
   or more triangles (both counts are printed), or the check is vacuous;
8. engine vs plain (reduced worm): 10 steps from that state at
   resort_every 1 and 3 on cuda and on cpu, max |dpos| <= 1e-4, the
   largest elastic displacement printed beside it;
9. main path: ``Simulator(generate_worm_scene(SimParams()), engine="auto",
   device="cuda")``, the full worm in the 30h x 20h x 250h pool, one resort
   period of warm-up re-sorted at every step (the start-up transient moves
   particles more than a cell in 30 steps) and held to the shell's capture
   bound like the rest, then 500 timed steps. Checks: finite state, walls
   bitwise still, no shell or tile overflow, drift within the shell's
   capture bound, exactly 12 rho*, 6 paccel, 2 viscsurf, 1 boundary,
   1 spring and 1 membrane launch a step, and the worm integrity gate of
   ``bench.py``: max spring strain < 0.5 over every spring, mean liquid
   rho/rho0 in [0.5, 2] from the engine's own time-t density sums, muscle
   activation equal to the wave model's at the last step and not all zero.
   With ``--profile-steps N``, N more steps then run under torch.profiler
   and the device-time breakdown is printed;
10. kernel vs plain (full worm): phase 7's check and counts on the main
   path's final state, the spring launch's shared-memory size (above
   48 KB: the opt-in branch), then all six kernels and their plain
   versions timed with CUDA events at those shapes, beside each kernel's
   bound: the candidate pairs its tables list (tiles x tile width x real
   own rows) x the functor's operations a pair (for the spring and membrane
   passes what this run's data needs, see ``PAIR_FLOPS``) over the card's
   f32 rate, against its input and output bytes over the card's memory
   rate.

``--only`` runs the named phases alone (small: 3-4, box: 5-6, rworm: 7,
rworm_engine: 8, worm: 9-10) while iterating; the run then prints no result
lines and exits 2.

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
from scipy.spatial import cKDTree

from sph_tpu_torch.constants import (BOUNDARY_PARTICLE, ELASTIC_PARTICLE,
                                     LIQUID_PARTICLE)
from sph_tpu_torch.core import fastw as W
from sph_tpu_torch.models import muscle
from sph_tpu_torch.ops import _build
from sph_tpu_torch.ops import pair_kernels as pk
from sph_tpu_torch.runtime import Simulator
from sph_tpu_torch.scene import (generate_liquid_box_scene,
                                 generate_worm_scene)

H = 3.34
BOX_STEPS = 120
BOX_WARMUP = 210  # untimed box steps: by step 330 the pool is on the floor
WORM_STEPS = 500
WORM_SETTLE = 60  # reduced-worm steps before its checks
KERNEL_TOL = 1e-5
# an output vector must reach this many times its tolerance in its own pass
MIN_SIGNAL = 100.0
ENGINE_TOL = 1e-4
REST_GAP = 0.93  # a settled pool's lowest liquid above the floor, in h
SETTLE = 300  # small-box steps before its kernel check: the pool is on the floor
# per-step launches of each kernel: rho* = 3 column sets x (time-t density
# + 3 PCISPH iterations); paccel = 2 x 3 iterations; the liquid box has no
# elastic matter and runs no spring or membrane pass
PER_STEP_BOX = {"rho_star": 12, "paccel": 6, "viscsurf": 2, "boundary": 1,
                "spring": 0, "membrane": 0}
PER_STEP = dict(PER_STEP_BOX, spring=1, membrane=1)
# pass name -> kernel kind, per-step launches of that pass
PASSES = {
    "raw_mm": ("rho_star", 4), "raw_ms": ("rho_star", 4),
    "raw_sm": ("rho_star", 4), "visc_mm": ("viscsurf", 1),
    "visc_ms": ("viscsurf", 1), "pacc_mm": ("paccel", 3),
    "pacc_ms": ("paccel", 3), "bnd_ms": ("boundary", 1),
    "spring_ms": ("spring", 1), "mem_ms": ("membrane", 1),
}
ELASTIC_PASSES = ("spring_ms", "mem_ms")
BOX_PASSES = set(PASSES) - set(ELASTIC_PASSES)
REPLACES = {
    "rho_star": "sph_tpu/ops/pair_kernels.py:878",
    "viscsurf": "sph_tpu/ops/pair_kernels.py:799",
    "paccel": "sph_tpu/ops/pair_kernels.py:926",
    "boundary": "sph_tpu/ops/pair_kernels.py:1075",
    "spring": "sph_tpu/ops/pair_kernels.py:1020",
    "membrane": "sph_tpu/ops/pair_kernels.py:1118",
}
SOURCE = "sph_tpu_torch/ops/csrc/pair_pass.cu"
# The card's published peaks (H100 SXM data sheet): f32 outside the tensor
# cores, device memory rate.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
# f32 operations of one candidate pair in each functor of pair_pass.cu,
# counted by hand from its pair() (a compare, min/max, sqrt, rsqrt and a
# division count one each). The four liquid passes charge every candidate
# pair the whole functor. The two elastic passes do work that depends on
# the data, and are charged what this run's data needs: spring one id
# compare a slot for every candidate pair, the sums (3 a matched slot, 28 a
# pair) for the springs the slab lists; membrane the distance test (12) for
# every candidate pair and the 7-triangle side test and sums (7 x 24 + 12)
# for the pairs within r0.
PAIR_FLOPS = {"rho_star": 13, "viscsurf": 25, "paccel": 29, "boundary": 22}
SPRING_MATCH_FLOPS = 3 + 28
MEMBRANE_TEST_FLOPS, MEMBRANE_NEAR_FLOPS = 12, 7 * 24 + 12
# the reduced worm: full length in a narrower pool, every spring anchor
# elastic (a lower or tighter box anchors the worm's springs to the walls)
REDUCED_WORM = dict(x_max=10 * H, y_max=20 * H, z_max=108 * H)


def check(ok, msg):
    if not ok:
        raise RuntimeError(msg)


def box_edge(params) -> float:
    """The longest box edge: real particles lie below it, pad rows and pad
    columns of the packs beyond."""
    return max(params.x_max, params.y_max, params.z_max)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0].strip()


def scene_setup(scene, params, device, **cfg_kw):
    layout = scene.layout()
    cfg = W.compute_fastw_config(scene.pos, params, layout,
                                 ptype=scene.ptype, device=device, **cfg_kw)
    ws = W.precompute_wall_static(scene.pos, scene.normal, params, layout,
                                  cfg)
    return scene, layout, cfg, ws


def kicked(state, speed=1.0, noise=0.3, seed=0, rest_gap=None):
    """``state`` with a seeded velocity kick of the moving particles: down at
    ``speed`` m/s (1 m/s is 2.5 sim units a step) with Gaussian ``noise``.
    At the defaults one step drives the pool's bottom layer into the walls'
    r0 band (the resting pool sits ~h above them and the boundary pass
    would sum zeros) and compresses it (nonzero pressure). A pool that has
    not settled yet (it takes ~300 steps) is first lowered as a whole, with
    everything else that moves, until its lowest liquid particle sits
    ``rest_gap`` above the floor walls, where a settled pool rests."""
    rng = np.random.default_rng(seed)
    ptype = state.ptype.cpu().numpy()
    moving = ptype != BOUNDARY_PARTICLE
    kick = (rng.normal(0.0, noise, (int(moving.sum()), 3))
            + (0.0, -speed, 0.0))
    vel = state.vel.cpu().numpy().copy()
    vel[moving] += kick.astype(np.float32)
    pos = state.pos.cpu().numpy().copy()
    if rest_gap is not None:
        gap = (pos[ptype == LIQUID_PARTICLE, 1].min()
               - pos[~moving, 1].min())
        pos[moving, 1] -= np.float32(max(0.0, gap - rest_gap))
    dev = state.vel.device
    return dataclasses.replace(state, vel=torch.as_tensor(vel, device=dev),
                               pos=torch.as_tensor(pos, device=dev))


def to_device(obj, device):
    """A state dataclass with every tensor moved to ``device``."""
    return type(obj)(**{f.name: getattr(obj, f.name).to(device)
                        for f in dataclasses.fields(obj)})


def record_step_inputs(params, layout, cfg, ws, state, springs, membranes):
    """(pass, tables, own, slab) of the last call of each pair pass in one
    sort + one step of the fastw engine from ``state``; a fifth entry, where
    present, flags the own rows whose outputs the engine uses. On a scene with
    elastic matter the spring and membrane inputs come from ``state`` as it
    is and the liquid passes' from the kicked state (see ``kicked``)."""
    parts = W._make_step_parts_w(params, layout, cfg, wall_static=ws)
    calls = W.record_step_inputs(
        parts, kicked(state, rest_gap=REST_GAP * params.h), springs,
        membranes)
    expect = BOX_PASSES
    if layout.n_elastic > 0:
        expect = set(PASSES)
        ctx = {}
        still = W.record_step_inputs(parts, state, springs, membranes,
                                     ctx_out=ctx)
        calls.update({k: still[k] for k in ELASTIC_PASSES})
        # the engine applies the membrane sums to liquid rows only. On an
        # elastic row that is a vertex of the column's triangle the side
        # s = n . (x - a) is rounding noise around 0 and its sign, hence the
        # sum, is undefined: such rows are not compared
        p = calls["mem_ms"][0]
        calls["mem_ms"] += (ctx["liq_s"][:p.n_pad] > 0,)
    check(set(calls) == expect, f"passes called: {sorted(calls)}")
    return calls


def elastic_input_counts(params, calls, label):
    """The counts that make the spring and membrane checks non-vacuous:
    nonzero activation terms in the spring slab, and pairs of a liquid own
    row and an elastic column within r0 (new positions) whose column counts
    >= 1 and >= 2 triangles.
    The pairs come from a k-d tree on the host: within r0 is within the
    block's window, so the tables list them. Returns the data-dependent
    work of the two passes for ``pass_bound``: the springs the slab lists,
    and the pairs of any real own row and an elastic column within r0."""
    p, _, _, slab = calls["spring_ms"][:4]
    n_act = int((slab[3 + 2 * p.n_slots:] != 0).sum())
    n_springs = int((slab[3:3 + p.n_slots] >= 0).sum())
    p, tables, own, slab, liquid = calls["mem_ms"]
    far = box_edge(params)
    own_all = own[3:6, :p.n_pad].T.cpu().numpy().astype(np.float64)
    own_n = own_all[liquid.cpu().numpy()]
    m = slab.cpu().numpy().astype(np.float64)
    cols = np.nonzero(m[pk.PMM_XN] < far)[0]
    col_tree = cKDTree(m[pk.PMM_XN:pk.PMM_ZN + 1, cols].T)
    n_near = int(cKDTree(own_all[own_all[:, 0] < far]).count_neighbors(
        col_tree, float(params.r0)))
    pairs = cKDTree(own_n).query_ball_tree(col_tree, float(params.r0))
    ii = np.repeat(np.arange(len(pairs)), [len(q) for q in pairs])
    jj = cols[np.concatenate([np.asarray(q, np.int64) for q in pairs])]
    cnt = np.zeros(len(ii))
    for t in range(pk.MEM_TRIS):
        nt, at = m[6 * t:6 * t + 3, jj], m[6 * t + 3:6 * t + 6, jj]
        side = ((own_n[ii].T - at) * nt).sum(0)
        cnt += ((nt * nt).sum(0) > 0) & (side != 0)
    n1, n2 = int((cnt >= 1).sum()), int((cnt >= 2).sum())
    print(f"  {label:5s} spring slab: {n_act} nonzero activation terms; "
          f"membrane: {len(ii)} liquid-elastic pairs within r0, {n1} with "
          f"cnt >= 1, {n2} with cnt >= 2; membrane blocks with tiles "
          f"{int((tables[4] > 0).sum())} of {p.n_blocks}", flush=True)
    check(n_act > 0, f"{label}: no nonzero activation term in the spring "
          "inputs")
    check(n2 > 0, f"{label}: no membrane pair with cnt >= 2")
    return dict(spring=n_springs, membrane=n_near)


def pass_bound(p, tables, own, slab, far, data_work):
    """(candidate pairs, bound ms, "operations" | "bytes") of one launch:
    pairs = sum over blocks of tiles x tile width x real own rows (pad rows
    sit beyond ``far``); operations = pairs x the functor's count (see
    ``PAIR_FLOPS``; ``data_work`` holds the elastic passes' data-dependent
    pair counts) over the card's f32 peak; bytes = the pack rows the pass
    reads, its tables and its outputs, each once, over the card's memory
    rate."""
    n_out, own_rows, slab_rows = pk._rows(p)
    ob = int(tables[5][0])
    real = (own[0, ob:ob + p.n_pad] < far).reshape(p.n_blocks, p.block)
    pairs = int((tables[4].long() * real.sum(1)).sum()) * p.ccol
    nbytes = 4 * (slab_rows * slab.shape[1] + n_out * p.n_pad
                  + sum(t.numel() for t in tables))
    if own.data_ptr() != slab.data_ptr():
        nbytes += 4 * own_rows * p.n_pad
    if p.kind == "spring":
        ops = pairs * p.n_slots + data_work["spring"] * SPRING_MATCH_FLOPS
    elif p.kind == "membrane":
        ops = (pairs * MEMBRANE_TEST_FLOPS
               + data_work["membrane"] * MEMBRANE_NEAR_FLOPS)
    else:
        ops = pairs * PAIR_FLOPS[p.kind]
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    return pairs, max(t_ops, t_bytes), by


def compare(calls, label, far):
    """Kernel vs plain on each recorded pass; returns name -> max abs err
    over the real own rows. The tolerance of an output vector is KERNEL_TOL
    x the largest rounding scale (``PairPass.rounding_scale``) its
    components reach on the pass's real own rows, and the vector's largest
    magnitude there must be MIN_SIGNAL tolerances or more: a pass whose
    pairs are all marginal fails as vacuous. Pad rows (beyond ``far``; they
    pair with the pad columns at distance 0 and would dominate both maxima)
    are held to KERNEL_TOL x their own row's scale where that is larger."""
    errs = {}
    for name, (p, tables, own, slab, *used) in sorted(calls.items()):
        outs = [p.kernel(tables, own, slab), p.plain(tables, own, slab),
                p.rounding_scale(tables, own, slab)]
        torch.cuda.synchronize()
        k, r, scale = (o if isinstance(o, tuple) else (o,) for o in outs)
        for i, a in enumerate(k):
            check(bool(torch.isfinite(a).all()), f"{label} {name}[{i}]: "
                  "kernel output not finite")
        ob = int(tables[5][0])
        real = own[0, ob:ob + p.n_pad] < far
        if used:                       # rows whose sums are defined
            keep = used[0]
            k, r, scale = ([a[keep] for a in o] for o in (k, r, scale))
            real = real[keep]
        err = top = 0.0
        signal = float("inf")
        for group in pk.OUTPUT_GROUPS[p.kind]:
            row_scale = torch.stack([scale[i] for i in group]).amax(0)
            tol = KERNEL_TOL * float(row_scale[real].max())
            mag = max(float(r[i][real].abs().max()) for i in group)
            check(mag > 0.0 and mag >= MIN_SIGNAL * tol,
                  f"{label} {name}{list(group)}: max|plain| {mag:.3e} < "
                  f"{MIN_SIGNAL:g} * tolerance {tol:.3e}: vacuous")
            row_tol = torch.clamp(KERNEL_TOL * row_scale, min=tol)
            for i in group:
                d = (k[i] - r[i]).abs()
                check(bool((d <= row_tol).all()),
                      f"{label} {name}[{i}]: |kernel - plain| "
                      f"{float(d[real].max()):.3e} on real rows, tolerance "
                      f"{tol:.3e}; {float((d / row_tol).max()):.3g} "
                      "tolerances on some row")
                err = max(err, float(d[real].max()))
            top = max(top, mag)
            signal = min(signal, mag / tol)
        errs[name] = err
        print(f"  {label:5s} {name:9s} {p.kind:9s} blocks {p.n_blocks:4d} "
              f"ccol {p.ccol}: max|diff| {err:.3e}, max|plain| {top:.3e}, "
              f"least max|plain| / tolerance {signal:.3g}", flush=True)
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


def engine_vs_plain(scene, params, start, springs, membranes,
                    kind=LIQUID_PARTICLE, what="liquid"):
    """The engine on cuda (kernels) and on cpu (plain versions), 10 steps
    from ``start``; the largest displacement of the particles of ``kind``
    is printed beside the difference."""
    moving = (start.ptype == kind).cpu().numpy()
    pos0 = start.pos.cpu().numpy()
    for r_every in (1, 3):
        pos, vel = {}, {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            _, layout, cfg, ws = scene_setup(scene, params, dev,
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
            print(f"    {dev}: {time.perf_counter() - t0:.1f} s", flush=True)
        d = float(np.abs(pos["cuda"] - pos["cpu"]).max())
        dv = float(np.abs(vel["cuda"] - vel["cpu"]).max())
        moved = float(np.linalg.norm(pos["cpu"] - pos0, axis=1)[moving].max())
        print(f"  resort_every {r_every}: max|dpos| cuda vs cpu {d:.3e} "
              f"(max|dvel| {dv:.3e}); largest {what} displacement "
              f"{moved:.3e}", flush=True)
        check(np.isfinite(pos["cuda"]).all() and d <= ENGINE_TOL,
              f"engine cuda vs cpu max|dpos| {d} > {ENGINE_TOL}")
        check(moved > 100 * ENGINE_TOL,
              f"the {what} moved only {moved}: the check is vacuous")


def check_capture(sim, label):
    """Reads and resets the simulator's diagnostics: no shell or tile
    overflow, drift inside the shell's capture bound. Returns the report."""
    ovf = sim.check_overflow()
    check(ovf["shell_overflow"] == 0 and ovf["tile_overflow"] == 0,
          f"{label}: overflow: {ovf}")
    # the shell holds every wall within reach while no particle moves more
    # than dilate - 1 cells (h each) in a resort period; window_drift_h is
    # twice that displacement bound, in h
    shell_bound = sim._fast_cfg.dilate - 1
    check(ovf["window_drift_h"] / 2 < shell_bound,
          f"{label}: window drift {ovf['window_drift_h']} h: a particle "
          f"may have moved past the shell's {shell_bound}-cell capture "
          "bound")
    return ovf


def check_run(sim, scene, steps, launches, per_step, label):
    """The checks every driven path shares: finite state, walls bitwise
    still, no overflow, drift inside the shell's capture bound, the exact
    per-step launch counts. Returns the overflow report."""
    pos, vel = sim.get_position(), sim.get_velocity()
    check(np.isfinite(pos).all() and np.isfinite(vel).all(),
          f"{label}: non-finite state")
    b0, b1 = sim.layout.boundary_range
    check(np.array_equal(pos[b0:b1], scene.pos[b0:b1]),
          f"{label}: walls moved")
    ovf = check_capture(sim, label)
    for kind, per in per_step.items():
        check(launches[kind] == per * steps,
              f"{label} {kind}: {launches[kind]} launches in {steps} steps, "
              f"expected {per * steps}")
    return ovf


def timed_run(sim, steps):
    """(seconds, launches by kind) of ``steps`` steps ending in a device
    synchronize, the launch counts set to 0 just before."""
    torch.cuda.synchronize()
    for k in pk.LAUNCHES:
        pk.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    sim.step(steps)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, dict(pk.LAUNCHES)


def worm_integrity(sim, scene, params):
    """The worm gate of ``bench.py``: springs hold (max strain < 0.5 over
    every spring) and the liquid's mean density is sane (rho/rho0 in
    [0.5, 2]); the density is the engine's own time-t sum (one sort + the
    raw rho* passes on the final state)."""
    pos = sim.get_position()
    idx = scene.spring_idx
    used = idx >= 0
    a = pos[np.repeat(scene.spring_rows, idx.shape[1])[used.ravel()]]
    r = np.linalg.norm(a - pos[idx[used]], axis=1) * params.simulation_scale
    rest = scene.spring_rest[used]
    strain = float(np.max(np.abs(r - rest) / np.maximum(rest, 1e-9)))
    parts = W._make_step_parts_w(params, sim.layout, sim._fast_cfg,
                                 wall_static=sim._wall_static)
    rho = parts.density(sim.state, sim.springs, sim.membranes).cpu().numpy()
    l0, l1 = sim.layout.liquid_range
    check(np.isfinite(rho[l0:l1]).all(), "liquid density not finite")
    ratio = float(rho[l0:l1].mean()) / params.rho0
    print(f"  integrity at step {sim.step_count}: max strain {strain:.4f} "
          f"(< 0.5) over {int(used.sum())} springs, mean liquid rho/rho0 "
          f"{ratio:.4f} (in [0.5, 2])", flush=True)
    check(strain < 0.5, f"max spring strain {strain} >= 0.5")
    check(0.5 <= ratio <= 2.0, f"mean liquid rho/rho0 {ratio} not in [0.5, 2]")
    act = sim.get_muscle_activation()
    want = muscle.waves_signal(
        torch.tensor(float(sim.step_count - 1))).numpy()
    d = float(np.abs(act - want).max())
    print(f"  muscle activation vs the wave model at t = "
          f"{sim.step_count - 1}: max|diff| {d:.2e}, max {act.max():.4f}",
          flush=True)
    check(d <= 1e-6 and act.max() > 0.0,
          f"muscle activation off the wave model by {d}")


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
    ap.add_argument("--only", default="",
                    help="comma-separated phases to run alone while "
                         f"iterating ({', '.join(PHASES)}); the run then "
                         "prints no result and exits 2")
    args = ap.parse_args(argv)
    only = [s for s in args.only.split(",") if s] or list(PHASES)
    check(set(only) <= set(PHASES), f"--only {only}")

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    card = card_line()
    name = torch.cuda.get_device_name(0)
    # one parallel CPU op before the cpu-side engine runs: the first
    # parallel op of a process that takes a square root has returned
    # low-precision results in one thread's chunk on some hosts
    torch.rand(1 << 20).mul_(2.0)
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

    results = {key: phase(card, args.profile_steps)
               for key, phase in PHASES.items() if key in only}
    if len(results) < len(PHASES):
        print(f"chip_smoke: only {sorted(results)} ran, no result",
              file=sys.stderr)
        return 2
    kernels = results["worm"]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def small_box_phases(card, profile_steps):
    # 3. kernel vs plain on the small box, from its resting pool
    print("kernel vs plain:", flush=True)
    small = SimParams(x_max=8 * H, y_max=8 * H, z_max=8 * H)
    scene = generate_liquid_box_scene(small, fill_fraction=0.5)
    _, layout, cfg, ws = scene_setup(scene, small, "cuda")
    springs, membranes = scene.device_state("cuda")[1:]
    state = W.make_fastw_multi_step(small, layout, cfg, SETTLE,
                                    wall_static=ws)(
        scene.device_state("cuda")[0], springs, membranes)
    compare(record_step_inputs(small, layout, cfg, ws, state, springs,
                               membranes), "small", box_edge(small))

    # 4. engine vs plain, from the settled state kicked gently
    print("engine vs plain (8h box, 10 steps from the settled state kicked "
          "down at 0.3 m/s):", flush=True)
    engine_vs_plain(scene, small, kicked(state, speed=0.3, noise=0.05),
                    springs, membranes)


def box_phases(card, profile_steps):
    # 5. the liquid-box path
    params = SimParams()
    scene = generate_liquid_box_scene(params)
    sim = Simulator(scene, params, engine="auto", device="cuda")
    check(sim.engine == "fastw", f"auto resolved to {sim.engine}")
    n = scene.n_particles
    print(f"box path: {scene.counts}, n {n}, engine {sim.engine}, "
          f"cfg {sim._fast_cfg}", flush=True)
    sim.step(BOX_WARMUP)
    dt, launches = timed_run(sim, BOX_STEPS)
    ms_step = dt * 1e3 / BOX_STEPS
    ovf = check_run(sim, scene, BOX_STEPS, launches, PER_STEP_BOX, "box")
    pos = sim.get_position()
    l0, l1 = sim.layout.liquid_range
    lo, hi = np.asarray(params.box_min), np.asarray(params.box_max)
    check(bool(((pos[l0:l1] >= lo) & (pos[l0:l1] <= hi)).all()),
          "liquid left the box")
    print(f"box path: {BOX_STEPS} steps in {dt:.3f} s: {ms_step:.4f} "
          f"ms/step, {n * 1e3 / ms_step:.6g} particle-steps/s, window drift "
          f"{ovf['window_drift_h']:.4f} h, launches {launches} [{card}]",
          flush=True)

    # 6. kernel vs plain at the box's shapes, from its final state
    calls = record_step_inputs(params, sim.layout, sim._fast_cfg,
                               sim._wall_static, sim.state, sim.springs,
                               sim.membranes)
    compare(calls, "box", box_edge(params))
    for pname, (p, tables, own, slab, *_) in sorted(calls.items()):
        ms = time_ms(lambda: p.kernel(tables, own, slab), 20)
        plain_ms = time_ms(lambda: p.plain(tables, own, slab), 3)
        print(f"  box   {pname:8s} kernel {ms:9.4f} ms  plain "
              f"{plain_ms:9.3f} ms  (x{PASSES[pname][1]}/step) [{card}]",
              flush=True)


def reduced_worm():
    """The reduced worm stepped WORM_SETTLE steps on the card: (scene,
    params, layout, cfg, wall static, state, springs, membranes)."""
    params = SimParams(**REDUCED_WORM)
    scene = generate_worm_scene(params)
    _, layout, cfg, ws = scene_setup(scene, params, "cuda")
    check(layout.springs_elastic_only, "reduced worm anchors to the walls")
    print(f"reduced worm: {scene.counts}, spring slots "
          f"{layout.spring_slots}, cfg {cfg}", flush=True)
    state, springs, membranes = scene.device_state("cuda")
    state, diag = W.make_fastw_multi_step(
        params, layout, cfg, WORM_SETTLE, return_diag=True, wall_static=ws)(
        state, springs, membranes)
    check(int(diag["shell_overflow"]) == 0
          and int(diag["tile_overflow"]) == 0, f"overflow: {diag}")
    check(bool(torch.isfinite(state.pos).all()), "reduced worm not finite")
    return scene, params, layout, cfg, ws, state, springs, membranes


def reduced_worm_kernels(card, profile_steps):
    # 7. kernel vs plain on the reduced worm, muscles active
    _, params, layout, cfg, ws, state, springs, membranes = reduced_worm()
    calls = record_step_inputs(params, layout, cfg, ws, state, springs,
                               membranes)
    elastic_input_counts(params, calls, "rworm")
    compare(calls, "rworm", box_edge(params))


def reduced_worm_engine(card, profile_steps):
    # 8. engine vs plain on the reduced worm
    scene, params, _, _, _, state, springs, membranes = reduced_worm()
    print(f"engine vs plain (reduced worm, 10 steps from step "
          f"{WORM_SETTLE}):", flush=True)
    engine_vs_plain(scene, params, state, springs, membranes,
                    kind=ELASTIC_PARTICLE, what="elastic")


def worm_phases(card, profile_steps):
    # 9. main path: the full worm
    params = SimParams()
    t0 = time.perf_counter()
    scene = generate_worm_scene(params)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    sim = Simulator(scene, params, engine="auto", device="cuda")
    t_init = time.perf_counter() - t0
    check(sim.engine == "fastw", f"auto resolved to {sim.engine}")
    n = scene.n_particles
    print(f"main path: {scene.counts}, n {n}, generated in {t_gen:.1f} s, "
          f"simulator built in {t_init:.1f} s, engine {sim.engine}, spring "
          f"slots {sim.layout.spring_slots}, cfg {sim._fast_cfg}",
          flush=True)
    # warm-up period. The worm's inner liquid is packed at 0.85 r0 and
    # expands: over 30 steps some particles move more than the shell's one
    # cell. step(n) below one period re-sorts at every step, which keeps
    # every wall within reach captured from step 0.
    sim.step(sim._fast_cfg.resort_every - 1)
    sim.step(1)
    warm = check_capture(sim, "worm warm-up")
    print(f"main path: warm-up period, re-sorted every step: window drift "
          f"{warm['window_drift_h']:.4f} h", flush=True)
    dt, launches = timed_run(sim, WORM_STEPS)
    ms_step = dt * 1e3 / WORM_STEPS
    ovf = check_run(sim, scene, WORM_STEPS, launches, PER_STEP, "worm")
    worm_integrity(sim, scene, params)
    print(f"main path: {WORM_STEPS} steps in {dt:.3f} s: {ms_step:.4f} "
          f"ms/step, {n * 1e3 / ms_step:.6g} particle-steps/s, window drift "
          f"{ovf['window_drift_h']:.4f} h (shell bound "
          f"{2 * (sim._fast_cfg.dilate - 1)} h), launches {launches} "
          f"[{card}]", flush=True)
    if profile_steps > 0:
        profile(sim, profile_steps, card)

    # 10. kernel vs plain at the main path's shapes, from its final state
    calls = record_step_inputs(params, sim.layout, sim._fast_cfg,
                               sim._wall_static, sim.state, sim.springs,
                               sim.membranes)
    data_work = elastic_input_counts(params, calls, "worm")
    print(f"  worm  data-dependent work: {data_work['spring']} springs "
          f"listed, {data_work['membrane']} own-column pairs within r0",
          flush=True)
    spring = calls["spring_ms"][0]
    print(f"  worm  spring launch: {spring.slab_rows} slab rows x "
          f"{spring.ccol} columns = {spring.shared_bytes} B of dynamic "
          f"shared memory (opt-in above {48 * 1024}); membrane "
          f"{calls['mem_ms'][0].shared_bytes} B", flush=True)
    check(spring.shared_bytes > 48 * 1024,
          "the spring launch did not take the shared-memory opt-in branch")
    far = box_edge(params)
    errs = compare(calls, "worm", far)
    per_kind = {k: dict(err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                        ops_ms=0.0) for k in PER_STEP}
    for pname, (p, tables, own, slab, *_) in sorted(calls.items()):
        kind, mult = PASSES[pname]
        ms = time_ms(lambda: p.kernel(tables, own, slab), 20)
        plain_ms = time_ms(lambda: p.plain(tables, own, slab), 3)
        pairs, bound_ms, by = pass_bound(p, tables, own, slab, far,
                                         data_work)
        print(f"  worm  {pname:9s} kernel {ms:9.4f} ms  plain "
              f"{plain_ms:9.3f} ms  bound {bound_ms:8.5f} ms ({by}, "
              f"{pairs:.4g} candidate pairs)  (x{mult}/step) [{card}]",
              flush=True)
        acc = per_kind[kind]
        acc["err"] = max(acc["err"], errs[pname])
        acc["ms"] += mult * ms
        acc["plain_ms"] += mult * plain_ms
        acc["bound_ms"] += mult * bound_ms
        acc["ops_ms"] += mult * bound_ms * (by == "operations")

    # no single PyTorch call computes a windowed pair sum: library_ms null
    return [dict(
        name=kind, route="cuda", source=SOURCE, replaces=REPLACES[kind],
        launches=launches[kind], max_abs_err=acc["err"], ms=acc["ms"],
        plain_ms=acc["plain_ms"], bound_ms=acc["bound_ms"],
        bound_by=("operations" if 2 * acc["ops_ms"] >= acc["bound_ms"]
                  else "bytes"),
        library_ms=None,
        ms_scope="one step's launches at the full-worm shapes",
    ) for kind, acc in per_kind.items()]


# name -> phase(card, profile_steps), in running order; "worm" returns the
# kernels' result entries
PHASES = {"small": small_box_phases, "box": box_phases,
          "rworm": reduced_worm_kernels, "rworm_engine": reduced_worm_engine,
          "worm": worm_phases}


if __name__ == "__main__":
    sys.exit(main())
