"""At-scale throughput: the multi-worm scene and the ~1M-particle dam-break
on the fastw and fast engines (counterpart of ``scripts/bench_scale.py``).
On the card:

    python -m sph_tpu_torch.scripts.bench_scale [n_worms] [fill] [engine]

engine: "fastw" (default), "fast", or "both". fastw refuses springs
anchored to walls; on such a scene a fastw leg runs the fast engine and
its line says so (``[fast (fastw refuses wall-anchored springs)]``). No
other engine switch is made. ``measure(..., device="cpu")`` steps a small
scene on the CPU (the plain pair passes); the script itself needs CUDA.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..config import SimParams
from ..core import fast as F
from ..core import fastw as W
from ..core import graphed
from ..ops import pair_kernels as pk
from ..scene import (generate_liquid_box_scene, generate_multi_worm_params,
                     generate_multi_worm_scene)

CHUNK = 30
# the tuned fastw tiles (results/r5/best_config.json)
FASTW_TILES = dict(block=256, ccol=512, ccol_c=256)
REFUSED = "fast (fastw refuses wall-anchored springs)"


def build_engine(scene, params, engine, chunk, device):
    """(label, run(state, springs, membranes) -> (state, diag), cfg): the
    engine stepping ``chunk`` steps a call (one period graph a length on
    the card), built as the reference's scripts build it; diag holds device
    tensors. fastw: ``FASTW_TILES`` with the walls hoisted, or, on a scene
    whose springs anchor to walls, the fast engine under the label
    ``REFUSED``; fast: ``compute_fast_config``'s defaults."""
    layout = scene.layout()
    if engine == "fastw" and layout.springs_elastic_only:
        cfg = W.compute_fastw_config(scene.pos, params, layout,
                                     ptype=scene.ptype, device=device,
                                     **FASTW_TILES)
        ws = W.precompute_wall_static(scene.pos, scene.normal, params,
                                      layout, cfg)
        return "fastw", W.make_fastw_multi_step(
            params, layout, cfg, chunk, return_diag=True,
            wall_static=ws), cfg
    if engine not in ("fastw", "fast"):
        raise ValueError(f"unknown engine {engine!r}")
    cfg = F.compute_fast_config(scene.pos, params)
    fast_run = F.make_fast_multi_step(params, layout, cfg, chunk,
                                      return_drift=True)

    def run(state, springs, membranes):
        out, drift = fast_run(state, springs, membranes)
        return out, dict(window_drift=drift)
    return ("fast" if engine == "fast" else REFUSED), run, cfg


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def measure(name, scene, params, engine="fastw", chunk=CHUNK, rounds=4,
            device="cuda"):
    """Steps ``scene`` one untimed chunk of ``chunk`` steps (on the card the
    capture of its period graph), then ``rounds`` timed chunks ended by a
    device synchronize, and prints the reference's line. Returns its
    numbers and the integrity checks' readings:

    name, engine (what ran), particles, steps (timed), ms_step, pps,
    compile_s, finite, walls_still, in_box, shell_overflow (fastw: wall
    rows beyond the shell's capacity, whose pairs are dropped) and
    tile_overflow (the tiles sph_tpu's Pallas caps would drop, which the
    port's kernels compute: fastw over every chunk's tables, fast at the
    final positions, as ``Simulator.check_overflow``),
    warm_drift_h and drift_h (2x the summed per-step max displacement of a
    resort period, in h: the untimed chunk's and the timed chunks' worst),
    shell_bound_h (fastw: the shell's capture bound, 2 (dilate - 1) h;
    fast: None), launches (each pair kernel's launches a timed step: 0 on
    the CPU, where no kernel launches), captures (``graphed.CAPTURES``
    records of the period graphs captured here), and the runner with the
    final state (run, state, springs, membranes) for a caller that steps
    on."""
    label, run, cfg = build_engine(scene, params, engine, chunk, device)
    n_captured = len(graphed.CAPTURES)
    state, springs, membranes = scene.device_state(device)
    n = scene.n_particles
    t0 = time.perf_counter()
    state, warm = run(state, springs, membranes)
    _sync(device)
    compile_s = time.perf_counter() - t0
    for k in pk.LAUNCHES:
        pk.LAUNCHES[k] = 0
    diag = {}
    t0 = time.perf_counter()
    for _ in range(rounds):
        state, d = run(state, springs, membranes)
        diag = {k: torch.maximum(diag[k], v) if k in diag else v
                for k, v in d.items()}
    _sync(device)
    wall = time.perf_counter() - t0
    launches = dict(pk.LAUNCHES)
    steps = rounds * chunk
    ms = wall / steps * 1e3
    pps = n * steps / wall
    pos = state.pos.cpu().numpy()
    ok = bool(np.isfinite(pos).all()
              and np.isfinite(state.vel.cpu().numpy()).all())
    layout = scene.layout()
    b0, b1 = layout.boundary_range
    l0, l1 = layout.liquid_range
    lo, hi = np.asarray(params.box_min), np.asarray(params.box_max)
    out = dict(
        name=name, engine=label, particles=n, steps=steps, ms_step=ms,
        pps=pps, compile_s=compile_s, finite=ok,
        walls_still=bool(np.array_equal(pos[b0:b1], scene.pos[b0:b1])),
        in_box=bool(((pos[l0:l1] >= lo) & (pos[l0:l1] <= hi)).all()),
        warm_drift_h=2.0 * float(warm["window_drift"]) / params.h,
        drift_h=2.0 * float(diag["window_drift"]) / params.h,
        launches={k: v / steps for k, v in launches.items() if v},
        captures=graphed.CAPTURES[n_captured:], run=run, state=state,
        springs=springs, membranes=membranes)
    if label == "fastw":
        out.update(
            shell_overflow=max(int(warm["shell_overflow"]),
                               int(diag["shell_overflow"])),
            tile_overflow=max(int(warm["tile_overflow"]),
                              int(diag["tile_overflow"])),
            shell_bound_h=2.0 * (cfg.dilate - 1))
    else:
        tmax, ttot = F.tile_table_stats(pos, params, cfg)
        smax, per_block = F.tile_caps(cfg.ccol)
        out.update(shell_overflow=0,
                   tile_overflow=(max(0, tmax - smax)
                                  + max(0, ttot - cfg.n_blocks * per_block)),
                   shell_bound_h=None)
    print(f"{name} [{label}]: {n} particles, {ms:.4f} ms/step, "
          f"{pps / 1e6:.4f}M particle-steps/s, compile {compile_s:.1f}s, "
          f"finite={ok}", flush=True)
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n_worms = int(argv[0]) if len(argv) > 0 else 2
    fill = float(argv[1]) if len(argv) > 1 else 0.8
    engine = argv[2] if len(argv) > 2 else "fastw"
    engines = ("fast", "fastw") if engine == "both" else (engine,)
    if not torch.cuda.is_available():
        print("bench_scale: CUDA is not available", file=sys.stderr)
        return 1

    base = SimParams()
    t0 = time.perf_counter()
    mscene = generate_multi_worm_scene(n_worms, base)
    wide = generate_multi_worm_params(n_worms, base)
    print(f"{n_worms}-worm scene: {mscene.counts} "
          f"(build {time.perf_counter() - t0:.1f}s)", flush=True)
    for eng in engines:
        measure(f"{n_worms}-worm", mscene, wide, engine=eng)

    t0 = time.perf_counter()
    dscene = generate_liquid_box_scene(base, fill_fraction=fill)
    print(f"dam-break fill={fill}: {dscene.counts} "
          f"(build {time.perf_counter() - t0:.1f}s)", flush=True)
    for eng in engines:
        measure("dam-break", dscene, base, engine=eng)
    return 0


if __name__ == "__main__":
    sys.exit(main())
