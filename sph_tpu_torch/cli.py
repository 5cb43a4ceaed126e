"""Command-line interface (counterpart of ``sph_tpu/cli.py``).

    python -m sph_tpu_torch run --scene worm|box [--box 30,20,250]
        [--fill 0.15] --steps N [--engine auto|exact|fast|fastw]
        [--device cuda|cpu] [--ccol N] [--ccol-c N] [--resort-every N]

prints the same scene and timing lines as ``python -m sph_tpu run``. Only
the ``run`` subcommand on the generated scenes is ported so far.
"""
from __future__ import annotations

import argparse
import sys
import time


def _make_params(args):
    from .config import SimParams

    kw = {}
    if args.box:
        bx, by, bz = (float(v) for v in args.box.split(","))
        h = 3.34
        kw.update(x_max=bx * h, y_max=by * h, z_max=bz * h)
    return SimParams(**kw)


def cmd_run(args) -> int:
    from .runtime import Simulator
    from .scene import generate_liquid_box_scene, generate_worm_scene

    params = _make_params(args)
    t0 = time.time()
    if args.scene == "worm":
        scene = generate_worm_scene(params)
    else:
        scene = generate_liquid_box_scene(params, fill_fraction=args.fill)
    print(f"scene: {scene.counts} ({time.time() - t0:.1f}s)")

    fck = {k: v for k, v in (
        ("ccol", args.ccol), ("ccol_c", args.ccol_c),
        ("resort_every", args.resort_every)) if v is not None}
    sim = Simulator(scene, params, engine=args.engine, device=args.device,
                    fast_config=fck or None)
    print(f"engine: {sim.engine}")
    chunk = max(1, args.report_every)
    done = 0
    while done < args.steps:
        n = min(chunk, args.steps - done)
        ms = sim.step_blocking(n)
        done += n
        print(f"[[ step {sim.step_count} ]]  {ms / n:8.3f} ms/step "
              f"({1e3 / (ms / n):.1f} steps/s)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="sph_tpu_torch",
        description="PCISPH (Electrofluid) on PyTorch + CUDA",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("run", help="simulate")
    p.add_argument("--scene", default="worm", choices=["worm", "box"],
                   help="worm = the worm in its pool (elastic shell, "
                        "membranes, muscles); box = generated pure-liquid "
                        "box")
    p.add_argument("--box", default=None,
                   help="world box in h units, e.g. '30,20,250'")
    p.add_argument("--fill", type=float, default=0.15,
                   help="liquid fill fraction for the box scene")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--report-every", type=int, default=100)
    p.add_argument("--engine", default="auto",
                   choices=["auto", "exact", "fast", "fastw"],
                   help="exact = neighbour lists (the reference's nearest "
                        "32 within h; plain PyTorch gathers); "
                        "fast = blocked pair engine (walls in the carry); "
                        "fastw = wall-compact engine (static walls leave "
                        "the hot carry; auto picks it on wall-heavy "
                        "scenes)")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (Hopper kernels) or cpu "
                        "(plain PyTorch pair passes)")
    p.add_argument("--ccol", type=int, default=None,
                   help="main pair-pass tile width (multiple of 128; "
                        "default: fast 256, fastw 512)")
    p.add_argument("--ccol-c", type=int, default=None,
                   help="compact-pass (boundary/spring/membrane) tile "
                        "width (default: fast ccol, fastw 256)")
    p.add_argument("--resort-every", type=int, default=None,
                   help="steps between spatial resorts (default 30)")
    p.set_defaults(fn=cmd_run)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
