"""Command-line interface (counterpart of ``sph_tpu/cli.py``).

    python -m sph_tpu_torch run --scene worm|box|CONFIG_DIR [--box 30,20,250]
        [--fill 0.15] [--dt S] --steps N
        [--engine auto|exact|fast|fastw|halo] [--backend gloo|nccl]
        [--device cuda|cpu] [--ccol N] [--ccol-c N] [--resort-every N]
        [--adaptive-resort] [--dump DIR --dump-every K]
        [--checkpoint PATH] [--restore PATH]
        [--render-every K --render-dir DIR] [-v]
    python -m sph_tpu_torch replay --buffers DIR --render DIR [--every K]
        [--gif PATH --fps F]
    python -m sph_tpu_torch info --scene ...
    python -m sph_tpu_torch genscene --scene ... --out DIR

The same subcommands, flags and output lines as ``python -m sph_tpu``; the
reference's three flags map as there (``-l_to`` -> ``run --dump``,
``-l_from`` -> ``replay``, graphics -> ``run --render-every``). ``--device``
(default cuda) picks the card's kernels or the CPU's plain versions.
``-v`` turns ``runtime.timing``'s tracer on: each ``--report-every`` line
is followed by that chunk's host ms by span, its device ms by mark with
the device's idle share, and its counters.
Rendering (``--render-every``, ``replay``) needs matplotlib and PIL.

``--engine halo`` shards the fast engine over the ranks of a process group:
under ``torchrun --nproc-per-node N -m sph_tpu_torch run --engine halo``
each rank joins the group from torchrun's environment (``--backend``, gloo
by default: ranks may share a card; nccl needs a card a rank, rank r on
``cuda:LOCAL_RANK``), and rank 0 prints (its ``ranks:`` line names every
rank's device) and writes the files. A collective that waits longer than
the process group's timeout (``parallel.launch.GROUP_TIMEOUT``) fails its
rank. Without torchrun it is a world of one.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def _make_params(args):
    from .config import SimParams

    kw = {}
    if getattr(args, "box", None):
        bx, by, bz = (float(v) for v in args.box.split(","))
        h = 3.34
        kw.update(x_max=bx * h, y_max=by * h, z_max=bz * h)
    if getattr(args, "dt", None):
        kw["time_step"] = args.dt
    return SimParams(**kw)


def _make_scene(args, params):
    from .scene import generate_liquid_box_scene, generate_worm_scene, io

    if args.scene == "worm":
        return generate_worm_scene(params)
    if args.scene == "box":
        return generate_liquid_box_scene(
            params, fill_fraction=getattr(args, "fill", 0.15))
    return io.load_scene(args.scene)  # a config directory


def _join_ranks(args):
    """Under torchrun (WORLD_SIZE > 1) join the process group from its
    environment; returns (this rank's device, rank, whether this call
    started the group)."""
    import os

    import torch
    import torch.distributed as dist

    from .parallel.launch import group_options

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if args.engine != "halo" or world == 1 or dist.is_initialized():
        rank = dist.get_rank() if dist.is_initialized() else 0
        return args.device, rank, False
    device = args.device
    if device == "cuda":
        device = rank_device(args.backend,
                             int(os.environ.get("LOCAL_RANK", "0")),
                             torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group(args.backend, init_method="env://",
                            **group_options(args.backend, device))
    return device, dist.get_rank(), True


def rank_device(backend: str, local_rank: int, n_cards: int) -> str:
    """A torchrun rank's card: ``cuda:LOCAL_RANK``. gloo ranks beyond the
    cards share them in turn; nccl needs a card a rank and raises."""
    if n_cards < 1:
        raise RuntimeError("--device cuda, but this machine has no card")
    if backend == "nccl" and local_rank >= n_cards:
        raise ValueError(f"nccl needs a card a rank: local rank "
                         f"{local_rank} on a machine with {n_cards} "
                         "card(s); use gloo to share them")
    return f"cuda:{local_rank % n_cards}"


def cmd_run(args) -> int:
    from .runtime import Simulator, timing

    device, rank, joined = _join_ranks(args)
    say = print if rank == 0 else (lambda *a, **k: None)
    params = _make_params(args)
    t0 = time.time()
    scene = _make_scene(args, params)
    say(f"scene: {scene.counts} ({time.time() - t0:.1f}s)")

    fck = {k: v for k, v in (
        ("ccol", args.ccol), ("ccol_c", args.ccol_c),
        ("resort_every", args.resort_every)) if v is not None}
    sim = Simulator(
        scene, params, engine=args.engine, device=device,
        fast_config=fck or None, dump_dir=args.dump,
        dump_interval=args.dump_every,
        adaptive_resort=args.adaptive_resort,
    )
    say(f"engine: {sim.engine}")
    if joined:
        import torch.distributed as dist

        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, str(device))
        say(f"ranks: {len(every)} {args.backend} ranks on {every}")
    if args.restore:
        sim.restore(args.restore)
        say(f"restored from {args.restore} at step {sim.step_count}")

    chunk = max(1, args.report_every)
    done = 0
    if args.verbose:
        timing.enable()
    while done < args.steps:
        n = min(chunk, args.steps - done)
        ms = sim.step_blocking(n)
        done += n
        say(f"[[ step {sim.step_count} ]]  {ms / n:8.3f} ms/step "
            f"({1e3 / (ms / n):.1f} steps/s)")
        if args.verbose:
            for line in timing.report(timing.snapshot()):
                say(line)
            timing.reset()
        if args.render_every and sim.step_count % args.render_every == 0:
            from .viz import render_frame

            out = f"{args.render_dir}/step_{sim.step_count:06d}.png"
            pos = sim.get_position()      # every rank gathers
            if rank:
                continue
            render_frame(
                pos, scene.ptype, out,
                springs=(scene.spring_rows, scene.spring_idx,
                         scene.spring_type),
                tris=scene.tris,
                activation=sim.get_muscle_activation(),
                hud=True, counts=scene.counts, step=sim.step_count,
                time_step=params.time_step,
            )
            print(f"rendered {out}")
    timing.disable()
    if args.checkpoint:
        sim.save(args.checkpoint)
        say(f"checkpoint -> {args.checkpoint}")
    sim.flush()  # drain the async trajectory stream before exit
    if joined:
        import torch.distributed as dist

        dist.destroy_process_group()
    return 0


def cmd_replay(args) -> int:
    from .viz import frames_to_gif, render_trajectory

    paths = render_trajectory(
        f"{args.buffers}/position_buffer.txt", args.render,
        every=args.every,
    )
    print(f"rendered {len(paths)} frames -> {args.render}")
    if args.gif:
        print(f"gif -> {frames_to_gif(paths, args.gif, fps=args.fps)}")
    return 0


def cmd_info(args) -> int:
    params = _make_params(args)
    scene = _make_scene(args, params)
    info = dict(scene.counts)
    info["n_particles"] = scene.n_particles
    info["grid_dims"] = params.grid_dims
    info["delta"] = params.delta
    print(json.dumps(info, indent=2, default=str))
    return 0


def cmd_genscene(args) -> int:
    from .scene import io

    params = _make_params(args)
    scene = _make_scene(args, params)
    io.save_scene(scene, args.out)
    print(f"wrote {scene.n_particles} particles -> {args.out}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="sph_tpu_torch",
        description="PCISPH (Electrofluid) on PyTorch + CUDA",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    def add_scene_args(p):
        p.add_argument("--scene", default="worm",
                       help="worm = the worm in its pool (elastic shell, "
                            "membranes, muscles); box = generated "
                            "pure-liquid box; else a config directory "
                            "(position.txt, velocity.txt, "
                            "elasticconnections.txt)")
        p.add_argument("--box", default=None,
                       help="world box in h units, e.g. '30,20,250'")
        p.add_argument("--dt", type=float, default=None)
        p.add_argument("--fill", type=float, default=0.15,
                       help="liquid fill fraction for the box scene")

    p = sub.add_parser("run", help="simulate")
    add_scene_args(p)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--dump", default=None, help="dump buffers dir (-l_to)")
    p.add_argument("--dump-every", type=int, default=10)
    p.add_argument("--report-every", type=int, default=100)
    p.add_argument("--render-every", type=int, default=0)
    p.add_argument("--render-dir", default="frames")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--restore", default=None)
    p.add_argument("--engine", default="auto",
                   choices=["auto", "exact", "fast", "fastw", "halo"],
                   help="exact = neighbour lists (the reference's nearest "
                        "32 within h; plain PyTorch gathers); "
                        "fast = blocked pair engine (walls in the carry); "
                        "fastw = wall-compact engine (static walls leave "
                        "the hot carry; auto picks it on wall-heavy "
                        "scenes); halo = fast engine sharded over all "
                        "ranks (z-slab halo exchange)")
    p.add_argument("--backend", default="gloo", choices=["gloo", "nccl"],
                   help="halo engine under torchrun: the process group's "
                        "backend (gloo: ranks may share a card; nccl: a "
                        "card a rank)")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (Hopper kernels) or cpu "
                        "(plain PyTorch pair passes)")
    p.add_argument("--adaptive-resort", action="store_true",
                   help="fast/fastw engines: shorten the resort period "
                        "while the in-period window-drift bound exceeds "
                        "0.25 h (see Simulator.adaptive_resort)")
    p.add_argument("--ccol", type=int, default=None,
                   help="main pair-pass tile width (multiple of 128; "
                        "default: fast 256, fastw 512)")
    p.add_argument("--ccol-c", type=int, default=None,
                   help="compact-pass (boundary/spring/membrane) tile "
                        "width (default: fast ccol, fastw 256)")
    p.add_argument("--resort-every", type=int, default=None,
                   help="steps between spatial resorts (default 30)")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="after each report line, the chunk's host ms by "
                        "span, device ms by mark and counters "
                        "(runtime.timing's tracer)")
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("replay", help="render a dumped trajectory (-l_from)")
    p.add_argument("--buffers", default="buffers")
    p.add_argument("--render", default="frames")
    p.add_argument("--every", type=int, default=1)
    p.add_argument("--gif", default=None, metavar="PATH",
                   help="also assemble the frames into an animated GIF")
    p.add_argument("--fps", type=float, default=10.0)
    p.set_defaults(fn=cmd_replay)

    p = sub.add_parser("info", help="print scene statistics")
    add_scene_args(p)
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("genscene", help="generate a scene to config files")
    add_scene_args(p)
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_genscene)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
