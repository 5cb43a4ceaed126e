"""Multi-process halo-engine check over a two-level rank order
(counterpart of ``scripts/multihost_halo.py``).

Starts 4 ranks (two "slices" of 2 ranks, joined in one process group by
``parallel.launch.run_ranks``), builds the slice-major chain
(``make_mesh2(2, 2)``: the slice boundary is the edge ``dcn_edges``
names), runs the halo engine across TWO distributed resorts with real
migration between ranks, and holds every rank's own rows to a
single-device fast-engine run of the same scene.

Success criterion: the halo engine is agnostic of how the ranks group
into slices: only the chain order enters its collectives, so the run
matches the single-device engine within 5e-5 with no halo or migration
overflow.

    python -m sph_tpu_torch.scripts.multihost_halo [--backend gloo|nccl]
        [--device cuda|cpu]

gloo ranks (the default) on the card (the default) all share ``cuda:0``;
nccl ranks take a card each (``cuda:0`` to ``cuda:3``: four cards), as a
host's ranks would. ``--device cpu`` runs gloo ranks on the CPU, as
sph_tpu's script runs its processes on CPU devices.
"""
from __future__ import annotations

import argparse
import math
import sys
import time

import numpy as np
import torch

from ..config import SimParams
from ..core import fast as F
from ..parallel import (dcn_edges, make_halo_fast_multi_step, make_mesh2,
                        pad_scene_to_devices, shard_state)
from ..parallel.launch import run_ranks
from ..scene import generate_liquid_box_scene

N_SLICES = 2
PER_SLICE = 2
BLOCK = 128
STEPS = 5  # resort_every=2 -> crosses TWO distributed resorts
TOL = 5e-5
H = 3.34


def _scene():
    params = SimParams(x_max=6 * H, y_max=6 * H, z_max=60 * H)
    # deterministic generator: every rank builds the identical scene
    scene = generate_liquid_box_scene(params, fill_fraction=0.5)
    scene = pad_scene_to_devices(scene, N_SLICES * PER_SLICE * BLOCK)
    cfg = F.compute_fast_config(
        scene.pos, params, block=BLOCK, resort_every=2,
        block_multiple=math.lcm(8, N_SLICES * PER_SLICE))
    return params, scene, cfg


def _rank(comm):
    params, scene, cfg = _scene()
    chain = make_mesh2(N_SLICES, PER_SLICE, device=comm.device)
    state, springs, membranes = scene.device_state(chain.device)
    # halo band clamped to the rows of one rank
    halo_pad = min(1024, scene.n_particles // chain.world)
    run = make_halo_fast_multi_step(
        chain, params, scene.layout(), cfg, n_steps=STEPS,
        halo_pad=halo_pad, distributed_resort=True)
    out, diag = run(shard_state(state, chain), springs, membranes)
    return dict(rank=chain.rank, pos=out.pos, diag=diag)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"),
                    help="gloo: the ranks share the device; nccl: a card a "
                         "rank")
    ap.add_argument("--device", default="cuda",
                    help="the ranks' device (gloo ranks share one card) and "
                         "the reference's")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    world = N_SLICES * PER_SLICE
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print("multihost_halo: CUDA is not available (--device cpu runs "
                  "the ranks on the CPU)", file=sys.stderr)
            return 1
        device = torch.device("cuda", device.index or 0)
    devices = str(device)
    if args.backend == "nccl":
        if device.type != "cuda" or torch.cuda.device_count() < world:
            print(f"multihost_halo: nccl needs a card for each of the "
                  f"{world} ranks", file=sys.stderr)
            return 1
        devices = [f"cuda:{i}" for i in range(world)]
    t0 = time.time()
    res = run_ranks(_rank, world, args.backend, devices)
    params, scene, cfg = _scene()
    ref = F.make_fast_multi_step(params, scene.layout(), cfg, STEPS)(
        *scene.device_state(device)).pos.cpu().numpy()
    n_loc = scene.n_particles // world
    ok = True
    for r in res:
        rows = slice(r["rank"] * n_loc, (r["rank"] + 1) * n_loc)
        err = float(np.abs(r["pos"] - ref[rows]).max())
        ovf = {k: int(v) for k, v in r["diag"].items()
               if k.endswith("overflow")}
        good = err <= TOL and not any(ovf.values())
        ok &= good
        print(f"[rank {r['rank']}] {'OK' if good else 'FAIL'}: "
              f"{N_SLICES} slices x {PER_SLICE} {args.backend} ranks on "
              f"{devices}, "
              f"{scene.n_particles} particles, {STEPS} steps across 2 "
              f"distributed resorts, {len(r['pos'])} rows, max |dpos| vs "
              f"single-device fast = {err:.2e}, overflow {ovf}", flush=True)
    print(f"slice-boundary edges {dcn_edges(N_SLICES, PER_SLICE)}; "
          f"{'OK' if ok else 'FAIL'} in {time.time() - t0:.1f} s",
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
