"""The multi-GPU dry run and the rank functions that drive the sharded
engines (counterpart of ``__graft_entry__.dryrun_multichip``).

    python -m sph_tpu_torch.parallel.dryrun [N] [--backend gloo|nccl]
        [--device cuda|cpu]

runs N ranks (default 2) through :func:`~.launch.run_ranks`, on the card
unless ``--device cpu`` is given (gloo ranks share it), on the reduced
worm (14h x 12h x 108h: full physics, springs anchored to the walls) and
holds each sharded engine to its single-device counterpart, computed in
this process on the same device:

1. one all-gather sharded step against the exact engine, max |dpos| <=
   2e-5;
2. 3 halo-engine steps at resort_every 2 (across a resort) against the
   fast engine, <= 5e-5, with no halo overflow;
3. 5 steps of the distributed resort (across two resorts, with real
   migration between ranks) against the fast engine, <= 5e-5, with no
   halo or migration overflow.
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
from ..core.step import multi_step
from ..ops import pair_kernels as pk
from .halo import make_halo_fast_multi_step
from .launch import run_ranks
from .mesh import pad_scene_to_devices
from .sharded import gather_state, make_sharded_step, shard_state

H = 3.34
SHARDED_TOL = 2e-5
HALO_TOL = 5e-5
BLOCK = 128


def tiny_worm():
    """The reduced worm-in-pool scene (full physics: elastic shell,
    membranes, muscles, liquid, boundary box) in a small world box."""
    from ..scene import generate_worm_scene

    params = SimParams(x_max=14 * H, y_max=12 * H, z_max=108 * H)
    return params, generate_worm_scene(params)


def _timed(comm, fn):
    """(fn(), seconds) with the rank's device drained on both sides."""
    sync = (torch.cuda.synchronize if comm.device.type == "cuda"
            else (lambda: None))
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def halo_runs(comm, scene, params, cfg, runs, halo_pad=None, mig_cap=None,
              start=None):
    """The halo engine's runs on ``scene`` (or from ``start``, a dict of
    full-size ``pos``/``vel``/``muscle_activation``/``step`` arrays), each
    from the same start: ``runs`` is a list of (n_steps,
    distributed_resort). Yields (this rank's end state, a dict of the
    run's diag, this rank's pair-kernel ``launches`` and ``seconds``) a
    run."""
    state, springs, membranes = scene.device_state(comm.device)
    if start is not None:
        state = with_start(state, start)
    state_l = shard_state(state, comm)
    for n_steps, distributed in runs:
        run = make_halo_fast_multi_step(
            comm, params, scene.layout(), cfg, n_steps, halo_pad=halo_pad,
            distributed_resort=distributed, mig_cap=mig_cap)
        before = dict(pk.LAUNCHES)
        (res, diag), secs = _timed(
            comm, lambda: run(state_l, springs, membranes))
        yield res, dict(diag=diag, seconds=secs, launches={
            k: v - before[k] for k, v in pk.LAUNCHES.items()
            if v != before[k]})


def halo_rank(comm, scene, params, cfg, runs, halo_pad=None, mig_cap=None,
              start=None):
    """Rank function: :func:`halo_runs`, one dict a run: ``diag`` (every
    rank's equal), this rank's ``launches`` and ``seconds``, and on rank 0
    the gathered ``pos``/``vel``/``muscle_activation``/``step``."""
    out = []
    for res, rec in halo_runs(comm, scene, params, cfg, runs, halo_pad,
                              mig_cap, start):
        full = gather_state(res, comm)
        if comm.rank == 0:
            rec.update(pos=full.pos, vel=full.vel, step=full.step,
                       muscle_activation=full.muscle_activation)
        out.append(rec)
    return out


def sharded_rank(comm, scene, params, n_steps):
    """Rank function: ``n_steps`` all-gather sharded steps; rank 0 returns
    the gathered positions and velocities."""
    state, springs, membranes = scene.device_state(comm.device)
    step = make_sharded_step(comm, params, scene.layout(), n_steps)
    full = gather_state(step(shard_state(state, comm), springs, membranes),
                        comm)
    return dict(pos=full.pos, vel=full.vel) if comm.rank == 0 else {}


def with_start(state, start):
    """``state`` with the fields ``start`` gives (arrays or tensors)."""
    import dataclasses

    return dataclasses.replace(state, **{
        k: torch.as_tensor(np.asarray(v)).to(getattr(state, k))
        for k, v in start.items()})


def _check(ok, msg):
    if not ok:
        raise AssertionError(msg)


def _dryrun_rank(comm, scene, scene_h, params, cfg, halo_pad):
    return dict(
        sharded=sharded_rank(comm, scene, params, 1),
        halo=halo_rank(comm, scene_h, params, cfg,
                       [(3, False), (5, True)], halo_pad=halo_pad))


def dryrun_multichip(n_devices: int = 2, backend: str = "gloo",
                     device="cuda") -> dict:
    """The three checks of the module docstring on ``n_devices`` ranks on
    ``device`` (gloo ranks may share one card; nccl needs a card a rank;
    ``"cpu"`` runs them on the CPU's plain versions). Raises
    AssertionError on a failed check; returns the errors, the overflow
    counts and every rank's launches."""
    device = torch.device(device)
    if device.type == "cuda":
        devices = ([f"cuda:{i}" for i in range(n_devices)]
                   if backend == "nccl" else "cuda:0")
        device = torch.device("cuda:0")
    else:
        devices = "cpu"
    params, scene = tiny_worm()
    scene = pad_scene_to_devices(scene, n_devices)
    scene_h = pad_scene_to_devices(scene, n_devices * BLOCK)
    cfg = F.compute_fast_config(scene_h.pos, params, block=BLOCK,
                                resort_every=2,
                                block_multiple=math.lcm(8, n_devices))
    halo_pad = 2048
    res = run_ranks(_dryrun_rank, n_devices, backend, devices, scene,
                    scene_h, params, cfg, halo_pad)

    state, springs, membranes = scene.device_state(device)
    ref = multi_step(state, springs, membranes, params, scene.layout(), 1)
    err = float(np.abs(res[0]["sharded"]["pos"] - ref.pos.cpu().numpy())
                .max())
    _check(err <= SHARDED_TOL, f"sharded vs single-device max |dpos| {err}")

    out = dict(sharded_err=err, launches=[r["halo"] for r in res])
    state_h, springs_h, membranes_h = scene_h.device_state(device)
    for key, (n_steps, run) in zip(("halo", "distributed"),
                                   ((3, res[0]["halo"][0]),
                                    (5, res[0]["halo"][1]))):
        ref = F.make_fast_multi_step(params, scene_h.layout(), cfg,
                                     n_steps)(state_h, springs_h,
                                              membranes_h)
        e = float(np.abs(run["pos"] - ref.pos.cpu().numpy()).max())
        ovf = {k: int(v) for k, v in run["diag"].items()
               if k.endswith("overflow")}
        _check(not any(ovf.values()), f"{key} overflow {ovf}")
        _check(int(run["step"]) == n_steps, f"{key}: step {run['step']}")
        _check(e <= HALO_TOL, f"{key} vs single-device fast max |dpos| {e}")
        out[key + "_err"] = e
        out[key + "_overflow"] = ovf
    print(f"dryrun_multichip OK: {scene.n_particles} particles over "
          f"{n_devices} {backend} ranks on {device.type}, 1 step all-gather "
          f"sharded == exact single-device (max |dpos| {err:.2e}); halo "
          f"engine, 3 steps across a resort (resort_every=2) == single-"
          f"device fast (max |dpos| {out['halo_err']:.2e}, halo overflow "
          f"0); distributed O(cells) resort, 5 steps across two resorts "
          f"== single-device fast (max |dpos| {out['distributed_err']:.2e},"
          f" overflow 0/0)", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=2)
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        print("dryrun: CUDA is not available (--device cpu runs the ranks "
              "on the CPU)", file=sys.stderr)
        return 1
    dryrun_multichip(args.n, args.backend, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
