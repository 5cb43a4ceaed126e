"""Locomotion acceptance run: long-horizon worm drive (counterpart of
``scripts/locomotion.py``).

    python -m sph_tpu_torch.scripts.locomotion [--steps 20000] [--chunk 30]
        [--report-every 500] [--small] [--frames DIR] [--record PATH]
        [--assert-propels] [--engine fast|fastw] [--device cuda|cpu]

Runs the worm-in-pool scene for many thousands of steps (the fast engine
by default, as the reference does; ``--engine fastw`` runs the main path)
and records what the reference exists to produce, sustained muscle-driven
undulation:

* centre-of-mass z displacement of the elastic body beyond noise (the mean
  |COM-z change| between reports);
* shape integrity: the elastic bounding box, the largest spring strain;
* a rendered frame strip, when ``--frames`` names a directory (``""``
  renders nothing; matplotlib is needed otherwise).

It steps the reference's loop: ``max(1, report_every // chunk)`` chunks of
``chunk`` steps between reports, until ``--steps`` is reached, so the step
counts equal the reference's (20,160 at the defaults). Each report also
prints the largest window drift of its resort periods in h (fastw: with the
shell's and tiles' overflow counts). The muscle wave advances 1e-4 rad a
step (main_sim.py:8), so one undulation cycle is ~63k steps.
``--record PATH`` appends the reference's results block to PATH.
``--assert-propels`` exits 1 unless the verdict is PROPELS with a final
max strain below 0.5.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from ..config import SimParams
from ..constants import ELASTIC_PARTICLE
from ..scene import generate_worm_scene
from .bench_scale import build_engine

H = 3.34
SMALL = dict(x_max=14 * H, y_max=12 * H, z_max=108 * H)
PROPELS = "PROPELS"
STRAIN_LIMIT = 0.5


def strain(pos, rows, sidx, rest, scale) -> float:
    """The largest |r / rest - 1| over the springs ([Ne, 32] partner ids,
    -1 pad, and rest lengths in scaled SI; a pad or zero-rest slot counts
    0)."""
    valid = sidx >= 0
    d = pos[rows][:, None, :] - pos[np.maximum(sidx, 0)]
    r = np.linalg.norm(d, axis=2) * scale
    s = np.abs(np.where(valid & (rest > 0), r / np.maximum(rest, 1e-30),
                        1.0) - 1.0)
    return float(s.max())


def noise_of(zs) -> float:
    """The mean |COM-z change| between consecutive reports (0 for one)."""
    zs = np.asarray(zs)
    return float(np.abs(np.diff(zs)).mean()) if len(zs) > 1 else 0.0


def verdict(dz: float, noise: float) -> str:
    return (PROPELS if abs(dz) > 3 * noise and abs(dz) > 0.05
            else "no net propulsion beyond noise")


def passes(verdict_: str, final_strain: float) -> bool:
    """The acceptance gate: PROPELS with bounded strain."""
    return verdict_ == PROPELS and final_strain < STRAIN_LIMIT


def schedule(steps: int, chunk: int, report_every: int) -> list[int]:
    """The steps done at each report of the reference's loop: reports every
    ``max(1, report_every // chunk)`` chunks until ``steps`` is reached."""
    per_report = max(1, report_every // chunk) * chunk
    return [per_report * k for k in range(1, -(-steps // per_report) + 1)]


def _record(path, steps, small, scene, dz, noise, verdict_, bb0, bb1,
            final_strain, frames):
    with open(path, "a") as fh:
        fh.write(
            f"\n### Locomotion run ({steps} steps, "
            f"{'small' if small else 'full'} worm, "
            f"{scene.n_particles} particles)\n\n"
            f"- COM-z displacement: {dz:+.4f} sim units "
            f"(noise {noise:.4f}) — {verdict_}\n"
            f"- elastic bounding box {np.round(bb0, 1).tolist()} -> "
            f"{np.round(bb1, 1).tolist()}; "
            f"final max spring strain {final_strain:.3f}\n"
            f"- frame strip: {frames or 'none'}\n"
        )


def main(argv=None, out=None) -> int:
    """Runs the locomotion loop; returns the exit code. ``out``, a dict,
    receives the run's numbers: engine (what ran), steps, particles, dz,
    noise, verdict, strain0, strain (final), bb0, bb1, ms_step (the loop's
    wall ms a step, the first chunk's capture included), first_drift_h
    (the first chunk's drift bound in h), drift_h (the worst after it),
    shell_bound_h (fastw: the shell's capture bound in h), overflow (fastw:
    shell and tile overflow over the run), trace ([(step, COM-z, strain)]
    a report), passed (the gate), and the runner with the final state
    (run, state, springs, membranes) for a caller that steps on."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=20000)
    ap.add_argument("--chunk", type=int, default=30,
                    help="steps a runner call (one resort period)")
    ap.add_argument("--report-every", type=int, default=500)
    ap.add_argument("--small", action="store_true",
                    help="reduced worm world (14h x 12h x 108h: its springs "
                    "anchor to the walls, so fastw runs the fast engine "
                    "there)")
    ap.add_argument("--frames", default="frames/locomotion",
                    help="directory of the frame strip; '' renders none")
    ap.add_argument("--record", default=None, metavar="PATH",
                    help="append the results block to PATH")
    ap.add_argument("--assert-propels", action="store_true",
                    help="exit 1 unless the worm PROPELS with max strain "
                    "< 0.5")
    ap.add_argument("--engine", default="fast", choices=("fast", "fastw"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = {} if out is None else out
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("locomotion: CUDA is not available", file=sys.stderr)
        return 1

    t0 = time.perf_counter()
    params = SimParams(**SMALL) if args.small else SimParams()
    scene = generate_worm_scene(params)
    # fast: compute_fast_config's defaults, as the reference; fastw: the
    # tuned tiles, walls hoisted (the small worm anchors springs to walls:
    # the fast engine runs there, and the label says so)
    label, run, cfg = build_engine(scene, params, args.engine, args.chunk,
                                   device)
    print(f"scene: {scene.n_particles} particles {scene.counts} "
          f"({time.perf_counter() - t0:.1f}s); engine {label}, {cfg}",
          flush=True)
    state, springs, membranes = scene.device_state(device)
    el = scene.ptype == ELASTIC_PARTICLE
    rows, sidx, rest = scene.spring_rows, scene.spring_idx, scene.spring_rest
    scale = params.simulation_scale

    def strain_of(pos):
        return strain(pos, rows, sidx, rest, scale)

    p0 = state.pos.cpu().numpy()
    com0 = p0[el].mean(axis=0)
    bb0 = p0[el].max(0) - p0[el].min(0)
    strain0 = strain_of(p0)
    print(f"start: com={com0}, elastic bb={bb0}, max strain={strain0:.3f}",
          flush=True)

    if args.frames:
        os.makedirs(args.frames, exist_ok=True)
    trace, drifts, overflow = [], [], {}
    t0 = time.perf_counter()
    done = frame_i = 0
    per_report = max(1, args.report_every // args.chunk)
    for done in schedule(args.steps, args.chunk, args.report_every):
        diags = []
        for _ in range(per_report):
            state, diag = run(state, springs, membranes)
            diags.append(diag)
        pos = state.pos.cpu().numpy()
        drift = torch.stack([d["window_drift"] for d in diags]).cpu().numpy()
        drifts.extend((2.0 * drift / params.h).tolist())
        for k in ("shell_overflow", "tile_overflow"):
            if k in diags[0]:
                overflow[k] = max(overflow.get(k, 0), max(
                    int(d[k]) for d in diags))
        com = pos[el].mean(axis=0)
        bb = pos[el].max(0) - pos[el].min(0)
        st = strain_of(pos)
        ok = bool(np.isfinite(pos).all())
        trace.append((done, float(com[2]), st))
        el_ms = (time.perf_counter() - t0) / done * 1e3
        print(f"step {done:6d}  com_z={com[2]:9.4f} (d={com[2] - com0[2]:+.4f})"
              f"  bb=({bb[0]:.1f},{bb[1]:.1f},{bb[2]:.1f})"
              f"  strain={st:.3f}  finite={ok}  {el_ms:.4f} ms/step"
              f"  drift max {max(drifts[-per_report:]):.4f} h"
              + "".join(f"  {k} {v}" for k, v in overflow.items()),
              flush=True)
        if not ok:
            raise RuntimeError(f"non-finite state at step {done}")
        if args.frames and done % (args.steps // 10 or 1) < args.chunk:
            from ..viz import render_frame

            render_frame(
                pos, scene.ptype,
                os.path.join(args.frames, f"strip_{frame_i:02d}.png"),
                springs=(rows, sidx, scene.spring_type), tris=scene.tris,
                activation=state.muscle_activation.cpu().numpy(),
                hud=True, counts=scene.counts, step=done,
                time_step=params.time_step,
            )
            frame_i += 1
    ms_step = (time.perf_counter() - t0) / done * 1e3

    pos = state.pos.cpu().numpy()
    com1 = pos[el].mean(axis=0)
    bb1 = pos[el].max(0) - pos[el].min(0)
    dz = float(com1[2] - com0[2])
    noise = noise_of([t[1] for t in trace])
    final_strain = strain_of(pos)
    verdict_ = verdict(dz, noise)
    print(f"\nRESULT: com_z displacement {dz:+.4f} sim units over "
          f"{done} steps (checkpoint-to-checkpoint noise {noise:.4f})")
    print(f"shape: bb {bb0} -> {bb1}; final max strain {final_strain:.3f}")
    print("verdict:", verdict_, flush=True)
    passed = passes(verdict_, final_strain)
    out.update(
        steps=done, particles=scene.n_particles, dz=dz, noise=noise,
        verdict=verdict_, strain0=strain0, strain=final_strain, bb0=bb0,
        bb1=bb1, ms_step=ms_step, first_drift_h=drifts[0],
        drift_h=max(drifts[1:], default=0.0),
        engine=label,
        shell_bound_h=2.0 * (cfg.dilate - 1) if label == "fastw" else None,
        overflow=overflow, trace=trace, passed=passed, run=run, state=state,
        springs=springs, membranes=membranes)
    if args.record:
        _record(args.record, done, args.small, scene, dz, noise, verdict_,
                bb0, bb1, final_strain, args.frames)
    if args.assert_propels:
        if not passed:
            print(f"ACCEPTANCE FAIL: verdict={verdict_}, "
                  f"strain={final_strain:.3f}")
            return 1
        print("ACCEPTANCE PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
