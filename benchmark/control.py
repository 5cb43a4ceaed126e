"""Readings that the limits of the check are set from, on the card, at a
cell's own size: for each seed, the program's numbers against the plain
reference, and on the first seeds the control's and the faults', frame by
frame, in one process.

    python benchmark/control.py --workload <cell> --seeds 1,2,3 \
        [--seconds 20] [--control 3] [--out chiprun_out/control.jsonl]

Each seed runs the cell as a run does: its set-up and first frame, then the
window for ``--seconds``, from which the traffic's ``check_frames`` frames
are drawn from the seed. The first frame and the sampled ones are then
followed by the reference from the state each started from, and judged as
the check judges them (``harness.check``). On the first ``--control``
seeds the same frames are judged with the control and the faults in the
program's place: the control is the reference with its per-pair arithmetic
in bfloat16, the nearest precision below the configuration's float32; the
faults are the state returned unchanged, half of the rows left at their
start, every moving position moved by 0.05 h, and the reference without
each term the scene has (``reference.physics.TERMS``). One JSON line a
frame.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def term_faults(topo_a: dict) -> list:
    """The terms of ``reference.physics.TERMS`` that the scene has."""
    import numpy as np

    from reference import physics

    walls = bool((np.asarray(topo_a["ptype"]) == physics.BOUNDARY).any())
    has = {"springs": np.asarray(topo_a["spring_idx"]).size > 0,
           "walls": walls, "boundary": walls,
           "membranes": len(topo_a["tris"]) > 0}
    has["muscles"] = has["springs"] and bool(topo_a["muscle_model"])
    return [t for t in physics.TERMS if has[t]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(HERE), str(ROOT)]
    import numpy as np
    import torch

    from harness import cell as hc, check, inputs, spec, window
    from reference import physics

    cell = spec.load_cell(ROOT, args.workload)
    dev = torch.device("cuda")
    cfg, k = cell.config, int(cell.traffic["steps_per_frame"])
    h = float(cfg["params"]["h"])
    out = open(args.out, "a") if args.out else None
    for n_seed, seed in enumerate(int(s) for s in args.seeds.split(",")):
        scene, sim, first, _ = hc.setup(cfg, seed, dev, k)
        w = window.run(sim, k, seconds=args.seconds,
                       sampler=window.Sampler(
                           int(cell.traffic["check_frames"]), seed))
        frames = check.frames_for_check((scene.pos, scene.vel), first,
                                        w.sample)
        del w, sim, first
        topo_a = inputs.topology_arrays(scene)
        topo = physics.Topology.of(topo_a, dev)
        c = physics.derived(cfg["params"])
        units = check.scales(cfg["params"], k)
        wall = np.asarray(topo_a["ptype"]) == physics.BOUNDARY
        half = np.arange(len(wall)) % 2 == 0
        faults = term_faults(topo_a) if n_seed < args.control else []
        for i, (x0, v0, s0, x1, v1) in enumerate(frames):
            sets = check.row_sets(x0, topo_a, h, dev)

            def judge(x, v):
                return check.gaps(x0, x, v, rx, rv, sets, units)

            def ref(**kw):
                with torch.no_grad():
                    return [a.cpu().numpy() for a in physics.run(
                        torch.as_tensor(x0, device=dev),
                        torch.as_tensor(v0, device=dev), s0, k, topo, c,
                        **kw)]
            t = time.perf_counter()
            rx, rv = ref()
            line = dict(cell=args.workload, seed=seed, frame=i,
                        start_step=s0, ref_s=time.perf_counter() - t,
                        rows={n or "moving": int(r.sum())
                              for n, r in sets.items()},
                        program=judge(x1, v1))
            if n_seed < args.control:
                line["control"] = judge(*ref(pair_dtype=torch.bfloat16))
                line["unchanged"] = judge(x0, v0)
                line["half"] = judge(np.where(half[:, None], x0, x1),
                                     np.where(half[:, None], v0, v1))
                shift = np.float32(0.05 * h) * np.array([1, 0, 0],
                                                        np.float32)
                line["moved"] = judge(np.where(wall[:, None], x1,
                                               x1 + shift), v1)
                for term in faults:
                    line[f"no_{term}"] = judge(*ref(off=(term,)))
            print(json.dumps({k_: v for k_, v in line.items()
                              if k_ in ("seed", "frame", "start_step",
                                        "ref_s", "program")}), flush=True)
            if out:
                out.write(json.dumps(line) + "\n")
                out.flush()
        del frames, topo
        torch.cuda.empty_cache()
    print(f"control: done in {time.perf_counter() - T0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
