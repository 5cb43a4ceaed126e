"""Two checkouts' benchmark runs in turns on one card:

    python -m sph_tpu_torch.scripts.bench_ab PARENT CHANGE \
        [--cells worm.frame1:3,dambreak.frame30:1] [--seconds 51] \
        [--trace worm.frame1] [--seed n] [--out ab]

Each ``cell:pairs`` entry runs ``pairs`` pairs of ``benchmark/run.py
--workload cell --trace 0``, one in each checkout, a seed a pair, the
order turned each pair (P C, C P, P C: the card's drift falls on both
sides alike). ``--trace`` names cells of which each side then makes one
``--trace 1`` run on one more seed. Every run's output goes to
``chiprun_out/<out>/<cell>.<tag>.<side>.json`` (standard error beside it);
a line a run and, at the end, each side's median of every end-to-end
metric a cell are printed. Exits 1 if a run failed or read ``correct``
false.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def run(side: Path, cell: str, seed: int, seconds: float, traced: bool,
        stem: Path) -> dict | None:
    """One run of ``side``'s benchmark, its output in ``<stem>.json`` and
    ``<stem>.err``: its last line, None on a fault."""
    cmd = [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
           str(seed), "--seconds", str(seconds), "--trace", str(int(traced))]
    res = subprocess.run(cmd, cwd=side, capture_output=True, text=True,
                         timeout=seconds + 600)
    Path(f"{stem}.json").write_text(res.stdout)
    Path(f"{stem}.err").write_text(res.stderr)
    lines = res.stdout.strip().splitlines()
    try:
        line = json.loads(lines[-1]) if res.returncode == 0 else None
    except (IndexError, ValueError):
        line = None
    metrics = ({k: v["value"] for k, v in line["metrics"].items()}
               if line else {})
    print(f"{stem.name} seed={seed} rc={res.returncode} "
          f"correct={line and line['correct']} {metrics}", flush=True)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("change", type=Path)
    ap.add_argument("--cells", default="worm.frame1:3,dambreak.frame1:2,"
                    "worm.frame30:1,dambreak.frame30:1")
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--trace", default="")
    ap.add_argument("--seed", type=int, default=2_999_000_000)
    ap.add_argument("--out", default="ab")
    args = ap.parse_args(argv)
    sides = {"parent": args.parent.resolve(), "change": args.change.resolve()}
    out = ROOT / "chiprun_out" / args.out
    out.mkdir(parents=True, exist_ok=True)
    lines, bad = {}, 0
    seed = args.seed
    for entry in args.cells.split(","):
        cell, pairs = entry.split(":")
        for i in range(int(pairs)):
            seed += 1
            order = ("parent", "change") if i % 2 == 0 else ("change",
                                                             "parent")
            for side in order:
                line = run(sides[side], cell, seed, args.seconds, False,
                           out / f"{cell}.r{i}.{side}")
                bad += line is None or not line["correct"]
                lines.setdefault((cell, side), []).append(line)
    for cell in filter(None, args.trace.split(",")):
        seed += 1
        for side in ("parent", "change"):
            line = run(sides[side], cell, seed, args.seconds, True,
                       out / f"{cell}.t0.{side}")
            bad += line is None or not line["correct"]
    for (cell, side), got in sorted(lines.items()):
        got = [g for g in got if g]
        if got:
            med = {k: statistics.median(g["metrics"][k]["value"] for g in got)
                   for k in got[0]["metrics"]}
            print(f"median {cell} {side} ({len(got)} runs): {med}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
