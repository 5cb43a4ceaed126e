"""Runs one cell of the benchmark of ``sph_tpu_torch`` on the card and
prints its result as the last line of standard output (one JSON object).

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. ``--trace 0`` measures the cell's end-to-end
metrics over ``--seconds``; ``--trace 1`` runs the traffic's traced frames
under ``torch.profiler`` and reports the per-layer metrics. Either checks
the frames against the plain reference (``benchmark/reference``) and
prints each number compared beside its limit as the last lines of standard
error. Exits 2, printing no result, without as many CUDA cards as the cell
asks for.
"""
import time

T0 = time.perf_counter()    # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# build and kernel caches at fixed places inside the checkout
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_ext",
          "CUDA_CACHE_PATH": "cuda"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / ".bench_cache" / sub)
    sys.path[:0] = [str(HERE), str(ROOT)]
    from harness.cell import run_cell

    code, result = run_cell(ROOT, args.workload, args.seed, args.seconds,
                            bool(args.trace), T0)
    if result is not None:
        print(json.dumps(result), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
