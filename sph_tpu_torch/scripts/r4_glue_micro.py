"""Glue micro-benchmark (counterpart of ``scripts/r4_glue_micro.py``): what
does assembling an ``[8, n]`` field pack cost on the card, and which
construction is cheapest?

    python -m sph_tpu_torch.scripts.r4_glue_micro

Candidates at n = 232,192 and 8 rows, each timed with CUDA events around
200 back-to-back calls after one warm-up call:

  A  torch.stack(fields, 0)               (the engines' ``_pack``)
  B  torch.cat of [1, n] views
  C  torch.zeros([8, n]) + a row copy_ each
  D  the Hopper ``Pack`` kernel (``ops/csrc/pack.cu``), the counterpart
     of the TPU candidate ``pallas_pack``

beside a dispatch baseline (x + 1.0 on one row) and a fusion probe (A
followed by a row sum). Before timing, D is held bitwise against A. Needs
a CUDA card: it measures the device and has no CPU fallback.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops.pack import pack

N = 232192  # ~ the worm's n_pad
ROWS = 8
REPS = 200


def time_ms(fn, reps: int = REPS) -> float:
    """Mean device milliseconds a call: CUDA events around ``reps`` calls,
    after one untimed call."""
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


def make_fields(n: int = N, rows: int = ROWS, seed: int = 0,
                device="cuda") -> list[torch.Tensor]:
    """``rows`` standard-normal f32 vectors of ``n``, made with numpy."""
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal(n).astype(np.float32),
                            device=device) for _ in range(rows)]


def candidates(fields) -> dict:
    """name -> zero-argument callable of each timed construction."""
    rows, n = len(fields), fields[0].shape[0]

    def at_set():
        out = torch.zeros((rows, n), dtype=torch.float32,
                          device=fields[0].device)
        for i, x in enumerate(fields):
            out[i].copy_(x)
        return out

    return {
        "dispatch baseline (x + 1.0 on one row)": lambda: fields[0] + 1.0,
        "A torch.stack(fields, 0)": lambda: torch.stack(fields, 0),
        "B cat of [1, n] views": lambda: torch.cat(
            [x.view(1, -1) for x in fields], 0),
        "C zeros + row copy_": at_set,
        "D Pack kernel (csrc/pack.cu)": lambda: pack(fields),
        "A + row reduction (fusion probe)": lambda: torch.stack(
            fields, 0).sum(dim=1),
    }


def run() -> dict:
    """name -> mean ms a call on the current card, after holding D bitwise
    against A."""
    if not torch.cuda.is_available():
        raise RuntimeError("r4_glue_micro measures a CUDA card; none is "
                           "available")
    fields = make_fields()
    a, d = torch.stack(fields, 0), pack(fields)
    if not torch.equal(a, d):
        bad = int((a != d).any(dim=0).sum())
        raise RuntimeError(f"Pack kernel differs from torch.stack on {bad} "
                           f"of {N} columns")
    return {name: time_ms(fn) for name, fn in candidates(fields).items()}


def main() -> int:
    times = run()
    print(f"device: {torch.cuda.get_device_name(0)}; n={N}, rows={ROWS}, "
          f"{REPS} calls a candidate; D == A bitwise", flush=True)
    for name, ms in times.items():
        print(f"{name:44s} {ms:9.5f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
