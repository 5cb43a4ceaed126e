"""Wall-clock step timing (counterpart of ``sph_tpu/runtime/timing.py``).

PyTorch returns before the device finishes, so on a CUDA device every
reading synchronises first (``torch.cuda.synchronize``): a reading is the
time until the queued work is done, not the time to enqueue it.
"""
from __future__ import annotations

import time

import torch


class StepTimer:
    """Wall-clock milliseconds since the last ``refresh``."""

    def __init__(self, device="cpu"):
        self._cuda = torch.device(device).type == "cuda"
        self._t0 = time.perf_counter()

    def _now(self) -> float:
        if self._cuda:
            torch.cuda.synchronize()
        return time.perf_counter()

    def refresh(self) -> None:
        self._t0 = self._now()

    @property
    def elapsed_ms(self) -> float:
        return (self._now() - self._t0) * 1e3
