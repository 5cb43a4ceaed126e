"""Wall-clock step timing and profiler traces (counterpart of
``sph_tpu/runtime/timing.py``).

PyTorch returns before the device finishes, so on a CUDA device every
reading synchronises first (``torch.cuda.synchronize``): a reading is the
time until the queued work is done, not the time to enqueue it.
"""
from __future__ import annotations

import contextlib
import time

import torch


class StepTimer:
    """Wall-clock milliseconds since the last ``refresh``; ``report``
    prints (through ``log``) and accumulates named sections. ``device``:
    where the timed work runs (the card unless the caller names the
    CPU)."""

    def __init__(self, device="cuda", log=None):
        self._cuda = torch.device(device).type == "cuda"
        self._log = log
        self._t0 = self._t1 = time.perf_counter()
        self.sections: dict[str, float] = {}

    def _now(self) -> float:
        if self._cuda:
            torch.cuda.synchronize()
        return time.perf_counter()

    def refresh(self) -> None:
        self._t0 = self._t1 = self._now()

    def report(self, label: str) -> float:
        """Milliseconds since the last refresh or report, added to
        ``sections[label]`` and logged."""
        now = self._now()
        ms = (now - self._t1) * 1e3
        self._t1 = now
        self.sections[label] = self.sections.get(label, 0.0) + ms
        if self._log:
            self._log(f"{label}: \t{ms:9.3f} ms")
        return ms

    @property
    def elapsed_ms(self) -> float:
        return (self._now() - self._t0) * 1e3


@contextlib.contextmanager
def profile_trace(log_dir: str, device="cuda"):
    """Record a ``torch.profiler`` trace of the block (the counterpart of
    sph_tpu's ``jax.profiler`` trace): CPU and CUDA activity on the card,
    CPU activity only when ``device`` is the CPU. On exit the card is
    drained and a Chrome trace (``<host>_<pid>.<stamp>.pt.trace.json``: open
    it in Perfetto or chrome://tracing) is written into ``log_dir``.
    Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    from torch.profiler import tensorboard_trace_handler

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
