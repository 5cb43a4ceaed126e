"""Wall-clock step timing, profiler traces, and the tracer's calls.

``StepTimer`` and ``profile_trace`` are the counterparts of
``sph_tpu/runtime/timing.py``. The tracer lives in ``sph_tpu_torch.trace``
(below every layer, so that the engine can record into it); its calls for
the user (:func:`tracing`, :func:`enable`, :func:`disable`, :func:`span`,
:func:`count`, :func:`snapshot`, :func:`reset`, :func:`summary`,
:func:`report`) are re-exported here.

PyTorch returns before the device finishes, so on a CUDA device every
``StepTimer`` reading synchronises first (``torch.cuda.synchronize``): a
reading is the time until the queued work is done, not the time to enqueue
it.
"""
from __future__ import annotations

import contextlib
import time

import torch

from ..trace import (count, disable, enable, report, reset, snapshot, span,
                     summary, tracing)

__all__ = ["StepTimer", "profile_trace", "count", "disable", "enable",
           "report", "reset", "snapshot", "span", "summary", "tracing"]


class StepTimer:
    """Wall-clock milliseconds since the last ``refresh``. ``device``: where
    the timed work runs (the card unless the caller names the CPU)."""

    def __init__(self, device="cuda"):
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


@contextlib.contextmanager
def profile_trace(log_dir: str, device="cuda"):
    """Record a ``torch.profiler`` trace of the block (the counterpart of
    sph_tpu's ``jax.profiler`` trace): CPU and CUDA activity on the card,
    CPU activity only when ``device`` is the CPU. The tracer is on within
    the block, so the program's spans appear as ranges beside the kernels.
    On exit the card is drained and a Chrome trace
    (``<host>_<pid>.<stamp>.pt.trace.json``: open it in Perfetto or
    chrome://tracing) is written into ``log_dir``. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    from torch.profiler import tensorboard_trace_handler

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        with tracing():
            yield prof
        if cuda:
            torch.cuda.synchronize()
