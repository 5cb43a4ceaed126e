"""Async host IO: trajectory frames and checkpoints off the stepping loop
(counterpart of ``sph_tpu/runtime/async_io.py``).

ONE daemon worker thread and a bounded queue. ``submit`` hands the writer
callable and its arguments to the worker, which formats and writes them
while the main thread goes on stepping. The bounded queue applies
backpressure (at most ``maxsize`` writes in flight); ``flush()`` drains;
a worker exception is captured and re-raised on the next
``submit``/``flush``, so IO errors cannot pass silently.

Unlike a jax array, a CUDA tensor must not be read from the worker: a
``.cpu()`` there runs on the worker thread's current stream, not on the
stream that produced the tensor. So ``submit`` stages every tensor on the
main thread, in its arguments and in the fields of any dataclass among
them (a ``FluidState``, ``Springs``, ``Membranes``): a CUDA tensor is
copied into pinned host memory with ``non_blocking=True`` on the current
stream and an event is recorded after the copy; the worker waits on that
event before it reads the host copy. A CPU tensor is cloned, so that a
later in-place write by the caller cannot reach a pending write.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import queue
import threading

import numpy as np
import torch

logger = logging.getLogger("sph_tpu_torch")

_SENTINEL = object()


class _HostCopy:
    """A tensor's host copy in flight: ``array()`` waits for the copy and
    returns it as a NumPy array."""

    def __init__(self, t: torch.Tensor):
        t = t.detach()
        if t.device.type == "cuda":
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host, self._event = t.clone(), None

    def array(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


def _stage(x):
    """On the main thread: every tensor in ``x`` (itself, the items of a
    tuple or list, the fields of a dataclass) replaced by its host copy."""
    if isinstance(x, torch.Tensor):
        return _HostCopy(x)
    if isinstance(x, (tuple, list)):
        return type(x)(_stage(a) for a in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _stage(getattr(x, f.name))
            for f in dataclasses.fields(x) if f.init})
    return x


def _materialize(x):
    """On the worker: every host copy in ``x`` as a NumPy array."""
    if isinstance(x, _HostCopy):
        return x.array()
    if isinstance(x, (tuple, list)):
        return type(x)(_materialize(a) for a in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _materialize(getattr(x, f.name))
            for f in dataclasses.fields(x) if f.init})
    return np.asarray(x) if hasattr(x, "shape") else x


class AsyncWriter:
    """Single-worker ordered async executor for host IO."""

    def __init__(self, maxsize: int = 4):
        self._q: queue.Queue = queue.Queue(maxsize=maxsize)
        self._err: BaseException | None = None
        self._done = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="sph-async-io", daemon=True
        )
        self._thread.start()

    def _loop(self):
        while True:
            item = self._q.get()
            try:
                if item is _SENTINEL:
                    return
                fn, args, kw = item
                fn(*_materialize(args), **{k: _materialize(v)
                                          for k, v in kw.items()})
            except BaseException as e:  # surfaced on next submit/flush
                if self._err is None:
                    self._err = e
                logger.error("async IO failed: %r", e)
            finally:
                self._q.task_done()

    def _raise_pending(self):
        if self._err is not None:
            err, self._err = self._err, None
            raise RuntimeError("async IO write failed") from err

    def submit(self, fn, *args, **kw) -> None:
        """Enqueue ``fn(*args, **kw)`` with every tensor among them (see
        the module docstring) handed over as a NumPy array; blocks only when
        ``maxsize`` writes are already in flight (backpressure)."""
        self._raise_pending()
        if self._done.is_set():
            raise RuntimeError("AsyncWriter is closed")
        self._q.put((fn, _stage(args), {k: _stage(v) for k, v in kw.items()}))

    def flush(self) -> None:
        """Wait until every submitted write has completed."""
        self._q.join()
        self._raise_pending()

    def close(self) -> None:
        if self._done.is_set():
            return
        self._done.set()
        self._q.put(_SENTINEL)
        self._thread.join()
        self._raise_pending()


def save_npz_atomic(path: str, **arrays) -> None:
    """np.savez_compressed via a temp file + os.replace: a crash mid-write
    can never leave a truncated archive at the target path."""
    tmp = path + ".tmp.npz"  # savez appends .npz to other suffixes
    np.savez_compressed(tmp, **arrays)
    os.replace(tmp, path)
