"""The measured window: one client's closed loop, as a user steps and reads
the simulation.

A frame is ``sim.step(k)`` then ``sim.get_position()``, which brings the
positions into host memory. A frame fails when it does not arrive (the call
raises) or holds a non-finite position. ``check_overflow`` runs once after
the window has closed (:func:`close`): the engines keep their dropped-pair
counts since the last check, so one read sees every frame's, and the
positions-based count of the fast engine is taken at the last frame and at
every sampled one. A report fails every frame of the window.

The frames kept for the check are a uniform sample of the window's frames,
drawn from the seed as they come (reservoir sampling): each keeps the state
the frame started from and the state and positions it ended with.
"""
from __future__ import annotations

import contextlib
import dataclasses
import random
import time

import numpy as np


@dataclasses.dataclass
class Frame:
    start: object          # the program's state before the frame
    end: object            # its state after the frame
    pos: np.ndarray        # the positions the frame read into host memory


@dataclasses.dataclass
class Window:
    arrivals: list         # seconds from the window's start to each frame
    failed: int
    sample: list           # Frame
    last_pos: np.ndarray | None
    reads: list            # seconds of each get_position(), where timed


def overflow_failed(report: dict) -> bool:
    return any(v > 0 for k, v in report.items() if k.endswith("overflow"))


class Sampler:
    """A uniform sample of ``size`` frames of a stream, drawn from ``seed``."""

    def __init__(self, size: int, seed: int):
        self.size, self.rng, self.kept, self.seen = (
            size, random.Random(seed), [], 0)

    def offer(self, make):
        i, self.seen = self.seen, self.seen + 1
        if len(self.kept) < self.size:
            self.kept.append(make())
        else:
            j = self.rng.randrange(i + 1)
            if j < self.size:
                self.kept[j] = make()


def run(sim, k: int, *, seconds: float | None = None,
        frames: int | None = None, sampler: Sampler, sync=None,
        span=None) -> Window:
    """Frames until ``seconds`` have passed (the last frame ends the window)
    or ``frames`` have arrived. ``sync``: drains the card before each read,
    which is then timed by the host clock (``Window.reads``); ``span(name)``:
    a context manager around each part of a frame (the traced run's
    labels)."""
    clock = time.perf_counter
    span = span or (lambda name: contextlib.nullcontext())
    arrivals, reads, failed = [], [], 0
    pos = None
    t0 = clock()
    i = 0
    while True:
        start = sim.state
        try:
            with span("frame.step"):
                sim.step(k)
            if sync is not None:
                sync()
                t_read = clock()
            with span("frame.read"):
                pos = sim.get_position()
            if sync is not None:
                reads.append(clock() - t_read)
        except RuntimeError:
            # the frame never arrives, and no later one can
            arrivals.append(clock() - t0)
            failed += 1
            break
        arrivals.append(clock() - t0)
        with span("frame.check"):
            failed += not np.isfinite(pos.sum())
        end = sim.state
        sampler.offer(lambda: Frame(start, end, pos))
        i += 1
        if (seconds is not None and arrivals[-1] >= seconds) or (
                frames is not None and i >= frames):
            break
    return Window(arrivals, failed, sampler.kept, pos, reads)


def close(sim, w: Window) -> bool:
    """Whether ``check_overflow`` reports dropped pairs, read at the last
    frame's positions, then at each sampled frame's."""
    if w.last_pos is None:
        return False
    return any(overflow_failed(sim.check_overflow(pos))
               for pos in [w.last_pos] + [f.pos for f in w.sample])
