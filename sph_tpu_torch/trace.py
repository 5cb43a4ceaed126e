"""The port's tracer: where a call's time goes inside the program.

It is off unless turned on (:func:`tracing`, or :func:`enable` and
:func:`disable`; ``runtime.timing`` re-exports the user's calls); turning
it on from off starts a fresh record. While it is off, :func:`span`
returns one shared no-op context after a single check of a module-level
flag, and :func:`count`, :func:`mark`, :func:`anchor`, :func:`replayed`
and :func:`before_replay` return after the same check: no profiler range,
no CUDA event, no allocation. While it is on:

* a **span** records its name, start and end (``time.perf_counter_ns``),
  the id of the span open around it on the same thread (its parent, -1 for
  none) and a call id: a span opened with none around it starts a new call,
  and every span under it shares that id, so one ``Simulator.step`` or
  ``get_position`` is one call. Spans go to a ring of the last
  :data:`RING` (their ids keep counting, so an evicted parent's id is
  simply missing). While ``torch.profiler`` records, each span also opens
  ``record_function(name)``, so that its range sits on the profiler's
  timeline beside the kernels it launched;
* a **device mark** is an interval of the device's own timeline: a pair of
  CUDA timing events around work enqueued on a stream (:func:`mark`), or
  the events a period graph captured for the tracer records inside the
  graph (``core.graphed``), registered at each replay (:func:`replayed`)
  as the intervals :data:`PERIOD_MARKS`. Its times are read once its
  events have completed, and put on the host's ``perf_counter_ns`` clock
  through an anchor: an event recorded where the stream is known to be
  idle, right after a blocking read (:func:`anchor`) or at :func:`enable`
  after a ``synchronize``, whose host time is taken beside it. Host time at
  an event = the anchor's host time + ``elapsed_time(anchor, event)``. A
  mark records its name, start and end on the host clock, the span open
  when it was made (its parent) and that span's call id. Marks are read
  while the device runs a replay (:func:`replayed` reads those it has
  reached), so that reading them takes no host time from a gap in the
  device's work; a graph's events are overwritten by its next replay, so
  that replay first reads them (:func:`before_replay`), waiting where the
  device has not reached them yet (counted as ``trace.waits``): a cost
  only of tracing;
* a **counter** adds ``n`` to its name (:func:`count`). :func:`snapshot`
  also reports the launch and capture records the program keeps anyway
  (``ops.pair_kernels.LAUNCHES``, ``BOX_LAUNCHES`` and ``ops.pack.LAUNCHES``
  as ``launches.<kind>``, ``core.graphed.CAPTURES`` as ``graph.captures``
  and ``graph.capture_s``) and the ring kernels' device counters of the
  box cull, which only launches made with the tracer on keep
  (``ops.pair_kernels.cull_counters``: ``pair.<kind>.chunks`` and
  ``pair.<kind>.culled``, a device read), as their change since the
  record started.

Nothing is written out but through :func:`snapshot`; :func:`summary`
reduces one to the totals the CLI's ``--verbose`` prints. The module
imports nothing of the package at import time, so that every layer can
use it.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time

import torch

# most spans (and, apart, most device marks) the record keeps
RING = 65536
# unread marks beyond which a new mark reads those the device has reached
PENDING = 64
# idle gaps with no program span open
OUTSIDE = "outside the program"
# the intervals between a period graph's four events
PERIOD_MARKS = ("period.sort", "period.steps", "period.unsort")
# the fields of a span and of a mark in a snapshot
_SPAN = ("id", "name", "t0", "t1", "parent", "call")
_MARK = ("name", "t0", "t1", "parent", "call")

_ON = False


class _Null:
    """The context every call of :func:`span` and :func:`mark` returns
    while the tracer is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL = _Null()


class _Span:
    __slots__ = ("name", "id", "parent", "call", "t0", "rf")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        stack = _TRACER.stack()
        if stack:
            top = stack[-1]
            self.parent, self.call = top.id, top.call
        else:
            self.parent, self.call = -1, next(_TRACER.calls)
        self.id = next(_TRACER.ids)
        stack.append(self)
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _TRACER.stack().remove(self)
        _TRACER.spans.append((self.id, self.name, self.t0, t1, self.parent,
                              self.call))
        return False


class _Mark:
    __slots__ = ("name", "dev", "start", "owner")

    def __init__(self, name, dev):
        self.name, self.dev = name, dev

    def __enter__(self):
        self.owner = _TRACER.owner()
        self.start = _TRACER.event(self.dev)
        self.start.record(torch.cuda.current_stream(self.dev))
        return self

    def __exit__(self, *exc):
        end = _TRACER.event(self.dev)
        end.record(torch.cuda.current_stream(self.dev))
        # the anchor current now: one taken inside the block is as good
        # (an event before its anchor reads a negative elapsed time)
        _TRACER.pending.append((self.name, self.start, end, self.dev,
                                _TRACER.anchor_of(self.dev), self.owner,
                                True))
        if len(_TRACER.pending) > PENDING:
            _TRACER.settle(wait=False)
        return False


def _device_index(device) -> int:
    device = torch.device(device)
    return (device.index if device.index is not None
            else torch.cuda.current_device())


class Tracer:
    """The record behind the module's functions (one a process)."""

    def __init__(self):
        self._stacks = {}        # thread id -> its open spans
        self.reset()

    def reset(self):
        self.spans = collections.deque(maxlen=RING)
        self.marks = collections.deque(maxlen=RING)
        self.counters: dict[str, int | float] = {}
        # (name, start, end, device index, anchor, owner, pooled)
        self.pending = []
        self.anchors = {}        # device index -> (event, host ns)
        self.pool = {}           # device index -> free timing events
        self.ids, self.calls = itertools.count(1), itertools.count(1)
        self.t0, self.t1 = time.perf_counter_ns(), None
        self.base = {}           # the program's own counts at the start

    def stack(self) -> list:
        tid = threading.get_ident()
        stack = self._stacks.get(tid)
        if stack is None:
            stack = self._stacks[tid] = []
        return stack

    def owner(self):
        """(id, call id) of the innermost open span, (-1, 0) for none."""
        stack = self.stack()
        return (stack[-1].id, stack[-1].call) if stack else (-1, 0)

    def event(self, dev: int):
        free = self.pool.setdefault(dev, [])
        return free.pop() if free else torch.cuda.Event(enable_timing=True)

    def anchor_of(self, dev: int):
        """The device's current anchor; the first one after a
        ``synchronize``."""
        if dev not in self.anchors:
            torch.cuda.synchronize(dev)
            self.set_anchor(dev)
        return self.anchors[dev]

    def set_anchor(self, dev: int):
        """A new anchor, a fresh event (pending marks keep theirs)."""
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(dev))
        self.anchors[dev] = (ev, time.perf_counter_ns())

    def settle(self, events=None, wait=True):
        """Read pending marks into the record: those holding one of
        ``events`` where given, else all. ``wait``: wait where the device
        has not reached a mark's end yet (counted once a call as
        ``trace.waits``); else read, in the order made, those it has
        reached. A device's marks are on its stream, in order, so its last
        end reached means every one reached."""
        if events is None:
            todo = self.pending
        else:
            todo = [p for p in self.pending
                    if any(p[1] is e for e in events)]
        if not todo:
            return
        if wait:
            last = {p[3]: p[2] for p in todo}
            if not all(end.query() for end in last.values()):
                self.counters["trace.waits"] = (
                    self.counters.get("trace.waits", 0) + 1)
                for end in last.values():
                    end.synchronize()
        else:
            n = 0
            while n < len(todo) and todo[n][2].query():
                n += 1
            todo = todo[:n]
        done = set(map(id, todo))
        self.pending = [p for p in self.pending if id(p) not in done]
        at = {}         # host ns at each event, read once

        def host_ns(anc, ev):
            key = (id(anc[0]), id(ev))
            if key not in at:
                at[key] = anc[1] + round(anc[0].elapsed_time(ev) * 1e6)
            return at[key]
        for name, start, end, dev, anc, (parent, call), pooled in todo:
            self.marks.append((name, host_ns(anc, start), host_ns(anc, end),
                               parent, call))
            if pooled:
                self.pool.setdefault(dev, []).extend((start, end))


_TRACER = Tracer()


def _program_records() -> dict:
    """The counts the program keeps whether tracing or not."""
    from .core import graphed
    from .ops import pack, pair_kernels

    out = {f"launches.{k}": v for c in (pair_kernels.LAUNCHES,
                                        pair_kernels.BOX_LAUNCHES,
                                        pack.LAUNCHES)
           for k, v in c.items()}
    out.update(pair_kernels.cull_counters())
    out["graph.captures"] = len(graphed.CAPTURES)
    out["graph.capture_s"] = sum(c["capture_s"] for c in graphed.CAPTURES)
    return out


def _start() -> None:
    """A fresh record; while on, anchored after a ``synchronize`` on a card
    that CUDA has been started on."""
    _TRACER.reset()
    _TRACER.base = _program_records()
    if _ON and torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
        _TRACER.set_anchor(torch.cuda.current_device())


def on() -> bool:
    """Whether the tracer is on."""
    return _ON


def enable() -> None:
    """Turn the tracer on; from off, a fresh record starts."""
    global _ON
    if not _ON:
        _ON = True
        _start()


def disable() -> None:
    """Turn the tracer off; the record stays for :func:`snapshot`."""
    global _ON
    if _ON:
        _ON = False
        _TRACER.t1 = time.perf_counter_ns()


@contextlib.contextmanager
def tracing():
    """The tracer on within the block (left on where it was on)."""
    was = _ON
    enable()
    try:
        yield
    finally:
        if not was:
            disable()


def span(name: str):
    """A context that records the block as the span ``name``."""
    if not _ON:
        return NULL
    return _Span(name)


def count(name: str, n=1) -> None:
    """Add ``n`` to the counter ``name``."""
    if not _ON:
        return
    _TRACER.counters[name] = _TRACER.counters.get(name, 0) + n


def mark(name: str, device):
    """A context that records the device interval of the work the block
    enqueues on ``device``'s current stream as the mark ``name`` (nothing
    on a device other than a CUDA card)."""
    if not _ON or torch.device(device).type != "cuda":
        return NULL
    return _Mark(name, _device_index(device))


def anchor(device) -> None:
    """Call where ``device``'s stream is known to be idle (right after a
    blocking read): takes a new anchor."""
    if not _ON or torch.device(device).type != "cuda":
        return
    _TRACER.set_anchor(_device_index(device))


def before_replay(events) -> None:
    """Call before a replay records ``events`` again: reads the marks of
    its previous replay (waiting for the device where it has not reached
    them)."""
    if not _ON or events is None:
        return
    _TRACER.settle(events)


def replayed(events, device) -> None:
    """Register the marks between consecutive ``events`` of the replay
    just launched on ``device``: ``PERIOD_MARKS[i]`` spans ``events[i]`` to
    ``events[i + 1]``. First reads the earlier marks the device has
    reached, while it runs the replay."""
    if not _ON or events is None or torch.device(device).type != "cuda":
        return
    _TRACER.settle(wait=False)
    dev = _device_index(device)
    anc, owner = _TRACER.anchor_of(dev), _TRACER.owner()
    for name, a, b in zip(PERIOD_MARKS, events, events[1:]):
        _TRACER.pending.append((name, a, b, dev, anc, owner, False))


def reset() -> None:
    """Clear the record (spans, marks, counters); a fresh one starts."""
    _start()


def snapshot() -> dict:
    """The record since it started: ``spans`` and ``marks`` (dicts of name,
    ``t0``, ``t1`` in host ``perf_counter_ns``, ``parent``, ``call``; a
    span also its ``id``), ``counters`` and the record's bounds ``t0`` and
    ``t1`` (now, while the tracer is on). Reads pending marks first,
    waiting for the device where needed."""
    tr = _TRACER
    tr.settle()
    counters = dict(tr.counters)
    for k, v in _program_records().items():
        if v != tr.base.get(k, 0):
            counters[k] = v - tr.base.get(k, 0)
    return dict(spans=[dict(zip(_SPAN, s)) for s in tr.spans],
                marks=[dict(zip(_MARK, m)) for m in tr.marks],
                counters=counters, t0=tr.t0,
                t1=tr.t1 if tr.t1 is not None else time.perf_counter_ns())


def _union(intervals, lo, hi):
    """(busy ns, idle gaps) of ``intervals`` clipped to [lo, hi]."""
    busy, gaps, cur = 0, [], lo
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals
                       if e > lo and s < hi):
        if s > cur:
            gaps.append((cur, s))
        if e > cur:
            busy += e - max(s, cur)
            cur = e
    if hi > cur:
        gaps.append((cur, hi))
    return busy, gaps


def idle_by_span(spans, gaps) -> dict:
    """Nanoseconds of ``gaps`` charged to the innermost span open during
    each part of them (:data:`OUTSIDE` where none is): a sweep over the
    spans' and gaps' bounds, with the open spans kept in order of
    opening."""
    points = []
    for i, s in enumerate(spans):
        points += [(s["t0"], 0, i), (s["t1"], 1, i)]
    for s, e in gaps:
        points += [(s, 3, -1), (e, 2, -1)]
    points.sort()
    open_, idle, in_gap, last = [], {}, False, None
    for t, kind, i in points:
        if in_gap and last is not None and t > last:
            # the innermost open span: the last opened of the open ones
            name = spans[max(open_, key=lambda j: spans[j]["t0"])][
                "name"] if open_ else OUTSIDE
            idle[name] = idle.get(name, 0) + (t - last)
        last = t
        if kind == 0:
            open_.append(i)
        elif kind == 1:
            open_.remove(i)
        else:
            in_gap = kind == 3
    return idle


def summary(snap: dict, top: int = 10) -> dict:
    """A snapshot reduced: ``host_ms`` and ``device_ms`` by span and mark
    name (summed), ``window_s`` (the record's bounds), ``busy_s`` (the
    union of the marks), ``idle_share`` (1 − busy / window, None without
    marks) and ``idle_gaps`` (the record's idle seconds by the innermost
    span open during them, the largest ``top``)."""
    host, dev = {}, {}
    for s in snap["spans"]:
        host[s["name"]] = host.get(s["name"], 0.0) + (s["t1"] - s["t0"]) / 1e6
    for m in snap["marks"]:
        dev[m["name"]] = dev.get(m["name"], 0.0) + (m["t1"] - m["t0"]) / 1e6
    lo, hi = snap["t0"], snap["t1"]
    busy, gaps = _union([(m["t0"], m["t1"]) for m in snap["marks"]], lo, hi)
    idle = idle_by_span(snap["spans"], gaps) if snap["marks"] else {}
    window = (hi - lo) / 1e9
    return dict(
        host_ms=host, device_ms=dev, window_s=window, busy_s=busy / 1e9,
        idle_share=(1.0 - busy / (hi - lo)) if snap["marks"] and hi > lo
        else None,
        idle_gaps=[[k, v / 1e9] for k, v in sorted(
            idle.items(), key=lambda kv: -kv[1])[:top]])


def report(snap: dict) -> list:
    """The lines of the CLI's ``--verbose`` view of a snapshot: host ms by
    span, device ms by mark with the idle share and its largest gaps, and
    the counters."""
    s = summary(snap, top=3)

    def fmt(d, spec):
        return ", ".join(f"{k} {v:{spec}}" for k, v in sorted(
            d.items(), key=lambda kv: -kv[1]))
    lines = [f"  host ms: {fmt(s['host_ms'], '.3f')}"]
    if s["device_ms"]:
        gaps = ", ".join(f"{k} {1e3 * v:.3f}" for k, v in s["idle_gaps"])
        lines.append(f"  device ms: {fmt(s['device_ms'], '.3f')}; idle "
                     f"{s['idle_share']:.3f} of {1e3 * s['window_s']:.3f} "
                     f"ms (ms by span: {gaps})")
    lines.append("  counters: " + ", ".join(
        f"{k} {v:.6g}" for k, v in sorted(snap["counters"].items())))
    return lines
