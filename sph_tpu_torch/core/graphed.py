"""A resort period captured once as a CUDA graph and replayed: the port's
counterpart of the ``jax.jit`` over nested ``lax.scan``s that sph_tpu's
``make_fastw_multi_step`` and ``make_fast_multi_step`` return.

A period is ``sort_ctx -> carry_of -> r_steps x inner_step ->
unsort_state`` plus its diagnostics (the window drift and the sort's
overflow counts). Eagerly the host dispatches every glue op and pair launch
of it, ~444 kernels a step on the fastw worm; replayed, one graph launch a
period.

:class:`PeriodGraph` holds one period length on one device:

* static inputs: the changing fields of the state (``pos``, ``vel``,
  ``muscle_activation``, ``step``) are copied into buffers the graph reads;
  ``ptype``, ``normal``, the springs and the membranes never change and
  are captured by reference, as are the engine's constants and
  ``wall_static`` (closed over by the parts). Every call checks that the
  caller passes the same reference tensors (data pointer and shape) and
  raises if not;
* the first call runs one period eagerly on a side stream (the warm-up
  ``torch.cuda.graphs`` asks for: it makes every launch the graph will
  hold, so the kernels are loaded and their shared-memory opt-ins are set
  before capture), then captures the period, then replays it;
* every call returns clones of the graph's outputs: a caller that keeps an
  earlier state never sees it overwritten by a later replay.

A capture that fails raises, with the failing op's traceback chained;
nothing falls back to the eager loop.

Launch counts: ``pair_kernels.LAUNCHES`` (and ``BOX_LAUNCHES``) and
``pack.LAUNCHES`` count the wrappers' Python calls, and a replay makes
none. The warm-up and the capture are set-up: the counts they add are
taken back, and the capture's are added again at every replay, so each
call counts one period's launches as the eager loop does. (The box cull's
device counters, which a marked graph's kernels add to, count its warm-up
period too.)

Every capture appends its record to :data:`CAPTURES` (steps, capture plus
instantiate seconds, pool bytes, launches a replay), which measurement
scripts and the tracer read.

Device marks: a graph captured for the tracer (``sph_tpu_torch.trace``;
``marked``) records four CUDA timing events (``external``, so that the
capture holds them as event nodes) at its period's start, after the sort
(``sort_ctx`` and ``carry_of``), after the ``r_steps`` inner steps and
after ``unsort_state``; each replay registers the three intervals between
them (``period.sort``, ``period.steps``, ``period.unsort``). The runner
keeps a marked and an unmarked graph of a period length apart and replays
the one the tracer's state asks for, so that an untraced call replays a
graph with no event node: the first traced call of a period length
captures its marked graph, and replays it bitwise as the unmarked one.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from .. import trace
from ..ops import pack as pack_ops
from ..ops import pair_kernels as pk
from .state import FluidState

# the launch counters a period can add to
_COUNTERS = (pk.LAUNCHES, pk.BOX_LAUNCHES, pack_ops.LAUNCHES)
# the fields of a state that change from period to period
_CHANGING = ("pos", "vel", "muscle_activation", "step")
# one record a capture: r_steps, capture_s (capture plus instantiate
# seconds), pool_bytes (the device memory it reserved: the graph's private
# pool) and launches (the counts a replay adds)
CAPTURES: list[dict] = []


def run_period(parts, r_steps: int, state: FluidState, springs, membranes,
               marks=None):
    """One resort period eagerly: (state after r_steps, diag), diag the
    sort's overflow counts and the period's window drift. ``marks``: four
    CUDA events, recorded at the start, after the sort, after the steps and
    after the unsort."""
    if marks:
        marks[0].record()
    ctx, diag = parts.sort_ctx(state, springs, membranes)
    carry = parts.carry_of(ctx, state)
    if marks:
        marks[1].record()
    for _ in range(r_steps):
        carry = parts.inner_step(ctx, carry)
    if marks:
        marks[2].record()
    out = parts.unsort_state(ctx, carry, state)
    if marks:
        marks[3].record()
    return out, dict(diag, window_drift=carry[-1])


def period_runner(parts, n_steps: int, resort_every: int,
                  cuda_graph: bool = True):
    """run(state, springs, membranes) -> (state, diag) after ``n_steps``:
    whole periods of ``resort_every`` steps, the last one shorter, each
    replayed from its length's graph when ``cuda_graph`` is set and the
    state is on a CUDA device, else run eagerly. ``diag`` holds each key's
    max over the periods."""
    if n_steps < 1:
        raise ValueError(f"n_steps must be at least 1, got {n_steps}")
    r_every = max(1, resort_every)
    full, rem = divmod(n_steps, r_every)
    periods = [r_every] * full + ([rem] if rem else [])
    graphs = {}

    def run(state, springs, membranes):
        graphed = cuda_graph and state.pos.device.type == "cuda"
        diag = {}
        for r_steps in periods:
            with trace.span("engine.period"):
                trace.count("engine.periods")
                trace.count("engine.steps", r_steps)
                if graphed:
                    marked = trace.on()
                    key = (r_steps, state.pos.device, marked)
                    if key not in graphs:
                        graphs[key] = PeriodGraph(parts, r_steps, marked)
                    state, d = graphs[key](state, springs, membranes)
                else:
                    state, d = run_period(parts, r_steps, state, springs,
                                          membranes)
                diag = {k: torch.maximum(diag[k], v) if k in diag else v
                        for k, v in d.items()}
        return state, diag

    return run


def _refs(state, springs, membranes):
    """(name, data pointer, shape) of every tensor a graph reads by
    reference, and the dtype, shape and device of each field it copies."""
    out = [(f"state.{f}", getattr(state, f).data_ptr(),
            tuple(getattr(state, f).shape)) for f in ("ptype", "normal")]
    for obj, label in ((springs, "springs"), (membranes, "membranes")):
        for f in dataclasses.fields(obj):
            t = getattr(obj, f.name)
            out.append((f"{label}.{f.name}", t.data_ptr(), tuple(t.shape)))
    for f in _CHANGING:
        t = getattr(state, f)
        out.append((f"state.{f}", t.dtype, tuple(t.shape), t.device))
    return out


class PeriodGraph:
    """One resort period of ``r_steps`` steps, captured as a CUDA graph at
    its first call and replayed at every later one (see the module
    docstring). ``launches`` holds the counts its capture added, one dict
    a counter. ``marked``: the graph records the tracer's four timing
    events, ``marks`` (made at the capture; None unmarked)."""

    def __init__(self, parts, r_steps: int, marked: bool = False):
        self.parts, self.r_steps, self.marked = parts, r_steps, marked
        self.graph = self.launches = self.marks = None
        self._in = self._args = self._refs = self._out = None

    def eager(self, state, springs, membranes):
        """The captured function run without capture (any device): the
        state copied into the static inputs, the period on them, clones of
        its outputs."""
        self._stage(state, springs, membranes)
        return self._result(self._body())

    def __call__(self, state, springs, membranes):
        """(state, diag) after one replay of the period (captured first at
        the first call); the state must be on a CUDA device."""
        dev = state.pos.device
        with torch.cuda.device(dev):
            with trace.span("graph.stage"), trace.mark("facade.eager", dev):
                self._stage(state, springs, membranes)
            if self.graph is None:
                with trace.span("graph.capture"):
                    self._capture()
            trace.before_replay(self.marks)
            with trace.span("graph.replay"):
                self.graph.replay()
            trace.count("graph.replays")
            trace.replayed(self.marks, dev)
            for counter, add in zip(_COUNTERS, self.launches):
                for k, v in add.items():
                    counter[k] += v
            with trace.span("graph.result"), trace.mark("facade.eager",
                                                         dev):
                return self._result(self._out)

    def _stage(self, state, springs, membranes):
        refs = _refs(state, springs, membranes)
        if self._in is None:
            self._in = dataclasses.replace(
                state, **{f: getattr(state, f).clone() for f in _CHANGING})
            self._args, self._refs = (springs, membranes), refs
            return
        if refs != self._refs:
            diff = [a[0] for a, b in zip(refs, self._refs) if a != b]
            raise ValueError(
                f"the {self.r_steps}-step period graph reads other tensors "
                f"than it was captured with: {', '.join(diff)}; a graph "
                "holds its state's ptype and normal, its springs and its "
                "membranes by reference (build a new runner for new ones)")
        for f in _CHANGING:
            getattr(self._in, f).copy_(getattr(state, f))

    def _body(self):
        return run_period(self.parts, self.r_steps, self._in, *self._args,
                          marks=self.marks)

    def _result(self, out):
        state, diag = out
        return (dataclasses.replace(
                    state, **{f: getattr(state, f).clone()
                              for f in _CHANGING}),
                {k: v.clone() for k, v in diag.items()})

    def _capture(self):
        before = [dict(c) for c in _COUNTERS]
        if self.marked:
            self.marks = [torch.cuda.Event(enable_timing=True,
                                           external=True) for _ in range(4)]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self._body()
        torch.cuda.current_stream().wait_stream(side)
        _set_counts(before)
        torch.cuda.synchronize()
        # torch.cuda.graph empties the cache before it captures: so does
        # this, so that the growth in reserved memory is the graph's pool
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph):
                out = self._body()
        except RuntimeError as e:
            _set_counts(before)
            raise RuntimeError(f"capture of the {self.r_steps}-step period "
                               f"failed: {e}") from e
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        self.launches = [{k: c[k] - b[k] for k in c if c[k] != b[k]}
                         for c, b in zip(_COUNTERS, before)]
        CAPTURES.append(dict(
            r_steps=self.r_steps, capture_s=capture_s,
            pool_bytes=torch.cuda.memory_reserved() - reserved,
            launches=self.launches[0]))
        _set_counts(before)
        self.graph, self._out = graph, out


def _set_counts(values):
    for counter, saved in zip(_COUNTERS, values):
        counter.update(saved)

