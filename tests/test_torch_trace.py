"""The port's tracer (``sph_tpu_torch/trace.py``, its user's calls
re-exported by ``runtime/timing.py``) on the CPU: off, it records nothing
and makes no span object, event, profiler range or lasting allocation a
call; on, the facade's and the period runner's spans nest by parent with
one call id a facade call, its counters count the steps, periods, host
syncs and read bytes, the ring keeps its bound, the summary charges idle
gaps to the innermost open span, ``profile_trace`` shows the spans and the
CLI's ``-v`` prints the tracer's view. A period graph (its capture faked as
in ``tests/test_torch_graph.py``) captured for the tracer records its four
events at the capture and none at a replay, one captured for an untraced
call has none, and the runner keeps the two apart. On a CUDA card (marked
``cuda``, skipped here) the in-graph marks give positive times, a graph
captured with the tracer off replays bitwise as one captured with it on,
and a capture inside ``profile_trace`` works.

The module imports neither jax nor sph_tpu, so that on a machine with a
card and no jax its card test runs alone:
``python -m pytest --noconftest -m cuda tests/test_torch_trace.py``."""
import itertools
import json
import types
import tracemalloc

import numpy as np
import pytest
import torch

from sph_tpu_torch import trace
from sph_tpu_torch.cli import main as cli_main
from sph_tpu_torch.core import graphed
from sph_tpu_torch.runtime import Simulator, timing

from test_torch_graph import (RESORT, _FakeEvent, box_scene, engine_parts,
                              fake_cuda)  # noqa: F401 (fixture)


@pytest.fixture(autouse=True)
def tracer_off():
    """Every test starts and ends with the tracer off and its record
    empty."""
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def small_sim(engine="fastw", device="cpu"):
    params, scene = box_scene(kick=False)
    return Simulator(scene, params, engine=engine, device=device,
                     fast_config=dict(resort_every=RESORT)), scene


def _calls(n, dev):
    for _ in itertools.repeat(None, n):     # no int made a turn
        with trace.span("sim.step"), trace.mark("read.copy", dev):
            trace.count("sim.host_syncs")
            trace.anchor(dev)
            trace.before_replay(None)
            trace.replayed(None, dev)


def test_off_records_nothing(monkeypatch):
    """Off: every span is the one shared null context, a mark too; no span
    or mark object, CUDA event or profiler range is made (each raises
    here), not even while a profiler records; 1,000 calls leave
    no memory behind and no more at their peak than one call (the
    ``with`` statement's own); a Simulator's steps and read record no
    span, mark or counter."""
    assert timing.span is trace.span and timing.tracing is trace.tracing
    assert trace.span("sim.step") is trace.span("graph.replay") is \
        trace.NULL
    assert trace.mark("read.copy", "cuda") is trace.NULL

    def refused(*args, **kwargs):
        raise AssertionError("the tracer acted while off")
    sim, scene = small_sim()
    for obj, name in ((trace, "_Span"), (trace, "_Mark"),
                      (torch.cuda, "Event"), (torch.profiler,
                                              "record_function"),
                      (torch.autograd.profiler, "record_function")):
        monkeypatch.setattr(obj, name, refused)
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", lambda: True)
    dev = torch.device("cuda")
    _calls(10, dev)
    tracemalloc.start()
    try:
        peaks = []
        for n in (1, 1000):
            tracemalloc.reset_peak()
            c0 = tracemalloc.get_traced_memory()[0]
            _calls(n, dev)
            c1, peak = tracemalloc.get_traced_memory()
            assert c1 == c0
            peaks.append(peak - c0)
    finally:
        tracemalloc.stop()
    assert peaks[1] <= peaks[0]
    sim.step(3)
    pos = sim.get_position()
    assert np.isfinite(pos).all()
    snap = timing.snapshot()
    assert snap["spans"] == [] and snap["marks"] == []
    assert not {k for k in snap["counters"] if k.startswith(
        ("sim.", "engine.", "graph.replays", "trace."))}


@pytest.mark.parametrize("engine", ["fastw", "fast"])
def test_facade_spans_nest_by_call(engine):
    """On: ``step(k)`` is one call (``sim.step`` with ``engine.period``
    children, a period each; fastw also reads its shell overflow, one
    ``sim.sync``), ``get_position`` another (``sim.read`` over
    ``sim.read.copy``); ``engine.steps`` is k, ``engine.periods`` the
    period count, ``sim.read_bytes`` n x 12. The CPU makes no device
    mark."""
    sim, scene = small_sim(engine)
    k = 2 * RESORT + 1
    with timing.tracing():
        sim.step(k)
        pos = sim.get_position()
    snap = timing.snapshot()
    spans = snap["spans"]
    by_id = {s["id"]: s for s in spans}
    step = [s for s in spans if s["name"] == "sim.step"]
    read = [s for s in spans if s["name"] == "sim.read"]
    assert len(step) == len(read) == 1
    step, read = step[0], read[0]
    assert step["parent"] == read["parent"] == -1
    assert step["call"] != read["call"]
    periods = [s for s in spans if s["name"] == "engine.period"]
    assert len(periods) == 3                     # 2, 2 and 1 steps
    syncs = [s for s in spans if s["name"] == "sim.sync"]
    assert len(syncs) == (engine == "fastw")
    for s in periods + syncs + [x for x in spans if x["name"] == "sim.diag"]:
        assert s["parent"] == step["id"] and s["call"] == step["call"]
        assert step["t0"] <= s["t0"] <= s["t1"] <= step["t1"]
    copy = [s for s in spans if s["name"] == "sim.read.copy"]
    assert len(copy) == 1 and copy[0]["parent"] == read["id"]
    assert copy[0]["call"] == read["call"]
    for s in spans:                  # every parent is an enclosing span
        if s["parent"] != -1:
            p = by_id[s["parent"]]
            assert p["t0"] <= s["t0"] <= s["t1"] <= p["t1"]
    c = snap["counters"]
    assert c["engine.steps"] == k and c["engine.periods"] == 3
    assert c["sim.read_bytes"] == scene.n_particles * 12 == pos.nbytes
    assert c.get("sim.host_syncs", 0) == (engine == "fastw")
    assert snap["marks"] == []
    assert snap["t0"] <= step["t0"] and read["t1"] <= snap["t1"]


def test_ring_holds_its_bound_and_reset_clears(monkeypatch):
    """The ring keeps the last ``RING`` spans (ids count on); ``reset``
    empties spans and counters; the record outlives ``disable``."""
    monkeypatch.setattr(trace, "RING", 8)
    with timing.tracing():
        for i in range(20):
            with timing.span(f"s{i}"):
                timing.count("n")
    snap = timing.snapshot()
    assert [s["name"] for s in snap["spans"]] == [f"s{i}"
                                                  for i in range(12, 20)]
    assert [s["id"] for s in snap["spans"]] == list(range(13, 21))
    assert snap["counters"]["n"] == 20
    timing.reset()
    snap = timing.snapshot()
    assert snap["spans"] == [] and snap["counters"] == {}


def test_fake_capture_records_only_its_four_events(fake_cuda, monkeypatch):
    """A period graph captured for the tracer (``marked``) makes its four
    timing events at the capture (``external``, so the capture holds them)
    and records them at the warm-up and the capture only: a replay records
    nothing more, the tracer on or off. One captured for untraced calls
    makes and records none. On, a graph's calls give ``graph.stage``,
    ``graph.capture`` (the first call only), ``graph.replay`` and
    ``graph.result`` spans and count ``graph.replays`` and
    ``graph.captures``."""
    from sph_tpu_torch.ops import pack as pack_ops
    from sph_tpu_torch.ops import pair_kernels as pk

    monkeypatch.setattr(pk, "LAUNCHES", dict.fromkeys(pk.LAUNCHES, 0))
    monkeypatch.setattr(pack_ops, "LAUNCHES", {"pack": 0})
    monkeypatch.setattr(graphed, "_COUNTERS",
                        (pk.LAUNCHES, pack_ops.LAUNCHES))
    monkeypatch.setattr(graphed, "CAPTURES", [])
    params, scene = box_scene(kick=False)
    parts, _ = engine_parts("fastw", params, scene)
    state, springs, membranes = scene.device_state("cpu")
    plain = graphed.PeriodGraph(parts, RESORT)
    for _ in range(2):
        plain(state, springs, membranes)
    assert plain.marks is None and _FakeEvent.made == 0
    assert _FakeEvent.records == 0
    g = graphed.PeriodGraph(parts, RESORT, marked=True)
    g(state, springs, membranes)
    assert _FakeEvent.made == 4 and _FakeEvent.records == 8
    assert all(e.kwargs == dict(enable_timing=True, external=True)
               for e in g.marks)
    g(state, springs, membranes)
    assert _FakeEvent.records == 8
    with timing.tracing():
        for _ in range(3):
            g(state, springs, membranes)
    assert _FakeEvent.made == 4 and _FakeEvent.records == 8
    names = [s["name"] for s in timing.snapshot()["spans"]]
    assert names.count("graph.replay") == 3 and "graph.capture" not in names
    assert names.count("graph.stage") == names.count("graph.result") == 3
    assert timing.snapshot()["counters"]["graph.replays"] == 3
    with timing.tracing():
        graphed.PeriodGraph(parts, RESORT, marked=True)(state, springs,
                                                        membranes)
    snap = timing.snapshot()
    assert [s["name"] for s in snap["spans"]].count("graph.capture") == 1
    assert snap["counters"]["graph.captures"] == 1


def test_runner_keeps_the_traced_graph_apart(monkeypatch):
    """The period runner, for a state on a card, builds one graph a period
    length for untraced calls (unmarked) and one for traced calls (marked)
    at their first use, and replays the one the tracer's state asks for."""
    made, replayed = [], []

    class Graph:
        def __init__(self, parts, r_steps, marked=False):
            self.key = (r_steps, marked)
            made.append(self.key)

        def __call__(self, state, springs, membranes):
            replayed.append(self.key)
            return state, {}
    monkeypatch.setattr(graphed, "PeriodGraph", Graph)
    state = types.SimpleNamespace(
        pos=types.SimpleNamespace(device=torch.device("cuda", 0)))
    run = graphed.period_runner(None, 2 * RESORT + 1, RESORT)
    run(state, None, None)
    assert made == [(RESORT, False), (1, False)]
    with timing.tracing():
        run(state, None, None)
        run(state, None, None)
    run(state, None, None)
    assert made == [(RESORT, False), (1, False), (RESORT, True), (1, True)]
    off = [(RESORT, False)] * 2 + [(1, False)]
    on = [(RESORT, True)] * 2 + [(1, True)]
    assert replayed == off + on + on + off


class _Device:
    """A card's clock for :class:`_Event`: ``now`` is the device time (ms)
    an event recorded now gets, ``done`` how far the device has run."""
    now = done = 0.0


class _Event:
    """Stands in for a CUDA timing event on :class:`_Device`'s clock."""

    def __init__(self, **kwargs):
        self.t = None

    def record(self, stream=None):
        self.t = _Device.now

    def query(self):
        return self.t is not None and self.t <= _Device.done

    def synchronize(self):
        _Device.done = max(_Device.done, self.t)

    def elapsed_time(self, other):
        return other.t - self.t


def test_marks_on_the_host_clock(monkeypatch):
    """Device marks on a faked card: a mark's events and a period graph's
    four go onto the host clock through the anchor taken at ``enable``
    (host time = anchor's + elapsed ms); a replay first reads the marks the
    device has reached, its next replay waits for its own (one
    ``trace.waits``), and a mark's events are used again once read."""
    for name, value in (("Event", _Event), ("is_available", lambda: True),
                        ("is_initialized", lambda: True),
                        ("synchronize", lambda *a: None),
                        ("current_device", lambda: 0),
                        ("current_stream", lambda *a: None)):
        monkeypatch.setattr(torch.cuda, name, value)
    monkeypatch.setattr(_Device, "now", 0.0)
    monkeypatch.setattr(_Device, "done", 0.0)
    graph = [_Event() for _ in range(4)]
    with timing.tracing():
        h0 = trace._TRACER.anchors[0][1]          # the anchor at 0 ms
        with timing.span("sim.step"):
            _Device.now = 1.0
            with trace.mark("facade.eager", "cuda"):
                _Device.now = 3.0
            for ev, t in zip(graph, (4.0, 5.0, 9.0, 10.0)):
                _Device.now = t
                ev.record()
            _Device.done = 3.0
            trace.replayed(graph, "cuda")
            assert [p[0] for p in trace._TRACER.pending] == [
                "period.sort", "period.steps", "period.unsort"]
            assert len(trace._TRACER.pool[0]) == 2
            trace.before_replay(graph)
            assert trace._TRACER.pending == [] and _Device.done == 10.0
        snap = timing.snapshot()
    assert _Device.done == 10.0
    assert snap["counters"] == {"trace.waits": 1}
    step = snap["spans"][0]
    got = {m["name"]: (m["t0"] - h0, m["t1"] - h0, m["parent"], m["call"])
           for m in snap["marks"]}
    assert got == {n: (int(a * 1e6), int(b * 1e6), step["id"], 1)
                   for n, a, b in (("facade.eager", 1, 3),
                                   ("period.sort", 4, 5),
                                   ("period.steps", 5, 9),
                                   ("period.unsort", 9, 10))}


def test_summary_charges_idle_to_the_innermost_span():
    """``summary`` on a made-up record (ns): host ms by span, device ms by
    mark, the marks' union as busy, and each idle gap charged to the
    innermost span open during it, or to ``outside the program``."""
    spans = [dict(id=1, name="sim.step", t0=100, t1=700, parent=-1, call=1),
             dict(id=2, name="graph.replay", t0=150, t1=250, parent=1,
                  call=1),
             dict(id=3, name="sim.sync", t0=500, t1=700, parent=1, call=1),
             dict(id=4, name="sim.read", t0=800, t1=950, parent=-1, call=2)]
    marks = [dict(name="period.sort", t0=200, t1=300, parent=2, call=1),
             dict(name="period.steps", t0=300, t1=600, parent=2, call=1),
             dict(name="read.copy", t0=850, t1=900, parent=4, call=2),
             dict(name="facade.eager", t0=860, t1=880, parent=4, call=2)]
    snap = dict(spans=spans, marks=marks, counters={"sim.read_bytes": 12},
                t0=0, t1=1000)
    s = timing.summary(snap)
    assert s["host_ms"] == {"sim.step": 6e-4, "graph.replay": 1e-4,
                            "sim.sync": 2e-4, "sim.read": 1.5e-4}
    assert s["device_ms"] == pytest.approx(
        {"period.sort": 1e-4, "period.steps": 3e-4, "read.copy": 5e-5,
         "facade.eager": 2e-5})
    assert s["busy_s"] == pytest.approx(450e-9)
    assert s["window_s"] == pytest.approx(1e-6)
    assert s["idle_share"] == pytest.approx(0.55)
    # idle: 0-100 outside, 100-150 sim.step, 150-200 graph.replay,
    # 600-700 sim.sync, 700-800 outside, 800-850 and 900-950 sim.read,
    # 950-1000 outside
    assert dict(s["idle_gaps"]) == pytest.approx(
        {trace.OUTSIDE: 250e-9, "sim.step": 50e-9, "graph.replay": 50e-9,
         "sim.sync": 100e-9, "sim.read": 100e-9})
    lines = timing.report(snap)
    assert "sim.step" in lines[0] and "period.steps" in lines[1]
    assert lines[-1] == "  counters: sim.read_bytes 12"


def test_profile_trace_holds_the_program_spans(tmp_path):
    """``profile_trace`` turns the tracer on within its block (and off
    after it): its Chrome trace holds the facade's and engine's spans."""
    sim, _ = small_sim()
    with timing.profile_trace(str(tmp_path), device="cpu"):
        sim.step(1)
        sim.get_position()
    assert trace.span("x") is trace.NULL
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())[
        "traceEvents"]}
    assert {"sim.step", "engine.period", "sim.sync", "sim.diag", "sim.read",
            "sim.read.copy"} <= names


def test_cli_verbose_prints_the_tracer_view(capsys):
    """``run -v``: each report line is followed by the chunk's host ms by
    span and its counters (the chunk's own: the record is reset after
    each)."""
    assert cli_main(["run", "--scene", "box", "--box", "8,8,8", "--fill",
                     "0.5", "--steps", "4", "--report-every", "2",
                     "--resort-every", "2", "--device", "cpu", "-v"]) == 0
    out = capsys.readouterr().out.splitlines()
    at = [i for i, ln in enumerate(out) if ln.startswith("[[ step")]
    assert len(at) == 2
    for i in at:
        assert out[i + 1].startswith("  host ms: sim.step")
        assert out[i + 2] == ("  counters: engine.periods 1, engine.steps "
                              "2, sim.host_syncs 1")
    assert trace.span("x") is trace.NULL


@pytest.mark.cuda
def test_period_marks_on_the_card():
    """On a CUDA card: the in-graph marks of every replay give positive
    ``period.sort``, ``period.steps`` and ``period.unsort`` times in
    order, within the replay's call, beside the read's copy and the
    facade's eager groups; a graph captured with the tracer off replays
    bitwise as one captured with it on."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    off, _ = small_sim(device="cuda")
    on, scene = small_sim(device="cuda")
    off.step(RESORT)                         # captured with the tracer off
    with timing.tracing():
        on.step(RESORT)                      # captured with it on
        for _ in range(3):
            on.step(RESORT)
            pos = on.get_position()
    snap = timing.snapshot()
    for _ in range(3):
        off.step(RESORT)
    assert np.array_equal(off.get_position(), pos)
    marks = snap["marks"]
    names = [m["name"] for m in marks]
    for name in ("period.sort", "period.steps", "period.unsort"):
        assert names.count(name) == 4
    assert names.count("read.copy") == 3 and "facade.eager" in names
    periods = [m for m in marks if m["name"].startswith("period.")]
    for a, b, c in zip(periods[0::3], periods[1::3], periods[2::3]):
        assert [a["name"], b["name"], c["name"]] == [
            "period.sort", "period.steps", "period.unsort"]
        assert a["t0"] < a["t1"] <= b["t0"] < b["t1"] <= c["t0"] < c["t1"]
        assert a["call"] == b["call"] == c["call"]
    calls = {s["call"]: s for s in snap["spans"] if s["parent"] == -1}
    for m in marks:
        # on the host's clock: inside its call, give or take the anchor's
        # error (well under 0.1 ms)
        call = calls[m["call"]]
        assert call["t0"] - 1e5 <= m["t0"] <= m["t1"] <= call["t1"] + 1e5
    s = timing.summary(snap)
    assert 0.0 < s["idle_share"] < 1.0
    assert snap["counters"]["sim.read_bytes"] == 3 * scene.n_particles * 12


@pytest.mark.cuda
def test_capture_inside_profile_trace(tmp_path):
    """On a CUDA card: a sim's first traced call inside ``profile_trace``
    captures its marked graph there; the graph gives its marks, replays
    bitwise as the unmarked one, and the Chrome trace holds the capture's
    and the replays' spans."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    off, _ = small_sim(device="cuda")
    on, _ = small_sim(device="cuda")
    off.step(RESORT)
    on.step(RESORT)                          # the unmarked graphs
    with timing.profile_trace(str(tmp_path)):
        on.step(RESORT)                      # the marked graph's capture
        on.step(RESORT)
    snap = timing.snapshot()
    for _ in range(2):
        off.step(RESORT)
    assert np.array_equal(off.get_position(), on.get_position())
    names = [m["name"] for m in snap["marks"]]
    for name in trace.PERIOD_MARKS:
        assert names.count(name) == 2
    assert snap["counters"]["graph.captures"] == 1
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = {e.get("name") for e in json.loads(files[0].read_text())[
        "traceEvents"]}
    assert {"sim.step", "graph.capture", "graph.replay"} <= events
