"""The tracer (``sph_tpu_torch.trace``) on the card in the benchmark's
cells. From the root of a checkout, on a CUDA card:

    python -m sph_tpu_torch.scripts.trace_cells [--cells a,b] \
        [--seconds 6] [--seed n] [--out trace_cells.json]

For each cell it sets the program up as the benchmark does
(``benchmark/harness/cell.setup``), captures the traced (marked) period
graphs with one traced frame, then:

* the pass: ``trace_frames`` frames of the user's loop
  (``harness/window.run``) under ``tracing()``, no profiler and no drain,
  and from its snapshot the resort's device ms a period (``period.sort``
  + ``period.unsort``), the median ``graph.replay`` µs, the facade's host
  ms a frame (``sim.step`` less its ``sim.sync`` children), read GB/s
  (``sim.read_bytes`` over the ``read.copy`` device seconds), the idle
  share of the union of the marks over the pass's wall, the idle
  seconds by innermost open span, and each ring kind's share of chunks
  its box cull skipped (``pair.<kind>.culled`` over ``.chunks``);
* the tracer's cost: windows of ``--seconds`` off, on, off, on, the mean
  ms a frame of each;
* the same readings over a pass ten times as long (``long``);
* in worm.frame30, ``step(90)`` five times off and on (the waits a call).

Then the anchor's error (two events a 20 ms host sleep apart: device
minus host elapsed µs), and the host cost of a span and of the event
operations the tracer makes. Prints a line a reading to standard error
and writes every number to ``chiprun_out/<out>``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .. import trace

ROOT = Path(__file__).resolve().parents[2]
CELLS = "worm.frame30,dambreak.frame30,worm.frame1,dambreak.frame1"


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def readings(snap, frames):
    """The inside readings of one snapshot over ``frames`` frames."""
    s = trace.summary(snap, top=10)
    spans, marks, c = snap["spans"], snap["marks"], snap["counters"]

    def ms(name):
        return [(m["t1"] - m["t0"]) / 1e6 for m in marks
                if m["name"] == name]
    resort = [a + b for a, b in zip(ms("period.sort"), ms("period.unsort"))]
    replay = [(x["t1"] - x["t0"]) / 1e3 for x in spans
              if x["name"] == "graph.replay"]
    by_id = {x["id"]: x for x in spans}

    def step_of(x):
        while x["parent"] != -1 and x["parent"] in by_id:
            x = by_id[x["parent"]]
            if x["name"] == "sim.step":
                return x
        return None
    waits = {}
    for x in spans:
        if x["name"] == "sim.sync":
            st = step_of(x)
            if st is not None:
                waits[st["id"]] = waits.get(st["id"], 0) + x["t1"] - x["t0"]
    host = [(x["t1"] - x["t0"] - waits.get(x["id"], 0)) / 1e6
            for x in spans if x["name"] == "sim.step"]
    copy_s = sum(ms("read.copy")) / 1e3
    # the box cull's share of the chunks each ring kind tested
    cull = {k.split(".")[1]: c.get(k[:-len("chunks")] + "culled", 0) / v
            for k, v in c.items()
            if k.startswith("pair.") and k.endswith(".chunks") and v}
    return dict(
        frames=frames,
        resort_ms_per_period=statistics.mean(resort) if resort else None,
        resort_ms_all=resort,
        period_steps_ms=ms("period.steps"),
        read_copy_ms_all=ms("read.copy"),
        graph_launch_us=statistics.median(replay) if replay else None,
        graph_launch_us_all=replay,
        step_host_ms=sum(host) / frames if host else None,
        read_gb_per_s=(c.get("sim.read_bytes", 0) / copy_s / 1e9
                       if copy_s else None),
        idle_share_unprofiled=s["idle_share"],
        program_idle_gaps=s["idle_gaps"],
        culled_share=cull,
        host_ms=s["host_ms"], device_ms=s["device_ms"],
        window_s=s["window_s"], busy_s=s["busy_s"], counters=c,
        n_spans=len(spans), n_marks=len(marks))


def traced_pass(window, sim, k, n, seed):
    with trace.tracing():
        w = window.run(sim, k, frames=n, sampler=window.Sampler(0, seed))
        snap = trace.snapshot()
    return w, snap


def cost(window, sim, k, seed, seconds):
    """Windows of ``seconds`` off, on, off, on: mean ms a frame each."""
    out = []
    for on in (False, True, False, True):
        if on:
            trace.enable()
        w = window.run(sim, k, seconds=seconds,
                       sampler=window.Sampler(0, seed))
        n_spans = len(trace.snapshot()["spans"]) if on else 0
        trace.disable()
        out.append(dict(traced=on, frames=len(w.arrivals),
                        ms_a_frame=1e3 * w.arrivals[-1] / len(w.arrivals),
                        failed=w.failed, spans=n_spans))
    return out


def step90(sim):
    """``step(90)`` and a read five times, off, on, off, on: ms each and
    the waits of the traced ones."""
    out = {}
    for on in (False, True, False, True):
        if on:
            trace.enable()
        ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sim.step(90)
            sim.get_position()
            ms.append(1e3 * (time.perf_counter() - t0))
        waits = (trace.snapshot()["counters"].get("trace.waits", 0)
                 if on else 0)
        trace.disable()
        out.setdefault("on" if on else "off", []).append(
            dict(ms=ms, waits=waits))
    return out


def anchor_error(n=20, sleep_s=0.02):
    """Two events a known host sleep apart: device elapsed minus host
    elapsed, µs."""
    torch.cuda.synchronize()
    errs = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        ta = time.perf_counter_ns()
        time.sleep(sleep_s)
        b.record()
        tb = time.perf_counter_ns()
        b.synchronize()
        errs.append(a.elapsed_time(b) * 1e3 - (tb - ta) / 1e3)
    return errs


def call_cost(n=200000):
    """ns a ``with span(): count()``, off and on (the loop's own apart)."""
    out = {}
    for on in (False, True):
        if on:
            trace.enable()
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with trace.span("x"):
                trace.count("y")
        out["on" if on else "off"] = (time.perf_counter_ns() - t0) / n
        trace.disable()
    t0 = time.perf_counter_ns()
    for _ in range(n):
        pass
    out["loop"] = (time.perf_counter_ns() - t0) / n
    return out


def event_ops(n=2000):
    """µs a call of the CUDA event operations the tracer makes."""
    torch.cuda.synchronize()
    out = {}
    evs = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    st = torch.cuda.current_stream(0)

    def each(name, fn, items):
        t0 = time.perf_counter_ns()
        for x in items:
            fn(x)
        out[name] = (time.perf_counter_ns() - t0) / len(items) / 1e3
    each("current_stream", lambda _: torch.cuda.current_stream(0), evs)
    each("record", lambda e: e.record(st), evs)
    torch.cuda.synchronize()
    each("query", lambda e: e.query(), evs)
    each("elapsed_time", lambda e: evs[0].elapsed_time(e), evs)
    each("new_event", lambda _: torch.cuda.Event(enable_timing=True), evs)
    trace.enable()

    def marked(_):
        with trace.mark("x", "cuda"):
            pass
    each("mark_on", marked, evs)
    each("anchor_on", lambda _: trace.anchor("cuda"), evs)
    trace.disable()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", default=CELLS)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--seed", type=int, default=2**31 + 12345)
    ap.add_argument("--out", default="trace_cells.json")
    args = ap.parse_args(argv)
    for var, sub in {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR":
                     "torch_ext", "CUDA_CACHE_PATH": "cuda"}.items():
        os.environ[var] = str(ROOT / ".bench_cache" / sub)
    sys.path[:0] = [str(ROOT / "benchmark"), str(ROOT)]
    from harness import cell as hcell
    from harness import spec, window

    dev = torch.device("cuda")
    res = dict(card=torch.cuda.get_device_name(0), torch=torch.__version__,
               cuda=torch.version.cuda, cells={})
    seed = args.seed
    for name in args.cells.split(","):
        c = spec.load_cell(ROOT, name)
        k = int(c.traffic["steps_per_frame"])
        n = int(c.traffic["trace_frames"])
        t0 = time.perf_counter()
        scene, sim, first, failed = hcell.setup(c.config, seed, dev, k)
        log(f"{name}: setup {time.perf_counter() - t0:.1f} s, "
            f"{scene.n_particles} particles")
        r = {}
        w, snap = traced_pass(window, sim, k, 1, seed)   # the marked graphs
        r["capture"] = dict(frames=len(w.arrivals), failed=w.failed,
                            counters=snap["counters"])
        w, snap = traced_pass(window, sim, k, n, seed)
        r["pass"] = readings(snap, len(w.arrivals))
        r["pass"]["failed"] = w.failed
        r["pass_ms_a_frame"] = 1e3 * w.arrivals[-1] / len(w.arrivals)
        log(name, "pass", {kk: v for kk, v in r["pass"].items()
                           if not kk.endswith("_all") and kk not in
                           ("host_ms", "device_ms", "counters",
                            "period_steps_ms")})
        r["cost"] = cost(window, sim, k, seed, args.seconds)
        log(name, "cost", r["cost"])
        w, snap = traced_pass(window, sim, k, 10 * n, seed + 1)
        r["long"] = readings(snap, len(w.arrivals))
        log(name, "long", {kk: r["long"][kk] for kk in (
            "resort_ms_per_period", "graph_launch_us", "step_host_ms",
            "read_gb_per_s", "idle_share_unprofiled", "program_idle_gaps",
            "culled_share")})
        if name == "worm.frame30":
            r["step90"] = step90(sim)
            log(name, "step90", r["step90"])
        r["finite"] = bool(np.isfinite(sim.get_position()).all())
        res["cells"][name] = r
        del sim, first, scene
        torch.cuda.empty_cache()
    res["anchor_error_us"] = anchor_error()
    log("anchor error us", res["anchor_error_us"])
    res["call_ns"] = call_cost()
    log("call ns", res["call_ns"])
    res["event_us"] = event_ops()
    log("event us", res["event_us"])
    out = ROOT / "chiprun_out" / args.out
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(res))
    log("wrote", out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
