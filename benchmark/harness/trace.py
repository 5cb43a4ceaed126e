"""The traced run's records, from ``torch.profiler``'s trace of the card.

The window runs inside one profiler session (CPU and CUDA activity) and a
``window`` span; each part of a frame has its own span (``frame.step``,
``frame.read``, ``frame.check``). The session closes with
a CUDA graph of spin kernels: a session can drop its last kernel records
when it stops, and then it drops the spin kernels', which no sum counts.
"""
from __future__ import annotations

import bisect
import time

# the session's closing graph: spin kernels of ~2.5 us each, ~10 ms in all
TAIL_KERNELS, TAIL_CYCLES = 4096, 5000
TAIL_NAME = "spin_kernel"
TOP = 10


def _span(name: str) -> bool:
    return name == "window" or name.startswith("frame.")


def _spin_tail():
    import torch

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(TAIL_KERNELS):
            torch.cuda._sleep(TAIL_CYCLES)
    return graph


def profiled(run_window, device):
    """(what ``run_window(span)`` returns, records): the device's
    operations in the window (name, start and end in microseconds, kernel
    or copy), the spans of the frames' parts, the window's bounds."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    tail = _spin_tail() if cuda else None
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with record_function("window"):
            out = run_window(record_function)
            sync()
        wall_s = time.perf_counter() - t0
        if tail is not None:
            tail.replay()
            sync()
    dev_type = torch.autograd.DeviceType.CUDA
    ops, spans, window = [], [], None
    for e in prof.events():
        tr = e.time_range
        if e.device_type == dev_type:
            # the spans also appear on the device's timeline (annotations
            # of the kernels they launched): no operation of their own
            if TAIL_NAME not in e.name and not _span(e.name):
                ops.append((e.name, tr.start, tr.end,
                            not e.name.startswith(("Memcpy", "Memset"))))
        elif e.name == "window":
            window = (tr.start, tr.end)
        elif e.name.startswith("frame."):
            spans.append((tr.start, tr.end, e.name))
    return out, dict(ops=ops, spans=sorted(spans), window=window,
                     wall_s=wall_s)


def summarise(rec: dict) -> dict:
    """busy_s (the union of the device's operations inside the window),
    window_s, kernel_s (the kernels' summed time), the device operations
    by name, and the idle gaps by the frame part the host was in."""
    w0, w1 = rec["window"] or (0.0, rec["wall_s"] * 1e6)
    ivs = sorted((max(s, w0), min(e, w1)) for _, s, e, _ in rec["ops"]
                 if e > w0 and s < w1)
    busy, gaps, cur = 0.0, [], w0
    for s, e in ivs:
        if s > cur:
            gaps.append((cur, s))
        if e > cur:
            busy += e - max(s, cur)
            cur = e
    if w1 > cur:
        gaps.append((cur, w1))
    by_name, kernel_us = {}, 0.0
    for name, s, e, kernel in rec["ops"]:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
        kernel_us += (e - s) if kernel else 0.0
    spans = rec["spans"]
    starts = [s for s, _, _ in spans]
    idle = {}
    for s, e in gaps:
        # the gap split over the (sequential) spans it overlaps
        i = max(0, bisect.bisect_right(starts, s) - 1)
        covered = 0.0
        while i < len(spans) and spans[i][0] < e:
            a, b = max(s, spans[i][0]), min(e, spans[i][1])
            if b > a:
                idle[spans[i][2]] = idle.get(spans[i][2], 0.0) + (b - a)
                covered += b - a
            i += 1
        if e - s > covered:
            idle["between frames"] = (idle.get("between frames", 0.0)
                                      + (e - s - covered))

    def top(d):
        return [[k, v / 1e6] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return dict(busy_s=busy / 1e6, window_s=(w1 - w0) / 1e6,
                kernel_s=kernel_us / 1e6, kernel_time=by_name,
                device_ops=top(by_name), idle_gaps=top(idle))


def kernel_seconds(kernel_time: dict, names) -> float:
    """The summed seconds of the kernels whose names hold one of
    ``names``."""
    return sum(t for k, t in kernel_time.items()
               if any(n in k for n in names)) / 1e6
