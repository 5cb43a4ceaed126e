"""The metric arithmetic on recorded records: the rate, the percentile over
every frame, the profiler's busy and idle time, the kernel split, the
roofline share."""
import math

import pytest

from harness import spec, trace
from harness.work import bound_s

BENCH = spec.BENCH_DIR


def reader(name):
    cell = spec.Cell(name="x", chips=1, config={}, traffic={}, limits={},
                     end_to_end=[], per_layer=[], bench_dir=BENCH)
    return cell.reader(name)


def test_rate_and_tail_over_every_frame():
    # 400 frames 10 ms apart, and 20 of them 50 ms late: the 95th
    # percentile by nearest rank is the 380th of the sorted gaps
    gaps = [0.010] * 380 + [0.060] * 20
    t, arrivals = 0.0, []
    for g in gaps:
        t += g
        arrivals.append(t)
    rec = dict(arrivals=arrivals, frames=400, steps=400 * 30,
               window_wall_s=arrivals[-1], n_particles=1000, setup_s=7.5)
    assert reader("particle_steps_per_s")(rec) == pytest.approx(
        1000 * 12000 / 5.0)
    assert reader("frame_ms_p95")(rec) == pytest.approx(10.0)
    rec["arrivals"] = arrivals[:-20] + [a + 1.0 for a in arrivals[-20:]]
    # the gaps of the last 20: one of 1.06 s, 19 of 60 ms; the 380th of 400
    # is still 10 ms, the 381st 60 ms
    assert reader("frame_ms_p95")(rec) == pytest.approx(10.0)
    rec["arrivals"] = rec["arrivals"][:199]
    assert reader("frame_ms_p95")(rec) is None   # too few frames beyond
    assert reader("setup_s")(rec) == 7.5


def recorded():
    """A traced window of 2 steps, 1000 us: two pair kernels, a glue
    kernel, a copy; spans for the step and the read."""
    ops = [
        ("void pair_ring<PAccel>(...)", 100.0, 300.0, True),
        ("void spring_list<Spring>(...)", 300.0, 350.0, True),
        ("void at::native::elementwise_kernel<...>", 350.0, 450.0, True),
        ("Memcpy DtoH (Device -> Pageable)", 700.0, 800.0, False),
        ("spin_kernel", 2000.0, 2010.0, True),
    ]
    ops = [o for o in ops if trace.TAIL_NAME not in o[0]]
    spans = [(0.0, 650.0, "frame.step"), (650.0, 850.0, "frame.read"),
             (850.0, 1000.0, "frame.check")]
    return dict(ops=ops, spans=spans, window=(0.0, 1000.0), wall_s=1e-3)


def test_profiler_records_to_busy_idle_and_layers():
    s = trace.summarise(recorded())
    assert s["busy_s"] == pytest.approx(450e-6)
    assert s["window_s"] == pytest.approx(1e-3)
    assert s["kernel_s"] == pytest.approx(350e-6)
    idle = dict(s["idle_gaps"])
    assert idle["frame.step"] == pytest.approx(100e-6 + 200e-6)
    assert idle["frame.read"] == pytest.approx(50e-6 + 50e-6)
    assert idle["frame.check"] == pytest.approx(150e-6)
    rec = dict(s, steps=2, pair_kernels=spec.data("pair_kernels.txt"),
               read_ms=[0.2, 0.4])
    assert reader("pair_ms_per_step")(rec) == pytest.approx(0.125)
    assert reader("glue_ms_per_step")(rec) == pytest.approx(0.05)
    assert reader("idle_share")(rec) == pytest.approx(0.55)
    assert reader("read_ms")(rec) == pytest.approx(0.3)


def test_roofline_share_is_the_bound_over_all_kernels():
    # 100 pairs a row: every fluid pass bound by its operations
    work = dict(fluid=10**7, fluid_rows=10**5, moving_rows=9 * 10**4,
                boundary=10**4, boundary_rows=5000, boundary_cols=3000,
                membrane=0, membrane_rows=0, membrane_cols=0, spring=0,
                spring_rows=0)
    peaks = spec.data("peaks.json")
    b = bound_s(work, peaks)
    fluid_ops = 10**7 * (13 + 3 * 13 + 26 + 3 * 29)
    assert b["density"] + b["rho_star"] + b["viscsurf"] + b["paccel"] \
        == pytest.approx(fluid_ops / 67e12)
    rec = dict(work=work, peaks=peaks, kernel_s=0.01, steps=10)
    total = sum(b.values())
    assert reader("step_roofline")(rec) == pytest.approx(
        100 * total / 1e-3)
    assert not math.isnan(reader("step_roofline")(rec))
    # nothing to read: no share of 0
    assert reader("step_roofline")(dict(rec, kernel_s=0.0)) is None
    assert reader("idle_share")({"busy_s": 0.0}) is None


def test_a_recorded_trace_of_the_card():
    """Three frames of ``worm.frame1`` as ``torch.profiler`` recorded them
    on an H100 (``data/worm_frame1_trace.json``): the readers' arithmetic
    against a count made here, by a 1-us grid."""
    import json

    import numpy as np

    d = json.loads((BENCH / "tests" / "data" /
                    "worm_frame1_trace.json").read_text())
    ops = [(d["names"][i], s, e, k) for i, s, e, k in d["ops"]]
    rec = dict(ops=ops, spans=[tuple(x) for x in d["spans"]],
               window=tuple(d["window"]), wall_s=d["wall_s"])
    s = trace.summarise(rec)
    w0, w1 = d["window"]
    grid = np.zeros(int(w1 - w0) + 1, bool)
    for _, a, b, _ in ops:
        a, b = max(a, w0), min(b, w1)
        if b > a:
            grid[int(round(a - w0)):int(round(b - w0))] = True
    assert s["busy_s"] == pytest.approx(grid.sum() / 1e6, rel=1e-2)
    assert s["window_s"] == pytest.approx((w1 - w0) / 1e6)
    assert s["kernel_s"] == pytest.approx(
        sum(b - a for _, a, b, k in ops if k) / 1e6)
    pair = sum(b - a for n, a, b, k in ops
               if "pair_ring" in n or "spring_list" in n) / 1e6
    rec = dict(s, steps=d["steps"], frames=d["frames"],
               pair_kernels=spec.data("pair_kernels.txt"),
               arrivals=d["arrivals"], window_wall_s=d["arrivals"][-1],
               n_particles=d["n_particles"])
    assert reader("pair_ms_per_step")(rec) == pytest.approx(1e3 * pair / 3)
    assert reader("glue_ms_per_step")(rec) == pytest.approx(
        1e3 * (s["kernel_s"] - pair) / 3)
    assert 0 < reader("idle_share")(rec) < 1
    assert sum(t for _, t in s["idle_gaps"]) == pytest.approx(
        s["window_s"] - s["busy_s"])
    assert reader("particle_steps_per_s")(rec) == pytest.approx(
        d["n_particles"] * 3 / d["arrivals"][-1])
    # a memcpy is busy time but no kernel
    assert s["busy_s"] > s["kernel_s"]
