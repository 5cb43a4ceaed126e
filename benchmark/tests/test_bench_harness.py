"""The harness on the CPU: a cell found from files alone, the failure rule,
the check's verdict on a sound run and on broken ones, and no JAX."""
import dataclasses
import json
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from harness import cell as hc, inputs, spec
from harness.cell import run_cell
from reference import physics
from sph_tpu_torch.runtime.simulator import Simulator
from test_bench_reference import elastic_scene, params_dict

SEED = 3_000_000_017     # more than 32 signed bits hold


def run(root, traced=False, seconds=0.5):
    code, res = run_cell(root, "tiny.step2", SEED, seconds, traced,
                         time.perf_counter(), device_name="cpu",
                         log=lambda msg: None)
    assert code == 0
    return res


def test_sound_run_is_correct(bench_root):
    res = run(bench_root[0])
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"particle_steps_per_s", "setup_s"}
    for c in res["checks"].values():
        # null: the box's liquid starts farther than h from its walls
        assert c["value"] is None or c["value"] <= c["limit"]


def test_a_new_cell_and_metric_run_from_files_alone(bench_root):
    root, b = bench_root
    (root / "benchmark" / "metrics" / "frames_traced.py").write_text(
        "def read(rec):\n    return float(rec['frames'])\n")
    b["per_layer"].append({
        "name": "frames_traced", "unit": "frames", "better": "higher",
        "source": "host_clock", "layer": "test", "moves": "setup_s",
        "workloads": ["tiny.step2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    res = run(root, traced=True)
    assert res["metrics"]["frames_traced"]["value"] == 2.0
    # the profiled frames, then as many with the read timed
    assert res["attempted"] == 4
    assert "read_ms" in res["metrics"]
    assert res["device"]["window_s"] > 0
    assert res["breakdown"]["idle_gaps"]


def _broken(monkeypatch, fault):
    """Simulator.step / get_position broken underneath the harness."""
    step, get_position = Simulator.step, Simulator.get_position

    def bad_step(self, n=1):
        before = self.state
        step(self, n)
        if fault == "unchanged":
            self.state = before
        elif fault == "half":
            keep = torch.arange(before.pos.shape[0]) % 2 == 0
            self.state = dataclasses.replace(
                self.state,
                pos=torch.where(keep[:, None], before.pos, self.state.pos),
                vel=torch.where(keep[:, None], before.vel, self.state.vel))

    def bad_read(self):
        pos = get_position(self).copy()
        if fault == "altered":
            pos = pos + np.float32(0.05 * self.params.h)
        if fault == "nan":
            pos[0, 0] = np.nan
        return pos

    monkeypatch.setattr(Simulator, "step", bad_step)
    monkeypatch.setattr(Simulator, "get_position", bad_read)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_broken_timed_path_is_not_correct(bench_root, monkeypatch, fault):
    _broken(monkeypatch, fault)
    assert not run(bench_root[0])["correct"]


@pytest.fixture
def elastic_cell(bench_root, monkeypatch):
    """The tiny cell on the reference tests' elastic sheet (springs of two
    muscles, membranes, liquid, walls: every term of the step) under the
    limits of ``worm.frame1``."""
    root = bench_root[0]
    shutil.copy(spec.BENCH_DIR / "checks" / "worm.frame1.json",
                root / "benchmark" / "checks" / "tiny.step2.json")
    scene = elastic_scene()
    monkeypatch.setattr(inputs, "make_scene", lambda cfg, seed, dev: scene)
    return root


def test_a_sound_run_of_every_term_is_correct(elastic_cell):
    res = run(elastic_cell)
    assert res["correct"], res["checks"]
    for name in ("vel_gap.elastic", "pos_gap.wall", "pos_gap.membrane"):
        assert res["checks"][name]["value"] is not None


@pytest.mark.parametrize("term", physics.TERMS)
def test_a_term_left_out_is_not_correct(elastic_cell, monkeypatch, term):
    """The timed path without one term of the step: the reference put in
    the program's place, that term left out."""
    step = Simulator.step
    c = physics.derived(params_dict())

    def bad_step(self, n=1):
        start = self.state
        step(self, n)
        topo = physics.Topology.of(inputs.topology_arrays(self.scene), "cpu")
        x, v = physics.run(start.pos, start.vel, int(start.step), n, topo, c,
                           off=(term,))
        self.state = dataclasses.replace(self.state, pos=x, vel=v)

    monkeypatch.setattr(Simulator, "step", bad_step)
    assert not run(elastic_cell)["correct"]


def test_a_non_finite_frame_fails(bench_root, monkeypatch):
    _broken(monkeypatch, "nan")
    res = run(bench_root[0])
    assert res["failed"] >= 1 and not res["correct"]


def test_no_card_no_result(bench_root):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    code, res = run_cell(bench_root[0], "tiny.step2", 1, 1.0, False,
                         time.perf_counter(), log=lambda msg: None)
    assert code == 2 and res is None


def test_no_jax_after_a_run(bench_root):
    """A whole run in a fresh interpreter loads no module named jax, jaxlib,
    flax or sph_tpu (compared by the whole top-level name), and the
    reference loads nothing of sph_tpu_torch."""
    root = bench_root[0]
    code = f"""
import sys, time
sys.path[:0] = [{str(hc.spec.BENCH_DIR)!r}, {str(hc.spec.BENCH_DIR.parent)!r}]
import reference.physics, harness.check
assert not [m for m in sys.modules if m.split('.')[0] == 'sph_tpu_torch']
from harness.cell import run_cell, forbidden_modules
from pathlib import Path
code, res = run_cell(Path({str(root)!r}), 'tiny.step2', 5, 0.2, False,
                     time.perf_counter(), device_name='cpu',
                     log=lambda m: None)
assert code == 0 and res['correct']
assert 'sph_tpu_torch' in sys.modules
print(forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
    assert hc.FORBIDDEN == ("jax", "jaxlib", "flax", "sph_tpu")
    assert "sph_tpu_torch".split(".")[0] not in hc.FORBIDDEN
