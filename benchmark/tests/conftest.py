"""The benchmark's CPU tests: the harness and the reference import as the
run imports them (``benchmark/`` and the checkout's root on the path).

    python -m pytest benchmark/tests -q

A tiny cell (``data/tiny_box.json``: the pool of
``generate_liquid_box_scene`` in an 8h cube) runs the whole harness on the
CPU, the program's pair passes in their plain versions.
"""
import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

TINY_TRAFFIC = {"steps_per_frame": 2, "check_frames": 1, "trace_frames": 2,
                "why": "two steps a frame: the CPU tests' traffic"}


@pytest.fixture
def bench_root(tmp_path):
    """A checkout's worth of the benchmark under ``tmp_path`` with one more
    cell, ``tiny.step2``, added by files and entries alone; returns
    (root, the BENCHMARK.json dict as written)."""
    shutil.copytree(BENCH, tmp_path / BENCH.name,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = tmp_path / BENCH.name / "configs" / "tiny.json"
    shutil.copy(BENCH / "tests" / "data" / "tiny_box.json", cfg)
    (tmp_path / BENCH.name / "traffic" / "step2.json").write_text(
        json.dumps(TINY_TRAFFIC))
    # a box of liquid and walls: the numbers of the dam-break's cells
    shutil.copy(BENCH / "checks" / "dambreak.frame1.json",
                tmp_path / BENCH.name / "checks" / "tiny.step2.json")
    b["configs"].append({"name": "tiny", "source": "a test scene",
                         "file": f"{BENCH.name}/configs/tiny.json",
                         "reduced": [], "why": "CPU tests"})
    b["workloads"].append({"name": "tiny.step2", "config": "tiny",
                           "traffic": "step2", "chips": 1, "why": "tests"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("tiny.step2")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    return tmp_path, b
