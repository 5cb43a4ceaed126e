"""What a run reads from files: the cell's entry in ``BENCHMARK.json``, its
configuration, its traffic mix, its limits and the readers of its metrics.

Everything is found by name, so that a cell, a traffic mix or a metric is
added by adding files and entries:

* ``BENCHMARK.json``'s ``configs`` entry names the configuration's file;
* ``benchmark/traffic/<traffic>.json`` is the traffic mix;
* ``benchmark/checks/<cell>.json`` holds the limits of the cell's check;
* ``benchmark/metrics/<metric>.py`` is the metric's reader: ``read(rec)``
  returns its value from the run's records, or None where it finds
  nothing to read.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list      # the BENCHMARK.json entries this cell reports
    per_layer: list
    bench_dir: Path

    def reader(self, metric: str):
        """The ``read`` function of ``metrics/<metric>.py``."""
        path = self.bench_dir / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            f"bench_metric_{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def _reports(entry: dict, cell: str, e2e_names: set) -> bool:
    """A metric's ``workloads`` list names the cells that report it; an
    end-to-end metric without one is reported everywhere, a per-layer one
    wherever the end-to-end metric it moves is."""
    if "workloads" in entry:
        return cell in entry["workloads"]
    return "moves" not in entry or entry["moves"] in e2e_names


def load_cell(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``, with its files read
    from ``root``'s copy of the benchmark."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench_dir = root / BENCH_DIR.name
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json "
                         f"lists {', '.join(sorted(cells))}")
    w = cells[workload]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / cfg["file"]).read_text())
    traffic = json.loads(
        (bench_dir / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads(
        (bench_dir / "checks" / f"{workload}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, workload, names)]
    return Cell(name=workload, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=limits, end_to_end=e2e,
                per_layer=per_layer, bench_dir=bench_dir)


def data(name: str, bench_dir: Path = BENCH_DIR):
    """A file of ``benchmark/data``: JSON parsed, text as its lines."""
    path = bench_dir / "data" / name
    if path.suffix == ".json":
        return json.loads(path.read_text())
    return [ln.strip() for ln in path.read_text().splitlines()
            if ln.strip() and not ln.startswith("#")]
