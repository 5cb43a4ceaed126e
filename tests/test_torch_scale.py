"""The port's at-scale and locomotion scripts on the CPU at small sizes:
``scripts.bench_scale.measure`` on the 8h box (fastw and fast) and on the
wall-anchored tiny worm (14h x 12h x 108h), which fastw refuses and the
fast engine steps under a line that says so; ``scripts.locomotion`` on
``--small`` for 4 steps, its step counts and statistics against a NumPy
copy of ``scripts/locomotion.py``'s; both refuse to run without CUDA on
their default device. (The multi-worm scene and ``make_state`` are tested
in ``tests/test_torch_api.py``.) Under ``--dist loadfile`` files are
queued by their number of tests, most first: this file keeps fewer tests
than ``tests/test_fast_engine.py``, the suite's longest, so that it is
queued behind it."""
import itertools

import numpy as np
import pytest
import torch

from sph_tpu.config import SimParams as JParams

from sph_tpu_torch.convert import params_from
from sph_tpu_torch.scene import generate_liquid_box_scene, generate_worm_scene
from sph_tpu_torch.scripts import bench_scale, locomotion

from test_torch_fastw import BOX

H = 3.34
TINY = dict(x_max=14 * H, y_max=12 * H, z_max=108 * H)


@pytest.fixture
def cpu_tiles(monkeypatch):
    """fastw's tuned tiles (ccol 512) are ~20x slower in the plain CPU
    passes than 128-wide ones; the tiles do not change what is summed."""
    monkeypatch.setattr(bench_scale, "FASTW_TILES",
                        dict(block=128, ccol=128, ccol_c=128))


@pytest.mark.parametrize("engine", ["fastw", "fast"])
def test_measure_small_box(engine, cpu_tiles, capsys):
    params = params_from(JParams(**BOX))
    scene = generate_liquid_box_scene(params, fill_fraction=0.5)
    r = bench_scale.measure("box", scene, params, engine=engine, chunk=2,
                            rounds=1, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"box [{engine}]: {scene.n_particles} particles, ")
    assert "ms/step" in line and "M particle-steps/s" in line
    assert line.endswith("finite=True")
    assert r["engine"] == engine and r["particles"] == scene.n_particles
    assert r["steps"] == 2 and r["ms_step"] > 0 and r["pps"] > 0
    assert r["finite"] and r["walls_still"] and r["in_box"]
    assert r["shell_overflow"] == r["tile_overflow"] == 0
    assert 0 < r["warm_drift_h"] and 0 < r["drift_h"]
    assert (r["shell_bound_h"] == 2.0) == (engine == "fastw")
    # no kernel and no graph on the CPU
    assert r["launches"] == {} and r["captures"] == []


def test_measure_wall_anchored_worm_runs_fast_and_says_so(capsys):
    params = params_from(JParams(**TINY))
    scene = generate_worm_scene(params)
    assert not scene.layout().springs_elastic_only
    r = bench_scale.measure("tiny worm", scene, params, engine="fastw",
                            chunk=2, rounds=1, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("tiny worm [fast (fastw refuses wall-anchored "
                           "springs)]: 48677 particles")
    assert r["engine"] == bench_scale.REFUSED and r["finite"]
    assert r["walls_still"] and r["shell_bound_h"] is None
    with pytest.raises(ValueError, match="unknown engine"):
        bench_scale.measure("tiny worm", scene, params, engine="halo",
                            device="cpu")


@pytest.mark.parametrize("script", ["bench_scale", "locomotion"])
def test_scripts_refuse_to_run_without_cuda(script, monkeypatch, capsys):
    """No CPU fallback: on the card's default device, without CUDA, each
    script exits 1 before building anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = bench_scale if script == "bench_scale" else locomotion
    assert module.main([]) == 1
    assert "CUDA is not available" in capsys.readouterr().err


def reference_steps(steps, chunk, report_every):
    """``scripts/locomotion.py``'s loop, counting only."""
    done, reports = 0, []
    while done < steps:
        for _ in range(max(1, report_every // chunk)):
            done += chunk
        reports.append(done)
    return reports


def test_locomotion_schedule_equals_the_reference_loop():
    for steps, chunk, every in itertools.product(
            (1, 4, 7, 500, 20000, 20160), (1, 2, 3, 30, 31),
            (1, 2, 30, 499, 500)):
        assert locomotion.schedule(steps, chunk, every) == reference_steps(
            steps, chunk, every), (steps, chunk, every)
    assert locomotion.schedule(20000, 30, 500)[-1] == 20160


def reference_strain(pos, rows, sidx, rest, scale):
    """``scripts/locomotion.py:77-84``."""
    valid = sidx >= 0
    d = pos[rows][:, None, :] - pos[np.maximum(sidx, 0)]
    r = np.linalg.norm(d, axis=2) * scale
    s = np.abs(np.where(valid & (rest > 0), r / np.maximum(rest, 1e-30),
                        1.0) - 1.0)
    return float(s.max())


def reference_verdict(dz, zs):
    """``scripts/locomotion.py:126-136``: (noise, verdict)."""
    zs = np.array(zs)
    noise = float(np.abs(np.diff(zs)).mean()) if len(zs) > 1 else 0.0
    verdict = "PROPELS" if abs(dz) > 3 * noise and abs(dz) > 0.05 else \
        "no net propulsion beyond noise"
    return noise, verdict


def test_locomotion_statistics_equal_the_reference():
    rng = np.random.default_rng(3)
    pos = rng.uniform(0, 5, (40, 3)).astype(np.float32)
    rows = np.arange(10, dtype=np.int32)
    sidx = rng.integers(-1, 40, (10, 32)).astype(np.int32)
    rest = rng.uniform(0, 2e-6, (10, 32)).astype(np.float32)
    rest[0, :4] = 0.0
    assert locomotion.strain(pos, rows, sidx, rest, 3.9e-6) == \
        reference_strain(pos, rows, sidx, rest, 3.9e-6)
    for dz, zs in ((1.7496, [0.0, 0.05, 0.02, 0.09]), (-0.4, [0.1, 0.0]),
                   (0.04, [0.0, 0.001]), (0.3, [0.0, 0.2, 0.0]),
                   (0.2, [0.0]), (-0.06, [0.0, 0.0, 0.0])):
        noise, verdict = reference_verdict(dz, zs)
        assert locomotion.noise_of(zs) == noise
        assert locomotion.verdict(dz, noise) == verdict
        for st in (0.215, 0.5):
            assert locomotion.passes(verdict, st) == (
                verdict == "PROPELS" and st < 0.5)


def test_locomotion_small_run(tmp_path, capsys, monkeypatch):
    """--small --steps 4 --chunk 2 --report-every 2 on the CPU: the
    reference loop's steps and reports, its result lines, the record block,
    no frame; the tiny worm does not propel in 4 steps, so the gate of
    --assert-propels fails (exit 1)."""
    monkeypatch.chdir(tmp_path)
    out = {}
    argv = ["--small", "--steps", "4", "--chunk", "2", "--report-every",
            "2", "--device", "cpu", "--frames", "", "--record", "record.md",
            "--assert-propels"]
    assert locomotion.main(argv, out) == 1
    text = capsys.readouterr().out
    assert out["steps"] == reference_steps(4, 2, 2)[-1] == 4
    assert [t[0] for t in out["trace"]] == reference_steps(4, 2, 2)
    assert out["particles"] == 48677 and np.isfinite(out["dz"])
    assert out["verdict"] == reference_verdict(
        out["dz"], [t[1] for t in out["trace"]])[1]
    assert not out["passed"] and out["shell_bound_h"] is None
    assert "RESULT: com_z displacement" in text and "ACCEPTANCE FAIL" in text
    record = (tmp_path / "record.md").read_text()
    assert "### Locomotion run (4 steps, small worm, 48677 particles)" in \
        record
    assert sorted(p.name for p in tmp_path.iterdir()) == ["record.md"]
