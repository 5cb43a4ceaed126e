"""The port's bench (``sph_tpu_torch/bench.py``) and its glue path
(``ops/pack.py``, ``scripts/r4_glue_micro.py``) on the CPU: the box gate
passes for fastw and fast against the port's exact engine, the worm gate
fails on a stretched spring and on spread liquid and passes at rest, the
bench refuses to publish a CPU number (one JSON line, value 0.0, a reason),
its watchdog emits the zero line, and the packer's plain version equals
``jnp.stack`` where the TPU kernel ``pallas_pack`` (run in interpret mode)
leaves the last ``n % CH`` columns unwritten."""
import functools
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sph_tpu_torch import SimParams, bench
from sph_tpu_torch.ops import pack as pk
from sph_tpu_torch.scene import generate_liquid_box_scene

import test_torch_pair_kernels  # noqa: F401  (threads, first-op warm-up)

H = 3.34
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a column count with a ragged tail for both packers' blocks
RAGGED_N = 3 * 128 + 40


@pytest.mark.parametrize("engine", ["fastw", "fast"])
def test_gate_box_equivalence_cpu(engine, capsys):
    assert bench.gate_box_equivalence(SimParams(), engine=engine,
                                      device="cpu")
    err = capsys.readouterr().err
    assert err.count("PASS") == 2 and "FAIL" not in err


def integrity_case(kind):
    """(scene, params, state) of the worm gate's check on a small stand-in:
    the 8h box's pool with its first 8 liquid particles (a column along z
    at r0 spacing) made elastic and chained by springs at their rest
    lengths. ``kind``: "rest", "stretched" (one chain end pulled 60 % of
    its spring's length away) or "spread" (the liquid spread 2x about its
    centre: rho/rho0 falls below 0.5)."""
    params = SimParams(x_max=8 * H, y_max=8 * H, z_max=8 * H)
    scene = generate_liquid_box_scene(params, fill_fraction=0.5)
    ne = 8
    scene.color[:ne] = 2.2
    idx = np.full((ne, 32), -1, np.int32)
    rest = np.zeros((ne, 32), np.float32)
    for a in range(ne):
        for s, b in enumerate(x for x in (a - 1, a + 1) if 0 <= x < ne):
            idx[a, s] = b
            rest[a, s] = (np.linalg.norm(scene.pos[a] - scene.pos[b])
                          * params.simulation_scale)
    scene.spring_rows = np.arange(ne, dtype=np.int32)
    scene.spring_idx = idx
    scene.spring_rest = rest
    scene.spring_type = np.zeros((ne, 32), np.float32)
    pos = scene.pos.copy()
    if kind == "stretched":
        d = pos[ne - 1] - pos[ne - 2]
        pos[ne - 1] += 0.6 * d
    elif kind == "spread":
        l0, l1 = scene.layout().liquid_range
        c = pos[l0:l1].mean(axis=0)
        pos[l0:l1] = c + 2.0 * (pos[l0:l1] - c)
    state = scene.device_state("cpu")[0]
    state.pos = torch.as_tensor(pos)
    return scene, params, state


@pytest.mark.parametrize("kind,ok", [("rest", True), ("stretched", False),
                                     ("spread", False)])
def test_gate_worm_integrity(kind, ok, capsys):
    scene, params, state = integrity_case(kind)
    assert bench.gate_worm_integrity(scene, params, state) is ok
    line = capsys.readouterr().err
    strain = float(line.split("max strain=")[1].split()[0])
    ratio = float(line.split("rho/rho0=")[1].split()[0])
    if kind == "stretched":
        assert strain >= 0.5 and 0.5 <= ratio <= 2.0
    elif kind == "spread":
        assert strain < 0.5 and ratio < 0.5
    else:
        assert strain < 1e-5 and 0.5 <= ratio <= 2.0


def test_bench_refuses_cpu_number(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("SPH_BENCH_FORCE", raising=False)
    monkeypatch.setattr(bench, "_emitted", type(bench._emitted)())
    assert bench.main() == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["metric"] == "pcisph_particle_steps_per_sec_worm"
    assert rec["value"] == 0.0 and rec["vs_baseline"] == 0.0
    assert "CPU" in rec["reason"]


def test_bench_watchdog_emits_zero_line():
    env = dict(os.environ, PYTHONPATH=REPO, SPH_BENCH_FORCE="1",
               SPH_BENCH_WATCHDOG_S="0.01", CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-m", "sph_tpu_torch.bench"],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["value"] == 0.0 and rec["reason"].startswith("watchdog")


def _fields(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n).astype(np.float32) for _ in range(8)]


def test_pack_plain_equals_jnp_stack():
    fields = _fields(RAGGED_N)
    got = pk.pack([torch.as_tensor(f) for f in fields])      # CPU: plain
    assert got.dtype == torch.float32 and got.shape == (8, RAGGED_N)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jnp.stack([jnp.asarray(f) for f in fields],
                                          0)))
    assert torch.equal(pk.pack_plain([torch.as_tensor(f) for f in fields]),
                       got)
    assert pk.LAUNCHES == {"pack": 0}


def test_pallas_pack_leaves_tail_unwritten(monkeypatch):
    """``scripts/r4_glue_micro.py:pallas_pack`` runs n // CH grid steps of
    CH columns: the last n % CH columns of its output are never written
    (interpret mode leaves them NaN). The port's packer writes them all."""
    # the script sets JAX_PLATFORMS and extends sys.path at import
    monkeypatch.setenv("JAX_PLATFORMS", os.environ.get("JAX_PLATFORMS", ""))
    monkeypatch.setattr(sys, "path", list(sys.path))
    spec = importlib.util.spec_from_file_location(
        "r4_glue_micro", os.path.join(REPO, "scripts", "r4_glue_micro.py"))
    glue = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(glue)
    monkeypatch.setattr(glue, "CH", 128)
    monkeypatch.setattr(glue.pl, "pallas_call",
                        functools.partial(glue.pl.pallas_call,
                                          interpret=True))
    fields = _fields(RAGGED_N, seed=1)
    ref = np.stack(fields, 0)
    out = np.asarray(glue.pallas_pack([jnp.asarray(f) for f in fields]))
    full = RAGGED_N // 128 * 128
    np.testing.assert_array_equal(out[:, :full], ref[:, :full])
    assert not (out[:, full:] == ref[:, full:]).any()
    port = pk.pack([torch.as_tensor(f) for f in fields])
    np.testing.assert_array_equal(port.numpy(), ref)


@pytest.mark.cuda
def test_pack_kernel_matches_plain_on_cuda():
    """On a CUDA card: the Pack kernel equals torch.stack bit for bit at a
    float4-aligned n and at a ragged one, one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    for n in (232192, 232192 + 13):
        fields = [torch.as_tensor(f, device="cuda") for f in _fields(n)]
        before = pk.LAUNCHES["pack"]
        got = pk.pack(fields)
        torch.cuda.synchronize()
        assert pk.LAUNCHES["pack"] == before + 1
        assert torch.equal(got, torch.stack(fields, 0))
