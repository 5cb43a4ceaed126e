"""The port's wall-compact (fastw) engine on CPU (plain pair passes) against
sph_tpu: its fastw engine with stale windows (Pallas in interpret mode),
from a kicked box whose liquid hits the floor walls, and its exact
neighbor-list engine, plus the port's Simulator, stepper and CLI.

Tolerances are those of ``tests/test_fastw_engine.py``: positions within
5e-5, velocities within 10x that."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sph_tpu.config import SimParams as JParams
from sph_tpu.core import fastw as JW
from sph_tpu.core.step import SceneLayout as JLayout
from sph_tpu.core.step import multi_step
from sph_tpu.runtime.simulator import resolve_auto_engine as j_resolve
from sph_tpu.scene import generate_liquid_box_scene as j_box

from sph_tpu_torch.constants import MAX_NEIGHBORS
from sph_tpu_torch.convert import params_from
from sph_tpu_torch.core import fastw as W
from sph_tpu_torch.core.step import SceneLayout
from sph_tpu_torch.runtime import Simulator
from sph_tpu_torch.runtime.simulator import resolve_auto_engine
from sph_tpu_torch.scene import Scene, generate_liquid_box_scene

from test_fast_engine import sparse_blob_scene
from test_torch_pair_kernels import kick_box_scene

H = 3.34
ATOL = 5e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOX = dict(x_max=8 * H, y_max=8 * H, z_max=8 * H)
# the pool lowered to within r0 of the floor walls, jittered and pushed
# down gently: the boundary sums are nonzero from the first step and the
# pressure sums from the second, without the kernel tests' close-pair
# violence (their state moves the pool more than h a step)
KICK = dict(jitter=0.2, drop=2.6, speed=0.1, noise=0.05)


def port_scene(js):
    return Scene(pos=js.pos.copy(), vel=js.vel.copy(),
                 color=js.color.copy(), normal=js.normal.copy())


def port_run(scene, params, steps, **cfg_kw):
    layout = scene.layout()
    cfg = W.compute_fastw_config(scene.pos, params, layout,
                                 ptype=scene.ptype, **cfg_kw)
    ws = W.precompute_wall_static(scene.pos, scene.normal, params, layout,
                                  cfg)
    return W.make_fastw_multi_step(params, layout, cfg, steps,
                                   return_diag=True, wall_static=ws)(
        *scene.device_state("cpu"))


@pytest.fixture(scope="module")
def box_runs():
    """The kicked 8h box (fill 0.5), 4 steps at resort_every=2 (stale
    windows), through sph_tpu's fastw engine (one interpret-mode call) and
    the port's (CPU)."""
    jp = JParams(**BOX)
    js = kick_box_scene(j_box(jp, fill_fraction=0.5), jp, **KICK)
    jl = js.layout()
    jcfg = JW.compute_fastw_config(js.pos, jp, jl, ptype=js.ptype,
                                   resort_every=2)
    assert jcfg.interpret
    jws = JW.precompute_wall_static(js.pos, js.normal, jp, jl, jcfg)
    jout, jdiag = JW.make_fastw_multi_step(jp, jl, jcfg, 4,
                                           return_diag=True,
                                           wall_static=jws)(
        *js.device_state())
    params = params_from(jp)
    scene = kick_box_scene(generate_liquid_box_scene(params,
                                                     fill_fraction=0.5),
                           params, **KICK)
    np.testing.assert_array_equal(scene.pos, js.pos)
    np.testing.assert_array_equal(scene.vel, js.vel)
    out, diag = port_run(scene, params, 4, resort_every=2)
    return dict(params=params, scene=scene, out=out, diag=diag,
                jout=jout, jdiag=jdiag)


def test_port_matches_jax_fastw_stale_windows(box_runs):
    out, jout = box_runs["out"], box_runs["jout"]
    np.testing.assert_allclose(out.pos.numpy(), np.asarray(jout.pos),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(out.vel.numpy(), np.asarray(jout.vel),
                               rtol=0, atol=ATOL * 10)
    assert int(out.step) == int(jout.step) == 4
    np.testing.assert_array_equal(out.muscle_activation.numpy(),
                                  np.asarray(jout.muscle_activation))
    diag, jdiag = box_runs["diag"], box_runs["jdiag"]
    for k in ("shell_overflow", "tile_overflow"):
        assert int(diag[k]) == int(jdiag[k]) == 0
    np.testing.assert_allclose(float(diag["window_drift"]),
                               float(jdiag["window_drift"]), rtol=1e-3)
    # the liquid moved, and the second step's pressure and boundary passes
    # sum nonzero terms: the comparison is not of two unchanged states
    scene, params = box_runs["scene"], box_runs["params"]
    assert np.abs(out.pos.numpy() - scene.pos).max() > 1e-4
    layout = scene.layout()
    cfg = W.compute_fastw_config(scene.pos, params, layout,
                                 ptype=scene.ptype)
    ws = W.precompute_wall_static(scene.pos, scene.normal, params, layout,
                                  cfg)
    state, springs, membranes = scene.device_state("cpu")
    state = W.make_fastw_multi_step(params, layout, cfg, 1, wall_static=ws)(
        state, springs, membranes)
    calls = W.record_step_inputs(
        W._make_step_parts_w(params, layout, cfg, wall_static=ws),
        state, springs, membranes)
    for name in ("pacc_mm", "pacc_ms", "bnd_ms"):
        p, tables, own, slab = calls[name]
        assert any(bool(o.abs().max() > 0) for o in p(tables, own, slab))


def test_walls_bitwise_still(box_runs):
    scene, out = box_runs["scene"], box_runs["out"]
    b0, b1 = scene.layout().boundary_range
    assert b1 - b0 > 0
    np.testing.assert_array_equal(out.pos.numpy()[b0:b1], scene.pos[b0:b1])
    np.testing.assert_array_equal(out.vel.numpy()[b0:b1], scene.vel[b0:b1])
    np.testing.assert_array_equal(out.normal.numpy(), scene.normal)


@pytest.mark.parametrize("name", ["sparse_blob", "box", "box_min_offset"])
def test_port_matches_jax_exact(name):
    """No walls (the shell machinery is skipped), walls, and a world whose
    box_min is offset, 3 steps against sph_tpu's exact engine."""
    if name == "box":
        jp = JParams(**BOX)
        js = j_box(jp, fill_fraction=0.5)
    else:
        off = np.zeros(3, np.float32)
        if name == "box_min_offset":
            off = np.array([-2 * H, 1.5 * H, -3 * H], np.float32)
        jp = JParams(x_min=float(off[0]), x_max=float(off[0]) + 8 * H,
                     y_min=float(off[1]), y_max=float(off[1]) + 8 * H,
                     z_min=float(off[2]), z_max=float(off[2]) + 8 * H)
        js = sparse_blob_scene(jp)
        js.pos = js.pos + off
    ref = multi_step(*js.device_state(), jp, js.layout(), 3)
    out, diag = port_run(port_scene(js), params_from(jp), 3)
    assert int(diag["shell_overflow"]) == 0
    assert int(diag["tile_overflow"]) == 0
    np.testing.assert_allclose(out.pos.numpy(), np.asarray(ref.pos),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(out.vel.numpy(), np.asarray(ref.vel),
                               rtol=0, atol=ATOL * 10)


def test_simulator_and_stepper_match_engine(box_runs):
    """Simulator chunks at the resort period, so 4 steps at resort_every=2
    are the engine's two periods bitwise; the stateful stepper too. (A
    remainder runs as single steps, each with its own resort, so step(3)
    + step(1) would re-sort at step 3 and differ in summation order.)"""
    params, scene = box_runs["params"], box_runs["scene"]
    sim = Simulator(scene, params, device="cpu",
                    fast_config=dict(resort_every=2))
    assert sim.engine == "fastw"
    sim.step(4)
    assert sim.step_count == 4
    np.testing.assert_array_equal(sim.get_position(),
                                  box_runs["out"].pos.numpy())
    np.testing.assert_array_equal(sim.get_velocity(),
                                  box_runs["out"].vel.numpy())
    ovf = sim.check_overflow()
    assert ovf["shell_overflow"] == 0 and ovf["tile_overflow"] == 0
    assert ovf["window_drift_h"] > 0.0
    assert sim.check_overflow()["window_drift_h"] == 0.0  # read-and-reset
    assert sim.step_blocking(1) > 0.0 and sim.step_count == 5

    layout = scene.layout()
    cfg = W.compute_fastw_config(scene.pos, params, layout,
                                 ptype=scene.ptype, resort_every=2)
    ws = W.precompute_wall_static(scene.pos, scene.normal, params, layout,
                                  cfg)
    sort, inner, unsort = W.make_fastw_stepper(params, layout, cfg,
                                               inner_steps=2, wall_static=ws)
    state, springs, membranes = scene.device_state("cpu")
    for _ in range(2):
        ctx, carry, diag = sort(state, springs, membranes)
        state = unsort(ctx, inner(ctx, carry), state)
    assert torch.equal(state.pos, box_runs["out"].pos)
    assert int(diag["shell_overflow"]) == 0


def test_cli_run_box_cpu():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-m", "sph_tpu_torch", "run", "--scene", "box",
         "--box", "8,8,8", "--fill", "0.5", "--steps", "3", "--device",
         "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "scene: {'liquid': 605" in res.stdout
    assert "[[ step 3 ]]" in res.stdout and "ms/step" in res.stdout


def test_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = params_from(JParams(**BOX))
    scene = generate_liquid_box_scene(params, fill_fraction=0.5)
    with pytest.raises(RuntimeError, match="CUDA"):
        Simulator(scene, params, device="cuda")


def _elastic_scene(params, muscle_model):
    js = sparse_blob_scene(JParams(**BOX), n_side=6)
    scene = port_scene(js)
    scene.color[:8] = 2.2
    idx = np.full((8, MAX_NEIGHBORS), -1, np.int32)
    idx[:7, 0] = np.arange(1, 8)
    idx[1:, 1] = np.arange(0, 7)
    scene.spring_rows = np.arange(8, dtype=np.int32)
    scene.spring_idx = idx
    scene.spring_rest = np.where(idx >= 0, 1e-6, 0.0).astype(np.float32)
    scene.spring_type = np.zeros((8, MAX_NEIGHBORS), np.float32)
    scene.muscle_model = muscle_model
    return scene


def test_unported_paths_raise():
    params = params_from(JParams(**BOX))
    # springs (no walls: auto picks "fast", so ask for fastw)
    sim = Simulator(_elastic_scene(params, False), params, engine="fastw",
                    device="cpu")
    with pytest.raises(NotImplementedError, match="worm slice"):
        sim.step(1)
    with pytest.raises(NotImplementedError, match="worm slice"):
        Simulator(_elastic_scene(params, True), params, engine="fastw",
                  device="cpu")
    box = generate_liquid_box_scene(params, fill_fraction=0.5)
    blob = port_scene(sparse_blob_scene(JParams(**BOX)))
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        Simulator(blob, params, device="cpu")        # auto -> fast
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        Simulator(box, params, engine="exact", device="cpu")
    for kw in (dict(dump_dir="frames"), dict(adaptive_resort=True)):
        with pytest.raises(NotImplementedError):
            Simulator(box, params, device="cpu", **kw)
    sim = Simulator(box, params, device="cpu")
    with pytest.raises(NotImplementedError):
        sim.save("ckpt.npz")


@pytest.mark.parametrize("walls,n,elastic_only", [
    ((56, 100), 100, True), ((89, 100), 100, True), ((0, 0), 100, True),
    ((56, 100), 100, False)])
def test_auto_engine_resolution_matches_jax(walls, n, elastic_only):
    kw = dict(n_particles=n, boundary_range=walls,
              springs_elastic_only=elastic_only)
    assert resolve_auto_engine(SceneLayout(**kw)) == j_resolve(
        True, JLayout(**kw))
