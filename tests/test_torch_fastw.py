"""The port's wall-compact (fastw) engine on CPU (plain pair passes) against
sph_tpu: its fastw engine with stale windows (Pallas in interpret mode),
from a kicked box whose liquid hits the floor walls, and its exact
neighbor-list engine, plus the port's Simulator, stepper and CLI; and on
scenes with elastic matter: a spring chain with muscles and a membrane quad
against sph_tpu's fastw, the elastic sort tables of a reduced worm against
sph_tpu's (sort only: stepping the worm in interpret mode is too slow), and
the port alone stepping that worm.

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
from sph_tpu.scene import generate_worm_scene as j_worm
from sph_tpu.scene.scene import Scene as JScene

from sph_tpu_torch.constants import MAX_NEIGHBORS, MUSCLE_COUNT
from sph_tpu_torch.convert import params_from
from sph_tpu_torch.core import fastw as W
from sph_tpu_torch.core.step import SceneLayout
from sph_tpu_torch.runtime import Simulator
from sph_tpu_torch.runtime.simulator import resolve_auto_engine
from sph_tpu_torch.scene import (Scene, generate_liquid_box_scene,
                                 generate_worm_scene)

from test_fast_engine import sparse_blob_scene
from test_torch_pair_kernels import kick_box_scene
from torch_scenes import scene_path

H = 3.34
ATOL = 5e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOX = dict(x_max=8 * H, y_max=8 * H, z_max=8 * H)
# the pool lowered to within r0 of the floor walls, jittered and pushed
# down gently: the boundary sums are nonzero from the first step and the
# pressure sums from the second, without the kernel tests' close-pair
# violence (their state moves the pool more than h a step)
KICK = dict(jitter=0.2, drop=2.6, speed=0.1, noise=0.05)


# the worm at full length in a narrower pool: 10h x 20h x 108h keeps the
# full scene's y geometry (the worm rests on the pool) and every spring
# anchor elastic, which fastw requires in both packages
WORM = dict(x_max=10 * H, y_max=20 * H, z_max=108 * H)


def port_scene(js):
    return Scene(pos=js.pos.copy(), vel=js.vel.copy(),
                 color=js.color.copy(), normal=js.normal.copy(),
                 spring_rows=js.spring_rows.copy(),
                 spring_idx=js.spring_idx.copy(),
                 spring_rest=js.spring_rest.copy(),
                 spring_type=js.spring_type.copy(), tris=js.tris.copy(),
                 muscle_model=js.muscle_model)


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


def spring_chain_scene(jp):
    """The spring chain with muscles of ``tests/test_fastw_engine.py``: 8
    elastic particles of a sparse blob chained by springs of muscle 5."""
    scene = sparse_blob_scene(jp, n_side=6)
    scene.color[:8] = 2.2
    ne = 8
    idx = np.full((ne, MAX_NEIGHBORS), -1, np.int32)
    rest = np.zeros((ne, MAX_NEIGHBORS), np.float32)
    mus = np.zeros((ne, MAX_NEIGHBORS), np.int32)
    for a in range(ne):
        s = 0
        for b in (a - 1, a + 1):
            if 0 <= b < ne:
                idx[a, s] = b
                r = np.linalg.norm(scene.pos[a] - scene.pos[b])
                rest[a, s] = r * jp.simulation_scale * 0.97
                mus[a, s] = 5
                s += 1
    scene.spring_rows = np.arange(ne, dtype=np.int32)
    scene.spring_idx = idx
    scene.spring_rest = rest
    scene.spring_type = mus.astype(np.float32)
    scene.muscle_model = True
    return scene


def membrane_quad_scene(jp):
    """The membrane quad of ``tests/test_fastw_engine.py``: two triangles
    over four elastic particles and one liquid particle 0.4 r0 above."""
    r0 = jp.r0
    quad = np.array([
        [8.0, 8.0, 8.0], [8.0 + r0, 8.0, 8.0],
        [8.0, 8.0, 8.0 + r0], [8.0 + r0, 8.0, 8.0 + r0],
    ], np.float32)
    liq = np.array([[8.0 + 0.5 * r0, 8.0 + 0.4 * r0, 8.0 + 0.5 * r0]],
                   np.float32)
    pos = np.concatenate([quad, liq])
    return JScene(
        pos=pos, vel=np.zeros_like(pos),
        color=np.array([2.1] * 4 + [1.1], np.float32),
        normal=np.zeros_like(pos),
        tris=np.array([[0, 1, 2], [1, 3, 2]], np.int32),
    )


@pytest.mark.parametrize("name,steps", [("spring_chain", 3),
                                        ("membrane_quad", 2)])
def test_port_matches_jax_fastw_elastic(name, steps):
    jp = JParams(**BOX)
    js = (spring_chain_scene if name == "spring_chain"
          else membrane_quad_scene)(jp)
    jl = js.layout()
    jcfg = JW.compute_fastw_config(js.pos, jp, jl, ptype=js.ptype)
    assert jcfg.interpret
    jout = JW.make_fastw_multi_step(jp, jl, jcfg, steps)(*js.device_state())
    scene = port_scene(js)
    out, diag = port_run(scene, params_from(jp), steps)
    assert int(diag["tile_overflow"]) == 0
    np.testing.assert_allclose(out.pos.numpy(), np.asarray(jout.pos),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(out.vel.numpy(), np.asarray(jout.vel),
                               rtol=0, atol=ATOL * 10)
    assert int(out.step) == int(jout.step) == steps
    act = out.muscle_activation.numpy()
    np.testing.assert_allclose(act, np.asarray(jout.muscle_activation),
                               rtol=0, atol=1e-6)
    if name == "spring_chain":
        assert act.max() > 0.5          # the wave model drove the muscles
        # the springs pulled: with them cut the chain ends up elsewhere
        cut = port_scene(js)
        cut.spring_idx[:] = -1
        free, _ = port_run(cut, params_from(jp), steps)
        assert np.abs(free.pos.numpy()[:8] - out.pos.numpy()[:8]).max() \
            > 100 * ATOL
    else:
        assert not act.any()
        # the membrane pushed the liquid particle up
        assert out.pos.numpy()[4, 1] > scene.pos[4, 1] + 0.1


@pytest.fixture(scope="module")
def worm():
    """The reduced worm of both packages (sph_tpu's NumPy generator), the
    port's engine parts and sort context, and sph_tpu's sort context."""
    params = params_from(JParams(**WORM))
    with scene_path(native=False):
        js = j_worm(JParams(**WORM))
        scene = generate_worm_scene(params)
    np.testing.assert_array_equal(scene.pos, js.pos)
    np.testing.assert_array_equal(scene.spring_idx, js.spring_idx)
    layout = scene.layout()
    assert layout.springs_elastic_only and layout.spring_slots == 16
    cfg = W.compute_fastw_config(scene.pos, params, layout,
                                 ptype=scene.ptype)
    ws = W.precompute_wall_static(scene.pos, scene.normal, params, layout,
                                  cfg)
    parts = W._make_step_parts_w(params, layout, cfg, wall_static=ws)
    state = scene.device_state("cpu")
    ctx, _ = parts.sort_ctx(*state)
    # the sorted positions, rows 0-2 of the step's main pack
    own = torch.stack(parts.carry_of(ctx, state[0])[:3])
    jp, jl = JParams(**WORM), js.layout()
    jcfg = JW.compute_fastw_config(js.pos, jp, jl, ptype=js.ptype)
    jws = JW.precompute_wall_static(js.pos, js.normal, jp, jl, jcfg)
    jctx, _ = JW._make_step_parts_w(jp, jl, jcfg, wall_static=jws)[0](
        *js.device_state())
    return dict(params=params, scene=scene, cfg=cfg, ctx=ctx, jctx=jctx,
                own=own, spring=parts.passes["spring_ms"])


def test_worm_elastic_sort_tables_match_jax(worm):
    ctx, jctx, cfg = worm["ctx"], worm["jctx"], worm["cfg"]
    for k in ("els", "mem_vidx"):
        np.testing.assert_array_equal(ctx[k].numpy(), np.asarray(jctx[k]),
                                      err_msg=k)
    # sph_tpu's spr_static (partner ids, rest lengths) is rows 3..3+2*slots
    # of the port's spring pack
    np.testing.assert_array_equal(ctx["spr_pack"][3:3 + 2 * 16].numpy(),
                                  np.asarray(jctx["spr_static"]))
    for k in ("spr_tables", "mem_tables", "tables_m", "tables_ms"):
        assert len(ctx[k]) == len(jctx[k]) == 6
        for i, (a, b) in enumerate(zip(ctx[k], jctx[k])):
            assert a.dtype == torch.int32, (k, i)
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f"{k}[{i}]")
    np.testing.assert_array_equal(
        ctx["mem_pt_ok"].numpy().reshape(-1, 7), np.asarray(jctx["mem_pt_ok"]))
    np.testing.assert_array_equal(
        ctx["mem_pt_safe"].numpy().reshape(-1, 7),
        np.asarray(jctx["mem_pt_safe"]))
    # the gather index of the activation term addresses what sph_tpu's
    # one-hot matrix selects
    onehot = np.asarray(jctx["spr_onehot"])
    mid = ctx["spr_mid"].numpy().T.reshape(-1)
    np.testing.assert_array_equal(
        np.where(onehot.any(1), onehot.argmax(1) + 1, 0), mid)
    assert (mid > 0).sum() > 1000
    # the gates decide which blocks work: blocks without elastic rows run
    # no spring tile, blocks away from the worm no membrane tile
    n_all = int((ctx["tables_m"][4] > 0).sum())
    for k in ("spr_tables", "mem_tables"):
        assert 0 < int((ctx[k][4] > 0).sum()) < n_all <= cfg.n_blocks
    # the packs' pad columns: far positions, -1 ids, no triangles
    n_el, pack = ctx["els"].shape[0], ctx["spr_pack"]
    assert pack.shape == (3 + 3 * 16, -(-n_el // 128) * 128 + 256)
    assert bool((pack[:3, n_el:] > worm["params"].z_max).all())
    assert bool((pack[3:19, n_el:] == -1).all())
    assert not ctx["mem_pack"][:42].any()


def test_worm_spring_list_matches_the_pair_form(worm):
    """The reduced worm's spring list (built by the sort, once a period):
    it extends the spring tables, holds every slot the slab lists (each
    spring's partner lies in its row's coverage at sort time), and with
    the slab's positions and activation terms filled as a step fills them
    (activations from a seed) its sums equal the pair form's within 1e-5
    of the pass's rounding scale, the kernel tolerance."""
    ctx, own, p = worm["ctx"], worm["own"], worm["spring"]
    lst, els = ctx["spr_list"], ctx["els"]
    assert len(lst) == 8
    assert all(a is b for a, b in zip(lst[:6], ctx["spr_tables"]))
    pack = ctx["spr_pack"].clone()
    n, n_el = p.n_slots, els.shape[0]
    assert int(lst[6][-1]) == int((pack[3:3 + n] >= 0).sum()) > 100_000
    pack[:3, :n_el] = own[:, els]
    act = torch.as_tensor(np.random.default_rng(0).uniform(
        0.0, 1.0, MUSCLE_COUNT).astype(np.float32)) * \
        worm["params"].muscle_force
    pack[3 + 2 * n:, :n_el] = torch.cat([act.new_zeros(1), act])[
        ctx["spr_mid"]]
    lf, pf = p(lst, own, pack), p(lst[:6], own, pack)
    top = float(torch.stack(p.rounding_scale(lst[:6], own, pack)).max())
    assert float(torch.stack(pf).abs().max()) > 100 * 1e-5 * top
    for a, b in zip(lf, pf):
        assert float((a - b).abs().max()) <= 1e-5 * top


def test_port_steps_reduced_worm(worm):
    """5 steps of the reduced worm on the CPU (plain passes): finite,
    springs hold (the integrity bound of the worm gate: strain < 0.5), the
    muscles follow the wave, the membrane pass acts on some liquid."""
    params, scene = worm["params"], worm["scene"]
    sim = Simulator(scene, params, engine="auto", device="cpu")
    assert sim.engine == "fastw"
    sim.step(5)
    pos = sim.get_position()
    assert np.isfinite(pos).all() and np.isfinite(sim.get_velocity()).all()
    b0, b1 = sim.layout.boundary_range
    np.testing.assert_array_equal(pos[b0:b1], scene.pos[b0:b1])
    idx = scene.spring_idx
    used = idx >= 0
    a = pos[np.repeat(scene.spring_rows, idx.shape[1])[used.ravel()]]
    r = np.linalg.norm(a - pos[idx[used]], axis=1) * params.simulation_scale
    rest = scene.spring_rest[used]
    strain = float(np.max(np.abs(r - rest) / np.maximum(rest, 1e-9)))
    assert 0.0 < strain < 0.5
    from sph_tpu_torch.models import muscle
    np.testing.assert_allclose(
        sim.get_muscle_activation(),
        muscle.waves_signal(torch.tensor(4.0)).numpy(), rtol=0, atol=1e-6)
    ovf = sim.check_overflow()
    assert ovf["shell_overflow"] == 0 and ovf["tile_overflow"] == 0
    # override: taken as given, zero-padded (the wave model then overwrites
    # it at the next step)
    sim.set_muscle_activation([1.0, 0.5])
    act = sim.get_muscle_activation()
    assert act[0] == 1.0 and act[1] == 0.5 and not act[2:].any()
    # one more recorded step: both elastic passes sum nonzero terms
    calls = W.record_step_inputs(
        W._make_step_parts_w(params, sim.layout, sim._fast_cfg,
                             wall_static=sim._wall_static),
        sim.state, sim.springs, sim.membranes)
    assert sorted(calls) == sorted(
        ["raw_mm", "raw_ms", "raw_sm", "visc_mm", "visc_ms", "pacc_mm",
         "pacc_ms", "bnd_ms", "spring_ms", "mem_ms"])
    for name in ("spring_ms", "mem_ms"):
        p, tables, own, slab = calls[name]
        assert any(bool(o.abs().max() > 0) for o in p(tables, own, slab))


def test_unported_paths_raise(tmp_path):
    """No path raises any more: the halo engine (ported since, a world of
    one here), dumps, the adaptive resort and checkpoints step; a
    wall-free blob, which auto sends to the fast engine, steps."""
    params = params_from(JParams(**BOX))
    box = generate_liquid_box_scene(params, fill_fraction=0.5)
    blob = port_scene(sparse_blob_scene(JParams(**BOX)))
    sim = Simulator(blob, params, device="cpu")      # auto -> fast
    assert sim.engine == "fast"
    sim.step(2)
    assert sim.step_count == 2 and np.isfinite(sim.get_position()).all()
    assert np.abs(sim.get_position() - blob.pos).max() > 1e-3
    halo = Simulator(box, params, engine="halo", device="cpu")
    halo.step(1)
    assert halo.step_count == 1 and np.isfinite(halo.get_position()).all()
    for kw in (dict(dump_dir=str(tmp_path / "frames")),
               dict(adaptive_resort=True)):
        sim = Simulator(box, params, device="cpu", **kw)
        sim.step(1)
        sim.flush()
        assert sim.step_count == 1
    assert (tmp_path / "frames" / "position_buffer.txt").exists()
    sim.save(str(tmp_path / "ckpt.npz"))
    sim.restore(str(tmp_path / "ckpt.npz"))
    assert sim.step_count == 1


@pytest.mark.parametrize("walls,n,elastic_only", [
    ((56, 100), 100, True), ((89, 100), 100, True), ((0, 0), 100, True),
    ((56, 100), 100, False)])
def test_auto_engine_resolution_matches_jax(walls, n, elastic_only):
    kw = dict(n_particles=n, boundary_range=walls,
              springs_elastic_only=elastic_only)
    assert resolve_auto_engine(SceneLayout(**kw)) == j_resolve(
        True, JLayout(**kw))
