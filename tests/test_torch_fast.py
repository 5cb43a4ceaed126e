"""The port's fast engine on CPU (plain pair passes) against sph_tpu's fast
engine (``make_fast_multi_step``, Pallas in interpret mode), one JAX call per
scene: a kicked box (compact tiles of 128, stale windows), a sparse blob with
a muscle spring chain, the membrane quad, a sparse blob in a world whose
box_min is offset, the subgroup-gated passes at sub 8/16/32, and the elastic
chain whose springs take the gather fallback; plus the port's Simulator,
stepper, CLI, ``elastic_accel``, the wall-anchored worm stepped alone, and
the auto rule on the dam-break.

Tolerances are those of ``tests/test_fast_engine.py``: positions within
5e-5, velocities within 5e-4, gated against ungated within 1e-6 (positions)
and 1e-5 (velocities). The gated runs are held against sph_tpu's ungated
run: its own test holds its gated passes to its ungated ones (a gated
sph_tpu call in interpret mode takes four times as long)."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from sph_tpu.config import SimParams as JParams
from sph_tpu.core import elastic as JE
from sph_tpu.core import fast as JF
from sph_tpu.core.state import Springs as JSprings
from sph_tpu.core.state import empty_membranes as j_empty_membranes
from sph_tpu.core.state import make_state
from sph_tpu.core.step import SceneLayout as JLayout
from sph_tpu.ops.vec3 import V3
from sph_tpu.runtime.simulator import resolve_auto_engine as j_resolve
from sph_tpu.scene import generate_liquid_box_scene as j_box

from sph_tpu_torch.config import SimParams
from sph_tpu_torch.constants import ELASTIC_PARTICLE, MUSCLE_COUNT
from sph_tpu_torch.convert import (membranes_from_numpy, params_from,
                                   springs_from_numpy, state_from_numpy)
from sph_tpu_torch.core import fast as F
from sph_tpu_torch.core.elastic import elastic_accel
from sph_tpu_torch.core.step import SceneLayout
from sph_tpu_torch.ops import pair_kernels as pk
from sph_tpu_torch.runtime import Simulator
from sph_tpu_torch.runtime.simulator import resolve_auto_engine
from sph_tpu_torch.scene import generate_liquid_box_scene, generate_worm_scene

from test_fast_engine import sparse_blob_scene
from test_torch_fastw import (BOX, KICK, membrane_quad_scene, port_scene,
                              spring_chain_scene)
from test_torch_pair_kernels import kick_box_scene

H = 3.34
ATOL = 5e-5
VTOL = 5e-4
SUB_ATOL, SUB_VTOL = 1e-6, 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OFF = np.array([-2 * H, 1.5 * H, -3 * H], np.float32)
# the kicked box: compact tiles of 128 and stale windows (two periods)
BOX_CFG = dict(ccol_c=128, resort_every=2)
BOX_STEPS = 4
SUB_CFG = dict(block=128, ccol=128)


def jax_run(js, jp, steps, **cfg_kw):
    cfg = JF.compute_fast_config(js.pos, jp, interpret=True, **cfg_kw)
    assert cfg.interpret
    return JF.make_fast_multi_step(jp, js.layout(), cfg, steps,
                                   return_drift=True)(
        *js.device_state())


def port_run(scene, params, steps, **cfg_kw):
    cfg = F.compute_fast_config(scene.pos, params, **cfg_kw)
    return F.make_fast_multi_step(params, scene.layout(), cfg, steps,
                                  return_drift=True)(
        *scene.device_state("cpu"))


def assert_matches(out, jout, steps, atol=ATOL, vtol=VTOL):
    np.testing.assert_allclose(out.pos.numpy(), np.asarray(jout.pos),
                               rtol=0, atol=atol)
    np.testing.assert_allclose(out.vel.numpy(), np.asarray(jout.vel),
                               rtol=0, atol=vtol)
    assert int(out.step) == int(jout.step) == steps
    np.testing.assert_allclose(out.muscle_activation.numpy(),
                               np.asarray(jout.muscle_activation),
                               rtol=0, atol=1e-6)


def _scene(name):
    """(jax params, jax scene, steps, fast config) of a named case."""
    if name == "kicked_box":
        jp = JParams(**BOX)
        return (jp, kick_box_scene(j_box(jp, fill_fraction=0.5), jp, **KICK),
                BOX_STEPS, BOX_CFG)
    if name == "blob_offset":
        jp = JParams(x_min=float(OFF[0]), x_max=float(OFF[0]) + 8 * H,
                     y_min=float(OFF[1]), y_max=float(OFF[1]) + 8 * H,
                     z_min=float(OFF[2]), z_max=float(OFF[2]) + 8 * H)
        js = sparse_blob_scene(jp)
        js.pos = js.pos + OFF
        return jp, js, 3, {}
    jp = JParams(**BOX)
    if name == "spring_chain":
        return jp, spring_chain_scene(jp), 3, {}
    return jp, membrane_quad_scene(jp), 2, {}


@pytest.fixture(scope="module", params=["kicked_box", "spring_chain",
                                        "membrane_quad", "blob_offset"])
def case(request):
    jp, js, steps, cfg_kw = _scene(request.param)
    jout, jdrift = jax_run(js, jp, steps, **cfg_kw)
    params = params_from(jp)
    scene = port_scene(js)
    out, drift = port_run(scene, params, steps, **cfg_kw)
    return dict(name=request.param, params=params, scene=scene, steps=steps,
                cfg_kw=cfg_kw, out=out, drift=drift, jout=jout,
                jdrift=jdrift)


def test_port_matches_jax_fast(case):
    out, jout = case["out"], case["jout"]
    assert_matches(out, jout, case["steps"])
    np.testing.assert_allclose(float(case["drift"]), float(case["jdrift"]),
                               rtol=1e-3)
    scene = case["scene"]
    b0, b1 = scene.layout().boundary_range
    np.testing.assert_array_equal(out.pos.numpy()[b0:b1], scene.pos[b0:b1])
    pos = out.pos.numpy()
    if case["name"] == "spring_chain":
        act = out.muscle_activation.numpy()
        assert act.max() > 0.5          # the wave model drove the muscles
        # the springs pulled: with them cut the chain ends up elsewhere
        cut = port_scene(spring_chain_scene(JParams(**BOX)))
        cut.spring_idx[:] = -1
        free, _ = port_run(cut, case["params"], case["steps"])
        assert np.abs(free.pos.numpy()[:8] - pos[:8]).max() > 100 * ATOL
    elif case["name"] == "membrane_quad":
        assert pos[4, 1] > scene.pos[4, 1] + 0.1   # the liquid was pushed
    else:
        assert np.abs(pos - scene.pos).max() > 1e-2


@pytest.mark.parametrize("case", ["kicked_box"], indirect=True)
def test_kicked_box_sums_are_not_vacuous(case):
    """From the kicked box's state after one step, the pressure and boundary
    passes sum nonzero terms: the comparison is not of resting states."""
    params, scene = case["params"], case["scene"]
    cfg = F.compute_fast_config(scene.pos, params, **case["cfg_kw"])
    state, springs, membranes = scene.device_state("cpu")
    state = F.make_fast_multi_step(params, scene.layout(), cfg, 1)(
        state, springs, membranes)
    calls = F.record_step_inputs(
        F._make_step_parts(params, scene.layout(), cfg), state, springs,
        membranes)
    assert sorted(calls) == ["boundary", "density", "paccel", "rho_star",
                             "viscsurf"]
    assert calls["boundary"][0].ccol == 128 and calls["density"][0].ccol == 256
    for name in ("paccel", "boundary"):
        p, tables, own, slab = calls[name]
        assert any(bool(o.abs().max() > 0) for o in p(tables, own, slab))


@pytest.mark.parametrize("case", ["kicked_box"], indirect=True)
def test_simulator_and_stepper_match_engine(case):
    """Simulator chunks at the resort period, so 4 steps at resort_every=2
    are the engine's two periods bitwise; the stateful stepper too."""
    params, scene, out = case["params"], case["scene"], case["out"]
    sim = Simulator(scene, params, engine="fast", device="cpu",
                    fast_config=case["cfg_kw"])
    assert sim.engine == "fast"
    sim.step(BOX_STEPS)
    np.testing.assert_array_equal(sim.get_position(), out.pos.numpy())
    np.testing.assert_array_equal(sim.get_velocity(), out.vel.numpy())
    ovf = sim.check_overflow()
    assert ovf["cell_overflow"] == 0 and ovf["tile_overflow"] == 0
    assert "shell_overflow" not in ovf
    np.testing.assert_allclose(ovf["window_drift_h"],
                               2 * float(case["drift"]) / params.h, rtol=1e-6)
    assert sim.check_overflow()["window_drift_h"] == 0.0  # read-and-reset

    cfg = F.compute_fast_config(scene.pos, params, **case["cfg_kw"])
    sort, inner, unsort = F.make_fast_stepper(params, scene.layout(), cfg,
                                              inner_steps=2)
    state, springs, membranes = scene.device_state("cpu")
    for _ in range(2):
        ctx, carry, diag = sort(state, springs, membranes)
        state = unsort(ctx, inner(ctx, carry), state)
    assert torch.equal(state.pos, out.pos) and torch.equal(state.vel,
                                                            out.vel)
    assert int(diag["tile_overflow"]) == 0


@pytest.fixture(scope="module")
def sub_runs():
    """The 8h box at rest (fill 0.5) at block 128, ccol 128, 3 steps in one
    resort period: sph_tpu ungated, the port ungated and at sub 8/16/32."""
    jp = JParams(**BOX)
    js = j_box(jp, fill_fraction=0.5)
    jout, _ = jax_run(js, jp, 3, **SUB_CFG)
    params = params_from(jp)
    scene = generate_liquid_box_scene(params, fill_fraction=0.5)
    outs = {sub: port_run(scene, params, 3, sub=sub, **SUB_CFG)[0]
            for sub in (None, 8, 16, 32)}
    return dict(params=params, scene=scene, jout=jout, outs=outs)


@pytest.mark.parametrize("sub", [None, 8, 16, 32])
def test_gated_engine_matches_jax(sub_runs, sub):
    out = sub_runs["outs"][sub]
    assert_matches(out, sub_runs["jout"], 3)
    if sub is not None:
        ref = sub_runs["outs"][None]
        np.testing.assert_allclose(out.pos.numpy(), ref.pos.numpy(),
                                   rtol=0, atol=SUB_ATOL)
        np.testing.assert_allclose(out.vel.numpy(), ref.vel.numpy(),
                                   rtol=0, atol=SUB_VTOL)
        # the gate skips work: fewer (tile, group) pairs compute than the
        # block tiles times the groups
        params, scene = sub_runs["params"], sub_runs["scene"]
        cfg = F.compute_fast_config(scene.pos, params, sub=sub, **SUB_CFG)
        pencil, cid = F._cells(torch.as_tensor(scene.pos), params, cfg.dims)
        tables, _, _, gt = F._window_tables(
            pencil[torch.argsort(cid, stable=True)], cfg)
        p = pk.make_density_pass(c_rho=1.0, inv_h2=1.0, sub=sub,
                                 block=cfg.block, ccol=cfg.ccol,
                                 n_blocks=cfg.n_blocks)
        blocks = torch.nonzero(tables[4] > 0).reshape(-1)
        cols, valid, off = pk._tile_columns(tables, p.ccol, blocks,
                                            int(tables[4].max()), 1 << 30)
        gate = pk._group_gate(p, tables + gt, blocks, off)
        assert bool((valid[:, None, :] & ~gate).any())


def test_gated_first_step_is_bitwise_ungated():
    """At the first step of a resort period every skipped term is an exact
    zero: gated and ungated steps of the kicked box agree bit for bit."""
    params = params_from(JParams(**BOX))
    scene = kick_box_scene(generate_liquid_box_scene(params,
                                                     fill_fraction=0.5),
                           params, **KICK)
    outs = [port_run(scene, params, 2, resort_every=1, sub=sub, **SUB_CFG)[0]
            for sub in (None, 32, 8)]
    assert np.abs(outs[0].pos.numpy() - scene.pos).max() > 0.1
    for o in outs[1:]:
        assert torch.equal(o.pos, outs[0].pos)
        assert torch.equal(o.vel, outs[0].vel)


def elastic_chain_inputs():
    """The elastic chain of ``test_spring_pass_matches_gather_fallback``
    (24 elastic particles chained by muscle springs, a liquid block, a
    floor of walls) as numpy arrays."""
    params = JParams()
    r0 = params.r0
    pos, typ, nrm = [], [], []
    for k in range(24):
        pos.append([5.0 + 0.8 * r0 * k, 8.0, 5.0])
        typ.append(2)
        nrm.append([0, 0, 0])
    for ix in range(6):
        for iy in range(4):
            for iz in range(6):
                pos.append([2 + ix * r0, 3 + iy * r0, 2 + iz * r0])
                typ.append(1)
                nrm.append([0, 0, 0])
    for ix in range(12):
        for iz in range(12):
            pos.append([ix * r0, 0.2, iz * r0])
            typ.append(3)
            nrm.append([0, 1, 0])
    pos = np.array(pos, np.float32)
    idx = np.full((24, 32), -1, np.int32)
    rest = np.zeros((24, 32), np.float32)
    musc = np.zeros((24, 32), np.int32)
    for k in range(24):
        s = 0
        for j in (k - 1, k + 1):
            if 0 <= j < 24:
                idx[k, s] = j
                rest[k, s] = 0.8 * r0 * params.simulation_scale * 0.95
                musc[k, s] = (min(k, j) % 5) + 1
                s += 1
    act = np.zeros(MUSCLE_COUNT, np.float32)
    act[:5] = 0.7
    return params, dict(pos=pos, ptype=np.array(typ, np.int32),
                        normal=np.array(nrm, np.float32), idx=idx, rest=rest,
                        muscle=musc, act=act)


@pytest.fixture(scope="module")
def chain_runs():
    """sph_tpu's gather fallback (springs_elastic_only False), 2 steps, and
    the port's with the fallback and with the spring pass."""
    jp, a = elastic_chain_inputs()
    n = len(a["pos"])
    state = dataclasses.replace(
        make_state(a["pos"], np.zeros_like(a["pos"]), a["ptype"],
                   a["normal"]),
        muscle_activation=jnp.asarray(a["act"]))
    springs = jax.tree.map(jnp.asarray, JSprings(
        row_ids=np.arange(24, dtype=np.int32), idx=a["idx"], rest=a["rest"],
        muscle=a["muscle"]))
    lay = dict(n_particles=n, elastic_range=(0, 24), muscle_model=False,
               springs_elastic_only=False)
    jcfg = JF.compute_fast_config(a["pos"], jp, block=128, ccol=128,
                                  interpret=True)
    jout = JF.make_fast_multi_step(jp, JLayout(**lay), jcfg, 2)(
        state, springs, j_empty_membranes(n))
    params = params_from(jp)
    cfg = F.compute_fast_config(a["pos"], params, block=128, ccol=128)
    outs = {}
    for only in (False, True):
        layout = SceneLayout(**dict(lay, springs_elastic_only=only))
        outs[only] = F.make_fast_multi_step(params, layout, cfg, 2)(
            state_from_numpy(a["pos"], np.zeros_like(a["pos"]), a["ptype"],
                             a["normal"], a["act"]),
            springs_from_numpy(np.arange(24, dtype=np.int32), a["idx"],
                               a["rest"], a["muscle"]),
            membranes_from_numpy(np.zeros((0, 3), np.int32),
                                 np.full((n, 7), -1, np.int32)))
    return dict(params=params, cfg=cfg, a=a, lay=lay, jout=jout, outs=outs)


@pytest.mark.parametrize("elastic_only", [False, True])
def test_elastic_chain_matches_jax_fallback(chain_runs, elastic_only):
    """The port's fallback (False) and its spring pass (True) against
    sph_tpu's fallback; the two port paths against each other at the
    bounds of sph_tpu's own pass-vs-fallback test."""
    out = chain_runs["outs"][elastic_only]
    assert_matches(out, chain_runs["jout"], 2)
    if elastic_only:
        fb = chain_runs["outs"][False]
        np.testing.assert_allclose(out.vel.numpy(), fb.vel.numpy(), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(out.pos.numpy(), fb.pos.numpy(), rtol=0,
                                   atol=1e-5)
    # which path ran: the fallback's sorted springs, or the slab pack
    a, params, cfg = chain_runs["a"], chain_runs["params"], chain_runs["cfg"]
    layout = SceneLayout(**dict(chain_runs["lay"],
                                springs_elastic_only=elastic_only))
    n = len(a["pos"])
    ctx, _ = F._make_step_parts(params, layout, cfg).sort_ctx(
        state_from_numpy(a["pos"], np.zeros_like(a["pos"]), a["ptype"],
                         a["normal"], a["act"]),
        springs_from_numpy(np.arange(24, dtype=np.int32), a["idx"],
                           a["rest"], a["muscle"]),
        membranes_from_numpy(np.zeros((0, 3), np.int32),
                             np.full((n, 7), -1, np.int32)))
    assert ("spr_pack" in ctx) == elastic_only
    assert ("springs_s" in ctx) != elastic_only
    # the muscles pulled: the chain's velocities are not the free fall's
    v = out.vel.numpy()[:24]
    assert np.abs(v - v.mean(0)).max() > 1e-3


def test_elastic_accel_matches_jax_random():
    """Random positions and spring tables (pads, a coincident partner,
    muscle ids past MUSCLE_COUNT, inactive muscles)."""
    rng = np.random.default_rng(0)
    jp = JParams()
    n, ne = 300, 60
    pos = rng.uniform(0.0, 10.0, (n, 3)).astype(np.float32)
    rows = rng.choice(n, ne, replace=False).astype(np.int32)
    idx = rng.integers(0, n, (ne, 32)).astype(np.int32)
    idx[rng.random((ne, 32)) < 0.4] = -1
    idx[0, 0] = rows[0]                              # r == 0: dropped
    rest = rng.uniform(0.5, 2.0, (ne, 32)).astype(np.float32) * np.float32(
        jp.simulation_scale)
    musc = rng.integers(0, MUSCLE_COUNT + 5, (ne, 32)).astype(np.int32)
    act = rng.uniform(0.0, 1.0, MUSCLE_COUNT).astype(np.float32)
    act[rng.random(MUSCLE_COUNT) < 0.3] = 0.0
    ref = JE.elastic_accel(
        V3(*(jnp.asarray(pos[:, k]) for k in range(3))),
        JSprings(row_ids=jnp.asarray(rows), idx=jnp.asarray(idx),
                 rest=jnp.asarray(rest), muscle=jnp.asarray(musc)),
        jnp.asarray(act), jp)
    ref = np.stack([np.asarray(c) for c in (ref.x, ref.y, ref.z)], 1)
    out = elastic_accel(torch.as_tensor(pos),
                        springs_from_numpy(rows, idx, rest, musc),
                        torch.as_tensor(act), params_from(jp)).numpy()
    assert out.shape == (ne, 3) and out.dtype == np.float32
    scale = np.abs(ref).max()
    assert scale > 0
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6 * scale)


def test_cli_run_fast_cpu():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-m", "sph_tpu_torch", "run", "--scene", "box",
         "--box", "8,8,8", "--fill", "0.5", "--steps", "3", "--device",
         "cpu", "--engine", "fast", "--ccol", "128", "--ccol-c", "128"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "engine: fast" in res.stdout
    assert "[[ step 3 ]]" in res.stdout and "ms/step" in res.stdout


def test_wall_anchored_worm_steps_on_fallback():
    """The worm of ``__graft_entry__._tiny_worm`` (14h x 12h x 108h): its
    springs anchor to walls, so auto picks the fast engine and the springs
    go through the gather fallback. Two CPU steps: finite, walls still,
    springs stretched but whole, the elastic matter moves. (The worm starts
    squeezed in this pool: its strain reaches 0.65 at step 2 in both
    packages, sph_tpu's fast engine 0.6507, and relaxes below 0.5 on the
    worm's own springs by step 50; the bench's < 0.5 gate is for the worm
    after 500 steps.)"""
    params = SimParams(x_max=14 * H, y_max=12 * H, z_max=108 * H)
    scene = generate_worm_scene(params)
    layout = scene.layout()
    assert not layout.springs_elastic_only
    sim = Simulator(scene, params, engine="auto", device="cpu")
    assert sim.engine == "fast"
    ctx, _ = F._make_step_parts(params, layout, sim._fast_cfg).sort_ctx(
        sim.state, sim.springs, sim.membranes)
    assert "springs_s" in ctx and "spr_pack" not in ctx
    assert "mem_pack" in ctx
    sim.step(2)
    pos = sim.get_position()
    assert np.isfinite(pos).all() and np.isfinite(sim.get_velocity()).all()
    b0, b1 = layout.boundary_range
    np.testing.assert_array_equal(pos[b0:b1], scene.pos[b0:b1])
    idx = scene.spring_idx
    used = idx >= 0
    a = pos[np.repeat(scene.spring_rows, idx.shape[1])[used.ravel()]]
    r = np.linalg.norm(a - pos[idx[used]], axis=1) * params.simulation_scale
    rest = scene.spring_rest[used]
    strain = float(np.max(np.abs(r - rest) / np.maximum(rest, 1e-9)))
    assert 0.0 < strain < 1.0
    el = scene.ptype == ELASTIC_PARTICLE
    assert np.abs(pos[el] - scene.pos[el]).max() > 1e-3
    ovf = sim.check_overflow()
    assert ovf["tile_overflow"] == 0 and ovf["window_drift_h"] > 0


def test_auto_picks_fast_on_the_dam_break():
    """The dam-break of ``scripts/bench_scale.py`` (fill 0.8 of the
    reference world): 11 % wall, so both packages' auto rule picks fast."""
    scene = generate_liquid_box_scene(SimParams(), fill_fraction=0.8)
    layout = scene.layout()
    assert scene.counts["liquid"] == 816_750
    assert layout.n_particles == 918_082     # sph_tpu's default (native)
    assert resolve_auto_engine(layout) == "fast"
    fields = {f.name: getattr(layout, f.name)
              for f in dataclasses.fields(SceneLayout)}
    assert j_resolve(True, JLayout(**fields)) == "fast"
