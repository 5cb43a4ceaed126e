"""The port's exact engine on CPU against sph_tpu's (``core/grid.py``,
``core/neighbors.py``, ``core/pcisph.py``, ``core/membranes.py``,
``core/step.py``), on identical inputs made with numpy from a seed; each JAX
function is called once per fixture.

Tolerances: grid ``order``/``cell_start`` and neighbour ``idx`` exactly
equal (ties included: both keep the earlier candidate among equal
distances), ``q`` within 1e-7; each solver function within 1e-6 of its
output's scale (max |sph_tpu output|; for integration and the membrane
correction, of the displacement); ``multi_step`` over 10 steps within 5e-5
(positions) and 5e-4 (velocities), as ``tests/test_torch_fast.py``."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sph_tpu.config import SimParams as JParams
from sph_tpu.core import grid as JG
from sph_tpu.core import membranes as JM
from sph_tpu.core import neighbors as JN
from sph_tpu.core import pcisph as JP
from sph_tpu.core import step as JS
from sph_tpu.ops import vec3
from sph_tpu.scene import generate_liquid_box_scene as j_box
from sph_tpu.scene.scene import Scene as JScene

from sph_tpu_torch import bench
from sph_tpu_torch.convert import params_from
from sph_tpu_torch.core import grid as G
from sph_tpu_torch.core import membranes as M
from sph_tpu_torch.core import neighbors as N
from sph_tpu_torch.core import pcisph as P
from sph_tpu_torch.core import step as S
from sph_tpu_torch.runtime import Simulator
from sph_tpu_torch.scene import generate_liquid_box_scene

from test_grid_neighbors import small_params
from test_torch_fastw import (BOX, KICK, membrane_quad_scene, port_scene,
                              spring_chain_scene)
from test_torch_pair_kernels import kick_box_scene

H = 3.34
ATOL = 5e-5
VTOL = 5e-4
FN_TOL = 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OFF = np.array([-2 * H, 1.5 * H, -3 * H], np.float32)


def v3(a):
    return vec3.split(jnp.asarray(a))


def merged(v):
    return np.array(vec3.merge(v))


def ids(n):
    return jnp.arange(n, dtype=jnp.int32), torch.arange(n, dtype=torch.int32)


def port_nbrs(nb):
    """sph_tpu's NeighborList as the port's (the same lists on both sides)."""
    return N.NeighborList(*(torch.as_tensor(np.array(a))
                            for a in (nb.idx, nb.q, nb.valid)))


def assert_scaled(got, want, tol=FN_TOL, what=""):
    """|got - want| <= tol * max|want|, with a nonzero scale."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    assert scale > 0.0, f"{what}: reference is all zero (vacuous)"
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} * {scale:.3e}"


# ---------------------------------------------------------------------------
# grid and neighbour search
# ---------------------------------------------------------------------------

def _cloud(name):
    """(jax params, positions) of a named grid/neighbour case."""
    rng = np.random.default_rng(11)
    if name == "box":
        jp = JParams(**BOX)
        return jp, j_box(jp, fill_fraction=0.5).pos
    if name == "box_min_offset":
        jp = JParams(x_min=float(OFF[0]), x_max=float(OFF[0]) + 8 * H,
                     y_min=float(OFF[1]), y_max=float(OFF[1]) + 8 * H,
                     z_min=float(OFF[2]), z_max=float(OFF[2]) + 8 * H)
        lo, hi = np.array(jp.box_min), np.array(jp.box_max)
        # 600 inside, 40 outside the box on every side (clipped into the
        # edge cells)
        return jp, np.concatenate([
            rng.uniform(lo + 0.01, hi - 0.01, (600, 3)),
            rng.uniform(lo - 2 * H, hi + 3 * H, (40, 3))]).astype(np.float32)
    if name == "lattice":
        # a perfect lattice at 0.85 r0: 56 neighbours within h, many at
        # exactly equal distances, so the 32 kept are decided by ties; and
        # apart from it a pair exactly h apart in f32 (within h: r <= h)
        jp = JParams(**BOX)
        ax = np.arange(9) * jp.r0 * 0.85
        g = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1)
        h = np.float32(jp.h)
        pair = np.array([[0.5, 20.0, 20.0], [0.5 + h, 20.0, 20.0]],
                        np.float32)
        return jp, np.concatenate([(2.0 + g.reshape(-1, 3)).astype(
            np.float32), pair])
    # the dense cluster of tests/test_grid_neighbors.py (> 32 within h)
    jp = small_params()
    crng = np.random.default_rng(3)
    pos = (np.array([13.0, 13.0, 13.0])
           + crng.normal(scale=0.4 * jp.h, size=(64, 3))).astype(np.float32)
    return jp, np.clip(pos, 0.01, np.array(jp.box_max) - 0.01)


@pytest.mark.parametrize("name", ["box", "box_min_offset"])
def test_build_grid_matches(name):
    jp, pos = _cloud(name)
    jg = JG.build_grid(v3(pos), jp)
    g = G.build_grid(torch.as_tensor(pos), params_from(jp))
    for a, b in ((g.ccx, jg.ccx), (g.ccy, jg.ccy), (g.ccz, jg.ccz),
                 (g.order, jg.order), (g.cell_start, jg.cell_start)):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(g.cell_start[-1]) == len(pos)
    assert (G.max_cell_occupancy(pos, params_from(jp))
            == JG.max_cell_occupancy(pos, jp))
    assert int(G.cell_occupancy_overflow(g, params_from(jp))) == int(
        JG.cell_occupancy_overflow(jg, jp))


@pytest.mark.parametrize("name", ["lattice", "dense_cluster"])
def test_find_neighbors_matches(name):
    jp, pos = _cloud(name)
    p = params_from(jp)
    jids, tids = ids(len(pos))
    v = v3(pos)
    nb = JN.find_neighbors(v, jids, v, JG.build_grid(v, jp), jp)
    tp = torch.as_tensor(pos)
    tn = N.find_neighbors(tp, tids, tp, G.build_grid(tp, p), p)
    # the case truncates: some rows have all 32 slots filled
    assert int(JN.neighbor_overflow(nb)) > 0
    assert int(N.neighbor_overflow(tn)) == int(JN.neighbor_overflow(nb))
    np.testing.assert_array_equal(tn.idx.numpy(), np.asarray(nb.idx))
    np.testing.assert_array_equal(tn.valid.numpy(), np.asarray(nb.valid))
    np.testing.assert_allclose(tn.q.numpy(), np.asarray(nb.q), rtol=0,
                               atol=1e-7)
    if name == "lattice":                   # the pair exactly h apart
        assert tn.idx[-1, 0] == len(pos) - 2 and tn.valid[-1].sum() == 1


# ---------------------------------------------------------------------------
# the solver functions, on one neighbour list
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def solver():
    """The violently kicked 8h box with walls (jittered, lowered into the
    walls' r0 band, pushed down at 2 m/s: pairs closer than h/4 and nonzero
    pressure at the first step): both packages' solver functions on
    sph_tpu's neighbour list of it."""
    jp = JParams(**BOX)
    js = kick_box_scene(j_box(jp, fill_fraction=0.5), jp)
    pos, vel, normal = v3(js.pos), v3(js.vel), v3(js.normal)
    ptype = jnp.asarray(js.ptype)
    jids, _ = ids(len(js.pos))
    nb = JN.find_neighbors(pos, jids, pos, JG.build_grid(pos, jp), jp)
    rho = JP.compute_density(nb, jp)
    a_ext = JP.compute_external_forces(pos, vel, rho, ptype, nb, jp,
                                       normal_g=normal)
    res = JP.pcisph_pressure_loop(pos, vel, ptype, nb, jp)
    x1, v1 = JP.integrate(pos, vel, ptype, a_ext, res.a_p, nb, jp,
                          normal_g=normal)
    state, _, _ = js.device_state()
    diag = JS.diagnostics(state, jp)
    ref = dict(rho=np.array(rho), a_ext=merged(a_ext),
               pressure=np.array(res.pressure), a_p=merged(res.a_p),
               x1=merged(x1), v1=merged(v1),
               diag={k: np.array(v) for k, v in diag.items()})
    t = dict(pos=torch.as_tensor(js.pos), vel=torch.as_tensor(js.vel),
             normal=torch.as_tensor(js.normal),
             ptype=torch.as_tensor(js.ptype))
    return dict(jp=jp, p=params_from(jp), js=js, nbrs=port_nbrs(nb), t=t,
                ref=ref)


def test_compute_density_matches(solver):
    rho = P.compute_density(solver["nbrs"], solver["p"])
    assert_scaled(rho.numpy(), solver["ref"]["rho"], what="rho")


def test_external_forces_match(solver):
    t, ref = solver["t"], solver["ref"]
    a = P.compute_external_forces(
        t["pos"], t["vel"], torch.as_tensor(ref["rho"]), t["ptype"],
        solver["nbrs"], solver["p"], normal_g=t["normal"])
    assert a.shape == t["pos"].shape
    assert_scaled(a.numpy(), ref["a_ext"], what="a_ext")


def test_pressure_loop_matches(solver):
    t, ref = solver["t"], solver["ref"]
    res = P.pcisph_pressure_loop(t["pos"], t["vel"], t["ptype"],
                                 solver["nbrs"], solver["p"])
    assert_scaled(res.pressure.numpy(), ref["pressure"], what="pressure")
    assert_scaled(res.a_p.numpy(), ref["a_p"], what="a_p")


def test_integrate_matches(solver):
    """Positions and velocities after integration and the boundary
    response; the position is held on its displacement's scale, and some
    particles must take the boundary correction (they start in the walls'
    r0 band)."""
    t, ref = solver["t"], solver["ref"]
    x1, v1 = P.integrate(
        t["pos"], t["vel"], t["ptype"], torch.as_tensor(ref["a_ext"]),
        torch.as_tensor(ref["a_p"]), solver["nbrs"], solver["p"],
        normal_g=t["normal"])
    pos0 = t["pos"].numpy()
    assert_scaled(x1.numpy() - pos0, ref["x1"] - pos0, what="displacement")
    assert_scaled(v1.numpy(), ref["v1"], what="velocity")
    v_new = t["vel"] + torch.as_tensor(ref["a_ext"] + ref["a_p"]) * float(
        np.float32(solver["p"].time_step))
    assert not torch.allclose(v1, (t["vel"] + v_new) * 0.5)


def test_diagnostics_match(solver):
    state = solver["js"]
    pstate = port_scene(state).device_state("cpu")[0]
    out = S.diagnostics(pstate, solver["p"])
    ref = solver["ref"]["diag"]
    assert set(out) == set(ref)
    for k in ("rho", "pressure"):
        assert_scaled(out[k].numpy(), ref[k], what=k)
    for k in ("neighbor_count", "neighbor_overflow", "cell_overflow"):
        np.testing.assert_array_equal(out[k].numpy(), ref[k])


def test_membrane_correction_matches():
    """The membrane quad: the liquid particle 0.4 r0 above two triangles is
    pushed out; both evaluation modes (liquid slice, liquid mask)."""
    jp = JParams(**BOX)
    js = membrane_quad_scene(jp)
    p = params_from(jp)
    pos, ptype = v3(js.pos), jnp.asarray(js.ptype)
    jids, tids = ids(len(js.pos))
    nb = JN.find_neighbors(pos, jids, pos, JG.build_grid(pos, jp), jp)
    _, _, jmem = js.device_state()
    lr = js.layout().liquid_range
    ref = merged(JM.membrane_position_correction(pos, ptype, nb, jmem, jp,
                                                 liquid_range=lr))
    _, _, mem = port_scene(js).device_state("cpu")
    tp = torch.as_tensor(js.pos)
    for kw in (dict(liquid_range=lr), dict(pos_g=tp)):
        got = M.membrane_position_correction(
            tp, torch.as_tensor(js.ptype), port_nbrs(nb), mem, p, **kw)
        assert_scaled(got.numpy() - js.pos, ref - js.pos,
                      what=f"membrane delta {list(kw)}")
    assert np.abs(ref - js.pos).max() > 0.01 * jp.r0


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _engine_scene(name):
    """(jax params, jax scene) of a named engine case."""
    if name == "gate_box":
        p, sc = bench.gate_box_scene(params_from(JParams()))
        jp = JParams(x_max=p.x_max, y_max=p.y_max, z_max=p.z_max,
                     cell_capacity=p.cell_capacity)
        return jp, JScene(pos=sc.pos, vel=sc.vel, color=sc.color,
                          normal=sc.normal)
    jp = JParams(**BOX)
    if name == "kicked_box":
        return jp, kick_box_scene(j_box(jp, fill_fraction=0.5), jp, **KICK)
    if name == "spring_chain":
        return jp, spring_chain_scene(jp)
    return jp, membrane_quad_scene(jp)


def assert_engine_matches(out, ref, steps):
    np.testing.assert_allclose(out.pos.numpy(), np.asarray(ref.pos),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(out.vel.numpy(), np.asarray(ref.vel),
                               rtol=0, atol=VTOL)
    assert int(out.step) == int(ref.step) == steps
    np.testing.assert_allclose(out.muscle_activation.numpy(),
                               np.asarray(ref.muscle_activation),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["gate_box", "kicked_box", "spring_chain",
                                  "membrane_quad"])
def test_multi_step_matches(name):
    jp, js = _engine_scene(name)
    ref = JS.multi_step(*js.device_state(), jp, js.layout(), 10)
    scene = port_scene(js)
    out = S.multi_step(*scene.device_state("cpu"), params_from(jp),
                       scene.layout(), 10)
    assert_engine_matches(out, ref, 10)
    moved = np.abs(np.asarray(ref.pos) - js.pos).max()
    assert moved > 100 * ATOL, f"{name}: moved only {moved}"
    b0, b1 = scene.layout().boundary_range
    np.testing.assert_array_equal(out.pos.numpy()[b0:b1], js.pos[b0:b1])
    if name == "spring_chain":
        assert out.muscle_activation.max() > 0.5


def test_multi_step_cached_matches():
    """Refresh 1 equals the port's multi_step bit for bit; refresh 3 (4
    steps, a shorter last sweep) is held against sph_tpu's."""
    jp, js = _engine_scene("kicked_box")
    p, scene = params_from(jp), port_scene(js)
    args = scene.device_state("cpu")
    plain = S.multi_step(*args, p, scene.layout(), 4)
    one = S.multi_step_cached(*args, p, scene.layout(), 4, refresh_every=1)
    assert torch.equal(one.pos, plain.pos) and torch.equal(one.vel,
                                                           plain.vel)
    # cached indices on moved positions: the same pairs drop out beyond h
    st = args[0]
    idx = S.neighbor_indices(st, p, scene.layout())
    moved = st.pos.numpy() + np.random.default_rng(5).normal(
        0.0, 0.3, st.pos.shape).astype(np.float32)
    jst, _, _ = js.device_state()
    jst = jst.__class__(**{**jst.__dict__, "pos": jnp.asarray(moved)})
    jf = JS._freshen_neighbors(jst, jnp.asarray(idx.numpy()), jp)
    tf = S._freshen_neighbors(dataclasses.replace(
        st, pos=torch.as_tensor(moved)), idx, p)
    np.testing.assert_array_equal(tf.idx.numpy(), np.asarray(jf.idx))
    np.testing.assert_array_equal(tf.valid.numpy(), np.asarray(jf.valid))
    # q <= 1 within one f32 ulp of 1 (the two sqrt implementations differ
    # by an ulp on some inputs)
    np.testing.assert_allclose(tf.q.numpy(), np.asarray(jf.q), rtol=0,
                               atol=float(np.spacing(np.float32(1.0))))
    assert (idx >= 0).sum() > tf.valid.sum() > 0
    ref = JS.multi_step_cached(*js.device_state(), jp, js.layout(), 4,
                               refresh_every=3)
    out = S.multi_step_cached(*args, p, scene.layout(), 4, refresh_every=3)
    assert_engine_matches(out, ref, 4)
    again = S.multi_step_unrolled_cached(*args, p, scene.layout(), 4,
                                         refresh_every=3)
    assert torch.equal(again.pos, out.pos)
    # the cached indices change the trajectory: refresh 3 is not refresh 1
    assert not torch.equal(out.pos, plain.pos)


def test_simulator_exact_cpu():
    """Simulator(engine="exact") steps the engine (scene-measured cell
    capacity), reports cell overflow, and its getters are diagnostics'."""
    params = params_from(JParams(**BOX, cell_capacity=16))
    scene = kick_box_scene(generate_liquid_box_scene(params,
                                                     fill_fraction=0.5),
                           params, **KICK)
    sim = Simulator(scene, params, engine="exact", device="cpu")
    assert sim.engine == "exact"
    cap = G.measured_cell_capacity(scene.pos, params)
    assert sim.params.cell_capacity == cap > 16
    sim.step(2)
    sim.step(1)
    ref = S.multi_step(*scene.device_state("cpu"), sim.params,
                       scene.layout(), 3)
    assert sim.step_count == 3
    np.testing.assert_array_equal(sim.get_position(), ref.pos.numpy())
    np.testing.assert_array_equal(sim.get_velocity(), ref.vel.numpy())
    assert sim.check_overflow() == {"cell_overflow": 0}
    diag = S.diagnostics(ref, sim.params)
    np.testing.assert_array_equal(sim.get_density(), diag["rho"].numpy())
    np.testing.assert_array_equal(sim.get_pressure(),
                                  diag["pressure"].numpy())
    got = sim.get_diagnostics()
    assert set(got) == {"rho", "pressure", "neighbor_count",
                        "neighbor_overflow", "cell_overflow"}
    assert got["pressure"].max() > 0.0
    # a capacity below the densest cell's occupancy is reported
    small = Simulator(scene, params, engine="exact", device="cpu")
    small.params = dataclasses.replace(params, cell_capacity=4)
    occ = G.max_cell_occupancy(scene.pos, params)
    assert small.check_overflow() == {"cell_overflow": occ - 4}


def test_cli_run_exact_cpu():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-m", "sph_tpu_torch", "run", "--scene", "box",
         "--box", "8,8,8", "--fill", "0.5", "--steps", "2",
         "--report-every", "1", "--engine", "exact", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "engine: exact" in res.stdout
    assert res.stdout.count("ms/step") == 2
