"""The reduced worm (10h x 20h x 108h: every spring anchor elastic) stepped
by both packages' fastw engines on the CPU: one 2-step resort period from
the same kicked state (``chip_smoke.kicked``: the moving rows lowered until
the lowest liquid sits 0.4 h above the floor walls, inside their r0 band,
and pushed down at 0.3 m/s, the kick of its engine phases), sph_tpu's
Pallas passes in interpret mode, the port's plain passes. Its own file, so
that ``--dist loadfile`` runs it on a worker of its own: sph_tpu's compile
and 2 steps take ~90 s.

Held to the fastw bound of the JAX tests: velocities within 1e-3 on every
row, positions within 1e-4 on every row farther than 3 h from a
near-coincident pair. The generated worm lies on its pool: a line of pool
liquid rows under the worm's belly sits within 1.5e-4 to 1e-2 sim units of
elastic rows (11 closer than 0.01 r0, where one ulp of z is over 1e-3 of
their distance). Around them the f32 problem does not fix the result to
1e-4: a one-ulp change of the input positions moves the port's own result
by 1.4e-3 to 2.9e-3 in the 2 steps (the test shows it is over 1e-3), and
the packages part by up to 6.5e-3 there (51 rows beyond 1e-4, all within
1.5 h of such a pair). Those rows' positions are held to 1e-2 (0.003 h)."""
import dataclasses

import numpy as np
import torch
from scipy.spatial import cKDTree

import jax.numpy as jnp
from sph_tpu.config import SimParams as JParams
from sph_tpu.core import fastw as JW
from sph_tpu.scene import generate_worm_scene as j_worm

import chip_smoke
from sph_tpu_torch.constants import (BOUNDARY_PARTICLE, ELASTIC_PARTICLE,
                                     LIQUID_PARTICLE)
from sph_tpu_torch.convert import params_from
from sph_tpu_torch.core import fastw as W
from sph_tpu_torch.scene import generate_worm_scene

from test_torch_fastw import WORM
from torch_scenes import scene_path

TOL = 1e-4          # positions; velocities 10x
STEPS = 2
GAP = 0.4           # the lowest liquid above the floor walls, in h
COINCIDENT = 0.01   # a liquid row this close to an elastic row, in r0
REACH = 3.0         # rows this close to a coincident one, in h
NEAR_TOL = 1e-2     # positions of the rows near them


def test_reduced_worm_period_matches_sph_tpu():
    jp, params = JParams(**WORM), params_from(JParams(**WORM))
    with scene_path(native=False):
        js = j_worm(jp)
        scene = generate_worm_scene(params)
    np.testing.assert_array_equal(scene.pos, js.pos)
    layout = scene.layout()
    cfg = W.compute_fastw_config(scene.pos, params, layout,
                                 ptype=scene.ptype)
    ws = W.precompute_wall_static(scene.pos, scene.normal, params, layout,
                                  cfg)
    state, springs, membranes = scene.device_state("cpu")
    start = chip_smoke.kicked(state, speed=0.3, noise=0.05,
                              rest_gap=GAP * params.h)

    # the kicked state's step sums pressure, wall and membrane terms
    calls = W.record_step_inputs(
        W._make_step_parts_w(params, layout, cfg, wall_static=ws), start,
        springs, membranes)
    for name in ("pacc_mm", "bnd_ms", "mem_ms", "spring_ms"):
        p, tables, own, slab = calls[name]
        assert max(float(o.abs().max()) for o in p(tables, own, slab)) > 0, \
            name

    run = W.make_fastw_multi_step(params, layout, cfg, STEPS,
                                  return_diag=True, wall_static=ws)
    out, diag = run(start, springs, membranes)
    assert int(diag["shell_overflow"]) == int(diag["tile_overflow"]) == 0
    # the same state with every moving coordinate one ulp off
    rng = np.random.default_rng(1)
    pos = start.pos.numpy().copy()
    moving = scene.ptype != BOUNDARY_PARTICLE
    pos[moving] = np.nextafter(pos[moving], np.where(
        rng.random(pos[moving].shape) < 0.5, -np.inf, np.inf).astype(
            np.float32))
    nudged, _ = run(dataclasses.replace(start, pos=torch.as_tensor(pos)),
                    springs, membranes)

    jl = js.layout()
    jcfg = JW.compute_fastw_config(js.pos, jp, jl, ptype=js.ptype)
    assert jcfg.interpret
    jws = JW.precompute_wall_static(js.pos, js.normal, jp, jl, jcfg)
    jstate, jsprings, jmembranes = js.device_state()
    jstate = dataclasses.replace(jstate, pos=jnp.asarray(start.pos.numpy()),
                                 vel=jnp.asarray(start.vel.numpy()))
    jout, jdiag = JW.make_fastw_multi_step(
        jp, jl, jcfg, STEPS, return_diag=True, wall_static=jws)(
        jstate, jsprings, jmembranes)
    assert int(jdiag["shell_overflow"]) == int(jdiag["tile_overflow"]) == 0
    assert int(out.step) == int(jout.step) == STEPS
    np.testing.assert_allclose(out.muscle_activation.numpy(),
                               np.asarray(jout.muscle_activation),
                               rtol=0, atol=1e-6)

    p_out, v_out = out.pos.numpy(), out.vel.numpy()
    dpos = np.abs(p_out - np.asarray(jout.pos)).max(1)
    dvel = np.abs(v_out - np.asarray(jout.vel)).max(1)
    spread = np.abs(p_out - nudged.pos.numpy()).max(1)
    # the liquid rows nearly on top of an elastic row, and the rows near them
    p0 = start.pos.numpy()
    elastic = scene.ptype == ELASTIC_PARTICLE
    liquid = np.flatnonzero(scene.ptype == LIQUID_PARTICLE)
    d_el = cKDTree(p0[elastic]).query(p0[liquid])[0]
    coincident = liquid[d_el < COINCIDENT * params.r0]
    near = np.zeros(len(p0), bool)
    for rows in cKDTree(p0).query_ball_point(p0[coincident],
                                             REACH * params.h):
        near[rows] = True
    held = moving & ~near
    assert 0 < len(coincident) and held.sum() >= 0.9 * moving.sum()
    assert (held & elastic).sum() >= 0.9 * elastic.sum()
    assert dpos[held].max() <= TOL, dpos[held].max()
    assert dvel[moving].max() <= 10 * TOL, dvel[moving].max()
    # near them the f32 problem itself does not fix the positions to TOL
    assert spread[near].max() > 10 * TOL
    assert dpos[near].max() <= NEAR_TOL, dpos[near].max()
    # walls still; the elastic body moved far beyond the tolerance
    np.testing.assert_array_equal(p_out[~moving], scene.pos[~moving])
    moved = np.linalg.norm(p_out - p0, axis=1)
    assert moved[held & elastic].max() > 100 * TOL
