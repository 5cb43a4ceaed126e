"""The port's package surface against sph_tpu's on the CPU: the multi-worm
generator (both packages on their NumPy path, ``torch_scenes.scene_path``;
bitwise), ``make_state`` (host arrays to a state, bitwise) and
the top-level names. (The scripts that use them are tested in
``tests/test_torch_scale.py``.)"""
import dataclasses

import numpy as np
import pytest
import torch

import sph_tpu
from sph_tpu.config import SimParams as JParams
from sph_tpu.core.state import make_state as j_make_state
from sph_tpu.scene import generate_multi_worm_params as j_multi_params
from sph_tpu.scene import generate_multi_worm_scene as j_multi_worm

import sph_tpu_torch
from sph_tpu_torch.constants import BOUNDARY_PARTICLE
from sph_tpu_torch.convert import params_from
from sph_tpu_torch.scene import (generate_liquid_box_scene,
                                 generate_multi_worm_params,
                                 generate_multi_worm_scene,
                                 generate_worm_scene)

from test_torch_fastw import BOX, WORM
from torch_scenes import scene_path

SCENE_FIELDS = ("pos", "vel", "color", "normal", "spring_rows", "spring_idx",
                "spring_rest", "spring_type", "tris")


@pytest.mark.parametrize("n_worms", [1, 2])
def test_multi_worm_scene_equals_sph_tpu(n_worms):
    """Array for array, bitwise, on the reduced worm's lane (both packages'
    NumPy path); the widened params field for field."""
    jp = JParams(**WORM)
    with scene_path(native=False):
        js = j_multi_worm(n_worms, jp)
        ps = generate_multi_worm_scene(n_worms, params_from(jp))
        one = generate_worm_scene(params_from(jp)) if n_worms == 1 else None
    for f in SCENE_FIELDS:
        a, b = getattr(ps, f), getattr(js, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert ps.muscle_model and js.muscle_model
    assert ps.counts == js.counts
    wide, jwide = generate_multi_worm_params(n_worms, params_from(jp)), \
        j_multi_params(n_worms, jp)
    for f in dataclasses.fields(wide):
        assert getattr(wide, f.name) == getattr(jwide, f.name), f.name
    assert wide.x_max == pytest.approx(n_worms * WORM["x_max"])
    layout = ps.layout()
    assert layout.springs_elastic_only and layout.elastic_range[0] == 0
    if n_worms == 1:         # one worm is the worm scene
        for f in SCENE_FIELDS:
            np.testing.assert_array_equal(getattr(ps, f), getattr(one, f))
    else:                    # the worms are the same worm a lane apart
        ne = ps.counts["elastic"] // n_worms
        np.testing.assert_allclose(ps.pos[ne:2 * ne, 0] - ps.pos[:ne, 0],
                                   WORM["x_max"], rtol=0, atol=1e-4)
        assert (ps.tris[len(ps.tris) // 2:] >= ne).all()


def _host_arrays(seed=0, n=64):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 10, (n, 3))
    vel = rng.normal(size=(n, 3))
    ptype = rng.choice([1, 2, 3], n)
    normal = rng.normal(size=(n, 3))
    return pos, vel, ptype, normal


@pytest.mark.parametrize("with_normal", [False, True])
def test_make_state_equals_sph_tpu(with_normal):
    """Host arrays (f64 and i64 in) to a state, boundary rows' ``vel`` taken
    as their normals when no ``normal`` is given; every field bitwise
    sph_tpu's, dtypes f32 and i32, on the device asked for; the state
    steps through the exported ``simulation_step`` and ``multi_step``."""
    pos, vel, ptype, normal = _host_arrays()
    assert (ptype == BOUNDARY_PARTICLE).any()
    args = (pos, vel, ptype) + ((normal,) if with_normal else ())
    ours = sph_tpu_torch.make_state(*args, device="cpu")
    ref = j_make_state(*args)
    for f in dataclasses.fields(ours):
        a, b = getattr(ours, f.name), np.asarray(getattr(ref, f.name))
        assert a.device.type == "cpu"
        assert str(a.dtype).split(".")[-1] == str(b.dtype), f.name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f.name)
    walls = ptype == BOUNDARY_PARTICLE
    assert not ours.vel.numpy()[walls].any() or with_normal
    # the state steps through the exported API
    params = sph_tpu_torch.SimParams(**BOX)
    scene = generate_liquid_box_scene(params, fill_fraction=0.5)
    st = sph_tpu_torch.make_state(scene.pos, scene.vel, scene.ptype,
                                  scene.normal, device="cpu")
    # the state owns its data, as sph_tpu's does
    assert not np.shares_memory(st.pos.numpy(), scene.pos)
    _, springs, membranes = scene.device_state("cpu")
    one = sph_tpu_torch.simulation_step(st, springs, membranes, params,
                                        scene.layout())
    two = sph_tpu_torch.multi_step(st, springs, membranes, params,
                                   scene.layout(), 1)
    assert torch.equal(one.pos, two.pos) and int(two.step) == 1


def test_top_level_names_equal_sph_tpu():
    assert sph_tpu_torch.__all__ == sph_tpu.__all__
    for name in sph_tpu_torch.__all__:
        assert hasattr(sph_tpu_torch, name), name
