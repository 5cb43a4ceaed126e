"""sph_tpu_torch's NumPy-only copies (constants, SimParams, the liquid-box
and worm generators), its device state, its muscle wave and its tile-chunk
tables against sph_tpu, plus the port's no-jax import rule."""
import dataclasses
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sph_tpu import constants as jconst
from sph_tpu.config import SimParams as JParams
from sph_tpu.core import fast as JF
from sph_tpu.models import muscle as jmuscle
from sph_tpu.scene import generate_liquid_box_scene as j_box
from sph_tpu.scene import generate_worm_scene as j_worm

from sph_tpu_torch import constants as tconst
from sph_tpu_torch.config import SimParams
from sph_tpu_torch.convert import (membranes_from_numpy, params_from,
                                   springs_from_numpy, state_from_numpy)
from sph_tpu_torch.core import fast as F
from sph_tpu_torch.models import muscle
from sph_tpu_torch.scene import generate_liquid_box_scene, generate_worm_scene

from torch_scenes import scene_path

H = 3.34
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PARAM_CASES = [
    {},
    dict(x_max=8 * H, y_max=8 * H, z_max=8 * H),
    dict(x_min=-2 * H, x_max=6 * H, time_step=1e-6, h=3.0, rho0=998.0,
         n_pcisph_iters=4),
]


def test_constants_equal():
    names = [k for k in vars(jconst) if k.isupper()]
    assert names
    for k in names:
        assert getattr(tconst, k) == getattr(jconst, k), k


@pytest.mark.parametrize("kw", PARAM_CASES)
def test_params_fields_and_coefficients(kw):
    jp = JParams(**kw)
    p = params_from(jp)
    assert p == SimParams(**kw)
    assert ([f.name for f in dataclasses.fields(SimParams)]
            == [f.name for f in dataclasses.fields(JParams)])
    for f in dataclasses.fields(JParams):
        assert getattr(p, f.name) == getattr(jp, f.name), f.name
    coeffs = [k for k, v in vars(JParams).items()
              if isinstance(v, functools.cached_property)]
    assert {"c_rho", "c_visc", "c_surf", "c_press", "delta", "r0"} \
        <= set(coeffs)
    for k in coeffs:
        # computed in f64 by the same expressions: exactly equal
        assert getattr(p, k) == getattr(jp, k), k


def _assert_scene_equal(s, js):
    for k in ("pos", "vel", "color", "normal", "spring_rows", "spring_idx",
              "spring_rest", "spring_type", "tris"):
        a, b = getattr(s, k), getattr(js, k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert s.muscle_model == js.muscle_model
    assert dataclasses.asdict(s.layout()) == dataclasses.asdict(js.layout())
    assert s.counts == js.counts


def test_liquid_box_scene_bitwise_small():
    kw = PARAM_CASES[1]
    s = generate_liquid_box_scene(SimParams(**kw), fill_fraction=0.5)
    _assert_scene_equal(s, j_box(JParams(**kw), fill_fraction=0.5))


def test_liquid_box_scene_bitwise_full():
    """Full-size box on both packages' NumPy path. (Their native builders
    receive the box extents as f32 and count 59 x-columns where the NumPy
    path counts 60: 101,332 walls instead of 102,408;
    ``tests/test_torch_native.py`` holds that path.)"""
    with scene_path(native=False):
        s = generate_liquid_box_scene(SimParams())
        js = j_box(JParams())
    _assert_scene_equal(s, js)
    assert s.counts["liquid"] == 108_900
    assert s.counts["boundary"] == 102_408


def test_worm_scene_bitwise_small():
    """The worm at the 20h x 12h x 110h size of ``tests/test_scene.py`` on
    both packages' NumPy path, array for array; the device state and the
    converters carry its springs and membranes over unchanged."""
    kw = dict(x_max=20 * H, y_max=12 * H, z_max=110 * H)
    with scene_path(native=False):
        s = generate_worm_scene(SimParams(**kw))
        js = j_worm(JParams(**kw))
    _assert_scene_equal(s, js)
    c = s.counts
    assert c["elastic"] == 10_143 and c["membranes"] == 11_386
    assert c["springs"] > 130_000 and s.muscle_model
    assert (s.spring_type > 0).sum() > 1000        # muscle springs exist
    _, jsp, jmb = js.device_state()
    _, sp, mb = s.device_state("cpu")
    conv = springs_from_numpy(np.asarray(jsp.row_ids), np.asarray(jsp.idx),
                              np.asarray(jsp.rest), np.asarray(jsp.muscle))
    for k in ("row_ids", "idx", "rest", "muscle"):
        assert torch.equal(getattr(conv, k), getattr(sp, k)), k
        assert getattr(sp, k).numpy().dtype == np.asarray(
            getattr(jsp, k)).dtype
    assert int(sp.muscle.max()) == 96
    convm = membranes_from_numpy(np.asarray(jmb.tris),
                                 np.asarray(jmb.particle_tris))
    for k in ("tris", "particle_tris"):
        assert torch.equal(getattr(convm, k), getattr(mb, k)), k
    assert int((mb.particle_tris >= 0).sum(1).max()) == 7


def test_muscle_wave_matches_jax():
    """f32 sines of torch and XLA may differ in the last place: 1e-6."""
    for t in (0.0, 1.0, 499.0, 12345.0):
        out = muscle.waves_signal(torch.tensor(t))
        ref = np.asarray(jmuscle.waves_signal(jnp.float32(t)))
        assert out.shape == ref.shape == (tconst.MUSCLE_COUNT,)
        assert out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)
        assert out.numpy()[:tconst.ACTIVE_MUSCLE_COUNT].max() > 0.5
    step = torch.tensor(7, dtype=torch.int32)
    np.testing.assert_allclose(
        muscle.next_activation(step).numpy(),
        np.asarray(jmuscle.next_activation(jnp.int32(7))), rtol=0, atol=1e-6)
    table = muscle.schedule(5, device="cpu")
    ref = np.asarray(jmuscle.schedule(5))
    assert table.shape == ref.shape
    np.testing.assert_allclose(table.numpy(), ref, rtol=0, atol=1e-6)
    assert not table[0].any() and table[1].any()


@pytest.mark.parametrize("seed,ccol", [(0, 128), (1, 256), (2, 512)])
def test_tile_chunks_match_jax(seed, ccol):
    """Random nondecreasing column ranges per block, some empty, some
    starting below an aligned offset (the negated floor division)."""
    rng = np.random.default_rng(seed)
    nb = 64
    edges = np.sort(rng.integers(0, 5000, (nb, 6)), axis=1)
    lo, hi = edges[:, 0::2].copy(), edges[:, 1::2].copy()
    hi[rng.random((nb, 3)) < 0.2] = 0             # empty chunks
    lo, hi = lo.reshape(-1).astype(np.int32), hi.reshape(-1).astype(np.int32)
    out = F._tile_chunks(torch.as_tensor(lo), torch.as_tensor(hi), nb, ccol)
    ref = JF._tile_chunks(jnp.asarray(lo), jnp.asarray(hi), nb, ccol)
    for o, r in zip(out, ref):
        assert o.dtype == torch.int32 and o.is_contiguous()
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    assert int(out[2].max()) > 1


def test_device_state_matches_jax():
    kw = PARAM_CASES[1]
    js = j_box(JParams(**kw), fill_fraction=0.5)
    s = generate_liquid_box_scene(SimParams(**kw), fill_fraction=0.5)
    jst, jsp, jmb = js.device_state()
    st, sp, mb = s.device_state("cpu")
    pairs = [
        (st.pos, jst.pos), (st.vel, jst.vel), (st.ptype, jst.ptype),
        (st.normal, jst.normal),
        (st.muscle_activation, jst.muscle_activation), (st.step, jst.step),
        (sp.row_ids, jsp.row_ids), (sp.idx, jsp.idx), (sp.rest, jsp.rest),
        (sp.muscle, jsp.muscle), (mb.tris, jmb.tris),
        (mb.particle_tris, jmb.particle_tris),
    ]
    for t, j in pairs:
        j = np.asarray(j)
        assert t.device.type == "cpu"
        assert t.numpy().dtype == j.dtype and t.shape == j.shape
        np.testing.assert_array_equal(t.numpy(), j)
    conv = state_from_numpy(js.pos, js.vel, js.ptype, js.normal,
                            np.asarray(jst.muscle_activation),
                            np.asarray(jst.step))
    for k in ("pos", "vel", "ptype", "normal", "muscle_activation", "step"):
        assert torch.equal(getattr(conv, k), getattr(st, k)), k


def test_port_imports_no_jax():
    """Every sph_tpu_torch module and chip_smoke.py import without jax or
    sph_tpu (the machine with the card has no jax)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import sph_tpu_torch, chip_smoke\n"
        "mods = [m.name for m in pkgutil.walk_packages("
        "sph_tpu_torch.__path__, 'sph_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "assert len(mods) >= 22, mods\n"
        "assert {'sph_tpu_torch.runtime.async_io', "
        "'sph_tpu_torch.runtime.checkpoint', 'sph_tpu_torch.scene.io', "
        "'sph_tpu_torch.viz.render', 'sph_tpu_torch.cli'} <= set(mods), "
        "mods\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'sph_tpu' or m.startswith('sph_tpu.')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
