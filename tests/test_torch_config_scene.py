"""sph_tpu_torch's NumPy-only copies (constants, SimParams, the liquid-box
generator) and its device state against sph_tpu, plus the port's
no-jax import rule."""
import dataclasses
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sph_tpu import constants as jconst
from sph_tpu.config import SimParams as JParams
from sph_tpu.scene import generate_liquid_box_scene as j_box
from sph_tpu.scene import native

from sph_tpu_torch import constants as tconst
from sph_tpu_torch.config import SimParams
from sph_tpu_torch.convert import params_from, state_from_numpy
from sph_tpu_torch.scene import generate_liquid_box_scene

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


def test_liquid_box_scene_bitwise_full(monkeypatch):
    """Full-size box against sph_tpu's NumPy generator, which the port
    copies. (sph_tpu's optional native library, ``native/``, receives the
    box extents as f32 and counts 59 x-columns where the NumPy path counts
    60: 101,332 walls instead of 102,408.)"""
    monkeypatch.setattr(native, "available", lambda: False)
    s = generate_liquid_box_scene(SimParams())
    _assert_scene_equal(s, j_box(JParams()))
    assert s.counts["liquid"] == 108_900
    assert s.counts["boundary"] == 102_408


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
        "assert len(mods) >= 15, mods\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'sph_tpu' or m.startswith('sph_tpu.')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
