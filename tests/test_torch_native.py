"""The port's native scene builder (``sph_tpu_torch/scene/native.py``)
against sph_tpu's, the scenes of both generator paths against sph_tpu's,
and ``profile_trace`` on the CPU.

Each package builds its scenes natively where ``g++`` is found (its
default) and with NumPy loops otherwise; the two paths differ on the full
box (101,332 walls against 102,408), so every comparison puts both
packages on one path (``torch_scenes.scene_path``)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sph_tpu.config import SimParams as JParams
from sph_tpu.scene import generate_liquid_box_scene as j_box
from sph_tpu.scene import generate_multi_worm_scene as j_multi_worm
from sph_tpu.scene import generate_worm_scene as j_worm
from sph_tpu.scene import native as j_native

from sph_tpu_torch.config import SimParams
from sph_tpu_torch.constants import MAX_NEIGHBORS
from sph_tpu_torch.runtime.timing import profile_trace
from sph_tpu_torch.scene import (generate_liquid_box_scene,
                                 generate_multi_worm_scene,
                                 generate_worm_scene)
from sph_tpu_torch.scene import native

from test_torch_config_scene import _assert_scene_equal
from torch_scenes import scene_path

H = 3.34
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_native_builder.py's params, and the full box
SIZES = {"small": dict(x_max=12 * H, y_max=10 * H, z_max=40 * H),
         "full": {}}
REDUCED_WORM = dict(x_max=10 * H, y_max=20 * H, z_max=108 * H)
# particles of each scene on each path (sph_tpu's counts)
COUNTS = {"worm": (231_811, 232_887), "box": (210_232, 211_308),
          "dam": (918_082, 919_158), "worm2": (436_750, 437_826),
          "rworm": (60_603, 59_763)}


def test_source_is_sph_tpus():
    assert native.SRC.read_bytes() == Path(
        REPO, "native", "scene_builder.cpp").read_bytes()


@pytest.mark.parametrize("size", SIZES)
def test_entry_points_equal_sph_tpu(size):
    """Each entry point bitwise and in dtype against sph_tpu's native one;
    the spring graph on sph_tpu's native worm at that size."""
    jp = JParams(**SIZES[size])
    r0 = np.float32(jp.r0)
    ext = (jp.x_max, jp.y_max, jp.z_max)
    with scene_path(native=True):
        js = j_worm(jp)
    c = js.counts
    graph = (js.pos, c["elastic"], c["liquid"], float(r0),
             float(np.float32(jp.simulation_scale)), MAX_NEIGHBORS)
    for name, args in (("pool_liquid", (r0, *ext, 0.15)),
                       ("boundary_box", (r0, *ext)),
                       ("inner_worm_liquid", (r0, *ext)),
                       ("spring_graph", graph)):
        ours, ref = getattr(native, name)(*args), getattr(j_native, name)(
            *args)
        ours, ref = (ours, ref) if isinstance(ours, tuple) else ((ours,),
                                                                 (ref,))
        for a, b in zip(ours, ref, strict=True):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)
            assert len(a), name


def _scenes(name):
    """(the port's scene ``name``, sph_tpu's)."""
    if name == "worm":
        return generate_worm_scene(SimParams()), j_worm(JParams())
    if name == "rworm":
        return (generate_worm_scene(SimParams(**REDUCED_WORM)),
                j_worm(JParams(**REDUCED_WORM)))
    if name == "worm2":
        return (generate_multi_worm_scene(2, SimParams()),
                j_multi_worm(2, JParams()))
    fill = 0.8 if name == "dam" else 0.15
    return (generate_liquid_box_scene(SimParams(), fill_fraction=fill),
            j_box(JParams(), fill_fraction=fill))


@pytest.mark.parametrize("path", ["native", "numpy"])
@pytest.mark.parametrize("name", COUNTS)
def test_scene_equals_sph_tpu(name, path):
    """Array for array on one path; the native worm is sph_tpu's default
    full worm (its TPU records' 231,811 particles)."""
    with scene_path(native=path == "native"):
        ours, ref = _scenes(name)
    _assert_scene_equal(ours, ref)
    assert ours.n_particles == COUNTS[name][path == "numpy"]
    if name == "worm":
        assert ours.counts == dict(
            liquid=120_336, elastic=10_143,
            boundary=101_332 if path == "native" else 102_408,
            springs=137_804, membranes=11_386)


def test_port_reaches_neither_sph_tpu_nor_native_dir(tmp_path):
    """Every module of the port imported, then the native library built
    from the port's own source into an empty build directory and a worm
    generated with it: no module of sph_tpu is imported, nothing under
    ``native/`` is opened, listed, compiled or loaded (audit events)."""
    code = (
        "import importlib, os, pkgutil, sys\n"
        f"native_dir = os.path.join({REPO!r}, 'native') + os.sep\n"
        "seen = []\n"
        "def hook(event, args):\n"
        "    if event in ('open', 'os.listdir', 'os.scandir',\n"
        "                 'subprocess.Popen', 'ctypes.dlopen'):\n"
        "        seen.append((event, repr(args)))\n"
        "sys.addaudithook(hook)\n"
        "import sph_tpu_torch\n"
        "for m in pkgutil.walk_packages(sph_tpu_torch.__path__,\n"
        "                               'sph_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from sph_tpu_torch import SimParams\n"
        "from sph_tpu_torch.scene import generate_worm_scene, native\n"
        "from pathlib import Path\n"
        f"native.BUILD_DIR = Path({str(tmp_path)!r})\n"
        "assert native.available()\n"
        "s = generate_worm_scene(SimParams(x_max=40.08, y_max=33.4,\n"
        "                                  z_max=133.6))\n"
        "assert s.counts['springs'] > 0\n"
        "bad = [e for e in seen if native_dir in e[1]]\n"
        "assert not bad, bad\n"
        "built = [e for e in seen if e[0] == 'subprocess.Popen'\n"
        "         and 'scene_builder' in e[1]]\n"
        "assert len(built) == 1 and str(native.SRC) in built[0][1], built\n"
        "lib = [e for e in seen if e[0] == 'ctypes.dlopen'\n"
        "       and 'libsphscene' in e[1]]\n"
        f"assert lib and all({str(tmp_path)!r} in e[1] for e in lib), lib\n"
        "mods = [m for m in sys.modules\n"
        "        if m == 'sph_tpu' or m.startswith('sph_tpu.')]\n"
        "assert not mods, mods\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO,
               OMP_NUM_THREADS=str(torch.get_num_threads()))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("fault", ["no_compiler", "broken_source"])
def test_build_faults(fault, tmp_path, monkeypatch):
    """No ``g++``: ``available()`` is False and the generator takes its
    NumPy path. A compiler that fails raises with its output, and the
    generator does not fall back."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    small = dict(x_max=8 * H, y_max=8 * H, z_max=8 * H)
    if fault == "no_compiler":
        monkeypatch.setattr(native.shutil, "which", lambda name: None)
        assert not native.available()
        with pytest.raises(RuntimeError, match="needs g"):
            native.pool_liquid(np.float32(1.0), 10.0, 10.0, 10.0, 0.5)
        ours = generate_liquid_box_scene(SimParams(**small))
        with scene_path(native=False):
            _assert_scene_equal(ours, j_box(JParams(**small)))
        return
    broken = tmp_path / "scene_builder.cpp"
    broken.write_text(native.SRC.read_text() + "\nnot C++;\n")
    monkeypatch.setattr(native, "SRC", broken)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        native.available()
    assert "error" in str(err.value)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        generate_liquid_box_scene(SimParams(**small))
    assert not list((tmp_path / "_build").glob("*.so"))


def test_profile_trace_on_the_cpu(tmp_path):
    a = torch.randn(64, 64)
    with profile_trace(str(tmp_path), device="cpu"):
        (a @ a).sum()
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())[
        "traceEvents"]}
    assert {"aten::mm", "aten::sum"} <= names
