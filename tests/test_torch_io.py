"""The port's host IO against sph_tpu's, on the CPU: the trajectory dumper,
the scene files (``save_scene``, ``load_scene``, ``load_scene_one_file``),
``render_frame``, ``info`` and ``genscene`` of the CLI, and the async
writer. Every writer must produce sph_tpu's bytes for the same arrays (the
port formats whole tables with one ``%`` format, sph_tpu row by row);
every reader sph_tpu's arrays, bitwise.

Scenes: the tiny worm of ``__graft_entry__._tiny_worm`` (14h x 12h x 108h:
springs, muscles and membranes), the 8h box, and seeded random arrays with
the values a formatter can get wrong (negative zero, subnormals, large and
tiny magnitudes)."""
import contextlib
import io as stdio
import json
import os

import numpy as np
import pytest

from sph_tpu.cli import main as j_cli
from sph_tpu.runtime import async_io as j_async
from sph_tpu.scene import io as j_io
from sph_tpu.viz import render as j_render

from sph_tpu_torch.cli import main as cli
from sph_tpu_torch.runtime.async_io import AsyncWriter
from sph_tpu_torch.scene import io
from sph_tpu_torch.viz import render

from test_torch_fastw import port_scene
from torch_scenes import scene_path

H = 3.34
SCENE_FILES = ("position.txt", "velocity.txt", "elasticconnections.txt")


@pytest.fixture(scope="module")
def tiny_worm():
    from __graft_entry__ import _tiny_worm

    jp, js = _tiny_worm()
    return jp, js, port_scene(js)


def _bytes(path):
    with open(path, "rb") as fh:
        return fh.read()


def _same_files(a, b, names):
    for name in names:
        assert _bytes(os.path.join(a, name)) == _bytes(os.path.join(b, name)), \
            name


def _assert_scenes_equal(s, j):
    for f in ("pos", "vel", "color", "normal", "spring_rows", "spring_idx",
              "spring_rest", "spring_type", "tris"):
        a, b = getattr(s, f), getattr(j, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert s.muscle_model == j.muscle_model


def _awkward_positions(n, seed=0):
    """Seeded f32 positions with the values a formatter can get wrong."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-200.0, 200.0, (n, 3)).astype(np.float32)
    special = np.array([-0.0, 0.0, 1e-40, -3.4e38, 1.0000001, 123456789.0,
                        1e-7, 0.1], np.float32)
    pos.ravel()[:len(special)] = special
    return pos


def test_dumper_bytes_equal_sph_tpu(tiny_worm, tmp_path):
    """position_buffer.txt (header and frames), connection_buffer.txt and
    membranes_buffer.txt, byte for byte, for the same frames."""
    _, js, scene = tiny_worm
    jd = j_io.TrajectoryDumper(str(tmp_path / "j"), js)
    d = io.TrajectoryDumper(str(tmp_path / "p"), scene)
    for seed in range(2):
        frame = _awkward_positions(scene.n_particles, seed)
        jd.append(frame)
        d.append(frame)
    _same_files(tmp_path / "j", tmp_path / "p",
                ("position_buffer.txt", "connection_buffer.txt",
                 "membranes_buffer.txt"))
    _, _, frames = io.load_trajectory(str(tmp_path / "p" /
                                          "position_buffer.txt"))
    _, _, jframes = j_io.load_trajectory(str(tmp_path / "j" /
                                              "position_buffer.txt"))
    assert frames.shape == (2, int((scene.ptype != 3).sum()), 4)
    np.testing.assert_array_equal(frames, jframes)


def test_scene_files_round_trip(tiny_worm, tmp_path):
    """save_scene writes sph_tpu's bytes; load_scene reads sph_tpu's
    arrays back from them, bitwise."""
    _, js, scene = tiny_worm
    j_io.save_scene(js, str(tmp_path / "j"))
    io.save_scene(scene, str(tmp_path / "p"))
    _same_files(tmp_path / "j", tmp_path / "p", SCENE_FILES)
    _assert_scenes_equal(io.load_scene(str(tmp_path / "p")),
                         j_io.load_scene(str(tmp_path / "j")))


def test_load_scene_one_file(tiny_worm, tmp_path):
    """The sectioned configuration.txt: the same Scene as sph_tpu's reader,
    springs densified in file order."""
    _, js, _ = tiny_worm
    rows = []
    for r, i in enumerate(js.spring_rows):
        for s in range(js.spring_idx.shape[1]):
            if js.spring_idx[r, s] >= 0:
                rows.append((i, js.spring_idx[r, s] + 0.1,
                             js.spring_rest[r, s], js.spring_type[r, s]))
    vel4 = np.where((js.ptype == 3)[:, None], js.normal, js.vel)
    path = tmp_path / "configuration.txt"
    with open(path, "w") as fh:
        fh.write("Position\n")
        for p, c in zip(js.pos, js.color):
            fh.write(f"{p[0]:.9g}\t{p[1]:.9g}\t{p[2]:.9g}\t{c:.6g}\n")
        fh.write("Velocity\n")
        for v, c in zip(vel4, js.color):
            fh.write(f"{v[0]:.9g}\t{v[1]:.9g}\t{v[2]:.9g}\t{c:.6g}\n")
        fh.write(f"ElasticConnection\n{len(rows)}\n")
        for r in rows:
            fh.write("\t".join(f"{x:.9g}" for x in r) + "\n")
    s = io.load_scene_one_file(str(path))
    _assert_scenes_equal(s, j_io.load_scene_one_file(str(path)))
    assert len(s.spring_rows) == len(js.spring_rows)
    np.testing.assert_array_equal(s.spring_idx, js.spring_idx)


def test_render_frame_bytes_equal_sph_tpu(tiny_worm, tmp_path):
    """The same PNG bytes as sph_tpu's render_frame, with every overlay
    (springs, membranes, HUD) and density colouring."""
    jp, js, scene = tiny_worm
    rng = np.random.default_rng(0)
    rho = rng.uniform(960.0, 1040.0, scene.n_particles).astype(np.float32)
    act = np.zeros(96, np.float32)
    act[:3] = (1.0, 0.5, 0.05)
    kw = dict(rho=rho, springs=(js.spring_rows, js.spring_idx,
                                js.spring_type),
              tris=js.tris, activation=act, hud=True, counts=js.counts,
              step=7, time_step=jp.time_step, title="t")
    a = render.render_frame(scene.pos, scene.ptype, str(tmp_path / "p.png"),
                            **kw)
    b = j_render.render_frame(js.pos, js.ptype, str(tmp_path / "j.png"),
                              **kw)
    assert os.path.getsize(a) > 10_000
    assert _bytes(a) == _bytes(b)


def _stdout_of(main, argv):
    buf = stdio.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


@pytest.mark.parametrize("scene", ["box", "worm"])
def test_cli_info_and_genscene_equal_sph_tpu(scene, tmp_path):
    """``info`` prints sph_tpu's JSON; ``genscene`` writes its files byte
    for byte (the 8h box and the tiny worm's box), both packages on their
    NumPy path."""
    box = "8,8,8" if scene == "box" else "14,12,108"
    args = ["--scene", scene, "--box", box]
    with scene_path(native=False):
        assert json.loads(_stdout_of(cli, ["info"] + args)) == json.loads(
            _stdout_of(j_cli, ["info"] + args))
        _stdout_of(cli, ["genscene"] + args + ["--out", str(tmp_path / "p")])
        _stdout_of(j_cli, ["genscene"] + args + ["--out", str(tmp_path / "j")])
    names = [n for n in SCENE_FILES if os.path.exists(tmp_path / "j" / n)]
    assert len(names) == (3 if scene == "worm" else 2)
    assert sorted(os.listdir(tmp_path / "p")) == sorted(names)
    _same_files(tmp_path / "j", tmp_path / "p", names)
    # and a config directory is a scene for both CLIs
    cfg = ["--scene", str(tmp_path / "p")]
    assert json.loads(_stdout_of(cli, ["info"] + cfg)) == json.loads(
        _stdout_of(j_cli, ["info"] + cfg))


def test_async_io_error_is_raised():
    """A worker-thread IO failure surfaces on flush, not silently, and the
    writer recovers (sph_tpu's test_async_io_error_is_raised)."""
    w = AsyncWriter()

    def boom(_):
        raise OSError("disk full")

    w.submit(boom, np.zeros(3))
    with pytest.raises(RuntimeError, match="async IO"):
        w.flush()
    seen = []
    w.submit(seen.append, np.arange(4.0))
    w.flush()
    assert len(seen) == 1 and seen[0].shape == (4,)
    w.close()
    with pytest.raises(RuntimeError, match="closed"):
        w.submit(seen.append, np.arange(4.0))


def test_async_writer_hands_over_tensors():
    """Tensors, in the arguments and in dataclass fields, reach the writer
    as NumPy arrays copied at submit: an in-place write after submit does
    not reach the pending write. ``save_npz_atomic`` writes sph_tpu's npz."""
    import dataclasses

    import torch

    from sph_tpu_torch.core.state import Membranes

    t = torch.arange(6, dtype=torch.float32)
    m = Membranes(tris=torch.ones((2, 3), dtype=torch.int32),
                  particle_tris=torch.zeros((4, 7), dtype=torch.int32))
    seen = []
    w = AsyncWriter()
    release = __import__("threading").Event()
    w.submit(lambda: release.wait(10))     # holds the worker
    w.submit(lambda a, mem=None: seen.append((a, mem)), t, mem=m)
    t.add_(100.0)
    m.tris.add_(5)
    release.set()
    w.flush()
    w.close()
    a, mem = seen[0]
    assert isinstance(a, np.ndarray) and isinstance(mem.tris, np.ndarray)
    np.testing.assert_array_equal(a, np.arange(6, dtype=np.float32))
    np.testing.assert_array_equal(mem.tris, np.ones((2, 3), np.int32))
    assert dataclasses.is_dataclass(mem)


def test_save_npz_atomic_equals_sph_tpu(tmp_path):
    arrays = dict(a=_awkward_positions(5), b=np.arange(3, dtype=np.int32))
    io_p, io_j = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    from sph_tpu_torch.runtime.async_io import save_npz_atomic

    save_npz_atomic(io_p, **arrays)
    j_async.save_npz_atomic(io_j, **arrays)
    zp, zj = np.load(io_p), np.load(io_j)
    assert sorted(zp.files) == sorted(zj.files) == ["a", "b"]
    for k in zp.files:
        assert zp[k].dtype == zj[k].dtype
        np.testing.assert_array_equal(zp[k], zj[k])
    assert not os.path.exists(io_p + ".tmp.npz")
