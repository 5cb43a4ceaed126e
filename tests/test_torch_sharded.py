"""The port's parallel package beside its halo engine: the all-gather
sharded step (``sph_tpu_torch.parallel.sharded``) on gloo CPU ranks against
the port's exact engine, with ``tests/test_sharded.py``'s tolerances (1e-6
on the box, 2e-5 on the worm); the scene padding and the measured halo and
migration pads against sph_tpu's (bitwise, equal integers); the four
collectives of ``Comm``; the scatters that drop out-of-range indices and
the resort-time check of the tables' tile offsets; the halo engine in a
world of one through ``Simulator`` (against
``engine="fast"``, sph_tpu's halo tolerance 2e-5) and through the CLI, in a
world of one and on 2 ranks joined from torchrun's environment."""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from sph_tpu.config import SimParams as JParams
from sph_tpu.core import fast as JF
from sph_tpu.parallel import measure_halo_pad as j_measure_halo_pad
from sph_tpu.parallel import measure_migration_pad as j_measure_mig_pad
from sph_tpu.parallel import pad_scene_to_devices as j_pad
from sph_tpu.scene import generate_liquid_box_scene as j_box
from sph_tpu.scene import generate_worm_scene as j_worm

from sph_tpu_torch.config import SimParams
from sph_tpu_torch.convert import params_from
from sph_tpu_torch.core import fast as F
from sph_tpu_torch.core.step import multi_step
from sph_tpu_torch.ops import pair_kernels as pk
from sph_tpu_torch.ops.pair_kernels import ALIGN
from sph_tpu_torch.parallel import (make_halo_fast_multi_step,
                                    measure_halo_pad, measure_migration_pad,
                                    pad_scene_to_devices)
from sph_tpu_torch.parallel.comm import Comm
from sph_tpu_torch.parallel.dryrun import sharded_rank
from sph_tpu_torch.parallel.halo import _scatter, _scatter_add
from sph_tpu_torch.parallel.launch import run_ranks
from sph_tpu_torch.runtime import Simulator
from sph_tpu_torch.scene import generate_liquid_box_scene

import torch_ranks
from test_torch_fastw import port_scene
from torch_scenes import scene_path

H = 3.34
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARDED = {"box": (dict(x_max=8 * H, y_max=8 * H, z_max=8 * H), 4, 5, 1e-6),
           "worm": (dict(x_max=20 * H, y_max=12 * H, z_max=110 * H), 2, 2,
                    2e-5)}


def jax_scene(name, jp):
    if name == "box":
        return j_box(jp, fill_fraction=0.5)
    with scene_path(native=False):
        return j_worm(jp)


@pytest.mark.parametrize("name", ["box", "worm"])
def test_sharded_matches_exact(name):
    """The all-gather step on 4 (box) or 2 (worm) ranks against the exact
    engine on one device; the worm's full physics (springs, muscles,
    membranes) included."""
    box, world, steps, tol = SHARDED[name]
    jp = JParams(**box)
    params = params_from(jp)
    scene = pad_scene_to_devices(port_scene(jax_scene(name, jp)), world)
    assert scene.n_particles % world == 0
    out = run_ranks(sharded_rank, world, "gloo", "cpu", scene, params,
                    steps)[0]
    state, springs, membranes = scene.device_state("cpu")
    ref = multi_step(state, springs, membranes, params, scene.layout(),
                     steps)
    np.testing.assert_allclose(out["pos"], ref.pos.numpy(), rtol=0,
                               atol=tol)
    np.testing.assert_allclose(out["vel"], ref.vel.numpy(), rtol=0,
                               atol=tol)
    assert np.abs(ref.pos.numpy() - scene.pos).max() > 100 * tol


def test_pad_scene_bitwise_sph_tpus():
    """``pad_scene_to_devices``: the same padding rows and corner normal as
    sph_tpu's, bitwise, and no padding where the count divides."""
    jp = JParams(x_max=8 * H, y_max=8 * H, z_max=8 * H)
    js = j_box(jp, fill_fraction=0.5)
    for n in (1, 3, 8, 256, 4 * 128, 1000):
        ours = pad_scene_to_devices(port_scene(js), n)
        theirs = j_pad(js, n)
        assert ours.n_particles % n == 0
        for f in ("pos", "vel", "color", "normal", "spring_rows",
                  "spring_idx", "tris"):
            a, b = getattr(ours, f), getattr(theirs, f)
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b)
    scene = port_scene(js)
    assert pad_scene_to_devices(scene, 1) is scene


def test_measured_pads_equal_sph_tpus():
    """The scene-measured halo band covers the densest two z-rows plus
    ccol, ALIGN-rounded, and both measured pads equal sph_tpu's."""
    jp = JParams()
    params = params_from(jp)
    rng = np.random.default_rng(3)
    pos = rng.uniform(
        [params.x_min, params.y_min, params.z_min],
        [params.x_max, params.y_max, params.z_max],
        (4096, 3)).astype(np.float32)
    cfg = F.compute_fast_config(pos, params)
    jcfg = JF.compute_fast_config(pos, jp, interpret=True)
    pad = measure_halo_pad(pos, params, cfg)
    assert pad % ALIGN == 0
    nz = cfg.dims[2]
    zrow = np.clip((pos[:, 2] - params.z_min) / params.h, 0,
                   nz - 1).astype(int)
    counts = np.bincount(zrow, minlength=nz)
    assert pad >= int((counts[:-1] + counts[1:]).max()) + cfg.ccol
    for margin in (1.0, 1.5, 3.0):
        assert measure_halo_pad(pos, params, cfg, margin) == \
            j_measure_halo_pad(pos, jp, jcfg, margin)
        assert measure_migration_pad(pos, params, cfg, margin) == \
            j_measure_mig_pad(pos, jp, jcfg, margin)


def test_comm_collectives():
    """The four operations on 3 gloo ranks (the chain's ends receive the
    fill) and in a world of one (no process group: all local)."""
    res = run_ranks(torch_ranks.comm_ops, 3, "gloo", "cpu")
    a = [np.arange(3, dtype=np.float32) + 10 * r for r in range(3)]
    for r, out in enumerate(res):
        assert out["rank"] == r and out["world"] == 3
        np.testing.assert_array_equal(out["gather"], np.stack(a))
        np.testing.assert_array_equal(out["gather_int"], [0, 1, 2])
        np.testing.assert_array_equal(out["psum"], a[0] + a[1] + a[2])
        np.testing.assert_array_equal(
            out["next"], a[r - 1] if r > 0 else [-1.0] * 3)
        np.testing.assert_array_equal(
            out["prev"], a[r + 1] if r < 2 else [-2.0, -3.0, -4.0])
        assert float(out["pmax"]) == 2.0
    one = Comm("cpu")
    assert (one.rank, one.world) == (0, 1)
    x = torch.arange(4.0)
    assert one.all_gather(x) is x and one.psum(x) is x
    np.testing.assert_array_equal(one.send_next(x, 7.0).numpy(), [7.0] * 4)
    np.testing.assert_array_equal(one.send_prev(x, -1.0).numpy(),
                                  [-1.0] * 4)
    with pytest.raises(ValueError, match="distinct card"):
        run_ranks(torch_ranks.comm_ops, 2, "nccl", "cuda:0")


def test_halo_guards(monkeypatch):
    """The halo engine's scatters drop an index outside the array (sph_tpu's
    ``mode="drop"``) where a bare torch index raises on the CPU (and
    asserts on the card); its window tables' tile offsets are checked for
    the ring kernels once a resort, where they are built, and an unaligned
    offset raises."""
    idx = torch.tensor([2, -1, 5, 0, 4])
    val = torch.tensor([1.0, 2.0, 3.0, 4.0, 5.0])
    with pytest.raises(IndexError):
        torch.zeros(4)[idx] = val
    np.testing.assert_array_equal(_scatter(4, -9.0, idx, val).numpy(),
                                  [4.0, -9.0, 1.0, -9.0])
    np.testing.assert_array_equal(
        _scatter(4, -1, idx, idx).numpy(), [0, -1, 2, -1])
    np.testing.assert_array_equal(
        _scatter_add(4, torch.tensor([1, 1, 9, -3]),
                     torch.tensor([1.0, 2.0, 4.0, 8.0])).numpy(),
        [0.0, 3.0, 0.0, 0.0])
    two = _scatter_add(3, torch.tensor([0, 3, 2]),
                       torch.tensor([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]]))
    np.testing.assert_array_equal(two.numpy(), [[1.0, 0.0, 3.0],
                                                [4.0, 0.0, 6.0]])

    with pytest.raises(ValueError, match="multiple of 4"):
        pk.check_tile_offsets(torch.tensor([0, 128, 130], dtype=torch.int32),
                              "test")
    with pytest.raises(ValueError, match="negative"):
        pk.check_tile_offsets(torch.tensor([-4], dtype=torch.int32), "test")
    checked = []
    real = pk.check_tile_offsets
    monkeypatch.setattr(pk, "check_tile_offsets",
                        lambda aln, label: checked.append(label)
                        or real(aln, label))
    params = SimParams(x_max=6 * H, y_max=6 * H, z_max=24 * H)
    scene = pad_scene_to_devices(port_scene(j_box(JParams(
        x_max=6 * H, y_max=6 * H, z_max=24 * H), fill_fraction=0.5)), 128)
    cfg = F.compute_fast_config(scene.pos, params, block=128,
                                resort_every=2)
    state, springs, membranes = scene.device_state("cpu")
    for distributed in (False, True):
        checked.clear()
        make_halo_fast_multi_step(Comm("cpu"), params, scene.layout(), cfg, 5,
                                  distributed_resort=distributed)(
            state, springs, membranes)
        assert checked == ["halo window tables"] * 3     # 3 resorts


def test_simulator_halo_world_of_one(tmp_path):
    """``Simulator(engine="halo")`` in a plain process (a world of one),
    with either resort: the scene padded to the rank grid, 7 steps across
    resorts against ``engine="fast"`` on the padded scene within sph_tpu's
    2e-5, the overflow counts through ``check_overflow``, and a checkpoint
    round trip."""
    params = SimParams(x_max=6 * H, y_max=6 * H, z_max=60 * H)
    scene = port_scene(j_box(JParams(x_max=6 * H, y_max=6 * H,
                                     z_max=60 * H), fill_fraction=0.5))
    fck = dict(resort_every=3)
    for distributed in (False, True):
        _simulator_halo(scene, params, fck, distributed, tmp_path)


def _simulator_halo(scene, params, fck, distributed, tmp_path):
    sim = Simulator(scene, params, engine="halo", device="cpu",
                    fast_config=fck, distributed_resort=distributed)
    assert sim.engine == "halo" and sim.scene.n_particles % 256 == 0
    assert sim.scene.n_particles > scene.n_particles
    sim.step(7)
    ref = Simulator(sim.scene, params, engine="fast", device="cpu",
                    fast_config=fck)
    ref.step(7)
    assert sim.step_count == 7
    np.testing.assert_allclose(sim.get_position(), ref.get_position(),
                               rtol=0, atol=2e-5)
    assert np.abs(sim.get_position() - sim.scene.pos).max() > 1e-3
    out = sim.check_overflow()
    assert out["halo_overflow"] == 0 and out["tile_overflow"] == 0
    assert ("resort_overflow" in out) == distributed
    path = str(tmp_path / "ck.npz")
    sim.save(path)
    sim.step(2)
    again = Simulator(scene, params, engine="halo", device="cpu",
                      fast_config=fck, distributed_resort=distributed)
    again.restore(path)
    assert again.step_count == 7
    again.step(2)
    np.testing.assert_array_equal(again.get_position(), sim.get_position())


@pytest.mark.parametrize("world", [1, 2])
def test_cli_run_halo(tmp_path, world):
    """``python -m sph_tpu_torch run --engine halo --device cpu`` steps and
    reports, in a world of one and as 2 ranks joined from torchrun's
    environment (RANK, WORLD_SIZE, MASTER_ADDR/PORT), each rank in a
    directory of its own: only rank 0 prints and writes the checkpoint,
    which holds every rank's rows after 4 steps."""
    # the subprocesses keep to this worker's share of the cores
    threads = max(1, torch.get_num_threads() // world)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS=str(threads))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = []
    for rank in range(world):
        cwd = tmp_path / f"rank{rank}"
        cwd.mkdir()
        rank_env = env if world == 1 else dict(
            env, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
            MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "sph_tpu_torch", "run", "--scene", "box",
             "--box", "6,6,40", "--fill", "0.5", "--steps", "4",
             "--report-every", "2", "--engine", "halo", "--device", "cpu",
             "--checkpoint", "ck.npz"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=str(cwd), env=rank_env))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300))
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err
    assert "engine: halo" in outs[0][0]
    assert "[[ step 4 ]]" in outs[0][0]
    ck = np.load(tmp_path / "rank0" / "ck.npz")
    scene = generate_liquid_box_scene(
        SimParams(x_max=6 * H, y_max=6 * H, z_max=40 * H),
        fill_fraction=0.5)
    assert int(ck["step"]) == 4 and np.isfinite(ck["pos"]).all()
    assert len(ck["pos"]) >= scene.n_particles and len(ck["pos"]) % world == 0
    np.testing.assert_array_equal(ck["ptype"][:scene.n_particles],
                                  scene.ptype)
    for rank in range(1, world):
        assert outs[rank][0] == ""
        assert list((tmp_path / f"rank{rank}").iterdir()) == []
