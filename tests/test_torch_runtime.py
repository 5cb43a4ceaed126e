"""The port's simulator facade against sph_tpu's, on the CPU: checkpoints
that load in either package, save/restore continuing bitwise and the three
ways ``restore`` treats a checkpoint, the adaptive resort ladder's choices,
trajectory dumps (async against sync, and against sph_tpu's Simulator),
the fastw engine's in-graph wall path (``wall_static=None``), the spring
and membrane getters, and the CLI's run/restore/replay.

sph_tpu's fastw and fast engines run as its own tests run them, in Pallas
interpret mode; each distinct period length costs a compile of ~20-45 s
there, so one sph_tpu fastw Simulator (resort period 4, with dumps and the
ladder) serves the checkpoint, ladder and dump comparisons in turn, and one
fast Simulator the fast engine's ladder. Scenes: the kicked 8h box of
``tests/test_torch_fastw.py`` (its liquid hits the floor walls), its spring
chain, and the tiny worm of ``__graft_entry__._tiny_worm`` (springs and
membranes). Tolerances: ``ATOL`` of ``tests/test_torch_fastw.py`` between
the packages (velocities 10x), bitwise within the port, the drift bounds
within 1e-4 relative, the two wall paths within 1e-5 as
``tests/test_fastw_engine.py`` holds them."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from sph_tpu.config import SimParams as JParams
from sph_tpu.core import fastw as JW
from sph_tpu.runtime import Simulator as JSim
from sph_tpu.runtime import checkpoint as j_ckpt
from sph_tpu.scene import generate_liquid_box_scene as j_box
from sph_tpu.scene import io as j_io

from sph_tpu_torch.cli import main as cli
from sph_tpu_torch.convert import params_from
from sph_tpu_torch.core import fastw as W
from sph_tpu_torch.core import graphed
from sph_tpu_torch.ops import pair_kernels as pk
from sph_tpu_torch.runtime import Simulator
from sph_tpu_torch.runtime import checkpoint as ckpt
from sph_tpu_torch.scene import io

from test_torch_fastw import ATOL, BOX, KICK, port_scene, spring_chain_scene
from test_torch_pair_kernels import kick_box_scene

RESORT = 4       # ladder levels 4, 2, 1


def kicked_box():
    """(sph_tpu params, sph_tpu scene, port params, port scene)."""
    jp = JParams(**BOX)
    js = kick_box_scene(j_box(jp, fill_fraction=0.5), jp, **KICK)
    return jp, js, params_from(jp), port_scene(js)


def chunks(sim, k, h):
    """k chunks of ``sim`` (either package), each one period of its current
    length: [(the next period, the chunk's drift bound in h)]."""
    out = []
    for _ in range(k):
        sim.step(sim._fast_chunk)
        out.append((sim._fast_chunk,
                    2.0 * float(np.asarray(sim._last_drift)) / h))
    return out


def state_of(sim):
    return sim.get_position(), sim.get_velocity()


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """One sph_tpu fastw Simulator (adaptive, period 4, dumps every 4
    steps, sync writes) driven through: three chunks at threshold 10 (its
    step-4 checkpoint saved, its trajectory read at step 8); from step 0
    again three chunks at threshold 1e-3; 4 steps from the port's step-4
    checkpoint. And the fast engine's ladder the same way. The packages
    part by ~1.5e-5 a period on this box, so what is held to ATOL spans at
    most 8 steps from a common state."""
    d = tmp_path_factory.mktemp("runtime")
    jp, js, params, scene = kicked_box()
    out = dict(dir=d, params=params, scene=scene)
    jsim = JSim(js, jp, engine="fastw", adaptive_resort=True,
                drift_threshold_h=10.0,
                fast_config=dict(resort_every=RESORT),
                dump_dir=str(d / "jdump"), dump_interval=RESORT,
                async_io=False)
    ck0 = str(d / "ck0.npz")
    jsim.save(ck0)
    out["fastw_10"] = chunks(jsim, 1, jp.h)
    out["ck_j"] = str(d / "ck_j.npz")
    jsim.save(out["ck_j"])
    out["fastw_10"] += chunks(jsim, 1, jp.h)
    out["jax_8"] = state_of(jsim)
    out["frames_j"] = j_io.load_trajectory(str(d / "jdump" /
                                               "position_buffer.txt"))[2]
    out["fastw_10"] += chunks(jsim, 1, jp.h)
    jsim.restore(ck0)
    jsim._drift_threshold_h = 1e-3
    out["fastw_1e-3"] = chunks(jsim, 3, jp.h)

    # the port: 8 steps with dumps, its step-4 checkpoint for sph_tpu
    psim = Simulator(scene, params, device="cpu",
                     fast_config=dict(resort_every=RESORT),
                     dump_dir=str(d / "pdump"), dump_interval=RESORT,
                     async_io=False)
    psim.step(RESORT)
    out["ck_p"] = str(d / "ck_p.npz")
    psim.save(out["ck_p"])
    out["port_4"] = state_of(psim)
    psim.step(RESORT)
    out["port_8"] = state_of(psim)
    out["frames_p"] = io.load_trajectory(str(d / "pdump" /
                                             "position_buffer.txt"))

    jsim.restore(out["ck_p"])
    jsim._drift_threshold_h = 10.0
    jsim._fast_chunk = RESORT
    jsim.step(RESORT)
    out["jax_from_port"] = state_of(jsim)

    fsim = JSim(js, jp, engine="fast", adaptive_resort=True,
                drift_threshold_h=10.0,
                fast_config=dict(resort_every=RESORT), async_io=False)
    out["fast_10"] = chunks(fsim, 3, jp.h)
    fsim.restore(ck0)
    fsim._drift_threshold_h = 1e-3
    out["fast_1e-3"] = chunks(fsim, 3, jp.h)
    return out


def test_checkpoint_keys_and_dtypes_equal_sph_tpu(tmp_path):
    """A checkpoint of the tiny worm (springs, muscles, membranes) written
    by either package loads in the other with every array bitwise equal;
    both write the same keys and dtypes (the port's ``KEYS`` is
    sph_tpu's list)."""
    from __graft_entry__ import _tiny_worm

    jp, js = _tiny_worm()
    scene = port_scene(js)
    rng = np.random.default_rng(0)
    jstate, jspr, jmem = js.device_state()
    jstate = dataclasses.replace(
        jstate, muscle_activation=rng.uniform(0, 1, 100).astype(np.float32),
        step=np.int32(7))
    j_ckpt.save_checkpoint(str(tmp_path / "j.npz"), jstate, jspr, jmem,
                           color=js.color)
    state, spr, mem = scene.device_state("cpu")
    state.muscle_activation = torch.as_tensor(jstate.muscle_activation)
    state.step = torch.tensor(7, dtype=torch.int32)
    ckpt.save_checkpoint(str(tmp_path / "p.npz"), state, spr, mem,
                         color=scene.color)
    zj, zp = np.load(tmp_path / "j.npz"), np.load(tmp_path / "p.npz")
    assert sorted(zj.files) == sorted(zp.files) == sorted(
        ckpt.KEYS + ("color",))
    for k in zj.files:
        assert zj[k].dtype == zp[k].dtype and zj[k].shape == zp[k].shape, k
        np.testing.assert_array_equal(zj[k], zp[k], err_msg=k)
    # sph_tpu's checkpoint in the port, the port's in sph_tpu
    pst, pspr, pmem, pcol = ckpt.load_checkpoint(str(tmp_path / "j.npz"),
                                                 "cpu")
    jst, jspr2, jmem2, jcol = j_ckpt.load_checkpoint(str(tmp_path / "p.npz"))
    for a, b in ((pst, jst), (pspr, jspr2), (pmem, jmem2)):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), np.asarray(getattr(b, f.name))
            assert x.numpy().dtype == y.dtype, f.name
            np.testing.assert_array_equal(x.numpy(), y, err_msg=f.name)
    np.testing.assert_array_equal(pcol, jcol)
    assert int(pst.step) == 7


def test_checkpoints_cross_load_and_step_alike(jax_runs):
    """sph_tpu's step-4 checkpoint restored in the port and the port's in
    sph_tpu: arrays bitwise equal after the load, and 4 more steps of each
    package from either checkpoint within ATOL of the other package's
    uninterrupted run."""
    r = jax_runs
    z = np.load(r["ck_j"])
    sim = Simulator(r["scene"], r["params"], device="cpu",
                    fast_config=dict(resort_every=RESORT))
    sim.restore(r["ck_j"])
    for f in ("pos", "vel", "muscle_activation", "step"):
        np.testing.assert_array_equal(getattr(sim.state, f).numpy(), z[f])
    assert sim.step_count == RESORT
    sim.step(RESORT)
    jst = j_ckpt.load_checkpoint(r["ck_p"])[0]
    for a, b in zip((jst.pos, jst.vel), r["port_4"]):
        np.testing.assert_array_equal(np.asarray(a), b)
    for (pos, vel), (jpos, jvel) in ((state_of(sim), r["jax_8"]),
                                     (r["port_8"], r["jax_from_port"])):
        np.testing.assert_allclose(pos, jpos, rtol=0, atol=ATOL)
        np.testing.assert_allclose(vel, jvel, rtol=0, atol=ATOL * 10)
        assert np.abs(jpos - z["pos"]).max() > 1e-4


@pytest.mark.parametrize("engine", ["fastw", "fast"])
def test_adaptive_ladder_matches_sph_tpu(jax_runs, engine):
    """sph_tpu's test_adaptive_resort_moves_down_the_ladder on both
    engines: over three chunks the period stays at 4 at threshold 10 and
    steps down 4 -> 2 -> 1 at 1e-3; the port makes the same choices and
    each chunk's drift bound agrees within 1e-4 relative."""
    r = jax_runs
    for thr in (10.0, 1e-3):
        sim = Simulator(r["scene"], r["params"], engine=engine, device="cpu",
                        adaptive_resort=True, drift_threshold_h=thr,
                        fast_config=dict(resort_every=RESORT))
        assert sim._chunk_levels == [4, 2, 1]
        got = chunks(sim, 3, r["params"].h)
        want = r[f"{engine}_{'10' if thr == 10.0 else '1e-3'}"]
        assert [c for c, _ in got] == [c for c, _ in want]
        np.testing.assert_allclose([d for _, d in got],
                                   [d for _, d in want], rtol=1e-4)
        assert sim.step_count == sum(c for c, _ in [(RESORT, 0)] + got[:-1])
    assert [c for c, _ in r[f"{engine}_10"]] == [4, 4, 4]
    assert [c for c, _ in r[f"{engine}_1e-3"]] == [2, 1, 1]


def test_dumped_frames_match_sph_tpu(jax_runs):
    """The port's trajectory of 8 steps (frames at 0, 4, 8) against
    sph_tpu's Simulator with the same interval, within ATOL."""
    n_e, n_l, frames = jax_runs["frames_p"]
    jframes = jax_runs["frames_j"]
    assert frames.shape == jframes.shape == (3, n_e + n_l, 4)
    np.testing.assert_allclose(frames, jframes, rtol=0, atol=ATOL)
    assert np.abs(frames[-1] - frames[0]).max() > 1e-4


def test_async_dump_equals_sync(tmp_path):
    """The async writer's trajectory is byte-identical to the synchronous
    one (an interval below the resort period: single-step periods, as in
    sph_tpu), and an async checkpoint restores bitwise."""
    _, _, params, scene = kicked_box()
    sims = [Simulator(scene, params, device="cpu", dump_dir=str(tmp_path / k),
                      dump_interval=3, async_io=k == "a",
                      fast_config=dict(resort_every=RESORT))
            for k in "as"]
    for sim in sims:
        sim.step(6)
    sims[0].save(str(tmp_path / "ck.npz"), wait=False)
    sims[0].flush()
    a, s = (open(tmp_path / k / "position_buffer.txt", "rb").read()
            for k in "as")
    assert a == s and len(io.load_trajectory(
        str(tmp_path / "a" / "position_buffer.txt"))[2]) == 3
    c = Simulator(scene, params, device="cpu", async_io=False,
                  fast_config=dict(resort_every=RESORT))
    c.restore(str(tmp_path / "ck.npz"))
    assert c.step_count == 6
    np.testing.assert_array_equal(c.get_position(), sims[1].get_position())


@pytest.mark.parametrize("engine", ["exact", "fastw", "fast"])
def test_restore_continues_bitwise(engine, tmp_path):
    """sph_tpu's test_checkpoint_resume_exact: a run restored from step 3
    continues bitwise with the one that was not interrupted."""
    _, _, params, scene = kicked_box()
    kw = dict(engine=engine, device="cpu", fast_config=None
              if engine == "exact" else dict(resort_every=2))
    sim = Simulator(scene, params, **kw)
    sim.step(3)
    sim.save(str(tmp_path / "s.npz"))
    sim2 = Simulator(scene, params, **kw)
    sim2.restore(str(tmp_path / "s.npz"))
    assert sim2.step_count == 3
    sim.step(3)
    sim2.step(3)
    for a, b in zip(state_of(sim), state_of(sim2)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(sim.get_muscle_activation(),
                                  sim2.get_muscle_activation())


def _edited(path, out, **arrays):
    z = dict(np.load(path))
    for k, fn in arrays.items():
        z[k] = fn(z[k].copy())
    np.savez(out, **z)
    return out


def test_restore_refuses_other_walls(tmp_path):
    """Branch (a): a checkpoint whose walls moved, whose types differ, or
    whose particle count differs raises ValueError naming what differs,
    and leaves the Simulator as it was."""
    _, _, params, scene = kicked_box()
    sim = Simulator(scene, params, device="cpu")
    sim.save(str(tmp_path / "s.npz"))
    b0, b1 = sim.layout.boundary_range
    assert b1 > b0

    def moved(pos):
        pos[b0 + 5, 1] += 0.5
        return pos

    def retyped(pt):
        pt[b0] = 1
        return pt

    before = sim.get_position()
    for name, edit, what in (("walls", dict(pos=moved), "wall positions"),
                             ("types", dict(ptype=retyped), "ptype"),
                             ("normals", dict(normal=lambda a: -a), "normal"),
                             ("count", dict(pos=lambda a: a[:-1]),
                              "particles")):
        bad = _edited(str(tmp_path / "s.npz"), str(tmp_path / f"{name}.npz"),
                      **edit)
        with pytest.raises(ValueError, match=what):
            sim.restore(bad)
        np.testing.assert_array_equal(sim.get_position(), before)


def test_restore_keeps_or_rebuilds_the_runners(tmp_path):
    """Branch (c): the same scene keeps the Simulator's reference tensors
    and runners, so a period graph staged before the restore accepts the
    restored state. Branch (b): changed springs replace them, the runners
    are built anew (the old graph would refuse the new springs), and the
    run continues bitwise as a Simulator built with those springs."""
    jp = JParams(**BOX)
    params, scene = params_from(jp), port_scene(spring_chain_scene(jp))
    kw = dict(device="cpu", engine="fastw",
              fast_config=dict(resort_every=2))
    sim = Simulator(scene, params, **kw)
    sim.step(2)
    sim.save(str(tmp_path / "s.npz"))
    refs = (sim.state.ptype, sim.state.normal, sim.springs, sim.membranes)
    runners = dict(sim._fast_runs)
    parts = W._make_step_parts_w(params, sim.layout, sim._fast_cfg,
                                 wall_static=sim._wall_static)
    g = graphed.PeriodGraph(parts, 2)
    g._stage(sim.state, sim.springs, sim.membranes)
    sim.step(2)
    sim.restore(str(tmp_path / "s.npz"))                     # (c)
    assert (sim.state.ptype, sim.state.normal, sim.springs,
            sim.membranes) == refs
    assert sim._fast_runs == runners and sim.step_count == 2
    g._stage(sim.state, sim.springs, sim.membranes)

    longer = _edited(str(tmp_path / "s.npz"), str(tmp_path / "b.npz"),
                     spring_rest=lambda r: r * np.float32(1.25))
    sim.restore(longer)                                      # (b)
    assert sim.springs is not refs[2]
    assert all(sim._fast_runs[k] is not runners[k] for k in sim._fast_runs)
    with pytest.raises(ValueError, match="springs.rest"):
        g._stage(sim.state, sim.springs, sim.membranes)
    scene_b = dataclasses.replace(scene,
                                  spring_rest=scene.spring_rest * 1.25)
    ref = Simulator(scene_b, params, **kw)
    ref.restore(longer)
    assert ref._fast_runs.keys() == sim._fast_runs.keys()
    sim.step(4)
    ref.step(4)
    for a, b in zip(state_of(sim), state_of(ref)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(sim.get_elastic_connections()[1],
                                  scene_b.spring_rest)


def test_refused_restore_leaves_the_simulator_as_it_was(tmp_path):
    """A checkpoint whose springs anchor to a wall, which fastw refuses:
    ``restore`` raises, the Simulator's state, springs, membranes, layout
    and runners are the same objects as before, and two more steps equal
    bitwise those of a Simulator that never tried the restore. The scene:
    the kicked 8h box (walls), its first 8 rows an elastic chain."""
    _, _, params, scene = kicked_box()
    ne = 8
    scene.color[:ne] = 2.2
    idx = np.full((ne, scene.spring_idx.shape[1]), -1, np.int32)
    rest = np.zeros(idx.shape, np.float32)
    for a in range(ne - 1):
        idx[a, 0], idx[a + 1, 1] = a + 1, a
        rest[a, 0] = rest[a + 1, 1] = np.linalg.norm(
            scene.pos[a] - scene.pos[a + 1]) * params.simulation_scale
    scene = dataclasses.replace(
        scene, spring_rows=np.arange(ne, dtype=np.int32), spring_idx=idx,
        spring_rest=rest, spring_type=np.zeros(idx.shape, np.float32))
    kw = dict(device="cpu", engine="fastw", fast_config=dict(resort_every=2))
    sim, ref = Simulator(scene, params, **kw), Simulator(scene, params, **kw)
    assert sim.layout.springs_elastic_only
    sim.step(2)
    ref.step(2)
    sim.save(str(tmp_path / "s.npz"))
    b0 = sim.layout.boundary_range[0]

    def to_wall(a):
        a[0, 2] = b0
        return a

    bad = _edited(str(tmp_path / "s.npz"), str(tmp_path / "wall.npz"),
                  spring_idx=to_wall)
    before = (sim.state, sim.springs, sim.membranes, sim.layout,
              sim._fast_runs)
    runners = dict(sim._fast_runs)
    with pytest.raises(ValueError, match="elastic-only spring anchors"):
        sim.restore(bad)
    after = (sim.state, sim.springs, sim.membranes, sim.layout,
             sim._fast_runs)
    assert all(a is b for a, b in zip(after, before))
    assert sim._fast_runs == runners
    sim.step(2)
    ref.step(2)
    assert sim.step_count == 4
    for a, b in zip(state_of(sim), state_of(ref)):
        np.testing.assert_array_equal(a, b)


def test_in_graph_wall_path(monkeypatch):
    """``wall_static=None`` sorts the walls in the resort and sums their
    mutual density with ``raw_sw``: 4 steps (two periods) within ATOL of
    sph_tpu's in-graph path and within 1e-5 of the port's hoisted path, the
    stepper bitwise the multi-step runner; the ``raw_sw`` inputs meet the
    ring kernel's precondition; ``tile_overflow`` counts the shell x wall
    tables too."""
    jp, js, params, scene = kicked_box()
    jl = js.layout()
    jcfg = JW.compute_fastw_config(js.pos, jp, jl, ptype=js.ptype,
                                   resort_every=2)
    jout = JW.make_fastw_multi_step(jp, jl, jcfg, 4)(*js.device_state())
    layout = scene.layout()
    cfg = W.compute_fastw_config(scene.pos, params, layout,
                                 ptype=scene.ptype, resort_every=2)
    ws = W.precompute_wall_static(scene.pos, scene.normal, params, layout,
                                  cfg)
    outs = {}
    for key, w in (("none", None), ("ws", ws)):
        outs[key] = W.make_fastw_multi_step(params, layout, cfg, 4,
                                            return_diag=True, wall_static=w)(
            *scene.device_state("cpu"))
    out, diag = outs["none"]
    np.testing.assert_allclose(out.pos.numpy(), np.asarray(jout.pos),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(out.vel.numpy(), np.asarray(jout.vel),
                               rtol=0, atol=ATOL * 10)
    np.testing.assert_allclose(out.pos.numpy(), outs["ws"][0].pos.numpy(),
                               rtol=0, atol=1e-5)
    assert int(diag["tile_overflow"]) == int(diag["shell_overflow"]) == 0
    assert np.abs(out.pos.numpy() - scene.pos).max() > 1e-4
    # the raw_sw pass runs once a period, only on the in-graph path
    parts = W._make_step_parts_w(params, layout, cfg, wall_static=None)
    assert "raw_sw" in parts.passes
    assert "raw_sw" not in W._make_step_parts_w(params, layout, cfg,
                                                wall_static=ws).passes
    calls = W.record_step_inputs(parts, *scene.device_state("cpu"))
    p, tables, own, slab = calls["raw_sw"]
    assert (p.n_blocks, p.ccol) == (cfg.n_blocks_s, cfg.ccol_compact)
    # the ring kernel's precondition on this new table shape: a 16-byte
    # aligned slab whose width, ccol and tile offsets are multiples of 4,
    # rows a CTA dividing the block (checked on CPU tables)
    pk._check(p, tables, own, slab)
    assert slab.shape[1] % 4 == 0 and bool((tables[0] % 4 == 0).all())
    # the stateful stepper takes the in-graph path too
    sort, inner, unsort = W.make_fastw_stepper(params, layout, cfg,
                                               inner_steps=2)
    state, springs, membranes = scene.device_state("cpu")
    for _ in range(2):
        ctx, carry, _ = sort(state, springs, membranes)
        state = unsort(ctx, inner(ctx, carry), state)
    assert torch.equal(state.pos, out.pos)
    # every table set's overflow counts: with each set made to overflow by
    # one tile, the in-graph path counts four (moving, moving x shell,
    # shell x moving, shell x wall), the hoisted path three
    real = W._table_overflow
    monkeypatch.setattr(W, "_table_overflow",
                        lambda *a: real(*a) + 1)
    for w, n in ((None, 4), (ws, 3)):
        p2 = W._make_step_parts_w(params, layout, cfg, wall_static=w)
        _, d = p2.sort_ctx(*scene.device_state("cpu"))
        assert int(d["tile_overflow"]) == n


def test_in_graph_wall_period_syncs_nothing_on_meta(monkeypatch):
    """The in-graph wall path stays capturable: a period with
    ``wall_static=None`` on the ``meta`` device (as
    ``tests/test_torch_graph.py`` runs the hoisted one), the pair passes
    stubbed, makes no host sync and, after a warm-up period, copies
    nothing from host memory."""
    from test_torch_graph import _refuse, _setitem_on_card

    _, _, params, scene = kicked_box()
    layout = scene.layout()
    cfg = W.compute_fastw_config(scene.pos, params, layout,
                                 ptype=scene.ptype, device="meta",
                                 resort_every=2)
    parts = W._make_step_parts_w(params, layout, cfg, wall_static=None)
    assert "raw_sw" in parts.passes
    for key, p in parts.passes.items():
        def stub(tables, own, slab, _p=p):
            outs = [torch.empty(_p.n_pad, device=own.device)
                    for _ in range(pk._rows(_p)[0])]
            return outs[0] if len(outs) == 1 else tuple(outs)
        parts.passes[key] = stub
    state, springs, membranes = scene.device_state("meta")
    g = graphed.PeriodGraph(parts, 2)
    g.eager(state, springs, membranes)
    monkeypatch.setattr(torch, "tensor", _refuse("torch.tensor"))
    monkeypatch.setattr(torch, "as_tensor", _refuse("torch.as_tensor"))
    monkeypatch.setattr(torch.Tensor, "__setitem__",
                        _setitem_on_card(torch.Tensor.__setitem__))
    out, diag = g.eager(state, springs, membranes)
    monkeypatch.undo()
    assert out.pos.device.type == "meta"
    assert out.pos.shape == state.pos.shape
    assert set(diag) >= {"window_drift", "tile_overflow", "shell_overflow"}


def test_elastic_getters_equal_sph_tpu():
    """get_elastic_connections and get_membranes on the tiny worm."""
    from __graft_entry__ import _tiny_worm

    jp, js = _tiny_worm()
    jsim = JSim(js, jp, engine="exact", async_io=False)
    sim = Simulator(port_scene(js), params_from(jp), engine="exact",
                    device="cpu", async_io=False)
    for a, b in zip(sim.get_elastic_connections(),
                    jsim.get_elastic_connections()):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert len(js.tris) > 0
    np.testing.assert_array_equal(sim.get_membranes(), jsim.get_membranes())


def test_cli_run_dump_checkpoint_restore_replay(tmp_path, capsys):
    """``run --dump --checkpoint``, then ``run --restore``, then ``replay
    --render --gif`` on the 8h box on the CPU."""
    box = ["--scene", "box", "--box", "8,8,8", "--fill", "0.5",
           "--device", "cpu", "--resort-every", "2"]
    dump, ck = tmp_path / "buffers", str(tmp_path / "ck.npz")
    assert cli(["run"] + box + ["--steps", "4", "--dump", str(dump),
                                "--dump-every", "2", "--report-every", "2",
                                "--checkpoint", ck]) == 0
    assert cli(["run"] + box + ["--steps", "2", "--restore", ck]) == 0
    out = capsys.readouterr().out
    assert "[[ step 4 ]]" in out and "restored from" in out
    assert "[[ step 6 ]]" in out
    frames, gif = tmp_path / "frames", tmp_path / "t.gif"
    assert cli(["replay", "--buffers", str(dump), "--render", str(frames),
                "--gif", str(gif)]) == 0
    assert sorted(os.listdir(frames)) == [f"frame_{i:05d}.png"
                                          for i in range(3)]
    assert gif.stat().st_size > 0
