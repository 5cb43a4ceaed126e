"""The port's graphed resort period (``sph_tpu_torch/core/graphed.py``) on
the CPU: the period a graph captures syncs nothing with the host (run on
the ``meta`` device, where a host read raises), the captured function run
without capture equals the eager loop bitwise and sph_tpu's jitted fastw
period within the tolerances of ``tests/test_torch_fastw.py``, the launch
counts of a replay, and the ``cuda_graph`` switch. On a CUDA card (marked
``cuda``, skipped here) a graphed period is held bitwise to the eager one.

Scenes: the kicked 8h box, the spring chain and the membrane quad of
``tests/test_torch_fastw.py``, and for the fast engine's gather fallback
the 8h box with an elastic chain anchored to a wall.

The module imports neither jax nor sph_tpu at its top (the tests that
compare with sph_tpu import them), so that on a machine with a card and
no jax its card test runs alone:
``python -m pytest --noconftest -m cuda tests/test_torch_graph.py``."""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from sph_tpu_torch import SimParams
from sph_tpu_torch.constants import BOUNDARY_PARTICLE, MAX_NEIGHBORS
from sph_tpu_torch.core import fast as F
from sph_tpu_torch.core import fastw as W
from sph_tpu_torch.core import graphed
from sph_tpu_torch.ops import pack as pack_ops
from sph_tpu_torch.ops import pair_kernels as pk
from sph_tpu_torch.runtime import Simulator
from sph_tpu_torch.scene import generate_liquid_box_scene

H = 3.34
BOX = dict(x_max=8 * H, y_max=8 * H, z_max=8 * H)   # test_torch_fastw's
RESORT = 2
STEPS = 4        # two resort periods


def box_scene(kick=True):
    """(params, scene) of the 8h box at fill 0.5, kicked as in
    ``tests/test_torch_fastw.py`` (its liquid hits the floor walls)."""
    params = SimParams(**BOX)
    scene = generate_liquid_box_scene(params, fill_fraction=0.5)
    if kick:
        from test_torch_fastw import KICK
        from test_torch_pair_kernels import kick_box_scene

        kick_box_scene(scene, params, **KICK)
    return params, scene


def anchored_scene():
    """The kicked 8h box whose first 8 particles are an elastic chain, its
    first spring anchored to a wall: the fast engine's gather fallback."""
    params, scene = box_scene()
    scene.color[:8] = 2.2
    wall = int(np.nonzero(scene.ptype == BOUNDARY_PARTICLE)[0][0])
    idx = np.full((8, MAX_NEIGHBORS), -1, np.int32)
    idx[:, 0] = np.arange(1, 9)
    idx[7, 0] = 6
    idx[0, 1] = wall
    rest = np.where(idx >= 0, np.float32(0.8 * params.r0
                                         * params.simulation_scale), 0.0)
    scene.spring_rows = np.arange(8, dtype=np.int32)
    scene.spring_idx = idx
    scene.spring_rest = rest.astype(np.float32)
    scene.spring_type = np.zeros_like(rest, np.float32)
    assert not scene.layout().springs_elastic_only
    return params, scene


def scene_of(name):
    if name == "box":
        return box_scene()
    if name == "anchored":
        return anchored_scene()
    from sph_tpu.config import SimParams as JParams
    from sph_tpu_torch.convert import params_from
    from test_torch_fastw import (membrane_quad_scene, port_scene,
                                  spring_chain_scene)

    jp = JParams(**BOX)
    make = spring_chain_scene if name == "spring_chain" else \
        membrane_quad_scene
    return params_from(jp), port_scene(make(jp))


def engine_parts(engine, params, scene, device="cpu"):
    """(StepParts, resort period) of ``engine`` on ``scene``."""
    layout = scene.layout()
    if engine == "fast":
        cfg = F.compute_fast_config(scene.pos, params, block=128, ccol=128,
                                    resort_every=RESORT)
        return F._make_step_parts(params, layout, cfg), cfg
    cfg = W.compute_fastw_config(scene.pos, params, layout,
                                 ptype=scene.ptype, device=device,
                                 resort_every=RESORT)
    ws = W.precompute_wall_static(scene.pos, scene.normal, params, layout,
                                  cfg)
    return W._make_step_parts_w(params, layout, cfg, wall_static=ws), cfg


def multi_step(engine, params, scene, cfg, n, **kw):
    layout = scene.layout()
    if engine == "fast":
        return F.make_fast_multi_step(params, layout, cfg, n, **kw)
    ws = W.precompute_wall_static(scene.pos, scene.normal, params, layout,
                                  cfg)
    return W.make_fastw_multi_step(params, layout, cfg, n, wall_static=ws,
                                   **kw)


CASES = [("fastw", "box"), ("fastw", "spring_chain"),
         ("fastw", "membrane_quad"), ("fast", "box"),
         ("fast", "spring_chain"), ("fast", "membrane_quad"),
         ("fast", "anchored")]


def _refuse(what):
    def refused(*args, **kwargs):
        raise AssertionError(f"{what} in a captured period")
    return refused


def _setitem_on_card(setitem):
    """``Tensor.__setitem__`` that refuses a Python number assigned through
    a tensor index: index_put_ copies the number from host memory."""
    def checked(self, index, value):
        parts = index if isinstance(index, tuple) else (index,)
        if (isinstance(value, (bool, int, float))
                and any(isinstance(i, torch.Tensor) for i in parts)):
            raise AssertionError("a number assigned through a tensor index "
                                 "(a host-to-device copy) in a captured "
                                 "period")
        return setitem(self, index, value)
    return checked


@pytest.mark.parametrize("engine,name", CASES)
def test_period_syncs_nothing_on_meta(engine, name, monkeypatch):
    """A whole period on the ``meta`` device, whose tensors hold no values,
    with the pair passes stubbed by ``torch.empty`` outputs of their
    shapes: a host sync (``.item()``, ``int(tensor)``, ``nonzero``, a
    boolean-mask index) raises there, and could not be captured on the
    card. After one period (the graph's warm-up), a second one may copy
    nothing from host memory either, which a capture refuses too: no tensor
    made from host data, no number assigned through a tensor index."""
    params, scene = scene_of(name)
    parts, _ = engine_parts(engine, params, scene, device="meta")
    for key, p in parts.passes.items():
        def stub(tables, own, slab, _p=p):
            outs = [torch.empty(_p.n_pad, device=own.device)
                    for _ in range(pk._rows(_p)[0])]
            return outs[0] if len(outs) == 1 else tuple(outs)
        parts.passes[key] = stub
    state, springs, membranes = scene.device_state("meta")
    g = graphed.PeriodGraph(parts, RESORT)
    g.eager(state, springs, membranes)
    monkeypatch.setattr(torch, "tensor", _refuse("torch.tensor"))
    monkeypatch.setattr(torch, "as_tensor", _refuse("torch.as_tensor"))
    monkeypatch.setattr(torch.Tensor, "__setitem__",
                        _setitem_on_card(torch.Tensor.__setitem__))
    out, diag = g.eager(state, springs, membranes)
    monkeypatch.undo()
    assert out.pos.device.type == "meta"
    assert out.pos.shape == state.pos.shape
    assert out.vel.shape == state.vel.shape
    assert out.muscle_activation.shape == state.muscle_activation.shape
    assert set(diag) >= {"window_drift", "tile_overflow"}
    with pytest.raises((RuntimeError, NotImplementedError)):
        out.pos.sum().item()            # what a sync does on meta


@pytest.mark.parametrize("engine,name", CASES)
def test_graph_function_equals_the_eager_loop(engine, name):
    """The function a graph captures, run without capture on the CPU (the
    state copied into static inputs, the period, its outputs cloned), two
    periods: bitwise the eager loop (``cuda_graph=False``). A state the
    caller keeps is not overwritten by the next period, and another ptype
    tensor than the captured one is refused."""
    params, scene = scene_of(name)
    parts, cfg = engine_parts(engine, params, scene)
    state, springs, membranes = scene.device_state("cpu")
    ref = multi_step(engine, params, scene, cfg, STEPS, cuda_graph=False)(
        state, springs, membranes)
    g = graphed.PeriodGraph(parts, RESORT)
    first, d1 = g.eager(state, springs, membranes)
    kept = first.pos.clone()
    out, d2 = g.eager(first, springs, membranes)
    assert torch.equal(first.pos, kept)
    for f in ("pos", "vel", "muscle_activation", "step"):
        assert torch.equal(getattr(out, f), getattr(ref, f)), f
    assert out.ptype is state.ptype and out.normal is state.normal
    assert int(out.step) == STEPS
    if name != "membrane_quad":         # the quad barely moves in 4 steps
        assert (out.pos - state.pos).abs().max() > 1e-4
    for d in (d1, d2):
        assert set(d) >= {"window_drift", "tile_overflow"}
    other = dataclasses.replace(out, ptype=out.ptype.clone())
    with pytest.raises(ValueError, match="state.ptype"):
        g.eager(other, springs, membranes)


def test_graph_function_matches_jax_fastw():
    """Two periods of the graph's function on the kicked 8h box against
    sph_tpu's jitted ``make_fastw_multi_step`` (Pallas in interpret mode):
    the tolerances of ``tests/test_torch_fastw.py``."""
    from sph_tpu.config import SimParams as JParams
    from sph_tpu.core import fastw as JW
    from sph_tpu.scene import generate_liquid_box_scene as j_box
    from sph_tpu_torch.convert import params_from
    from test_torch_fastw import ATOL, KICK
    from test_torch_pair_kernels import kick_box_scene

    jp = JParams(**BOX)
    js = kick_box_scene(j_box(jp, fill_fraction=0.5), jp, **KICK)
    jl = js.layout()
    jcfg = JW.compute_fastw_config(js.pos, jp, jl, ptype=js.ptype,
                                   resort_every=RESORT)
    jws = JW.precompute_wall_static(js.pos, js.normal, jp, jl, jcfg)
    jout, jdiag = JW.make_fastw_multi_step(jp, jl, jcfg, STEPS,
                                           return_diag=True,
                                           wall_static=jws)(
        *js.device_state())
    params, scene = box_scene()
    assert params == params_from(jp)
    np.testing.assert_array_equal(scene.pos, js.pos)
    parts, _ = engine_parts("fastw", params, scene)
    g = graphed.PeriodGraph(parts, RESORT)
    state, springs, membranes = scene.device_state("cpu")
    drift = []
    for _ in range(STEPS // RESORT):
        state, d = g.eager(state, springs, membranes)
        drift.append(float(d["window_drift"]))
        assert int(d["shell_overflow"]) == int(d["tile_overflow"]) == 0
    np.testing.assert_allclose(state.pos.numpy(), np.asarray(jout.pos),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(state.vel.numpy(), np.asarray(jout.vel),
                               rtol=0, atol=ATOL * 10)
    assert int(state.step) == int(jout.step) == STEPS
    np.testing.assert_allclose(max(drift), float(jdiag["window_drift"]),
                               rtol=1e-3)
    assert np.abs(state.pos.numpy() - scene.pos).max() > 1e-4


class _FakeStream:
    def wait_stream(self, other):
        pass


class _FakeEvent:
    """Stands in for ``torch.cuda.Event``: counts the events made and
    their records."""

    made = records = 0

    def __init__(self, **kwargs):
        self.kwargs = kwargs
        _FakeEvent.made += 1

    def record(self, stream=None):
        _FakeEvent.records += 1


class _FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph``: a replay runs nothing."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


@pytest.fixture
def fake_cuda(monkeypatch):
    """The ``torch.cuda`` calls of a capture, on the CPU: the warm-up and
    the capture run the period eagerly, a replay runs nothing, an event
    is counted and counts its records."""
    noop = contextlib.nullcontext
    monkeypatch.setattr(_FakeEvent, "made", 0)
    monkeypatch.setattr(_FakeEvent, "records", 0)
    for name, value in (("Stream", _FakeStream),
                        ("stream", lambda s: noop()),
                        ("current_stream", _FakeStream),
                        ("synchronize", lambda: None),
                        ("empty_cache", lambda: None),
                        ("memory_reserved", lambda *a: 0),
                        ("device", lambda d: noop()),
                        ("CUDAGraph", _FakeGraph),
                        ("Event", _FakeEvent),
                        ("graph", lambda g: noop())):
        monkeypatch.setattr(torch.cuda, name, value)


def test_replays_count_the_launches_of_their_capture(fake_cuda,
                                                     monkeypatch):
    """The warm-up and the capture add no launch; each replay adds the
    counts the capture made, so after k replays the counts are k times
    those of one period."""
    params, scene = scene_of("spring_chain")
    parts, _ = engine_parts("fastw", params, scene)
    for key, p in parts.passes.items():
        def counted(tables, own, slab, _p=p):
            pk.LAUNCHES[_p.launch_key] += 1
            return _p(tables, own, slab)
        parts.passes[key] = counted
    monkeypatch.setattr(pk, "LAUNCHES", dict.fromkeys(pk.LAUNCHES, 0))
    monkeypatch.setattr(pack_ops, "LAUNCHES", {"pack": 0})
    monkeypatch.setattr(graphed, "_COUNTERS",
                        (pk.LAUNCHES, pack_ops.LAUNCHES))
    monkeypatch.setattr(graphed, "CAPTURES", [])
    state, springs, membranes = scene.device_state("cpu")
    graphed.run_period(parts, RESORT, state, springs, membranes)
    per_period = {k: v for k, v in pk.LAUNCHES.items() if v}
    assert per_period["rho_star"] == 4 * RESORT
    assert per_period["spring"] == RESORT
    pk.LAUNCHES.update(dict.fromkeys(pk.LAUNCHES, 0))
    g = graphed.PeriodGraph(parts, RESORT)
    for k in (1, 2, 3):
        g(state, springs, membranes)
        assert g.graph.replays == k
        assert {key: v for key, v in pk.LAUNCHES.items() if v} == {
            key: k * v for key, v in per_period.items()}
    assert g.launches == [per_period, {}]
    assert [c["launches"] for c in graphed.CAPTURES] == [per_period]
    assert pack_ops.LAUNCHES == {"pack": 0}


def test_cuda_graph_switch(monkeypatch):
    """``cuda_graph`` (on by default) replays graphs only for a state on a
    CUDA device: on the CPU the engines' runners and the Simulator step the
    eager loop whatever its value, and capture nothing."""
    def refused(*args, **kwargs):
        raise AssertionError("a period graph built for a CPU state")
    monkeypatch.setattr(graphed, "PeriodGraph", refused)
    params, scene = box_scene()
    for engine in ("fastw", "fast"):
        _, cfg = engine_parts(engine, params, scene)
        args = scene.device_state("cpu")
        outs = [multi_step(engine, params, scene, cfg, RESORT, **kw)(*args)
                for kw in ({}, dict(cuda_graph=True),
                           dict(cuda_graph=False))]
        for out in outs[1:]:
            assert torch.equal(out.pos, outs[0].pos)
        sim = Simulator(scene, params, engine=engine, device="cpu",
                        fast_config=dict(resort_every=RESORT))
        sim.step(RESORT + 1)
        assert sim.step_count == RESORT + 1


@pytest.mark.cuda
def test_graphed_period_equals_eager_on_cuda():
    """On a CUDA card: two periods of the 8h box replayed from a graph
    against the eager loop, bitwise, for both engines, with the pair-kernel
    launches of the replays equal to the eager loop's; a state the caller
    keeps is not overwritten by the next replay."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    params, scene = box_scene(kick=False)
    for engine in ("fastw", "fast"):
        _, cfg = engine_parts(engine, params, scene, device="cuda")
        args = scene.device_state("cuda")
        counts, outs = [], []
        graphed.CAPTURES.clear()
        for cuda_graph in (False, True):
            run = multi_step(engine, params, scene, cfg, STEPS,
                             cuda_graph=cuda_graph)
            pk.LAUNCHES.update(dict.fromkeys(pk.LAUNCHES, 0))
            outs.append(run(*args))
            torch.cuda.synchronize()
            counts.append(dict(pk.LAUNCHES))
        assert [c["r_steps"] for c in graphed.CAPTURES] == [RESORT]
        assert counts[0] == counts[1] and sum(counts[0].values()) > 0
        for f in ("pos", "vel", "muscle_activation", "step"):
            assert torch.equal(getattr(outs[0], f), getattr(outs[1], f)), f
        kept = outs[1].pos.clone()
        later = run(outs[1], *args[1:])
        torch.cuda.synchronize()
        assert not torch.equal(later.pos, kept)
        assert torch.equal(outs[1].pos, kept)
