"""The plain reference: its neighbour search, its agreement with the
program's engines on small scenes of every force term, its independence
from the program, and the control that the check must reject."""
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from harness import check, inputs, spec
from reference import physics
from reference.neighbours import within
from sph_tpu_torch.runtime.simulator import Simulator
from sph_tpu_torch.scene.scene import Scene

H = 3.34
TINY = json.loads((spec.BENCH_DIR / "tests" / "data" /
                   "tiny_box.json").read_text())


def test_within_is_the_brute_force_set():
    g = torch.Generator().manual_seed(0)
    q = torch.rand((300, 3), generator=g) * 20
    t = torch.rand((500, 3), generator=g) * 20
    for a, b, same in ((q, t, False), (t, t, True)):
        nb = within(a, b, 2.5, same=same)
        d = torch.cdist(a.double(), b.double())
        want = d < 2.5
        if same:
            want.fill_diagonal_(False)
        got = torch.zeros_like(want)
        rows = torch.arange(a.shape[0])[:, None].expand_as(nb)
        real = nb < b.shape[0]
        got[rows[real], nb[real]] = True
        assert torch.equal(got, want)


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import reference.physics, reference.neighbours; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'sph_tpu_torch', 'sph_tpu', 'jax', 'jaxlib', 'flax'}))"
            % str(spec.BENCH_DIR))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def params_dict(**box):
    p = dict(TINY["params"])
    p.update(box)
    return p


def elastic_scene():
    """A liquid block against a membrane sheet of elastic particles joined
    by springs of two muscles, inside walls: every force term of the step,
    at a size a CPU test holds."""
    r0 = 0.5 * H
    n = 6
    gx, gz = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    sheet = np.stack([8.0 + r0 * gx.ravel(), np.full(n * n, 9.0),
                      8.0 + r0 * gz.ravel()], 1)
    lx, ly, lz = np.meshgrid(np.arange(5), np.arange(3), np.arange(5),
                             indexing="ij")
    liq = np.stack([8.6 + r0 * lx.ravel(), 9.0 + 0.45 * r0 + r0 * ly.ravel(),
                    8.6 + r0 * lz.ravel()], 1)
    # a layer under the sheet, within r0 of the walls
    bx, bz = np.meshgrid(np.arange(5), np.arange(5), indexing="ij")
    liq = np.concatenate([liq, np.stack(
        [8.6 + r0 * bx.ravel(), np.full(25, 6.5 + 0.7 * r0),
         8.6 + r0 * bz.ravel()], 1)])
    wx, wz = np.meshgrid(np.arange(14), np.arange(14), indexing="ij")
    walls = np.stack([3.0 + r0 * wx.ravel(), np.full(196, 6.5),
                      3.0 + r0 * wz.ravel()], 1)
    pos = np.concatenate([sheet, liq, walls]).astype(np.float32)
    ne, nl = n * n, len(liq)
    color = np.concatenate([np.full(ne, 2.2), np.full(nl, 1.1),
                            np.full(len(walls), 3.0)]).astype(np.float32)
    normal = np.zeros_like(pos)
    normal[ne + nl:, 1] = 1.0
    idx = np.full((ne, 32), -1, np.int32)
    rest = np.zeros((ne, 32), np.float32)
    typ = np.zeros((ne, 32), np.float32)
    scale = physics.derived(params_dict())["scale"]
    tris = []
    for i in range(n):
        for k in range(n):
            a = i * n + k
            s = 0
            for di, dk in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                if 0 <= i + di < n and 0 <= k + dk < n:
                    b = (i + di) * n + (k + dk)
                    idx[a, s] = b
                    rest[a, s] = np.linalg.norm(pos[a] - pos[b]) * scale * 0.95
                    typ[a, s] = 5.2 if max(i, i + di) < n // 2 else 0.0
                    s += 1
            if i + 1 < n and k + 1 < n:
                tris += [(a, a + n, a + 1), (a + 1, a + n, a + n + 1)]
    vel = np.zeros_like(pos)
    vel[ne:ne + nl - 25, 1] = -0.05
    return Scene(pos=pos, vel=vel, color=color, normal=normal,
                 spring_rows=np.arange(ne, dtype=np.int32), spring_idx=idx,
                 spring_rest=rest, spring_type=typ,
                 tris=np.array(tris, np.int32), muscle_model=True)


def box_scene(seed):
    cfg = dict(TINY, jitter_m_s=0.002)
    return inputs.make_scene(cfg, seed, torch.device("cpu"))


def program_and_reference(scene, engine, steps, pair_dtype=torch.float32,
                          start_step=0):
    params = params_dict()
    sim = Simulator(scene, inputs.sim_params({"params": params}),
                    engine=engine, device="cpu", async_io=False)
    sim.step(steps)
    topo = physics.Topology.of(inputs.topology_arrays(scene), "cpu")
    c = physics.derived(params)
    rx, rv = physics.run(torch.as_tensor(scene.pos),
                         torch.as_tensor(scene.vel), start_step, steps, topo,
                         c, pair_dtype)
    return (scene.pos, scene.vel, sim.get_position(), sim.get_velocity(),
            rx.numpy(), rv.numpy(),
            check.row_sets(scene.pos, inputs.topology_arrays(scene), H))


@pytest.mark.parametrize("engine", ["fast", "fastw"])
def test_reference_follows_the_engines_on_every_force_term(engine):
    scene = elastic_scene()
    x0, v0, x1, v1, rx, rv, sets = program_and_reference(scene, engine, 4)
    mov = sets[""]
    # the terms act: the liquid moved, the muscles pulled the sheet
    assert np.abs(rv[mov] - v0[mov]).max() > 1e-3
    assert np.abs(x1 - rx)[mov].max() <= 1e-4 * H
    scale = np.abs(rv[mov] - v0[mov]).max()
    assert np.abs(v1 - rv)[mov].max() <= 1e-3 * scale
    units = check.scales(params_dict(), 4)
    g = check.gaps(x0, x1, v1, rx, rv, sets, units)
    assert g["walls_moved"] == 0.0
    assert {"vel_gap.elastic", "pos_gap.wall", "pos_gap.membrane"} <= set(g)


@pytest.mark.parametrize("seed", [1, 2])
def test_reference_follows_the_fastw_box(seed):
    x0, v0, x1, v1, rx, rv, sets = program_and_reference(box_scene(seed),
                                                         "fastw", 3)
    g = check.gaps(x0, x1, v1, rx, rv, sets, check.scales(params_dict(), 3))
    assert g["vel_gap"] < 1e-3 and g["pos_gap"] < 1e-5


def test_the_control_fails_every_cell_limit():
    """The reference with its pair arithmetic in bfloat16, put in the
    program's place, is refused by each cell's limits (the card's readings
    at full size are in PERF.md)."""
    scene = elastic_scene()
    params = params_dict()
    topo = physics.Topology.of(inputs.topology_arrays(scene), "cpu")
    c = physics.derived(params)
    x0, v0 = torch.as_tensor(scene.pos), torch.as_tensor(scene.vel)
    rx, rv = physics.run(x0, v0, 0, 2, topo, c)
    bx, bv = physics.run(x0, v0, 0, 2, topo, c, torch.bfloat16)
    sets = check.row_sets(scene.pos, inputs.topology_arrays(scene), H)
    g = check.gaps(scene.pos, bx.numpy(), bv.numpy(), rx.numpy(),
                   rv.numpy(), sets, check.scales(params, 2))
    for f in (spec.BENCH_DIR / "checks").glob("*.json"):
        limits = json.loads(f.read_text())
        # a number of the cell's own over its limit, not a missing limit
        assert any(g[n] > lim for n, lim in limits.items() if n in g), f.name


def test_row_sets_are_the_brute_force_sets():
    """The rows each term acts on, against distances taken pair by pair."""
    scene = elastic_scene()
    sets = check.row_sets(scene.pos, inputs.topology_arrays(scene), H)
    d = np.linalg.norm(scene.pos[:, None] - scene.pos[None], axis=-1)
    wall = scene.ptype == physics.BOUNDARY
    tri = np.zeros(len(wall), bool)
    tri[scene.tris.ravel()] = True
    near_wall = ~wall & ((d < H) & wall[None]).any(1)
    near_tri = ((scene.ptype == physics.LIQUID)
                & ((d < H / 2) & tri[None]).any(1))
    assert np.array_equal(sets[""], ~wall)
    assert np.array_equal(sets["elastic"], scene.ptype == 2)
    assert np.array_equal(sets["wall"], near_wall) and near_wall.any()
    assert np.array_equal(sets["membrane"], near_tri) and near_tri.any()


def test_first_tris_keeps_seven_in_order():
    tris = np.array([[0, 1, 2]] * 9 + [[3, 1, 2]], np.int64)
    pt = physics.first_tris(tris, 4)
    assert pt[0].tolist() == list(range(7))
    assert pt[3].tolist() == [9] + [-1] * 6
    assert pt[1].tolist() == list(range(7))


@pytest.mark.cuda
def test_reference_on_the_card_agrees_with_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    scene = elastic_scene()
    params = params_dict()
    c = physics.derived(params)
    out = []
    for dev in ("cpu", "cuda"):
        topo = physics.Topology.of(inputs.topology_arrays(scene), dev)
        out.append(physics.run(torch.as_tensor(scene.pos, device=dev),
                               torch.as_tensor(scene.vel, device=dev), 0, 3,
                               topo, c))
    assert torch.allclose(out[0][0], out[1][0].cpu(), atol=1e-4 * H, rtol=0)
