"""The work counter of ``step_roofline``: the pairs within reach, counted
from positions alone, equal a brute-force count and do not move with the
engine or its tile settings."""
import pytest
import torch

from harness import inputs
from harness.work import count, in_triangles
from sph_tpu_torch.runtime.simulator import Simulator
from test_bench_reference import elastic_scene, params_dict

H = 3.34


def brute(pos, ptype, spring_idx, has_tri):
    d = torch.cdist(pos.double(), pos.double())
    wall = ptype == 3
    n = len(pos)
    eye = torch.eye(n, dtype=torch.bool)
    fluid = (d < H) & ~eye & ~(wall[:, None] & wall[None, :])
    bnd = (d < H / 2) & ~wall[:, None] & wall[None, :]
    mem = (d < H / 2) & (ptype == 1)[:, None] & has_tri[None, :]
    return dict(fluid=int(fluid.sum()) // 2, boundary=int(bnd.sum()),
                boundary_rows=int(bnd.any(1).sum()),
                boundary_cols=int(bnd.any(0).sum()),
                membrane=int(mem.sum()), membrane_cols=int(mem.any(0).sum()),
                spring=int((spring_idx >= 0).sum()))


@pytest.mark.parametrize("seed", [0, 1])
def test_count_is_the_brute_force_count(seed):
    g = torch.Generator().manual_seed(seed)
    n = 600
    pos = torch.rand((n, 3), generator=g) * 12
    ptype = torch.randint(1, 4, (n,), generator=g)
    has_tri = (ptype == 2) & (torch.rand(n, generator=g) < 0.5)
    spring_idx = torch.randint(-1, n, (50, 32), generator=g)
    got = count(pos, ptype, spring_idx, has_tri, H)
    for k, v in brute(pos, ptype, spring_idx, has_tri).items():
        assert got[k] == v, k


def test_count_does_not_move_with_engine_or_tiles():
    """The positions each engine hands the user, at other blocks and column
    tiles, counted with the scene's own arrays: one count."""
    scene = elastic_scene()
    params = inputs.sim_params({"params": params_dict()})
    counts = []
    for engine, fc in (("fast", None), ("fast", dict(block=64, ccol=128)),
                       ("fastw", None), ("fastw", dict(block=128, ccol=256,
                                                       ccol_c=128))):
        sim = Simulator(scene, params, engine=engine, device="cpu",
                        fast_config=fc, async_io=False)
        counts.append(count(
            torch.as_tensor(sim.get_position()),
            torch.as_tensor(scene.ptype).long(),
            torch.as_tensor(scene.spring_idx).long(),
            in_triangles(scene.tris, scene.n_particles, "cpu"), H))
    assert all(c == counts[0] for c in counts)
    assert counts[0]["fluid"] > 0 and counts[0]["membrane"] > 0
    assert counts[0]["spring"] > 0
