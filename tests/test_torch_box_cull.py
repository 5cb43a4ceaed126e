"""The ring kernels' box cull (``pair_ring`` with ``pair_kernels.CHUNK``
in ``sph_tpu_torch/ops/csrc/pair_pass.cu``): the plain version of its box
kernel (``pair_kernels.chunk_boxes``) against NumPy, the buffer the box
kernel writes (``pair_kernels.box_buffer``), and its plain model
(``pair_kernels.cull_chunks``: the kernel's warps of consecutive rows, its
chunks of columns, each kind's cull reach with its margin) on the sorted
layouts the benchmark's two scenes start from: no pair that a culled (warp,
chunk) holds has a term that is not an exact zero, however the kernel's
compiler fuses the distance, and the share it culls lies in a stated
range. Two broken models must fail the same check: one without the margin
(a pair placed where a fused r2 rounds under the threshold that the
unfused gap reaches) and one whose threshold lies short of the kernel's
reach. The kernels run only on a card: ``chip_smoke.py`` (phase 19) holds
every culled kernel bitwise to its unculled form and its device counters
to ``cull_counts``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from sph_tpu_torch.config import SimParams
from sph_tpu_torch.core import fast as F
from sph_tpu_torch.core import fastw as W
from sph_tpu_torch.ops import pair_kernels as pk
from sph_tpu_torch.scene import generate_liquid_box_scene, generate_worm_scene

PARAMS = SimParams()
U = 2.0 ** -24          # f32's unit roundoff
# own blocks a layout's exactness check walks, drawn from a seed
SAMPLE = 12
# the share of tested chunks the cull must skip on every launch below
CULLED = (0.40, 0.90)


def test_chunk_boxes_match_numpy():
    """Each aligned run of ``chunk`` columns (the last one short) gets the
    min and max of the three rows from ``row0``, zeros in the 4th and 8th
    slots, for the kernel's chunks 16, 32, 64 and the membrane's rows."""
    rng = np.random.default_rng(7)
    for chunk, row0, width in ((16, 0, 100), (32, 0, 256), (64, 42, 452),
                               (32, 3, 36)):
        slab = rng.normal(size=(row0 + 3, width)).astype(np.float32)
        got = pk.chunk_boxes(torch.from_numpy(slab), row0, chunk).numpy()
        n = -(-width // chunk)
        assert got.shape == (n, 8) and got.dtype == np.float32
        for b in range(n):
            cols = slab[row0:row0 + 3, b * chunk:(b + 1) * chunk]
            np.testing.assert_array_equal(got[b, :3], cols.min(1))
            np.testing.assert_array_equal(got[b, 4:7], cols.max(1))
        assert not got[:, 3].any() and not got[:, 7].any()


def _dam():
    """The dam-break's launches (fast engine): density on the time-t
    positions, viscsurf and paccel on the force tables, boundary on the
    compact wall pack."""
    scene = generate_liquid_box_scene(PARAMS, fill_fraction=0.8)
    cfg = F.compute_fast_config(scene.pos, PARAMS)
    parts = F._make_step_parts(PARAMS, scene.layout(), cfg)
    state = scene.device_state("cpu")
    ctx, _ = parts.sort_ctx(*state)
    xs, ys, zs = parts.carry_of(ctx, state[0])[:3]
    pos = F._pack([xs, ys, zs])
    own6 = F._pack([xs, ys, zs, xs, ys, zs])
    ps = parts.passes
    return {
        "dam.density": (ps["density"], ctx["rho_tables"], pos, pos),
        "dam.viscsurf": (ps["viscsurf"], ctx["force_tables"], pos, pos),
        "dam.paccel": (ps["paccel"], ctx["force_tables"], pos, pos),
        "dam.boundary": (ps["boundary"], ctx["bnd_tables"], own6,
                         ctx["bnd_pack"]),
    }


def _worm():
    """The worm's launches (fastw): rho*, viscsurf and paccel over the
    moving rows' main window and against the shell, the shell rows against
    the moving ones, boundary and membrane (its pack's x(t+1) rows filled
    as a step fills them)."""
    scene = generate_worm_scene(PARAMS)
    layout = scene.layout()
    cfg = W.compute_fastw_config(scene.pos, PARAMS, layout,
                                 ptype=scene.ptype)
    ws = W.precompute_wall_static(scene.pos, scene.normal, PARAMS, layout,
                                  cfg)
    parts = W._make_step_parts_w(PARAMS, layout, cfg, wall_static=ws)
    state = scene.device_state("cpu")
    ctx, _ = parts.sort_ctx(*state)
    xs, ys, zs = parts.carry_of(ctx, state[0])[:3]
    pos = F._pack([xs, ys, zs])
    own6 = F._pack([xs, ys, zs, xs, ys, zs])
    shp = ctx["shell_pos_pack"]
    mem = ctx["mem_pack"].clone()
    els = ctx["els"]
    mem[pk.PMM_XN:pk.PMM_ZN + 1, :els.shape[0]] = pos[:, els]
    ps = parts.passes
    return {
        "worm.raw_mm": (ps["raw_mm"], ctx["tables_m"], pos, pos),
        "worm.raw_ms": (ps["raw_ms"], ctx["tables_ms"], pos, shp),
        "worm.raw_sm": (ps["raw_sm"], ctx["tables_sm"], shp, pos),
        "worm.visc_mm": (ps["visc_mm"], ctx["tables_m"], pos, pos),
        "worm.pacc_mm": (ps["pacc_mm"], ctx["tables_m"], pos, pos),
        "worm.pacc_ms": (ps["pacc_ms"], ctx["tables_ms"], pos, shp),
        "worm.bnd_ms": (ps["bnd_ms"], ctx["tables_ms"], own6,
                        ctx["bnd_pack"]),
        "worm.mem_ms": (ps["mem_ms"], ctx["mem_tables"], own6, mem),
    }


@pytest.fixture(scope="module")
def launches():
    """name -> (PairPass, tables, own, slab) of the benchmark scenes'
    ring launches at their first sort."""
    return _dam() | _worm()


NAMES = ["dam.density", "dam.viscsurf", "dam.paccel", "dam.boundary",
         "worm.raw_mm", "worm.raw_ms", "worm.raw_sm", "worm.visc_mm",
         "worm.pacc_mm", "worm.pacc_ms", "worm.bnd_ms", "worm.mem_ms"]
# the launches the cull-share range holds: the liquid passes' main windows
MAIN = ("dam.density", "dam.viscsurf", "dam.paccel", "worm.raw_mm",
        "worm.visc_mm", "worm.pacc_mm")


def _fma(a, b, c):
    """f32 fma(a, b, c), through f64 (the product is exact there)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def r2_forms(dx, dy, dz):
    """The f32 r2 = dx dx + dy dy + dz dz as a compiler may evaluate it:
    unfused, and fused into one or two FMAs."""
    xx, yy, zz = dx * dx, dy * dy, dz * dz
    return [(xx + yy) + zz, _fma(dz, dz, xx + yy),
            _fma(dz, dz, _fma(dy, dy, xx)), _fma(dx, dx, yy + zz)]


def all_zero(p: pk.PairPass, dx, dy, dz):
    """Per pair: every term the kernel adds is an exact zero (or its exit
    skips the pair) however the distance is fused: density and rho*
    h2 - r2 <= 0 (also fully fused into h2); viscsurf, boundary, membrane
    r2 >= their exit's reach; paccel r = r2 rsqrtf(r2) >= h with rsqrtf 2
    ulps low and r rounded down."""
    forms = r2_forms(dx, dy, dz)
    if p.kind in ("density", "rho_star"):
        h2 = np.float32(p.consts[0])
        fused = _fma(-dz, dz, _fma(-dy, dy, _fma(-dx, dx, h2)))
        return np.logical_and.reduce([h2 - r2 <= 0 for r2 in forms]
                                     + [fused <= 0])
    if p.kind == "paccel":
        h = float(p.consts[0])
        low = (1 - 2 * 2 ** -23) * (1 - U)
        return np.logical_and.reduce(
            [np.sqrt(r2.astype(np.float64)) * low >= h for r2 in forms])
    reach = np.float32(p.consts[-1])
    return np.logical_and.reduce([r2 >= reach for r2 in forms])


def violations(p: pk.PairPass, tables, own, slab, blocks, model=None):
    """The (block, tile, warp, chunk) the model of ``model`` (default
    ``p``) culls that hold a pair of a live row whose terms are not all
    exact zeros under ``p``: a count over ``blocks``."""
    keep, tested = pk.cull_chunks(model or p, tables, own, slab, blocks)
    C, Wr, B = pk.CHUNK, pk.RING[p.kind].warp_rows, p.block
    aln, _, _, s0, cnt, ob = (t.long() for t in tables[:6])
    i0 = pk._OWN_XYZ.get(p.kind, 0)
    j0 = pk._RING_ROW0.get(p.kind, 0)
    o = own[i0:i0 + 3].numpy()
    x = slab[j0:j0 + 3].numpy()
    width = slab.shape[1]
    bad = 0
    for i, b in enumerate(blocks.tolist()):
        rows = int(ob[0]) + b * B + np.arange(B)
        live = (rows >= 0) & (rows < own.shape[1])
        r = np.where(live, rows, 0)
        for t in range(int(cnt[b])):
            c = 3 * b + int(t >= s0[3 * b + 1]) + int(t >= s0[3 * b + 2])
            off = int(aln[c]) + (t - int(s0[c])) * p.ccol
            cols = off + np.arange(p.ccol)
            inside = (cols >= 0) & (cols < width)
            cl = np.where(inside, cols, 0)
            d = [o[k][r, None] - x[k][None, cl] for k in range(3)]
            kept_terms = ~all_zero(p, *d) & live[:, None] & inside[None, :]
            hold = kept_terms.reshape(B // Wr, Wr, p.ccol // C, C).any(
                axis=(1, 3))                                # [warps, nch]
            culled = (tested[i, t] & ~keep[i, t]).numpy()
            bad += int((culled & hold).sum())
    return bad


def sample_blocks(p, tables, seed):
    """``SAMPLE`` blocks with tiles, drawn from ``seed``, and the first
    and last of them."""
    active = np.nonzero(tables[4].numpy() > 0)[0]
    rng = np.random.default_rng(seed)
    pick = rng.choice(active, size=min(SAMPLE, len(active)), replace=False)
    return torch.as_tensor(np.unique(np.r_[pick, active[0], active[-1]]))


@pytest.mark.parametrize("scene", ["dam", "worm"])
def test_cull_skips_only_exact_zeros(launches, scene):
    """On the sampled blocks of each of the scene's launches, no (warp,
    chunk) the kernel culls holds a pair whose terms are not exact zeros:
    the cull changes no sum. On the main windows it culls 0.40-0.90 of
    the tested chunks over every block (the candidate pairs within h are
    1-2 %)."""
    for name in NAMES:
        if not name.startswith(scene + "."):
            continue
        p, tables, own, slab = launches[name]
        blocks = sample_blocks(p, tables, seed=NAMES.index(name))
        keep, tested = pk.cull_chunks(p, tables, own, slab, blocks)
        assert int((tested & ~keep).sum()) > 0, name   # the sample culls
        assert violations(p, tables, own, slab, blocks) == 0, name
        if name in MAIN:
            tested, culled = pk.cull_counts(p, tables, own, slab)
            assert CULLED[0] <= culled / tested <= CULLED[1], (
                name, culled, tested)


def near_miss(p: pk.PairPass, seed=11):
    """A row at (10, 10, 10) and a column past it on each axis whose f32
    distance, unfused, reaches the pass's threshold while a fused form
    falls under it: (row, column) as f32 triples."""
    rng = np.random.default_rng(seed)
    reach = (np.float32(p.consts[0]) if p.kind in ("density", "rho_star")
             else np.float32(p.consts[-1]))
    row = np.full(3, 10.0, np.float32)
    u = rng.normal(size=(200000, 3))
    u = np.abs(u) / np.linalg.norm(u, axis=1, keepdims=True)
    col = (row + u * np.sqrt(float(reach))).astype(np.float32)
    d = [(col[:, k] - row[k]).astype(np.float32) for k in range(3)]
    unfused = r2_forms(*d)[0]
    hit = (unfused >= reach) & (unfused < p.cull_reach) & ~all_zero(p, *d)
    assert hit.any()
    return row, col[np.argmax(hit)]


def test_broken_models_fail(launches, monkeypatch):
    """Two broken models fail the check that the shipped one passes:
    (1) a threshold at 0.85 h while the kernel's terms reach h culls
    chunks that hold pairs within reach on the dam-break's sampled
    blocks; (2) with one live row and one column at a near miss (the
    rest of the chunk far off), density's and viscsurf's margin keeps
    the chunk, and without it the unfused gap reaches the threshold, the
    chunk is culled and the check finds the pair whose fused distance
    keeps a term."""
    p, tables, own, slab = launches["dam.density"]
    h2 = np.float32(p.consts[0])
    short = dataclasses.replace(p, consts=(float(h2 * np.float32(0.7225)),)
                                + p.consts[1:])
    blocks = sample_blocks(p, tables, seed=0)
    assert violations(p, tables, own, slab, blocks) == 0
    assert violations(p, tables, own, slab, blocks, model=short) > 0

    i32 = torch.int32
    blocks = torch.zeros(1, dtype=torch.long)
    for name in ("dam.density", "dam.viscsurf"):
        p = dataclasses.replace(launches[name][0], n_blocks=1)
        row, col = near_miss(p)
        own = torch.from_numpy(row[:, None].copy())      # one live row
        slab = torch.full((3, p.ccol), 1e4, dtype=torch.float32)
        slab[:, 0] = torch.from_numpy(col)
        tables = (torch.zeros(3, dtype=i32), torch.zeros(3, dtype=i32),
                  torch.full((3,), p.ccol, dtype=i32),
                  torch.tensor([0, 1, 1], dtype=i32),
                  torch.ones(1, dtype=i32), torch.zeros(1, dtype=i32))
        with monkeypatch.context() as m:
            keep, _ = pk.cull_chunks(p, tables, own, slab, blocks)
            assert bool(keep[0, 0, 0, 0]), name
            assert violations(p, tables, own, slab, blocks) == 0, name
            m.setattr(pk, "CULL_MARGIN", 0.0)
            keep, _ = pk.cull_chunks(p, tables, own, slab, blocks)
            assert not bool(keep[0, 0, 0, 0]), name
            assert violations(p, tables, own, slab, blocks) == 1, name


def test_ring_cull_configuration():
    """Each kind's threshold lies above its reach by its margin, at most
    one f32 ulp more (rounded up): density and rho* h^2, viscsurf,
    boundary and membrane their exit's reach, paccel h^2 with the wider
    rsqrtf margin. The chunk divides ALIGN (the tables' tile offsets are
    its multiples) and holds whole rounds of every kind's 4-column groups
    (so a part keeps its columns). A lane tests a chunk: a tile of 32
    chunks (ccol 512) culls, one column within reach in chunk 20 keeping
    that chunk alone; a wider one (ccol 1024) runs the unculled kernel,
    every chunk kept untested. The box kernel's buffer serves
    every launch while it is large enough and grows by a quarter, keeping
    the smaller one."""
    kw = dict(block=256, ccol=256, n_blocks=1, inv_h2=np.float32(
        1 / PARAMS.h ** 2), c_rho=1.0)
    passes = dict(
        density=pk.make_density_pass(**kw),
        rho_star=pk.make_rho_star_pass(raw=True, **kw),
        viscsurf=pk.make_viscsurf_pass(**kw),
        paccel=pk.make_paccel_pass(inv_h=np.float32(1 / PARAMS.h),
                                   rho0_delta=1.0, **kw),
        boundary=pk.make_boundary_pass(r0=PARAMS.r0, **kw),
        membrane=pk.make_membrane_pass(r0=PARAMS.r0, **kw))
    assert set(passes) == set(pk.RING)
    assert pk.CHUNK > 0 and pk.ALIGN % pk.CHUNK == 0
    for kind, p in passes.items():
        reach = (p.consts[0] ** 2 if kind == "paccel" else p.consts[0]
                 if kind in ("density", "rho_star") else p.consts[-1])
        margin = (pk.CULL_MARGIN_RSQRT if kind == "paccel"
                  else pk.CULL_MARGIN)
        t = p.cull_reach
        assert t == float(np.float32(t)), kind
        assert reach * (1 + margin) <= t, kind
        assert t <= float(np.nextafter(np.float32(reach * (1 + margin)),
                                       np.float32(np.inf))), kind
        assert margin >= 16 * U
        assert pk.CHUNK % (4 * pk.RING[kind].tpr) == 0, kind

    i32 = torch.int32
    own = torch.full((3, 1), 10.0)
    for ccol in (512, 1024):
        p = dataclasses.replace(passes["density"], ccol=ccol)
        slab = torch.full((3, ccol), 1e4)
        slab[:, 20 * pk.CHUNK + 3] = torch.tensor([10.0, 10.0,
                                                   10.0 + PARAMS.h / 2])
        tables = (torch.zeros(3, dtype=i32), torch.zeros(3, dtype=i32),
                  torch.full((3,), ccol, dtype=i32),
                  torch.tensor([0, 1, 1], dtype=i32),
                  torch.ones(1, dtype=i32), torch.zeros(1, dtype=i32))
        keep, tested = pk.cull_chunks(p, tables, own, slab,
                                      torch.zeros(1, dtype=torch.long))
        keep, tested = keep[0, 0, 0], tested[0, 0, 0]
        assert p.culls == (ccol == 512) and keep.shape == (ccol // pk.CHUNK,)
        assert bool(tested.all()) == p.culls and bool(tested.any()) == p.culls
        assert keep.nonzero().flatten().tolist() == (
            [20] if p.culls else list(range(ccol // pk.CHUNK)))

    dev = torch.device("cpu")
    bufs = pk._BOXES.pop(dev, None)
    try:
        a = pk.box_buffer(dev, 40)
        assert a.shape == (50, 8) and a.dtype == torch.float32
        assert pk.box_buffer(dev, 50) is a
        b = pk.box_buffer(dev, 51)
        assert b.shape == (63, 8) and b.data_ptr() != a.data_ptr()
        assert [id(x) for x in pk._BOXES[dev]] == [id(a), id(b)]
    finally:
        pk._BOXES.pop(dev, None)
        if bufs is not None:
            pk._BOXES[dev] = bufs


def test_unculled_entries_only_in_the_chip_check():
    """The ring kernels without the cull (``sph_pair_<kind>_nocull``) are
    declared by the loader and called by ``chip_smoke.py`` alone; the
    shipped entry points take the cull's three arguments besides."""
    from pathlib import Path
    import re

    from sph_tpu_torch.ops import _build

    root = Path(pk.__file__).resolve().parents[1]
    named = [p.relative_to(root).as_posix() for p in root.rglob("*.py")
             if re.search(r"_nocull\b|\bNOCULL\b", p.read_text())]
    assert named == ["ops/_build.py"]
    smoke = (root.parent / "chip_smoke.py").read_text()
    assert 'entry=f"sph_pair_{p.kind}_nocull"' in smoke
    src = (root / "ops" / "csrc" / "pair_pass.cu").read_text()
    assert set(_build.NOCULL) == {k + "_nocull" for k in pk.RING}
    for kind in pk.RING:
        assert f"int sph_pair_{kind}_nocull(SPH_PAIR_ARGS)" in src
        assert f"int sph_pair_{kind}(SPH_RING_ARGS)" in src


def test_tracer_reads_the_cull_counters(monkeypatch):
    """The device counters reach a snapshot as ``pair.<kind>.chunks`` and
    ``pair.<kind>.culled``, as their change since the record started; a
    launch made with the tracer off passes none (``_call`` asks only while
    it is on); the box launches count as ``launches.chunk_boxes``."""
    from sph_tpu_torch import trace

    buf = torch.zeros((len(pk.RING), 2), dtype=torch.int64)
    monkeypatch.setattr(pk, "_CULL_COUNTS", {torch.device("cpu"): buf})
    monkeypatch.setattr(pk, "BOX_LAUNCHES", {"chunk_boxes": 0})
    i = list(pk.RING).index("paccel")
    buf[i] = torch.tensor([100, 60])
    with trace.tracing():
        buf[i] += torch.tensor([40, 30])
        pk.BOX_LAUNCHES["chunk_boxes"] += 3
        counters = trace.snapshot()["counters"]
    assert counters["pair.paccel.chunks"] == 40
    assert counters["pair.paccel.culled"] == 30
    assert counters["launches.chunk_boxes"] == 3
    assert not any(k.startswith("pair.density") for k in counters)
    assert pk.cull_counters() == {"pair.paccel.chunks": 140,
                                  "pair.paccel.culled": 90}
