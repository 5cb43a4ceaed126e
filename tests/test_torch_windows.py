"""The port's sort, window tables and wall shell against sph_tpu's: every
integer table and shell row must be exactly equal (the Hopper kernels and
the Pallas kernels then stream the same tiles)."""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sph_tpu.config import SimParams as JParams
from sph_tpu.core import fast as JF
from sph_tpu.core import fastw as JW
from sph_tpu.scene import generate_liquid_box_scene as j_box

from sph_tpu_torch.convert import params_from
from sph_tpu_torch.core import fast as F
from sph_tpu_torch.core import fastw as W
from sph_tpu_torch.scene import generate_liquid_box_scene

H = 3.34
OFF = np.array([-2 * H, 1.5 * H, -3 * H], np.float32)


def _case(name):
    """(jax params, port params, jax scene, port scene) for the 8h box, or
    the same box in a world whose box_min is offset (scene shifted)."""
    if name == "box8":
        kw = dict(x_max=8 * H, y_max=8 * H, z_max=8 * H)
    else:
        kw = dict(x_min=float(OFF[0]), x_max=float(OFF[0]) + 8 * H,
                  y_min=float(OFF[1]), y_max=float(OFF[1]) + 8 * H,
                  z_min=float(OFF[2]), z_max=float(OFF[2]) + 8 * H)
    jp = JParams(**kw)
    p = params_from(jp)
    base = dict(x_max=8 * H, y_max=8 * H, z_max=8 * H)
    js = j_box(JParams(**base), fill_fraction=0.5)
    s = generate_liquid_box_scene(params_from(JParams(**base)),
                                  fill_fraction=0.5)
    if name != "box8":
        js.pos = js.pos + OFF
        s.pos = s.pos + OFF
    return jp, p, js, s


@pytest.fixture(scope="module", params=["box8", "offset"])
def case(request):
    jp, p, js, s = _case(request.param)
    jl, lay = js.layout(), s.layout()
    jcfg = JW.compute_fastw_config(js.pos, jp, jl, ptype=js.ptype,
                                   resort_every=2)
    cfg = W.compute_fastw_config(s.pos, p, lay, ptype=s.ptype,
                                 resort_every=2)
    jws = JW.precompute_wall_static(js.pos, js.normal, jp, jl, jcfg)
    ws = W.precompute_wall_static(s.pos, s.normal, p, lay, cfg)
    jparts = JW._make_step_parts_w(jp, jl, jcfg, wall_static=jws)
    parts = W._make_step_parts_w(p, lay, cfg, wall_static=ws)
    jctx, jdiag = jparts[0](*js.device_state())
    ctx, diag = parts.sort_ctx(*s.device_state("cpu"))
    return dict(jp=jp, p=p, js=js, s=s, jcfg=jcfg, cfg=cfg, jws=jws, ws=ws,
                jctx=jctx, jdiag=jdiag, ctx=ctx, diag=diag)


def _eq(t, j, what):
    j = np.asarray(j)
    t = t.cpu().numpy()
    assert t.shape == j.shape, (what, t.shape, j.shape)
    np.testing.assert_array_equal(t, j.astype(t.dtype), err_msg=what)


def test_config_and_shell_cap_equal(case):
    jcfg, cfg = case["jcfg"], case["cfg"]
    skip = {"interpret", "unroll", "scan_chunk", "device"}
    for f in dataclasses.fields(JW.FastWConfig):
        if f.name not in skip:
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    js, s = case["js"], case["s"]
    for d in (1, 2, 3):
        assert (W.measure_shell_cap(s.pos, s.ptype, case["p"], cfg.dims, d)
                == JW.measure_shell_cap(js.pos, js.ptype, case["jp"],
                                        jcfg.dims, d))


def test_precompute_wall_static_equal(case):
    jws, ws = case["jws"], case["ws"]
    assert set(ws) == set(jws)
    for k in jws:
        assert ws[k].dtype in (torch.float32, torch.int32)
        _eq(ws[k], jws[k], k)


@pytest.mark.parametrize("key", ["tables_m", "tables_ms", "tables_sm"])
def test_sort_ctx_window_tables_exact(case, key):
    jt, t = case["jctx"][key], case["ctx"][key]
    assert len(t) == len(jt) == 6
    for i, (a, b) in enumerate(zip(t, jt)):
        assert a.dtype == torch.int32, (key, i)
        _eq(a, b, f"{key}[{i}]")
    # the gated shell tables leave phantom/empty blocks with no tiles
    assert int((t[4] == 0).sum()) > 0


def test_sort_ctx_order_shell_and_diag_exact(case):
    jctx, ctx = case["jctx"], case["ctx"]
    _eq(ctx["order"], jctx["order"], "order")
    _eq(ctx["orig_of_sorted"], jctx["orig_of_sorted"], "orig_of_sorted")
    for i, (a, b) in enumerate(zip(ctx["shell_static"],
                                   jctx["shell_static"])):
        _eq(a, b, f"shell_static[{i}]")
    _eq(ctx["ww_const"], jctx["ww_const"], "ww_const")
    _eq(ctx["bnd_pack"], np.asarray(jctx["bnd_pack"])[:7], "bnd_pack")
    _eq(ctx["shell_pos_pack"], np.asarray(jctx["shell_pos_pack"])[:3],
        "shell_pos_pack")
    for k in ("shell_overflow", "tile_overflow"):
        assert int(case["diag"][k]) == int(case["jdiag"][k]) == 0


def _pencils(seed, n, npen):
    rng = np.random.default_rng(seed)
    return np.sort(rng.integers(0, npen, n)).astype(np.int32)


@pytest.mark.parametrize("seed,n,block,ccol,sub", [
    (0, 1000, 256, 512, None), (1, 2800, 128, 256, 32),
    (2, 700, 256, 128, 8), (3, 1500, 128, 128, 16), (4, 700, 128, 256, 128)])
def test_window_tables_random_pencils(seed, n, block, ccol, sub):
    """The 6-tuple tables, pencil starts and ranges, and the subgroup gate's
    unmerged windows (``gtabs``: None unless 0 < sub < block)."""
    dims = (7, 5, 9)
    nb = -(-(-(-n // block)) // 8) * 8
    kw = dict(n_particles=n, n_blocks=nb, block=block, ccol=ccol, dims=dims,
              sub=sub)
    pen = _pencils(seed, n, dims[0] * dims[2])
    jt, jps, jpr, jg = JF._window_tables(jnp.asarray(pen),
                                         JF.FastConfig(**kw))
    t, ps, pr, g = F._window_tables(torch.as_tensor(pen),
                                    F.FastConfig(**kw))
    for i, (a, b) in enumerate(zip(t, jt)):
        _eq(a, b, f"tables[{i}]")
    _eq(ps, jps, "pstart")
    for a, b in zip(pr, jpr):
        _eq(a, b, "pencil_ranges")
    assert (g is None) == (jg is None) == (sub in (None, block))
    if g is not None:
        for a, b in zip(g, jg):
            assert a.dtype == torch.int32
            _eq(a, b, "gtabs")
        assert g[0].shape == (nb * 3 * (block // sub),)
        # a group's windows lie inside its block's pencil-band range
        lo = t[1].reshape(nb, 3)[:, :1].long()
        assert bool((g[0].reshape(nb, -1) >= lo).all())
    assert int((t[4] == 0).sum()) > 0      # phantom blocks
    # pad to the pack width: F._pad_field matches JF._pad_field
    x = np.arange(n, dtype=np.float32)
    _eq(F._pad_field(torch.as_tensor(x), F.FastConfig(**kw), 7.0),
        JF._pad_field(jnp.asarray(x), JF.FastConfig(**kw), 7.0), "pad")


@pytest.mark.parametrize("seed", [0, 1])
def test_fast_config_and_tile_stats_random(seed):
    """compute_fast_config and tile_table_stats equal sph_tpu's on random
    positions, in a world whose box_min is offset."""
    rng = np.random.default_rng(seed)
    kw = dict(x_min=float(OFF[0]), x_max=float(OFF[0]) + 9 * H,
              y_min=float(OFF[1]), y_max=float(OFF[1]) + 6 * H,
              z_min=float(OFF[2]), z_max=float(OFF[2]) + 14 * H)
    jp = JParams(**kw)
    p = params_from(jp)
    lo = np.array([kw["x_min"], kw["y_min"], kw["z_min"]])
    ext = np.array([9 * H, 6 * H, 14 * H])
    pos = (lo + rng.uniform(0.0, 1.0, (3000 + 500 * seed, 3)) * ext).astype(
        np.float32)
    for ckw in (dict(), dict(block=128, ccol=128, sub=32, ccol_c=128,
                             resort_every=5, block_multiple=16)):
        jcfg = JF.compute_fast_config(pos, jp, interpret=True, **ckw)
        cfg = F.compute_fast_config(pos, p, **ckw)
        for f in dataclasses.fields(F.FastConfig):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
        assert cfg.ccol_compact == jcfg.ccol_compact
        assert cfg.n_alloc == jcfg.n_alloc
        stats = F.tile_table_stats(pos, p, cfg)
        assert stats == JF.tile_table_stats(pos, jp, jcfg)
        assert stats[0] > 0 and stats[1] >= stats[0]


@pytest.mark.parametrize("seed", [0, 1])
def test_cross_tables_gate_overflow_random(seed):
    rng = np.random.default_rng(seed)
    nx, npen, nb, ccol = 6, 48, 16, 256
    first = rng.integers(0, npen, nb).astype(np.int32)
    last = np.minimum(first + rng.integers(0, 8, nb), npen - 1).astype(
        np.int32)
    pstart = np.concatenate(
        [[0], np.cumsum(rng.integers(0, 300, npen))]).astype(np.int32)
    active = rng.random(nb) < 0.7
    jt = JW._gate(JW._cross_tables(jnp.asarray(first), jnp.asarray(last),
                                   jnp.asarray(pstart), nx, npen, nb, ccol),
                  jnp.asarray(active))
    t = W._gate(W._cross_tables(torch.as_tensor(first),
                                torch.as_tensor(last),
                                torch.as_tensor(pstart), nx, npen, nb, ccol),
                torch.as_tensor(active))
    for i, (a, b) in enumerate(zip(t, jt)):
        _eq(a, b, f"cross[{i}]")
    for c in (128, 512, 4096):
        assert (int(W._table_overflow(t, c, nb))
                == int(JW._table_overflow(jt, c, nb)))
    # tables with counts beyond the TPU driver's caps are counted alike
    big = tuple(t[:4]) + (torch.full((nb,), 40, dtype=torch.int32), t[5])
    jbig = tuple(jt[:4]) + (jnp.full((nb,), 40, jnp.int32), jt[5])
    assert int(W._table_overflow(big, 512, nb)) \
        == int(JW._table_overflow(jbig, 512, nb)) > 0


@pytest.mark.parametrize("dilate", [1, 2])
def test_shell_of_random(dilate):
    rng = np.random.default_rng(dilate)
    dims = (9, 5, 12)
    ncell = dims[0] * dims[1] * dims[2]
    cid_m = rng.integers(0, ncell, 5).astype(np.int32)
    cid_w = np.sort(rng.integers(0, ncell, 300)).astype(np.int32)
    kw = dict(n_mov=40, n_wall=300, mov_lo=0, wall_lo=40, wall_hi=340,
              n_blocks=8, n_blocks_s=8, block=256, ccol=512, dims=dims,
              dilate=dilate)
    jflag = JW._shell_of(jnp.asarray(cid_m), jnp.asarray(cid_w),
                         JW.FastWConfig(**kw))
    flag = W._shell_of(torch.as_tensor(cid_m), torch.as_tensor(cid_w),
                       W.FastWConfig(**kw))
    _eq(flag, jflag, "shell flag")
    assert 0 < int(flag.sum()) < 300
