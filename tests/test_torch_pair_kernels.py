"""The port's plain pair passes against sph_tpu's Pallas passes (interpret
mode) and against an f64 NumPy oracle written here, on identical packs and
tables.

Inputs are what the port's fastw engine hands each of its eight pass
instances in one step of the 8h box (fill 0.5) from a seeded state whose
liquid is kicked toward the floor, so every pass sees wall contact and
pressure.

Tolerances are per output, scaled by the oracle's max over the components
of the output's vector (``pair_kernels.OUTPUT_GROUPS``):

* port vs oracle, every row: 2e-6 (f32 sums of the same terms);
* port vs Pallas: rho* 1e-5 (both sum exact f32 terms), the others 1e-4,
  the noise of the bf16-split MXU reductions
  (``sph_tpu/ops/pair_kernels.py:_dotT``), on every row with one named
  exception: the surface sums of the viscsurf pass on own PAD rows (rows
  past the particle count; they carry ``far`` positions and the engine
  discards their outputs). A pad row pairs with the slab's pad columns at
  distance 0, so its exact surface sum is 0; the Pallas reduction centres
  each tile on the tile's first (real) column and sums offsets of ~``far``
  through a bf16 split, leaving up to 1e-2 of the output's scale there. On
  those rows the port and the oracle must both be exactly 0.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sph_tpu.ops import pair_kernels as jpk

from sph_tpu_torch.config import SimParams
from sph_tpu_torch.constants import BOUNDARY_PARTICLE
from sph_tpu_torch.core import fastw as W
from sph_tpu_torch.ops import pair_kernels as pk
from sph_tpu_torch.scene import generate_liquid_box_scene

H = 3.34
ORACLE_TOL = 2e-6
TOL = {"rho_star": 1e-5, "viscsurf": 1e-4, "paccel": 1e-4, "boundary": 1e-4}
# kind -> outputs held against Pallas on real own rows only (see above)
SURFACE = {"viscsurf": (3, 4, 5)}
PASS_NAMES = ["raw_mm", "raw_ms", "raw_sm", "visc_mm", "visc_ms",
              "pacc_mm", "pacc_ms", "bnd_ms"]


def kick_box_scene(scene, params, seed=0, jitter=0.35, drop=3.4,
                   speed=2.0, noise=0.3):
    """Jitter the scene's moving particles by up to ``jitter`` r0, lower
    them by ``drop`` units and kick them down at ``speed`` m/s (plus
    Gaussian ``noise``), in place. At the defaults some liquid pairs, and
    some liquid-wall pairs, lie closer than h/4 (the pressure pass's close
    branch). Works on sph_tpu's and the port's ``Scene`` alike."""
    rng = np.random.default_rng(seed)
    moving = scene.ptype != BOUNDARY_PARTICLE
    n = int(moving.sum())
    scene.pos[moving] += rng.uniform(-jitter, jitter, (n, 3)).astype(
        np.float32) * np.float32(params.r0)
    scene.pos[moving, 1] -= np.float32(drop)
    scene.vel[moving] = (rng.normal(0.0, noise, (n, 3))
                         + (0.0, -speed, 0.0)).astype(np.float32)
    return scene


def kicked_box_state(seed=0):
    """(params, layout, cfg, wall_static, state, springs, membranes) of the
    kicked 8h box."""
    params = SimParams(x_max=8 * H, y_max=8 * H, z_max=8 * H)
    scene = kick_box_scene(generate_liquid_box_scene(params,
                                                     fill_fraction=0.5),
                           params, seed)
    layout = scene.layout()
    cfg = W.compute_fastw_config(scene.pos, params, layout,
                                 ptype=scene.ptype)
    ws = W.precompute_wall_static(scene.pos, scene.normal, params, layout,
                                  cfg)
    return (params, layout, cfg, ws) + scene.device_state("cpu")


@pytest.fixture(scope="module")
def recorded():
    """name -> (PairPass, tables, own, slab): the last call of each pair
    pass in one sort + step of the port on CPU."""
    params, layout, cfg, ws, state, springs, membranes = kicked_box_state()
    parts = W._make_step_parts_w(params, layout, cfg, wall_static=ws)
    calls = W.record_step_inputs(parts, state, springs, membranes)
    assert sorted(calls) == sorted(PASS_NAMES)
    return params, calls


def jax_pass(p: pk.PairPass, params):
    """The sph_tpu Pallas pass (interpret mode) configured like ``p``."""
    inv_h2 = np.float32(1.0 / (params.h * params.h))
    kw = dict(block=p.block, ccol=p.ccol, n_blocks=p.n_blocks,
              inv_h2=inv_h2, interpret=True)
    if p.kind == "rho_star":
        return jpk.make_rho_star_pass(c_rho=np.float32(params.c_rho),
                                      raw=True, **kw)
    if p.kind == "viscsurf":
        return jpk.make_viscsurf_pass(**kw)
    if p.kind == "paccel":
        return jpk.make_paccel_pass(
            inv_h=np.float32(1.0 / params.h),
            rho0_delta=np.float32(params.rho0 * params.delta), **kw)
    return jpk.make_boundary_pass(r0=np.float32(params.r0), **kw)


def jax_pack(t):
    """A port pack as the TPU layout: rows padded to the 8-row tile."""
    a = t.numpy()
    pad = -a.shape[0] % 8
    return jnp.asarray(np.pad(a, ((0, pad), (0, 0))))


def oracle_terms(kind, params, o, s):
    """Each output's f64 pair terms of one own block: ``o`` own pack rows
    [k, B, 1], ``s`` slab pack rows [k, 1, C] (sph_tpu's pass docstrings,
    with constants from ``params`` in f64)."""
    h = params.h
    d = o[:3] - s[:3]
    if kind == "boundary":                  # distances from the new x_i
        d = o[3:6] - s[:3]
    r2 = (d * d).sum(0)
    r = np.sqrt(r2)
    if kind == "rho_star":
        return [np.maximum(h * h - r2, 0.0) ** 3]
    if kind == "viscsurf":
        wv = np.maximum(h - r, 0.0) * s[6] / h          # row 6 holds 1/rho
        return ([wv * (s[3 + k] - o[3 + k]) for k in range(3)]
                + [(r2 < h * h) * d[k] for k in range(3)])
    if kind == "paccel":
        cm = h / 4.0 - r
        term = np.where(cm > 0.0, cm * cm * params.rho0 * params.delta,
                        np.maximum(h - r, 0.0) ** 2 * (o[4] + s[4])) * s[3]
        w = np.where(r2 > 0.0, term / np.where(r2 > 0.0, r, 1.0), 0.0)
        return [w * d[k] * 0.5 / (h * h) for k in range(3)]
    r0 = params.r0
    w = np.maximum(0.0, (r0 - r) / r0) * s[6]           # row 6: isb
    return [w * s[3 + k] for k in range(3)] + [w, w * (r0 - r)]


def block_pairs(p: pk.PairPass, tables, own, slab):
    """(b, own rows [k, B, 1], slab columns [k, 1, C]) in f64 for each own
    block b with tiles: every column of every tile the tables list (tile t
    of block b starts at aln[c] + (t - s0[c]) * ccol, c = 3b + #{s0[3b+1],
    s0[3b+2] <= t})."""
    aln, _, _, s0, cnt, ob = (t.numpy().astype(np.int64) for t in tables)
    o64 = own.numpy().astype(np.float64)
    s64 = slab.numpy().astype(np.float64)
    for b in range(p.n_blocks):
        tiles = []
        for t in range(cnt[b]):
            c = 3 * b + int(t >= s0[3 * b + 1]) + int(t >= s0[3 * b + 2])
            tiles.append(aln[c] + (t - s0[c]) * p.ccol + np.arange(p.ccol))
        if not tiles:
            continue
        cols = np.concatenate(tiles)
        cols = cols[cols < s64.shape[1]]
        rows = ob[0] + b * p.block + np.arange(p.block)
        yield b, o64[:, rows][:, :, None], s64[:, cols][:, None, :]


def oracle(p: pk.PairPass, params, tables, own, slab):
    """f64 sums of each output's pair terms, block by block."""
    out = np.zeros((pk._SPECS[p.kind][0], p.n_pad))
    for b, o, s in block_pairs(p, tables, own, slab):
        for k, t in enumerate(oracle_terms(p.kind, params, o, s)):
            out[k, b * p.block:(b + 1) * p.block] = t.sum(-1)
    return list(out)


def run_both(p, params, tables, own, slab):
    """(port outputs, Pallas outputs, f64 oracle) as numpy lists."""
    ref = jax_pass(p, params)(tuple(jnp.asarray(t.numpy()) for t in tables),
                              jax_pack(own), jax_pack(slab))
    out = p(tables, own, slab)

    def lst(x):
        return [np.asarray(a) for a in (x if isinstance(x, tuple) else (x,))]

    return lst(out), lst(ref), oracle(p, params, tables, own, slab)


def own_pad_rows(p, params, tables, own):
    """Own rows past the particle count: they sit at ``far``, beyond the
    box."""
    ob = int(tables[5][0])
    x = own[0, ob:ob + p.n_pad].numpy()
    return x > max(params.x_max, params.y_max, params.z_max)


def assert_close(p, params, tables, own, out, ref, orc):
    assert len(out) == len(ref) == len(orc) == pk._SPECS[p.kind][0]
    pad = own_pad_rows(p, params, tables, own)
    for group in pk.OUTPUT_GROUPS[p.kind]:
        scale = max(float(np.abs(orc[i]).max()) for i in group)
        assert scale > 0.0, (p.kind, group)       # no zeros-vs-zeros
        for i in group:
            assert out[i].shape == ref[i].shape == (p.n_pad,)
            assert out[i].dtype == np.float32
            err = float(np.abs(out[i] - orc[i]).max())
            assert err <= ORACLE_TOL * scale, (
                "port vs oracle", p.kind, i, err, scale)
            rows = slice(None)
            if i in SURFACE.get(p.kind, ()):
                rows = ~pad
                assert not orc[i][pad].any() and not out[i][pad].any()
            err = float(np.abs(out[i][rows] - ref[i][rows]).max())
            assert err <= TOL[p.kind] * scale, (
                "port vs pallas", p.kind, i, err, scale)


@pytest.mark.parametrize("name", PASS_NAMES)
def test_plain_pass_matches_pallas(recorded, name):
    params, calls = recorded
    p, tables, own, slab = calls[name]
    before = dict(pk.LAUNCHES)
    out, ref, orc = run_both(p, params, tables, own, slab)
    assert pk.LAUNCHES == before          # CPU tensors: no kernel launch
    assert_close(p, params, tables, own, out, ref, orc)
    if p.kind == "paccel":               # both branches of the pair weight
        r = np.concatenate([np.sqrt(((o[:3] - s[:3]) ** 2).sum(0)).ravel()
                            for _, o, s in block_pairs(p, tables, own, slab)])
        assert ((r > 0) & (r < params.h / 4)).sum() > 0
        assert ((r > params.h / 4) & (r < params.h)).sum() > 0


@pytest.mark.parametrize("name", ["raw_mm", "bnd_ms"])
def test_zero_tile_blocks(recorded, name):
    """Blocks with a zero tile count (phantom blocks past the particle
    count, gated blocks, and here a real block switched off) sum nothing:
    exactly 0 in both packages, other blocks unchanged."""
    params, calls = recorded
    p, tables, own, slab = calls[name]
    cnt = tables[4].clone()
    live = torch.nonzero(cnt > 0).reshape(-1)
    assert len(live) >= 2 and int((cnt == 0).sum()) > 0
    off = int(live[0])
    cnt[off] = 0
    gated = tuple(tables[:4]) + (cnt, tables[5])
    out, ref, orc = run_both(p, params, gated, own, slab)
    assert_close(p, params, gated, own, out, ref, orc)
    full = p(tables, own, slab)
    full = full if isinstance(full, tuple) else (full,)
    rows = slice(off * p.block, (off + 1) * p.block)
    for o, r, f in zip(out, ref, full):
        zero = torch.nonzero(cnt == 0).reshape(-1)
        for b in zero.tolist():
            blk = slice(b * p.block, (b + 1) * p.block)
            assert not o[blk].any() and not np.asarray(r)[blk].any()
        keep = np.ones(o.shape[0], bool)
        keep[rows] = False
        np.testing.assert_array_equal(o[keep], f.numpy()[keep])


def test_dispatch_and_input_checks(recorded):
    params, calls = recorded
    p, tables, own, slab = calls["raw_mm"]
    with pytest.raises(ValueError):
        p(tables, own.to("meta"), slab.to("meta"))
    with pytest.raises(ValueError):        # f64 packs are refused
        p.kernel(tables, own.double(), slab.double())
    with pytest.raises(ValueError):        # int64 tables are refused
        p.kernel(tuple(t.long() for t in tables), own, slab)
    with pytest.raises(ValueError):        # too few pack rows
        p.kernel(tables, own[:2].contiguous(), slab)


def test_rho_star_clamped_wrapper(recorded):
    """raw=False applies c_rho * max((s - (h^2)^3) / h^6, 1) like sph_tpu."""
    params, calls = recorded
    p, tables, own, slab = calls["raw_mm"]
    inv_h2 = np.float32(1.0 / (params.h * params.h))
    kw = dict(block=p.block, ccol=p.ccol, n_blocks=p.n_blocks,
              inv_h2=inv_h2, c_rho=np.float32(params.c_rho))
    out = pk.make_rho_star_pass(**kw)(tables, own, slab).numpy()
    ref = np.asarray(jpk.make_rho_star_pass(interpret=True, **kw)(
        tuple(jnp.asarray(t.numpy()) for t in tables), jax_pack(own),
        jax_pack(slab)))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_kernels_match_plain_on_cuda(recorded):
    """On a CUDA card: each Hopper kernel against its plain version on the
    same inputs (1e-5 of the output vector's max magnitude)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    params, calls = recorded
    for name, (p, tables, own, slab) in calls.items():
        cu = [t.cuda() for t in tables]
        before = pk.LAUNCHES[p.kind]
        k = p(cu, own.cuda(), slab.cuda())
        assert pk.LAUNCHES[p.kind] == before + 1
        r = p.plain(tables, own, slab)
        k = [t.cpu().numpy() for t in (k if isinstance(k, tuple) else (k,))]
        r = [t.numpy() for t in (r if isinstance(r, tuple) else (r,))]
        for group in pk.OUTPUT_GROUPS[p.kind]:
            scale = max(float(np.abs(r[i]).max()) for i in group)
            for i in group:
                assert np.abs(k[i] - r[i]).max() <= 1e-5 * scale, (name, i)


def test_pass_constants_match_jax_wrappers():
    """The f32 constants handed to the kernels are the JAX wrappers' own
    (same expressions, same rounding)."""
    params = SimParams()
    inv_h2 = np.float32(1.0 / (params.h * params.h))
    inv_h = np.float32(1.0 / params.h)
    kw = dict(block=256, ccol=512, n_blocks=8, inv_h2=inv_h2)
    rho = pk.make_rho_star_pass(c_rho=1.0, raw=True, **kw)
    assert rho.consts == (float(np.float32(1.0) / inv_h2),)
    visc = pk.make_viscsurf_pass(**kw)
    assert visc.consts[2] == float(np.float32(np.sqrt(inv_h2)))
    pacc = pk.make_paccel_pass(inv_h=inv_h, rho0_delta=np.float32(
        params.rho0 * params.delta), **kw)
    assert pacc.consts[3] == float(np.float32(0.5) * inv_h * inv_h)
    bnd = pk.make_boundary_pass(r0=np.float32(params.r0), **kw)
    r0 = np.float32(params.r0)
    assert bnd.consts == (float(r0), float(np.float32(1.0 / r0)))
    assert dataclasses.replace(bnd, ccol=256).ccol == 256
