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

The fast engine's passes (the time-t density, rho* on the iteration pack,
viscsurf and paccel, all four subgroup-gated at sub 32, and the boundary
pass) are recorded the same way from one step of the port's fast engine on
the kicked box at block 128, ccol 128; the oracle applies the gate of each
row's subgroup as its docstring in ``sph_tpu/ops/pair_kernels.py`` states
it (a tile counts for a group when it overlaps one of the group's three
windows), and the density pass is also held ungated.

The spring and membrane passes run on synthetic packs and tables made here
from a seed (``elastic_inputs``): a cloud of own rows of which a sorted
subset is the compact elastic slab, with partner lists that hold pads, a
partner listed twice, a coincident partner and nonzero activation terms,
triangle slots that hold 0 to 7 triangles per column and one triangle whose
plane passes exactly through an own row (s == 0), and tables whose blocks
stream all, some or none of the slab's tiles (so some own rows meet no
partner). Same bounds: 2e-6 against the oracle, 1e-4 against Pallas.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sph_tpu.ops import pair_kernels as jpk

from sph_tpu_torch.config import SimParams
from sph_tpu_torch.constants import BOUNDARY_PARTICLE
from sph_tpu_torch.core import fast as F
from sph_tpu_torch.core import fastw as W
from sph_tpu_torch.ops import pair_kernels as pk
from sph_tpu_torch.scene import generate_liquid_box_scene

# The suite runs in several worker processes at once (pytest-xdist): each
# takes its share of the cores for torch's CPU kernels, or the workers'
# thread pools oversubscribe the host and spin against each other (a torch
# test file ran 8x slower beside one other busy process). Every worker
# imports this module when it collects the tests.
_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
torch.set_num_threads(max(1, (os.cpu_count() or 1) // _WORKERS))

# The first parallel op of a process that takes a square root has, on some
# hosts, returned ~3e-4-relative results in one worker thread's chunk (5 of
# 60 fresh processes with torch 2.13 + OpenMP on an AVX-512 host: torch.sqrt
# as the first op; never when another parallel op ran first, 0 of 80; later
# calls are exact). One cheap parallel op at import keeps that host fault
# out of every comparison of this file and of those that import it.
torch.rand(1 << 20).mul_(2.0)

H = 3.34
ORACLE_TOL = 2e-6
TOL = {"density": 1e-5, "rho_star": 1e-5, "viscsurf": 1e-4, "paccel": 1e-4, "boundary": 1e-4,
       "spring": 1e-4, "membrane": 1e-4}
# kind -> outputs held against Pallas on real own rows only (see above)
SURFACE = {"viscsurf": (3, 4, 5)}
PASS_NAMES = ["raw_mm", "raw_ms", "raw_sm", "visc_mm", "visc_ms",
              "pacc_mm", "pacc_ms", "bnd_ms"]
# the fast engine's passes (gated at FAST_SUB but the boundary pass)
FAST_NAMES = ["density", "rho_star", "viscsurf", "paccel", "boundary"]
FAST_SUB = 32


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


@pytest.fixture(scope="module")
def recorded_fast():
    """name -> (PairPass, tables, own, slab): the last call of each pair
    pass in one sort + step of the port's fast engine on CPU (gated)."""
    params, layout, _, _, state, springs, membranes = kicked_box_state()
    cfg = F.compute_fast_config(state.pos, params, block=128, ccol=128,
                                sub=FAST_SUB)
    calls = F.record_step_inputs(F._make_step_parts(params, layout, cfg),
                                 state, springs, membranes)
    assert sorted(calls) == sorted(FAST_NAMES)
    for name, (p, tables, *_) in calls.items():
        assert p.gated == (name != "boundary")
        assert len(tables) == (8 if p.gated else 6)
    return params, calls


def jax_pass(p: pk.PairPass, params, name=None):
    """The sph_tpu Pallas pass (interpret mode) configured like ``p``
    (``name`` "rho_star": the density kind as sph_tpu's non-raw rho*)."""
    inv_h2 = np.float32(1.0 / (params.h * params.h))
    kw = dict(block=p.block, ccol=p.ccol, n_blocks=p.n_blocks,
              inv_h2=inv_h2, interpret=True, sub=p.sub)
    c_rho = np.float32(params.c_rho)
    if p.kind == "density":
        make = (jpk.make_rho_star_pass if name == "rho_star"
                else jpk.make_density_pass)
        return make(c_rho=c_rho, **kw)
    if p.kind == "rho_star":
        return jpk.make_rho_star_pass(c_rho=c_rho, raw=True, **kw)
    if p.kind == "viscsurf":
        return jpk.make_viscsurf_pass(**kw)
    if p.kind == "paccel":
        return jpk.make_paccel_pass(
            inv_h=np.float32(1.0 / params.h),
            rho0_delta=np.float32(params.rho0 * params.delta), **kw)
    if p.kind == "spring":
        return jpk.make_spring_pass(
            inv_h=np.float32(1.0 / params.h),
            h_scale=np.float32(params.h * params.simulation_scale),
            k_spring=np.float32(params.k_spring), n_slots=p.n_slots, **kw)
    if p.kind == "membrane":
        return jpk.make_membrane_pass(r0=np.float32(params.r0), **kw)
    return jpk.make_boundary_pass(r0=np.float32(params.r0), **kw)


def jax_pack(t):
    """A port pack as the TPU layout: rows padded to the 8-row tile."""
    a = t.numpy()
    pad = -a.shape[0] % 8
    return jnp.asarray(np.pad(a, ((0, pad), (0, 0))))


def spring_terms(params, o, s, gid, n_slots):
    """f64 spring + muscle force terms: own row i pairs with column j once
    per slot of j that lists i; force along x_i - x_j of magnitude
    -(r - rest) k - actf per matched slot, r in meters."""
    d = o[:3] - s[:3]
    r = np.sqrt((d * d).sum(0))                              # sim units
    coef = 0.0
    for k in range(n_slots):
        m = s[3 + k] == gid
        coef = coef + m * (
            -(r * params.simulation_scale - s[3 + n_slots + k])
            * params.k_spring - s[3 + 2 * n_slots + k])
    unit = d / np.where(r > 0.0, r, 1.0)
    return [np.where(r > 0.0, coef * unit[k], 0.0) for k in range(3)]


def membrane_terms(params, o, s):
    """f64 membrane terms: per pair the unit normals of the column's
    triangles, each signed by the side of its plane the own row's new
    position lies on, averaged over the triangles counted; weight by the
    new-position distance within r0."""
    r0 = params.r0
    xn = o[3:6]
    cnt, v = 0.0, 0.0
    for t in range(7):
        nt, at = s[6 * t:6 * t + 3], s[6 * t + 3:6 * t + 6]
        side = ((xn - at) * nt).sum(0)
        sgn = np.where((nt * nt).sum(0) > 0.0, np.sign(side), 0.0)
        cnt = cnt + np.abs(sgn)
        v = v + sgn * nt
    d = xn - s[42:45]
    dist = np.sqrt((d * d).sum(0))
    w = np.where(cnt > 0, np.maximum(0.0, (r0 - dist) / r0), 0.0)
    mean = v / np.maximum(cnt, 1.0)
    return [w * mean[k] for k in range(3)] + [w, w * (r0 - dist)]


def oracle_terms(p, params, o, s, gid):
    """Each output's f64 pair terms of one own block: ``o`` own pack rows
    [k, B, 1], ``s`` slab pack rows [k, 1, C], ``gid`` the own rows' sorted
    ids [B, 1] (sph_tpu's pass docstrings, with constants from ``params``
    in f64)."""
    kind = p.kind
    if kind == "spring":
        return spring_terms(params, o, s, gid, p.n_slots)
    if kind == "membrane":
        return membrane_terms(params, o, s)
    h = params.h
    d = o[:3] - s[:3]
    if kind == "boundary":                  # distances from the new x_i
        d = o[3:6] - s[:3]
    r2 = (d * d).sum(0)
    r = np.sqrt(r2)
    if kind in ("density", "rho_star"):     # density: raw sums, see oracle
        return [np.maximum(h * h - r2, 0.0) ** 3]
    if kind == "viscsurf":
        wv = np.maximum(h - r, 0.0) * s[6] / h          # row 6 holds 1/rho
        # the surface sum's pair set is the f32 test r^2 < h^2 of the
        # passes: a step at r = h, where f64 and f32 disagree on pairs at
        # exactly h (walls on the lattice, two r0 apart)
        f = np.float32
        d32 = o[:3].astype(f) - s[:3].astype(f)
        r2_32 = d32[0] * d32[0] + d32[1] * d32[1] + d32[2] * d32[2]
        near = r2_32 < f(1.0) / f(1.0 / (params.h * params.h))
        return ([wv * (s[3 + k] - o[3 + k]) for k in range(3)]
                + [near * d[k] for k in range(3)])
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
    """(b, own rows [k, B, 1], slab columns [k, 1, C], own ids [B, 1], gate
    [B, C]) in f64 for each own block b with tiles: every column of every
    tile the tables list (tile t of block b starts at off = aln[c] + (t -
    s0[c]) * ccol, c = 3b + #{s0[3b+1], s0[3b+2] <= t}). ``gate`` says which
    (row, column) terms count: all of them, or for a gated pass those of the
    tiles that overlap one of the row's subgroup's three windows [glo, ghi)
    (glo/ghi at (3b + dz) * ng + g, ng = block / sub)."""
    aln, _, _, s0, cnt, ob = (t.numpy().astype(np.int64) for t in tables[:6])
    if p.gated:
        ng = p.block // p.sub
        glo, ghi = (t.numpy().astype(np.int64).reshape(p.n_blocks, 3, ng)
                    for t in tables[6:8])
    o64 = own.numpy().astype(np.float64)
    s64 = slab.numpy().astype(np.float64)
    for b in range(p.n_blocks):
        tiles, gates = [], []
        for t in range(cnt[b]):
            c = 3 * b + int(t >= s0[3 * b + 1]) + int(t >= s0[3 * b + 2])
            off = aln[c] + (t - s0[c]) * p.ccol
            tiles.append(off + np.arange(p.ccol))
            hit = np.ones(p.block, bool)
            if p.gated:
                hit = np.repeat(((ghi[b] > off) & (glo[b] < off + p.ccol))
                                .any(0), p.sub)
            gates.append(np.repeat(hit[:, None], p.ccol, 1))
        if not tiles:
            continue
        cols = np.concatenate(tiles)
        keep = cols < s64.shape[1]
        cols = cols[keep]
        rows = ob[0] + b * p.block + np.arange(p.block)
        yield (b, o64[:, rows][:, :, None], s64[:, cols][:, None, :],
               rows[:, None].astype(np.float64),
               np.concatenate(gates, 1)[:, keep])


def density_of(params, s):
    """f64 density from raw sums: c_rho max((s - (h^2)^3) / h^6, 1)."""
    h6 = params.h ** 6
    return params.c_rho * np.maximum((s - h6) / h6, 1.0)


def oracle(p: pk.PairPass, params, tables, own, slab):
    """f64 sums of each output's pair terms, block by block."""
    out = np.zeros((pk._SPECS[p.kind][0], p.n_pad))
    for b, o, s, gid, gate in block_pairs(p, tables, own, slab):
        for k, t in enumerate(oracle_terms(p, params, o, s, gid)):
            out[k, b * p.block:(b + 1) * p.block] = (t * gate).sum(-1)
    if p.kind == "density":
        out = density_of(params, out)
    return list(out)


def run_both(p, params, tables, own, slab, name=None):
    """(port outputs, Pallas outputs, f64 oracle) as numpy lists."""
    ref = jax_pass(p, params, name)(
        tuple(jnp.asarray(t.numpy()) for t in tables), jax_pack(own),
        jax_pack(slab))
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
                            for _, o, s, _, _ in block_pairs(p, tables, own,
                                                             slab)])
        assert ((r > 0) & (r < params.h / 4)).sum() > 0
        assert ((r > params.h / 4) & (r < params.h)).sum() > 0


@pytest.mark.parametrize("name,gated", [
    ("density", False), ("density", True), ("rho_star", True),
    ("viscsurf", True), ("paccel", True)])
def test_fast_pass_matches_pallas(recorded_fast, name, gated):
    """The density pass (ungated and gated) and the four gated passes of
    the fast engine against sph_tpu's passes of the same ``sub`` and the
    oracle; the gate skips some (tile, group) terms that the ungated pass
    computes, and a gated pass sums what the gate admits. The density
    kernel takes ``RING["density"].rows_cta`` = 128 rows a CTA, the block
    of these inputs, so its plain version is held here at the shapes one
    CTA of the kernel takes; no case at another block is needed."""
    params, calls = recorded_fast
    p, tables, own, slab = calls[name]
    if p.kind == "density":
        assert p.block == pk.RING["density"].rows_cta
    if not gated:
        p, tables = dataclasses.replace(p, sub=None), tables[:6]
    assert p.gated == gated
    before = dict(pk.LAUNCHES)
    out, ref, orc = run_both(p, params, tables, own, slab, name)
    assert pk.LAUNCHES == before          # CPU tensors: no kernel launch
    assert_close(p, params, tables, own, out, ref, orc)
    gates = [g for *_, g in block_pairs(p, tables, own, slab)]
    assert all(g.all() for g in gates) != gated
    if p.kind == "density":
        # rows with no tile (gated far-wall blocks, phantoms) read c_rho
        c_rho = np.float32(params.c_rho)
        assert (out[0] == c_rho).any() and (out[0] > c_rho).sum() > 100


def test_gate_leaves_sort_time_sums_unchanged(recorded_fast):
    """At sort-time positions every term the gate skips is an exact zero:
    the gated time-t density equals the ungated one bit for bit."""
    _, calls = recorded_fast
    p, tables, own, slab = calls["density"]
    full = dataclasses.replace(p, sub=None)(tables[:6], own, slab)
    assert torch.equal(p(tables, own, slab), full)


N_SLOTS = 4
EL_BLOCK, EL_CCOL, EL_BLOCKS, N_EL = 128, 128, 8, 300


def elastic_inputs(seed=0):
    """(params, {"spring_ms": call, "mem_ms": call}) with call = (PairPass,
    tables, own, slab) as the engine would hand them: synthetic, from a
    seed. 900 real own rows in an 8-unit cube (the rest pads at ``far``), of
    which a sorted subset of 300 rows is the elastic slab (mcap 512)."""
    rng = np.random.default_rng(seed)
    params = SimParams()
    far = np.float32(max(params.x_max, params.y_max, params.z_max)
                     + 100.0 * params.h)
    n_pad = EL_BLOCKS * EL_BLOCK
    n_alloc, n_real = n_pad + EL_CCOL, 900
    mcap = -(-N_EL // 128) * 128 + EL_CCOL
    x_t = np.full((3, n_alloc), far, np.float32)
    x_t[:, :n_real] = rng.uniform(0.0, 8.0, (3, n_real))
    x_n = x_t.copy()
    x_n[:, :n_real] += rng.normal(0.0, 0.05, (3, n_real)).astype(np.float32)
    els = np.sort(rng.choice(n_real, N_EL, replace=False))

    # one block streams nothing, one its middle tile only (its elastic rows
    # meet no partner outside it), one three disjoint chunks, the rest all
    aln = np.zeros((EL_BLOCKS, 3), np.int32)
    s0 = np.zeros((EL_BLOCKS, 3), np.int32)
    cnt = np.zeros(EL_BLOCKS, np.int32)
    for b in range(EL_BLOCKS):
        aln[b], s0[b], cnt[b] = (0, 512, 512), (0, 4, 4), 4
    aln[1], s0[1], cnt[1] = (128, 256, 256), (0, 1, 1), 1
    aln[2], s0[2], cnt[2] = (0, 256, 384), (0, 1, 2), 3
    cnt[5] = 0
    z = np.zeros(EL_BLOCKS * 3, np.int32)
    tables = tuple(torch.as_tensor(a) for a in (
        aln.reshape(-1), z, z, s0.reshape(-1), cnt, np.zeros(1, np.int32)))

    # ---- spring slab ----
    spr = np.zeros((pk.spr_cols(N_SLOTS), mcap), np.float32)
    spr[:3] = far
    spr[:3, :N_EL] = x_t[:, els]
    spr[3:3 + N_SLOTS] = -1.0
    scale = params.simulation_scale
    for j in range(N_EL):
        k = int(rng.integers(0, N_SLOTS + 1))
        partners = rng.choice(np.delete(els, j), k, replace=False)
        if j % 7 == 0 and k >= 2:
            partners[1] = partners[0]              # listed twice
        for slot, i in enumerate(partners):
            r = np.linalg.norm(x_t[:, i] - x_t[:, els[j]])
            spr[3 + slot, j] = i
            spr[3 + N_SLOTS + slot, j] = r * scale * rng.uniform(0.9, 1.0)
            if rng.random() < 0.5:                 # a muscle spring
                spr[3 + 2 * N_SLOTS + slot, j] = (
                    rng.uniform(0.2, 1.0) * params.muscle_force)
    # a partner at the very same position: q2 == 0 drops the pair
    i_same = int(els[0])
    spr[:3, 1] = x_t[:, i_same]
    spr[3, 1], spr[3 + N_SLOTS, 1] = i_same, 1e-3
    own_main = np.zeros((pk.MAIN_COLS, n_alloc), np.float32)
    own_main[:3] = x_t
    kw = dict(block=EL_BLOCK, ccol=EL_CCOL, n_blocks=EL_BLOCKS,
              inv_h2=np.float32(1.0 / (params.h * params.h)))
    spring = pk.make_spring_pass(
        inv_h=np.float32(1.0 / params.h),
        h_scale=np.float32(params.h * scale),
        k_spring=np.float32(params.k_spring), n_slots=N_SLOTS, **kw)

    # ---- membrane slab ----
    mem = np.zeros((pk.MEM_COLS, mcap), np.float32)
    mem[42:] = far
    mem[42:45, :N_EL] = x_n[:, els]
    mem[45:48, :N_EL] = x_t[:, els]
    n_tri = rng.integers(0, 8, N_EL)               # 0..7 triangles a column
    n_tri[rng.random(N_EL) < 0.3] = 0
    for j in range(N_EL):
        for t in range(n_tri[j]):
            nt = rng.normal(size=3)
            mem[6 * t:6 * t + 3, j] = nt / np.linalg.norm(nt)
            mem[6 * t + 3:6 * t + 6, j] = (
                x_n[:, els[j]] + rng.normal(0.0, 0.5, 3))
    # a triangle whose plane holds an own row's new position exactly
    # (s == 0: not counted), beside one that is counted
    j0 = int(np.argmax(n_tri >= 2))
    d = np.linalg.norm(x_n[:, :n_real].T - mem[42:45, j0], axis=1)
    d[els[j0]] = np.inf
    for blk in (1, 2, 5):                          # blocks that skip tiles
        d[blk * EL_BLOCK:(blk + 1) * EL_BLOCK] = np.inf
    i0 = int(np.argmin(d))
    assert d[i0] < params.r0
    mem[0:6, j0] = (0.0, 1.0, 0.0, 0.0, x_n[1, i0], 0.0)
    own6 = np.concatenate([x_t, x_n])
    membrane = pk.make_membrane_pass(r0=np.float32(params.r0), **kw)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a))

    return params, dict(
        spring_ms=(spring, tables, t(own_main), t(spr)),
        mem_ms=(membrane, tables, t(own6), t(mem)),
    ), dict(els=els, i0=i0, j0=j0)


@pytest.fixture(scope="module")
def elastic():
    return elastic_inputs()


@pytest.mark.parametrize("name", ["spring_ms", "mem_ms"])
def test_elastic_pass_matches_pallas(elastic, name):
    params, calls, _ = elastic
    p, tables, own, slab = calls[name]
    before = dict(pk.LAUNCHES)
    out, ref, orc = run_both(p, params, tables, own, slab)
    assert pk.LAUNCHES == before          # CPU tensors: no kernel launch
    assert_close(p, params, tables, own, out, ref, orc)
    # block 5 streams no tile: exactly zero
    blk = slice(5 * p.block, 6 * p.block)
    assert all(not o[blk].any() for o in out)


def test_elastic_inputs_cover_the_cases(elastic):
    """The synthetic inputs hold what the formulas branch on (a test on
    inputs without them would pass a wrong formula)."""
    params, calls, info = elastic
    p, tables, own, slab = calls["spring_ms"]
    s = slab.numpy()
    ids, n = s[3:3 + N_SLOTS], N_SLOTS
    assert (ids == -1).any() and (s[3 + 2 * n:] != 0).sum() > 50
    assert any(len(set(c[c >= 0])) < (c >= 0).sum() for c in ids.T)
    out = [o.numpy() for o in p(tables, own, slab)]
    force = np.abs(np.stack(out)).sum(0)
    els = info["els"]
    assert (force[els] > 0).sum() > 100
    # an elastic own row of block 1 (one tile) whose partners lie elsewhere
    in_b1 = els[(els >= p.block) & (els < 2 * p.block)]
    listed = {int(i) for c in ids[:, p.ccol:2 * p.ccol].T for i in c}
    assert any(int(i) not in listed for i in in_b1)
    assert not force[[i for i in in_b1 if int(i) not in listed]].any()
    # liquid (non-elastic) own rows feel no spring
    assert not np.delete(force, els).any()

    p, tables, own, slab = calls["mem_ms"]
    m, o6 = slab.numpy().astype(np.float64), own.numpy().astype(np.float64)
    ntri = (np.abs(m[:42].reshape(7, 6, -1)[:, :3]).sum(1) > 0).sum(0)
    assert set(range(8)) <= set(ntri.tolist())
    i0, j0 = info["i0"], info["j0"]
    side0 = ((o6[3:6, i0] - m[3:6, j0]) * m[0:3, j0]).sum()
    assert side0 == 0.0 and ntri[j0] >= 2
    wsum = p(tables, own, slab)[3].numpy()
    assert (wsum > 0).sum() > 100


@pytest.mark.parametrize("name", PASS_NAMES + ["spring_ms", "mem_ms",
                                  "density", "paccel"])
def test_rounding_scale_bounds_the_sums(recorded, elastic, recorded_fast,
                                        name):
    """``PairPass.rounding_scale``: per row at least the f64 sum of the
    absolute pair terms (a cutoff factor counts as no less than itself), on
    a row without pairs exactly 0, and 1e-5 of its max bounds the f32 plain
    version's distance from the f64 oracle."""
    params, calls = recorded
    p, tables, own, slab = dict(calls, **elastic[1],
                                **recorded_fast[1])[name]
    scale = p.rounding_scale(tables, own, slab)
    scale = [a.numpy() for a in (scale if isinstance(scale, tuple)
                                 else (scale,))]
    out = p.plain(tables, own, slab)
    out = [a.numpy() for a in (out if isinstance(out, tuple) else (out,))]
    orc = oracle(p, params, tables, own, slab)
    absum = np.zeros((len(orc), p.n_pad))
    for b, o, s, gid, gate in block_pairs(p, tables, own, slab):
        for k, t in enumerate(oracle_terms(p, params, o, s, gid)):
            absum[k, b * p.block:(b + 1) * p.block] = np.abs(t * gate).sum(-1)
    if p.kind == "density":     # the raw sum's scale where not clamped
        free = orc[0] > params.c_rho
        absum = np.where(free, absum * params.c_rho / params.h ** 6, 0.0)
    for group in pk.OUTPUT_GROUPS[p.kind]:
        top = max(float(scale[i].max()) for i in group)
        for i in group:
            assert scale[i].shape == (p.n_pad,) and (scale[i] >= 0).all()
            assert (scale[i] >= absum[i] * (1 - 1e-5)).all(), (name, i)
            assert not scale[i][absum[i] == 0].any(), (name, i)
            assert np.abs(out[i] - orc[i]).max() <= 1e-5 * top, (name, i)


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


def test_gated_pass_checks(recorded_fast):
    """A gated pass takes the 8-tuple tables; only the density, viscsurf
    and paccel kinds have a gated form, at a sub that divides the block."""
    _, calls = recorded_fast
    p, tables, own, slab = calls["paccel"]
    assert p.launch_key == "paccel_sub" and p.sub == FAST_SUB
    with pytest.raises(ValueError, match="8-tuple"):
        p.kernel(tables[:6], own, slab)
    with pytest.raises(ValueError, match="table 6"):
        p.kernel(tables[:6] + (tables[6][:-1], tables[7]), own, slab)
    kw = dict(block=128, ccol=128, n_blocks=8, inv_h2=1.0, c_rho=1.0)
    with pytest.raises(ValueError, match="no gated pass"):
        pk.make_rho_star_pass(raw=True, sub=32, **kw)
    with pytest.raises(ValueError, match="no gated pass"):
        pk.make_density_pass(sub=48, **kw)
    assert not pk.make_density_pass(sub=128, **kw).gated   # sub >= block


def test_spring_pass_checks(elastic):
    """The spring slab's row count follows the slot count (the list kernel
    reads the slab in place: no shared memory); ids must stay exact as
    f32."""
    _, calls, _ = elastic
    p, tables, own, slab = calls["spring_ms"]
    assert p.slab_rows == pk.spr_cols(N_SLOTS) == 15
    assert p.shared_bytes == 0
    assert calls["mem_ms"][0].slab_rows == 45
    wide = dataclasses.replace(p, n_slots=16)
    assert wide.slab_rows == 51 and dataclasses.replace(
        wide, ccol=256).shared_bytes == 0
    with pytest.raises(ValueError, match="rows"):   # slab too short for 16
        wide.kernel(tables, own, slab)
    kw = dict(block=256, ccol=256, inv_h=1.0, h_scale=1.0, k_spring=1.0)
    with pytest.raises(ValueError, match="2\\^24"):
        pk.make_spring_pass(n_blocks=1 << 16, **kw)


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
def test_kernels_match_plain_on_cuda(recorded, elastic, recorded_fast):
    """On a CUDA card: each Hopper kernel against its plain version on the
    same inputs (1e-5 of the output vector's max magnitude)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    params, calls = recorded
    calls = dict(calls, **elastic[1],
                 **{"fast_" + k: v for k, v in recorded_fast[1].items()})
    for name, (p, tables, own, slab) in calls.items():
        if p.kind == "spring":             # the list kernel takes its list
            tables = pk.spring_list(p, tables, slab)
        cu = [t.cuda() for t in tables]
        before = pk.LAUNCHES[p.launch_key]
        k = p(cu, own.cuda(), slab.cuda())
        assert pk.LAUNCHES[p.launch_key] == before + 1
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
    # the third is the kernel's exit threshold, which no JAX wrapper has
    assert bnd.consts == (float(r0), float(np.float32(1.0 / r0)),
                          float(pk.sqrt_reach(r0)))
    den = pk.make_density_pass(c_rho=np.float32(params.c_rho), **kw)
    h2 = np.float32(1.0) / inv_h2
    assert den.consts == (float(h2), float(np.float32(h2 * h2) * h2),
                          float(inv_h2 * inv_h2 * inv_h2),
                          float(np.float32(params.c_rho)))
    assert pk.make_rho_star_pass(c_rho=np.float32(params.c_rho),
                                 **kw) == den
    assert dataclasses.replace(bnd, ccol=256).ccol == 256
