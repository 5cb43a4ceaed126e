"""The host side of the ring driver that runs the density (the time-t
density and the clamped rho*), rho* (raw), viscosity/surface,
pressure-force, boundary and membrane kernels (``pair_ring`` in
``sph_tpu_torch/ops/csrc/pair_pass.cu``): the checks of its preconditions,
its configuration's way into the build, the shared memory it reports (the
membrane kernel stages only its pack's x(t+1) rows), the near-pair count
that charges the early exits' bounds (``chip_smoke.near_pairs``), and the
thresholds of the exits at h and at r0 (``pair_kernels.sqrt_reach``).

Inputs are the packs and tables that the port's fastw and fast engines hand
their passes in one step of the kicked 8h box (the fixtures of
``test_torch_pair_kernels.py``), the synthetic membrane inputs of its
``elastic`` fixture, and the engines' membrane and boundary launches on the
8h box with a membrane sheet in its pool (``membrane_box``). The kernels
run only on a card:
``chip_smoke.py`` holds them bitwise to the first driver on the recorded
launches of four paths (within the kernel tolerance where a row is split
over threads), and ``test_torch_pair_kernels.py``'s cuda-marked test holds
them to the plain versions.
"""
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from sph_tpu_torch.config import SimParams
from sph_tpu_torch.ops import _build
from sph_tpu_torch.ops import pair_kernels as pk
from sph_tpu_torch.core import fast as F
from sph_tpu_torch.core import fastw as W
from sph_tpu_torch.scene import Scene, generate_liquid_box_scene
from test_torch_pair_kernels import (H, elastic, recorded,  # noqa: F401
                                     recorded_fast)

H100_SMEM = 232_448   # the most dynamic shared memory a CTA may take
RING_NAMES = ["raw_mm", "raw_ms", "raw_sm", "visc_mm", "visc_ms", "pacc_mm",
              "pacc_ms", "bnd_ms"]
# the fast engine's launches; fast_rho_star is the density kind on the
# iteration pack
FAST_RING_NAMES = ["fast_density", "fast_rho_star", "fast_viscsurf",
                   "fast_paccel", "fast_boundary"]
# the engines' membrane launches (``membrane_box``) and the synthetic ones
MEMBRANE_NAMES = ["mem_ms", "fast_membrane", "el_mem_ms"]
# the ring kinds with an exact early exit
EXIT_KINDS = ("viscsurf", "paccel", "boundary", "membrane")


@pytest.fixture(scope="module")
def membrane_box():
    """name -> (pass, tables, own, slab) of the membrane and boundary
    launches of one sort + step of the fastw engine (``mem_ms``,
    ``bnd_ms``) and of the fast engine (``membrane``, ``boundary``) on the
    8h box with an 8 x 8 elastic sheet of 98 triangles, r0 apart, laid
    across the middle of its pool (at rest: what these tests read are the
    engines' packs and tables, their shapes and alignment)."""
    params = SimParams(x_max=8 * H, y_max=8 * H, z_max=8 * H)
    box = generate_liquid_box_scene(params, fill_fraction=0.5)
    liquid = box.pos[box.ptype == 1]
    n, r0 = 8, np.float32(params.r0)
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    sheet = np.stack([3 * H + (i.ravel() + 0.29) * r0,
                      np.full(n * n, np.median(liquid[:, 1]) + 0.37 * r0),
                      3 * H + (j.ravel() + 0.41) * r0], 1).astype(np.float32)
    a = (np.arange(n - 1)[:, None] * n + np.arange(n - 1)).ravel()
    tris = np.concatenate([np.stack([a, a + 1, a + n], 1),
                           np.stack([a + 1, a + n + 1, a + n], 1)])
    zeros = np.zeros_like(sheet)
    scene = Scene(pos=np.concatenate([sheet, box.pos]),
                  vel=np.concatenate([zeros, box.vel]),
                  color=np.concatenate([np.full(n * n, 2.1, np.float32),
                                        box.color]),
                  normal=np.concatenate([zeros, box.normal]),
                  tris=tris.astype(np.int32))
    layout = scene.layout()
    state = scene.device_state("cpu")
    cfg = W.compute_fastw_config(scene.pos, params, layout, ptype=scene.ptype)
    ws = W.precompute_wall_static(scene.pos, scene.normal, params, layout,
                                  cfg)
    calls = W.record_step_inputs(
        W._make_step_parts_w(params, layout, cfg, wall_static=ws), *state)
    fcfg = F.compute_fast_config(state[0].pos, params, block=128, ccol=128)
    fast = F.record_step_inputs(F._make_step_parts(params, layout, fcfg),
                                *state)
    return dict(mem_ms=calls["mem_ms"], bnd_ms=calls["bnd_ms"],
                fast_membrane=fast["membrane"], fast_boundary=fast["boundary"])


@pytest.fixture(scope="module")
def ring(recorded, recorded_fast, membrane_box, elastic):
    """name -> (pass, tables, own, slab) of every recorded ring launch."""
    calls = {k: v for k, v in recorded[1].items() if k in RING_NAMES}
    for name in FAST_RING_NAMES:
        calls[name] = recorded_fast[1][name.removeprefix("fast_")]
    calls["mem_ms"] = membrane_box["mem_ms"]
    calls["fast_membrane"] = membrane_box["fast_membrane"]
    calls["el_mem_ms"] = elastic[1]["mem_ms"]
    assert all(c[0].kind in pk.RING for c in calls.values())
    return calls


def misaligned(slab):
    """A contiguous copy of ``slab`` carved from a flat buffer 4 bytes past
    a 16-byte boundary."""
    buf = torch.zeros(slab.numel() + 8, dtype=slab.dtype)
    skip = next(k for k in range(4) if (buf.data_ptr() + 4 * k) % 16 == 4)
    out = buf[skip:skip + slab.numel()].view(slab.shape)
    out.copy_(slab)
    assert out.is_contiguous() and out.data_ptr() % 16 == 4
    return out


@pytest.mark.parametrize("name", RING_NAMES + FAST_RING_NAMES
                         + MEMBRANE_NAMES)
def test_check_accepts_the_engines_packs(ring, name):
    p, tables, own, slab = ring[name]
    assert slab.data_ptr() % 16 == 0 and slab.shape[1] % 4 == 0
    pk._check(p, tables, own, slab)


def test_membrane_box_engines_hand_the_ring_what_it_copies(membrane_box):
    """The fastw boundary pack and both engines' membrane packs on a scene
    with a membrane: widths and tile offsets multiples of 4, tiles on
    some blocks and not on all (the membrane's are zeroed away from it)."""
    for p, tables, own, slab in membrane_box.values():
        pk._check(p, tables, own, slab)
        assert slab.shape[1] % 4 == 0
        assert bool((tables[0] % 4 == 0).all())
        if p.kind == "membrane":
            assert slab.shape[0] == pk.MEM_COLS
            assert 0 < int((tables[4] > 0).sum()) < p.n_blocks


@pytest.mark.parametrize("name", ["raw_mm", "visc_ms", "pacc_ms",
                                  "fast_density", "fast_rho_star",
                                  "fast_viscsurf", "fast_paccel", "bnd_ms",
                                  "fast_boundary", "mem_ms", "fast_membrane"])
def test_check_refuses_what_the_ring_cannot_copy(ring, name):
    p, tables, own, slab = ring[name]
    with pytest.raises(ValueError, match="16-byte"):
        pk._check(p, tables, own, misaligned(slab))
    narrow = torch.cat([slab, slab[:, :2]], 1)   # width % 4 == 2
    with pytest.raises(ValueError, match="multiples of 4"):
        pk._check(p, tables, own, narrow)
    odd = dataclasses.replace(p, ccol=p.ccol + 2)
    with pytest.raises(ValueError, match=f"ccol {p.ccol + 2}"):
        pk._check(odd, tables, own, slab)
    # a tile offset 2 columns off a multiple of 4 (CPU tables are read)
    shifted = (tables[0] + 2,) + tuple(tables[1:])
    with pytest.raises(ValueError, match=r"tile offsets \(aln\)"):
        pk._check(p, shifted, own, slab)


@pytest.mark.parametrize("name", ["raw_ms", "visc_mm", "pacc_mm",
                                  "fast_density", "fast_rho_star",
                                  "fast_paccel", "bnd_ms", "fast_boundary",
                                  "mem_ms", "fast_membrane"])
def test_check_refuses_a_block_the_ctas_do_not_tile(ring, name):
    """A CTA takes ``rows_cta`` rows of a block: a block 32 rows short of
    a multiple of it is refused before a launch."""
    p, tables, own, slab = ring[name]
    rows_cta = pk.RING[p.kind].rows_cta
    assert p.block % rows_cta == 0
    odd = dataclasses.replace(p, block=p.block - 32, sub=None)
    with pytest.raises(ValueError, match=f"do not divide block {odd.block}"):
        pk._check(odd, tables[:6], own, slab)


@pytest.mark.parametrize("name", ["fast_density", "fast_rho_star"])
def test_check_refuses_a_sub_the_rows_do_not_divide(ring, name,
                                                    monkeypatch):
    """The gated ring kernel keeps a thread's rows in one subgroup (one
    window set, one tile test): with two rows a thread (the density
    kernel's until the box cull's matrix gave it one), a gated pass whose
    sub the rows a thread do not divide is refused before a launch, with
    gate tables of the right size."""
    p, tables, own, slab = ring[name]
    monkeypatch.setitem(pk.RING, p.kind, dataclasses.replace(
        pk.RING[p.kind], rows=2))
    rows = pk.RING[p.kind].rows
    assert p.gated and rows == 2 and p.sub % rows == 0
    odd = dataclasses.replace(p, sub=rows - 1)
    assert odd.gated
    n_gate = 3 * p.n_blocks * (p.block // odd.sub)
    gate = tuple(torch.zeros(n_gate, dtype=torch.int32) for _ in range(2))
    with pytest.raises(ValueError, match=f"sub {odd.sub} does not allow"):
        pk._check(odd, tuple(tables[:6]) + gate, own, slab)


def test_first_driver_kinds_keep_their_inputs(recorded_fast):
    """Every pair kind but spring (a list kernel) runs on the ring driver,
    density too: its pack off a 16-byte boundary, which the first driver
    staged with plain loads, is now refused before a launch."""
    p, tables, own, slab = recorded_fast[1]["density"]
    assert p.kind in pk.RING
    assert set(pk._SPECS) - set(pk.RING) == {"spring"}
    pk._check(p, tables, own, slab)
    with pytest.raises(ValueError, match="16-byte"):
        pk._check(p, tables, own, misaligned(slab))


@pytest.mark.parametrize("kind", sorted(pk.RING))
def test_ring_config_reaches_the_build(kind):
    """``pk.RING`` is the one owner of the ring configuration: each field
    reaches nvcc as a define in ``_build.FLAGS`` (so the library's hash
    covers it), and it meets the kernel's static_asserts and the engines'
    blocks (128, 256) here, before a build on the card."""
    ring = pk.RING[kind]
    for field, value in dataclasses.asdict(ring).items():
        flag = f"-DSPH_{kind.upper()}_{field.upper()}={int(value)}"
        assert _build.FLAGS.count(flag) == 1, flag
    threads = ring.rows_cta // ring.rows * ring.tpr
    assert ring.tpr in (1, 2, 4) and ring.stages >= 2
    assert ring.rows_cta % ring.rows == 0
    assert threads % 32 == 0 and threads <= 512
    assert 128 % ring.rows_cta == 0 and 256 % ring.rows_cta == 0
    assert ring.exit == (kind in EXIT_KINDS)


@pytest.mark.parametrize("kind,ccol", [
    ("density", 256), ("density", 128),
    ("rho_star", 512), ("rho_star", 256), ("viscsurf", 512),
    ("viscsurf", 256), ("paccel", 512), ("paccel", 256), ("boundary", 256),
    ("boundary", 128), ("membrane", 256), ("membrane", 128)])
def test_shared_bytes_is_the_ring(kind, ccol):
    """At the worm's tile widths (ccol 512, ccol_c 256) and the density's
    (the dam-break's 256, the tests' 128) a launch takes the ring's stages
    x staged rows x ccol floats, under the card's limit: the slab rows the
    pass reads, but for the membrane pass only its x(t+1) rows (3 of the
    45 it reads, where the first design staged 45)."""
    kw = dict(block=256, ccol=ccol, n_blocks=8, inv_h2=1.0, c_rho=1.0)
    if kind == "density":
        p = pk.make_density_pass(**kw)
        rows = staged = 3
    elif kind == "rho_star":
        p = pk.make_rho_star_pass(raw=True, **kw)
        rows = staged = 3
    elif kind == "viscsurf":
        p = pk.make_viscsurf_pass(**kw)
        rows = staged = 7
    elif kind == "paccel":
        p = pk.make_paccel_pass(inv_h=1.0, rho0_delta=1.0, **kw)
        rows = staged = 5
    elif kind == "boundary":
        p = pk.make_boundary_pass(r0=1.0, **kw)
        rows = staged = 7
    else:
        p = pk.make_membrane_pass(r0=1.0, **kw)
        rows, staged = pk.PMM_ZN + 1, 3
    assert p.slab_rows == rows and p.staged_rows == staged
    assert p.shared_bytes == pk.RING[kind].stages * staged * ccol * 4
    assert p.shared_bytes < H100_SMEM


def test_membrane_staged_rows_match_the_kernel():
    """The rows the membrane functor stages (``kRows`` from ``kRow0`` in
    ``pair_pass.cu``) are the ones the host counts: x(t+1), rows
    PMM_XN..PMM_ZN; every other ring functor stages from row 0."""
    src = (Path(pk.__file__).parent / "csrc" / "pair_pass.cu").read_text()
    consts = {m[0]: (int(m[1]), int(m[2])) for m in re.findall(
        r"struct (\w+) \{[^}]*?static constexpr int kRows = (\d+), "
        r"kRow0 = (\d+);", src, re.S)}
    assert consts == {"Density": (3, 0), "RhoStar": (3, 0),
                      "ViscSurf": (7, 0), "PAccel": (5, 0),
                      "Boundary": (7, 0), "Membrane": (3, pk.PMM_XN)}
    p = pk.make_membrane_pass(block=256, ccol=256, n_blocks=1, r0=1.0)
    assert p.slab_rows - p.staged_rows == pk.PMM_XN


# kind -> (own rows, slab rows) of the positions a distance test reads
TEST_ROWS = {"paccel": (0, 0), "viscsurf": (0, 0), "boundary": (3, 0),
             "membrane": (3, pk.PMM_XN)}


def brute_near_pairs(p, own, slab, rows):
    """The pairs of own rows ``rows`` (sorted ids) and every slab column
    whose body runs, by brute force in f32 over the whole slab (not the
    tiles): paccel 0 < r2 and (r < h or r < h/4), r = r2 / sqrt(r2);
    viscsurf, boundary and membrane r2 < their reach (the last constant)."""
    h, h4 = (np.float32(c) for c in p.consts[:2])
    i0, j0 = TEST_ROWS[p.kind]
    o = own[i0:i0 + 3, rows].numpy().T
    s = slab[j0:j0 + 3].numpy()
    n = 0
    for i in range(0, len(o), 256):
        d = [o[i:i + 256, k:k + 1] - s[k][None, :] for k in range(3)]
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        if p.kind != "paccel":
            n += int((r2 < np.float32(p.consts[-1])).sum())
            continue
        r = r2 * (np.float32(1) / np.sqrt(np.maximum(r2, np.float32(1e-30))))
        n += int(((r2 > 0) & ((h - r > 0) | (h4 - r > 0))).sum())
    return n


@pytest.mark.parametrize("name", ["pacc_mm", "pacc_ms", "fast_paccel",
                                  "visc_mm", "fast_viscsurf", "bnd_ms",
                                  "fast_boundary"])
def test_near_pairs_count(recorded, ring, name):
    """The near pairs the tables list (gated: the ones the gate admits)
    are every pair within h of the whole slab for the rows of the blocks
    that stream tiles (the fast engine gives its wall-only blocks none):
    the maskless invariant puts each in exactly one tile of its row's
    block. Own pad rows are moved far from every column first: they sit
    on the slab's pad columns, of which the tiles list only some."""
    from chip_smoke import near_pairs

    p, tables, own, slab = ring[name]
    params = recorded[0]
    own = own.clone()
    own[:, own[0] > max(params.x_max, params.y_max, params.z_max)] += 1e6
    ob = int(tables[5][0])
    streams = np.nonzero(tables[4].numpy() > 0)[0]
    rows = (streams[:, None] * p.block + np.arange(p.block)).ravel() + ob
    rows = rows[(rows >= 0) & (rows < own.shape[1])]
    n = near_pairs(p, tables, own, slab)
    assert n == brute_near_pairs(p, own, slab, rows)
    if p.gated:
        ungated = dataclasses.replace(p, sub=None)
        assert near_pairs(ungated, tables[:6], own, slab) == n
    cand = int(tables[4].long().sum()) * p.ccol * p.block
    assert 0 < n < cand / 4, (n, cand)


def listed_near_pairs(p, tables, own, slab):
    """The (own row, listed column) pairs under the exit's reach (r2 <
    the pass's last constant), by walking the tables' tiles block by block
    in NumPy: tile s < cnt[b] of block b starts at column aln[c] + (s -
    s0[c]) * ccol of chunk c = 3b + (s >= s0[3b+1]) + (s >= s0[3b+2]);
    columns past the slab's width are not listed; own rows past the own
    pack's width are not live."""
    aln, _, _, s0, cnt, ob = (t.numpy().astype(np.int64) for t in tables)
    i0, j0 = TEST_ROWS[p.kind]
    o, x = own[i0:i0 + 3].numpy(), slab[j0:j0 + 3].numpy()
    reach = np.float32(p.consts[-1])
    n = 0
    for b in range(p.n_blocks):
        rows = ob[0] + b * p.block + np.arange(p.block)
        rows = rows[(rows >= 0) & (rows < own.shape[1])]
        for t in range(cnt[b]):
            c = 3 * b + (t >= s0[3 * b + 1]) + (t >= s0[3 * b + 2])
            off = aln[c] + (t - s0[c]) * p.ccol
            cols = np.arange(max(off, 0), min(off + p.ccol, slab.shape[1]))
            d = [o[k][rows, None] - x[k][None, cols] for k in range(3)]
            n += int((d[0] * d[0] + d[1] * d[1] + d[2] * d[2] < reach).sum())
    return n


@pytest.mark.parametrize("name", MEMBRANE_NAMES + ["bnd_ms"])
def test_near_pairs_count_of_the_r0_exits(ring, name):
    """The membrane (and boundary) pairs under the exit's reach, as
    ``chip_smoke.near_pairs`` counts them for the bound, are those of a
    tile-by-tile walk of the tables: on the synthetic membrane inputs the
    tables skip tiles and blocks (no maskless invariant to count against
    the whole slab), and some pairs lie within r0."""
    from chip_smoke import near_pairs

    p, tables, own, slab = ring[name]
    n = near_pairs(p, tables, own, slab)
    assert n == listed_near_pairs(p, tables, own, slab)
    assert n > 0


def test_first_design_entries_only_in_the_chip_check():
    """The first driver's entry points for the ring kinds
    (``sph_pair_<kind>_prev``) are declared by the loader and called by
    ``chip_smoke.py`` alone: no other module of the port names them, so no
    wrapper, engine or bench reaches them. (``Comm.send_prev``, the halo
    engine's send to the previous rank, is no such entry.)"""
    root = Path(pk.__file__).resolve().parents[1]
    named = [p.relative_to(root).as_posix() for p in root.rglob("*.py")
             if re.search(r"(?<!send)_prev\b|\bPREV\b", p.read_text())]
    assert named == ["ops/_build.py"]
    smoke = (root.parent / "chip_smoke.py").read_text()
    assert 'entry=f"sph_pair_{p.kind}_prev"' in smoke
    src = (root / "ops" / "csrc" / "pair_pass.cu").read_text()
    assert set(_build.PREV) == {k + "_prev" for k in (*pk.RING, "spring")}
    for entry in _build.PREV:
        assert f"int sph_pair_{entry}(SPH_PAIR_ARGS)" in src


def f32_prev(t):
    return np.nextafter(np.float32(t), np.float32(0.0))


# the h of every scene of the port (the worm's and the boxes': SimParams'
# default), and h values of other smoothing lengths from a seed
H_VALUES = [SimParams().h] + list(np.random.default_rng(3).uniform(
    0.5, 8.0, 5))


@pytest.mark.parametrize("h", H_VALUES)
def test_viscsurf_exit_threshold_is_exact(h):
    """The viscosity/surface kernel skips a pair at r2 >= reach, the
    pass's fourth constant. In f32 (numpy's sqrt is correctly rounded, as
    the kernel's sqrtf): sqrt(T) >= h > sqrt(prev(T)) for T =
    ``sqrt_reach(h)``; at every r2 from reach up both terms are exact zeros
    (max(h - sqrt(r2), 0) == 0 and not r2 < h^2), and at prev(reach) one of
    them is not: the exit skips every pair it can and no other."""
    inv_h2 = np.float32(1.0 / (h * h))
    p = pk.make_viscsurf_pass(block=256, ccol=512, n_blocks=1, inv_h2=inv_h2)
    hf, h2 = np.float32(p.consts[0]), np.float32(p.consts[1])
    t = pk.sqrt_reach(hf)
    assert t.dtype == np.float32
    assert np.sqrt(t) >= hf and np.sqrt(f32_prev(t)) < hf
    reach = np.float32(p.consts[3])
    assert reach == max(h2, t)
    r2 = reach
    for _ in range(64):
        assert np.maximum(hf - np.sqrt(r2), np.float32(0.0)) == 0.0
        assert not r2 < h2
        r2 = np.nextafter(r2, np.float32(np.inf))
    below = f32_prev(reach)
    assert hf - np.sqrt(below) > 0.0 or below < h2


@pytest.mark.parametrize("name", ["visc_mm", "visc_ms", "fast_viscsurf"])
def test_viscsurf_exit_skips_only_zeros(ring, name):
    """On the engines' recorded inputs, every listed pair at r2 >= reach
    has both terms exact zeros in f32 (torch's CPU sqrt is correctly
    rounded), and some pairs lie there: the exit leaves the sums as they
    are and has work to skip."""
    p, tables, own, slab = ring[name]
    h, h2, _, reach = p.consts
    skipped = total = 0
    for _, live, o, s, valid, _ in pk.pair_chunks(p, tables, own, slab):
        dx, dy, dz = o[0] - s[0], o[1] - s[1], o[2] - s[2]
        r2 = dx * dx + dy * dy + dz * dz
        out = valid & live[..., None] & (r2 >= reach)
        wv = torch.clamp(h - torch.sqrt(r2), min=0.0)
        assert not bool((out & ((wv != 0.0) | (r2 < h2))).any())
        skipped += int(out.sum())
        total += int((valid & live[..., None]).sum())
    assert 0 < skipped < total


# r0 = h/2 of the port's scenes (SimParams' own) and of the h values above
R0_VALUES = [SimParams().r0] + [h / 2 for h in H_VALUES]


@pytest.mark.parametrize("kind", ["boundary", "membrane"])
@pytest.mark.parametrize("r0", R0_VALUES)
def test_r0_exit_threshold_is_exact(kind, r0):
    """The boundary and membrane kernels skip a pair at r2 >= reach, their
    last constant, sqrt_reach(r0). In f32 (numpy's sqrt is correctly
    rounded, as the kernel's sqrtf): sqrt(reach) >= r0 > sqrt(prev(reach));
    from reach up d = r0 - sqrt(r2) <= 0, so the boundary weight
    max(0, d / r0) isb and every term it scales are zeros and the
    membrane's test !(d > 0) returns; at prev(reach) d > 0: the exit skips
    every pair it can and no other."""
    kw = dict(block=256, ccol=256, n_blocks=1, r0=np.float32(r0))
    p = (pk.make_boundary_pass if kind == "boundary"
         else pk.make_membrane_pass)(**kw)
    r0f = np.float32(p.consts[0])
    assert r0f == np.float32(r0)
    reach = np.float32(p.consts[-1])
    assert reach == pk.sqrt_reach(r0f)
    assert np.sqrt(reach) >= r0f and np.sqrt(f32_prev(reach)) < r0f
    inv_r0 = np.float32(1.0 / r0f)
    r2 = reach
    for _ in range(64):
        d = r0f - np.sqrt(r2)
        assert not d > 0.0
        w = np.maximum(np.float32(0.0), d * inv_r0) * np.float32(1.0)
        assert w == 0.0 and w * d == 0.0
        r2 = np.nextafter(r2, np.float32(np.inf))
    assert r0f - np.sqrt(f32_prev(reach)) > 0.0


@pytest.mark.parametrize("name", ["bnd_ms", "fast_boundary", "el_mem_ms",
                                  "mem_ms"])
def test_r0_exit_skips_only_zeros(ring, name):
    """On the recorded inputs every listed pair at r2 >= reach is an exact
    zero of all five sums of the pass, in f32 (torch's CPU sqrt is
    correctly rounded): the boundary terms w n (3), w, w d with w =
    max(0, d / r0) isb, and the membrane's weight max(0, d / r0), which
    scales its five terms, and its test d > 0; and some pairs lie there,
    and some below the reach."""
    p, tables, own, slab = ring[name]
    i0, j0 = TEST_ROWS[p.kind]
    r0, reach = p.consts[0], p.consts[-1]
    skipped = total = 0
    for _, live, o, s, valid, _ in pk.pair_chunks(p, tables, own, slab):
        dx, dy, dz = (o[i0 + k] - s[j0 + k] for k in range(3))
        r2 = dx * dx + dy * dy + dz * dz
        out = valid & live[..., None] & (r2 >= reach)
        d = r0 - torch.sqrt(r2)
        if p.kind == "boundary":
            w = torch.clamp(d * p.consts[1], min=0.0) * s[pk.PB_ISB]
            terms = [w * s[pk.PB_NX + k] for k in range(3)] + [w, w * d]
        else:
            w = torch.clamp(d / r0, min=0.0)
            terms = [w, w * d, (d > 0.0).to(w.dtype)]
        assert not any(bool((out & (t != 0.0)).any()) for t in terms)
        skipped += int(out.sum())
        total += int((valid & live[..., None]).sum())
    assert 0 < skipped < total
