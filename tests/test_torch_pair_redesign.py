"""The host side of the ring driver that runs the rho* (raw), viscosity/
surface and pressure-force kernels (``pair_ring`` in ``sph_tpu_torch/ops/
csrc/pair_pass.cu``): the checks of its preconditions, its configuration's
way into the build, the shared memory it reports, the near-pair count that
charges the pressure-force kernel's bound for its early exit
(``chip_smoke.near_pairs``), and the threshold of the viscosity/surface
kernel's early exit (``pair_kernels.sqrt_reach``).

Inputs are the packs and tables that the port's fastw and fast engines hand
their passes in one step of the kicked 8h box (the fixtures of
``test_torch_pair_kernels.py``). The kernels run only on a card:
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
from test_torch_pair_kernels import recorded, recorded_fast  # noqa: F401

H100_SMEM = 232_448   # the most dynamic shared memory a CTA may take
RING_NAMES = ["raw_mm", "raw_ms", "raw_sm", "visc_mm", "visc_ms", "pacc_mm",
              "pacc_ms"]
FAST_RING_NAMES = ["fast_viscsurf", "fast_paccel"]
# the ring kinds with an exact early exit
EXIT_KINDS = ("viscsurf", "paccel")


def ring_calls(recorded, recorded_fast):
    """name -> (pass, tables, own, slab) of every recorded ring launch."""
    calls = {k: v for k, v in recorded[1].items() if k in RING_NAMES}
    for name in FAST_RING_NAMES:
        calls[name] = recorded_fast[1][name.removeprefix("fast_")]
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


@pytest.mark.parametrize("name", RING_NAMES + FAST_RING_NAMES)
def test_check_accepts_the_engines_packs(recorded, recorded_fast, name):
    p, tables, own, slab = ring_calls(recorded, recorded_fast)[name]
    assert slab.data_ptr() % 16 == 0 and slab.shape[1] % 4 == 0
    pk._check(p, tables, own, slab)


@pytest.mark.parametrize("name", ["raw_mm", "visc_ms", "pacc_ms",
                                  "fast_viscsurf", "fast_paccel"])
def test_check_refuses_what_the_ring_cannot_copy(recorded, recorded_fast,
                                                 name):
    p, tables, own, slab = ring_calls(recorded, recorded_fast)[name]
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
                                  "fast_paccel"])
def test_check_refuses_a_block_the_ctas_do_not_tile(recorded, recorded_fast,
                                                    name):
    """A CTA takes ``rows_cta`` rows of a block: a block 32 rows short of
    a multiple of it is refused before a launch."""
    p, tables, own, slab = ring_calls(recorded, recorded_fast)[name]
    rows_cta = pk.RING[p.kind].rows_cta
    assert p.block % rows_cta == 0
    odd = dataclasses.replace(p, block=p.block - 32, sub=None)
    with pytest.raises(ValueError, match=f"do not divide block {odd.block}"):
        pk._check(odd, tables[:6], own, slab)


def test_first_driver_kinds_keep_their_inputs(recorded):
    """The kinds on the first driver stage tiles with plain loads: a pack
    off a 16-byte boundary is still theirs to take."""
    p, tables, own, slab = recorded[1]["bnd_ms"]
    assert p.kind not in pk.RING
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
    ("rho_star", 512), ("rho_star", 256), ("viscsurf", 512),
    ("viscsurf", 256), ("paccel", 512), ("paccel", 256)])
def test_shared_bytes_is_the_ring(kind, ccol):
    """At the worm's tile widths (ccol 512, ccol_c 256) a launch takes the
    ring's stages x slab rows x ccol floats, under the card's limit; the
    first driver's kinds still take one tile."""
    kw = dict(block=256, ccol=ccol, n_blocks=8, inv_h2=1.0, c_rho=1.0)
    if kind == "rho_star":
        p = pk.make_rho_star_pass(raw=True, **kw)
        rows = 3
    elif kind == "viscsurf":
        p = pk.make_viscsurf_pass(**kw)
        rows = 7
    else:
        p = pk.make_paccel_pass(inv_h=1.0, rho0_delta=1.0, **kw)
        rows = 5
    assert p.slab_rows == rows
    assert p.shared_bytes == pk.RING[kind].stages * rows * ccol * 4
    assert p.shared_bytes < H100_SMEM
    bnd = pk.make_boundary_pass(r0=1.0, **kw)
    assert bnd.shared_bytes == bnd.slab_rows * ccol * 4


def brute_near_pairs(p, own, slab, rows):
    """The pairs of own rows ``rows`` (sorted ids) and every slab column
    whose body runs, by brute force in f32 over the whole slab (not the
    tiles): paccel 0 < r2 and (r < h or r < h/4), r = r2 / sqrt(r2);
    viscsurf r2 < its reach."""
    h, h4 = (np.float32(c) for c in p.consts[:2])
    o = own[:3, rows].numpy().T
    s = slab[:3].numpy()
    n = 0
    for i in range(0, len(o), 256):
        d = [o[i:i + 256, k:k + 1] - s[k][None, :] for k in range(3)]
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        if p.kind == "viscsurf":
            n += int((r2 < np.float32(p.consts[3])).sum())
            continue
        r = r2 * (np.float32(1) / np.sqrt(np.maximum(r2, np.float32(1e-30))))
        n += int(((r2 > 0) & ((h - r > 0) | (h4 - r > 0))).sum())
    return n


@pytest.mark.parametrize("name", ["pacc_mm", "pacc_ms", "fast_paccel",
                                  "visc_mm", "fast_viscsurf"])
def test_near_pairs_count(recorded, recorded_fast, name):
    """The near pairs the tables list (gated: the ones the gate admits)
    are every pair within h of the whole slab for the rows of the blocks
    that stream tiles (the fast engine gives its wall-only blocks none):
    the maskless invariant puts each in exactly one tile of its row's
    block. Own pad rows are moved far from every column first: they sit
    on the slab's pad columns, of which the tiles list only some."""
    from chip_smoke import near_pairs

    p, tables, own, slab = ring_calls(recorded, recorded_fast)[name]
    params = recorded[0]
    own = own.clone()
    own[:3, own[0] > max(params.x_max, params.y_max, params.z_max)] += 1e6
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


def test_first_design_entries_only_in_the_chip_check():
    """The first driver's entry points for the ring kinds
    (``sph_pair_<kind>_prev``) are declared by the loader and called by
    ``chip_smoke.py`` alone: no other module of the port names them, so no
    wrapper, engine or bench reaches them."""
    root = Path(pk.__file__).resolve().parents[1]
    named = [p.relative_to(root).as_posix() for p in root.rglob("*.py")
             if re.search(r"_prev\b|\bPREV\b", p.read_text())]
    assert named == ["ops/_build.py"]
    smoke = (root.parent / "chip_smoke.py").read_text()
    assert 'entry=f"sph_pair_{p.kind}_prev"' in smoke


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
def test_viscsurf_exit_skips_only_zeros(recorded, recorded_fast, name):
    """On the engines' recorded inputs, every listed pair at r2 >= reach
    has both terms exact zeros in f32 (torch's CPU sqrt is correctly
    rounded), and some pairs lie there: the exit leaves the sums as they
    are and has work to skip."""
    p, tables, own, slab = ring_calls(recorded, recorded_fast)[name]
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
