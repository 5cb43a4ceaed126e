"""The fast engine: one PCISPH step built on blocked pair passes
(counterpart of ``sph_tpu/core/fast.py``).

Same stage order and physics as the JAX module: particles are re-sorted by
h-granularity cell id once per resort period (z-major / x-pencil / y-run
order) and the step runs in sorted space; every per-neighbor reduction is a
blocked all-pairs pass over contiguous sorted windows (``ops.pair_kernels``:
Hopper kernels on CUDA, plain versions on CPU); walls stay in the carry,
pinned. Elastic and muscle forces take the compact-slab spring pass when
every spring anchors to elastic matter, else the gather fallback of
``core.elastic``.

This module also holds the window tables and packs that the wall-compact
engine (``core/fastw.py``) reuses.

Differences from the JAX module:

* a resort period is captured once as a CUDA graph and replayed
  (``core.graphed``) where the JAX module jits the nested ``lax.scan``; on
  the CPU, or with ``cuda_graph=False``, a Python loop runs it.
  ``FastConfig`` has no ``interpret`` field (the tensors' device decides);
* ``sort_ctx`` returns ``(ctx, diag)`` as the wall-compact engine's does,
  ``diag`` holding the tiles the Pallas passes' static caps would drop;
* the spring and membrane slab packs are buffers of the sort context, their
  per-step rows written in place (as in the port's wall-compact engine), and
  the spring activation term is a gather ``act_ext[muscle id]`` instead of
  the one-hot matrix product: the same f32 values; the spring pass runs on
  a list of the (column, slot) entries it matches (``pair_kernels.
  spring_list``), built once per resort period: the same sums;
* the time-t density and rho* launch one kernel each that fuses the clamp
  (``pair_kernels.make_density_pass``), and the density reads a 3-row
  position pack where the TPU needs the 8-row main pack.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..config import SimParams
from ..constants import BOUNDARY_PARTICLE, LIQUID_PARTICLE, MUSCLE_COUNT
from ..models import muscle
from ..ops import pair_kernels as pk
from . import graphed
from .elastic import elastic_accel
from .state import FluidState, Membranes, Springs
from .step import SceneLayout

ALIGN = pk.ALIGN


@dataclasses.dataclass(frozen=True)
class FastConfig:
    """Static shapes of a blocked pair engine's sorted row space
    (hashable)."""

    n_particles: int
    n_blocks: int
    block: int  # own-block size (sorted particles per block)
    ccol: int   # slab tile width (multiple of 128)
    dims: tuple[int, int, int]  # h-granularity grid dims
    resort_every: int = 10  # steps between spatial re-sorts (window rebuilds)
    # subgroup size of the gated main-window passes (None/block = off): per
    # streamed tile only the `sub`-row groups whose own pencil-band windows
    # overlap it compute (see pair_kernels: the results are unchanged)
    sub: int | None = None
    # tile width of the compact-slab passes (boundary/spring/membrane);
    # None = ccol
    ccol_c: int | None = None

    @property
    def ccol_compact(self) -> int:
        return self.ccol_c or self.ccol

    @property
    def n_pad(self) -> int:
        return self.n_blocks * self.block

    @property
    def n_alloc(self) -> int:
        return self.n_pad + self.ccol

    @property
    def n_pencils(self) -> int:
        # a pencil is a y-column of cells, indexed cx + nx * cz
        return self.dims[0] * self.dims[2]


def compute_fast_config(
    pos,
    params: SimParams,
    block: int = 256,
    ccol: int = 256,
    resort_every: int = 30,
    block_multiple: int = 8,
    sub: int | None = None,
    ccol_c: int | None = None,
) -> FastConfig:
    """Static fast-engine shapes: they depend on the particle count only
    (windows are streamed with a per-block tile count). The block count is
    rounded up to ``block_multiple``, as sph_tpu's is (phantom blocks get no
    tiles), so both packages see the same tables."""
    cell = params.h
    nx = int((params.x_max - params.x_min) / cell) + 1
    ny = int((params.y_max - params.y_min) / cell) + 1
    nz = int((params.z_max - params.z_min) / cell) + 1
    n = len(pos)
    m = block_multiple
    nb = -(-(-(-n // block)) // m) * m
    return FastConfig(
        n_particles=n, n_blocks=nb, block=block, ccol=ccol,
        dims=(nx, ny, nz), resort_every=resort_every, sub=sub,
        ccol_c=ccol_c,
    )


def _cells(pos, params: SimParams, dims):
    """(pencil, cell id) int32 per particle: f32 arithmetic and truncating
    casts, bitwise sph_tpu's (box_min subtracted before scaling)."""
    nx, ny, nz = dims
    cell = float(np.float32(1.0 / params.h))
    lo = [float(np.float32(b)) for b in params.box_min]
    cx = torch.clamp(((pos[:, 0] - lo[0]) * cell).to(torch.int32), 0, nx - 1)
    cy = torch.clamp(((pos[:, 1] - lo[1]) * cell).to(torch.int32), 0, ny - 1)
    cz = torch.clamp(((pos[:, 2] - lo[2]) * cell).to(torch.int32), 0, nz - 1)
    pencil = cx + nx * cz
    return pencil, cy + ny * pencil


def _window_tables(pencil_s, cfg: FastConfig):
    """Per-block interaction-window descriptors.

    For each own block (``block`` consecutive sorted particles) the
    candidate set is three contiguous sorted-array windows — the pencil
    bands (z-1, z, z+1) x (x span +- 1 pencil) around the block's pencil
    range. Returns the 6-tuple tables (aligned_offset, lo, hi, tile_start,
    tile_count, own_base) as int32 [nb*3] / [nb] / [1], the per-pencil start
    offsets, the per-block pencil ranges, and ``gtabs``: for a gated config
    (``0 < sub < block``) the per-subgroup UNMERGED dz-band column windows
    (glo, ghi), int32 [nb * 3 * ng] at index (b*3 + dz) * ng + g, else None.

    Chunks are deduplicated in window space (``prev_hi``) and in tile space
    (``prev_tend``): a block's tiles are disjoint and cover every in-window
    column exactly once (the maskless-kernel invariant).
    """
    n, nb, B = cfg.n_particles, cfg.n_blocks, cfg.block
    nx = cfg.dims[0]
    npen = cfg.n_pencils
    ccol = cfg.ccol
    dev = pencil_s.device
    i32 = torch.int32
    pstart = torch.searchsorted(
        pencil_s, torch.arange(npen + 1, dtype=pencil_s.dtype, device=dev),
        right=False, out_int32=True,
    )

    bidx = torch.arange(nb, dtype=i32, device=dev)
    first = pencil_s[torch.clamp(bidx * B, max=n - 1).long()]
    last = pencil_s[torch.clamp(bidx * B + B - 1, max=n - 1).long()]

    alns, los, his, nsubs, plos, phis = [], [], [], [], [], []
    prev_hi = torch.zeros(nb, dtype=i32, device=dev)
    prev_tend = torch.zeros(nb, dtype=i32, device=dev)
    for dz in (-1, 0, 1):
        lo_p = torch.clamp(first + dz * nx - 1, 0, npen)
        hi_p = torch.clamp(last + dz * nx + 2, 0, npen)
        lo_p = torch.maximum(lo_p, prev_hi)
        hi_p = torch.maximum(hi_p, lo_p)
        prev_hi = hi_p
        off = pstart[lo_p.long()]
        end = pstart[hi_p.long()]
        aligned = torch.maximum((off // ALIGN) * ALIGN, prev_tend)
        # ceil((end - aligned) / ccol) as a floor division of the negation
        nsub = torch.where(end > aligned, -((aligned - end) // ccol), 0)
        prev_tend = aligned + nsub * ccol
        alns.append(aligned)
        los.append(off)
        his.append(end)
        nsubs.append(nsub.to(i32))
        plos.append(lo_p)
        phis.append(hi_p)

    nsub = torch.stack(nsubs, 1)                     # [nb, 3]
    # phantom blocks (entirely beyond the particle count) do no work
    nsub = torch.where((bidx * B >= n)[:, None], 0, nsub)
    s0 = torch.cumsum(nsub, dim=1, dtype=i32) - nsub  # exclusive cumsum
    cnt = nsub.sum(dim=1, dtype=i32)
    tables = (
        torch.stack(alns, 1).reshape(-1).to(i32),
        torch.stack(los, 1).reshape(-1).to(i32),
        torch.stack(his, 1).reshape(-1).to(i32),
        s0.reshape(-1).contiguous(), cnt,
        torch.zeros(1, dtype=i32, device=dev),
    )
    pencil_ranges = (torch.stack(plos, 1), torch.stack(phis, 1))

    gtabs = None
    if cfg.sub and cfg.sub < B:
        sub = cfg.sub
        ng = B // sub
        gi = torch.arange(nb * ng, dtype=i32, device=dev)
        first_g = pencil_s[torch.clamp(gi * sub, max=n - 1).long()]
        last_g = pencil_s[torch.clamp(gi * sub + sub - 1, max=n - 1).long()]
        first_g, last_g = first_g.reshape(nb, ng), last_g.reshape(nb, ng)
        glos, ghis = [], []
        for dz in (-1, 0, 1):
            glos.append(pstart[
                torch.clamp(first_g + dz * nx - 1, 0, npen).long()])
            ghis.append(pstart[
                torch.clamp(last_g + dz * nx + 2, 0, npen).long()])
        gtabs = (torch.stack(glos, 1).reshape(-1),   # [nb, 3, ng] flat
                 torch.stack(ghis, 1).reshape(-1))
    return tables, pstart, pencil_ranges, gtabs


def tile_caps(ccol: int) -> tuple[int, int]:
    """(max tiles a block, mean tiles a block) that the Pallas passes' flat
    tile table holds (``sph_tpu/ops/pair_kernels._flat_tile_tables``);
    tiles beyond them are dropped there. The port's kernels have no caps;
    the counts keep the diagnostic comparable across the two packages."""
    return max(8, 16384 // ccol), max(4, 6144 // ccol)


def _table_overflow(tables, ccol, n_blocks):
    """Tiles the Pallas passes' static caps would drop for this table set."""
    smax, per_block = tile_caps(ccol)
    cnt = tables[4]
    return (torch.clamp(cnt.max() - smax, min=0)
            + torch.clamp(cnt.sum() - n_blocks * per_block, min=0)
            ).to(torch.int32)


def tile_table_stats(pos, params: SimParams, cfg: FastConfig):
    """(max tiles a block, total tiles) of the main window tables at the
    given positions ([N, 3], numpy or a tensor), through the engine's own
    sort and ``_window_tables``."""
    p = torch.as_tensor(pos, dtype=torch.float32)
    pencil, cid = _cells(p, params, cfg.dims)
    pencil_s = pencil[torch.argsort(cid, stable=True)]
    cnt = _window_tables(pencil_s, cfg)[0][4]
    return int(cnt.max()), int(cnt.sum())


def _tile_chunks(lo, hi, n_blocks, ccol):
    """Per-block chunk descriptors (aln, s0, cnt) from flattened [nb*3]
    lo/hi column ranges, deduplicated in tile space (each block's tiles are
    disjoint and cover every in-range column exactly once: the
    maskless-kernel invariant). lo/hi must be nondecreasing per block."""
    i32 = torch.int32
    lo3 = lo.reshape(n_blocks, 3).to(i32)
    hi3 = hi.reshape(n_blocks, 3).to(i32)
    alns, nsubs = [], []
    prev_tend = torch.zeros(n_blocks, dtype=i32, device=lo.device)
    for c in range(3):
        aligned = torch.maximum(
            torch.div(lo3[:, c], ALIGN, rounding_mode="floor") * ALIGN,
            prev_tend)
        # ceil((hi - aligned) / ccol): the negated operand must floor
        nsub = torch.where(
            hi3[:, c] > aligned,
            -torch.div(aligned - hi3[:, c], ccol, rounding_mode="floor"), 0)
        prev_tend = aligned + nsub * ccol
        alns.append(aligned)
        nsubs.append(nsub)
    nsub = torch.stack(nsubs, 1)
    s0 = (torch.cumsum(nsub, dim=1, dtype=i32) - nsub).reshape(-1)
    return (torch.stack(alns, 1).reshape(-1).contiguous(), s0.contiguous(),
            nsub.sum(dim=1, dtype=i32))


def _pad_field(a, cfg: FastConfig, fill=0.0):
    pad = cfg.n_alloc - a.shape[0]
    return torch.cat([a, a.new_full((pad,), fill)])


def _pack_rows(mat):
    """Pad a [rows, width] matrix with zero rows to a multiple of 8 (the
    TPU's sublane tile; the kernels read the rows they need)."""
    pad = -mat.shape[0] % 8
    return torch.cat([mat, mat.new_zeros((pad, mat.shape[1]))]) if pad \
        else mat


def _pack(fields):
    """Column-major [fields, width] pack: one contiguous row per field."""
    return torch.stack(fields, dim=0)


@dataclasses.dataclass
class StepParts:
    """An engine's stages plus its configured pair passes. ``inner_step``
    looks the passes up in ``passes`` at call time, so a caller may wrap one
    (e.g. to record its inputs)."""

    sort_ctx: Callable      # (state, springs, membranes) -> (ctx, diag)
    carry_of: Callable
    inner_step: Callable
    unsort_state: Callable
    passes: dict
    # density(state, springs, membranes) -> [n] time-t density from the
    # engine's own pair sums (see each engine for the rows it leaves out)
    density: Callable


def record_step_inputs(parts: StepParts, state: FluidState, springs: Springs,
                       membranes: Membranes, ctx_out: dict | None = None
                       ) -> dict:
    """name -> (PairPass, tables, own_pack, slab_pack) of the last call of
    each pair pass in one sort + one step from ``state`` (the stepped state
    is discarded; ``parts.passes`` is restored). ``ctx_out``, when given,
    receives the sort context (e.g. ``liq_s``, the liquid flag of the sorted
    rows: the membrane sums are used on liquid rows only)."""
    calls = {}
    passes = dict(parts.passes)
    for name, p in passes.items():
        def rec(tables, own, slab, _name=name, _p=p):
            calls[_name] = (_p, tables, own, slab)
            return _p(tables, own, slab)
        parts.passes[name] = rec
    try:
        ctx, _ = parts.sort_ctx(state, springs, membranes)
        if ctx_out is not None:
            ctx_out.update(ctx)
        parts.inner_step(ctx, parts.carry_of(ctx, state))
    finally:
        parts.passes.update(passes)
    return calls


def _make_step_parts(params: SimParams, layout: SceneLayout,
                     cfg: FastConfig) -> StepParts:
    """Build the fast engine's stages: sort_ctx (once per resort period),
    carry_of, inner_step (every step, in sorted space) and unsort_state;
    same stage order and physics as ``sph_tpu/core/fast.py``."""
    f32 = np.float32
    inv_h2 = f32(1.0 / (params.h * params.h))
    inv_h = f32(1.0 / params.h)
    c_rho = f32(params.c_rho)
    r0 = f32(params.r0)
    kw = dict(block=cfg.block, ccol=cfg.ccol, n_blocks=cfg.n_blocks,
              inv_h2=inv_h2)
    # the subgroup gate applies to the four main-window passes only; the
    # compact-slab passes stream their own narrower tiles (ccol_c)
    mkw = dict(kw, sub=cfg.sub)
    ckw = dict(kw, ccol=cfg.ccol_compact)
    n_slots = layout.spring_slots
    passes = dict(
        density=pk.make_density_pass(c_rho=c_rho, **mkw),
        viscsurf=pk.make_viscsurf_pass(**mkw),
        rho_star=pk.make_rho_star_pass(c_rho=c_rho, **mkw),
        paccel=pk.make_paccel_pass(
            inv_h=inv_h, rho0_delta=f32(params.rho0 * params.delta), **mkw),
        boundary=pk.make_boundary_pass(r0=r0, **ckw),
        membrane=pk.make_membrane_pass(r0=r0, **ckw),
        spring=pk.make_spring_pass(
            inv_h=inv_h, h_scale=f32(params.h * params.simulation_scale),
            k_spring=f32(params.k_spring), n_slots=n_slots, **ckw),
    )
    spring_pass = passes["spring"]
    muscle_force = float(f32(params.muscle_force))

    n = cfg.n_particles
    nb, B, n_pad = cfg.n_blocks, cfg.block, cfg.n_pad
    npen = cfg.n_pencils
    ccol_c = cfg.ccol_compact
    far = float(f32(
        max(params.x_max, params.y_max, params.z_max) + 100.0 * params.h))

    dt = float(f32(params.time_step))
    pos_dt = float(f32(params.time_step * params.simulation_scale_inv))
    rho0 = float(f32(params.rho0))
    delta_c = float(f32(params.delta))
    c_press = float(f32(params.c_press))
    c_visc = float(f32(params.c_visc))
    c_surf = float(f32(params.c_surf))
    gx, gy, gz = (float(f32(g)) for g in params.gravity)
    lo_box = [float(f32(b)) for b in params.box_min]
    hi_box = [float(f32(b - 1e-6)) for b in params.box_max]

    def sort_ctx(state: FluidState, springs: Springs, membranes: Membranes):
        """Everything derived from the spatial sort (valid for the whole
        resort period): permutation, window tables, per-block gates, sorted
        static fields, and spring/membrane ids translated to sorted space."""
        dev = state.pos.device
        i64 = torch.int64
        is_b = state.ptype == BOUNDARY_PARTICLE
        pencil, cid = _cells(state.pos, params, cfg.dims)
        order = torch.argsort(cid, stable=True)
        inv = torch.empty(n, dtype=i64, device=dev)
        inv[order] = torch.arange(n, device=dev)
        pencil_s = pencil[order]
        isb_o = is_b[order]

        def srt(a, fill=0.0):
            return _pad_field(a[order], cfg, fill)

        tables, _, (plo_r, phi_r), gtabs = _window_tables(pencil_s, cfg)
        gt = gtabs or ()
        # pad/phantom rows are flagged boundary (fill 1.0): maskless tiles
        # can overhang into pad columns, so phantom rows are pinned like
        # walls
        isb_s = srt(is_b.to(torch.float32), 1.0)
        liq_s = srt((state.ptype == LIQUID_PARTICLE).to(torch.float32))
        nrm = state.normal
        aln_t, lo_t, hi_t, s0_t, cnt_t, ob_t = tables
        zero = torch.zeros_like(cnt_t)

        def win_has(flag_o):
            """Per block: a row of its pencil-band windows has the flag
            (per-pencil counts, prefix sums over each window's pencils)."""
            seg = torch.zeros(npen, dtype=i64, device=dev)
            seg.index_add_(0, pencil_s.long(), flag_o.long())
            csum = torch.cat([seg.new_zeros(1), torch.cumsum(seg, 0)])
            return (csum[phi_r.long()] - csum[plo_r.long()]).sum(1) > 0

        # a block whose own rows are all walls receives no forces: the
        # force passes skip it; density/rho* skip only wall blocks with no
        # moving particle in reach (their rho is read by masked pairs only)
        own_nonb = isb_s[:n_pad].reshape(nb, B).amin(1) == 0
        force_tables = (aln_t, lo_t, hi_t, s0_t,
                        torch.where(own_nonb, cnt_t, zero), ob_t, *gt)
        rho_tables = (aln_t, lo_t, hi_t, s0_t,
                      torch.where(own_nonb | win_has(~isb_o), cnt_t, zero),
                      ob_t, *gt)
        ctx = dict(
            order=order, isb_s=isb_s, liq_s=liq_s,
            nxs=srt(nrm[:, 0]), nys=srt(nrm[:, 1]), nzs=srt(nrm[:, 2]),
            tables=tables, force_tables=force_tables, rho_tables=rho_tables,
            bmask=isb_s[:n_pad] > 0,
            not_b=(isb_s[:n_pad] == 0).to(torch.float32),
        )

        # boundary pass: compact static slab of the wall columns (walls
        # never move, so the whole pack is built once per resort), window
        # tables mapped into it by searchsorted
        b0, b1 = layout.boundary_range
        if b1 > b0:
            bels = torch.sort(inv[b0:b1]).values         # ascending rows
            lo_b = torch.searchsorted(bels, lo_t.long(), out_int32=True)
            hi_b = torch.searchsorted(bels, hi_t.long(), out_int32=True)
            aln_b, s0_b, cnt_b = _tile_chunks(lo_b, hi_b, nb, ccol_c)
            ctx["bnd_tables"] = (
                aln_b, lo_b, hi_b, s0_b,
                torch.where(own_nonb & win_has(isb_o), cnt_b, zero), ob_t)
            n_b = b1 - b0
            bcap = -(-n_b // ALIGN) * ALIGN + ccol_c
            pack = torch.zeros((pk.BND_COLS, bcap), dtype=torch.float32,
                               device=dev)
            pack[:3] = far
            src = torch.cat([state.pos[order].T, nrm[order].T])  # [6, n]
            pack[:6, :n_b] = src[:, bels]
            pack[pk.PB_ISB, :n_b] = 1.0
            ctx["bnd_pack"] = pack
        else:
            ctx["bnd_tables"] = (aln_t, lo_t, hi_t, s0_t, zero, ob_t)
            ctx["bnd_pack"] = torch.zeros((pk.BND_COLS, ccol_c),
                                          dtype=torch.float32, device=dev)

        if springs.n_elastic > 0 or membranes.n_tris > 0:
            _sort_elastic(ctx, springs, membranes, inv, order, win_has)
        diag = dict(tile_overflow=_table_overflow(tables, cfg.ccol, nb))
        return ctx, diag

    def _sort_elastic(ctx, springs, membranes, inv, order, win_has):
        """The compact elastic slab (springs + membranes stream elastic
        columns only), or the gather fallback's sorted spring ids."""
        dev = inv.device
        i64 = torch.int64
        e0, e1 = layout.elastic_range
        n_el = e1 - e0
        el_rows = inv[e0:e1]                          # sorted row per eid
        perm = torch.argsort(el_rows)                 # compact column order
        els = el_rows[perm]                           # ascending rows
        ctx["els"] = els
        _, lo_t, hi_t, _, _, ob_t = ctx["tables"]
        lo_c = torch.searchsorted(els, lo_t.long(), out_int32=True)
        hi_c = torch.searchsorted(els, hi_t.long(), out_int32=True)
        aln_c, s0_c, cnt_c = _tile_chunks(lo_c, hi_c, nb, ccol_c)
        mcap = -(-n_el // ALIGN) * ALIGN + ccol_c
        zero = torch.zeros_like(cnt_c)

        if springs.n_elastic > 0 and layout.springs_elastic_only:
            # springs as a pair pass over the compact slab: each column
            # carries its partners' sorted ids and rest lengths (static per
            # resort) and per-step positions and activation terms
            rmap = torch.full((n,), -1, dtype=i64, device=dev)
            rmap[springs.row_ids.long()] = torch.arange(springs.n_elastic,
                                                        device=dev)
            r_of_col = rmap[e0:e1][perm]
            r_safe = torch.clamp(r_of_col, min=0)
            sidx = torch.where((r_of_col >= 0)[:, None],
                               springs.idx[r_safe, :n_slots].long(), -1)
            used = sidx >= 0
            idx_f = torch.where(
                used, inv[torch.clamp(sidx, min=0)].to(torch.float32), -1.0)
            rest_c = torch.where(used, springs.rest[r_safe, :n_slots], 0.0)
            mid = torch.where(used, springs.muscle[r_safe, :n_slots].long(),
                              0)
            # muscle ids outside 1..MUSCLE_COUNT drive nothing
            mid = torch.where((mid >= 1) & (mid <= MUSCLE_COUNT), mid, 0)
            ctx["spr_mid"] = mid.T.contiguous()          # [n_slots, n_el]
            pack = torch.zeros((pk.spr_cols(n_slots), mcap),
                               dtype=torch.float32, device=dev)
            pack[:3] = far
            # pad columns carry partner id -1 (0 would match sorted row 0)
            pack[3:3 + n_slots] = -1.0
            pack[3:3 + n_slots, :n_el] = idx_f.T
            pack[3 + n_slots:3 + 2 * n_slots, :n_el] = rest_c.T
            ctx["spr_pack"] = _pack_rows(pack)
            own_el = torch.zeros(n_pad, dtype=torch.bool, device=dev)
            own_el.index_fill_(0, els, True)
            own_el = own_el.reshape(nb, B).any(dim=1)
            ctx["spr_tables"] = (aln_c, lo_c, hi_c, s0_c,
                                 torch.where(own_el, cnt_c, zero), ob_t)
            # the entries the pair form would match, once a period
            ctx["spr_list"] = pk.spring_list(spring_pass, ctx["spr_tables"],
                                             ctx["spr_pack"])
        elif springs.n_elastic > 0:
            # the fallback (springs anchored outside the elastic block):
            # spring ids translated to sorted rows, gathered every step
            sidx = springs.idx.long()
            ctx["springs_s"] = Springs(
                row_ids=inv[springs.row_ids.long()],
                idx=torch.where(sidx >= 0, inv[torch.clamp(sidx, min=0)],
                                -1),
                rest=springs.rest, muscle=springs.muscle)

        if membranes.n_tris > 0:
            pt = membranes.particle_tris[e0:e1].long()   # [n_el, 7]
            ctx["mem_vidx"] = inv[membranes.tris.long()]
            ptp = pt[perm]
            ctx["mem_pt_ok"] = (ptp >= 0).reshape(-1, 1)
            ctx["mem_pt_safe"] = torch.clamp(ptp, min=0).reshape(-1)
            has_mem = torch.zeros(n, dtype=torch.bool, device=dev)
            has_mem[e0:e1] = (pt >= 0).any(dim=1)
            own_liq = ctx["liq_s"][:n_pad].reshape(nb, B).amax(1) > 0
            ctx["mem_tables"] = (
                aln_c, lo_c, hi_c, s0_c,
                torch.where(win_has(has_mem[order]) & own_liq, cnt_c, zero),
                ob_t)
            pack = torch.zeros((pk.MEM_COLS, mcap), dtype=torch.float32,
                               device=dev)
            pack[6 * pk.MEM_TRIS:] = far
            ctx["mem_pack"] = pack

    def carry_of(ctx, state: FluidState):
        """Sorted-space step carry from an original-space state."""
        order = ctx["order"]
        pos, vel = state.pos[order], state.vel[order]

        def pad(a, fill=0.0):
            return _pad_field(a, cfg, fill)

        return (
            pad(pos[:, 0], far), pad(pos[:, 1], far), pad(pos[:, 2], far),
            pad(vel[:, 0]), pad(vel[:, 1]), pad(vel[:, 2]),
            state.muscle_activation, state.step,
            torch.zeros((), dtype=torch.float32, device=pos.device),
        )

    def density(state: FluidState, springs: Springs, membranes: Membranes):
        """[n] time-t density of every particle from one sort (walls whose
        block is gated out, with no moving particle in reach, read c_rho)."""
        ctx, _ = sort_ctx(state, springs, membranes)
        xs, ys, zs = carry_of(ctx, state)[:3]
        pos_pack = _pack([xs, ys, zs])
        rho_s = passes["density"](ctx["rho_tables"], pos_pack, pos_pack)
        rho = torch.empty(n, dtype=torch.float32, device=xs.device)
        rho[ctx["order"]] = rho_s[:n]
        return rho

    def inner_step(ctx, carry):
        xs, ys, zs, vtx, vty, vtz, act, step_no, drift = carry
        isb_s = ctx["isb_s"]
        bmask = ctx["bmask"]
        force_tables = ctx["force_tables"]

        # wall rows carry the wall normal as "velocity" (sphFluid.cl:860);
        # the dynamics below use the true velocity
        isb = isb_s > 0
        vxs = torch.where(isb, ctx["nxs"], vtx)
        vys = torch.where(isb, ctx["nys"], vty)
        vzs = torch.where(isb, ctx["nzs"], vtz)

        # ---- density ----
        pos_pack = _pack([xs, ys, zs])
        rho_s = _pad_field(
            passes["density"](ctx["rho_tables"], pos_pack, pos_pack), cfg,
            1.0)
        rho_s = torch.where(rho_s <= 0, 1.0, rho_s)  # padding guard
        inv_rho_s = 1.0 / rho_s  # the passes take 1/rho (no pair divide)

        # ---- external forces (viscosity + surface tension fused) ----
        main1 = _pack([xs, ys, zs, vxs, vys, vzs, inv_rho_s, isb_s])
        vx, vy, vz, stx, sty, stz = passes["viscsurf"](force_tables, main1,
                                                       main1)
        own_irho = inv_rho_s[:n_pad]
        not_b = ctx["not_b"]
        aex = (c_visc * vx * own_irho + c_surf * stx + gx) * not_b
        aey = (c_visc * vy * own_irho + c_surf * sty + gy) * not_b
        aez = (c_visc * vz * own_irho + c_surf * stz + gz) * not_b

        # ---- elastic + muscle forces ----
        if "spr_pack" in ctx:
            els = ctx["els"]
            n_el = els.shape[0]
            spr_pack = ctx["spr_pack"]
            spr_pack[:3, :n_el] = main1[:3][:, els]
            # per-spring activation term: muscle id 0 (plain spring) -> 0
            act_ext = torch.cat([act.new_zeros(1), act * muscle_force])
            spr_pack[3 + 2 * n_slots:3 + 3 * n_slots, :n_el] = act_ext[
                ctx["spr_mid"]]
            sfx, sfy, sfz = passes["spring"](ctx["spr_list"], main1,
                                             spr_pack)
            aex = aex + sfx
            aey = aey + sfy
            aez = aez + sfz
        elif "springs_s" in ctx:
            sp = ctx["springs_s"]
            ae = elastic_accel(torch.stack([xs[:n], ys[:n], zs[:n]], 1), sp,
                               act, params)
            aex = aex.index_add(0, sp.row_ids, ae[:, 0])
            aey = aey.index_add(0, sp.row_ids, ae[:, 1])
            aez = aez.index_add(0, sp.row_ids, ae[:, 2])

        # ---- PCISPH prediction-correction ----
        zeros = torch.zeros(n_pad, dtype=torch.float32, device=xs.device)
        p_s, apx, apy, apz = zeros, zeros, zeros, zeros
        own_x, own_y, own_z = xs[:n_pad], ys[:n_pad], zs[:n_pad]
        own_vx, own_vy, own_vz = vtx[:n_pad], vty[:n_pad], vtz[:n_pad]

        for _ in range(params.n_pcisph_iters):
            xst = torch.where(bmask, own_x,
                              own_x + pos_dt * (own_vx + dt * apx))
            yst = torch.where(bmask, own_y,
                              own_y + pos_dt * (own_vy + dt * apy))
            zst = torch.where(bmask, own_z,
                              own_z + pos_dt * (own_vz + dt * apz))
            iter_pack = _pack([_pad_field(xst, cfg, far),
                               _pad_field(yst, cfg, far),
                               _pad_field(zst, cfg, far)])
            rho_star = passes["rho_star"](ctx["rho_tables"], iter_pack,
                                          iter_pack)
            p_s = p_s + torch.clamp((rho_star - rho0) * delta_c, min=0.0)
            pa_pack = _pack([
                xs, ys, zs,
                _pad_field(1.0 / torch.clamp(rho_star, min=1.0), cfg, 1.0),
                _pad_field(p_s, cfg),
            ])
            fx, fy, fz = passes["paccel"](force_tables, pa_pack, pa_pack)
            coef = torch.where(bmask, 0.0, c_press / rho_star)
            apx, apy, apz = coef * fx, coef * fy, coef * fz

        # ---- integrate ----
        vnx = own_vx + dt * (aex + apx)
        vny = own_vy + dt * (aey + apy)
        vnz = own_vz + dt * (aez + apz)
        xn = torch.clamp(own_x + pos_dt * vnx, lo_box[0], hi_box[0])
        yn = torch.clamp(own_y + pos_dt * vny, lo_box[1], hi_box[1])
        zn = torch.clamp(own_z + pos_dt * vnz, lo_box[2], hi_box[2])
        vax = (own_vx + vnx) * 0.5
        vay = (own_vy + vny) * 0.5
        vaz = (own_vz + vnz) * 0.5

        # ---- Ihmsen boundary response ----
        own_pack = _pack([xs, ys, zs, _pad_field(xn, cfg, far),
                          _pad_field(yn, cfg, far), _pad_field(zn, cfg, far)])
        ncx, ncy, ncz, wsum, w2sum = passes["boundary"](
            ctx["bnd_tables"], own_pack, ctx["bnd_pack"])
        nlen2 = ncx * ncx + ncy * ncy + ncz * ncz
        has = nlen2 > 0
        coef = torch.where(
            has,
            torch.rsqrt(torch.clamp(nlen2, min=1e-30))
            * w2sum / torch.clamp(wsum, min=1e-30),
            0.0,
        )
        xn = xn + ncx * coef
        yn = yn + ncy * coef
        zn = zn + ncz * coef
        vn_dot = ncx * vax + ncy * vay + ncz * vaz
        fric = has & (vn_dot < 0)
        vax = torch.where(fric, (vax - ncx * vn_dot) * 0.99, vax)
        vay = torch.where(fric, (vay - ncy * vn_dot) * 0.99, vay)
        vaz = torch.where(fric, (vaz - ncz * vn_dot) * 0.99, vaz)

        # ---- membranes ----
        if "mem_pack" in ctx:
            els = ctx["els"]
            n_el = els.shape[0]
            vidx = ctx["mem_vidx"]
            xyz_n = torch.stack([xn, yn, zn], dim=1)      # [n_pad, 3]
            vabc = xyz_n[vidx.reshape(-1)].reshape(-1, 3, 3)
            a3 = vabc[:, 0]
            tn = torch.linalg.cross(vabc[:, 1] - a3, vabc[:, 2] - a3)
            tl2 = (tn * tn).sum(dim=1, keepdim=True)
            til = torch.where(
                tl2 > 0, torch.rsqrt(torch.clamp(tl2, min=1e-30)), 0.0)
            tri6 = torch.cat([tn * til, a3], dim=1)       # [n_tri, 6]
            g = torch.where(ctx["mem_pt_ok"], tri6[ctx["mem_pt_safe"]], 0.0)
            mem_pack = ctx["mem_pack"]
            mem_pack[:6 * pk.MEM_TRIS, :n_el] = g.reshape(
                n_el, 6 * pk.MEM_TRIS).T
            mem_pack[6 * pk.MEM_TRIS:, :n_el] = torch.stack(
                [xn, yn, zn, own_x, own_y, own_z])[:, els]
            mnx, mny, mnz, mws, mw2 = passes["membrane"](
                ctx["mem_tables"], own_pack, mem_pack)
            ml2 = mnx * mnx + mny * mny + mnz * mnz
            mhas = (ml2 > 0) & (ctx["liq_s"][:n_pad] > 0)
            mcoef = torch.where(
                mhas,
                torch.rsqrt(torch.clamp(ml2, min=1e-30))
                * mw2 / torch.clamp(mws, min=1e-30),
                0.0,
            )
            xn = xn + mnx * mcoef
            yn = yn + mny * mcoef
            zn = zn + mnz * mcoef

        # walls (and pad rows) are pinned: the carry stays exact across the
        # whole resort period
        xn = torch.where(bmask, own_x, xn)
        yn = torch.where(bmask, own_y, yn)
        zn = torch.where(bmask, own_z, zn)
        vax = torch.where(bmask, own_vx, vax)
        vay = torch.where(bmask, own_vy, vay)
        vaz = torch.where(bmask, own_vz, vaz)

        if layout.muscle_model:
            act = muscle.next_activation(step_no)

        # window-staleness bound: the sum over the period's steps of the
        # per-step max displacement (pinned rows move exactly 0)
        d2 = ((xn - own_x) * (xn - own_x)
              + (yn - own_y) * (yn - own_y)
              + (zn - own_z) * (zn - own_z))
        drift = drift + torch.sqrt(torch.max(d2))

        return (
            _pad_field(xn, cfg, far), _pad_field(yn, cfg, far),
            _pad_field(zn, cfg, far),
            _pad_field(vax, cfg), _pad_field(vay, cfg),
            _pad_field(vaz, cfg),
            act, step_no + 1, drift,
        )

    def unsort_state(ctx, carry, state: FluidState) -> FluidState:
        xs, ys, zs, vtx, vty, vtz, act, step_no, _drift = carry
        order = ctx["order"]
        pos = torch.empty_like(state.pos)
        vel = torch.empty_like(state.vel)
        pos[order] = torch.stack([xs[:n], ys[:n], zs[:n]], 1)
        vel[order] = torch.stack([vtx[:n], vty[:n], vtz[:n]], 1)
        return FluidState(
            pos=pos, vel=vel, ptype=state.ptype, normal=state.normal,
            muscle_activation=act, step=step_no,
        )

    return StepParts(sort_ctx, carry_of, inner_step, unsort_state, passes,
                     density)


def make_fast_multi_step(params, layout, cfg: FastConfig, n_steps: int = 1,
                         return_drift: bool = False,
                         cuda_graph: bool = True):
    """run(state, springs, membranes) -> state after n_steps. One sort per
    resort period (``cfg.resort_every`` steps, the last period shorter).
    ``return_drift``: also return the window-staleness bound, the max over
    the call's resort periods of the summed per-step max displacement (a
    device tensor; 2x it bounds how far a pair approached while the
    period's windows were stale). ``cuda_graph``: for a state on the card,
    each period length captured once as a CUDA graph and replayed
    (``core.graphed``); False, or a state on the CPU, is the eager
    loop."""
    parts = _make_step_parts(params, layout, cfg)
    run_periods = graphed.period_runner(parts, n_steps, cfg.resort_every,
                                        cuda_graph)

    def run(state, springs, membranes):
        state, diag = run_periods(state, springs, membranes)
        if return_drift:
            return state, diag["window_drift"]
        return state

    return run


def make_fast_stepper(params, layout, cfg: FastConfig, inner_steps: int = 10):
    """Stateful stepping API: (sort, inner, unsort). ``sort`` returns
    (ctx, carry, diag); ``inner`` advances the carry ``inner_steps`` steps;
    ``unsort`` writes it back into original order. The resort period is
    the caller's number of ``inner`` calls between sorts."""
    parts = _make_step_parts(params, layout, cfg)

    def sort(state, springs, membranes):
        ctx, diag = parts.sort_ctx(state, springs, membranes)
        return ctx, parts.carry_of(ctx, state), diag

    def inner(ctx, carry):
        for _ in range(inner_steps):
            carry = parts.inner_step(ctx, carry)
        return carry

    return sort, inner, parts.unsort_state
