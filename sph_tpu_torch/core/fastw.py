"""The wall-compact fast engine (counterpart of ``sph_tpu/core/fastw.py``).

Frozen boundary walls leave the hot loop: the sorted step carry holds only
MOVING rows (liquid + elastic); a thin SHELL of walls (those whose grid cell
lies within a ``dilate``-cell dilation of any moving-occupied cell) stays
live, with its rho/rho*/p recomputed each step from a shell-rows x
moving-columns pass plus a static wall-wall constant; moving rows take their
wall contributions from compact shell-column passes; deep walls vanish from
the step. Same pair set, stage order and physics as the JAX engine; the
six pair passes run through ``ops.pair_kernels`` (Hopper kernels on CUDA,
plain versions on CPU).

Differences from the JAX module:

* a resort period is captured once as a CUDA graph and replayed
  (``core.graphed``) where the JAX module jits the nested ``lax.scan``; on
  the CPU, or with ``cuda_graph=False``, a Python loop runs it;
* with ``wall_static=None`` the walls are sorted in every resort and
  their wall-wall density sums come from the ``raw_sw`` pass (shell rows x
  wall columns), as in the JAX module; with the
  :func:`precompute_wall_static` result both are constant-table lookups;
* the spring and membrane slab packs are buffers of the sort context: their
  static rows (partner ids, rest lengths, pad columns) are written once per
  resort, the position, activation and triangle rows in place every step;
* the per-spring activation term is a gather ``act_ext[muscle id]`` instead
  of the one-hot matrix product: the same f32 values, no matmul precision
  mode involved;
* the spring pass runs on a list of the (column, slot) entries it matches
  (``pair_kernels.spring_list``), built once per resort period from the
  spring tables and the slab's partner ids: the same sums.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as TF

from ..config import SimParams
from ..constants import BOUNDARY_PARTICLE, LIQUID_PARTICLE, MUSCLE_COUNT
from ..models import muscle
from ..ops import pair_kernels as pk
from .state import FluidState, Membranes, Springs
from .step import SceneLayout
from . import fast as F
from . import graphed
from .fast import StepParts, _table_overflow, record_step_inputs  # noqa: F401

ALIGN = pk.ALIGN


@dataclasses.dataclass(frozen=True)
class FastWConfig:
    """Static shapes of the wall-compact engine (hashable)."""

    n_mov: int          # count of moving (liquid+elastic) particles
    n_wall: int         # count of boundary particles
    mov_lo: int         # moving ids are [0, mov_lo) + [wall_hi, n)
    wall_lo: int        # boundary ids are [wall_lo, wall_hi)
    wall_hi: int
    n_blocks: int       # moving-row blocks
    n_blocks_s: int     # shell-row blocks (shell_cap = n_blocks_s * block)
    block: int
    ccol: int           # moving-column tile width
    dims: tuple[int, int, int]
    device: str = "cpu"
    resort_every: int = 30
    ccol_c: int | None = None   # compact (shell) tile width
    dilate: int = 2     # shell = walls within this cell dilation of moving

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
    def shell_cap(self) -> int:
        return self.n_blocks_s * self.block

    @property
    def shell_alloc(self) -> int:
        return self.shell_cap + self.ccol_compact

    @property
    def n_pencils(self) -> int:
        return self.dims[0] * self.dims[2]

    def mov_cfg(self) -> F.FastConfig:
        """FastConfig view of the moving-row space."""
        return F.FastConfig(
            n_particles=self.n_mov, n_blocks=self.n_blocks,
            block=self.block, ccol=self.ccol, dims=self.dims,
        )


def _mov_wall_split(layout: SceneLayout):
    """(mov_lo, wall_lo, wall_hi): moving ids are [0, wall_lo) +
    [wall_hi, n) — boundary is contiguous in both scene orders."""
    b0, b1 = layout.boundary_range
    return b0, b0, b1


def measure_shell_cap(pos, ptype, params: SimParams, dims,
                      dilate: int = 2) -> int:
    """Scene-measured shell POPULATION (walls within the dilated moving
    occupancy) at the given positions. NumPy; mirrors ``_shell_of``."""
    nx, ny, nz = dims
    pos = np.asarray(pos)
    is_w = np.asarray(ptype) == BOUNDARY_PARTICLE
    cell = 1.0 / params.h
    lo = np.asarray(params.box_min)
    c = np.clip(((pos - lo) * cell).astype(np.int64), 0,
                np.array([nx, ny, nz]) - 1)
    occ = np.zeros((nz, nx, ny), bool)
    cm = c[~is_w]
    occ[cm[:, 2], cm[:, 0], cm[:, 1]] = True
    d = dilate
    dil = np.zeros_like(occ)
    for dz in range(-d, d + 1):
        for dx in range(-d, d + 1):
            for dy in range(-d, d + 1):
                src = occ[
                    max(0, -dz):nz - max(0, dz),
                    max(0, -dx):nx - max(0, dx),
                    max(0, -dy):ny - max(0, dy),
                ]
                dil[
                    max(0, dz):nz - max(0, -dz),
                    max(0, dx):nx - max(0, -dx),
                    max(0, dy):ny - max(0, -dy),
                ] |= src
    cw = c[is_w]
    return int(dil[cw[:, 2], cw[:, 0], cw[:, 1]].sum())


def compute_fastw_config(
    pos,
    params: SimParams,
    layout: SceneLayout,
    block: int = 256,
    ccol: int = 512,
    ccol_c: int | None = 256,
    device: str = "cpu",
    resort_every: int = 30,
    dilate: int = 2,
    shell_margin: float = 1.3,
    ptype=None,
) -> FastWConfig:
    """Static shapes: moving-row blocks from the layout's class ranges,
    shell capacity measured from the initial positions (overflow at run
    time is surfaced as a loud diagnostic, not silent truncation)."""
    cell = params.h
    nx = int((params.x_max - params.x_min) / cell) + 1
    ny = int((params.y_max - params.y_min) / cell) + 1
    nz = int((params.z_max - params.z_min) / cell) + 1
    mov_lo, wall_lo, wall_hi = _mov_wall_split(layout)
    n = layout.n_particles
    n_mov = n - (wall_hi - wall_lo)
    nb = -(-(-(-n_mov // block)) // 8) * 8
    if ptype is None:
        # synthesize the class vector from the layout ranges
        pt = np.zeros(n, np.int32)
        pt[wall_lo:wall_hi] = BOUNDARY_PARTICLE
    else:
        pt = np.asarray(ptype)
    n_sh = measure_shell_cap(pos, pt, params, (nx, ny, nz), dilate=dilate)
    blk8 = 8 * block
    cap = max(blk8, -(-int(shell_margin * max(n_sh, 1)) // blk8) * blk8)
    cap = min(cap, -(-max(wall_hi - wall_lo, 1) // blk8) * blk8)
    return FastWConfig(
        n_mov=n_mov, n_wall=wall_hi - wall_lo, mov_lo=mov_lo,
        wall_lo=wall_lo, wall_hi=wall_hi,
        n_blocks=nb, n_blocks_s=cap // block, block=block, ccol=ccol,
        dims=(nx, ny, nz), device=str(torch.device(device)),
        resort_every=resort_every, ccol_c=ccol_c, dilate=dilate,
    )


def precompute_wall_static(pos, normal, params: SimParams,
                           layout: SceneLayout, cfg: FastWConfig):
    """Host-side wall constants: walls never move (`owHelper.cpp:775-928`
    generates them once, `sphFluid.cl:616-622` freezes them), so their cell
    sort and their mutual t^3 density sums are simulation invariants. The
    mutual sums are computed in f64 (cKDTree within-h pairs) and cast once.
    Tensors land on ``cfg.device``. Returns None when the scene has no
    walls."""
    wall_lo, wall_hi = cfg.wall_lo, cfg.wall_hi
    if wall_hi <= wall_lo:
        return None
    nx, ny, nz = cfg.dims
    pw = np.asarray(pos, np.float32)[wall_lo:wall_hi]
    nw = np.asarray(normal, np.float32)[wall_lo:wall_hi]
    # mirror fast._cells in f32 so cell assignment matches the device path
    cell = np.float32(1.0 / params.h)
    lo = np.asarray(params.box_min, np.float32)
    c = np.clip(((pw - lo) * cell).astype(np.int32), 0,
                np.array([nx, ny, nz], np.int32) - 1)
    pencil = c[:, 0] + nx * c[:, 2]
    cid = c[:, 1] + ny * pencil
    order = np.argsort(cid, kind="stable")
    ps, nss = pw[order], nw[order]

    from scipy.spatial import cKDTree

    h2 = np.float64(params.h) ** 2
    tree = cKDTree(ps.astype(np.float64))
    pairs = tree.query_pairs(r=float(params.h), output_type="ndarray")
    ww = np.zeros(len(ps), np.float64)
    if len(pairs):
        d2 = np.sum(
            (ps[pairs[:, 0]].astype(np.float64)
             - ps[pairs[:, 1]].astype(np.float64)) ** 2, axis=1)
        t3 = np.maximum(h2 - d2, 0.0) ** 3
        np.add.at(ww, pairs[:, 0], t3)
        np.add.at(ww, pairs[:, 1], t3)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=cfg.device)

    return dict(
        x=t(ps[:, 0]), y=t(ps[:, 1]), z=t(ps[:, 2]),
        nx=t(nss[:, 0]), ny=t(nss[:, 1]), nz=t(nss[:, 2]),
        pencil=t(pencil[order], torch.int32),
        cid=t(cid[order], torch.int32),
        ww=t(ww.astype(np.float32)),
    )


def _cross_tables(first, last, pstart, nx, npen, nb, ccol):
    """6-tuple window tables for own blocks with pencil ranges
    [first, last] into a FOREIGN compact column space described by its
    per-pencil prefix offsets ``pstart`` (len npen+1, nondecreasing).
    Same dz-band dedup (window space) + tile dedup (prev_tend) as
    ``core.fast._window_tables`` — tiles stay disjoint + covering."""
    dev = first.device
    i32 = torch.int32
    alns, los, his, nsubs = [], [], [], []
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
        nsub = torch.where(end > aligned, -((aligned - end) // ccol), 0)
        prev_tend = aligned + nsub * ccol
        alns.append(aligned)
        los.append(off)
        his.append(end)
        nsubs.append(nsub.to(i32))
    nsub = torch.stack(nsubs, 1)
    s0 = torch.cumsum(nsub, dim=1, dtype=i32) - nsub
    return (
        torch.stack(alns, 1).reshape(-1).to(i32),
        torch.stack(los, 1).reshape(-1).to(i32),
        torch.stack(his, 1).reshape(-1).to(i32),
        s0.reshape(-1).contiguous(), nsub.sum(dim=1, dtype=i32),
        torch.zeros(1, dtype=i32, device=dev),
    )


def _gate(tables, active):
    aln, lo, hi, s0, cnt, ob = tables
    return (aln, lo, hi, s0, torch.where(active, cnt, 0), ob)


def _shell_of(cid_m, cid_w_s, cfg: FastWConfig):
    """Shell membership flag per SORTED wall: its cell lies within the
    ``dilate``-cell box dilation of the moving-occupied cells."""
    nx, ny, nz = cfg.dims
    occ = torch.zeros(nx * ny * nz, dtype=torch.float32,
                      device=cid_m.device)
    occ.index_fill_(0, cid_m.long(), 1.0)
    d = cfg.dilate
    dil = TF.max_pool3d(occ.reshape(1, 1, nz, nx, ny), kernel_size=2 * d + 1,
                        stride=1, padding=d).reshape(-1)
    return dil[cid_w_s.long()] > 0.0


def _pad_to(a, width, fill=0.0):
    return torch.cat([a, a.new_full((width - a.shape[0],), fill)])


def _make_step_parts_w(params: SimParams, layout: SceneLayout,
                       cfg: FastWConfig, wall_static=None) -> StepParts:
    """Build the wall-compact step stages: same stage order and physics as
    ``sph_tpu/core/fastw.py:_make_step_parts_w`` (sphFluid.cl stage
    sequence); moving rows only in the carry, shell walls recomputed per
    step, deep walls absent.

    ``wall_static``: optional :func:`precompute_wall_static` result. When
    given, the per-resort wall sort and the shell x wall ``raw_sw`` density
    pass are replaced by constant-table lookups (walls never move). When
    None the in-graph path runs: the walls are sorted from the state's
    positions and ``raw_sw`` sums their mutual density terms at every
    resort (the two paths differ only by the f32 summation order of the
    wall-wall sums)."""
    if layout.n_elastic > 0 and not layout.springs_elastic_only:
        raise ValueError(
            "fastw requires elastic-only spring anchors (wall rows are not "
            "addressable in the moving-compact sorted space)")
    f32 = np.float32
    inv_h2 = f32(1.0 / (params.h * params.h))
    inv_h = f32(1.0 / params.h)
    c_rho = float(f32(params.c_rho))
    h2 = f32(params.h * params.h)
    self3 = float(f32(h2 * h2) * h2)
    inv_h6 = float(inv_h2 * inv_h2 * inv_h2)

    nb_m, nb_s, B = cfg.n_blocks, cfg.n_blocks_s, cfg.block
    ccol, ccol_c = cfg.ccol, cfg.ccol_compact
    kw = dict(block=B, inv_h2=inv_h2)
    pacc_kw = dict(inv_h=inv_h, rho0_delta=f32(params.rho0 * params.delta))
    passes = dict(
        raw_mm=pk.make_rho_star_pass(
            ccol=ccol, n_blocks=nb_m, c_rho=c_rho, raw=True, **kw),
        raw_ms=pk.make_rho_star_pass(
            ccol=ccol_c, n_blocks=nb_m, c_rho=c_rho, raw=True, **kw),
        raw_sm=pk.make_rho_star_pass(
            ccol=ccol, n_blocks=nb_s, c_rho=c_rho, raw=True, **kw),
        visc_mm=pk.make_viscsurf_pass(ccol=ccol, n_blocks=nb_m, **kw),
        visc_ms=pk.make_viscsurf_pass(ccol=ccol_c, n_blocks=nb_m, **kw),
        pacc_mm=pk.make_paccel_pass(ccol=ccol, n_blocks=nb_m, **pacc_kw,
                                    **kw),
        pacc_ms=pk.make_paccel_pass(ccol=ccol_c, n_blocks=nb_m, **pacc_kw,
                                    **kw),
        bnd_ms=pk.make_boundary_pass(r0=f32(params.r0), ccol=ccol_c,
                                     n_blocks=nb_m, **kw),
        mem_ms=pk.make_membrane_pass(r0=f32(params.r0), ccol=ccol_c,
                                     n_blocks=nb_m, **kw),
        spring_ms=pk.make_spring_pass(
            inv_h=inv_h, h_scale=f32(params.h * params.simulation_scale),
            k_spring=f32(params.k_spring), n_slots=layout.spring_slots,
            ccol=ccol_c, n_blocks=nb_m, **kw),
    )
    if wall_static is None and cfg.n_wall > 0:
        # shell rows x wall columns: the walls' mutual density sums, once a
        # resort period
        passes["raw_sw"] = pk.make_rho_star_pass(
            ccol=ccol_c, n_blocks=nb_s, c_rho=c_rho, raw=True, **kw)
    spring_pass = passes["spring_ms"]
    n_slots = layout.spring_slots
    muscle_force = float(f32(params.muscle_force))

    n = layout.n_particles
    n_mov, n_wall = cfg.n_mov, cfg.n_wall
    nx = cfg.dims[0]
    npen = cfg.n_pencils
    far = float(f32(
        max(params.x_max, params.y_max, params.z_max) + 100.0 * params.h))
    dev = torch.device(cfg.device)
    wall_lo, wall_hi = cfg.wall_lo, cfg.wall_hi
    mov_ids = torch.as_tensor(np.concatenate(
        [np.arange(0, wall_lo), np.arange(wall_hi, n)]
    ).astype(np.int64), device=dev)

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
    # pad rows of the moving space are pinned (they carry `far`)
    pad_mask = torch.arange(cfg.n_pad, device=dev) >= n_mov
    # width of the sorted wall pack of the in-graph wall path
    wall_alloc = -(-max(n_wall, 1) // ALIGN) * ALIGN + ccol_c

    def sort_ctx(state: FluidState, springs: Springs, membranes: Membranes):
        pencil_m, cid_m = F._cells(state.pos[mov_ids], params, cfg.dims)
        order = torch.argsort(cid_m, stable=True)
        orig_of_sorted = mov_ids[order]             # [n_mov] original ids
        pencil_ms = pencil_m[order]
        tables_m, pstart_m, pranges, _ = F._window_tables(pencil_ms,
                                                          cfg.mov_cfg())
        bidx = torch.arange(nb_m, dtype=torch.int32, device=dev)
        first_m = pencil_ms[torch.clamp(bidx * B, max=n_mov - 1).long()]
        last_m = pencil_ms[
            torch.clamp(bidx * B + B - 1, max=n_mov - 1).long()]

        ctx = dict(order=order, orig_of_sorted=orig_of_sorted,
                   tables_m=tables_m)
        diag = dict(
            tile_overflow=_table_overflow(tables_m, ccol, nb_m),
            shell_overflow=torch.zeros((), dtype=torch.int32, device=dev),
        )
        if n_wall > 0:
            _sort_shell(ctx, diag, _wall_sort(state), cid_m, pstart_m,
                        first_m, last_m, bidx)
        if springs.n_elastic > 0 or membranes.n_tris > 0:
            _sort_elastic(ctx, state, springs, membranes, orig_of_sorted,
                          pencil_ms, pranges)
        return ctx, diag

    def _wall_sort(state):
        """The walls in cell order: positions, normals, pencils and cell
        ids (``wall_static``'s, or sorted here from the state)."""
        if wall_static is not None:
            return wall_static
        pw = state.pos[wall_lo:wall_hi]
        nw = state.normal[wall_lo:wall_hi]
        pencil_w, cid_w = F._cells(pw, params, cfg.dims)
        order_w = torch.argsort(cid_w, stable=True)
        pw, nw = pw[order_w], nw[order_w]
        return dict(x=pw[:, 0], y=pw[:, 1], z=pw[:, 2], nx=nw[:, 0],
                    ny=nw[:, 1], nz=nw[:, 2], pencil=pencil_w[order_w],
                    cid=cid_w[order_w])

    def _sort_shell(ctx, diag, ws, cid_m, pstart_m, first_m, last_m, bidx):
        # ---- shell selection over the sorted walls ----
        cap = cfg.shell_cap
        shell_flag = _shell_of(cid_m, ws["cid"], cfg)
        n_sh = shell_flag.sum().to(torch.int32)
        diag["shell_overflow"] = torch.clamp(n_sh - cap, min=0)
        # first `cap` flagged rows in order, padded with n_wall (the JAX
        # nonzero(size=, fill_value=)) — a scatter, no host sync
        rank = torch.cumsum(shell_flag, 0) - 1
        dst = torch.where(shell_flag & (rank < cap), rank, cap)
        sh_rows = torch.full((cap + 1,), n_wall, dtype=torch.int64,
                             device=dev)
        sh_rows[dst] = torch.arange(n_wall, device=dev)
        sh_rows = sh_rows[:cap]
        real = torch.arange(cap, device=dev) < n_sh
        safe = torch.clamp(sh_rows, max=n_wall - 1)

        def sgat(a, fill):
            return _pad_to(torch.where(real, a[safe], fill),
                           cfg.shell_alloc, fill)

        sx, sy, sz = sgat(ws["x"], far), sgat(ws["y"], far), sgat(ws["z"],
                                                                  far)
        snx, sny, snz = (sgat(ws["nx"], 0.0), sgat(ws["ny"], 0.0),
                         sgat(ws["nz"], 0.0))
        s_isb = _pad_to(real.to(torch.float32), cfg.shell_alloc, 0.0)
        ctx["shell_static"] = (sx, sy, sz, snx, sny, snz, s_isb)
        ctx["shell_pos_pack"] = F._pack([sx, sy, sz])
        ctx["bnd_pack"] = F._pack([sx, sy, sz, snx, sny, snz, s_isb])

        # shell pencils: window form (pads clamp to the last real pencil so
        # partial blocks don't window to the array tail), key form (pads =
        # npen so pstart_sh sees real rows only)
        pen_sh_raw = ws["pencil"][safe]
        pen_last = torch.index_select(
            pen_sh_raw, 0, torch.clamp(n_sh - 1, min=0).long().reshape(1))
        pen_sh_win = torch.where(real, pen_sh_raw, pen_last)
        pen_sh_key = torch.where(real, pen_sh_raw, npen)
        pstart_sh = torch.searchsorted(
            pen_sh_key,
            torch.arange(npen + 1, dtype=pen_sh_key.dtype, device=dev),
            right=False, out_int32=True,
        )

        # mov rows -> shell cols (density/visc/paccel/boundary)
        t_ms = _cross_tables(first_m, last_m, pstart_sh, nx, npen, nb_m,
                             ccol_c)
        ctx["tables_ms"] = _gate(t_ms, bidx * B < n_mov)
        # shell rows -> mov cols (shell rho/rho*)
        sbidx = torch.arange(nb_s, dtype=torch.int32, device=dev)
        first_s = pen_sh_win[torch.clamp(sbidx * B, max=cap - 1).long()]
        last_s = pen_sh_win[torch.clamp(sbidx * B + B - 1, max=cap - 1)
                            .long()]
        t_sm = _cross_tables(first_s, last_s, pstart_m, nx, npen, nb_s, ccol)
        ctx["tables_sm"] = _gate(t_sm, sbidx * B < n_sh)
        diag["tile_overflow"] = (
            diag["tile_overflow"]
            + _table_overflow(ctx["tables_ms"], ccol_c, nb_m)
            + _table_overflow(ctx["tables_sm"], ccol, nb_s)
        )
        if wall_static is not None:
            # walls never move: their mutual density sums are precomputed
            # once on the host (f64) — gather the shell's rows
            ctx["ww_const"] = torch.where(real, ws["ww"][safe], 0.0)
            return
        # shell rows -> wall cols: the wall-wall sums of this resort
        pencil_ws = ws["pencil"]
        pstart_w = torch.searchsorted(
            pencil_ws,
            torch.arange(npen + 1, dtype=pencil_ws.dtype, device=dev),
            right=False, out_int32=True,
        )
        t_sw = _gate(_cross_tables(first_s, last_s, pstart_w, nx, npen, nb_s,
                                   ccol_c), sbidx * B < n_sh)
        wall_pack = F._pack([_pad_to(ws["x"], wall_alloc, far),
                             _pad_to(ws["y"], wall_alloc, far),
                             _pad_to(ws["z"], wall_alloc, far)])
        # the raw sums hold each wall's own self term: subtracted here once
        ctx["ww_const"] = passes["raw_sw"](t_sw, ctx["shell_pos_pack"],
                                           wall_pack) - self3
        diag["tile_overflow"] = (diag["tile_overflow"]
                                 + _table_overflow(t_sw, ccol_c, nb_s))

    def _sort_elastic(ctx, state, springs, membranes, orig_of_sorted,
                      pencil_ms, pranges):
        """The compact elastic slab (springs + membranes): elastic columns
        in sorted order, their tile tables per own block, and the slab
        packs' static rows."""
        i64 = torch.int64
        e0, e1 = layout.elastic_range
        n_el = e1 - e0
        # original id -> moving sorted row (walls stay -1)
        inv_m = torch.full((n,), -1, dtype=i64, device=dev)
        inv_m[orig_of_sorted] = torch.arange(n_mov, device=dev)
        liq_s = _pad_to(
            (state.ptype[orig_of_sorted] == LIQUID_PARTICLE).to(
                torch.float32), cfg.n_alloc)
        ctx["liq_s"] = liq_s
        el_rows = inv_m[e0:e1]
        perm = torch.argsort(el_rows)
        els = el_rows[perm]
        ctx["els"] = els
        tables_m = ctx["tables_m"]
        lo_t, hi_t, ob_t = tables_m[1], tables_m[2], tables_m[5]
        lo_c = torch.searchsorted(els, lo_t.to(i64), right=False,
                                  out_int32=True)
        hi_c = torch.searchsorted(els, hi_t.to(i64), right=False,
                                  out_int32=True)
        aln_c, s0_c, cnt_c = F._tile_chunks(lo_c, hi_c, nb_m, ccol_c)
        mcap = -(-n_el // ALIGN) * ALIGN + ccol_c
        zero_cnt = torch.zeros_like(cnt_c)

        if springs.n_elastic > 0:
            rmap = torch.full((n,), -1, dtype=i64, device=dev)
            rmap[springs.row_ids.long()] = torch.arange(springs.n_elastic,
                                                        device=dev)
            r_of_col = rmap[e0:e1][perm]
            has_row = (r_of_col >= 0)[:, None]
            r_safe = torch.clamp(r_of_col, min=0)
            # every -1 (pad slot, column without a row) is clamped before it
            # indexes, then masked
            sidx = torch.where(has_row,
                               springs.idx[r_safe, :n_slots].long(), -1)
            used = sidx >= 0
            idx_f = torch.where(
                used, inv_m[torch.clamp(sidx, min=0)].to(torch.float32),
                -1.0)
            rest_c = torch.where(used, springs.rest[r_safe, :n_slots], 0.0)
            mid = torch.where(used, springs.muscle[r_safe, :n_slots].long(),
                              0)
            # muscle ids outside 1..MUSCLE_COUNT drive nothing
            mid = torch.where((mid >= 1) & (mid <= MUSCLE_COUNT), mid, 0)
            ctx["spr_mid"] = mid.T.contiguous()          # [n_slots, n_el]
            pack = torch.zeros((pk.spr_cols(n_slots), mcap),
                               dtype=torch.float32, device=dev)
            pack[:3] = far
            pack[3:3 + n_slots] = -1.0
            pack[3:3 + n_slots, :n_el] = idx_f.T
            pack[3 + n_slots:3 + 2 * n_slots, :n_el] = rest_c.T
            ctx["spr_pack"] = pack
            own_el = torch.zeros(cfg.n_pad, dtype=torch.bool, device=dev)
            own_el.index_fill_(0, els, True)
            own_el = own_el.reshape(nb_m, B).any(dim=1)
            ctx["spr_tables"] = (
                aln_c, lo_c, hi_c, s0_c,
                torch.where(own_el, cnt_c, zero_cnt), ob_t)
            # the entries the pair form would match, once a period
            ctx["spr_list"] = pk.spring_list(spring_pass, ctx["spr_tables"],
                                             pack)

        if membranes.n_tris > 0:
            pt = membranes.particle_tris[e0:e1].long()   # [n_el, 7]
            ctx["mem_vidx"] = inv_m[membranes.tris.long()]
            ptp = pt[perm]
            ctx["mem_pt_ok"] = (ptp >= 0).reshape(-1, 1)
            ctx["mem_pt_safe"] = torch.clamp(ptp, min=0).reshape(-1)
            has_mem_m = torch.zeros(n_mov, dtype=torch.float32, device=dev)
            has_mem_m[el_rows] = (pt >= 0).any(dim=1).to(torch.float32)
            seg = torch.zeros(npen, dtype=torch.float32, device=dev)
            seg.index_add_(0, pencil_ms.long(), has_mem_m)
            csum = torch.cat([seg.new_zeros(1), torch.cumsum(seg, 0)])
            plo_r, phi_r = pranges
            chunk_mem = (csum[phi_r.long()] - csum[plo_r.long()]).sum(1) > 0
            own_liq = liq_s[:cfg.n_pad].reshape(nb_m, B).max(dim=1)[0] > 0
            ctx["mem_tables"] = (
                aln_c, lo_c, hi_c, s0_c,
                torch.where(chunk_mem & own_liq, cnt_c, zero_cnt), ob_t)
            pack = torch.zeros((pk.MEM_COLS, mcap), dtype=torch.float32,
                               device=dev)
            pack[6 * pk.MEM_TRIS:] = far
            ctx["mem_pack"] = pack

    def carry_of(ctx, state: FluidState):
        src = ctx["orig_of_sorted"]
        pos, vel = state.pos[src], state.vel[src]

        def srt(a, fill=0.0):
            return _pad_to(a.contiguous(), cfg.n_alloc, fill)

        return (
            srt(pos[:, 0], far), srt(pos[:, 1], far), srt(pos[:, 2], far),
            srt(vel[:, 0]), srt(vel[:, 1]), srt(vel[:, 2]),
            state.muscle_activation, state.step,
            torch.zeros((), dtype=torch.float32, device=dev),
        )

    have_walls = n_wall > 0

    def _density(ctx, pos_pack):
        """(rho of the moving rows [n_pad], rho of the shell rows or None)
        from the three raw rho* passes at the packed positions."""
        tables_m = ctx["tables_m"]
        s_mm = passes["raw_mm"](tables_m, pos_pack, pos_pack)
        if not have_walls:
            return c_rho * torch.clamp((s_mm - self3) * inv_h6, min=1.0), None
        shp = ctx["shell_pos_pack"]
        s_mw = passes["raw_ms"](ctx["tables_ms"], pos_pack, shp)
        rho_m = c_rho * torch.clamp((s_mm - self3 + s_mw) * inv_h6, min=1.0)
        s_sm = passes["raw_sm"](ctx["tables_sm"], shp, pos_pack)
        rho_sh = c_rho * torch.clamp((s_sm + ctx["ww_const"]) * inv_h6,
                                     min=1.0)
        return rho_m, rho_sh

    def density(state: FluidState, springs: Springs, membranes: Membranes):
        ctx, _ = sort_ctx(state, springs, membranes)
        xs, ys, zs = carry_of(ctx, state)[:3]
        rho_m, _ = _density(ctx, F._pack([xs, ys, zs]))
        rho = torch.full((n,), float("nan"), dtype=torch.float32, device=dev)
        rho[ctx["orig_of_sorted"]] = rho_m[:n_mov]
        return rho

    def inner_step(ctx, carry):
        xs, ys, zs, vxs, vys, vzs, act, step_no, drift = carry
        tables_m = ctx["tables_m"]
        raw_mm, raw_ms, raw_sm = (passes["raw_mm"], passes["raw_ms"],
                                  passes["raw_sm"])

        # ---- density (moving + shell-wall rows) ----
        rho_m, rho_sh = _density(ctx, F._pack([xs, ys, zs]))
        inv_rho_m = 1.0 / rho_m                      # [n_pad]

        # ---- external forces (viscosity + surface tension) ----
        main1 = F._pack([
            xs, ys, zs, vxs, vys, vzs,
            _pad_to(inv_rho_m, cfg.n_alloc, 1.0), torch.zeros_like(xs),
        ])
        vx, vy, vz, stx, sty, stz = passes["visc_mm"](tables_m, main1, main1)
        if have_walls:
            sxs, sys_, szs, snx, sny, snz, _ = ctx["shell_static"]
            shell_v = F._pack([
                sxs, sys_, szs, snx, sny, snz,
                _pad_to(1.0 / rho_sh, cfg.shell_alloc, 1.0),
                torch.zeros_like(sxs),
            ])
            vx2, vy2, vz2, sx2, sy2, sz2 = passes["visc_ms"](
                ctx["tables_ms"], main1, shell_v)
            vx, vy, vz = vx + vx2, vy + vy2, vz + vz2
            stx, sty, stz = stx + sx2, sty + sy2, stz + sz2
        aex = c_visc * vx * inv_rho_m + c_surf * stx + gx
        aey = c_visc * vy * inv_rho_m + c_surf * sty + gy
        aez = c_visc * vz * inv_rho_m + c_surf * stz + gz

        # ---- elastic + muscle forces ----
        if "spr_pack" in ctx:
            els = ctx["els"]
            n_el = els.shape[0]
            spr_pack = ctx["spr_pack"]
            spr_pack[:3, :n_el] = main1[:3][:, els]
            # per-spring activation term: muscle id 0 (plain spring) -> 0
            act_ext = torch.cat([act.new_zeros(1), act * muscle_force])
            spr_pack[3 + 2 * n_slots:, :n_el] = act_ext[ctx["spr_mid"]]
            sfx, sfy, sfz = passes["spring_ms"](ctx["spr_list"], main1,
                                                spr_pack)
            aex = aex + sfx
            aey = aey + sfy
            aez = aez + sfz

        # ---- PCISPH prediction-correction ----
        zeros = torch.zeros(cfg.n_pad, dtype=torch.float32, device=dev)
        p_m, apx, apy, apz = zeros, zeros, zeros, zeros
        if have_walls:
            p_sh = torch.zeros(cfg.shell_cap, dtype=torch.float32,
                               device=dev)
        own_x, own_y, own_z = xs[:cfg.n_pad], ys[:cfg.n_pad], zs[:cfg.n_pad]
        own_vx = vxs[:cfg.n_pad]
        own_vy = vys[:cfg.n_pad]
        own_vz = vzs[:cfg.n_pad]

        for _ in range(params.n_pcisph_iters):
            xst = own_x + pos_dt * (own_vx + dt * apx)
            yst = own_y + pos_dt * (own_vy + dt * apy)
            zst = own_z + pos_dt * (own_vz + dt * apz)
            iter_pack = F._pack([
                _pad_to(xst, cfg.n_alloc, far),
                _pad_to(yst, cfg.n_alloc, far),
                _pad_to(zst, cfg.n_alloc, far),
            ])
            rs_mm = raw_mm(tables_m, iter_pack, iter_pack)
            if have_walls:
                rs_mw = raw_ms(ctx["tables_ms"], iter_pack,
                               ctx["shell_pos_pack"])
                rho_star = c_rho * torch.clamp(
                    (rs_mm - self3 + rs_mw) * inv_h6, min=1.0)
                rs_sm = raw_sm(ctx["tables_sm"], ctx["shell_pos_pack"],
                               iter_pack)
                rho_star_sh = c_rho * torch.clamp(
                    (rs_sm + ctx["ww_const"]) * inv_h6, min=1.0)
                p_sh = p_sh + torch.clamp(
                    (rho_star_sh - rho0) * delta_c, min=0.0)
            else:
                rho_star = c_rho * torch.clamp(
                    (rs_mm - self3) * inv_h6, min=1.0)
            p_m = p_m + torch.clamp((rho_star - rho0) * delta_c, min=0.0)
            pa_pack = F._pack([
                xs, ys, zs,
                _pad_to(1.0 / torch.clamp(rho_star, min=1.0), cfg.n_alloc,
                        1.0),
                _pad_to(p_m, cfg.n_alloc),
            ])
            fx, fy, fz = passes["pacc_mm"](tables_m, pa_pack, pa_pack)
            if have_walls:
                sxs, sys_, szs = ctx["shell_static"][:3]
                sh_pa = F._pack([
                    sxs, sys_, szs,
                    _pad_to(1.0 / torch.clamp(rho_star_sh, min=1.0),
                            cfg.shell_alloc, 1.0),
                    _pad_to(p_sh, cfg.shell_alloc),
                ])
                fx2, fy2, fz2 = passes["pacc_ms"](ctx["tables_ms"], pa_pack,
                                                  sh_pa)
                fx, fy, fz = fx + fx2, fy + fy2, fz + fz2
            coef = c_press / rho_star
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

        # ---- Ihmsen boundary response (shell columns) ----
        if have_walls or "mem_pack" in ctx:
            own_pack = F._pack(
                [xs, ys, zs, _pad_to(xn, cfg.n_alloc, far),
                 _pad_to(yn, cfg.n_alloc, far),
                 _pad_to(zn, cfg.n_alloc, far)],
            )
        if have_walls:
            ncx, ncy, ncz, wsum, w2sum = passes["bnd_ms"](
                ctx["tables_ms"], own_pack, ctx["bnd_pack"])
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
            mnx, mny, mnz, mws, mw2 = passes["mem_ms"](
                ctx["mem_tables"], own_pack, mem_pack)
            ml2 = mnx * mnx + mny * mny + mnz * mnz
            mhas = (ml2 > 0) & (ctx["liq_s"][:cfg.n_pad] > 0)
            mcoef = torch.where(
                mhas,
                torch.rsqrt(torch.clamp(ml2, min=1e-30))
                * mw2 / torch.clamp(mws, min=1e-30),
                0.0,
            )
            xn = xn + mnx * mcoef
            yn = yn + mny * mcoef
            zn = zn + mnz * mcoef

        # pad rows stay pinned at `far` with zero velocity
        xn = torch.where(pad_mask, own_x, xn)
        yn = torch.where(pad_mask, own_y, yn)
        zn = torch.where(pad_mask, own_z, zn)
        vax = torch.where(pad_mask, 0.0, vax)
        vay = torch.where(pad_mask, 0.0, vay)
        vaz = torch.where(pad_mask, 0.0, vaz)

        if layout.muscle_model:
            act = muscle.next_activation(step_no)

        d2 = ((xn - own_x) * (xn - own_x)
              + (yn - own_y) * (yn - own_y)
              + (zn - own_z) * (zn - own_z))
        drift = drift + torch.sqrt(torch.max(d2))

        return (
            _pad_to(xn, cfg.n_alloc, far), _pad_to(yn, cfg.n_alloc, far),
            _pad_to(zn, cfg.n_alloc, far),
            _pad_to(vax, cfg.n_alloc), _pad_to(vay, cfg.n_alloc),
            _pad_to(vaz, cfg.n_alloc),
            act, step_no + 1, drift,
        )

    def unsort_state(ctx, carry, state: FluidState) -> FluidState:
        xs, ys, zs, vtx, vty, vtz, act, step_no, _drift = carry
        dest = ctx["orig_of_sorted"]
        pos = state.pos.clone()
        vel = state.vel.clone()
        pos[dest] = torch.stack([xs[:n_mov], ys[:n_mov], zs[:n_mov]], 1)
        vel[dest] = torch.stack([vtx[:n_mov], vty[:n_mov], vtz[:n_mov]], 1)
        return FluidState(
            pos=pos, vel=vel, ptype=state.ptype, normal=state.normal,
            muscle_activation=act, step=step_no,
        )

    return StepParts(sort_ctx, carry_of, inner_step, unsort_state, passes,
                     density)


def make_fastw_multi_step(params, layout, cfg: FastWConfig,
                          n_steps: int = 1, return_diag: bool = False,
                          wall_static=None, cuda_graph: bool = True):
    """run(state, springs, membranes) -> state after n_steps. One sort per
    resort period (``cfg.resort_every`` steps, the last period shorter).
    ``return_diag``: also return a dict with the window-staleness drift
    bound and the shell/tile overflow counts (max over the call's resort
    periods), all device tensors — overflow means pairs were DROPPED and
    must be surfaced loudly by the caller. ``cuda_graph``: for a state on
    the card, each period length captured once as a CUDA graph and
    replayed (``core.graphed``); False, or a state on the CPU, is the
    eager loop."""
    parts = _make_step_parts_w(params, layout, cfg, wall_static=wall_static)
    run_periods = graphed.period_runner(parts, n_steps, cfg.resort_every,
                                        cuda_graph)

    def run(state, springs, membranes):
        state, diag = run_periods(state, springs, membranes)
        if return_diag:
            return state, diag
        return state

    return run


def make_fastw_stepper(params, layout, cfg: FastWConfig,
                       inner_steps: int = 10, wall_static=None):
    """Stateful stepping API: (sort, inner, unsort). ``sort`` returns
    (ctx, carry, diag); ``inner`` advances the carry ``inner_steps`` steps;
    ``unsort`` writes it back into original order."""
    parts = _make_step_parts_w(params, layout, cfg, wall_static=wall_static)

    def sort(state, springs, membranes):
        ctx, diag = parts.sort_ctx(state, springs, membranes)
        return ctx, parts.carry_of(ctx, state), diag

    def inner(ctx, carry):
        for _ in range(inner_steps):
            carry = parts.inner_step(ctx, carry)
        return carry

    return sort, inner, parts.unsort_state
