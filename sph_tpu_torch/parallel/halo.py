"""The z-slab halo-exchange fast engine: the multi-GPU path (counterpart of
``sph_tpu/parallel/halo.py``).

Domain decomposition: the fast engine keeps particles sorted by cell id in
z-major order, so a contiguous range of the sorted array IS a z-slab of the
world. Each rank owns ``n_blocks_loc`` consecutive own blocks (equal
particle counts: load balanced by construction) plus a fixed-capacity halo
band of ``halo_pad`` sorted rows on each side. Between spatial resorts the
only per-step communication is the halo exchange: a send to each neighbour
(``Comm.send_next`` / ``send_prev``) a field group, each moving
``halo_pad`` rows.

Cell size h >= the interaction radius, so one cell-row halos suffice;
``halo_pad`` must cover the particles of one z cell-row plus alignment
slack. It is validated at every resort: ``halo_overflow`` counts the window
bounds the band clipped (pairs dropped; raise the pad).

The spatial resort has two forms (``distributed_resort``): the replicated
one (positions all-gathered, every rank computes the global sort and window
tables; O(N) traffic once a resort period), and the distributed one: global
sorted ranks from an all-gathered per-CELL histogram plus per-rank prefix
counts, neighbour-only migration through fixed-capacity buffers, window
tables from the histogram's pencil offsets; original order exists only at a
call's entry and exit. Springs and membranes run on the compact elastic
subset in LOCAL slab coordinates, with no per-step collective in either
form.

The same stages, tables and arithmetic as ``sph_tpu``'s engine; its pair
passes are ``ops.pair_kernels``' (the Hopper kernels on CUDA tensors, the
plain versions on CPU tensors), all at the main tile width ``cfg.ccol``, as
``sph_tpu``'s halo engine builds them. Differences:

* one process a rank, each running the functions below with its ``Comm``
  (``sph_tpu`` traces them once under ``shard_map``); the steps are eager:
  every step needs collectives, which a CUDA graph cannot capture when
  gloo stages them through the host;
* every scatter that ``sph_tpu`` writes with ``mode="drop"`` (or whose
  targets may fall outside the array) goes through an explicit scratch
  slot or a mask here: torch raises on an out-of-range index on the CPU
  and asserts on the card;
* the spring activation term is a gather ``act_ext[muscle id]`` where
  ``sph_tpu`` contracts a one-hot matrix at full precision (the same f32
  values), and the spring pass runs on its list (``pair_kernels.
  spring_list``), built once a resort period: the same sums;
* the ring kernels' tile offsets are checked once a resort, where the
  tables are built (``pair_kernels.check_tile_offsets``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import SimParams
from ..constants import BOUNDARY_PARTICLE, LIQUID_PARTICLE, MUSCLE_COUNT
from ..core import fast as F
from ..core.elastic import spring_accel
from ..core.state import FluidState
from ..core.step import SceneLayout
from ..models import muscle
from ..ops import pair_kernels as pk
from .comm import Comm

ALIGN = pk.ALIGN
I64 = torch.int64
F32 = torch.float32


def _two_row_peak(pos, params: SimParams, cfg: F.FastConfig) -> int:
    """The densest two consecutive z cell-rows' particle count."""
    nz = cfg.dims[2]
    zrow = np.clip(
        (np.asarray(pos)[:, 2] - params.z_min) / params.h, 0, nz - 1
    ).astype(np.int64)
    counts = np.bincount(zrow, minlength=nz)
    return int((counts[:-1] + counts[1:]).max()) if nz > 1 else int(
        counts.max())


def measure_halo_pad(pos, params: SimParams, cfg: F.FastConfig,
                     margin: float = 1.5) -> int:
    """Scene-measured halo band size (rows exchanged per edge).

    An edge block's interaction window reaches into the neighbouring
    z-slab by at most its own (partial) z-row plus one full z-row, plus
    the ccol tile overhang. The bound used is ``margin`` x the densest
    two consecutive z-rows of the build-time scene + ccol, ALIGN-rounded:
    resort-time drift is covered by the margin, and any violation is
    surfaced (and pairs dropped) via the halo_overflow diagnostic."""
    need = int(margin * _two_row_peak(pos, params, cfg)) + cfg.ccol
    return max(ALIGN, -(-need // ALIGN) * ALIGN)


def measure_migration_pad(pos, params: SimParams, cfg: F.FastConfig,
                          margin: float = 1.5) -> int:
    """Scene-measured migration buffer size (rows per direction per
    resort) for the distributed resort, mirroring :func:`measure_halo_pad`.

    Rows migrate when their global sorted rank crosses a rank boundary
    between resorts. With the per-period pair-approach drift bound held
    under h, a row's CELL can change by at most one cell row, so every
    migrant was within the two z cell-rows straddling the boundary at the
    previous resort; rank shifts induced by other rows' cell changes are
    bounded by the same two-row population. Violations are surfaced, and
    the overflowing rows dropped, via ``diag["resort_overflow"]``."""
    need = int(margin * _two_row_peak(pos, params, cfg))
    return max(ALIGN, -(-need // ALIGN) * ALIGN)


def _scatter(size, fill, idx, val):
    """A [size] tensor of ``fill`` with ``val`` written at ``idx``; an index
    outside [0, size) goes to a scratch slot and is dropped (``sph_tpu``'s
    ``.at[idx].set(val, mode="drop")``)."""
    ok = (idx >= 0) & (idx < size)
    out = val.new_full((size + 1,), fill)
    out[torch.where(ok, idx, size)] = val
    return out[:size]


def _scatter_add(size, idx, val):
    """Zeros [size] (or [k, size] for a 2-D ``val``) with ``val`` added at
    ``idx`` (last dim); out-of-range indices dropped."""
    ok = (idx >= 0) & (idx < size)
    out = val.new_zeros((*val.shape[:-1], size + 1))
    out.index_add_(val.dim() - 1, torch.where(ok, idx, size), val)
    return out[..., :size]


def make_halo_fast_multi_step(
    comm: Comm,
    params: SimParams,
    layout: SceneLayout,
    cfg: F.FastConfig,
    n_steps: int = 1,
    halo_pad: int | None = None,
    distributed_resort: bool = False,
    mig_cap: int | None = None,
    _session: bool = False,
):
    """``run(state, springs, membranes) -> (state, diag)`` on every rank,
    ``state`` the rank's shard (``parallel.sharded.shard_state``), springs
    and membranes replicated. ``diag = {"halo_overflow": int,
    "window_drift": f32}``, plus ``"resort_overflow"`` with the distributed
    resort (rows that could not migrate: DROPPED), each the same on every
    rank; overflow is the count of window bounds clipped by the halo band
    (pairs dropped; raise halo_pad), window_drift the staleness bound of
    ``core.fast``.

    ``cfg.n_particles`` must be a multiple of ``world * cfg.block`` (pad the
    scene with ``pad_scene_to_devices`` to ``world * block``) and
    ``cfg.n_blocks`` must divide across the ranks
    (``compute_fast_config(..., block_multiple=lcm(8, world))``).
    ``run.passes`` is the dict of the engine's pair passes, looked up at
    call time (a caller may wrap one to record its inputs)."""
    ndev = comm.world
    if halo_pad is None:
        # default: 4096 rows, clamped to the per-rank row count (the
        # halo_overflow diagnostic reports if physics needs more)
        per_dev = (cfg.n_blocks // max(ndev, 1)) * cfg.block
        halo_pad = max(ALIGN, min(4096, (per_dev // ALIGN) * ALIGN))
    if halo_pad % ALIGN:
        raise ValueError(f"halo_pad {halo_pad} is not a multiple of {ALIGN}")
    n = cfg.n_particles
    if n % (ndev * cfg.block):
        raise ValueError(f"n_particles {n} must be a multiple of "
                         f"ranks*block {ndev * cfg.block}")
    if cfg.n_blocks % ndev:
        raise ValueError(
            f"n_blocks {cfg.n_blocks} must divide across {ndev} ranks: "
            "build the config with compute_fast_config(..., "
            "block_multiple=lcm(8, ranks))")
    if layout.n_elastic > 0 and not layout.springs_anchors_static:
        raise ValueError(
            "halo engine: springs anchored to moving (liquid) particles "
            "would reuse stale resort-time positions for up to "
            "resort_every steps; only elastic/boundary anchors are exact")
    nb_loc = cfg.n_blocks // ndev
    B = cfg.block
    n_pad_loc = nb_loc * B
    if n_pad_loc < halo_pad:
        raise ValueError(f"halo_pad {halo_pad} exceeds per-rank rows "
                         f"{n_pad_loc}; use a smaller halo_pad or fewer "
                         "ranks")
    n_loc = n // ndev
    # local slab: [left halo | own rows | right halo | tile overhang]
    slab_size = n_pad_loc + 2 * halo_pad + cfg.ccol
    own_off = halo_pad  # own rows always start here in the slab
    own = slice(own_off, own_off + n_pad_loc)
    # the global sorted coordinate system is shifted by +halo_pad so that
    # rank 0's slab start (o0 - halo_pad) is never negative
    P0 = halo_pad
    galloc = P0 + cfg.n_pad + cfg.ccol + halo_pad

    f32 = np.float32
    far = float(f32(
        max(params.x_max, params.y_max, params.z_max) + 100.0 * params.h))
    nx, ny, nz = cfg.dims
    rk = comm.rank

    inv_h2 = f32(1.0 / (params.h * params.h))
    inv_h = f32(1.0 / params.h)
    c_rho = f32(params.c_rho)
    r0 = f32(params.r0)
    kw = dict(block=B, ccol=cfg.ccol, n_blocks=nb_loc, inv_h2=inv_h2)
    # the subgroup gate applies to the four main-window passes, as in
    # core.fast; gate windows are rebuilt in LOCAL slab coordinates
    sub_on = bool(cfg.sub and cfg.sub < B)
    n_grp = B // cfg.sub if sub_on else 0
    mkw = dict(kw, sub=cfg.sub)
    n_slots = layout.spring_slots
    use_spring_pass = layout.n_elastic > 0 and layout.springs_elastic_only
    passes = dict(
        density=pk.make_density_pass(c_rho=c_rho, **mkw),
        viscsurf=pk.make_viscsurf_pass(**mkw),
        rho_star=pk.make_rho_star_pass(c_rho=c_rho, **mkw),
        paccel=pk.make_paccel_pass(
            inv_h=inv_h, rho0_delta=f32(params.rho0 * params.delta), **mkw),
        boundary=pk.make_boundary_pass(r0=r0, **kw),
        membrane=pk.make_membrane_pass(r0=r0, **kw),
    )
    if use_spring_pass:
        passes["spring"] = pk.make_spring_pass(
            inv_h=inv_h, h_scale=f32(params.h * params.simulation_scale),
            k_spring=f32(params.k_spring), n_slots=n_slots, **kw)
    # the list is built from the pass itself (a caller may wrap passes[])
    spring_pass = passes.get("spring")
    muscle_force = float(f32(params.muscle_force))

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

    def exchange(own_fields, fills):
        """Local slabs from own rows plus the neighbours' edge rows.

        own_fields: list of [n_pad_loc] tensors. Returns [slab_size] rows:
        [prev tail | own | next head | fill]. The chain's ends receive the
        per-field fill (positions -> far): the maskless kernels have no
        window test, and zero-position columns would sit at the box
        origin corner inside reach of real particles."""
        stack = torch.stack(own_fields, 0)                # [k, n_pad_loc]
        fillc = torch.tensor(fills, dtype=F32, device=stack.device)[:, None]
        tail = comm.send_next(stack[:, -halo_pad:].contiguous(), fillc)
        head = comm.send_prev(stack[:, :halo_pad].contiguous(), fillc)
        out = torch.cat([tail, stack, head,
                         fillc.expand(len(own_fields), cfg.ccol)], dim=1)
        return list(out)

    def inner_body(ctx, carry):
        """One sorted-space local step. Every per-resort product (window
        tables, static slabs, spring and membrane contexts) comes from
        ``ctx``, so both resorts share this body."""
        xo, yo, zo, vxo, vyo, vzo, act, step_no, drift = carry
        isb_s = ctx["isb_s"]
        nxs, nys, nzs = ctx["nxs"], ctx["nys"], ctx["nzs"]
        bmask = ctx["bmask"]
        tables = ctx["tables"]
        force_tables = ctx["force_tables"]

        xs, ys, zs, vxs_t, vys_t, vzs_t = exchange(
            [xo, yo, zo, vxo, vyo, vzo], [far, far, far, 0.0, 0.0, 0.0])
        # boundary rows carry wall normals as "velocity"
        isb = isb_s > 0
        vxs = torch.where(isb, nxs, vxs_t)
        vys = torch.where(isb, nys, vys_t)
        vzs = torch.where(isb, nzs, vzs_t)

        # the density pass reads x, y, z only (the 3-row position pack)
        pos_pack = F._pack([xs, ys, zs])
        rho_o = passes["density"](tables, pos_pack, pos_pack)
        rho_o = torch.where(rho_o <= 0, 1.0, rho_o)
        inv_rho_o = 1.0 / rho_o  # the passes take 1/rho (no pair divide)
        (inv_rho_s,) = exchange([inv_rho_o], [1.0])

        main1 = F._pack([xs, ys, zs, vxs, vys, vzs, inv_rho_s, isb_s])
        vx, vy, vz, stx, sty, stz = passes["viscsurf"](force_tables, main1,
                                                       main1)
        not_b = ctx["not_b"]
        aex = (c_visc * vx * inv_rho_o + c_surf * stx + gx) * not_b
        aey = (c_visc * vy * inv_rho_o + c_surf * sty + gy) * not_b
        aez = (c_visc * vz * inv_rho_o + c_surf * stz + gz) * not_b

        if "spr_list" in ctx:
            # the compact-slab spring pass over the LOCAL slab, no
            # collective: partners of owned rows are inside the band
            n_el = ctx["n_el"]
            spr_pack = ctx["spr_pack"]
            col_ok, col_safe = ctx["spr_col_ok"], ctx["spr_col_safe"]
            for k, a in enumerate((xs, ys, zs)):
                spr_pack[k, :n_el] = torch.where(col_ok, a[col_safe], far)
            # per-spring activation term: muscle id 0 (plain spring) -> 0
            act_ext = torch.cat([act.new_zeros(1), act * muscle_force])
            spr_pack[3 + 2 * n_slots:3 + 3 * n_slots, :n_el] = act_ext[
                ctx["spr_mid"]]
            sfx, sfy, sfz = passes["spring"](ctx["spr_list"], main1,
                                             spr_pack)
            aex = aex + sfx
            aey = aey + sfy
            aez = aez + sfz
        elif "fb_row_eid" in ctx:
            # the gather fallback: elastic endpoints from a [3, n_el] psum
            # of the owned elastic rows, anything else (boundary, which
            # never moves) from the entry-time original-order positions
            n_el = ctx["n_el"]
            ebuf = comm.psum(_scatter_add(
                n_el, ctx["fb_eid_rows"], torch.stack([xo, yo, zo])))
            ep_eid, row_eid = ctx["fb_ep_eid"], ctx["fb_row_eid"]
            ep = torch.where((ep_eid >= 0)[..., None],
                             ebuf[:, torch.clamp(ep_eid, min=0)]
                             .permute(1, 2, 0), ctx["fb_static"])
            rows = ebuf[:, torch.clamp(row_eid, min=0)].T
            a_e = spring_accel(rows, ep, ctx["springs"], act, params)
            tgt = ctx["fb_own_rows_local"]
            ae = _scatter_add(n_pad_loc, tgt, a_e.T.contiguous())
            aex, aey, aez = aex + ae[0], aey + ae[1], aez + ae[2]

        # PCISPH
        zeros = torch.zeros(n_pad_loc, dtype=F32, device=xo.device)
        p_o, apx, apy, apz = zeros, zeros, zeros, zeros
        own_x, own_y, own_z = xs[own], ys[own], zs[own]
        for _ in range(params.n_pcisph_iters):
            xst = torch.where(bmask, own_x, own_x + pos_dt * (vxo + dt * apx))
            yst = torch.where(bmask, own_y, own_y + pos_dt * (vyo + dt * apy))
            zst = torch.where(bmask, own_z, own_z + pos_dt * (vzo + dt * apz))
            xsts, ysts, zsts = exchange([xst, yst, zst], [far, far, far])
            iter_pack = F._pack([xsts, ysts, zsts])
            rho_star = passes["rho_star"](tables, iter_pack, iter_pack)
            p_o = p_o + torch.clamp((rho_star - rho0) * delta_c, min=0.0)
            irs_s, p_s = exchange(
                [1.0 / torch.clamp(rho_star, min=1.0), p_o], [1.0, 0.0])
            pa_pack = F._pack([xs, ys, zs, irs_s, p_s])
            fx, fy, fz = passes["paccel"](force_tables, pa_pack, pa_pack)
            coef = torch.where(bmask, 0.0, c_press / rho_star)
            apx, apy, apz = coef * fx, coef * fy, coef * fz

        # integrate
        vnx = vxo + dt * (aex + apx)
        vny = vyo + dt * (aey + apy)
        vnz = vzo + dt * (aez + apz)
        xn = torch.clamp(own_x + pos_dt * vnx, lo_box[0], hi_box[0])
        yn = torch.clamp(own_y + pos_dt * vny, lo_box[1], hi_box[1])
        zn = torch.clamp(own_z + pos_dt * vnz, lo_box[2], hi_box[2])
        vax = (vxo + vnx) * 0.5
        vay = (vyo + vny) * 0.5
        vaz = (vzo + vnz) * 0.5

        xns, yns, zns = exchange([xn, yn, zn], [far, far, far])
        own_pack = F._pack([xs, ys, zs, xns, yns, zns])
        bnd_pack = F._pack([xs, ys, zs, nxs, nys, nzs, isb_s])
        ncx, ncy, ncz, wsum, w2sum = passes["boundary"](
            ctx["bnd_tables"], own_pack, bnd_pack)
        nlen2 = ncx * ncx + ncy * ncy + ncz * ncz
        has = nlen2 > 0
        coef = torch.where(
            has,
            torch.rsqrt(torch.clamp(nlen2, min=1e-30))
            * w2sum / torch.clamp(wsum, min=1e-30),
            0.0)
        xn = xn + ncx * coef
        yn = yn + ncy * coef
        zn = zn + ncz * coef
        vn_dot = ncx * vax + ncy * vay + ncz * vaz
        fric = has & (vn_dot < 0)
        vax = torch.where(fric, (vax - ncx * vn_dot) * 0.99, vax)
        vay = torch.where(fric, (vay - ncy * vn_dot) * 0.99, vay)
        vaz = torch.where(fric, (vaz - ncz * vn_dot) * 0.99, vaz)

        if "mem_tri_cols" in ctx:
            # triangle geometry from the LOCAL slab (no collective);
            # triangles with ANY out-of-slab vertex are zeroed: they can
            # only belong to zero-weight columns on this rank
            tri_cols = ctx["mem_tri_cols"]
            n_tri = tri_cols.shape[0]
            n_el = ctx["n_el"]
            xyz_n = torch.stack([xns, yns, zns], dim=1)      # [slab, 3]
            vabc = xyz_n[tri_cols.reshape(-1)].reshape(n_tri, 3, 3)
            a3 = vabc[:, 0]
            tn = torch.linalg.cross(vabc[:, 1] - a3, vabc[:, 2] - a3) \
                * ctx["mem_tri_in_slab"]
            tl2 = (tn * tn).sum(dim=1, keepdim=True)
            til = torch.where(
                tl2 > 0, torch.rsqrt(torch.clamp(tl2, min=1e-30)), 0.0)
            tri6 = torch.cat([tn * til, a3], dim=1)          # [n_tri, 6]
            g = torch.where(ctx["mem_t_ok"].reshape(-1, 1),
                            tri6[ctx["mem_t_safe"].reshape(-1)], 0.0)
            tri_mat = g.reshape(n_el, 6 * pk.MEM_TRIS).T     # [42, n_el]
            mem_pack = torch.zeros((pk.MEM_COLS, slab_size), dtype=F32,
                                   device=xo.device)
            # the elastic columns inside the slab (chosen at the resort)
            mem_pack[:6 * pk.MEM_TRIS, ctx["mem_cols"]] = tri_mat[
                :, ctx["mem_els"]]
            mem_pack[pk.PMM_XN:] = torch.stack([xns, yns, zns, xs, ys, zs])
            mnx, mny, mnz, mws, mw2 = passes["membrane"](
                ctx["mem_tables"], own_pack, mem_pack)
            ml2 = mnx * mnx + mny * mny + mnz * mnz
            mhas = (ml2 > 0) & (ctx["liq_s"][own] > 0)
            mcoef = torch.where(
                mhas,
                torch.rsqrt(torch.clamp(ml2, min=1e-30))
                * mw2 / torch.clamp(mws, min=1e-30),
                0.0)
            xn = xn + mnx * mcoef
            yn = yn + mny * mcoef
            zn = zn + mnz * mcoef

        # pin boundary rows
        xn = torch.where(bmask, own_x, xn)
        yn = torch.where(bmask, own_y, yn)
        zn = torch.where(bmask, own_z, zn)
        vax = torch.where(bmask, vxo, vax)
        vay = torch.where(bmask, vyo, vay)
        vaz = torch.where(bmask, vzo, vaz)

        if layout.muscle_model:
            act = muscle.next_activation(step_no)
        # window-staleness bound: per-step max displacement, summed over
        # the period (see core.fast)
        d2 = ((xn - own_x) * (xn - own_x)
              + (yn - own_y) * (yn - own_y)
              + (zn - own_z) * (zn - own_z))
        drift = drift + torch.sqrt(torch.max(d2))
        return (xn, yn, zn, vax, vay, vaz, act, step_no + 1, drift)

    def finish_window_tables(lo_l, hi_l, base):
        """Clamp shifted-global window bounds into the local slab and
        re-chunk into disjoint, covering tiles. Returns (tables, lo_c, hi_c,
        cnt_new, overflow_local); overflow counts clipped bounds (pairs
        dropped; raise halo_pad). Checks the ring's tile offsets (one host
        read a resort)."""
        slab_lo = base
        slab_hi = base + n_pad_loc + 2 * halo_pad
        lo_c = torch.clamp(lo_l, slab_lo, slab_hi)
        hi_c = torch.clamp(hi_l, slab_lo, slab_hi)
        overflow = (lo_l != lo_c).sum() + (hi_l != hi_c).sum()
        lo_loc = lo_c - base
        hi_loc = hi_c - base
        aln, s0, cnt = F._tile_chunks(lo_loc, hi_loc, nb_loc, cfg.ccol)
        pk.check_tile_offsets(aln, "halo window tables")
        ob = torch.full((1,), own_off, dtype=torch.int32, device=aln.device)
        tables = (aln, lo_loc.to(torch.int32), hi_loc.to(torch.int32), s0,
                  cnt, ob)
        return tables, lo_c, hi_c, cnt, overflow

    def gate_local(glo_l, ghi_l, base):
        """Subgroup gate windows in local slab coordinates, clamped to the
        slab like the main windows (tiles exist only inside the clamped
        main windows, so this loses nothing relative to the tile set)."""
        slab_lo = base
        slab_hi = base + n_pad_loc + 2 * halo_pad
        return ((torch.clamp(glo_l, slab_lo, slab_hi) - base)
                .to(torch.int32).contiguous(),
                (torch.clamp(ghi_l, slab_lo, slab_hi) - base)
                .to(torch.int32).contiguous())

    def gated(cnt, keep):
        return torch.where(keep, cnt, torch.zeros_like(cnt))

    def build_spring_ctx(springs, el_rows, partner_row_of, base, lo_c, hi_c,
                         eid_own_rows, ob, n_el):
        """The compact-slab spring context: partner ids rewritten into LOCAL
        slab coordinates, out-of-slab columns poisoned, and the pass's list
        built once for the period. ``partner_row_of(orig_ids)`` maps
        original particle ids to global sorted rows (the only piece that
        differs between the two resorts)."""
        dev_t = el_rows.device
        e0, _ = layout.elastic_range
        mcap_s = -(-n_el // ALIGN) * ALIGN + cfg.ccol
        perm_e = torch.argsort(el_rows)               # the rows are unique
        els_g = el_rows[perm_e]                        # ascending rows
        rmap = torch.full((n,), -1, dtype=I64, device=dev_t)
        rmap[springs.row_ids.long()] = torch.arange(springs.n_elastic,
                                                    device=dev_t)
        r_of_col = rmap[e0 + perm_e]                   # [n_el]
        r_safe = torch.clamp(r_of_col, min=0)
        sidx_c = torch.where((r_of_col >= 0)[:, None],
                             springs.idx[r_safe, :n_slots].long(), -1)
        col_slab = els_g + P0 - base                   # [n_el] slab coord
        col_ok = (col_slab >= 0) & (col_slab < slab_size)
        used = sidx_c >= 0
        idx_slab = torch.where(
            used, partner_row_of(torch.clamp(sidx_c, min=0)) + P0 - base, -1)
        idx_f = torch.where(col_ok[:, None] & used, idx_slab.to(F32), -1.0)
        rest_c = torch.where(used, springs.rest[r_safe, :n_slots], 0.0)
        mid = torch.where(used, springs.muscle[r_safe, :n_slots].long(), 0)
        # muscle ids outside 1..MUSCLE_COUNT drive nothing
        mid = torch.where((mid >= 1) & (mid <= MUSCLE_COUNT), mid, 0)
        pack = torch.zeros((pk.spr_cols(n_slots), mcap_s), dtype=F32,
                           device=dev_t)
        pack[:3] = far
        # pad columns carry partner id -1 (0 would match slab row 0)
        pack[3:3 + n_slots] = -1.0
        pack[3:3 + n_slots, :n_el] = idx_f.T
        pack[3 + n_slots:3 + 2 * n_slots, :n_el] = rest_c.T
        pack = F._pack_rows(pack)
        # windows onto the compact column space (slab-clipped bounds, so
        # only in-slab columns are ever streamed)
        lo_e = torch.searchsorted(els_g, lo_c - P0, out_int32=True)
        hi_e = torch.searchsorted(els_g, hi_c - P0, out_int32=True)
        aln_e, s0_e, cnt_e = F._tile_chunks(lo_e, hi_e, nb_loc, cfg.ccol)
        own_el_blk = (eid_own_rows.reshape(nb_loc, B) >= 0).any(dim=1)
        spr_tables = (aln_e, lo_e, hi_e, s0_e, gated(cnt_e, own_el_blk), ob)
        return dict(
            spr_pack=pack, spr_mid=mid.T.contiguous(), spr_col_ok=col_ok,
            spr_col_safe=torch.clamp(col_slab, 0, slab_size - 1),
            spr_list=pk.spring_list(spring_pass, spr_tables, pack),
            n_el=n_el)

    def build_fallback_ctx(springs, row_eid, ep_eid, static_pos,
                           own_rows_local, eid_own_rows, n_el):
        """The spring gather fallback's context (scenes whose springs
        anchor to walls): eid maps in the ORIGINAL-id domain, the static
        (boundary) endpoints' entry-time positions, and each spring row's
        own-row scatter target."""
        sidx_safe = torch.clamp(springs.idx, min=0).long()
        return dict(
            springs=springs, fb_row_eid=row_eid, fb_ep_eid=ep_eid,
            fb_static=static_pos[sidx_safe],             # [Ne, 32, 3]
            fb_own_rows_local=own_rows_local, fb_eid_rows=eid_own_rows,
            n_el=n_el)

    def build_mem_ctx(membranes, el_rows, tri_rows, base, seg_m, plo_l,
                      phi_l, own_liq, tables, cnt_new, ob):
        """The membrane context: triangle vertices as LOCAL slab
        coordinates, triangles with ANY out-of-slab vertex zeroed (they can
        only feed zero-weight columns on this rank). ``seg_m`` is the
        per-pencil count of membrane-flagged rows."""
        e0, e1 = layout.elastic_range
        n_el = e1 - e0
        pt = membranes.particle_tris[e0:e1].long()
        tri_raw = tri_rows + P0 - base
        tri_in_slab = ((tri_raw >= 0) & (tri_raw < slab_size)).all(
            dim=1, keepdim=True).to(F32)                 # [M, 1]
        el_cols = el_rows - base + P0
        # the elastic columns inside the slab: one host read a resort
        els = torch.nonzero((el_cols >= 0) & (el_cols < slab_size)
                            ).reshape(-1)
        csum_m = torch.cat([seg_m.new_zeros(1), torch.cumsum(seg_m, 0)])
        chunk_mem = (csum_m[phi_l] - csum_m[plo_l]).sum(dim=1) > 0
        mem_tables = tables[:4] + (gated(cnt_new, chunk_mem & own_liq), ob)
        return dict(
            mem_tri_cols=torch.clamp(tri_raw, 0, slab_size - 1),
            mem_tri_in_slab=tri_in_slab, mem_t_ok=pt >= 0,
            mem_t_safe=torch.clamp(pt, min=0), mem_cols=el_cols[els],
            mem_els=els, mem_tables=mem_tables, n_el=n_el)

    def pencil_counts(flag, pencil):
        """Per-pencil sums of ``flag`` (f32, as sph_tpu's segment sums)."""
        return torch.zeros(cfg.n_pencils + 1, dtype=F32,
                           device=flag.device).index_add_(
            0, pencil, flag)[:cfg.n_pencils]

    def block_has(seg, plo_l, phi_l):
        csum = torch.cat([seg.new_zeros(1), torch.cumsum(seg, 0)])
        return (csum[phi_l] - csum[plo_l]).sum(dim=1) > 0

    # ================= replicated resort =================================

    def sweep(state_l, springs, membranes, r_steps):
        """One replicated resort + r_steps sorted-space local steps.
        state_l holds the rank's original-space rows [n_loc]."""
        ag = comm.all_gather
        pos_g = ag(state_l.pos)
        vel_g = ag(state_l.vel)
        nrm_g = ag(state_l.normal)
        ptype_g = ag(state_l.ptype)
        dev_t = pos_g.device
        is_b = (ptype_g == BOUNDARY_PARTICLE).to(F32)
        is_liq = (ptype_g == LIQUID_PARTICLE).to(F32)

        pencil, cid = F._cells(pos_g, params, cfg.dims)
        order = torch.argsort(cid, stable=True)
        inv = torch.empty(n, dtype=I64, device=dev_t)
        inv[order] = torch.arange(n, device=dev_t)
        pencil_s = pencil[order]

        tables_g, _, pranges, gtabs = F._window_tables(pencil_s, cfg)
        lo_g, hi_g = tables_g[1].long(), tables_g[2].long()

        o0 = rk * n_pad_loc                      # own start, sorted coords
        base = o0 - halo_pad + P0                # slab start, shifted
        t0 = rk * nb_loc * 3
        lo_l = lo_g[t0:t0 + nb_loc * 3] + P0
        hi_l = hi_g[t0:t0 + nb_loc * 3] + P0
        base6, lo_c, hi_c, cnt_new, ovf_loc = finish_window_tables(
            lo_l, hi_l, base)
        overflow = comm.psum(ovf_loc)
        ob = base6[5]
        gt = ()
        if sub_on:
            t0g = t0 * n_grp
            span = slice(t0g, t0g + nb_loc * 3 * n_grp)
            gt = gate_local(gtabs[0][span].long() + P0,
                            gtabs[1][span].long() + P0, base)

        def sl(a_sorted, fill):
            """The rank's slab window of a sorted field."""
            g = a_sorted.new_full((galloc,), fill)
            g[P0:P0 + n] = a_sorted
            return g[base:base + slab_size]

        # fill 1.0: rows outside the real sorted range (the last rank's
        # phantom pads, never-real shift regions) are pinned like walls;
        # maskless tiles can overhang into them
        isb_s = sl(is_b[order], 1.0)
        liq_s = sl(is_liq[order], 0.0)
        nrm_s = nrm_g[order]
        pos_s = pos_g[order]
        vel_s = vel_g[order]
        ctx = dict(isb_s=isb_s, liq_s=liq_s, nxs=sl(nrm_s[:, 0], 0.0),
                   nys=sl(nrm_s[:, 1], 0.0), nzs=sl(nrm_s[:, 2], 0.0))
        bmask = isb_s[own] > 0
        ctx.update(bmask=bmask, not_b=(~bmask).to(F32))
        # per-block gates (as core.fast's sort)
        own_nonb = isb_s[own].reshape(nb_loc, B).amin(dim=1) == 0
        plo_r, phi_r = pranges
        plo_l = plo_r[rk * nb_loc:(rk + 1) * nb_loc].long()
        phi_l = phi_r[rk * nb_loc:(rk + 1) * nb_loc].long()
        win_has_b = block_has(pencil_counts(is_b[order], pencil_s),
                              plo_l, phi_l)
        ctx.update(
            tables=base6 + gt,
            force_tables=base6[:4] + (gated(cnt_new, own_nonb), ob, *gt),
            bnd_tables=base6[:4] + (gated(cnt_new, own_nonb & win_has_b),
                                    ob))

        # ---- elastic machinery (shared by springs + membranes) ----------
        have_springs = springs.n_elastic > 0
        have_mem = membranes.n_tris > 0
        if have_springs or have_mem:
            e0, e1 = layout.elastic_range
            n_el = e1 - e0
            eid_of_orig = torch.full((n,), -1, dtype=I64, device=dev_t)
            eid_of_orig[e0:e1] = torch.arange(n_el, device=dev_t)
            # eid of each own row, for the per-step psum globalization
            eid_own_rows = sl(eid_of_orig[order], -1)[own]
            el_rows = inv[e0:e1]                      # sorted row per eid
        if have_springs and layout.springs_elastic_only:
            ctx.update(build_spring_ctx(
                springs, el_rows, lambda sidx: inv[sidx], base, lo_c, hi_c,
                eid_own_rows, ob, n_el))
        elif have_springs:
            sidx = springs.idx.long()
            ctx.update(build_fallback_ctx(
                springs, eid_of_orig[springs.row_ids.long()],
                torch.where(sidx >= 0,
                            eid_of_orig[torch.clamp(sidx, min=0)], -1),
                pos_g, inv[springs.row_ids.long()] - o0, eid_own_rows, n_el))
        if have_mem:
            has_mem = torch.zeros(n, dtype=F32, device=dev_t)
            has_mem[e0:e1] = (membranes.particle_tris[e0:e1] >= 0).any(
                dim=1).to(F32)
            own_liq = liq_s[own].reshape(nb_loc, B).amax(dim=1) > 0
            ctx.update(build_mem_ctx(
                membranes, el_rows, inv[membranes.tris.long()], base,
                pencil_counts(has_mem[order], pencil_s), plo_l, phi_l,
                own_liq, base6, cnt_new, ob))

        carry = (sl(pos_s[:, 0], far)[own], sl(pos_s[:, 1], far)[own],
                 sl(pos_s[:, 2], far)[own], sl(vel_s[:, 0], 0.0)[own],
                 sl(vel_s[:, 1], 0.0)[own], sl(vel_s[:, 2], 0.0)[own],
                 state_l.muscle_activation, state_l.step,
                 torch.zeros((), dtype=F32, device=dev_t))
        for _ in range(r_steps):
            carry = inner_body(ctx, carry)
        xn, yn, zn, vxn, vyn, vzn, act, step_no, drift = carry
        drift = comm.pmax(drift)

        # re-globalize own rows, unsort, slice the original shard
        def unsort(a):
            full = torch.empty(n, dtype=F32, device=dev_t)
            full[order] = comm.all_gather(a)[:n]
            return full[rk * n_loc:(rk + 1) * n_loc]

        new_state = FluidState(
            pos=torch.stack([unsort(xn), unsort(yn), unsort(zn)], dim=1),
            vel=torch.stack([unsort(vxn), unsort(vyn), unsort(vzn)], dim=1),
            ptype=state_l.ptype, normal=state_l.normal,
            muscle_activation=act, step=step_no)
        return new_state, overflow, drift

    # ================= distributed resort ================================
    # state stays sharded in SORTED space across sweeps: global sorted ranks
    # from an all-gathered per-CELL histogram (O(n_cells)) + per-rank
    # prefix counts; only rows whose rank crosses a rank boundary migrate,
    # through fixed-capacity buffers; window tables from the histogram's
    # pencil offsets. Original order only at a call's entry and exit.
    npen = cfg.n_pencils
    n_cells = ny * npen
    if mig_cap is None:
        # measure_migration_pad gives a scene-derived bound; halo_pad
        # (>= the same two-z-row population + ccol) is a safe default:
        # overruns drop rows and are surfaced loudly
        mig_cap = halo_pad

    def cells_of(x, y, z):
        return F._cells(torch.stack([x, y, z], dim=1), params, cfg.dims)

    def resort_distributed(rows, springs, membranes, statics):
        """One resort with no O(N) collective. rows: dict(x y z vx vy vz
        [n_pad_loc] f32, oid [n_pad_loc] int64; oid -1 = phantom pad row).
        Returns (new rows, ctx, ovf_win, ovf_mig): ovf_win counts window
        bounds clipped by the halo band (as the replicated path), ovf_mig
        rows that needed to move more than one rank or overran the mig_cap
        buffers; those particles are DROPPED (raise the resort cadence or
        halo_pad/mig_cap)."""
        dev_t = rows["x"].device
        base0 = rk * n_pad_loc
        oid = rows["oid"]
        real = oid >= 0
        _, cid = cells_of(rows["x"], rows["y"], rows["z"])
        cid = torch.where(real, cid.long(), n_cells)       # sentinel bucket

        # global sorted rank: histogram + rank prefix + local offset.
        # Intra-cell order = (rank, previous sorted order): a stable sort
        # w.r.t. the PREVIOUS sorted order, where the replicated path's is
        # stable w.r.t. original ids; reductions differ by f32 round-off
        cnt_loc = torch.zeros(n_cells + 1, dtype=I64, device=dev_t)
        cnt_loc.index_add_(0, cid, torch.ones_like(cid))
        cnt_all = comm.all_gather(cnt_loc[None, :n_cells])  # [ranks, cells]
        hist = cnt_all.sum(dim=0)
        cell_start = torch.cat([hist.new_zeros(1), torch.cumsum(hist, 0)])
        my_prefix = (torch.cumsum(cnt_all, dim=0) - cnt_all)[rk]
        s_l = torch.argsort(cid, stable=True)
        cid_s = cid[s_l]
        first_occ = torch.searchsorted(cid_s, cid_s)
        occ = torch.empty(n_pad_loc, dtype=I64, device=dev_t)
        occ[s_l] = torch.arange(n_pad_loc, device=dev_t) - first_occ
        csafe = torch.clamp(cid, max=n_cells - 1)
        rank = cell_start[csafe] + my_prefix[csafe] + occ
        rank = torch.where(real, rank, cfg.n_pad)      # phantoms: beyond all

        # neighbour-only migration through fixed-capacity buffers
        ddev = torch.div(rank, n_pad_loc, rounding_mode="floor")
        stay = real & (ddev == rk)
        go_l = real & (ddev == rk - 1)
        go_r = real & (ddev == rk + 1)
        lost = real & ~(stay | go_l | go_r)
        ovf_mig = comm.psum(
            lost.sum() + torch.clamp(go_l.sum() - mig_cap, min=0)
            + torch.clamp(go_r.sum() - mig_cap, min=0))

        fpack = torch.stack([rows["x"], rows["y"], rows["z"],
                             rows["vx"], rows["vy"], rows["vz"]])
        ipack = torch.stack([oid, rank])
        # column n_pad_loc: an empty slot (oid -1)
        f_pad = torch.cat([fpack, fpack.new_zeros(6, 1)], dim=1)
        i_pad = torch.cat([ipack, torch.tensor([[-1], [0]], dtype=I64,
                                               device=dev_t)], dim=1)

        def pack(mask):
            """The first mig_cap rows of ``mask``, padded with the empty
            slot (a fixed shape, no host read)."""
            slot = torch.cumsum(mask.to(I64), 0) - 1
            idx = _scatter(mig_cap, n_pad_loc,
                           torch.where(mask, slot, mig_cap),
                           torch.arange(n_pad_loc, device=dev_t))
            return f_pad[:, idx], i_pad[:, idx]

        fl, il = pack(go_l)
        fr, ir = pack(go_r)
        # the chain's ends receive an empty slot's fill: oid -1
        empty_i = torch.tensor([[-1], [0]], dtype=I64, device=dev_t)
        rxl_f = comm.send_next(fr, 0.0)      # from the left neighbour
        rxl_i = comm.send_next(ir, empty_i)
        rxr_f = comm.send_prev(fl, 0.0)      # from the right neighbour
        rxr_i = comm.send_prev(il, empty_i)

        sent = n_pad_loc                      # the dropped slot
        t_stay = torch.where(stay, rank - base0, sent)
        t_l = torch.where(rxl_i[0] >= 0, rxl_i[1] - base0, sent)
        t_r = torch.where(rxr_i[0] >= 0, rxr_i[1] - base0, sent)

        def scat(fill, own_v, lv, rv):
            a = own_v.new_full((n_pad_loc + 1,), fill)
            for t, v in ((t_stay, own_v), (t_l, lv), (t_r, rv)):
                a[torch.where((t >= 0) & (t <= sent), t, sent)] = v
            return a[:n_pad_loc]

        new = dict(
            x=scat(far, rows["x"], rxl_f[0], rxr_f[0]),
            y=scat(far, rows["y"], rxl_f[1], rxr_f[1]),
            z=scat(far, rows["z"], rxl_f[2], rxr_f[2]),
            vx=scat(0.0, rows["vx"], rxl_f[3], rxr_f[3]),
            vy=scat(0.0, rows["vy"], rxl_f[4], rxr_f[4]),
            vz=scat(0.0, rows["vz"], rxl_f[5], rxr_f[5]),
            oid=scat(-1, oid, rxl_i[0], rxr_i[0]),
        )

        # ---- window tables: pencil starts from the histogram, block
        # pencil ranges from the local rows ------------------------------
        pstart = cell_start[torch.arange(npen + 1, device=dev_t) * ny]
        oidn = new["oid"]
        realn = oidn >= 0
        pen_n = cells_of(new["x"], new["y"], new["z"])[0].long()
        base = base0 - halo_pad + P0
        rows_b = torch.arange(nb_loc, device=dev_t) * B
        last_i = torch.clamp(rows_b + B - 1, 0, max(n - 1 - base0, 0))
        first_p = pen_n[rows_b]
        last_p = pen_n[last_i]
        phantom_blk = (base0 + rows_b) >= n
        prev_hi = torch.zeros(nb_loc, dtype=I64, device=dev_t)
        los, his, plos, phis = [], [], [], []
        for dz in (-1, 0, 1):
            lo_p = torch.clamp(first_p + dz * nx - 1, 0, npen)
            hi_p = torch.clamp(last_p + dz * nx + 2, 0, npen)
            lo_p = torch.maximum(lo_p, prev_hi)
            hi_p = torch.maximum(hi_p, lo_p)
            prev_hi = hi_p
            off = pstart[lo_p]
            los.append(off)
            his.append(torch.where(phantom_blk, off, pstart[hi_p]))
            plos.append(lo_p)
            phis.append(hi_p)
        lo_l = torch.stack(los, 1).reshape(-1) + P0
        hi_l = torch.stack(his, 1).reshape(-1) + P0
        plo_l = torch.stack(plos, 1)
        phi_l = torch.stack(phis, 1)
        base6, lo_c, hi_c, cnt_new, ovf_loc = finish_window_tables(
            lo_l, hi_l, base)
        ovf_win = comm.psum(ovf_loc)
        ob = base6[5]
        gt = ()
        if sub_on:
            # per-subgroup gate windows from the local rows (unmerged dz
            # bands, see core.fast)
            rows_sg = torch.arange(nb_loc * n_grp, device=dev_t) * cfg.sub
            last_sg = torch.clamp(rows_sg + cfg.sub - 1, 0,
                                  max(n - 1 - base0, 0))
            first_gp = pen_n[rows_sg].reshape(nb_loc, n_grp)
            last_gp = pen_n[last_sg].reshape(nb_loc, n_grp)
            glos, ghis = [], []
            for dz in (-1, 0, 1):
                glos.append(pstart[
                    torch.clamp(first_gp + dz * nx - 1, 0, npen)])
                ghis.append(pstart[
                    torch.clamp(last_gp + dz * nx + 2, 0, npen)])
            gt = gate_local(torch.stack(glos, 1).reshape(-1) + P0,
                            torch.stack(ghis, 1).reshape(-1) + P0, base)

        # ---- static fields: O(n_loc) gathers from the replicated
        # original-order tables, then one halo exchange builds the slabs
        safe = torch.clamp(oidn, min=0)
        isb_own = torch.where(realn, statics["is_b"][safe], 1.0)
        liq_own = torch.where(realn, statics["is_liq"][safe], 0.0)
        nrm_own = torch.where(realn[:, None], statics["nrm"][safe], 0.0)
        isb_s, liq_s, nxs, nys, nzs = exchange(
            [isb_own, liq_own, nrm_own[:, 0], nrm_own[:, 1], nrm_own[:, 2]],
            [1.0, 0.0, 0.0, 0.0, 0.0])
        bmask = isb_s[own] > 0
        own_nonb = isb_s[own].reshape(nb_loc, B).amin(dim=1) == 0
        pen_safe = torch.where(realn, pen_n, npen)

        def pencil_count(w):
            return comm.psum(pencil_counts(w, pen_safe))

        win_has_b = block_has(pencil_count(isb_own * realn.to(F32)),
                              plo_l, phi_l)
        ctx = dict(
            isb_s=isb_s, liq_s=liq_s, nxs=nxs, nys=nys, nzs=nzs,
            bmask=bmask, not_b=(~bmask).to(F32), tables=base6 + gt,
            force_tables=base6[:4] + (gated(cnt_new, own_nonb), ob, *gt),
            bnd_tables=base6[:4] + (gated(cnt_new, own_nonb & win_has_b),
                                    ob))

        have_springs = springs.n_elastic > 0
        have_mem = membranes.n_tris > 0
        eid_of_orig = statics["eid_of_orig"]
        if have_springs or have_mem:
            e0, e1 = layout.elastic_range
            n_el = e1 - e0
            # sorted row of each elastic id: an O(n_el) psum scatter (each
            # eid lives on exactly one rank)
            eid_own = torch.where(realn, eid_of_orig[safe], -1)
            rows_glob = base0 + torch.arange(n_pad_loc, device=dev_t)
            el_rows = comm.psum(_scatter_add(
                n_el, eid_own, torch.where(eid_own >= 0, rows_glob, 0)))
        if have_springs and layout.springs_elastic_only:
            # partner rows from the eid -> sorted-row map
            ctx.update(build_spring_ctx(
                springs, el_rows,
                lambda sidx: el_rows[torch.clamp(eid_of_orig[sidx], min=0)],
                base, lo_c, hi_c, eid_own, ob, n_el))
        elif have_springs:
            # the gather fallback: eid maps in the original-id domain,
            # scatter targets from the per-resort eid -> sorted-row map
            row_eid = eid_of_orig[springs.row_ids.long()]
            sidx = springs.idx.long()
            ctx.update(build_fallback_ctx(
                springs, row_eid,
                torch.where(sidx >= 0,
                            eid_of_orig[torch.clamp(sidx, min=0)], -1),
                statics["pos"],
                torch.where(row_eid >= 0,
                            el_rows[torch.clamp(row_eid, min=0)] - base0,
                            -1),
                eid_own, n_el))
        if have_mem:
            seg_m = pencil_count(
                torch.where(realn, statics["has_mem"][safe], 0.0))
            own_liq = liq_s[own].reshape(nb_loc, B).amax(dim=1) > 0
            tri_eid = eid_of_orig[membranes.tris.long()]
            ctx.update(build_mem_ctx(
                membranes, el_rows, el_rows[torch.clamp(tri_eid, min=0)],
                base, seg_m, plo_l, phi_l, own_liq, base6, cnt_new, ob))
        return new, ctx, ovf_win, ovf_mig

    def entry_sort_distributed(state_l):
        """The entry sort: with the exit unsort, the ONLY O(N) gathers of a
        distributed run (once a call or a session, not a resort)."""
        pos_g = comm.all_gather(state_l.pos)
        vel_g = comm.all_gather(state_l.vel)
        _, cid = F._cells(pos_g, params, cfg.dims)
        order = torch.argsort(cid, stable=True)
        base0 = rk * n_pad_loc

        def loc(a_sorted, fill):
            g = a_sorted.new_full((cfg.n_pad,), fill)
            g[:n] = a_sorted
            return g[base0:base0 + n_pad_loc]

        ps, vs = pos_g[order], vel_g[order]
        return dict(x=loc(ps[:, 0], far), y=loc(ps[:, 1], far),
                    z=loc(ps[:, 2], far), vx=loc(vs[:, 0], 0.0),
                    vy=loc(vs[:, 1], 0.0), vz=loc(vs[:, 2], 0.0),
                    oid=loc(order, -1))

    def build_statics(state_l, membranes):
        """The replicated original-order static tables (gathered once a
        call, or once a session)."""
        dev_t = state_l.pos.device
        ptype_g = comm.all_gather(state_l.ptype)
        statics = dict(
            is_b=(ptype_g == BOUNDARY_PARTICLE).to(F32),
            is_liq=(ptype_g == LIQUID_PARTICLE).to(F32),
            nrm=comm.all_gather(state_l.normal),
            # entry-time original-order positions: static-anchor
            # (boundary) spring endpoints only; boundary never moves
            pos=comm.all_gather(state_l.pos),
        )
        e0, e1 = layout.elastic_range
        eid = torch.full((n,), -1, dtype=I64, device=dev_t)
        eid[e0:e1] = torch.arange(e1 - e0, device=dev_t)
        statics["eid_of_orig"] = eid
        hm = torch.zeros(n, dtype=F32, device=dev_t)
        if membranes.n_tris > 0:
            hm[e0:e1] = (membranes.particle_tris[e0:e1] >= 0).any(
                dim=1).to(F32)
        statics["has_mem"] = hm
        return statics

    def sweep_d(rows, act, step_no, springs, membranes, statics, r_steps):
        rows2, ctx, o_win, o_mig = resort_distributed(
            rows, springs, membranes, statics)
        carry = (rows2["x"], rows2["y"], rows2["z"], rows2["vx"],
                 rows2["vy"], rows2["vz"], act, step_no,
                 torch.zeros((), dtype=F32, device=rows2["x"].device))
        for _ in range(r_steps):
            carry = inner_body(ctx, carry)
        xn, yn, zn, vxn, vyn, vzn, act2, s2, drift = carry
        rows3 = dict(x=xn, y=yn, z=zn, vx=vxn, vy=vyn, vz=vzn,
                     oid=rows2["oid"])
        return rows3, act2, s2, o_win, o_mig, comm.pmax(drift)

    def exit_unsort(rows, act, step_no, state_l):
        """Original order from the sorted rows (the O(N) exit, once a call
        or a session)."""
        og = comm.all_gather(rows["oid"])
        tgt = torch.where(og >= 0, og, n)

        def unsort(a):
            buf = a.new_zeros(n + 1)
            buf[tgt] = comm.all_gather(a)
            return buf[rk * n_loc:(rk + 1) * n_loc]

        return FluidState(
            pos=torch.stack([unsort(rows["x"]), unsort(rows["y"]),
                             unsort(rows["z"])], dim=1),
            vel=torch.stack([unsort(rows["vx"]), unsort(rows["vy"]),
                             unsort(rows["vz"])], dim=1),
            ptype=state_l.ptype, normal=state_l.normal,
            muscle_activation=act, step=step_no)

    r_every = max(1, cfg.resort_every)
    full, rem = divmod(n_steps, r_every)
    periods = [r_every] * full + ([rem] if rem else [])

    def stepper(state, springs, membranes):
        ovf = torch.zeros((), dtype=I64, device=state.pos.device)
        drf = torch.zeros((), dtype=F32, device=state.pos.device)
        for r_steps in periods:
            state, o2, d2 = sweep(state, springs, membranes, r_steps)
            ovf, drf = torch.maximum(ovf, o2), torch.maximum(drf, d2)
        return state, {"halo_overflow": ovf, "window_drift": drf}

    def stepper_distributed(state_l, springs, membranes):
        """``stepper`` with the O(cells) distributed resort between sweeps:
        the entry sort and exit unsort are the only O(N) collectives, paid
        once a call. diag also carries ``resort_overflow`` (migration
        misses: dropped particles)."""
        statics = build_statics(state_l, membranes)
        rows = entry_sort_distributed(state_l)
        act, step_no = state_l.muscle_activation, state_l.step
        dev_t = state_l.pos.device
        ovf = torch.zeros((), dtype=I64, device=dev_t)
        mig = torch.zeros((), dtype=I64, device=dev_t)
        drf = torch.zeros((), dtype=F32, device=dev_t)
        for r_steps in periods:
            rows, act, step_no, o2, m2, d2 = sweep_d(
                rows, act, step_no, springs, membranes, statics, r_steps)
            ovf = torch.maximum(ovf, o2)
            mig = torch.maximum(mig, m2)
            drf = torch.maximum(drf, d2)
        return exit_unsort(rows, act, step_no, state_l), {
            "halo_overflow": ovf, "window_drift": drf,
            "resort_overflow": mig}

    if _session:
        if not distributed_resort:
            raise ValueError("a halo session runs the distributed resort")

        def begin(state_l, membranes):
            return dict(rows=entry_sort_distributed(state_l),
                        statics=build_statics(state_l, membranes),
                        act=state_l.muscle_activation, step=state_l.step)

        def step(sess, springs, membranes):
            rows, act, s2, o_win, o_mig, drift = sweep_d(
                sess["rows"], sess["act"], sess["step"], springs,
                membranes, sess["statics"], r_every)
            return (dict(rows=rows, statics=sess["statics"], act=act,
                         step=s2),
                    {"halo_overflow": o_win, "window_drift": drift,
                     "resort_overflow": o_mig})

        def finish(sess, state_l):
            return exit_unsort(sess["rows"], sess["act"], sess["step"],
                               state_l)

        for f in (begin, step, finish):
            f.passes = passes
        return begin, step, finish

    run = stepper_distributed if distributed_resort else stepper
    run.passes = passes
    return run


def make_halo_session(comm: Comm, params: SimParams, layout: SceneLayout,
                      cfg: F.FastConfig, halo_pad: int | None = None,
                      mig_cap: int | None = None):
    """Stateful sorted-space stepping over the distributed resort:

        begin(state, membranes) -> session       # one O(N) entry sort
        step(session, springs, membranes) -> (session, diag)
        finish(session, state) -> state          # one O(N) exit unsort

    Each ``step`` advances ``cfg.resort_every`` steps (one distributed
    resort + one sorted-space period) with NO O(N) collective: the session
    keeps the particle state sharded in sorted space between calls, so
    chunked stepping pays the entry/exit gathers once a session. diag
    carries halo_overflow / window_drift / resort_overflow of that call."""
    return make_halo_fast_multi_step(
        comm, params, layout, cfg, n_steps=cfg.resort_every,
        halo_pad=halo_pad, distributed_resort=True, mig_cap=mig_cap,
        _session=True)
