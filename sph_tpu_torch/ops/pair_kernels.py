"""Blocked all-pairs passes of the wall-compact engine: Hopper kernels and
their plain PyTorch versions.

Counterpart of ``sph_tpu/ops/pair_kernels.py`` for the four passes the
fastw step runs on a scene without elastic matter (rho*, viscosity/surface,
pressure force, boundary). The contract is the JAX one:

* particles are cell-sorted; an own block is ``block`` consecutive rows;
* ``tables`` is the 6-tuple ``(aln, lo, hi, s0, cnt, ob)`` of int32 chunk
  descriptors from ``core.fast._window_tables`` / ``core.fastw._cross_tables``:
  block b streams ``cnt[b]`` tiles of ``ccol`` slab columns, tile s at column
  ``aln[c] + (s - s0[c]) * ccol`` of chunk ``c = 3b + (s >= s0[3b+1]) +
  (s >= s0[3b+2])``; own rows start at column ``ob[0]`` of the own pack;
* packs are column-major ``[fields, width]`` f32 (one row per field);
* MASKLESS: a block's tiles are disjoint and cover every in-window column,
  and every real column outside the pencil-band window is >= h from the
  block's rows, where each pair term vanishes; pad columns carry ``far``
  positions. No per-pair window test is applied;
* each pass returns ``n_outputs`` f32 vectors of ``n_blocks * block`` rows,
  post-scaled by the same constants as the JAX wrappers.

Unlike the TPU driver there is no flat tile table with static caps: every
tile a table lists is computed. A tile column beyond the slab pack's width is
skipped (bounds check), which the tables never produce: the last tile of a
window ends before ``end + ccol <= width``.

Dispatch: a pass called on CPU tensors runs its plain version; on CUDA
tensors it launches the kernel (``csrc/pair_pass.cu``) or raises. Each kernel
launch adds one to ``LAUNCHES[kind]``.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

ALIGN = 128  # column alignment of tile offsets (kept for table parity)

# main pack columns (time-t fields)
MAIN_COLS = 8
(PM_X, PM_Y, PM_Z, PM_VEX, PM_VEY, PM_VEZ, PM_RHO, PM_ISB) = range(8)

# iteration packs
ITER_COLS = 3      # [x*, y*, z*] (predicted positions only)
PACC_COLS = 5      # [x, y, z, 1/rho*, p]

# boundary pack columns
BND_COLS = 7
(PB_X, PB_Y, PB_Z, PB_NX, PB_NY, PB_NZ, PB_ISB) = range(7)

# own pack for the post-integrate passes: [x_t, y_t, z_t, xn, yn, zn]
OWN_COLS = 6

# kind -> (n_outputs, own pack rows, slab pack rows) the pass reads
_SPECS = {
    "rho_star": (1, ITER_COLS, ITER_COLS),
    "viscsurf": (6, PM_VEZ + 1, PM_RHO + 1),
    "paccel": (3, PACC_COLS, PACC_COLS),
    "boundary": (5, OWN_COLS, BND_COLS),
}

# kind -> output indices grouped by quantity (the components of one vector
# are one group): comparisons scale a tolerance by the group's magnitude,
# since one component of a vector sum may cancel to far below the others.
OUTPUT_GROUPS = {
    "rho_star": ((0,),),
    "viscsurf": ((0, 1, 2), (3, 4, 5)),
    "paccel": ((0, 1, 2),),
    "boundary": ((0, 1, 2), (3,), (4,)),
}

# Kernel launches per kind (plain ints, reset by callers that count a run).
LAUNCHES = {kind: 0 for kind in _SPECS}

# Pair elements ([rows x columns]) per chunk of blocks in the plain
# versions: bounds the gathered pair matrices to ~64 MB per temporary.
_PLAIN_PAIRS = 1 << 24


@dataclasses.dataclass(frozen=True)
class PairPass:
    """One configured pair pass: ``call(tables, own_pack, slab_pack)``.

    ``consts`` are the pass's f32 constants in the kernel's argument order
    (see ``csrc/pair_pass.cu``)."""

    kind: str
    block: int
    ccol: int
    n_blocks: int
    consts: tuple[float, ...]

    @property
    def n_pad(self) -> int:
        return self.n_blocks * self.block

    def __call__(self, tables, own_pack, slab_pack):
        dev = own_pack.device.type
        if dev == "cpu":
            return self.plain(tables, own_pack, slab_pack)
        if dev == "cuda":
            return self.kernel(tables, own_pack, slab_pack)
        raise ValueError(f"pair pass on unsupported device {own_pack.device}")

    def plain(self, tables, own_pack, slab_pack):
        """The plain PyTorch version (any device; it computes in the packs'
        dtype, so f64 packs give an f64 oracle of the same sums)."""
        out = _plain(self, tables, own_pack, slab_pack)
        return out[0] if len(out) == 1 else tuple(out)

    def kernel(self, tables, own_pack, slab_pack):
        """Launch the CUDA kernel on the current stream."""
        out = _launch(self, tables, own_pack, slab_pack)
        return out[0] if len(out) == 1 else tuple(out)


def _f32(x) -> float:
    return float(np.float32(x))


def make_rho_star_pass(*, block, ccol, n_blocks, inv_h2, c_rho, raw=False,
                       **_):
    """Predicted density sums s_i = sum_j max(h^2 - r*_ij^2, 0)^3 (self term
    included; pack cols: predicted x, y, z). ``raw=True`` returns the bare
    sums, which the fastw engine combines across column sets before the
    clamp; otherwise c_rho * max((s - (h^2)^3) / h^6, 1)."""
    h2 = np.float32(1.0) / np.float32(inv_h2)
    p = PairPass("rho_star", block, ccol, n_blocks, (float(h2),))
    if raw:
        return p
    self3 = np.float32(h2 * h2) * h2
    inv_h6 = np.float32(inv_h2) * np.float32(inv_h2) * np.float32(inv_h2)
    c_rho = _f32(c_rho)

    def call(tables, own_pack, slab_pack):
        s = p(tables, own_pack, slab_pack)
        return c_rho * torch.clamp((s - float(self3)) * float(inv_h6),
                                   min=1.0)

    return call


def make_viscsurf_pass(*, block, ccol, n_blocks, inv_h2, **_):
    """Viscosity + surface-tension sums over the main pack: (vx, vy, vz) =
    sum max(h - r, 0) * (1/rho_j) * (v_j - v_i) / h, (sx, sy, sz) =
    sum_{r < h} (x_i - x_j). Wall columns carry their normal as v; the
    PM_RHO row carries 1/rho."""
    h = np.float32(1.0) / np.float32(np.sqrt(inv_h2))
    h2 = np.float32(1.0) / np.float32(inv_h2)
    inv_h = np.float32(np.sqrt(inv_h2))
    return PairPass("viscsurf", block, ccol, n_blocks,
                    (float(h), float(h2), float(inv_h)))


def make_paccel_pass(*, block, ccol, n_blocks, inv_h2, inv_h, rho0_delta,
                     **_):
    """Pressure-force sums sum_j w_ij (x_i - x_j) * 0.5 / h^2 with
    w = [cm^2 rho0 delta if cm = h/4 - r > 0 else (h - r)_+^2 (p_i + p_j)]
    * (1/rho*_j) / r, and w = 0 at r = 0. Pack cols: [x, y, z, 1/rho*, p]."""
    h = np.float32(1.0) / np.float32(inv_h)
    h4 = np.float32(h / 4.0)
    out_c = np.float32(0.5) * np.float32(inv_h) * np.float32(inv_h)
    return PairPass("paccel", block, ccol, n_blocks,
                    (float(h), float(h4), _f32(rho0_delta), float(out_c)))


def make_boundary_pass(*, block, ccol, n_blocks, r0, **_):
    """Ihmsen boundary sums: d = |x_new,i - x_j|, w = max(0, (r0 - d)/r0)
    * isb_j; outputs sum w n_j (3), sum w, sum w (r0 - d). Own pack cols
    [x_t, y_t, z_t, xn, yn, zn]; slab = boundary pack (BND_COLS)."""
    r0 = np.float32(r0)
    inv_r0 = np.float32(1.0 / r0)
    return PairPass("boundary", block, ccol, n_blocks,
                    (float(r0), float(inv_r0)))


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _rho_star_pairs(c, o, s, valid):
    (h2,) = c
    dx, dy, dz = o[0] - s[0], o[1] - s[1], o[2] - s[2]
    t = torch.clamp(h2 - (dx * dx + dy * dy + dz * dz), min=0.0)
    return [torch.where(valid, t * t * t, 0.0).sum(-1)]


def _viscsurf_pairs(c, o, s, valid):
    h, h2, inv_h = c
    dx, dy, dz = o[0] - s[0], o[1] - s[1], o[2] - s[2]
    r2 = dx * dx + dy * dy + dz * dz
    t = torch.clamp(h - torch.sqrt(r2), min=0.0)
    wv = torch.where(valid, t * s[PM_RHO], 0.0)
    ws = (valid & (r2 < h2)).to(torch.float32)
    return [(wv * (s[PM_VEX + k] - o[PM_VEX + k])).sum(-1) * inv_h
            for k in range(3)] + [(ws * d).sum(-1) for d in (dx, dy, dz)]


def _paccel_pairs(c, o, s, valid):
    h, h4, rho0_delta, out_c = c
    dx, dy, dz = o[0] - s[0], o[1] - s[1], o[2] - s[2]
    r2 = dx * dx + dy * dy + dz * dz
    inv_r = torch.rsqrt(torch.clamp(r2, min=1e-30))
    r = r2 * inv_r
    t = torch.clamp(h - r, min=0.0)
    far = t * t * (o[4] + s[4])
    cm = h4 - r
    close = cm * cm * rho0_delta
    term = torch.where(cm > 0.0, close, far) * s[3]
    w = torch.where(valid & (r2 > 0.0), term * inv_r, 0.0)
    return [(w * d).sum(-1) * out_c for d in (dx, dy, dz)]


def _boundary_pairs(c, o, s, valid):
    r0, inv_r0 = c
    dnx, dny, dnz = o[3] - s[PB_X], o[4] - s[PB_Y], o[5] - s[PB_Z]
    dist = torch.sqrt(dnx * dnx + dny * dny + dnz * dnz)
    w = torch.clamp((r0 - dist) * inv_r0, min=0.0) * s[PB_ISB]
    w = torch.where(valid, w, 0.0)
    return [(w * s[PB_NX + k]).sum(-1) for k in range(3)] + [
        w.sum(-1), (w * (r0 - dist)).sum(-1)]


_PAIRS = {
    "rho_star": _rho_star_pairs,
    "viscsurf": _viscsurf_pairs,
    "paccel": _paccel_pairs,
    "boundary": _boundary_pairs,
}


def _tile_columns(tables, ccol, blocks, n_tiles, width):
    """Slab column ids [len(blocks), n_tiles*ccol] that the given blocks
    stream, and their validity (tile within the block's count, column
    within the slab width)."""
    aln, _, _, s0, cnt, _ = (t.long() for t in tables)
    dev = aln.device
    s = torch.arange(n_tiles, device=dev)[None, :]
    b3 = blocks[:, None] * 3
    c = b3 + (s >= s0[b3 + 1]).long() + (s >= s0[b3 + 2]).long()
    off = aln[c] + (s - s0[c]) * ccol                       # [nb, T]
    cols = off[:, :, None] + torch.arange(ccol, device=dev)
    valid = ((s < cnt[blocks, None])[:, :, None]
             & (cols >= 0) & (cols < width))
    nb = blocks.shape[0]
    cols = torch.where(valid, cols, 0).reshape(nb, -1)
    return cols, valid.reshape(nb, -1)


def _plain(p: PairPass, tables, own, slab):
    """Sum over each block's tiles: pair matrices gathered per chunk of
    blocks (blocks without tiles skipped), with none of the TPU driver's
    static tile caps."""
    n_out, own_rows, slab_rows = _SPECS[p.kind]
    B = p.block
    dev = own.device
    out = torch.zeros((n_out, p.n_blocks, B), dtype=own.dtype, device=dev)
    cnt = tables[4].long()
    # host syncs: the plain path sizes its gathers from the tables
    active = torch.nonzero(cnt > 0).reshape(-1)
    active = active[torch.argsort(cnt[active], stable=True)]
    counts = cnt[active].tolist()
    ob = int(tables[5][0])
    own_w, slab_w = own.shape[1], slab.shape[1]
    own = own[:own_rows]
    slab = slab[:slab_rows]
    pairs = _PAIRS[p.kind]
    i = 0
    while i < len(counts):
        # blocks sorted by tile count: grow the chunk while its widest
        # (last) block keeps the gathered pair matrices within budget
        j = i + 1
        while (j < len(counts) and (j + 1 - i) * B * counts[j] * p.ccol
               <= _PLAIN_PAIRS):
            j += 1
        blocks = active[i:j]
        cols, valid = _tile_columns(tables, p.ccol, blocks, counts[j - 1],
                                    slab_w)
        rows = ob + blocks[:, None] * B + torch.arange(B, device=dev)
        live = (rows >= 0) & (rows < own_w)
        o = own[:, torch.where(live, rows, 0)][..., None]   # [k, nb, B, 1]
        s = slab[:, cols][:, :, None, :]                    # [k, nb, 1, C]
        res = pairs(p.consts, o, s, valid[:, None, :])
        for k, r in enumerate(res):
            out[k, blocks] = torch.where(live, r, 0.0)
        i = j
    return list(out.reshape(n_out, p.n_pad))


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

def _check(p: PairPass, tables, own, slab):
    n_out, own_rows, slab_rows = _SPECS[p.kind]
    dev = own.device
    if len(tables) != 6:
        raise ValueError(f"{p.kind}: expected the 6-tuple tables, "
                         f"got {len(tables)}")
    for name, a, rows in (("own", own, own_rows), ("slab", slab, slab_rows)):
        if a.device != dev or a.dtype != torch.float32 or a.dim() != 2:
            raise ValueError(f"{p.kind}: {name} pack must be a 2-D f32 "
                             f"tensor on {dev}, got {a.dtype} "
                             f"{tuple(a.shape)} on {a.device}")
        if not a.is_contiguous():
            raise ValueError(f"{p.kind}: {name} pack is not contiguous")
        if a.shape[0] < rows:
            raise ValueError(f"{p.kind}: {name} pack has {a.shape[0]} rows,"
                             f" needs {rows}")
    if own.shape[1] < p.n_pad:
        raise ValueError(f"{p.kind}: own pack width {own.shape[1]} < "
                         f"n_blocks*block {p.n_pad}")
    sizes = (3 * p.n_blocks, None, None, 3 * p.n_blocks, p.n_blocks, 1)
    for i, (t, n) in enumerate(zip(tables, sizes)):
        if n is None:
            continue
        if (t.device != dev or t.dtype != torch.int32
                or not t.is_contiguous() or t.shape != (n,)):
            raise ValueError(f"{p.kind}: table {i} must be contiguous int32 "
                             f"[{n}] on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if not (32 <= p.block <= 1024 and p.block % 32 == 0):
        raise ValueError(f"{p.kind}: block {p.block} is not a multiple of "
                         "32 in [32, 1024]")


def _launch(p: PairPass, tables, own, slab):
    from . import _build

    _check(p, tables, own, slab)
    lib = _build.load()
    n_out = _SPECS[p.kind][0]
    out = torch.empty((n_out, p.n_pad), dtype=torch.float32,
                      device=own.device)
    aln, _, _, s0, cnt, ob = tables
    consts = (list(p.consts) + [0.0] * 4)[:4]
    with torch.cuda.device(own.device):
        stream = torch.cuda.current_stream(own.device).cuda_stream
        err = getattr(lib, "sph_pair_" + p.kind)(
            own.data_ptr(), own.shape[1], slab.data_ptr(), slab.shape[1],
            aln.data_ptr(), s0.data_ptr(), cnt.data_ptr(), ob.data_ptr(),
            out.data_ptr(), p.n_blocks, p.block, p.ccol, *consts, stream,
        )
    if err:
        msg = ctypes.string_at(lib.sph_cuda_error_string(err)).decode()
        raise RuntimeError(f"{p.kind} kernel launch failed: {msg} ({err})")
    LAUNCHES[p.kind] += 1
    return list(out)
