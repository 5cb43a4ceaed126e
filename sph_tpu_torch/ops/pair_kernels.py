"""Blocked all-pairs passes of the fast engines: Hopper kernels and their
plain PyTorch versions.

Counterpart of ``sph_tpu/ops/pair_kernels.py`` for the seven passes the fast
and wall-compact steps run (time-t density, rho*, viscosity/surface,
pressure force, boundary, and on scenes with elastic matter spring and
membrane). The contract is the JAX one:

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

Subgroup gate (``sub``, the counterpart of ``_make_sub_pass``): with
``0 < sub < block`` a pass takes the 8-tuple tables, the 6-tuple plus
``glo``, ``ghi``: int32 ``[n_blocks * 3 * (block // sub)]``, the unmerged
column window ``[glo, ghi)`` of each (block b, dz band, subgroup g) at index
``(3b + dz) * (block // sub) + g``. Rows ``g*sub .. (g+1)*sub - 1`` of a block
compute a tile only when its columns ``[off, off + ccol)`` overlap one of
their group's three windows. A skipped (tile, group) term is an exact zero at
sort time (the maskless invariant holds per subgroup), so the sums and their
order are unchanged.

Unlike the TPU driver there is no flat tile table with static caps: every
tile a table lists is computed. A tile column beyond the slab pack's width is
skipped (bounds check), which the tables never produce: the last tile of a
window ends before ``end + ccol <= width``.

Dispatch: a pass called on CPU tensors runs its plain version; on CUDA
tensors it launches the kernel (``csrc/pair_pass.cu``) or raises. Each kernel
launch adds one to ``LAUNCHES[kind]``, a gated one to ``LAUNCHES[kind +
"_sub"]``.

Every pair pass but the spring one runs on the ring driver (``pair_ring``
in ``csrc/pair_pass.cu``) in the configuration ``RING`` gives: density
(the time-t density and the clamped rho*), rho* (raw), viscosity/surface,
pressure force, boundary and membrane. Their slab tiles are copied into a ring of shared-memory stages
by 16-byte bulk copies, so their slab pack must start on a 16-byte boundary
and have a width that is a multiple of 4, ``ccol`` and every tile offset
(``aln``) must be multiples of 4, and a CTA's ``rows_cta`` must divide
``block`` (``_check``). The ring stages the slab rows every pair reads
(``PairPass.staged_rows``): the membrane pass only its x(t+1) rows, its
kernel reading the triangle rows of the few pairs within r0 from device
memory. The viscosity/surface, pressure-force, boundary and membrane
kernels skip a pair's body where every term is an exact zero
(``Ring.exit``); the thresholds are the passes' last constants
(``sqrt_reach``).

The ring kinds cull by boxes (``CHUNK``): each launch first writes the
box of every aligned run of ``CHUNK`` slab columns into a buffer kept a
device (the kernel ``pair_ring_boxes``, launched by the kind's own entry
point, counted in ``BOX_LAUNCHES``; ``chunk_boxes`` is its plain
version), and the ring kernel skips the columns of a chunk whose box
lies ``cull_reach`` or more from the box of a warp's rows
(``PairPass.cull_reach``: past it every term is an exact zero). The sums
are bitwise those without the cull; ``cull_chunks`` is the plain model of
what it skips. Launches made while the tracer is on (the graphs a traced
call replays) also count each kind's chunks tested and culled on the
device (``cull_counters``).

The spring pass runs on a list, not on tiles: ``spring_list`` (once per
resort period) turns the tile tables and the partner ids of the spring
slab into a CSR over the own rows of the (column, slot) entries that the
pair pass would match, in the order it meets them. The pass then takes the
8-tuple ``spring_list`` returns (the 6-tuple plus ``row_ptr``, ``ent``);
its kernel reads only the list. On the bare 6-tuple its plain version is
the pair form, the oracle the list is held to.
"""
from __future__ import annotations

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

# membrane pack columns: 7 triangles x (unit normal, reference vertex) at
# rows 6t..6t+5 (zeros when absent), then x(t+1) and x(t) of the column
MEM_COLS = 48
PMM_XN, PMM_YN, PMM_ZN = 42, 43, 44
PMM_XT, PMM_YT, PMM_ZT = 45, 46, 47
MEM_TRIS = 7

# spring pack rows: 0-2 elastic positions, then n_slots partner sorted row
# ids (f32, -1 pad), n_slots rest lengths (m), n_slots activation force
# terms. n_slots is the scene's measured max spring degree
# (``SceneLayout.spring_slots``).
SPR_IDX0 = 3


def spr_cols(n_slots: int) -> int:
    return 3 + 3 * n_slots


# kind -> (n_outputs, own pack rows, slab pack rows) the pass reads; the
# spring pass's slab rows depend on its slot count (see ``_rows``). The
# membrane pass reads no x(t) row of the slab.
_SPECS = {
    "density": (1, 3, 3),
    "rho_star": (1, ITER_COLS, ITER_COLS),
    "viscsurf": (6, PM_VEZ + 1, PM_RHO + 1),
    "paccel": (3, PACC_COLS, PACC_COLS),
    "boundary": (5, OWN_COLS, BND_COLS),
    "spring": (3, 3, None),
    "membrane": (5, OWN_COLS, PMM_ZN + 1),
}

# kind -> output indices grouped by quantity (the components of one vector
# are one group): comparisons scale a tolerance by the group's magnitude,
# since one component of a vector sum may cancel to far below the others.
OUTPUT_GROUPS = {
    "density": ((0,),),
    "rho_star": ((0,),),
    "viscsurf": ((0, 1, 2), (3, 4, 5)),
    "paccel": ((0, 1, 2),),
    "boundary": ((0, 1, 2), (3,), (4,)),
    "spring": ((0, 1, 2),),
    "membrane": ((0, 1, 2), (3,), (4,)),
}

# kinds with a subgroup-gated kernel (the fast engine's main-window passes)
GATED = ("density", "viscsurf", "paccel")


@dataclasses.dataclass(frozen=True)
class Ring:
    """The ring driver's configuration of one kind, compiled into the
    kernel (``_build.FLAGS`` passes each field as ``-DSPH_<KIND>_<FIELD>``).
    Chosen by timing a matrix of them on the card (PERF.md)."""

    rows: int          # own rows a thread (R), consecutive
    tpr: int           # threads a row; their partial sums add in fixed order
    stages: int        # tiles in the shared-memory ring
    rows_cta: int      # rows of an own block a CTA takes
    exit: bool = False  # the kind's exact early exit

    @property
    def warp_rows(self) -> int:
        """Own rows a warp holds, one consecutive run: the box cull's row
        box."""
        return 32 * self.rows // self.tpr


# kinds on the ring driver -> their configuration
RING = {"density": Ring(rows=1, tpr=2, stages=2, rows_cta=128),
        "rho_star": Ring(rows=2, tpr=4, stages=2, rows_cta=64),
        "viscsurf": Ring(rows=1, tpr=2, stages=2, rows_cta=64, exit=True),
        "paccel": Ring(rows=1, tpr=4, stages=2, rows_cta=64, exit=True),
        "boundary": Ring(rows=1, tpr=2, stages=2, rows_cta=64, exit=True),
        "membrane": Ring(rows=1, tpr=2, stages=2, rows_cta=128, exit=True)}
# the box cull's columns a chunk, for every ring kind (``_build.FLAGS``
# passes it as -DSPH_RING_CHUNK): divides ALIGN (the tiles' offsets are its
# multiples) and is a multiple of 4 tpr (a row's parts keep their columns)
CHUNK = 16

# kind -> the first slab row the ring stages, where it is not row 0: the
# membrane kernel stages x(t+1), what its distance test reads for every pair
_RING_ROW0 = {"membrane": PMM_XN}


# Kernel launches per kind, gated launches as kind + "_sub" (plain ints,
# reset by callers that count a run); the box cull's box launches apart.
LAUNCHES = {kind: 0 for kind in _SPECS} | {k + "_sub": 0 for k in GATED}
BOX_LAUNCHES = {"chunk_boxes": 0}

# the box cull's margins over the reach past which a pair's terms vanish:
# the rounding between the box test and the pair (csrc/pair_pass.cu),
# wider for paccel, whose radius goes through rsqrtf (2 ulps)
CULL_MARGIN = 2.0 ** -20
CULL_MARGIN_RSQRT = 2.0 ** -18
# kind -> its constant past which a pair's terms vanish (h^2, the exits'
# reach); paccel's is h^2 from h
_REACH = {"density": 0, "rho_star": 0, "viscsurf": 3, "boundary": 2,
          "membrane": 1}
# device -> int64 [len(RING), 2]: chunks tested and culled a kind, rows in
# RING's order (made at the first launch with the tracer on)
_CULL_COUNTS: dict = {}
# device -> the f32 [n, 8] buffers the box kernel writes, the newest (and
# largest) last: a launch uses the newest, made larger when a slab needs
# more; older ones stay, since a captured graph may still write to them
_BOXES: dict = {}

# Pair elements ([rows x columns]) per chunk of blocks in the plain
# versions, by device type. On the card a chunk's pair matrices may take
# ~64 MB per temporary (few, large launches); on the CPU 2 MB, so that the
# dozen temporaries of a chunk stay in cache (5x faster there than 64 MB).
_PLAIN_PAIRS = {"cuda": 1 << 24, "cpu": 1 << 19}


@dataclasses.dataclass(frozen=True)
class PairPass:
    """One configured pair pass: ``call(tables, own_pack, slab_pack)``.

    ``consts`` are the pass's f32 constants in the kernel's argument order
    (see ``csrc/pair_pass.cu``); ``n_slots`` is its one integer constant
    (the spring pass's partner slots, 0 elsewhere); ``sub`` the subgroup
    size of the gate (None or >= block: ungated)."""

    kind: str
    block: int
    ccol: int
    n_blocks: int
    consts: tuple[float, ...]
    n_slots: int = 0
    sub: int | None = None

    def __post_init__(self):
        if self.gated and (self.kind not in GATED or self.block % self.sub):
            raise ValueError(f"{self.kind}: no gated pass at block "
                             f"{self.block}, sub {self.sub}")

    @property
    def n_pad(self) -> int:
        return self.n_blocks * self.block

    @property
    def gated(self) -> bool:
        """Subgroup-gated: 8-tuple tables, a tile computed per group."""
        return self.sub is not None and 0 < self.sub < self.block

    @property
    def launch_key(self) -> str:
        """Its entry in ``LAUNCHES``."""
        return self.kind + "_sub" if self.gated else self.kind

    @property
    def slab_rows(self) -> int:
        """Slab pack rows the pass reads (and the kernel stages)."""
        return _rows(self)[2]

    @property
    def staged_rows(self) -> int:
        """Slab rows a kernel launch stages in shared memory a tile: those
        from ``_RING_ROW0`` (0 by default) up to the last row the pass
        reads, none for the spring list kernel."""
        if self.kind == "spring":
            return 0
        return self.slab_rows - _RING_ROW0.get(self.kind, 0)

    @property
    def shared_bytes(self) -> int:
        """Dynamic shared memory of one kernel launch: its ring of
        ``RING[kind].stages`` staged tiles."""
        if self.kind == "spring":
            return 0
        return 4 * self.staged_rows * self.ccol * RING[self.kind].stages

    @property
    def culls(self) -> bool:
        """Whether the pass's kernel takes the box cull: a ring kind whose
        tiles hold at most 32 chunks (one lane tests a chunk); a wider
        tile runs the unculled kernel, whose sums are the same."""
        return self.kind in RING and self.ccol <= 32 * CHUNK

    @property
    def cull_reach(self) -> float | None:
        """The ring kernel's box cull threshold: the f32 r2 at or above
        which every term of this pass's pair is an exact zero (density and
        rho*: h^2; viscsurf, boundary, membrane: their exit's reach;
        paccel: h^2, r >= h), times 1 + ``CULL_MARGIN`` (paccel:
        ``CULL_MARGIN_RSQRT``), rounded up to f32. None for the spring
        pass."""
        if self.kind == "paccel":
            t = self.consts[0] ** 2 * (1.0 + CULL_MARGIN_RSQRT)
        elif self.kind in _REACH:
            t = self.consts[_REACH[self.kind]] * (1.0 + CULL_MARGIN)
        else:
            return None
        v = np.float32(t)
        if float(v) < t:
            v = np.nextafter(v, np.float32(np.inf))
        return float(v)

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
        if self.kind == "density":
            out = [_density_of(self, out[0])]
        return out[0] if len(out) == 1 else tuple(out)

    def rounding_scale(self, tables, own_pack, slab_pack):
        """Per row and output, the magnitude the f32 rounding of this pass's
        sum scales with: sum_j |term_ij|, where a factor (c - r)^n that
        vanishes at its cutoff c (h, h^2, h/4, r0) counts as c (c - r)^(n-1),
        since an f32 c - r is off by ulps of c however small it is. Two
        correct f32 evaluations of the pass differ by a few ulps of it. The
        density's is its raw sum's times c_rho / h^6 where the clamp at 1 is
        not active (0 where it is: the output is c_rho exactly)."""
        out = _plain(self, tables, own_pack, slab_pack, scale=True)
        if self.kind == "density":
            _, _, inv_h6, c_rho = self.consts
            raw = _plain(self, tables, own_pack, slab_pack)[0]
            free = _density_of(self, raw) > c_rho
            out = [torch.where(free, out[0] * (c_rho * inv_h6), 0.0)]
        return out[0] if len(out) == 1 else tuple(out)

    def kernel(self, tables, own_pack, slab_pack):
        """Launch the CUDA kernel on the current stream."""
        out = _launch(self, tables, own_pack, slab_pack)
        return out[0] if len(out) == 1 else tuple(out)


def _rows(p: PairPass) -> tuple[int, int, int]:
    n_out, own_rows, slab_rows = _SPECS[p.kind]
    if p.kind == "spring":
        slab_rows = spr_cols(p.n_slots)
    return n_out, own_rows, slab_rows


def _f32(x) -> float:
    return float(np.float32(x))


def make_density_pass(*, block, ccol, n_blocks, inv_h2, c_rho, sub=None,
                      **_):
    """Density c_rho * max((s - (h^2)^3) / h^6, 1) with s_i = sum_j
    max(h^2 - r_ij^2, 0)^3 over the block's tiles, the self term included
    (then subtracted, exactly as f32 (h^2 h^2) h^2). Reads x, y, z from rows
    0-2 of both packs (the main pack, or the 3-row iteration pack: rho*).
    Rows with no tile (gated blocks, phantoms) sum 0 and clamp to c_rho."""
    h2 = np.float32(1.0) / np.float32(inv_h2)
    self3 = np.float32(h2 * h2) * h2
    inv_h6 = np.float32(inv_h2) * np.float32(inv_h2) * np.float32(inv_h2)
    return PairPass("density", block, ccol, n_blocks,
                    (float(h2), float(self3), float(inv_h6), _f32(c_rho)),
                    sub=sub)


def _density_of(p: PairPass, s):
    """The density pass's epilogue on its raw sums (the kernel's store)."""
    _, self3, inv_h6, c_rho = p.consts
    return c_rho * torch.clamp((s - self3) * inv_h6, min=1.0)


def make_rho_star_pass(*, block, ccol, n_blocks, inv_h2, c_rho, raw=False,
                       sub=None, **_):
    """Predicted density sums s_i = sum_j max(h^2 - r*_ij^2, 0)^3 (self term
    included; pack cols: predicted x, y, z). ``raw=True`` returns the bare
    sums, which the fastw engine combines across column sets before the
    clamp (never gated); otherwise c_rho * max((s - (h^2)^3) / h^6, 1): the
    density pass on the iteration pack."""
    if not raw:
        return make_density_pass(block=block, ccol=ccol, n_blocks=n_blocks,
                                 inv_h2=inv_h2, c_rho=c_rho, sub=sub)
    h2 = np.float32(1.0) / np.float32(inv_h2)
    return PairPass("rho_star", block, ccol, n_blocks, (float(h2),), sub=sub)


def sqrt_reach(h) -> np.float32:
    """The least f32 t with sqrtf(t) >= h. f32 sqrt is correctly rounded,
    hence monotone: every r2 >= t has sqrtf(r2) >= h, every r2 below has
    sqrtf(r2) < h."""
    h = np.float32(h)
    t = np.float32(h * h)
    while np.sqrt(t) >= h:
        t = np.nextafter(t, np.float32(0.0))
    while np.sqrt(t) < h:
        t = np.nextafter(t, np.float32(np.inf))
    return t


def make_viscsurf_pass(*, block, ccol, n_blocks, inv_h2, sub=None, **_):
    """Viscosity + surface-tension sums over the main pack: (vx, vy, vz) =
    sum max(h - r, 0) * (1/rho_j) * (v_j - v_i) / h, (sx, sy, sz) =
    sum_{r < h} (x_i - x_j). Wall columns carry their normal as v; the
    PM_RHO row carries 1/rho.

    The fourth constant is the kernel's exact early exit: at r2 >=
    max(h^2, sqrt_reach(h)) both terms are exact zeros (h - sqrtf(r2) <= 0
    and not r2 < h^2), so the pair is skipped before its sqrtf. h^2 alone
    is no safe bound: h and h^2 are rounded apart."""
    h = np.float32(1.0) / np.float32(np.sqrt(inv_h2))
    h2 = np.float32(1.0) / np.float32(inv_h2)
    inv_h = np.float32(np.sqrt(inv_h2))
    reach = max(h2, sqrt_reach(h))
    return PairPass("viscsurf", block, ccol, n_blocks,
                    (float(h), float(h2), float(inv_h), float(reach)),
                    sub=sub)


def make_paccel_pass(*, block, ccol, n_blocks, inv_h2, inv_h, rho0_delta,
                     sub=None, **_):
    """Pressure-force sums sum_j w_ij (x_i - x_j) * 0.5 / h^2 with
    w = [cm^2 rho0 delta if cm = h/4 - r > 0 else (h - r)_+^2 (p_i + p_j)]
    * (1/rho*_j) / r, and w = 0 at r = 0. Pack cols: [x, y, z, 1/rho*, p]."""
    h = np.float32(1.0) / np.float32(inv_h)
    h4 = np.float32(h / 4.0)
    out_c = np.float32(0.5) * np.float32(inv_h) * np.float32(inv_h)
    return PairPass("paccel", block, ccol, n_blocks,
                    (float(h), float(h4), _f32(rho0_delta), float(out_c)),
                    sub=sub)


def make_boundary_pass(*, block, ccol, n_blocks, r0, **_):
    """Ihmsen boundary sums: d = |x_new,i - x_j|, w = max(0, (r0 - d)/r0)
    * isb_j; outputs sum w n_j (3), sum w, sum w (r0 - d). Own pack cols
    [x_t, y_t, z_t, xn, yn, zn]; slab = boundary pack (BND_COLS).

    The third constant is the kernel's exact early exit: at r2 >=
    sqrt_reach(r0), sqrtf(r2) >= r0, so w is a zero and so is every term;
    the pair is skipped before its sqrtf."""
    r0 = np.float32(r0)
    inv_r0 = np.float32(1.0 / r0)
    return PairPass("boundary", block, ccol, n_blocks,
                    (float(r0), float(inv_r0), float(sqrt_reach(r0))))


def make_spring_pass(*, block, ccol, n_blocks, inv_h, h_scale, k_spring,
                     n_slots=32, **_):
    """Elastic + muscle spring forces as a pair pass over the compact
    elastic slab. The slab lists each elastic column j's spring partners as
    sorted row ids; a pair (own i, column j) matches once per slot of j that
    holds i (msum; the graph is symmetric). With q2 = r^2 / h^2,
    r_m = q2 * rsqrt(max(q2, 1e-30)) * h_scale (meters) and the matched
    slots' summed rest lengths and activation terms,
    coef = -(r_m * msum - sum rest) * k_spring - sum actf, and the outputs
    are sum_j coef * rsqrt(q2) / h * (x_i - x_j) over pairs with msum > 0 and
    q2 > 0: accelerations in scaled SI units. No radius cutoff: a spring is
    included whenever its partner column lies in the block's tiles.

    Own pack: positions at rows 0-2 (the main pack). Slab: ``spr_cols``
    rows. Row ids are compared as f32, exact below 2^24 rows. The pass
    takes the 8-tuple of ``spring_list`` (see the module docstring)."""
    if n_blocks * block + ccol >= 1 << 24:
        raise ValueError(
            f"spring pass: {n_blocks * block} own rows do not compare "
            "exactly as f32 ids (limit 2^24)")
    if n_slots < 1:
        raise ValueError(f"spring pass: n_slots {n_slots} < 1")
    inv_h = np.float32(inv_h)
    return PairPass("spring", block, ccol, n_blocks,
                    (float(inv_h), float(inv_h * inv_h), _f32(h_scale),
                     _f32(k_spring)), n_slots=int(n_slots))


def make_membrane_pass(*, block, ccol, n_blocks, r0, **_):
    """Membrane interaction sums. Per pair (own i, elastic column j) and
    each of j's 7 triangle slots t with unit normal n_t and vertex a_t:
    s_t = n_t . (x_new,i - a_t), counted when |n_t|^2 > 0 and s_t != 0;
    v = sum sign(s_t) n_t, cnt = the number counted. With
    d = |x_new,i - x_new,j| and w = max(0, (r0 - d) / r0) where cnt > 0
    (else 0), the outputs are sum (w / cnt) v (3), sum w, sum w (r0 - d).

    Own pack cols [x_t, y_t, z_t, xn, yn, zn]; slab = membrane pack
    (``MEM_COLS`` rows; columns without a triangle carry all-zero normals).
    Blocks without liquid near a membrane have their tile count zeroed by
    the caller, which also masks the correction to liquid rows.

    The second constant is the kernel's exit, sqrt_reach(r0): r2 >= it
    exactly where d >= r0, the pairs whose weight is 0, tested before the
    sqrtf."""
    r0 = np.float32(r0)
    return PairPass("membrane", block, ccol, n_blocks,
                    (float(r0), float(sqrt_reach(r0))))


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

# Each function below returns the pass's per-row sums over the pair axis.
# With ``scale`` it returns their rounding scale instead (see
# ``PairPass.rounding_scale``): absolute terms, cutoff factors uncancelled.

def _sum(term, scale):
    return term.abs().sum(-1) if scale else term.sum(-1)


def _rho_star_pairs(p, o, s, valid, gid, scale):
    h2 = p.consts[0]                 # the density pass's raw sums too
    dx, dy, dz = o[0] - s[0], o[1] - s[1], o[2] - s[2]
    t = torch.clamp(h2 - (dx * dx + dy * dy + dz * dz), min=0.0)
    return [torch.where(valid, t * t * (h2 if scale else t), 0.0).sum(-1)]


def _viscsurf_pairs(p, o, s, valid, gid, scale):
    h, h2, inv_h = p.consts[:3]
    dx, dy, dz = o[0] - s[0], o[1] - s[1], o[2] - s[2]
    r2 = dx * dx + dy * dy + dz * dz
    t = torch.clamp(h - torch.sqrt(r2), min=0.0)
    if scale:
        t = torch.where(t > 0.0, h, 0.0)
    wv = torch.where(valid, t * s[PM_RHO], 0.0)
    ws = (valid & (r2 < h2)).to(torch.float32)
    return [_sum(wv * (s[PM_VEX + k] - o[PM_VEX + k]), scale) * inv_h
            for k in range(3)] + [_sum(ws * d, scale) for d in (dx, dy, dz)]


def _paccel_pairs(p, o, s, valid, gid, scale):
    h, h4, rho0_delta, out_c = p.consts
    dx, dy, dz = o[0] - s[0], o[1] - s[1], o[2] - s[2]
    r2 = dx * dx + dy * dy + dz * dz
    inv_r = torch.rsqrt(torch.clamp(r2, min=1e-30))
    r = r2 * inv_r
    t = torch.clamp(h - r, min=0.0)
    far = t * (h if scale else t) * (o[4] + s[4])
    cm = h4 - r
    close = cm * (h4 if scale else cm) * rho0_delta
    term = torch.where(cm > 0.0, close, far) * s[3]
    w = torch.where(valid & (r2 > 0.0), term * inv_r, 0.0)
    return [_sum(w * d, scale) * out_c for d in (dx, dy, dz)]


def _boundary_pairs(p, o, s, valid, gid, scale):
    r0, inv_r0 = p.consts[:2]
    dnx, dny, dnz = o[3] - s[PB_X], o[4] - s[PB_Y], o[5] - s[PB_Z]
    dist = torch.sqrt(dnx * dnx + dny * dny + dnz * dnz)
    w = torch.clamp((r0 - dist) * inv_r0, min=0.0)
    if scale:
        w = torch.where(w > 0.0, 1.0, 0.0)
    w = torch.where(valid, w * s[PB_ISB], 0.0)
    return [_sum(w * s[PB_NX + k], scale) for k in range(3)] + [
        _sum(w, scale), _sum(w * (r0 - dist), scale)]


def _spring_weight(p, dx, dy, dz, msum, rest, actf, scale):
    """The spring term's weight w (force = w * (x_i - x_j)) of pairs whose
    matched slots sum to ``msum``, ``rest``, ``actf``; 0 unless msum > 0
    and q2 > 0."""
    inv_h, inv_h_sq, h_scale, k_spring = p.consts
    q2 = (dx * dx + dy * dy + dz * dz) * inv_h_sq
    inv_q = torch.rsqrt(torch.clamp(q2, min=1e-30))
    r_m = q2 * inv_q * h_scale
    if scale:                    # r - rest cancels too: ulps of the lengths
        coef = (r_m * msum + rest.abs()) * k_spring + actf.abs()
    else:
        coef = -(r_m * msum - rest) * k_spring - actf
    return torch.where((msum > 0.0) & (q2 > 0.0), coef * inv_q * inv_h, 0.0)


def _spring_pairs(p, o, s, valid, gid, scale):
    n = p.n_slots
    dx, dy, dz = o[0] - s[0], o[1] - s[1], o[2] - s[2]
    msum = torch.zeros_like(dx)
    rest = torch.zeros_like(dx)
    actf = torch.zeros_like(dx)
    for k in range(n):
        m = (s[SPR_IDX0 + k] == gid).to(dx.dtype)
        msum = msum + m
        rest = rest + m * s[SPR_IDX0 + n + k]
        actf = actf + m * s[SPR_IDX0 + 2 * n + k]
    w = torch.where(valid, _spring_weight(p, dx, dy, dz, msum, rest, actf,
                                          scale), 0.0)
    return [_sum(w * d, scale) for d in (dx, dy, dz)]


def _membrane_pairs(p, o, s, valid, gid, scale):
    r0 = p.consts[0]
    xn, yn, zn = o[3], o[4], o[5]
    cnt = vx = vy = vz = 0.0
    for t in range(MEM_TRIS):
        ntx, nty, ntz = s[6 * t], s[6 * t + 1], s[6 * t + 2]
        side = ((xn - s[6 * t + 3]) * ntx + (yn - s[6 * t + 4]) * nty
                + (zn - s[6 * t + 5]) * ntz)
        has = (ntx * ntx + nty * nty + ntz * ntz > 0.0) & (side != 0.0)
        sgn = torch.where(has, torch.sign(side), 0.0)
        cnt = cnt + sgn.abs()
        vx, vy, vz = vx + sgn * ntx, vy + sgn * nty, vz + sgn * ntz
    inv_cnt = 1.0 / torch.clamp(cnt, min=1.0)
    dnx, dny, dnz = xn - s[PMM_XN], yn - s[PMM_YN], zn - s[PMM_ZN]
    dist = torch.sqrt(dnx * dnx + dny * dny + dnz * dnz)
    w = torch.clamp((r0 - dist) / r0, min=0.0)
    if scale:
        w = torch.where(w > 0.0, 1.0, 0.0)
    w = torch.where(valid & (cnt > 0.0), w, 0.0)
    wc = w * inv_cnt
    return [_sum(wc * v, scale) for v in (vx, vy, vz)] + [
        _sum(w, scale), _sum(w * (r0 - dist), scale)]


_PAIRS = {
    "density": _rho_star_pairs,
    "rho_star": _rho_star_pairs,
    "viscsurf": _viscsurf_pairs,
    "paccel": _paccel_pairs,
    "boundary": _boundary_pairs,
    "spring": _spring_pairs,
    "membrane": _membrane_pairs,
}


def _tile_columns(tables, ccol, blocks, n_tiles, width):
    """Slab column ids [len(blocks), n_tiles*ccol] that the given blocks
    stream, their validity (tile within the block's count, column within
    the slab width), and each tile's first column [len(blocks), n_tiles]."""
    aln, _, _, s0, cnt, _ = (t.long() for t in tables[:6])
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
    return cols, valid.reshape(nb, -1), off


def _group_gate(p: PairPass, tables, blocks, off):
    """[len(blocks), block, n_tiles * ccol]: the subgroup gate of each own
    row and tile column. A row's group computes a tile when the tile's
    columns [off, off + ccol) overlap one of its three windows."""
    ng = p.block // p.sub
    glo, ghi = (t.long().reshape(p.n_blocks, 3, ng)[blocks][..., None]
                for t in tables[6:8])                       # [nb, 3, ng, 1]
    o = off[:, None, None, :]                               # [nb, 1, 1, T]
    hit = ((ghi > o) & (glo < o + p.ccol)).any(1)           # [nb, ng, T]
    hit = hit.repeat_interleave(p.sub, dim=1)               # [nb, B, T]
    return hit[..., None].expand(-1, -1, -1, p.ccol).reshape(
        hit.shape[0], p.block, -1)


def _plain(p: PairPass, tables, own, slab, scale=False):
    """Sum over each block's tiles: pair matrices gathered per chunk of
    blocks (blocks without tiles skipped), with none of the TPU driver's
    static tile caps; the spring pass on its list (8-tuple) sums over the
    list. ``scale``: the sums' rounding scale instead."""
    if p.kind == "spring" and len(tables) == 8:
        return _spring_list_sums(p, tables, own, slab, scale)
    n_out = _rows(p)[0]
    out = torch.zeros((n_out, p.n_blocks, p.block), dtype=own.dtype,
                      device=own.device)
    for blocks, live, o, s, valid, gid in pair_chunks(p, tables, own, slab):
        res = _PAIRS[p.kind](p, o, s, valid, gid, scale)
        for k, r in enumerate(res):
            out[k, blocks] = torch.where(live, r, 0.0)
    return list(out.reshape(n_out, p.n_pad))


def pair_chunks(p: PairPass, tables, own, slab):
    """The pass's pair matrices, chunk by chunk of the blocks with tiles:
    yields (blocks [nb], live own rows [nb, B], own fields [k, nb, B, 1],
    slab fields [k, nb, 1, C], valid pairs [nb, B | 1, C] (tile listed,
    column in the slab, gate), own row ids as the packs' dtype [nb, B, 1])."""
    _, own_rows, slab_rows = _rows(p)
    B = p.block
    dev = own.device
    cnt = tables[4].long()
    # host syncs: the plain path sizes its gathers from the tables
    active = torch.nonzero(cnt > 0).reshape(-1)
    active = active[torch.argsort(cnt[active], stable=True)]
    counts = cnt[active].tolist()
    ob = int(tables[5][0])
    own_w, slab_w = own.shape[1], slab.shape[1]
    own = own[:own_rows]
    slab = slab[:slab_rows]
    budget = _PLAIN_PAIRS[dev.type]
    i = 0
    while i < len(counts):
        # blocks sorted by tile count: grow the chunk while its widest
        # (last) block keeps the gathered pair matrices within budget
        j = i + 1
        while (j < len(counts) and (j + 1 - i) * B * counts[j] * p.ccol
               <= budget):
            j += 1
        blocks = active[i:j]
        cols, valid, off = _tile_columns(tables, p.ccol, blocks,
                                         counts[j - 1], slab_w)
        rows = ob + blocks[:, None] * B + torch.arange(B, device=dev)
        live = (rows >= 0) & (rows < own_w)
        o = own[:, torch.where(live, rows, 0)][..., None]   # [k, nb, B, 1]
        s = slab[:, cols][:, :, None, :]                    # [k, nb, 1, C]
        gid = rows.to(own.dtype)[..., None]                 # [nb, B, 1]
        valid = valid[:, None, :]
        if p.gated:
            valid = valid & _group_gate(p, tables, blocks, off)
        yield blocks, live, o, s, valid, gid
        i = j


# ---------------------------------------------------------------------------
# the spring pass's list
# ---------------------------------------------------------------------------

def spring_list(p: PairPass, tables, slab):
    """The spring pass's 8-tuple: ``tables`` (the 6-tuple) plus a CSR over
    the own rows of the spring entries the pair pass would match:
    ``row_ptr`` int32 [n_pad + 1] and ``ent`` int32 [n_slots * width]
    (width: the spring slab's), entry ``j * n_slots + s`` for slot s of
    slab column j.

    Slot s of column j lists partner id g (slab row ``SPR_IDX0 + s``): the
    entry belongs to own row i = g - ob when g is an integer with 0 <= i <
    n_pad and column j lies in a tile that i's block streams (tile t < cnt,
    at column aln[c] + (t - s0[c]) * ccol of chunk c, as the pair pass
    reads the tables; the tiles of a block are disjoint, so there is at
    most one). Entries are built from the columns' lists (j -> i), never
    from i's own, so no symmetry is assumed. Each row's entries are in the
    order the pair pass meets them: tile (chunk) order, column, slot.

    Shape-static and free of host syncs: the shapes depend only on
    (n_slots, width, n_pad); dropped entries sort to the end under a
    sentinel key (``row_ptr[n_pad]`` counts the kept ones). Run once per
    resort period: the ids, and so the list, are fixed between sorts."""
    if p.kind != "spring":
        raise ValueError(f"spring_list of a {p.kind} pass")
    n, width = p.n_slots, slab.shape[1]
    span = 3 * width * n                       # key range of one own row
    if (p.n_pad + 1) * span >= 1 << 62 or width * n >= 1 << 31:
        raise ValueError(f"spring_list: {p.n_pad} rows x {width} columns x "
                         f"{n} slots overflow the list's keys")
    dev = slab.device
    aln, _, _, s0, cnt, ob = (t.long() for t in tables[:6])
    ids = slab[SPR_IDX0:SPR_IDX0 + n]                       # [n, width]
    g = ids.long()
    i = g - ob
    ok = (ids >= 0) & (ids == g.to(ids.dtype)) & (i >= 0) & (i < p.n_pad)
    i = torch.where(ok, i, 0)
    b = i // p.block
    b3 = 3 * b
    j = torch.arange(width, device=dev)
    # the chunk (0-2) whose tile of i's block holds column j, else 3. A
    # tile's chunk is nondecreasing in its index, so chunk order, then
    # column, is the pair pass's tile order, then column
    chunk = torch.full_like(i, 3)
    for k in (2, 1, 0):
        c = b3 + k
        t = s0[c] + torch.div(j - aln[c], p.ccol, rounding_mode="floor")
        in_c = b3 + (t >= s0[b3 + 1]).long() + (t >= s0[b3 + 2]).long()
        hit = (in_c == c) & (t >= 0) & (t < cnt[b])
        chunk = torch.where(hit, k, chunk)
    slot = torch.arange(n, device=dev)[:, None]
    key = ((i * 3 + chunk) * width + j) * n + slot
    key = torch.where(ok & (chunk < 3), key, p.n_pad * span)
    key = torch.sort(key.reshape(-1)).values
    bounds = torch.arange(p.n_pad + 1, device=dev) * span
    row_ptr = torch.searchsorted(key, bounds, out_int32=True)
    ent = (key % (width * n)).to(torch.int32)
    return tuple(tables[:6]) + (row_ptr, ent)


def _spring_list_sums(p: PairPass, tables, own, slab, scale):
    """The spring pass's sums over its list (the 8-tuple of
    ``spring_list``): consecutive entries of one row and column merged
    (msum, rest, actf summed over their slots), one term a merged column,
    summed into its row. Host syncs: the merged columns are counted."""
    n = p.n_slots
    row_ptr, ent = tables[6].long(), tables[7].long()
    dev = own.device
    e = torch.arange(ent.shape[0], device=dev)
    row = torch.searchsorted(row_ptr, e, right=True) - 1
    keep = e < row_ptr[-1]
    row, ent = row[keep], ent[keep]
    j, s = ent // n, ent % n
    new = torch.ones_like(row, dtype=torch.bool)
    new[1:] = (row[1:] != row[:-1]) | (j[1:] != j[:-1])
    grp = torch.cumsum(new, 0) - 1
    first = torch.nonzero(new).reshape(-1)
    g_row, g_col = row[first], j[first]

    def seg(v):
        return torch.zeros(first.shape[0], dtype=own.dtype,
                           device=dev).index_add_(0, grp, v)

    msum = seg(torch.ones_like(j, dtype=own.dtype))
    rest = seg(slab[SPR_IDX0 + n + s, j])
    actf = seg(slab[SPR_IDX0 + 2 * n + s, j])
    orow = tables[5].long()[0] + g_row
    live = (orow >= 0) & (orow < own.shape[1])
    orow = torch.where(live, orow, 0)
    d = [own[k, orow] - slab[k, g_col] for k in range(3)]
    w = torch.where(live, _spring_weight(p, *d, msum, rest, actf, scale),
                    0.0)
    out = []
    for dk in d:
        t = w * dk
        out.append(torch.zeros(p.n_pad, dtype=own.dtype, device=dev)
                   .index_add_(0, g_row, t.abs() if scale else t))
    return out


# ---------------------------------------------------------------------------
# the box cull
# ---------------------------------------------------------------------------

# kind -> the first own-pack row of the positions its distance test reads
# (the boundary and membrane passes: the new positions); 0 elsewhere
_OWN_XYZ = {"boundary": 3, "membrane": 3}


def chunk_boxes(slab, row0: int, chunk: int):
    """Plain version of the box kernel (``pair_ring_boxes`` in
    ``csrc/pair_pass.cu``): [ceil(width / chunk), 8] f32, row b (min x,
    min y, min z, 0, max x, max y, max z, 0) of slab rows row0 .. row0 + 2
    over columns b chunk .. b chunk + chunk - 1 below the slab's width."""
    x = slab[row0:row0 + 3]
    n = -(-x.shape[1] // chunk)
    pad = (0, n * chunk - x.shape[1])
    lo = torch.nn.functional.pad(x, pad, value=float("inf"))
    hi = torch.nn.functional.pad(x, pad, value=float("-inf"))
    lo = lo.reshape(3, n, chunk).amin(2)
    hi = hi.reshape(3, n, chunk).amax(2)
    zero = torch.zeros_like(lo[0])
    return torch.stack([lo[0], lo[1], lo[2], zero, hi[0], hi[1], hi[2],
                        zero], 1)


def cull_chunks(p: PairPass, tables, own, slab, blocks, boxes=None):
    """The box cull as the ring kernel makes it, for own blocks ``blocks``
    (a 1-D int64 tensor): (keep, tested), bool [len(blocks), tiles, warps,
    chunks] over each block's tiles (the most any of them streams), its
    warps (``Ring.warp_rows`` consecutive rows each) and each tile's
    ``ccol / CHUNK`` chunks. A chunk is tested where the pass culls
    (``PairPass.culls``), its tile is listed, it starts inside the slab
    and (gated) a live row of the warp takes the tile; kept where it is
    tested and its box comes within ``cull_reach`` of the box of the
    warp's live rows, or its tile does not start on a multiple of
    ``CHUNK``, and, untested, wherever the pass does not cull. Gaps in the
    packs' dtype, each axis's unfused, as the kernel takes them."""
    C, W, B = CHUNK, RING[p.kind].warp_rows, p.block
    nw, nch = B // W, p.ccol // C
    aln, _, _, s0, cnt, ob = (t.long() for t in tables[:6])
    slab_w, own_w = slab.shape[1], own.shape[1]
    if boxes is None:
        boxes = chunk_boxes(slab, _RING_ROW0.get(p.kind, 0), C)
    dev, nb = own.device, blocks.shape[0]
    n_t = max(int(cnt[blocks].max()) if nb else 0, 1)
    s = torch.arange(n_t, device=dev)[None, :]
    b3 = blocks[:, None] * 3
    c = b3 + (s >= s0[b3 + 1]).long() + (s >= s0[b3 + 2]).long()
    off = aln[c] + (s - s0[c]) * p.ccol                     # [nb, T]
    ncol = torch.where(off < 0, 0, torch.clamp(slab_w - off, 0, p.ccol))
    cc = torch.arange(nch, device=dev) * C
    inside = (s < cnt[blocks, None])[..., None] & (cc < ncol[..., None])
    bi = torch.clamp(torch.div(off[..., None] + cc, C, rounding_mode="floor"),
                     0, boxes.shape[0] - 1)
    bx = boxes[bi]                                          # [nb, T, nch, 8]
    rows = int(tables[5][0]) + blocks[:, None] * B + torch.arange(B,
                                                                  device=dev)
    live = (rows >= 0) & (rows < own_w)
    i0 = _OWN_XYZ.get(p.kind, 0)
    xyz = own[i0:i0 + 3][:, torch.where(live, rows, 0)]     # [3, nb, B]
    inf = torch.tensor(float("inf"), dtype=own.dtype, device=dev)
    lo = torch.where(live, xyz, inf).reshape(3, nb, nw, W).amin(-1)
    hi = torch.where(live, xyz, -inf).reshape(3, nb, nw, W).amax(-1)
    g2 = None
    for k in range(3):
        g = torch.clamp(torch.maximum(
            bx[..., k][:, :, None, :] - hi[k][:, None, :, None],
            lo[k][:, None, :, None] - bx[..., 4 + k][:, :, None, :]), min=0.0)
        g2 = g * g if g2 is None else g2 + g * g           # [nb, T, nw, nch]
    inside = inside[:, :, None, :].expand(-1, -1, nw, -1)
    if p.gated:
        ng = B // p.sub
        glo, ghi = (t.long().reshape(p.n_blocks, 3, ng)[blocks][..., None]
                    for t in tables[6:8])                   # [nb, 3, ng, 1]
        o = off[:, None, None, :]
        hit = ((ghi > o) & (glo < o + p.ccol)).any(1)       # [nb, ng, T]
        hit = hit.repeat_interleave(p.sub, dim=1) & live[..., None]
        takes = hit.reshape(nb, nw, W, n_t).any(2)          # [nb, nw, T]
        inside = inside & takes.permute(0, 2, 1)[..., None]
    if not p.culls:
        return inside, torch.zeros_like(inside)
    aligned = (off % C == 0)[:, :, None, None]
    keep = inside & (~(g2 >= p.cull_reach) | ~aligned)
    return keep, inside


def cull_counts(p: PairPass, tables, own, slab):
    """(chunks tested, chunks culled) of one launch of the pass, summed over
    every own block and warp as the kernel's counters count them
    (``cull_chunks``, 256 blocks at a time)."""
    boxes = chunk_boxes(slab, _RING_ROW0.get(p.kind, 0), CHUNK)
    tested = culled = 0
    for b0 in range(0, p.n_blocks, 256):
        blocks = torch.arange(b0, min(b0 + 256, p.n_blocks),
                              device=own.device)
        keep, t = cull_chunks(p, tables, own, slab, blocks, boxes)
        tested += int(t.sum())
        culled += int((t & ~keep).sum())
    return tested, culled


def _cull_counter(device, kind: str):
    """The address of ``kind``'s two device counters (chunks tested,
    culled) on ``device``, made zero at its first use; None where none
    exists yet and a capture is under way (a buffer made inside a capture
    would be zeroed at every replay)."""
    buf = _CULL_COUNTS.get(device)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            return None
        buf = _CULL_COUNTS[device] = torch.zeros(
            (len(RING), 2), dtype=torch.int64, device=device)
    return buf[list(RING).index(kind)].data_ptr()


def box_buffer(device, n: int):
    """The box cull's buffer on ``device`` for ``n`` boxes: f32 [m, 8], m
    >= n, whose first ``n`` rows the box kernel of a ring launch there
    writes (the boxes of its slab). The newest buffer serves while it
    holds ``n``; else one of ``n`` boxes and a quarter more is made and
    kept, unless a capture is under way: a buffer made inside one stays
    in its graph's pool and serves that launch alone."""
    bufs = _BOXES.setdefault(device, [])
    if bufs and bufs[-1].shape[0] >= n:
        return bufs[-1]
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        return torch.empty((n, 8), dtype=torch.float32, device=device)
    bufs.append(torch.empty((n + n // 4, 8), dtype=torch.float32,
                            device=device))
    return bufs[-1]


def cull_counters() -> dict:
    """``pair.<kind>.chunks`` and ``pair.<kind>.culled``: the chunks the
    ring kernels launched with the tracer on tested and culled, summed over
    the devices (a device read), for the kinds that tested any."""
    out = {}
    for buf in _CULL_COUNTS.values():
        for kind, (n, culled) in zip(RING, buf.tolist()):
            if n:
                for key, v in (("chunks", n), ("culled", culled)):
                    name = f"pair.{kind}.{key}"
                    out[name] = out.get(name, 0) + v
    return out


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

def _check(p: PairPass, tables, own, slab):
    n_out, own_rows, slab_rows = _rows(p)
    dev = own.device
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
    n_tab = 8 if p.gated or p.kind == "spring" else 6
    if len(tables) != n_tab:
        raise ValueError(f"{p.kind}: expected the {n_tab}-tuple tables, "
                         f"got {len(tables)}")
    sizes = (3 * p.n_blocks, None, None, 3 * p.n_blocks, p.n_blocks, 1)
    if p.gated:
        sizes += (3 * p.n_blocks * (p.block // p.sub),) * 2
    if p.kind == "spring":             # the list: row_ptr, ent
        sizes += (p.n_pad + 1, p.n_slots * slab.shape[1])
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
    if p.kind == "spring" and tables[6].device.type == "cpu":
        # the list's invariants, where reading them costs no host sync
        # (on the card the kernel skips entries outside the slab)
        row_ptr, ent = tables[6], tables[7]
        if not (int(row_ptr[0]) == 0 and bool((row_ptr[1:] >= row_ptr[:-1])
                                              .all())
                and int(row_ptr[-1]) <= ent.shape[0]
                and bool(((ent >= 0) & (ent < ent.shape[0])).all())):
            raise ValueError(f"{p.kind}: a malformed list: row_ptr must "
                             "rise from 0 to at most the entries' capacity, "
                             "entries must address the slab's slots")
    ring = RING.get(p.kind)
    if ring is None:
        return
    if p.block % ring.rows_cta:
        raise ValueError(f"{p.kind}: the ring kernel takes {ring.rows_cta} "
                         f"rows a CTA, which do not divide block {p.block}")
    if p.gated and p.sub % ring.rows:
        raise ValueError(f"{p.kind}: the gated ring kernel keeps a thread's "
                         f"{ring.rows} rows in one subgroup, which sub "
                         f"{p.sub} does not allow")
    # the ring driver's bulk copies: 16-byte units, 16-byte aligned. Tables
    # on the card are not read here (a host sync a launch): the engines'
    # aln are multiples of ALIGN by construction
    aln = tables[0]
    if slab.data_ptr() % 16 or slab.shape[1] % 4 or p.ccol % 4 or (
            aln.device.type == "cpu" and bool((aln % 4 != 0).any())):
        raise ValueError(
            f"{p.kind}: the ring kernel needs a slab pack on a 16-byte "
            f"boundary with a width, ccol and tile offsets (aln) that are "
            f"multiples of 4; got address {slab.data_ptr()} (mod 16: "
            f"{slab.data_ptr() % 16}), width {slab.shape[1]}, ccol "
            f"{p.ccol}")


def check_tile_offsets(aln, label: str) -> None:
    """The ring driver's tile-offset precondition (every ``aln`` a
    nonnegative multiple of 4), read where an engine builds its tables:
    one host read a resort period, where ``_check`` reads only CPU tables
    (a read a launch would sync the card)."""
    if bool(((aln % 4 != 0) | (aln < 0)).any()):
        raise ValueError(f"{label}: a tile offset (aln) that is negative or "
                         "not a multiple of 4; the ring kernels' bulk "
                         "copies need 16-byte aligned tiles")


def _launch(p: PairPass, tables, own, slab):
    out = _call(p, tables, own, slab)
    LAUNCHES[p.launch_key] += 1
    if p.culls:
        BOX_LAUNCHES["chunk_boxes"] += 1
    return out


def _call(p: PairPass, tables, own, slab, entry=None):
    """Check the inputs, launch ``sph_pair_<kind>`` (or the library's
    ``entry``) on the current stream, raise on a launch error; returns the
    output rows. A ring kind's own entry point launches the box kernel on
    the slab, into ``box_buffer``, then the ring kernel; with the tracer
    on, the kernel also counts its chunks (``cull_counters``). Counts
    nothing: ``_launch`` counts the pass's own launches."""
    from . import _build
    from .. import trace

    _check(p, tables, own, slab)
    lib = _build.load()
    n_out = _rows(p)[0]
    out = torch.empty((n_out, p.n_pad), dtype=torch.float32,
                      device=own.device)
    aln, _, _, s0, cnt, ob = tables[:6]
    consts = (list(p.consts) + [0.0] * 4)[:4]
    with torch.cuda.device(own.device):
        stream = torch.cuda.current_stream(own.device).cuda_stream
        cull = ()
        if p.kind in RING and entry is None:
            cull = (None, 0.0, None)
            if p.culls:
                boxes = box_buffer(own.device, -(-slab.shape[1] // CHUNK))
                cull = (boxes.data_ptr(), p.cull_reach,
                        _cull_counter(own.device, p.kind) if trace.on()
                        else None)
        if p.kind == "spring" and entry is None:      # the list kernel
            err = lib.sph_pair_spring(
                own.data_ptr(), own.shape[1], slab.data_ptr(), slab.shape[1],
                tables[6].data_ptr(), tables[7].data_ptr(), ob.data_ptr(),
                out.data_ptr(), p.n_pad, *consts, p.n_slots, stream)
        else:
            # the gate's windows, or null pointers and sub 0: ungated
            glo, ghi = ((t.data_ptr() for t in tables[6:8]) if p.gated
                        else (None, None))
            err = getattr(lib, entry or "sph_pair_" + p.kind)(
                own.data_ptr(), own.shape[1], slab.data_ptr(), slab.shape[1],
                aln.data_ptr(), s0.data_ptr(), cnt.data_ptr(), ob.data_ptr(),
                glo, ghi, p.sub if p.gated else 0,
                out.data_ptr(), p.n_blocks, p.block, p.ccol, *consts,
                p.n_slots, stream, *cull,
            )
    if err:
        raise RuntimeError(f"{p.kind} kernel launch failed: "
                           f"{_build.error_string(err)} ({err})")
    return list(out)
