"""Window tables and field packs of the blocked pair engines.

Counterpart of the parts of ``sph_tpu/core/fast.py`` that the wall-compact
engine reuses: :class:`FastConfig`, ``_window_tables`` (without the
subgroup tables), ``_tile_chunks``, ``_pad_field`` and ``_pack``. The fast
engine itself is ROADMAP Queue 1 item 7.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops import pair_kernels as pk

ALIGN = pk.ALIGN


@dataclasses.dataclass(frozen=True)
class FastConfig:
    """Static shapes of a blocked pair engine's sorted row space (hashable;
    the fields ``_window_tables`` reads)."""

    n_particles: int
    n_blocks: int
    block: int  # own-block size (sorted particles per block)
    ccol: int   # slab tile width (multiple of 128)
    dims: tuple[int, int, int]  # h-granularity grid dims

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


def _window_tables(pencil_s, cfg: FastConfig):
    """Per-block interaction-window descriptors.

    For each own block (``block`` consecutive sorted particles) the
    candidate set is three contiguous sorted-array windows — the pencil
    bands (z-1, z, z+1) x (x span +- 1 pencil) around the block's pencil
    range. Returns the 6-tuple tables (aligned_offset, lo, hi, tile_start,
    tile_count, own_base) as int32 [nb*3] / [nb] / [1], the per-pencil start
    offsets, and the per-block pencil ranges.

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
    return tables, pstart, pencil_ranges


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


def _pack(fields):
    """Column-major [fields, width] pack: one contiguous row per field."""
    return torch.stack(fields, dim=0)
