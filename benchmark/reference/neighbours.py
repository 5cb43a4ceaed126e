"""Fixed-radius neighbour search in plain PyTorch.

``within(query, target, radius)`` returns, for every query row, the ids of
the target rows closer than ``radius`` as a dense ``[rows, K]`` matrix,
padded with ``len(target)`` (an id the callers map to a row placed far
away). The targets are bucketed on a grid of cell ``radius``; a query row
reads the 27 cells around its own, which, with z the fastest index of the
cell key, are 9 runs of 3 consecutive cells of the sorted targets.
"""
from __future__ import annotations

import torch

# entries of the candidate matrix held at once (rows x candidates)
_CHUNK_ENTRIES = 1 << 25


def _cells(p, origin, radius):
    return torch.floor((p - origin) / radius).long() + 1


def within(query: torch.Tensor, target: torch.Tensor, radius: float,
           same: bool = False) -> torch.Tensor:
    """[len(query), K] int64 target ids with |query_i - target_j| < radius,
    in the targets' cell order, padded with ``len(target)``. ``same``: the
    two sets are one, and a row is not its own neighbour."""
    n_t = target.shape[0]
    dev = query.device
    if n_t == 0 or query.shape[0] == 0:
        return torch.full((query.shape[0], 0), n_t, dtype=torch.long,
                          device=dev)
    origin = torch.minimum(query.min(0).values, target.min(0).values)
    gt = _cells(target, origin, radius)
    gq = _cells(query, origin, radius)
    dims = torch.maximum(gt.max(0).values, gq.max(0).values) + 2
    ny, nz = int(dims[1]), int(dims[2])
    n_cells = int(dims[0]) * ny * nz

    def key(g0, g1, g2):
        return (g0 * ny + g1) * nz + g2

    kt = key(gt[:, 0], gt[:, 1], gt[:, 2])
    order = torch.argsort(kt, stable=True)
    count = torch.bincount(kt, minlength=n_cells)
    start = torch.cumsum(count, 0) - count

    offs = torch.tensor([(a, b) for a in (-1, 0, 1) for b in (-1, 0, 1)],
                        device=dev)
    cx = gq[:, 0:1] + offs[:, 0]
    cy = gq[:, 1:2] + offs[:, 1]
    k_lo = key(cx, cy, gq[:, 2:3] - 1)            # [M, 9]
    k_hi = key(cx, cy, gq[:, 2:3] + 1)
    lo = start[k_lo]
    lens = start[k_hi] + count[k_hi] - lo
    total = lens.sum(1)
    r2max = radius * radius

    out, widths = [], []
    m = query.shape[0]
    i0 = 0
    while i0 < m:
        cmax = max(1, int(total[i0:].max()))
        rows = max(1, _CHUNK_ENTRIES // cmax)
        i1 = min(m, i0 + rows)
        c = max(1, int(total[i0:i1].max()))
        ln = lens[i0:i1]
        cum = torch.cumsum(ln, 1)
        p = torch.arange(c, device=dev).expand(i1 - i0, c).contiguous()
        seg = torch.searchsorted(cum, p, right=True).clamp(max=8)
        first = torch.gather(cum - ln, 1, seg)
        srt = torch.gather(lo[i0:i1], 1, seg) + (p - first)
        ok = p < total[i0:i1, None]
        j = order[torch.where(ok, srt, 0)]
        d = query[i0:i1, None, :] - target[j]
        keep = ok & ((d * d).sum(-1) < r2max)
        if same:
            keep &= j != torch.arange(i0, i1, device=dev)[:, None]
        k = int(keep.sum(1).max()) if keep.numel() else 0
        slot = torch.where(keep, torch.cumsum(keep, 1) - 1, k)
        o = torch.full((i1 - i0, k + 1), n_t, dtype=torch.long, device=dev)
        o.scatter_(1, slot, torch.where(keep, j, n_t))
        out.append(o[:, :k])
        widths.append(k)
        i0 = i1
    kmax = max(widths)
    return torch.cat([torch.nn.functional.pad(o, (0, kmax - o.shape[1]),
                                              value=n_t) for o in out])
