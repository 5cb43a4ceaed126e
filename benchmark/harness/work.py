"""The pair work a step needs, counted from positions, and its roofline
bound on the card.

The pairs are those within each pass kind's reach at the given positions,
each pair once, whatever tiles, blocks or engine an implementation uses:

* ``fluid``: unordered pairs within h, walls with walls left out (they
  never move, so their sums can be kept). A step runs on them the time-t
  density once, the predicted density and the pressure force once for
  each PCISPH iteration, and viscosity with surface tension once;
* ``boundary``: (moving particle, wall) pairs within r0, once a step;
* ``membrane``: (liquid particle, elastic particle with a triangle) pairs
  within r0, once a step;
* ``spring``: the spring graph's entries, once a step.

The f32 operations of one pair are the hand counts of the port's CUDA
functors (``pair_pass.cu``): the distance with its exit test plus the
body. Bytes count each input a pass reads once and each output it writes
once. A pass is bound by the larger of its operations over the card's f32
rate and its bytes over its memory rate (``data/peaks.json``).
"""
from __future__ import annotations

import torch

from reference.neighbours import within

LIQUID, BOUNDARY = 1, 3
# f32 operations a pair within reach, and the per-row fields (4 bytes
# each) a pass reads and writes: (ops, passes a step, fields in a row,
# fields out a row)
PASSES = {
    "density": (13, 1, 3, 1),
    "rho_star": (13, 3, 3, 1),
    "viscsurf": (9 + 17, 1, 7, 6),
    "paccel": (17 + 12, 3, 5, 3),
    "boundary": (9 + 14, 1, 3, 5),
    "membrane": (9 + 3 + 7 * 24 + 12, 1, 3, 5),
    "spring": (3 + 28, 1, 3, 3),
}
FLUID = ("density", "rho_star", "viscsurf", "paccel")
# a wall: position and normal; a membrane column: its position and seven
# triangles (normal, vertex); a spring entry: partner id, rest length,
# activation term
WALL_COL_FIELDS = 6
MEMBRANE_COL_FIELDS = 3 + 7 * 6
SPRING_ENTRY_FIELDS = 3


def in_triangles(tris, n: int, device) -> torch.Tensor:
    """[n] bool: the particles that are a vertex of one of the scene's
    triangles ``tris`` ([M, 3] ids)."""
    has = torch.zeros(n, dtype=torch.bool, device=device)
    has[torch.as_tensor(tris, device=device).long().reshape(-1)] = True
    return has


def count(pos: torch.Tensor, ptype: torch.Tensor, spring_idx: torch.Tensor,
          has_tri: torch.Tensor, h: float) -> dict:
    """Pairs within reach at ``pos``, and the rows and columns that take
    part, from the scene's own arrays: ``ptype``, ``spring_idx`` (the
    scene's [rows, S] partner ids, -1 pad) and ``has_tri`` ([N] bool, the
    particles with a triangle, :func:`in_triangles`)."""
    n = pos.shape[0]
    wall = ptype == BOUNDARY
    r0 = 0.5 * h
    nb = within(pos, pos, h, same=True)
    real = nb < n
    j = nb.clamp(max=n - 1)
    fluid = real & ~(wall[:, None] & wall[j])
    fluid_rows = int(fluid.any(1).sum())
    moving = torch.nonzero(~wall).squeeze(1)
    walls = torch.nonzero(wall).squeeze(1)
    nbw = within(pos[moving], pos[walls], r0)
    bnd = nbw < walls.numel()
    liq = torch.nonzero(ptype == LIQUID).squeeze(1)
    cols = torch.nonzero(has_tri).squeeze(1)
    nbm = within(pos[liq], pos[cols], r0)
    mem = nbm < cols.numel()
    springs = spring_idx >= 0
    return dict(
        fluid=int(fluid.sum()) // 2, fluid_rows=fluid_rows,
        moving_rows=int(moving.numel()),
        boundary=int(bnd.sum()), boundary_rows=int(bnd.any(1).sum()),
        boundary_cols=int(torch.unique(nbw[bnd]).numel()),
        membrane=int(mem.sum()), membrane_rows=int(mem.any(1).sum()),
        membrane_cols=int(torch.unique(nbm[mem]).numel()),
        spring=int(springs.sum()), spring_rows=int(springs.any(1).sum()))


def bound_s(work: dict, peaks: dict) -> dict:
    """Seconds a step of each pass kind needs at the card's peaks."""
    pairs = {k: work["fluid"] for k in FLUID}
    pairs.update(boundary=work["boundary"], membrane=work["membrane"],
                 spring=work["spring"])
    rows_in = {k: work["fluid_rows"] for k in FLUID}
    rows_in.update(boundary=work["boundary_rows"],
                   membrane=work["membrane_rows"],
                   spring=work["spring_rows"])
    rows_out = {k: work["fluid_rows"] for k in ("density", "rho_star")}
    rows_out.update(viscsurf=work["moving_rows"],
                    paccel=work["moving_rows"], boundary=rows_in["boundary"],
                    membrane=rows_in["membrane"], spring=rows_in["spring"])
    out = {}
    for kind, (ops, passes, f_in, f_out) in PASSES.items():
        fields = rows_in[kind] * f_in + rows_out[kind] * f_out
        if kind == "boundary":
            fields += work["boundary_cols"] * WALL_COL_FIELDS
        if kind == "membrane":
            fields += work["membrane_cols"] * MEMBRANE_COL_FIELDS
        if kind == "spring":
            fields += work["spring"] * SPRING_ENTRY_FIELDS
        t_ops = pairs[kind] * ops / peaks["f32_flops"]
        t_bytes = 4 * fields / peaks["bytes_s"]
        out[kind] = passes * max(t_ops, t_bytes)
    return out
