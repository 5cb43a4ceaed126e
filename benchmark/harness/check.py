"""The check that decides ``correct``: the frames the window produced,
against the plain reference.

The program's state evolves chaotically (near liquid-elastic contacts one
ulp of the inputs grows to 1e-3 within two steps), so the reference cannot
follow a window from its start: it follows each checked frame from the
state the program started that frame from, for the frame's k steps, and
the first frame of every run starts from the benchmark's own inputs.

What is compared, over each set of rows of a checked frame:

* ``vel_gap``: the 90th percentile of |v_program - v_reference|, in units
  of the frame's gravity kick |g| k dt;
* ``pos_gap``: the 90th percentile of |x_program - x_reference|, in units
  of the smoothing radius h;

first over every moving row, then (``vel_gap.<set>``, ``pos_gap.<set>``)
over the rows that one term acts on, so that a term that moves a few rows
of the scene cannot go wrong unseen: ``elastic``, the rows with springs
(the springs and the muscles); ``wall``, the moving rows within h of a
wall at the frame's start (their pairs with walls, which the wall-compact
engine sums apart, and the boundary correction within r0); ``membrane``,
the liquid rows within r0 of a particle of a triangle (the membrane
projection). A set that a frame does not have gives no number. Besides,
``walls_moved``, the largest displacement of a wall (exactly 0).

The units are fixed for a cell: a gap over the frame's own change swings
a hundredfold from frame to frame with the change, where the gaps
themselves hold steady. Each number is the largest over the checked
frames; ``checks/<cell>.json`` holds the limit of each number the cell
compares.
"""
from __future__ import annotations

import gc

import numpy as np
import torch

from reference import physics
from reference.neighbours import within

QUANTILE = 0.9


def scales(params: dict, k: int) -> tuple:
    """(velocity, position) units of the gaps: the frame's gravity kick
    |g| k dt in m/s, and h in simulation units."""
    g = float(np.linalg.norm(params["gravity"]))
    return g * k * params["time_step"], params["h"]


def gap(a, ref, rows, unit, q=QUANTILE) -> float:
    """The ``q`` quantile over ``rows`` of |a - ref|, in ``unit``."""
    out = float(np.quantile(np.linalg.norm(a[rows] - ref[rows], axis=1), q)
                / unit)
    return out if np.isfinite(out) else np.inf


def _near(x0, rows, cols, radius, device) -> np.ndarray:
    """[N] bool: the ``rows`` with one of ``cols`` within ``radius`` at
    ``x0``."""
    out = np.zeros(len(x0), bool)
    r, c = np.flatnonzero(rows), np.flatnonzero(cols)
    if len(r) and len(c):
        x = torch.as_tensor(x0, device=device)
        nb = within(x[r], x[c], radius)
        out[r[(nb < len(c)).any(1).cpu().numpy()]] = True
    return out


def row_sets(x0, topo_arrays: dict, h: float, device="cpu") -> dict:
    """The rows each number is taken over, at the frame's start positions
    ``x0``: ``""`` every moving row, ``elastic``, ``wall`` and
    ``membrane``."""
    ptype = np.asarray(topo_arrays["ptype"])
    wall = ptype == physics.BOUNDARY
    n = len(ptype)
    elastic = np.zeros(n, bool)
    idx = np.asarray(topo_arrays["spring_idx"])
    if idx.size:
        elastic[np.asarray(topo_arrays["spring_rows"])[
            (idx >= 0).any(1)]] = True
    tri = np.zeros(n, bool)
    tri[np.asarray(topo_arrays["tris"], np.int64).reshape(-1)] = True
    return {"": ~wall, "elastic": elastic,
            "wall": _near(x0, ~wall, wall, h, device),
            "membrane": _near(x0, ptype == physics.LIQUID, tri, 0.5 * h,
                              device)}


def gaps(x0, x1, v1, rx, rv, sets: dict, units) -> dict:
    """The numbers of one frame: its start positions, the program's end and
    the reference's end (host arrays [N, 3]), the rows of
    :func:`row_sets`; ``units`` from :func:`scales`."""
    out = {}
    for name, rows in sets.items():
        if not rows.any():
            continue
        sfx = f".{name}" if name else ""
        out["vel_gap" + sfx] = gap(v1, rv, rows, units[0])
        out["pos_gap" + sfx] = gap(x1, rx, rows, units[1])
    wall = ~sets[""]
    out["walls_moved"] = (float(np.nan_to_num(
        np.abs(x1[wall] - x0[wall]).max(), nan=np.inf)) if wall.any()
        else 0.0)
    return out


def frames_for_check(inputs, first, sample):
    """(start pos, start vel, start step, end pos, end vel) host arrays of
    each checked frame: the first frame from the inputs, then the sample."""
    out = [(inputs[0], inputs[1], 0, first.pos, first.end.vel.cpu().numpy())]
    for f in sample:
        out.append((f.start.pos.cpu().numpy(), f.start.vel.cpu().numpy(),
                    int(f.start.step), f.pos, f.end.vel.cpu().numpy()))
    return out


def judge(frames, k: int, topo_arrays: dict, params: dict, device) -> dict:
    """The largest of each number over ``frames``, each frame followed by
    the reference for its ``k`` steps from its start; a frame that starts
    non-finite reads infinite on every number."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    topo = physics.Topology.of(topo_arrays, device)
    c = physics.derived(params)
    units = scales(params, k)
    worst, broken = {}, False
    with torch.no_grad():
        for x0, v0, s0, x1, v1 in frames:
            if not (np.isfinite(x0).all() and np.isfinite(v0).all()):
                broken = True
                continue
            rx, rv = physics.run(torch.as_tensor(x0, device=device),
                                 torch.as_tensor(v0, device=device), s0, k,
                                 topo, c)
            g = gaps(x0, x1, v1, rx.cpu().numpy(), rv.cpu().numpy(),
                     row_sets(x0, topo_arrays, params["h"], device), units)
            for n, v in g.items():
                worst[n] = max(worst.get(n, 0.0), v)
    if broken:
        worst = dict.fromkeys(set(worst) | {"vel_gap"}, np.inf)
    return worst


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number has a limit and is within it (a limit of 0 asks for
    exactly 0). A limit whose rows no checked frame had (no row within r0
    of a wall yet, say) has nothing to compare."""
    return all(n in limits and v <= limits[n] for n, v in numbers.items())
