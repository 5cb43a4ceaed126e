"""The plain reference: one PCISPH step of the OpenWorm Electrofluid physics
in plain PyTorch, over every pair within reach.

It is the semantics the program's fast and wall-compact engines compute,
written from the physics and not from their code: positions in simulation
units, velocities in scaled SI; the time-t density of every particle (walls
included) from every other particle within h; viscosity (a wall's normal
standing in for its velocity) and surface tension; Hooke springs with the
muscle wave's contraction; three PCISPH prediction-correction iterations
(predicted density from positions moved by the pressure acceleration alone,
pressure accumulated on every particle, the spiky pressure force at the
time-t positions with its close-range repulsion inside h/4); leapfrog
integration clamped to the box; the Ihmsen boundary correction with
friction; the liquid-membrane projection; walls pinned. The neighbours are
found anew every step from the positions, whatever any resort would keep.

``pair_dtype`` sets the precision of the per-pair arithmetic (distances,
kernel terms, weights) after the f32 differences of positions; every sum,
every per-particle field and the integration stay f32. The reference runs
it at f32; the control of the check runs it at bfloat16. ``off`` names
terms left out (:data:`TERMS`): the faults that the check must reject,
planted in the reference put in the program's place.

Imports nothing of the program.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .neighbours import within

LIQUID, BOUNDARY = 1, 3
MUSCLES, ACTIVE_MUSCLES = 100, 96
TRIS_PER_PARTICLE = 7
# the pair list is searched at h (1 + MARGIN) at the time-t positions, so
# that it holds every pair within h of positions that no row left by more
# than MARGIN h / 2
MARGIN = 0.1
FAR = 1.0e6
# the terms a fault can leave out: the springs with their muscles, the
# muscles' activation alone, the moving rows' pairs with walls, the
# boundary correction, the membranes
TERMS = ("springs", "muscles", "walls", "boundary", "membranes")


def derived(p: dict) -> dict:
    """The physics' constants (float64) from the configuration's ``params``:
    owPhysicsConstant.h's definitions, the PCISPH delta by the reference's
    prototype neighbourhood (owPhysicsFluidSimulator.cpp:164-203)."""
    scale = 0.004 * p["mass"] ** (1 / 3) / 0.00025 ** (1 / 3)
    h = p["h"]
    h_s = h * scale
    w_poly6 = 315.0 / (64.0 * math.pi * h_s ** 9)
    grad_spiky = -45.0 / (math.pi * h_s ** 6)
    beta = p["time_step"] ** 2 * p["mass"] ** 2 * 2.0 / p["rho0"] ** 2
    radius = (p["mass"] / p["rho0"]) ** (1 / 3)
    xs = [1, 1, 0, -1, -1, -1, 0, 1, 1, 1, 0, -1, -1, -1, 0, 1,
          1, 1, 0, -1, -1, -1, 0, 1, 2, -2, 0, 0, 0, 0, 0, 0]
    ys = [0, 1, 1, 1, 0, -1, -1, -1, 0, 1, 1, 1, 0, -1, -1, -1,
          0, 1, 1, 1, 0, -1, -1, -1, 0, 0, 2, -2, 0, 0, 0, 0]
    zs = [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1,
          -1, -1, -1, -1, -1, -1, -1, -1, 0, 0, 0, 0, 2, -2, 1, -1]
    s1 = [0.0, 0.0, 0.0]
    s2 = 0.0
    for c in zip(xs, ys, zs):
        v = [k * 0.8 * radius for k in c]
        dist = math.sqrt(sum(k * k for k in v))
        if dist <= h_s:
            w = (h_s - dist) ** 2
            s1 = [a + w * k / dist for a, k in zip(s1, v)]
            s2 += w * w
    delta = 1.0 / (beta * grad_spiky ** 2 * (sum(a * a for a in s1) + s2))
    return dict(
        h=h, r0=0.5 * h, scale=scale, rho0=p["rho0"], delta=delta,
        dt=p["time_step"], pos_dt=p["time_step"] / scale,
        c_rho=p["mass"] * w_poly6 * h_s ** 6,
        c_visc=p["mass"] * p["viscosity"] * 45.0 / (math.pi * h_s ** 5),
        c_surf=(p["surface_tension_gain"] * w_poly6 * (h_s ** 2 / 2.0) ** 3
                * scale),
        c_press=p["mass"] * 45.0 / (math.pi * h_s ** 4),
        k_spring=p["k_spring"], muscle_force=p["muscle_force"],
        gravity=tuple(p["gravity"]),
        lo=tuple(p[k] for k in ("x_min", "y_min", "z_min")),
        hi=tuple(p[k] - 1e-6 for k in ("x_max", "y_max", "z_max")),
        iters=int(p["n_pcisph_iters"]),
    )


def f32(x: float) -> float:
    return float(np.float32(x))


@dataclasses.dataclass
class Topology:
    """What never changes in a run: types, wall normals, the spring graph
    (row ids, partner ids with -1 pads, rest lengths in metres, muscle ids)
    and the membranes (triangles, each elastic particle's first seven)."""

    ptype: torch.Tensor          # [N] int
    normal: torch.Tensor         # [N, 3] f32
    spring_rows: torch.Tensor    # [Ne] long
    spring_idx: torch.Tensor     # [Ne, S] long, -1 pad
    spring_rest: torch.Tensor    # [Ne, S] f32
    spring_muscle: torch.Tensor  # [Ne, S] long
    tris: torch.Tensor           # [M, 3] long
    particle_tris: torch.Tensor  # [N, 7] long, -1 pad
    muscle_model: bool

    @staticmethod
    def of(scene: dict, device) -> "Topology":
        """From host arrays: ``ptype``, ``normal``, ``spring_rows``,
        ``spring_idx``, ``spring_rest``, ``spring_type`` (the scene
        format's codes: the integer part is the muscle id), ``tris`` and
        ``muscle_model``."""
        def t(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=device)
        n = len(scene["ptype"])
        tris = np.asarray(scene["tris"], np.int64).reshape(-1, 3)
        check_symmetric(scene)
        return Topology(
            ptype=t(scene["ptype"], torch.int64),
            normal=t(scene["normal"], torch.float32),
            spring_rows=t(scene["spring_rows"], torch.int64),
            spring_idx=t(scene["spring_idx"], torch.int64),
            spring_rest=t(scene["spring_rest"], torch.float32),
            spring_muscle=t(np.asarray(scene["spring_type"]).astype(
                np.int64), torch.int64),
            tris=t(tris, torch.int64),
            particle_tris=t(first_tris(tris, n), torch.int64),
            muscle_model=bool(scene["muscle_model"]))


def check_symmetric(scene: dict) -> None:
    """Raise unless every spring entry (row, partner, rest, muscle) has its
    reverse: the step sums each row's own entries, which is the physics
    of a graph whose springs act on both their ends alike."""
    rows = np.asarray(scene["spring_rows"], np.int64)
    idx = np.asarray(scene["spring_idx"], np.int64)
    used = idx >= 0
    a = np.repeat(rows, idx.shape[1])[used.ravel()]
    b = idx[used]
    rest = np.asarray(scene["spring_rest"], np.float32)[used]
    mus = np.asarray(scene["spring_type"]).astype(np.int64)[used]
    fwd = np.lexsort((mus, rest, b, a))
    rev = np.lexsort((mus, rest, a, b))
    same = (np.array_equal(a[fwd], b[rev]) and np.array_equal(b[fwd], a[rev])
            and np.array_equal(rest[fwd], rest[rev])
            and np.array_equal(mus[fwd], mus[rev]))
    if not same:
        raise ValueError("the spring graph is not symmetric")


def first_tris(tris: np.ndarray, n: int) -> np.ndarray:
    """[n, 7] each particle's triangles in triangle order, the first seven
    kept (the scene format's per-particle membrane table), -1 pad."""
    out = np.full((n, TRIS_PER_PARTICLE), -1, np.int64)
    if len(tris) == 0:
        return out
    vert = tris.reshape(-1)
    tri = np.repeat(np.arange(len(tris)), 3)
    order = np.argsort(vert, kind="stable")
    vert, tri = vert[order], tri[order]
    first = np.searchsorted(vert, vert, side="left")
    rank = np.arange(len(vert)) - first
    keep = rank < TRIS_PER_PARTICLE
    out[vert[keep], rank[keep]] = tri[keep]
    return out


def muscle_wave(t: float, device) -> torch.Tensor:
    """The activation [100] emitted after step t (two travelling sine
    waves over 12 body rows, phase-shifted by pi, in [0, 1]; each row's
    value for its left and right muscle; quadrants MDR, MVR, MVL, MDL)."""
    row = torch.as_tensor(np.linspace(0.0, 1.5 * 2 * math.pi, 12,
                                      dtype=np.float32), device=device)
    phase = f32(1e-4) * torch.tensor(float(t), dtype=torch.float32,
                                     device=device)
    w1 = (torch.sin(row - phase) + 1.0) * 0.5
    w2 = (torch.sin(row + f32(math.pi) - phase) + 1.0) * 0.5
    d1, d2 = w1.repeat_interleave(2), w2.repeat_interleave(2)
    return torch.cat([d1, d2, d2, d1,
                      d1.new_zeros(MUSCLES - ACTIVE_MUSCLES)])


def activation_at(step: int, topo: Topology, device) -> torch.Tensor:
    """The activation step ``step`` runs with: that emitted after the step
    before, none at step 0 or without the muscle model."""
    if not topo.muscle_model or step == 0:
        return torch.zeros(MUSCLES, dtype=torch.float32, device=device)
    return muscle_wave(step - 1, device)


def _to(t: torch.Tensor, pd) -> torch.Tensor:
    """``t`` in the precision of the per-pair arithmetic."""
    return t.to(pd)


def _padded(a: torch.Tensor, fill: float) -> torch.Tensor:
    """``a`` with one more row of ``fill``: the row the pad id reads."""
    return torch.cat([a, a.new_full((1,) + a.shape[1:], fill)])


def step(pos: torch.Tensor, vel: torch.Tensor, step_no: int,
         topo: Topology, c: dict, pair_dtype=torch.float32, off=()):
    """(pos, vel) after one step from ``pos``, ``vel`` at step ``step_no``
    (both [N, 3] f32 on one device), without the terms named in ``off``."""
    dev = pos.device
    pd = pair_dtype
    n = pos.shape[0]
    wall = topo.ptype == BOUNDARY
    moving = ~wall
    liquid = topo.ptype == LIQUID
    h, r0 = f32(c["h"]), f32(c["r0"])
    h2 = f32(h * h)
    inv_h, inv_h6 = f32(1.0 / c["h"]), f32(1.0 / c["h"] ** 6)
    dt, pos_dt = f32(c["dt"]), f32(c["pos_dt"])
    c_rho, rho0 = f32(c["c_rho"]), f32(c["rho0"])
    delta, rho0_delta = f32(c["delta"]), f32(c["rho0"] * c["delta"])

    def P(t):
        return _to(t, pd)

    def S(t):
        return t.float().sum(1)

    if "walls" in off:
        wall_col = _padded(wall, False)

        def search(x, radius):
            nb = within(x, x, radius, same=True)
            return torch.where(moving[:, None] & wall_col[nb], n, nb)
    else:
        def search(x, radius):
            return within(x, x, radius, same=True)

    nbr = search(pos, h * (1.0 + MARGIN))                  # [N, K]
    xp = _padded(pos, FAR)
    d = [pos[:, k:k + 1] - xp[:, k][nbr] for k in range(3)]  # x_i - x_j
    dp = [P(a) for a in d]
    r2 = dp[0] * dp[0] + dp[1] * dp[1] + dp[2] * dp[2]
    r = torch.sqrt(r2)

    def density(r2_):
        t = torch.clamp(h2 - r2_, min=0.0)
        return c_rho * torch.clamp(S(t * t * t) * inv_h6, min=1.0)

    rho = density(r2)
    irho = 1.0 / rho

    # viscosity and surface tension (walls lend their normal as velocity)
    vj = _padded(torch.where(wall[:, None], topo.normal, vel), 0.0)
    wv = torch.clamp(h - r, min=0.0) * P(_padded(irho, 0.0)[nbr])
    near = (r2 < h2).to(pd)
    g = c["gravity"]
    a_ext = torch.stack([
        f32(c["c_visc"]) * S(wv * P(vj[:, k][nbr] - vel[:, k:k + 1]))
        * inv_h * irho + f32(c["c_surf"]) * S(near * dp[k]) + f32(g[k])
        for k in range(3)], 1)
    if "springs" not in off:
        a_ext = a_ext + springs(pos, step_no, topo, c, pd,
                                muscles="muscles" not in off)
    a_ext = torch.where(moving[:, None], a_ext, 0.0)

    # PCISPH prediction-correction
    press = torch.zeros(n, dtype=torch.float32, device=dev)
    a_p = torch.zeros_like(pos)
    h4 = f32(h / 4.0)
    out_c = f32(0.5 * inv_h * inv_h)
    reach = MARGIN * h / 2 / math.sqrt(3.0)
    for _ in range(c["iters"]):
        xs = torch.where(moving[:, None], pos + pos_dt * (vel + dt * a_p),
                         pos)
        # the time-t list holds every pair within h of the predicted
        # positions unless a row moved by more than the margin: then search
        # them anew
        far = float((xs - pos).abs().amax()) >= reach
        nbs = search(xs, h) if far else nbr
        xsp = _padded(xs, FAR)
        ds = [P(xs[:, k:k + 1] - xsp[:, k][nbs]) for k in range(3)]
        rho_s = density(ds[0] * ds[0] + ds[1] * ds[1] + ds[2] * ds[2])
        press = press + torch.clamp((rho_s - rho0) * delta, min=0.0)
        irs = P(_padded(1.0 / torch.clamp(rho_s, min=1.0), 0.0)[nbr])
        pp = P(press[:, None] + _padded(press, 0.0)[nbr])
        cm = h4 - r
        t = torch.clamp(h - r, min=0.0)
        term = torch.where(cm > 0, cm * cm * rho0_delta, t * t * pp) * irs
        w = torch.where(r2 > 0, term / torch.where(r2 > 0, r, 1.0), 0.0)
        f = torch.stack([S(w * dp[k]) for k in range(3)], 1) * out_c
        a_p = torch.where(moving[:, None],
                          f32(c["c_press"]) / rho_s[:, None] * f, 0.0)

    # integration
    v_new = vel + dt * (a_ext + a_p)
    lo = torch.tensor([f32(x) for x in c["lo"]], device=dev)
    hi = torch.tensor([f32(x) for x in c["hi"]], device=dev)
    x_new = torch.clamp(pos + pos_dt * v_new, lo, hi)
    v_avg = (vel + v_new) * 0.5
    x_b = x_new
    if "boundary" not in off:
        x_b, v_avg = boundary(x_new, v_avg, pos, moving, wall, topo, r0, pd)
    if "membranes" not in off:
        x_b = membranes(x_new, x_b, liquid, topo, r0, pd)
    x_out = torch.where(wall[:, None], pos, x_b)
    v_out = torch.where(wall[:, None], vel, v_avg)
    return x_out, v_out


def springs(pos, step_no, topo: Topology, c: dict, pd,
            muscles: bool = True) -> torch.Tensor:
    """[N, 3] Hooke and (with ``muscles``) muscle accelerations of the
    spring rows."""
    out = torch.zeros_like(pos)
    if topo.spring_rows.numel() == 0:
        return out
    act = activation_at(step_no, topo, pos.device)
    if not muscles:
        act = torch.zeros_like(act)
    mid = topo.spring_muscle
    known = (mid >= 1) & (mid <= MUSCLES)
    actf = torch.cat([act.new_zeros(1), act * f32(c["muscle_force"])])[
        torch.where(known, mid, 0)]
    used = topo.spring_idx >= 0
    d = pos[topo.spring_rows][:, None, :] - pos[topo.spring_idx.clamp(min=0)]
    d = d.to(pd)
    r = torch.sqrt((d * d).sum(-1))
    ok = used & (r > 0)
    coef = (-(r * f32(c["scale"]) - topo.spring_rest.to(pd))
            * f32(c["k_spring"]) - actf.to(pd))
    w = torch.where(ok, coef / torch.where(ok, r, 1.0), 0.0)
    acc = (w[..., None] * d).float().sum(1)
    return out.index_add(0, topo.spring_rows, acc)


def boundary(x_new, v_avg, pos, moving, wall, topo: Topology, r0, pd):
    """The Ihmsen correction of the moving rows by the walls within r0 of
    their new positions, with friction on the approaching velocity."""
    rows = torch.nonzero(moving).squeeze(1)
    walls = torch.nonzero(wall).squeeze(1)
    if walls.numel() == 0:
        return x_new, v_avg
    q = x_new[rows]
    nb = within(q, pos[walls], r0)                          # [R, K]
    wp = _padded(pos[walls], FAR)
    wn = _padded(topo.normal[walls], 0.0)
    dd = [_to(q[:, k:k + 1] - wp[:, k][nb], pd) for k in range(3)]
    dist = torch.sqrt(dd[0] * dd[0] + dd[1] * dd[1] + dd[2] * dd[2])
    w = torch.clamp((r0 - dist) * f32(1.0 / r0), min=0.0)
    nc = torch.stack([(w * wn[:, k][nb].to(pd)).float().sum(1)
                      for k in range(3)], 1)
    ws = w.float().sum(1)
    w2 = (w * (r0 - dist)).float().sum(1)
    nl2 = (nc * nc).sum(1)
    has = nl2 > 0
    coef = torch.where(has, torch.rsqrt(torch.clamp(nl2, min=1e-30))
                       * w2 / torch.clamp(ws, min=1e-30), 0.0)
    va = v_avg[rows]
    vdot = (nc * va).sum(1)
    fric = (has & (vdot < 0))[:, None]
    va = torch.where(fric, (va - nc * vdot[:, None]) * 0.99, va)
    x_b = x_new.clone()
    x_b[rows] = q + nc * coef[:, None]
    v_out = v_avg.clone()
    v_out[rows] = va
    return x_b, v_out


def membranes(x_own, x_b, liquid, topo: Topology, r0, pd):
    """The projection of the liquid rows out of the membranes: each liquid
    row at its position before the boundary correction (``x_own``) against
    the elastic particles within r0 of their corrected positions (``x_b``),
    each with its triangles' planes through their corrected vertices."""
    if topo.tris.numel() == 0:
        return x_b
    has_tri = (topo.particle_tris >= 0).any(1)
    cols = torch.nonzero(has_tri).squeeze(1)
    rows = torch.nonzero(liquid).squeeze(1)
    tv = x_b[topo.tris]                                      # [M, 3, 3]
    tn = torch.linalg.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])
    tl2 = (tn * tn).sum(1, keepdim=True)
    tn = tn * torch.where(tl2 > 0, torch.rsqrt(torch.clamp(tl2, min=1e-30)),
                          0.0)
    pt = topo.particle_tris[cols]                            # [C, 7]
    ok = (pt >= 0)[..., None]
    tri_n = _padded(torch.where(ok, tn[pt.clamp(min=0)], 0.0), 0.0)
    tri_a = _padded(torch.where(ok, tv[pt.clamp(min=0), 0], 0.0), 0.0)
    q = x_own[rows]
    nb = within(q, x_b[cols], r0)                            # [R, K]
    keep = (nb < cols.numel()).any(1)
    rows, q, nb = rows[keep], q[keep], nb[keep]
    if rows.numel() == 0:
        return x_b
    n_t, a_t = tri_n[nb], tri_a[nb]                          # [R, K, 7, 3]
    side = (_to(q[:, None, None, :] - a_t, pd) * _to(n_t, pd)).sum(-1)
    on = ((n_t * n_t).sum(-1) > 0) & (side != 0)
    sgn = torch.where(on, torch.sign(side), 0.0)
    cnt = sgn.abs().sum(-1)
    v = (sgn[..., None] * n_t).sum(-2)                       # [R, K, 3]
    cp = _padded(x_b[cols], FAR)
    dd = [_to(q[:, k:k + 1] - cp[:, k][nb], pd) for k in range(3)]
    dist = torch.sqrt(dd[0] * dd[0] + dd[1] * dd[1] + dd[2] * dd[2])
    w = torch.where(cnt > 0, torch.clamp((r0 - dist) / r0, min=0.0), 0.0)
    wc = (w / torch.clamp(cnt, min=1.0).to(pd))
    m = torch.stack([(wc * v[..., k].to(pd)).float().sum(1)
                     for k in range(3)], 1)
    ms = w.float().sum(1)
    m2 = (w * (r0 - dist)).float().sum(1)
    ml2 = (m * m).sum(1)
    coef = torch.where(ml2 > 0, torch.rsqrt(torch.clamp(ml2, min=1e-30))
                       * m2 / torch.clamp(ms, min=1e-30), 0.0)
    out = x_b.clone()
    out[rows] = x_b[rows] + m * coef[:, None]
    return out


def run(pos, vel, step_no: int, n_steps: int, topo: Topology, c: dict,
        pair_dtype=torch.float32, off=()):
    """(pos, vel) after ``n_steps`` steps."""
    unknown = set(off) - set(TERMS)
    if unknown:
        raise ValueError(f"no term {sorted(unknown)}")
    for k in range(n_steps):
        pos, vel = step(pos, vel, step_no + k, topo, c, pair_dtype, off)
    return pos, vel
