"""PCISPH solver core of the exact engine (counterpart of
``sph_tpu/core/pcisph.py``): density, external forces, the
prediction-correction loop, boundary handling and integration on the
``[N, 32]`` neighbour lists of ``core/neighbors.py``.

Per-kernel citations of the reference:

* density           — `sphFluid.cl:472-518`
* ext forces        — `sphFluid.cl:589-708` (viscosity, gravity, surf. tension)
* predict positions — `sphFluid.cl:889-979`
* predict density   — `sphFluid.cl:982-1059`
* correct pressure  — `sphFluid.cl:1062-1098`
* pressure force    — `sphFluid.cl:1101-1212` (incl. close-range anti-clump)
* boundary response — `sphFluid.cl:824-887` (Ihmsen et al. 2010)
* integrate         — `sphFluid.cl:1684-1808`

Vectors are ``[..., 3]`` tensors (``sph_tpu`` splits them into three planes
for the TPU's tiling; the per-component f32 arithmetic is the same). Each
constant is rounded to f32 once, as ``jnp.float32(...)`` rounds it.

Local/global split, kept for multi-device runs: each function computes
outputs for a *local* row set while neighbour gathers read *global*
tensors; quantities that evolve inside the PCISPH loop are re-globalised
through a ``gather`` callable (identity on one device). Single-device
callers pass the same tensor for local and global and ``gather=None``.

Reference quirks preserved deliberately (they shape the dynamics):
* Position prediction integrates **only** the pressure acceleration
  (sphFluid.cl:924).
* Pressure is corrected for *all* particles including boundary ones
  (the skip at sphFluid.cl:1084-1086 is commented out).
* For boundary neighbours the "velocity" entering the viscosity sum is the
  stored wall normal (sphFluid.cl:653 reading what :860 calls normals).
* Integration writes back the *average* of old and new velocity
  (sphFluid.cl:1759) after computing the position from the full new one.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..config import SimParams
from ..constants import BOUNDARY_PARTICLE
from ..ops.smoothing import poly6_term, spiky_term, visc_term
from .neighbors import NeighborList

GatherFn = Callable


def _f32(x) -> float:
    return float(np.float32(x))


def _identity_gather(x):
    return x


def norm2(v: torch.Tensor) -> torch.Tensor:
    """x*x + y*y + z*z of [..., 3], summed in that order."""
    return v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2]


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _zero_where_not(cond: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``v`` [..., 3] with rows where ``cond`` is False set to 0."""
    return torch.where(cond[..., None], v, 0.0)


def compute_density(nbrs: NeighborList, params: SimParams) -> torch.Tensor:
    """rho_i = c_rho * max(1, sum_j (1 - q^2)^3).

    The max(1, .) clamp is the reference's `density < hScaled6 -> hScaled6`
    (sphFluid.cl:514) in nondimensional form; 1 is exactly the missing
    self-contribution term."""
    q2 = nbrs.q * nbrs.q
    s = torch.where(nbrs.valid, poly6_term(q2), 0.0).sum(dim=1)
    return _f32(params.c_rho) * torch.clamp(s, min=1.0)


def compute_external_forces(
    pos_l: torch.Tensor,
    vel_l: torch.Tensor,
    rho_l: torch.Tensor,
    ptype_l: torch.Tensor,
    nbrs: NeighborList,
    params: SimParams,
    pos_g: torch.Tensor | None = None,
    vel_g: torch.Tensor | None = None,
    rho_g: torch.Tensor | None = None,
    ptype_g: torch.Tensor | None = None,
    normal_g: torch.Tensor | None = None,
) -> torch.Tensor:
    """Viscosity + gravity + surface tension -> a_ext [n_local, 3].

    Boundary particles get zero (they never move, sphFluid.cl:616-622).
    ``normal_g`` must be given (boundary normals of all particles)."""
    pos_g = pos_l if pos_g is None else pos_g
    vel_g = vel_l if vel_g is None else vel_g
    rho_g = rho_l if rho_g is None else rho_g
    ptype_g = ptype_l if ptype_g is None else ptype_g

    j = torch.clamp(nbrs.idx, min=0)
    mask = nbrs.valid & (nbrs.q < 1.0)

    # Boundary particles' "velocity" is their wall normal (see module doc).
    is_b_j = ptype_g[j] == BOUNDARY_PARTICLE
    vel_j = torch.where(is_b_j[..., None], normal_g[j], vel_g[j])

    w_v = torch.where(mask, visc_term(nbrs.q) / rho_g[j], 0.0)
    visc = ((vel_j - vel_l[:, None, :]) * w_v[..., None]).sum(dim=1)
    a = visc * (_f32(params.c_visc) / rho_l)[:, None]

    st = _zero_where_not(mask, pos_l[:, None, :] - pos_g[j]).sum(dim=1)
    a = a + st * _f32(params.c_surf)
    a = a + torch.tensor([_f32(g) for g in params.gravity],
                         dtype=torch.float32, device=a.device)
    return _zero_where_not(ptype_l != BOUNDARY_PARTICLE, a)


class PcisphResult(NamedTuple):
    pressure: torch.Tensor  # [n_local]
    a_p: torch.Tensor       # pressure-force acceleration [n_local, 3]


def pcisph_pressure_loop(
    pos_l: torch.Tensor,
    vel_l: torch.Tensor,
    ptype_l: torch.Tensor,
    nbrs: NeighborList,
    params: SimParams,
    pos_g: torch.Tensor | None = None,
    gather: GatherFn | None = None,
) -> PcisphResult:
    """The fixed ``n_pcisph_iters`` prediction-correction loop
    (`owPhysicsFluidSimulator.cpp:99-106`), a loop of device ops.

    ``gather`` re-globalises per-iteration local tensors (predicted
    positions, predicted densities, pressures) for neighbour reads."""
    pos_g = pos_l if pos_g is None else pos_g
    gather = _identity_gather if gather is None else gather

    j = torch.clamp(nbrs.idx, min=0)
    mask = nbrs.valid
    mask_h = mask & (nbrs.q < 1.0)
    not_b = ptype_l != BOUNDARY_PARTICLE

    dt = _f32(params.time_step)
    pos_dt = _f32(params.time_step * params.simulation_scale_inv)
    inv_h2 = _f32(1.0 / (params.h * params.h))
    c_rho = _f32(params.c_rho)
    rho0 = _f32(params.rho0)
    delta = _f32(params.delta)
    c_press = _f32(params.c_press)
    rho0_delta = float(np.float32(rho0) * np.float32(delta))

    # Unit vectors i->j and the anti-clump branch depend only on the
    # step-start geometry (the reference uses cached neighbour distances,
    # sphFluid.cl:1156), so they are hoisted out of the loop.
    inv_r = 1.0 / (torch.clamp(nbrs.q, min=1e-30) * _f32(params.h))
    unit_ij = (pos_l[:, None, :] - pos_g[j]) * inv_r[..., None]
    nonzero_r = nbrs.q > 0.0

    # Close-range anti-clump substitution (sphFluid.cl:1166-1170):
    # below q = 0.25 the pair term swaps to a rho0*delta-driven repulsion.
    close = nbrs.q < 0.25
    t_close = 0.25 - nbrs.q
    term_close = t_close * t_close * 0.5 * rho0_delta
    term_far_geom = spiky_term(nbrs.q) * 0.5

    p = torch.zeros_like(pos_l[:, 0])
    a_p = torch.zeros_like(pos_l)
    for _ in range(params.n_pcisph_iters):
        # -- predict positions (boundary stays put) --
        x_star = pos_l + (vel_l + a_p * dt) * pos_dt
        x_star = torch.where(not_b[:, None], x_star, pos_l)
        x_star_g = gather(x_star)

        # -- predicted density from predicted positions --
        q2s = norm2(x_star[:, None, :] - x_star_g[j]) * inv_h2
        contrib = torch.where(mask & (q2s < 1.0), poly6_term(q2s), 0.0)
        rho_star = c_rho * torch.clamp(contrib.sum(dim=1), min=1.0)
        rho_star_g = gather(rho_star)

        # -- pressure correction: all particles, non-negative increment --
        p = p + torch.clamp((rho_star - rho0) * delta, min=0.0)
        p_g = gather(p)

        # -- pressure-force acceleration --
        term = torch.where(close, term_close,
                           term_far_geom * (p[:, None] + p_g[j]))
        term = term / rho_star_g[j]
        w = torch.where(mask_h & nonzero_r, term, 0.0)
        f = (unit_ij * w[..., None]).sum(dim=1)
        a_p = _zero_where_not(not_b, f * (c_press / rho_star)[:, None])
    return PcisphResult(pressure=p, a_p=a_p)


def boundary_response(
    x_new: torch.Tensor,
    v_new: torch.Tensor,
    ptype_g: torch.Tensor,
    normal_g: torch.Tensor,
    pos0_g: torch.Tensor,
    nbrs: NeighborList,
    params: SimParams,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Ihmsen et al. 2010 frozen-particle position projection + friction
    (sphFluid.cl:824-887). Distances in sim units against the *static*
    boundary positions; r0 = h/2."""
    j = torch.clamp(nbrs.idx, min=0)
    r0 = _f32(params.r0)
    is_b_j = (ptype_g[j] == BOUNDARY_PARTICLE) & nbrs.valid

    dist = torch.sqrt(norm2(x_new[:, None, :] - pos0_g[j]))
    w = torch.where(is_b_j, torch.clamp((r0 - dist) / r0, min=0.0), 0.0)
    n_ci = (normal_g[j] * w[..., None]).sum(dim=1)
    w_sum = w.sum(dim=1)
    w2_sum = (w * (r0 - dist) * is_b_j).sum(dim=1)

    n_len2 = norm2(n_ci)
    has = n_len2 > 0.0
    inv_len = torch.rsqrt(torch.clamp(n_len2, min=1e-30))
    coef = inv_len * w2_sum / torch.clamp(w_sum, min=1e-30)
    x_out = torch.where(has[:, None], x_new + n_ci * coef[:, None], x_new)

    # Tangential friction: the projection uses the *unnormalised* n_ci,
    # exactly as the reference does (sphFluid.cl:878-884).
    vn = dot(n_ci, v_new)
    fric = has & (vn < 0.0)
    v_fric = (v_new - n_ci * vn[:, None]) * _f32(0.99)
    v_out = torch.where(fric[:, None], v_fric, v_new)
    return x_out, v_out


def integrate(
    pos_l: torch.Tensor,
    vel_l: torch.Tensor,
    ptype_l: torch.Tensor,
    a_ext: torch.Tensor,
    a_p: torch.Tensor,
    nbrs: NeighborList,
    params: SimParams,
    ptype_g: torch.Tensor | None = None,
    normal_g: torch.Tensor | None = None,
    pos0_g: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Semi-implicit Euler + box clamp + boundary response
    (sphFluid.cl:1684-1808). Returns (pos, vel) with boundary rows
    untouched."""
    ptype_g = ptype_l if ptype_g is None else ptype_g
    pos0_g = pos_l if pos0_g is None else pos0_g

    dt = _f32(params.time_step)
    pos_dt = _f32(params.time_step * params.simulation_scale_inv)
    v_new = vel_l + (a_ext + a_p) * dt
    x_new = pos_l + v_new * pos_dt

    eps = 1e-6
    dev = pos_l.device
    lo = torch.tensor([_f32(v) for v in params.box_min], device=dev)
    hi = torch.tensor([_f32(v - eps) for v in params.box_max], device=dev)
    x_new = torch.clamp(x_new, lo, hi)

    v_avg = (vel_l + v_new) * 0.5
    x_new, v_avg = boundary_response(
        x_new, v_avg, ptype_g, normal_g, pos0_g, nbrs, params)

    not_b = (ptype_l != BOUNDARY_PARTICLE)[:, None]
    return torch.where(not_b, x_new, pos_l), torch.where(not_b, v_avg, vel_l)
