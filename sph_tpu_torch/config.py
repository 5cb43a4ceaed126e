"""Simulation parameters and derived numerical constants.

A copy of ``sph_tpu/config.py`` (the port cannot import ``sph_tpu``: its
package import pulls in jax). ``tests/test_torch_config_scene.py`` holds every
field and coefficient equal to the original.

Numerics design
---------------
The reference (`src/owPhysicsConstant.h:12-77`,
`src/sphFluid.cl`) evaluates smoothing-kernel sums in *scaled*
SI units, where individual terms like ``(h_s^2 - r^2)^3`` are ~1e-31 — far
into precision-loss territory for float32, which is why the OpenCL kernels
resort to double-precision accumulation (`sphFluid.cl:493`). The pair
kernels run in f32.

We therefore *nondimensionalize*: every per-neighbor kernel term is expressed
in units of the scaled smoothing radius ``h_s`` so it is O(1)
(``q = r / h_s`` in [0, 1]), and all dimensional prefactors are folded into a
handful of scalar constants precomputed here in float64 and applied once per
reduction. The physics is identical; only the factorization differs.

Derived-constant map (reference -> here):
  Wpoly6Coefficient     (owPhysicsConstant.h:69) -> folded into ``c_rho``, ``c_surf``
  gradWspikyCoefficient (owPhysicsConstant.h:70) -> folded into ``c_press``, ``delta``
  del2WviscosityCoefficient (owPhysicsConstant.h:71) -> folded into ``c_visc``
  delta (owPhysicsFluidSimulator.cpp:164-203)    -> ``delta`` (same algorithm, f64)
"""
from __future__ import annotations

import dataclasses
import math
from functools import cached_property


@dataclasses.dataclass(frozen=True)
class SimParams:
    """Physical + numerical parameters of one simulation.

    All fields have the reference's defaults (`owPhysicsConstant.h`); the
    dataclass is hashable, so it can key caches of built step functions.
    Lengths with suffix ``_sim`` are in simulation units (the particle-grid
    units the scene files use); ``_s`` marks scaled SI meters.
    """

    # --- primary physical constants (owPhysicsConstant.h:12-27) ---
    rho0: float = 1000.0
    mass: float = 3.25e-14           # kg
    time_step: float = 5.0e-6        # s
    h: float = 3.34                  # smoothing radius, sim units
    viscosity: float = 5.0e-5        # dynamic viscosity mu
    stiffness: float = 0.75          # kept for config parity (unused in kernels)
    damping: float = 0.75            # kept for config parity (unused in kernels)
    gravity: tuple[float, float, float] = (0.0, -9.8, 0.0)

    # --- world box, sim units (owPhysicsConstant.h:32-37): 30h x 20h x 250h ---
    x_min: float = 0.0
    x_max: float = 30.0 * 3.34
    y_min: float = 0.0
    y_max: float = 20.0 * 3.34
    z_min: float = 0.0
    z_max: float = 250.0 * 3.34

    # --- solver knobs ---
    n_pcisph_iters: int = 3          # owPhysicsConstant.h:76 (maxIteration)
    max_neighbors: int = 32          # owOpenCLConstant.h:4
    # Max particles tracked per 2h hash-grid cell. The generated worm scene's
    # densest cell holds ~106, so anything below 128 silently drops neighbor
    # candidates there (the reference's own failure mode, sphFluid.cl:169).
    # Simulator derives a scene-measured value at construction; this default
    # covers the shipped scenes.
    cell_capacity: int = 128

    # --- elastic matter / muscles (sphFluid.cl:741, :782) ---
    k_spring: float = 6.0e8          # Hooke coefficient of elastic connections
    muscle_force: float = 800.0      # activation-to-acceleration gain
    surface_tension_gain: float = -1.5e-9 * 0.3   # sphFluid.cl:662

    # ------------------------------------------------------------------
    # Derived constants. All computed in float64; consumers cast to f32.
    # ------------------------------------------------------------------

    @cached_property
    def simulation_scale(self) -> float:
        """Sim-unit -> meter factor (owPhysicsConstant.h:19)."""
        return 0.004 * self.mass ** (1.0 / 3.0) / 0.00025 ** (1.0 / 3.0)

    @cached_property
    def simulation_scale_inv(self) -> float:
        return 1.0 / self.simulation_scale

    @cached_property
    def h_s(self) -> float:
        """Scaled smoothing radius, meters."""
        return self.h * self.simulation_scale

    @cached_property
    def r0(self) -> float:
        """Boundary/equilibrium spacing, sim units (owPhysicsConstant.h:27)."""
        return 0.5 * self.h

    @cached_property
    def cell_size(self) -> float:
        """Hash-grid cell edge, sim units (owPhysicsConstant.h:22): 2h.

        cell >= 2 * interaction radius, so the 2x2x2 corner-block search in
        the neighbor kernel is exhaustive.
        """
        return 2.0 * self.h

    @cached_property
    def grid_dims(self) -> tuple[int, int, int]:
        """Cell counts per axis at cell size 2h.

        The reference counts cells with ``h`` but indexes with ``2h`` and
        truncates ids to 16 bits (`owOpenCLSolver.cpp:14-17` vs
        `sphFluid.cl:377`) — an aliasing hash. We use the exact 2h grid.
        """
        def n(lo: float, hi: float) -> int:
            return int((hi - lo) / self.cell_size) + 1
        return (n(self.x_min, self.x_max),
                n(self.y_min, self.y_max),
                n(self.z_min, self.z_max))

    @cached_property
    def n_cells(self) -> int:
        nx, ny, nz = self.grid_dims
        return nx * ny * nz

    # -- smoothing-kernel coefficients (owPhysicsConstant.h:68-71) --

    @cached_property
    def w_poly6(self) -> float:
        return 315.0 / (64.0 * math.pi * self.h_s ** 9)

    @cached_property
    def grad_w_spiky(self) -> float:
        return -45.0 / (math.pi * self.h_s ** 6)

    @cached_property
    def beta(self) -> float:
        """PCISPH beta (owPhysicsConstant.h:68)."""
        return self.time_step ** 2 * self.mass ** 2 * 2.0 / self.rho0 ** 2

    # -- nondimensional fold-in constants --

    @cached_property
    def c_rho(self) -> float:
        """rho_i = c_rho * sum_j (1 - q_ij^2)^3  (sphFluid.cl:507,516)."""
        return self.mass * self.w_poly6 * self.h_s ** 6

    @cached_property
    def c_visc(self) -> float:
        """a_visc = c_visc / rho_i * sum_j (v_j - v_i)(1 - q_ij)/rho_j.

        = mass * mu * del2Wviscosity * h_s  (sphFluid.cl:653,688).
        """
        return self.mass * self.viscosity * 45.0 / (math.pi * self.h_s ** 5)

    @cached_property
    def c_surf(self) -> float:
        """a_st = c_surf * sum_j (x_i - x_j)   [x in sim units]
        (sphFluid.cl:662): -1.5e-9*0.3 * Wpoly6 * (h_s^2/2)^3 * scale."""
        return (self.surface_tension_gain * self.w_poly6
                * (self.h_s ** 2 / 2.0) ** 3 * self.simulation_scale)

    @cached_property
    def c_press(self) -> float:
        """a_p = c_press / rho*_i * sum_j term_j * unit(x_i - x_j), with
        term_j = (1-q)^2 * 0.5 * (p_i + p_j) / rho*_j  (sphFluid.cl:1160,1194).

        Both the kernel's leading minus (cl:1160) and gradWspiky's minus fold
        to a positive (repulsive) coefficient: mass * 45 / (pi * h_s^4).
        """
        return self.mass * 45.0 / (math.pi * self.h_s ** 4)

    @cached_property
    def delta(self) -> float:
        """PCISPH pressure-correction scalar.

        Same prototype-neighborhood construction as the reference
        (`owPhysicsFluidSimulator.cpp:164-203`): 32 ideal neighbors at
        0.8 * particleRadius spacing, delta = 1/(beta*|gradWspiky|^2*(S1+S2)).
        Computed here fully in float64.
        """
        x = [1, 1, 0, -1, -1, -1, 0, 1, 1, 1, 0, -1, -1, -1, 0, 1,
             1, 1, 0, -1, -1, -1, 0, 1, 2, -2, 0, 0, 0, 0, 0, 0]
        y = [0, 1, 1, 1, 0, -1, -1, -1, 0, 1, 1, 1, 0, -1, -1, -1,
             0, 1, 1, 1, 0, -1, -1, -1, 0, 0, 2, -2, 0, 0, 0, 0]
        z = [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1,
             -1, -1, -1, -1, -1, -1, -1, -1, 0, 0, 0, 0, 2, -2, 1, -1]
        particle_radius = (self.mass / self.rho0) ** (1.0 / 3.0)
        s1x = s1y = s1z = 0.0
        s2 = 0.0
        for xi, yi, zi in zip(x, y, z):
            vx = xi * 0.8 * particle_radius
            vy = yi * 0.8 * particle_radius
            vz = zi * 0.8 * particle_radius
            dist = math.sqrt(vx * vx + vy * vy + vz * vz)
            if dist <= self.h_s:
                h_r_2 = (self.h_s - dist) ** 2
                s1x += h_r_2 * vx / dist
                s1y += h_r_2 * vy / dist
                s1z += h_r_2 * vz / dist
                s2 += h_r_2 * h_r_2
        s1 = s1x * s1x + s1y * s1y + s1z * s1z
        return 1.0 / (self.beta * self.grad_w_spiky ** 2 * (s1 + s2))

    @cached_property
    def box_min(self) -> tuple[float, float, float]:
        return (self.x_min, self.y_min, self.z_min)

    @cached_property
    def box_max(self) -> tuple[float, float, float]:
        return (self.x_max, self.y_max, self.z_max)


DEFAULT_PARAMS = SimParams()
