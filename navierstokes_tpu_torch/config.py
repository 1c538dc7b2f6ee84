"""Runtime configuration of navierstokes_tpu_torch.

The JAX package's ``navierstokes_tpu/config.py`` schema without its TPU
layout knobs (``bsr_f_kmax``, ``bsr_gb_kmax``, ``f_matvec``,
``steps_per_chunk``); a value that no option of the JAX package takes
raises in ``models/navier_stokes.check_config``, which reads a
configuration by its field names, so a JAX package config object is
taken as it is.

The reference configures everything at compile time (macro ``DIM``,
``NS_INPUT`` inlet injection, hard-coded constants nu/p_out/Diameter —
src/NavierStokes.hpp:54, :77-122, :254-256) plus constructor arguments
(mesh, degrees, dt, T, step — src/NavierStokes.hpp:173-189).  Here all of
that is a runtime dataclass, so one build serves every scenario.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional


@dataclasses.dataclass
class InletConfig:
    """Inlet velocity profile (x-component only, like every reference scenario).

    Profiles found in the reference drivers:
      * ``uniform``:      u_x = u_m                           (tests/2D/test_naca, src/main default 3.0)
      * ``parabolic``:    u_x = 4 u_m y (H - y) / H^2         (tests/2D/test_01, test_02)
      * ``biparabolic``:  u_x = 16 u_m y z (H-y)(H-z) / H^4   (tests/3D/test_01, test_02)
    ``pulsating=True`` multiplies by sin(pi t / period)        (tests/{2,3}D/test_03).

    ``mean_velocity()`` reproduces each driver's ``get_mean_vel()``:
    uniform -> u_m; parabolic -> 2 u_m / 3; biparabolic -> 4 u_m / 9
    (tests/2D/test_02/src/test_02.cpp:39-42, tests/3D/test_01/src/test_01.cpp:39-42),
    with the same sin factor when pulsating (tests/2D/test_03/src/test_03.cpp:41-44).
    """

    kind: str = "parabolic"  # uniform | parabolic | biparabolic | custom
    u_m: float = 1.5
    height: float = 0.41
    pulsating: bool = False
    period: float = 8.0
    # Smooth (C1, raised-cosine) start-up ramp length in seconds; 0 = the
    # reference's impulsive start.  An impulsive start at CFL >~ 4 puts the
    # first few solves on a knife edge (stagnating Krylov iterations that
    # can amplify epsilon-level perturbations into divergence at 1M DoF);
    # a short ramp removes the pathology without changing the developed
    # flow the benchmarks measure.
    ramp: float = 0.0
    # Optional override: fn(points[(n, dim)], t) -> (n,) u_x values, or
    # (n, dim) full velocity vectors (reference InletVelocity::vector_value,
    # src/NavierStokes.hpp:77-122 — every shipped driver is x-only but the
    # hook is a full dim-vector Function)
    profile_fn: Optional[Callable] = None
    # Optional override of the mean velocity used for Re and Cd/Cl normalization.
    mean_override: Optional[float] = None

    def time_factor(self, t: float) -> float:
        f = math.sin(math.pi * t / self.period) if self.pulsating else 1.0
        if self.ramp and t < self.ramp:
            f *= 0.5 - 0.5 * math.cos(math.pi * t / self.ramp)
        return f

    def mean_velocity(self, t: float = 0.0) -> float:
        if self.mean_override is not None:
            base = self.mean_override
        elif self.kind == "uniform":
            base = self.u_m
        elif self.kind == "parabolic":
            base = 2.0 * self.u_m / 3.0
        elif self.kind == "biparabolic":
            base = 4.0 * self.u_m / 9.0
        else:
            raise ValueError(
                f"mean_override required for custom inlet kind {self.kind!r}")
        return base * self.time_factor(t)

    def steady_mean_velocity(self) -> float:
        """Mean velocity without the pulsation factor (used by set_re_number,
        matching the reference which calls get_mean_vel() at setup time where
        sin-time profiles would otherwise give 0 — src/NavierStokes.cpp:332-341
        evaluates get_mean_vel() before the time loop)."""
        if self.mean_override is not None:
            return self.mean_override
        if self.kind == "uniform":
            return self.u_m
        if self.kind == "parabolic":
            return 2.0 * self.u_m / 3.0
        if self.kind == "biparabolic":
            return 4.0 * self.u_m / 9.0
        raise ValueError(f"mean_override required for custom inlet {self.kind!r}")

    def evaluate(self, points, t: float):
        """Inlet velocity at the given coordinates (host-side numpy):
        (n,) u_x values for the builtin profiles, or whatever profile_fn
        returns — (n,) x-only or (n, dim) full vectors."""
        import numpy as np

        pts = np.asarray(points)
        if self.profile_fn is not None:
            # passthrough: the fn receives t and owns any time dependence
            return np.asarray(self.profile_fn(pts, t))
        H = self.height
        if self.kind == "uniform":
            vals = np.full(pts.shape[0], self.u_m)
        elif self.kind == "parabolic":
            y = pts[:, 1]
            vals = 4.0 * self.u_m * y * (H - y) / (H * H)
        elif self.kind == "biparabolic":
            y, z = pts[:, 1], pts[:, 2]
            vals = 16.0 * self.u_m * y * z * (H - y) * (H - z) / (H ** 4)
        else:
            raise ValueError(f"unknown inlet kind {self.kind!r}")
        return vals * self.time_factor(t)


@dataclasses.dataclass
class SolverConfig:
    """All solver knobs.  Defaults mirror the reference's hard-coded values.

    ``models/navier_stokes.check_config`` rejects a value that is none of
    the JAX package's."""

    # Physics (src/NavierStokes.hpp:254-256)
    nu: float = 1.0e-3
    p_out: float = 0.0            # outlet pressure (Neumann RHS, cpp:257-278)
    # Reference length of the Cd/Cl normalization: the reference hard-codes
    # 0.4 (src/NavierStokes.hpp:256) even for the d=0.1 cylinder.
    ref_length: float = 0.4
    # 3D span factor: the reference divides by an extra 0.41 in 3D
    # (src/NavierStokes.cpp:913-917).
    span_3d: float = 0.41
    # Viscous force term (ops/forces.py): "reference" = n.grad(u).t, the
    # reference's contraction (it vanishes on no-slip walls); "st" =
    # t.grad(u).n, the Schaefer-Turek definition (benchmark comparisons).
    force_formula: str = "reference"

    # Time stepping (constructor arguments, src/NavierStokes.hpp:173-189)
    deltat: float = 0.01
    t_final: float = 2.0
    output_step: int = 10  # VTU + checkpoint every this many steps

    # FE degrees (always 2/1 in the reference drivers; the constructor
    # arguments decide)
    degree_velocity: int = 2
    degree_pressure: int = 1

    # Time-stepping scheme:
    #   "monolithic" — reference parity: the full saddle-point system per
    #                  step, FGMRES + block preconditioner (cpp:344-397)
    #   "projection" — rotational incremental pressure correction: one
    #                  BC-masked F solve + one pressure-Poisson solve per
    #                  step, O(dt^2) splitting error
    scheme: str = "monolithic"
    proj_f_maxiter: int = 150     # BiCGStab budget for the u* solve
    proj_p_maxiter: int = 50      # CG budget for the pressure Poisson
    proj_rotational: bool = True  # rotational pressure update (+nu div u*)
    # BDF2 time derivative with extrapolated convection C(2u^n - u^{n-1})
    # (projection); the extrapolation is explicit, so it needs a moderate
    # CFL (the JAX package's VALIDATION.md: stable at CFL <~ 2).
    proj_bdf2: bool = True
    # Explicit-pressure extrapolation weight theta: the u* solve about
    # p* = p^n + theta (p^n - p^{n-1}) instead of p^n (0).  The JAX package
    # measured theta=1 divergent on its manufactured open channel
    # (VALIDATION.md); default 0.
    proj_p_extrap: float = 0.0
    # Pressure-Poisson operator of the projection step: "laplacian" (the
    # assembled consistent P1 stiffness, an approximate projection) or
    # "schur" (CG on the compatible B W B^T with the Laplacian V-cycle as
    # its preconditioner, pinned at the outlet and at the nodes below
    # proj_schur_pin_ratio: the projection exact to the CG tolerance; the
    # JAX package measured it long-horizon unstable, VALIDATION.md).
    proj_poisson: str = "laplacian"
    # "schur" pins phi=0 where the masked diag(B W B^T) keeps less than
    # this fraction of its unmasked weight
    proj_schur_pin_ratio: float = 0.95
    proj_tol: float = 1.0e-4      # relative tolerance of both sub-solves

    # Outer Krylov (src/NavierStokes.cpp:344-397)
    outer_tol: float = 1.0e-6     # relative to ||rhs||
    outer_maxiter: int = 200      # reference allows 10000
    outer_restart: int = 64
    # Iterative-refinement passes after an fp32 monolithic solve, with a
    # float64 residual (solvers/refine.py): the stand-in for the
    # reference's all-f64 solve (src/NavierStokes.cpp:348, 377).  0 = off.
    refine: int = 0
    refine_tol: float = 1.0e-2    # relative tol of each correction solve
    refine_maxiter: int = 60
    # Block preconditioner: "cc" (Cahouet-Chabard: pressure-Laplacian
    # V-cycle + pressure mass), "pcd" (CC + the per-step pressure
    # convection), "asimple" (reference parity, src/NavierStokes.cpp:934-995),
    # "ayosida" (cpp:998-1051), "identity".
    preconditioner: str = "cc"
    alpha: float = 0.5            # aSIMPLE damping (src/NavierStokes.hpp:306)

    # Inner solves (reference: ILU-GMRES, rtol 1e-2,
    # src/NavierStokes.cpp:972-973), here with fixed iteration caps
    inner_tol: float = 1.0e-2
    inner_maxiter_f: int = 10
    inner_maxiter_s: int = 20
    # F-block preconditioner of the inner velocity solve: "bj" (dense
    # inverses of the 256-node tile diagonals, rebuilt per step, the
    # ILU(0) stand-in; ops/p1ell.py) or "jacobi" / "diag" (diagonal
    # scaling, no tiles: the JAX package's choice for 3D-1Z, where F is
    # mass-dominated).
    f_precond: str = "bj"
    # F solve of the monolithic preconditioners: "bicgstab", "gmres" or
    # "richardson" (inner_maxiter_f preconditioned sweeps; the JAX package
    # measured FGMRES stalling with it at the CFL~8 bench point).
    f_solver: str = "bicgstab"
    # Node blocks per block-Jacobi tile (tile = this * bsr_block nodes);
    # 0 => auto = max(1, 256 // bu), 256-node tiles.
    bj_tile_blocks: int = 0
    # The JAX package's tile-gather formulation ("auto", "blocked", "rows",
    # "scatter"): all give the same tile values, which the port takes from
    # its compact F values whatever this says.
    bj_tiles: str = "auto"
    # bf16 F values inside the preconditioner's inner solves (fp32 runs;
    # vectors and sums stay fp32).
    inner_bf16: bool = False
    # bf16 block-Jacobi tile inverses (fp32 runs).  The JAX package
    # measured it divergent at the CFL~8 bench point; default off.
    bj_bf16: bool = False
    # Newton-Schulz iterations of the per-step tile inversion from the
    # static-operator seed; an exact inverse where the seed is outside the
    # contraction region.  0 = exact inverse every step.
    bj_newton: int = 3
    # Mass realization of the JAX package ("auto", "blocked", "node"): the
    # same product, which the port always takes from the F slots; as in the
    # JAX model, refinement runs only where the JAX model keeps a blocked
    # mass: "blocked", or "auto" in 2D ("auto" is the node mass in 3D).
    mass_format: str = "auto"

    # Curved (superparametric P2) geometry on boundaries with analytic
    # projectors (Mesh.snap_projectors, set by the native generators):
    # midside nodes snapped onto the curve, quadratic geometry in the
    # touched cells.  Inert for meshes without projectors.
    curved_boundary: bool = True

    # Numerics
    dtype: str = "float32"        # compute dtype on the device
    # "bsr" (P2/P1, compact operators) or "cells" (the generic element
    # operator, any degree pair, monolithic only); "ell" (the JAX package's
    # node-graph operator) runs on "cells" with the assembled Schur diagonal
    operator: str = "bsr"
    # Node-block size of the block-Jacobi tiles and the Schur aggregates;
    # 0 => 16.
    bsr_block: int = 0
    # Two-level Schur solve (solvers/schur.py): pressure node blocks per
    # aggregate (0 => auto = max(1, 64 // bp), 64-node aggregates), V-cycle
    # count and Chebyshev smoothing steps per cycle.
    schur_agg_blocks: int = 0
    schur_vcycles: int = 2
    schur_smooth_k: int = 3

    # Output
    output_dir: str = "output"
    cache_dir: str = "cache"
    csv_path: str = "forces_vs_time.csv"

    # Distribution
    # 0 or 1: one device; N > 1: the bsr operator split by rows over N
    # devices, the vectors on the model's device (parallel/)
    n_devices: int = 0
