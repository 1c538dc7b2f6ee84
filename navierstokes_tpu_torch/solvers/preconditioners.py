"""Block preconditioners of the monolithic Taylor-Hood system.

Port of ``navierstokes_tpu/solvers/preconditioners.py``: matrix-free
versions of the reference's Trilinos preconditioners
(src/NavierStokes.cpp:934-1051) with the same vmult algebra, signs and
1/alpha scaling:

* ``identity``  — pass-through (src/NavierStokes.hpp:274-287);
* ``cc``        — block upper-triangular with the Cahouet-Chabard Schur
  approximation (1/dt) Ap^-1 + nu Mp^-1;
* ``pcd``       — pressure convection-diffusion, Mp^-1 Fp Ap^-1;
* ``asimple``   — algebraic SIMPLE, S = B D^-1 B^T (cpp:934-995);
* ``ayosida``   — Yosida, S = B (dt M_lumped^-1) B^T with a second F-solve
  (cpp:998-1051).

Vectors are tuples (u (n_p2, dim), p (n_p1,)).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from navierstokes_tpu_torch.solvers.krylov import BicgstabLoop, gmres


@dataclasses.dataclass
class InnerSolve:
    """Inner solve policy: preconditioned BiCGStab (``maxiter`` counts
    matvec pairs) or restarted GMRES, at the reference's loose 1e-2
    tolerance (src/NavierStokes.cpp:972-989)."""
    tol: float = 1.0e-2
    maxiter: int = 30
    method: str = "bicgstab"  # bicgstab | gmres

    def __call__(self, apply_op: Callable, rhs, precond=None):
        if self.method == "gmres":
            return gmres(apply_op, rhs, tol=self.tol,
                         restart=min(10, self.maxiter),
                         maxiter=self.maxiter, precond=precond).x
        # only x: no read of the count and convergence
        loop = BicgstabLoop(apply_op, rhs, tol=self.tol,
                            maxiter=self.maxiter, precond=precond).run()
        return loop.unravel(loop.x)


def make_identity():
    return lambda r: r


def make_cahouet_chabard(apply_f: Callable, apply_bt: Callable,
                         solve_ap: Callable, mp_lumped, dinv,
                         dt: float, nu, inner_f: InnerSolve):
    """S_F^-1 ~= (1/dt) Ap^-1 + nu Mp^-1;  p = -S_F^-1 r_p;
    u = F^-1 (r_u - B^T p)  [Cahouet & Chabard 1988]."""
    jac_f = lambda r: r * dinv

    def vmult(r):
        ru, rp = r
        z = solve_ap(rp) / dt + nu * (rp / mp_lumped)
        p = -z
        u = inner_f(apply_f, ru - apply_bt(p), jac_f)
        return (u, p)

    return vmult


def make_pcd(apply_f: Callable, apply_bt: Callable, solve_ap: Callable,
             apply_ap: Callable, apply_np: Callable, mp_lumped, dinv,
             dt: float, nu, inner_f: InnerSolve):
    """S_F^-1 ~= Mp^-1 Fp Ap^-1 with Fp = Mp/dt + nu Ap + Np(u)
    [Elman, Silvester & Wathen]."""
    jac_f = lambda r: r * dinv

    def vmult(r):
        ru, rp = r
        y = solve_ap(rp)
        fy = mp_lumped * y / dt + nu * apply_ap(y) + apply_np(y)
        p = -(fy / mp_lumped)
        u = inner_f(apply_f, ru - apply_bt(p), jac_f)
        return (u, p)

    return vmult


def make_asimple(apply_f: Callable, apply_b: Callable, apply_bt: Callable,
                 dinv, diag_s, alpha: float,
                 inner_f: InnerSolve, inner_s: InnerSolve,
                 precond_s: Callable | None = None,
                 solve_s: Callable | None = None):
    """aSIMPLE vmult (src/NavierStokes.cpp:966-995):
    y = F^-1 ru;  z = S^-1 (rp - B y);  p = -z / alpha;
    u = y - D^-1 B^T p."""
    jac_f = lambda r: r * dinv
    sdinv = torch.where(diag_s != 0, 1.0 / diag_s, torch.ones_like(diag_s))
    jac_s = precond_s or (lambda r: r * sdinv)

    def apply_s(v):
        return apply_b(apply_bt(v) * dinv)

    def vmult(r):
        ru, rp = r
        y = inner_f(apply_f, ru, jac_f)
        r1 = rp - apply_b(y)
        z = solve_s(r1) if solve_s is not None \
            else inner_s(apply_s, r1, jac_s)
        p = -z / alpha
        u = y - apply_bt(p) * dinv
        return (u, p)

    return vmult


def make_ayosida(apply_f: Callable, apply_b: Callable, apply_bt: Callable,
                 dinv, dt_mlump_inv, diag_s,
                 inner_f: InnerSolve, inner_s: InnerSolve,
                 precond_s: Callable | None = None,
                 solve_s: Callable | None = None):
    """aYosida vmult (src/NavierStokes.cpp:1024-1051):
    y = F^-1 ru;  p = S^-1 (B y - rp);  u = y - F^-1 (B^T p)."""
    jac_f = lambda r: r * dinv
    sdinv = torch.where(diag_s != 0, 1.0 / diag_s, torch.ones_like(diag_s))
    jac_s = precond_s or (lambda r: r * sdinv)

    def apply_s(v):
        return apply_b(apply_bt(v) * dt_mlump_inv)

    def vmult(r):
        ru, rp = r
        y = inner_f(apply_f, ru, jac_f)
        r1 = apply_b(y) - rp
        p = solve_s(r1) if solve_s is not None \
            else inner_s(apply_s, r1, jac_s)
        u = y - inner_f(apply_f, apply_bt(p), jac_f)
        return (u, p)

    return vmult
