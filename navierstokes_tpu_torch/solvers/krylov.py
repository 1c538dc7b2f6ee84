"""Krylov solvers: (flexible) GMRES, right-preconditioned BiCGStab and
preconditioned CG.

Port of ``navierstokes_tpu/solvers/krylov.py`` with the same stopping
rules (||r|| <= max(tol ||b||, atol) or the iteration budget), the same
BiCGStab breakdown guard and the same iteration counting.  The loops are
Python loops whose state is fixed-shape tensors; the loop condition is
read on the host once per iteration.  GMRES keeps JAX's arithmetic: a
two-pass modified Gram-Schmidt against the whole static (m+1, n) basis
under an index mask on the device, and the small Hessenberg least-squares
problem (Givens rotations, the identity-padded triangular solve) on the
host in the solve's precision, from the one vector the iteration reads
back anyway.  Vectors may be tensors or tuples of tensors (flattened in
order, as ``jax.flatten_util.ravel_pytree`` does).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import scipy.linalg
import torch


class KrylovResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    residual: torch.Tensor   # final residual norm (0-d)
    converged: bool


def _ravel(tree):
    """(flat vector, unravel) of a tensor or a tuple of tensors."""
    if isinstance(tree, torch.Tensor):
        shape = tree.shape
        return tree.reshape(-1), lambda v: v.reshape(shape)
    shapes = [t.shape for t in tree]
    sizes = [t.numel() for t in tree]

    def unravel(v):
        return tuple(c.reshape(s) for c, s in zip(torch.split(v, sizes),
                                                  shapes))
    return torch.cat([t.reshape(-1) for t in tree]), unravel


def _flat_system(b, matvec, precond):
    """(b flat, unravel, flat matvec, flat preconditioner)."""
    b_flat, unravel = _ravel(b)
    mv = lambda v: _ravel(matvec(unravel(v)))[0]
    pc = ((lambda v: _ravel(precond(unravel(v)))[0])
          if precond is not None else (lambda v: v))
    return b_flat, unravel, mv, pc


def gmres(matvec: Callable, b, x0=None, *, tol=1e-6, atol=0.0, restart=30,
          maxiter=100, precond: Optional[Callable] = None,
          flexible=False) -> KrylovResult:
    """(F)GMRES with right preconditioning.

    ``restart`` is the Krylov dimension m; ``maxiter`` caps the total
    number of iterations across restart cycles.  ``flexible=True`` keeps
    the preconditioned vectors Z_j (FGMRES), so the preconditioner may be
    an iterative solve.  The (m+1, n) basis and the (m, n) Z are allocated
    once per solve and zeroed at each cycle."""
    b_flat, unravel, mv, pc = _flat_system(b, matvec, precond)
    n = b_flat.numel()
    dtype, dev = b_flat.dtype, b_flat.device
    npdt = np.float64 if dtype == torch.float64 else np.float32
    x = torch.zeros_like(b_flat) if x0 is None else _ravel(x0)[0]
    target = np.maximum(npdt(tol) * npdt(torch.linalg.norm(b_flat).item()),
                        npdt(atol))
    m = restart
    V = torch.empty((m + 1, n), dtype=dtype, device=dev)
    Z = torch.empty((m, n), dtype=dtype, device=dev) if flexible else None
    rows = torch.arange(m + 1, device=dev)
    tiny = npdt(1e-30)

    def cycle(x, total_iters):
        r0 = b_flat - mv(x)
        beta = torch.linalg.norm(r0)
        V.zero_()
        V[0] = torch.where(beta > 0, r0 / torch.clamp(beta, min=1e-30),
                           torch.zeros_like(r0))
        if flexible:
            Z.zero_()
        H = np.zeros((m + 1, m), npdt)
        cs = np.zeros(m, npdt)
        sn = np.zeros(m, npdt)
        g = np.zeros(m + 1, npdt)
        g[0] = res = npdt(beta.item())
        j = 0
        while j < m and res > target and total_iters + j < maxiter:
            z = pc(V[j])
            w = mv(z)
            if flexible:
                Z[j] = z
            # two-pass modified Gram-Schmidt over the whole basis, masked
            mask = (rows <= j).to(dtype)
            h1 = (V @ w) * mask
            w = w - h1 @ V
            h2 = (V @ w) * mask
            w = w - h2 @ V
            wnorm = torch.linalg.norm(w)
            V[j + 1] = w / torch.clamp(wnorm, min=1e-30)
            hw = torch.cat([h1 + h2, wnorm[None]]).cpu().numpy()
            h = hw[:m + 1].astype(npdt)
            h[j + 1] = hw[m + 1]
            # the stored Givens rotations, then the one annihilating h[j+1]
            for i in range(j):
                hi = cs[i] * h[i] + sn[i] * h[i + 1]
                h[i + 1] = -sn[i] * h[i] + cs[i] * h[i + 1]
                h[i] = hi
            denom = np.sqrt(h[j] ** 2 + h[j + 1] ** 2)
            if denom > 0:
                cj = h[j] / np.maximum(denom, tiny)
                sj = h[j + 1] / np.maximum(denom, tiny)
            else:
                cj, sj = npdt(1.0), npdt(0.0)
            h[j], h[j + 1] = denom, 0.0
            cs[j], sn[j] = cj, sj
            g[j + 1] = -sj * g[j]
            g[j] = cj * g[j]
            H[:, j] = h
            res = np.abs(g[j + 1])
            j += 1
        # the j x j upper-triangular system, padded to m with the identity
        active = np.arange(m) < j
        R = np.where(active[None, :] & active[:, None], H[:m, :m],
                     np.eye(m, dtype=npdt))
        y = scipy.linalg.solve_triangular(R, np.where(active, g[:m], 0.0),
                                          lower=False)
        yt = torch.as_tensor(y.astype(npdt), device=dev)
        dx = yt @ Z if flexible else pc(yt @ V[:m])
        return x + dx, total_iters + j, res, bool(res <= target)

    iters, res, conv = 0, np.inf, False
    while not conv and iters < maxiter:
        x, iters, res, conv = cycle(x, iters)
    return KrylovResult(unravel(x), iters,
                        torch.tensor(float(res), dtype=dtype, device=dev),
                        conv)


def fgmres(matvec: Callable, b, x0=None, **kw) -> KrylovResult:
    """Flexible GMRES: ``gmres(..., flexible=True)``."""
    return gmres(matvec, b, x0, flexible=True, **kw)


def bicgstab(matvec: Callable, b, x0=None, *, tol=1e-6, atol=0.0,
             maxiter=100, precond: Optional[Callable] = None
             ) -> KrylovResult:
    """Right-preconditioned BiCGStab (two matvecs per iteration)."""
    b_flat, unravel, mv, pc = _flat_system(b, matvec, precond)
    x = torch.zeros_like(b_flat) if x0 is None else _ravel(x0)[0]
    r = b_flat - mv(x)
    r0 = r
    target = torch.clamp(tol * torch.linalg.norm(b_flat), min=atol)
    one = torch.ones((), dtype=b_flat.dtype, device=b_flat.device)
    rho = alpha = omega = one
    v = torch.zeros_like(b_flat)
    p = torch.zeros_like(b_flat)
    eps = torch.full((), 1e-30, dtype=b_flat.dtype, device=b_flat.device)
    safe = lambda a: torch.where(a.abs() > eps, a, eps)
    k = 0
    stag = torch.zeros((), dtype=torch.bool, device=b_flat.device)
    while k < maxiter and bool((torch.linalg.norm(r) > target) & ~stag):
        rho_new = r0 @ r
        beta = (rho_new / safe(rho)) * (alpha / safe(omega))
        p = r + beta * (p - omega * v)
        phat = pc(p)
        v = mv(phat)
        denom = r0 @ v
        alpha = rho_new / safe(denom)
        s = r - alpha * v
        shat = pc(s)
        t = mv(shat)
        tt = t @ t
        omega = (t @ s) / torch.where(tt > eps, tt, eps)
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        # breakdown guard: stops the loop cleanly
        stag = (rho_new.abs() <= eps) | (denom.abs() <= eps)
        rho = rho_new
        k += 1
    res = torch.linalg.norm(r)
    return KrylovResult(unravel(x), k, res, bool(res <= target))


def cg(matvec: Callable, b, x0=None, *, tol=1e-6, atol=0.0, maxiter=100,
       precond: Optional[Callable] = None) -> KrylovResult:
    """Preconditioned conjugate gradient for SPD operators."""
    b_flat, unravel, mv, pc = _flat_system(b, matvec, precond)
    x = torch.zeros_like(b_flat) if x0 is None else _ravel(x0)[0]
    r = b_flat - mv(x)
    z = pc(r)
    p = z
    rz = r @ z
    target = torch.clamp(tol * torch.linalg.norm(b_flat), min=atol)
    k = 0
    while k < maxiter and bool(torch.linalg.norm(r) > target):
        Ap = mv(p)
        alpha = rz / torch.clamp(p @ Ap, min=1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        z = pc(r)
        rz_new = r @ z
        beta = rz_new / torch.clamp(rz, min=1e-30)
        p = z + beta * p
        rz = rz_new
        k += 1
    res = torch.linalg.norm(r)
    return KrylovResult(unravel(x), k, res, bool(res <= target))
