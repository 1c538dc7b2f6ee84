"""Krylov solvers: (flexible) GMRES, right-preconditioned BiCGStab and
preconditioned CG.

Port of ``navierstokes_tpu/solvers/krylov.py`` with the same stopping
rules (||r|| <= max(tol ||b||, atol) or the iteration budget), the same
BiCGStab breakdown guard and the same iteration counting.

The counterpart of JAX's ``lax.while_loop``: every loop keeps its whole
state on the device in fixed-shape tensors, the iteration count and the
loop predicate ``active`` (JAX's ``cond``: ``||r|| > target``, no
breakdown, ``k < maxiter``) included.  Iterations run in blocks of
``check_every`` (``BICGSTAB_CHECK_EVERY``, ``CG_CHECK_EVERY``,
``GMRES_CHECK_EVERY``): each iteration computes its update and commits it
under ``torch.where(active, new, old)``, adding ``active`` to the count,
and the host reads the one flag ``active`` at the end of a block
(``_host``).  Once a solve has stopped, a masked iteration changes no
bit, so counts and results are those of a block size of 1 at every block
size.  The state is updated in place, so a block can be captured as a
CUDA graph and replayed (models/step_graphs.py).

GMRES keeps JAX's arithmetic: a two-pass modified Gram-Schmidt against
the whole static (m+1, n) basis under an index mask, and the Givens
rotations of the small Hessenberg least-squares problem on the device in
the solve's precision (``kernels/arnoldi_lsq.py``: one hand-written CUDA
kernel launch per iteration on the card).  Only the end of a restart
cycle reads the host: (H, g, j, converged) in one transfer, and the
identity-padded triangular solve there, by LAPACK's trsv as before (its
bits, which no order on the card reproduces: see kernels/arnoldi_lsq.py).
Vectors may be tensors or tuples of tensors (flattened in order, as
``jax.flatten_util.ravel_pytree`` does).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import scipy.linalg
import torch

from navierstokes_tpu_torch.kernels.arnoldi_lsq import lsq_update

# Iterations per block between two host reads.  At the bench point of
# chip_smoke.py (2D-2, 1,014,414 DoF) a projection step takes 3-6
# BiCGStab and 47-53 CG iterations; FGMRES's outer solve 21-39.
BICGSTAB_CHECK_EVERY = 2
CG_CHECK_EVERY = 8
GMRES_CHECK_EVERY = 4


class KrylovResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    residual: torch.Tensor   # final residual norm (0-d)
    converged: bool


def _host(t: torch.Tensor):
    """The loops' one way to the host: a flag, or a few scalars stacked
    into one tensor, read in a single transfer."""
    return t.tolist()


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


def _commit(active, pairs):
    """state <- where(active, new, state) for each (state, new), in
    place."""
    for old, new in pairs:
        old.copy_(torch.where(active, new, old))


class _Loop:
    """Device state of a blocked Krylov loop: ``k`` (iterations), ``active``
    (the loop predicate), ``target``; ``blocks`` counts the blocks run and
    ``reads`` the host reads made by ``run``."""

    check_every = 1

    def run(self):
        """Blocks of ``check_every`` masked iterations until the flag read
        after a block is down."""
        while True:
            self.block()
            self.reads += 1
            if not _host(self.active):
                return self

    def block(self):
        """``check_every`` masked iterations, in place; no host read."""
        for _ in range(self.check_every):
            self._iteration()
        self.blocks += 1
        return self

    def result(self) -> KrylovResult:
        """x, and the count and convergence read in one transfer."""
        res = self.residual()
        k, conv = _host(torch.stack([self.k.to(res.dtype),
                                     (res <= self.target).to(res.dtype)]))
        return KrylovResult(self.unravel(self.x), int(k), res, bool(conv))

    def residual(self):
        return torch.linalg.norm(self.r)


class BicgstabLoop(_Loop):
    """Right-preconditioned BiCGStab (two matvecs per iteration) as device
    state.  Constructing it is the set-up (the initial residual, the
    target, the first predicate)."""

    check_every = BICGSTAB_CHECK_EVERY

    def __init__(self, matvec: Callable, b, x0=None, *, tol=1e-6, atol=0.0,
                 maxiter=100, precond: Optional[Callable] = None):
        b_flat, self.unravel, self.mv, self.pc = _flat_system(b, matvec,
                                                              precond)
        dt, dev = b_flat.dtype, b_flat.device
        self.maxiter = maxiter
        x = torch.zeros_like(b_flat) if x0 is None else _ravel(x0)[0]
        self.x = x.clone()
        self.r0 = b_flat - self.mv(self.x)          # the shadow residual
        self.r = self.r0.clone()
        self.target = torch.clamp(tol * torch.linalg.norm(b_flat), min=atol)
        one = torch.ones((), dtype=dt, device=dev)
        self.rho, self.alpha, self.omega = one.clone(), one.clone(), one
        self.v = torch.zeros_like(b_flat)
        self.p = torch.zeros_like(b_flat)
        self.eps = torch.full((), 1e-30, dtype=dt, device=dev)
        self.k = torch.zeros((), dtype=torch.int64, device=dev)
        self.stag = torch.zeros((), dtype=torch.bool, device=dev)
        self.active = torch.zeros((), dtype=torch.bool, device=dev)
        self.blocks = self.reads = 0
        self._predicate()

    def _predicate(self):
        self.active.copy_((torch.linalg.norm(self.r) > self.target)
                          & ~self.stag & (self.k < self.maxiter))

    def _iteration(self):
        eps, r0, r = self.eps, self.r0, self.r
        safe = lambda a: torch.where(a.abs() > eps, a, eps)
        rho_new = r0 @ r
        beta = (rho_new / safe(self.rho)) * (self.alpha / safe(self.omega))
        p = r + beta * (self.p - self.omega * self.v)
        phat = self.pc(p)
        v = self.mv(phat)
        denom = r0 @ v
        alpha = rho_new / safe(denom)
        s = r - alpha * v
        shat = self.pc(s)
        t = self.mv(shat)
        tt = t @ t
        omega = (t @ s) / torch.where(tt > eps, tt, eps)
        x = self.x + alpha * phat + omega * shat
        r_new = s - omega * t
        # breakdown guard: stops the loop cleanly
        stag = (rho_new.abs() <= eps) | (denom.abs() <= eps)
        a = self.active
        _commit(a, ((self.x, x), (self.r, r_new), (self.rho, rho_new),
                    (self.alpha, alpha), (self.omega, omega), (self.v, v),
                    (self.p, p), (self.stag, stag)))
        self.k.add_(a)
        self._predicate()


class CgLoop(_Loop):
    """Preconditioned conjugate gradient for SPD operators as device
    state."""

    check_every = CG_CHECK_EVERY

    def __init__(self, matvec: Callable, b, x0=None, *, tol=1e-6, atol=0.0,
                 maxiter=100, precond: Optional[Callable] = None):
        b_flat, self.unravel, self.mv, self.pc = _flat_system(b, matvec,
                                                              precond)
        dev = b_flat.device
        self.maxiter = maxiter
        x = torch.zeros_like(b_flat) if x0 is None else _ravel(x0)[0]
        self.x = x.clone()
        self.r = b_flat - self.mv(self.x)
        z = self.pc(self.r)
        self.p = z.clone()
        self.rz = self.r @ z
        self.target = torch.clamp(tol * torch.linalg.norm(b_flat), min=atol)
        self.k = torch.zeros((), dtype=torch.int64, device=dev)
        self.active = torch.zeros((), dtype=torch.bool, device=dev)
        self.blocks = self.reads = 0
        self._predicate()

    def _predicate(self):
        self.active.copy_((torch.linalg.norm(self.r) > self.target)
                          & (self.k < self.maxiter))

    def _iteration(self):
        p, rz = self.p, self.rz
        Ap = self.mv(p)
        alpha = rz / torch.clamp(p @ Ap, min=1e-30)
        x = self.x + alpha * p
        r = self.r - alpha * Ap
        z = self.pc(r)
        rz_new = r @ z
        beta = rz_new / torch.clamp(rz, min=1e-30)
        p_new = z + beta * p
        a = self.active
        _commit(a, ((self.x, x), (self.r, r), (self.p, p_new),
                    (self.rz, rz_new)))
        self.k.add_(a)
        self._predicate()


def bicgstab(matvec: Callable, b, x0=None, *, tol=1e-6, atol=0.0,
             maxiter=100, precond: Optional[Callable] = None
             ) -> KrylovResult:
    """Right-preconditioned BiCGStab (two matvecs per iteration)."""
    return BicgstabLoop(matvec, b, x0, tol=tol, atol=atol, maxiter=maxiter,
                        precond=precond).run().result()


def cg(matvec: Callable, b, x0=None, *, tol=1e-6, atol=0.0, maxiter=100,
       precond: Optional[Callable] = None) -> KrylovResult:
    """Preconditioned conjugate gradient for SPD operators."""
    return CgLoop(matvec, b, x0, tol=tol, atol=atol, maxiter=maxiter,
                  precond=precond).run().result()


def gmres(matvec: Callable, b, x0=None, *, tol=1e-6, atol=0.0, restart=30,
          maxiter=100, precond: Optional[Callable] = None,
          flexible=False) -> KrylovResult:
    """(F)GMRES with right preconditioning.

    ``restart`` is the Krylov dimension m; ``maxiter`` caps the total
    number of iterations across restart cycles.  ``flexible=True`` keeps
    the preconditioned vectors Z_j (FGMRES), so the preconditioner may be
    an iterative solve.  The (m+1, n) basis, the (m, n) Z and the
    Hessenberg state are allocated once per solve and zeroed at each
    cycle; a cycle's ``j``, ``res`` and ``active`` are device scalars.
    The host reads the flag after each block of ``GMRES_CHECK_EVERY``
    Arnoldi iterations, and (H, g, j, converged) once at the end of each cycle,
    where it solves the triangular system."""
    b_flat, unravel, mv, pc = _flat_system(b, matvec, precond)
    n = b_flat.numel()
    dtype, dev = b_flat.dtype, b_flat.device
    npdt = np.float64 if dtype == torch.float64 else np.float32
    ce = GMRES_CHECK_EVERY
    x = torch.zeros_like(b_flat) if x0 is None else _ravel(x0)[0]
    target = torch.clamp(tol * torch.linalg.norm(b_flat), min=atol)
    m = restart
    V = torch.empty((m + 1, n), dtype=dtype, device=dev)
    Z = torch.empty((m, n), dtype=dtype, device=dev) if flexible else None
    rows = torch.arange(m + 1, device=dev)
    H = torch.empty((m + 1, m), dtype=dtype, device=dev)
    cs = torch.empty(m, dtype=dtype, device=dev)
    sn = torch.empty(m, dtype=dtype, device=dev)
    g = torch.empty(m + 1, dtype=dtype, device=dev)
    j = torch.zeros((), dtype=torch.int32, device=dev)
    res = torch.full((), float("inf"), dtype=dtype, device=dev)
    active = torch.zeros((), dtype=torch.bool, device=dev)

    def arnoldi(j_max):
        jl = j.long().view(1)
        z = pc(V.index_select(0, jl)[0])
        w = mv(z)
        if flexible:
            jz = torch.clamp(jl, max=m - 1)
            Z.index_copy_(0, jz, torch.where(
                active, z, Z.index_select(0, jz)[0])[None])
        # two-pass modified Gram-Schmidt over the whole basis, masked
        mask = (rows <= j).to(dtype)
        h1 = (V @ w) * mask
        w = w - h1 @ V
        h2 = (V @ w) * mask
        w = w - h2 @ V
        wnorm = torch.linalg.norm(w)
        j1 = torch.clamp(jl + 1, max=m)
        V.index_copy_(0, j1, torch.where(
            active, w / torch.clamp(wnorm, min=1e-30),
            V.index_select(0, j1)[0])[None])
        # the stored Givens rotations, the new one, g, H[:, j], res, j and
        # the flag, under the flag
        lsq_update(H, cs, sn, g, h1 + h2, wnorm, j, res, active, target,
                   j_max)

    def cycle(x, total_iters):
        r0 = b_flat - mv(x)
        beta = torch.linalg.norm(r0)
        V.zero_()
        V[0] = torch.where(beta > 0, r0 / torch.clamp(beta, min=1e-30),
                           torch.zeros_like(r0))
        if flexible:
            Z.zero_()
        for t in (H, cs, sn, g):
            t.zero_()
        g[0] = beta
        res.copy_(beta)
        j.zero_()
        j_max = min(m, maxiter - total_iters)
        active.copy_((res > target) & (j_max > 0))
        while True:
            for _ in range(ce):
                arnoldi(j_max)
            if not _host(active):
                break
        # the j x j upper-triangular system, padded to m with the identity,
        # on the host in the solve's precision
        vals = np.asarray(_host(torch.cat([
            H[:m].reshape(-1), g[:m], j.to(dtype)[None],
            (res <= target).to(dtype)[None]])), npdt)
        jj, conv = int(vals[-2]), bool(vals[-1])
        act = np.arange(m) < jj
        R = np.where(act[None, :] & act[:, None],
                     vals[:m * m].reshape(m, m), np.eye(m, dtype=npdt))
        y = scipy.linalg.solve_triangular(
            R, np.where(act, vals[m * m:m * m + m], 0.0), lower=False)
        yt = torch.as_tensor(y.astype(npdt), device=dev)
        dx = yt @ Z if flexible else pc(yt @ V[:m])
        return x + dx, total_iters + jj, conv

    iters, conv = 0, False
    while not conv and iters < maxiter:
        x, iters, conv = cycle(x, iters)
    return KrylovResult(unravel(x), iters, res.clone(), conv)


def fgmres(matvec: Callable, b, x0=None, **kw) -> KrylovResult:
    """Flexible GMRES: ``gmres(..., flexible=True)``."""
    return gmres(matvec, b, x0, flexible=True, **kw)
