"""Krylov solvers: (flexible) GMRES, right-preconditioned BiCGStab and
preconditioned CG.

Port of ``navierstokes_tpu/solvers/krylov.py`` with the same stopping
rules (||r|| <= max(tol ||b||, atol) or the iteration budget), the same
BiCGStab breakdown guard and the same iteration counting.

The counterpart of JAX's ``lax.while_loop``: every loop keeps its whole
state on the device in fixed-shape tensors, the iteration count and the
loop predicate ``active`` (JAX's ``cond``: ``||r|| > target``, no
breakdown, ``k < maxiter``) included.  Each iteration commits its update
only while ``active`` is up, adding ``active`` to the count, so an
iteration run after the stop changes no bit: BiCGStab's and CG's vector
updates and scalars are one fused stage each between the products
(kernels/krylov_update.py: one launch per stage on the card; the plain
version's ``torch.where(active, new, old)`` on the CPU); CG's stages take
its dots and the norm its predicate reads, so ``CgLoop.residual`` returns
that norm, taken as float64 sums rounded once.  An iteration's
last launch is the predicate (kernels/conditional.set_condition: one
launch on the card, which also sets a while node's condition; FGMRES's
Givens kernel writes its flag itself).  How a loop runs its iterations under its
flag is the ``Mode`` in force (``iteration_mode``):

* ``MASKED`` (the default): blocks of ``check_every`` iterations
  (``BICGSTAB_CHECK_EVERY``, ``CG_CHECK_EVERY``, ``GMRES_CHECK_EVERY``),
  the flag read on the host after each block (``_host``); counts and
  results equal a block size of 1 at every block size.  The standalone
  solvers and the models that step eagerly by rule (row shards).
* ``HOST``: the flag read before each iteration, which runs only while
  it is up.  The plain step of a model whose step is captured, in both
  schemes: it launches exactly what its captured version launches.
* ``GRAPH``: the loop captured as one CUDA graph conditional *while*
  node on its flag, whose body is one iteration (``Mode.loop``): the body
  runs exactly as often as the loop iterates, no host read inside.  The
  captured step (models/step_graphs.py); FGMRES's host reads only at the
  end of each restart cycle.
* ``DRY``: GRAPH rehearsed on any device: the flag looked at before the
  first body and after each (not counted as a read), the loops entered,
  bodies run and tests counted (the CPU tests).

The state is updated in place, so a block can be captured as a CUDA graph
and replayed (models/step_graphs.py).

GMRES keeps JAX's arithmetic: a two-pass modified Gram-Schmidt of the
new vector against rows 0..j of the static (m+1, n) basis
(``kernels/gram_schmidt.py``: on the card four launches that read j from
the device and touch those rows only, on a basis whose rows are padded
to 128-byte boundaries; the JAX body's masked whole-basis
products on the CPU; products summed in float64 for float32 data), and
the Givens rotations of the small Hessenberg least-squares problem on the device in
the solve's precision (``kernels/arnoldi_lsq.py``: one hand-written CUDA
kernel launch per iteration on the card, its bounds read from the
device).  Only the end of a restart cycle reads the host: (H, g, j,
converged) in one transfer, and the identity-padded triangular solve
there, by LAPACK's trsv as before (its bits, which no order on the card
reproduces: see kernels/arnoldi_lsq.py).  Vectors may be tensors or
tuples of tensors (flattened in order, as ``jax.flatten_util.ravel_pytree``
does).
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple, Optional

import numpy as np
import scipy.linalg
import torch

from navierstokes_tpu_torch.kernels.arnoldi_lsq import lsq_update
from navierstokes_tpu_torch.kernels.conditional import set_condition
from navierstokes_tpu_torch.kernels.gram_schmidt import (basis,
                                                         gram_schmidt,
                                                         padded, workspace)
from navierstokes_tpu_torch.kernels.krylov_update import (dot, norm,
                                                          update)

# Iterations per block between two host reads (MASKED).  At the bench
# point of chip_smoke.py (2D-2, 1,014,414 DoF) a projection step takes
# 3-6 BiCGStab and 47-53 CG iterations; FGMRES's outer solve 21-39.
BICGSTAB_CHECK_EVERY = 2
CG_CHECK_EVERY = 8
GMRES_CHECK_EVERY = 4

MASKED, HOST, GRAPH, DRY = "masked", "host", "graph", "dry"


class Mode:
    """How the loops run their iterations under their flags (``kind``, see
    the module docstring) and what they counted: ``reads``, the loops'
    host reads; under DRY the loops ``entered``, the bodies ``runs`` and
    the ``tests`` of a flag (before each loop and after each body).  Under
    GRAPH, ``whiles`` (kernels/conditional.WhileNodes) adds the nodes to
    the capture in progress; node i keeps its body's launch record
    (``records[i]``), its enclosing node (``parents[i]``; -1 at the top of
    the segment ``segments[i]``, the ``segment`` being captured) and three
    counters on the device, ``tally[i]``: the node's evaluations, those
    that let the body run, and bodies run under a down flag (advanced by
    the condition kernels themselves)."""

    def __init__(self, kind: str = MASKED, whiles=None, capacity: int = 32):
        self.kind = kind
        self.reads = self.entered = self.runs = self.tests = 0
        self.whiles = whiles
        self.records, self.parents, self.segments = [], [], []
        self.segment = None
        self._open = []
        self.tally = (torch.zeros((capacity, 3), dtype=torch.int64,
                                  device=whiles.device)
                      if kind == GRAPH else None)

    def loop(self, flag, body):
        """A while loop on ``flag``: ``body(cond)``, one iteration whose
        last launch is its predicate (returns whether that set the node's
        condition ``cond``), while the flag is up, tested before the first
        body and after each: one while node (GRAPH), or run on any device
        (DRY)."""
        if self.kind == DRY:
            self.entered += 1
            self.tests += 1
            while bool(flag):
                self.runs += 1
                body(None)
                self.tests += 1
            return
        i = len(self.records)
        if i == self.tally.shape[0]:
            raise RuntimeError(f"more than {i} while nodes in one model's "
                               "captures")
        self.records.append(None)
        self.parents.append(self._open[-1] if self._open else -1)
        self.segments.append(self.segment)
        self._open.append(i)
        try:
            self.records[i] = self.whiles.loop(flag, body, self.tally[i])
        finally:
            self._open.pop()


_MODE = [Mode()]


@contextlib.contextmanager
def iteration_mode(mode: Mode):
    """The loops inside run their iterations as ``mode`` says."""
    _MODE.append(mode)
    try:
        yield mode
    finally:
        _MODE.pop()


def _run_loop(loop, body, block):
    """``loop`` to its stop as the mode in force says: ``block()`` until
    the flag read after one is down (MASKED), ``body(None)`` after each
    read of the flag up (HOST), or ``body`` under a while node (GRAPH,
    DRY)."""
    mode = _MODE[-1]
    if mode.kind == MASKED:
        while True:
            block()
            if not _read(loop, loop.active):
                return
    elif mode.kind == HOST:
        while _read(loop, loop.active):
            body(None)
    else:
        mode.loop(loop.active, body)


def _read(loop, t):
    """A host read made by ``loop``, counted in its ``reads`` and the
    mode's."""
    loop.reads += 1
    _MODE[-1].reads += 1
    return _host(t)


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


class _Loop:
    """Device state of a blocked Krylov loop: ``k`` (iterations), ``active``
    (the loop predicate), ``target``; ``blocks`` counts the blocks run and
    ``reads`` the host reads made by ``run``."""

    check_every = 1

    def run(self):
        """The loop to its stop, as the mode in force says
        (``_run_loop``)."""
        _run_loop(self, self._body, self.block)
        return self

    def _body(self, cond=None) -> bool:
        """One iteration and its predicate (see ``Mode.loop``)."""
        self._iteration()
        return self._predicate(cond)

    def block(self):
        """``check_every`` masked iterations, in place; no host read."""
        for _ in range(self.check_every):
            self._body()
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
        self.s = torch.empty_like(b_flat)           # scratch: s = r - alpha v
        self.eps = torch.full((), 1e-30, dtype=dt, device=dev)
        self.k = torch.zeros((), dtype=torch.int64, device=dev)
        self.stag = torch.zeros((), dtype=torch.bool, device=dev)
        self.active = torch.zeros((), dtype=torch.bool, device=dev)
        self.blocks = self.reads = 0
        self._predicate()

    def _predicate(self, cond=None) -> bool:
        return set_condition(self.active, torch.linalg.norm(self.r),
                             self.target, self.k, self.maxiter, self.stag,
                             cond)

    def _iteration(self):
        """JAX's body: p, then s, then x and r with the scalars, the
        breakdown guard and k (kernels/krylov_update.py), each stage
        committed under the flag; the products and dots between them."""
        eps, r0, s, a = self.eps, self.r0, self.s, self.active
        rho_new = r0 @ self.r
        update("bicgstab_p", self.p, self.r, self.v, rho_new, self.rho,
               self.alpha, self.omega, eps, a)
        phat = self.pc(self.p)
        v = self.mv(phat)
        denom = r0 @ v
        update("bicgstab_s", s, self.v, self.r, v, rho_new, denom, eps, a)
        shat = self.pc(s)
        t = self.mv(shat)
        tt = t @ t
        update("bicgstab_xr", self.x, self.r, phat, shat, s, t, rho_new,
               denom, t @ s, tt, eps, self.rho, self.alpha, self.omega,
               self.stag, self.k, a)


class CgLoop(_Loop):
    """Preconditioned conjugate gradient for SPD operators as device
    state.  Its stages take the dots and the norm themselves
    (kernels/krylov_update.py ``dot``, ``norm``: float64 sums rounded
    once), so an iteration launches the product, ``cg_xr``, the
    preconditioner, ``cg_p`` and the predicate; ``rnorm`` is ||r|| of the
    committed r (the set-up's, then ``cg_xr``'s), which the predicate and
    ``residual`` read.  ``pap`` holds the last p.Ap that ``cg_xr``
    committed; nothing in the loop reads it: it is the stage's observable
    dot for the checks (``krylov_update.cg_gate``)."""

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
        self.rz = dot(self.r, z)
        self.pap = torch.zeros_like(self.rz)        # the last p.Ap
        self.rnorm = norm(self.r)
        self.target = torch.clamp(tol * torch.linalg.norm(b_flat), min=atol)
        self.k = torch.zeros((), dtype=torch.int64, device=dev)
        self.active = torch.zeros((), dtype=torch.bool, device=dev)
        self.blocks = self.reads = 0
        self._predicate()

    def _predicate(self, cond=None) -> bool:
        return set_condition(self.active, self.rnorm, self.target, self.k,
                             self.maxiter, cond=cond)

    def _iteration(self):
        """JAX's body: x and r with p.Ap and ||r||, then p with r.z, rz
        and k (kernels/krylov_update.py), each stage committed under the
        flag."""
        p, a = self.p, self.active
        Ap = self.mv(p)
        update("cg_xr", self.x, self.r, p, Ap, self.rz, self.pap,
               self.rnorm, a)
        z = self.pc(self.r)
        update("cg_p", p, z, self.r, self.rz, self.k, a)

    def residual(self):
        return self.rnorm.clone()


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


class GmresLoop:
    """(F)GMRES with right preconditioning as device state in static
    buffers: the (m+1, n) basis V, the (m, n) Z of the preconditioned
    vectors (``flexible``), the Hessenberg state H, cs, sn, g, the
    solution x and the right-hand side b, and the 0-d ``j``, ``res``,
    ``active``, ``target``, the budget ``maxiter``, the iterations of the
    cycles before this one (``total``) and the cycle's bound ``j_max``.
    ``start`` begins a solve on them (the corrections of solvers/refine.py
    reuse the buffers of the outer solve), ``cycle`` begins a restart
    cycle, ``iteration`` is one Arnoldi step, ``end_cycle`` the host's
    part of a cycle's end and ``update`` x += y Z.  ``iterations`` and
    ``converged`` are the host's view, from the cycle ends' reads."""

    def __init__(self, matvec: Callable, b, x0=None, *, tol=1e-6, atol=0.0,
                 restart=30, maxiter=100,
                 precond: Optional[Callable] = None, flexible=False):
        b_flat, self.unravel, self.mv, self.pc = _flat_system(b, matvec,
                                                              precond)
        n, m = b_flat.numel(), restart
        dtype, dev = b_flat.dtype, b_flat.device
        self.m, self.flexible, self.dtype = m, flexible, dtype
        self.b, self.x = torch.empty_like(b_flat), torch.empty_like(b_flat)
        # the padded bases the Gram-Schmidt kernels stage with 16-byte
        # copies (rows 128-byte aligned); the solver sees (rows, n) views
        self.V = basis(m + 1, n, dtype, dev)
        self.Z = basis(m, n, dtype, dev) if flexible else None
        self.H = torch.empty((m + 1, m), dtype=dtype, device=dev)
        self.cs = torch.empty(m, dtype=dtype, device=dev)
        self.sn = torch.empty(m, dtype=dtype, device=dev)
        self.g = torch.empty(m + 1, dtype=dtype, device=dev)
        self.y = torch.zeros(m, dtype=dtype, device=dev)
        # the Gram-Schmidt coefficients of both passes and ||w||, and the
        # kernels' scratch on the card
        self.h1 = torch.zeros(m + 1, dtype=dtype, device=dev)
        self.h2 = torch.zeros(m + 1, dtype=dtype, device=dev)
        self.wnorm = torch.zeros((), dtype=dtype, device=dev)
        self.gs_work = workspace(m, n, dtype, dev)
        i32 = dict(dtype=torch.int32, device=dev)
        self.j, self.j_max = torch.zeros((), **i32), torch.zeros((), **i32)
        self.maxiter, self.total = (torch.zeros((), **i32),
                                    torch.zeros((), **i32))
        self.res = torch.full((), float("inf"), dtype=dtype, device=dev)
        self.target = torch.zeros((), dtype=dtype, device=dev)
        self.active = torch.zeros((), dtype=torch.bool, device=dev)
        self.blocks = self.reads = 0
        self.start(b_flat, x0, tol=tol, atol=atol, maxiter=maxiter)
        self.begin(maxiter)

    def start(self, b, x0=None, *, tol, atol=0.0, maxiter):
        """A new solve on the buffers, on the device: b, x0 (zero if
        None), the target, the budget and the first cycle's set-up."""
        self.b.copy_(_ravel(b)[0])
        if x0 is None:
            self.x.zero_()
        else:
            self.x.copy_(_ravel(x0)[0])
        self.target.copy_(torch.clamp(tol * torch.linalg.norm(self.b),
                                      min=atol))
        self.maxiter.fill_(maxiter)
        self.total.zero_()
        self.cycle()

    def begin(self, maxiter: int):
        """The host's part of a new solve: its view of the count."""
        self.budget, self.iterations, self.converged = maxiter, 0, False

    def cycle(self):
        """A restart cycle's set-up from x: r0, beta, V[0], zeroed Z, H,
        cs, sn and g, g[0] = beta, j = 0, j_max and the flag."""
        r0 = self.b - self.mv(self.x)
        beta = torch.linalg.norm(r0)
        padded(self.V).zero_()
        self.V[0] = torch.where(beta > 0, r0 / torch.clamp(beta, min=1e-30),
                                torch.zeros_like(r0))
        if self.flexible:
            padded(self.Z).zero_()
        for t in (self.H, self.cs, self.sn, self.g):
            t.zero_()
        self.g[0] = beta
        self.res.copy_(beta)
        self.j.zero_()
        self.j_max.copy_(torch.clamp(self.maxiter - self.total, max=self.m))
        self.active.copy_((self.res > self.target) & (self.j_max > 0))

    def iteration(self, cond=None) -> bool:
        """One Arnoldi step, committed under the flag; its last launch,
        the Givens kernel, writes the flag and, given ``cond``, sets the
        while node's condition, one launch fewer per iteration than a
        set_condition after it (PERF.md section 6 gives both times).
        Returns whether it set it."""
        V, j, active = self.V, self.j, self.active
        z = self.pc(V.index_select(0, j.long().view(1))[0])
        w = self.mv(z)
        # two-pass modified Gram-Schmidt against rows 0..j: h1, h2, ||w||,
        # and under the flag V[j+1] = w / ||w|| and (FGMRES) Z[j] = z
        gram_schmidt(V, w, self.h1, self.h2, self.wnorm, j, active,
                     self.gs_work, *((z, self.Z) if self.flexible else ()))
        # h1 + h2, the stored Givens rotations, the new one, g, H[:, j],
        # res, j and the flag, under the flag
        return lsq_update(self.H, self.cs, self.sn, self.g, self.h1, self.h2,
                          self.wnorm, j, self.res, active, self.target,
                          self.j_max, cond=cond)

    def block(self, n: int):
        """``n`` masked iterations, in place; no host read."""
        for _ in range(n):
            self.iteration()
        self.blocks += 1

    def iterate(self):
        """The cycle's iterations to its stop, as the mode in force says
        (``_run_loop``; MASKED in blocks of GMRES_CHECK_EVERY)."""
        _run_loop(self, self.iteration,
                  lambda: self.block(GMRES_CHECK_EVERY))

    def end_cycle(self) -> bool:
        """The host's part of a cycle's end: (H, g, j, converged) read in
        one transfer, the j x j upper-triangular system, padded to m with
        the identity, solved by LAPACK in the solve's precision, and y
        written to its device buffer.  Returns whether the solve is
        done."""
        m, dtype = self.m, self.dtype
        npdt = np.float64 if dtype == torch.float64 else np.float32
        parts = [self.H[:m].reshape(-1), self.g[:m], self.j.to(dtype)[None],
                 (self.res <= self.target).to(dtype)[None]]
        vals = np.asarray(_read(self, torch.cat(parts)), npdt)
        jj, conv = int(vals[m * m + m]), bool(vals[m * m + m + 1])
        act = np.arange(m) < jj
        R = np.where(act[None, :] & act[:, None],
                     vals[:m * m].reshape(m, m), np.eye(m, dtype=npdt))
        y = scipy.linalg.solve_triangular(
            R, np.where(act, vals[m * m:m * m + m], 0.0), lower=False)
        self.y.copy_(torch.as_tensor(y.astype(npdt)))
        self.iterations += jj
        self.converged = conv
        return conv or self.iterations >= self.budget

    def update(self):
        """x += y Z (or the preconditioned y V) and the cycle's j added to
        ``total``, on the device."""
        if self.flexible:
            dx = self.y @ self.Z
        else:
            dx = self.pc(self.y @ self.V[:self.m])
        self.x.copy_(self.x + dx)
        self.total.add_(self.j)

    def run(self):
        """Cycles to convergence or the budget, the host deciding at each
        cycle's end (``iterate`` runs a cycle's iterations)."""
        while True:
            self.iterate()
            done = self.end_cycle()
            self.update()
            if done:
                return self
            self.cycle()

    def solution(self):
        """x, unravelled (views of the static buffer)."""
        return self.unravel(self.x)

    def outcome(self):
        """(iterations, residual estimate |g[j]|, converged) of the solve,
        on the device."""
        return self.total.clone(), self.res.clone(), self.res <= self.target

    def result(self) -> KrylovResult:
        return KrylovResult(self.solution(), self.iterations,
                            self.res.clone(), self.converged)


def gmres(matvec: Callable, b, x0=None, *, tol=1e-6, atol=0.0, restart=30,
          maxiter=100, precond: Optional[Callable] = None,
          flexible=False) -> KrylovResult:
    """(F)GMRES with right preconditioning (``GmresLoop``).

    ``restart`` is the Krylov dimension m; ``maxiter`` caps the total
    number of iterations across restart cycles.  ``flexible=True`` keeps
    the preconditioned vectors Z_j (FGMRES), so the preconditioner may be
    an iterative solve.  Under MASKED the host reads the flag after each
    block of ``GMRES_CHECK_EVERY`` Arnoldi iterations, and (H, g, j,
    converged) once at the end of each cycle, where it solves the
    triangular system."""
    return GmresLoop(matvec, b, x0, tol=tol, atol=atol, restart=restart,
                     maxiter=maxiter, precond=precond,
                     flexible=flexible).run().result()


def fgmres(matvec: Callable, b, x0=None, **kw) -> KrylovResult:
    """Flexible GMRES: ``gmres(..., flexible=True)``."""
    return gmres(matvec, b, x0, flexible=True, **kw)
