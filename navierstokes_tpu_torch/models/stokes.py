"""Steady Stokes solver on the generic element ("cells") operator.

Port of ``navierstokes_tpu/models/stokes.py``.  The reference has no
Stokes solver of its own (the Stokes operator is the nu K + pressure
coupling part of its assembly, src/NavierStokes.cpp:196-229); this one
backs the manufactured-solution convergence checks of the Taylor-Hood
pairs (P2/P1, P3/P2, ...):

    [ nu K   G ] [u]   [ f ]
    [ G^T    0 ] [p] = [ 0 ]     with Dirichlet velocity BCs,

by FGMRES with the aSIMPLE block preconditioner on the element operator
of ops/operators.py (batched einsums plus fixed-order segment sums).
"""

from __future__ import annotations

import numpy as np
import torch

from navierstokes_tpu_torch.config import SolverConfig
from navierstokes_tpu_torch.fem.spaces import TaylorHoodSpace
from navierstokes_tpu_torch.mesh.geometry import Mesh
from navierstokes_tpu_torch.models.navier_stokes import (_DTYPES,
                                                         _resolve_device)
from navierstokes_tpu_torch.ops.assembly import build_cell_arrays
from navierstokes_tpu_torch.ops.operators import (apply_blocks, f_diag,
                                                  schur_diag, segment_plan)
from navierstokes_tpu_torch.solvers.krylov import fgmres
from navierstokes_tpu_torch.solvers.preconditioners import (InnerSolve,
                                                            make_asimple)


class StokesSolver:
    """``StokesSolver(mesh, nu, config, degree_velocity, degree_pressure,
    device="cuda")``; ``config.dtype`` sets the compute dtype."""

    def __init__(self, mesh: Mesh, nu: float = 1.0,
                 config: SolverConfig | None = None,
                 degree_velocity: int = 2, degree_pressure: int = 1,
                 device="cuda"):
        self.config = config or SolverConfig()
        self.nu = nu
        self.mesh = mesh
        self.device = _resolve_device(device)
        self.dtype = _DTYPES[self.config.dtype]
        self.space = sp = TaylorHoodSpace(mesh, degree_velocity,
                                          degree_pressure)
        self.cells = build_cell_arrays(sp, self.dtype, self.device)
        self.scat_v = segment_plan(sp.cell_p2, sp.n_p2, self.device)
        self.scat_p = segment_plan(sp.cell_p1, sp.n_p1, self.device)

    def solve(self, dirichlet_nodes: np.ndarray, dirichlet_values: np.ndarray,
              rhs_u=None, pin_pressure: bool = True, tol: float = 1e-10,
              maxiter: int = 400):
        """``dirichlet_nodes``: velocity-node ids with prescribed values
        ``dirichlet_values`` (n_dir, dim); ``rhs_u`` (n_p2, dim) the
        momentum RHS (e.g. ops/assembly.forcing_rhs).  With Dirichlet
        data on the whole boundary the pressure is defined up to a
        constant: ``pin_pressure`` removes its mean after the solve.
        Returns (u (n_p2, dim), p (n_p1,)) as numpy arrays and the FGMRES
        result."""
        sp, dim = self.space, self.space.dim
        kw = dict(dtype=self.dtype, device=self.device)
        mask_np = np.ones((sp.n_p2, 1))
        mask_np[dirichlet_nodes] = 0.0
        g_np = np.zeros((sp.n_p2, dim))
        g_np[dirichlet_nodes] = dirichlet_values
        mask = torch.as_tensor(mask_np, **kw)
        g = torch.as_tensor(g_np, **kw)

        cells, scat_v, scat_p = self.cells, self.scat_v, self.scat_p
        f_cell = self.nu * cells.stiff
        zero_u = torch.zeros((sp.n_p2, dim), **kw)
        zero_p = torch.zeros(sp.n_p1, **kw)

        d = f_diag(cells, f_cell, scat_v)
        mflat = mask[:, 0]
        sigma = torch.sum(d * mflat) / torch.clamp(torch.sum(mflat), min=1.0)
        dinv = (1.0 / (d * mflat + sigma * (1.0 - mflat)))[:, None]

        def blocks(xu, xp, **which):
            return apply_blocks(cells, f_cell, scat_v, scat_p, xu, xp,
                                **which)

        def apply_A(x):
            xu, xp = x
            xum = xu * mask
            yu, yp = blocks(xum, xp)
            return yu * mask + sigma * (xu - xum), yp

        def apply_F(xu):
            xum = xu * mask
            yu, _ = blocks(xum, zero_p, with_g=False, with_gt=False)
            return yu * mask + sigma * (xu - xum)

        def apply_B(xu):
            return blocks(xu * mask, zero_p, with_f=False, with_g=False)[1]

        def apply_Bt(xp):
            return blocks(zero_u, xp, with_f=False, with_gt=False)[0] * mask

        b_u = zero_u if rhs_u is None else torch.as_tensor(
            np.asarray(rhs_u), **kw)
        ag_u, ag_p = blocks(g, zero_p)
        b = ((b_u - ag_u) * mask + sigma * g, -ag_p)

        diag_s = schur_diag(cells, dinv[:, 0] * mflat, scat_p)
        M = make_asimple(apply_F, apply_B, apply_Bt, dinv, diag_s, 1.0,
                         InnerSolve(1e-3, 50), InnerSolve(1e-3, 50))
        res = fgmres(apply_A, b, tol=tol, restart=60, maxiter=maxiter,
                     precond=M)
        u, p = res.x
        u = u * mask + g
        if pin_pressure:
            p = p - torch.mean(p)
        return u.cpu().numpy(), p.cpu().numpy(), res
