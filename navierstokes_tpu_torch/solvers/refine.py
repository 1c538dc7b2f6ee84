"""Iterative refinement of the monolithic saddle-point solve in float64.

Port of ``navierstokes_tpu/solvers/refine.py``.  An fp32 FGMRES solve
floors near 3e-6 ||b||, which washes out small force coefficients (2D-1
lift).  Classic mixed-precision refinement lifts that floor: the residual
of the BC-masked block system is evaluated in float64, and each correction
is an ordinary fp32 FGMRES solve with the step's preconditioner.  The JAX
package evaluates the residual in double-float (two fp32s, its TPU has no
fast float64); the port uses native float64 through the fp64 SpMV variant,
on exact float64 copies of the fp32 operator values
(``ops/bsr.float64_tables``), so the system refined is exactly the fp32
system being solved.
"""

from __future__ import annotations

import numpy as np
import torch


def apply_saddle_f64(ops, bsr64, f64, mask, sigma, xu, xp):
    """The BC-masked monolithic operator (the step's apply_A) in float64:
    yu = (F xu_m + G xp) * mask + sigma (xu - xu_m);  yp = B xu_m.
    ``ops`` is the model's operator interface (ops/bsr.BsrOps or the
    row-sharded parallel/sharded_bsr.ShardedBsrOps), ``bsr64`` its tables
    with float64 static values (``ops.float64_tables``)."""
    xum = xu * mask
    yu = (ops.apply_f(bsr64, f64, xum) + ops.apply_bt(bsr64, xp)) * mask \
        + sigma * (xu - xum)
    return yu, ops.apply_b(bsr64, xum)


def rhs_f64(ops, bsr64, f64, mask, sigma, u, g, dt: float, neumann=None,
            extra=None):
    """The step RHS in float64: b_u = (M u / dt [+ neumann] [+ extra] -
    F g) * mask + sigma g, b_p = -(B g), with the fp32 system's dt;
    ``neumann`` (the p_out term) and ``extra`` (the forcing integral) are
    the fp32 step's vectors."""
    u, g = u.double(), g.double()
    b_u = ops.mass_apply(bsr64, u) / float(np.float32(dt))
    for term in (neumann, extra):
        if term is not None:
            b_u = b_u + term.double()
    b_u = (b_u - ops.apply_f(bsr64, f64, g)) * mask + sigma * g
    return b_u, -ops.apply_b(bsr64, g)


class Refinement:
    """Refinement's state: the float64 iterate (xu, xp), started from the
    fp32 solution ``x`` = (u, p), with ``residual`` (the fp32 right-hand
    side of the next correction), ``add`` (a correction, in place) and
    ``result``.  ``f64``, ``mask`` and ``sigma`` are float64 casts of the
    fp32 step's values.  In place, so that the captured step
    (models/step_graphs.py) keeps it in static buffers."""

    def __init__(self, ops, bsr64, f64, mask, sigma, b64, x):
        self.ops, self.bsr64 = ops, bsr64
        self.f64, self.mask, self.sigma = f64, mask, sigma
        self.b_u, self.b_p = b64
        self.dtype = x[0].dtype
        self.xu = x[0].to(torch.float64, copy=True)
        self.xp = x[1].to(torch.float64, copy=True)

    def residual(self):
        au, ap = apply_saddle_f64(self.ops, self.bsr64, self.f64, self.mask,
                                  self.sigma, self.xu, self.xp)
        return (self.b_u - au).to(self.dtype), (self.b_p - ap).to(self.dtype)

    def add(self, d):
        du, dp = d
        self.xu.copy_(self.xu + du.double())
        self.xp.copy_(self.xp + dp.double())

    def result(self):
        """((u, p) rounded to fp32, the fp32 norm of the true residual)."""
        ru, rp = self.residual()
        res = torch.sqrt(torch.sum(ru * ru) + torch.sum(rp * rp))
        return (self.xu.to(self.dtype), self.xp.to(self.dtype)), res

