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


def refine_saddle(ops, bsr64, f64, mask, sigma, b64, x, solve_fn,
                  n_passes: int):
    """``n_passes`` of refinement from the fp32 solution ``x`` = (u, p).
    ``f64``, ``mask`` and ``sigma`` are float64 casts of the fp32 step's
    values; ``solve_fn((ru, rp)) -> (du, dp)`` is the fp32 correction
    solve.  Returns ((u, p) rounded to fp32, the fp32 norm of the final
    true residual)."""
    dtype = x[0].dtype
    b_u, b_p = b64
    xu, xp = x[0].double(), x[1].double()

    def residual():
        au, ap = apply_saddle_f64(ops, bsr64, f64, mask, sigma, xu, xp)
        return (b_u - au).to(dtype), (b_p - ap).to(dtype)

    for _ in range(n_passes):
        du, dp = solve_fn(residual())
        xu = xu + du.double()
        xp = xp + dp.double()
    ru, rp = residual()
    res = torch.sqrt(torch.sum(ru * ru) + torch.sum(rp * rp))
    return (xu.to(dtype), xp.to(dtype)), res
