"""L2 error norms of discrete fields against exact ones (host, numpy).

The port's copy of ``navierstokes_tpu/fem/interpolation.py``: the
manufactured-solution checks of the Taylor-Hood discretisation (P2/P1:
O(h^3) velocity, O(h^2) pressure; P3/P2 one order more), which the
reference does not automate.
"""

from __future__ import annotations

import numpy as np

from navierstokes_tpu_torch.fem.spaces import TaylorHoodSpace
from navierstokes_tpu_torch.ops.assembly import quadrature_points


def l2_error_velocity(space: TaylorHoodSpace, u, exact_fn) -> float:
    """|| u_h - u ||_L2 of the velocity field u_h (n_p2, dim)."""
    rs = space.rs
    detj, xq = quadrature_points(space)
    u_c = np.asarray(u)[np.asarray(space.cell_p2)]      # (nc, n_v, dim)
    uh_q = np.einsum("qa,cad->cqd", rs.phi_v, u_c)
    ue_q = exact_fn(xq.reshape(-1, space.dim)).reshape(uh_q.shape)
    err2 = np.einsum("q,cqd,c->", rs.qw, (uh_q - ue_q) ** 2, detj)
    return float(np.sqrt(err2))


def l2_error_pressure(space: TaylorHoodSpace, p, exact_fn,
                      zero_mean: bool = True) -> float:
    """|| p_h - p ||_L2 of the pressure field p_h (n_p1,); with
    ``zero_mean`` both fields are shifted to zero mean first (an enclosed
    flow's pressure is defined up to a constant)."""
    rs = space.rs
    detj, xq = quadrature_points(space)
    p_c = np.asarray(p)[np.asarray(space.cell_p1)]      # (nc, n_p)
    ph_q = np.einsum("qj,cj->cq", rs.phi_p, p_c)
    pe_q = exact_fn(xq.reshape(-1, space.dim)).reshape(ph_q.shape)
    if zero_mean:
        vol = float(np.einsum("q,c->", rs.qw, detj))
        ph_q = ph_q - np.einsum("q,cq,c->", rs.qw, ph_q, detj) / vol
        pe_q = pe_q - np.einsum("q,cq,c->", rs.qw, pe_q, detj) / vol
    err2 = np.einsum("q,cq,c->", rs.qw, (ph_q - pe_q) ** 2, detj)
    return float(np.sqrt(err2))
