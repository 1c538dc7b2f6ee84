"""Drag/lift boundary integrals on the obstacle.

Port of ``navierstokes_tpu/ops/forces.py`` (formula parity with
src/NavierStokes.cpp:879-922): with outward unit normal n and tangent
t = (ny, -nx[, 0]),

    drag += [ nu * ngt * ny - p * nx ] * JxW
    lift -= [ nu * ngt * nx + p * ny ] * JxW

where ngt is n . grad(u) . t ("reference") or t . grad(u) . n ("st",
the Schaefer-Turek definition), then Cd/Cl = -2 (drag, lift) / (U^2 D),
divided by ``span_3d`` more in 3D (cpp:913-917).  ``neumann_rhs`` is the
outlet-pressure term of the momentum RHS (cpp:257-278).
"""

from __future__ import annotations

import torch

from navierstokes_tpu_torch.ops.assembly import FaceArrays
from navierstokes_tpu_torch.ops.operators import SegmentPlan


def drag_lift(faces: FaceArrays, u, p, nu, formula: str = "reference"):
    """Raw (drag, lift) integrals over the faces; u (n_p2, dim), p (n_p1,)."""
    u_f = u[faces.vel_nodes]                              # (nf, n_v, dim)
    p_f = p[faces.p_nodes]                                # (nf, n_p)
    grad_u = torch.einsum("fia,fqib->fqab", u_f, faces.dphi_phys)
    p_q = torch.einsum("fj,fqj->fq", p_f, faces.phi_p)
    n = faces.normals
    if n.shape[-1] == 2:
        t = torch.stack([n[..., 1], -n[..., 0]], dim=-1)
    else:
        t = torch.stack([n[..., 1], -n[..., 0], torch.zeros_like(n[..., 0])],
                        dim=-1)
    if formula == "st":
        ngt = torch.einsum("fqa,fqab,fqb->fq", t, grad_u, n)
    else:
        ngt = torch.einsum("fqa,fqab,fqb->fq", n, grad_u, t)
    jxw = faces.jxw
    nx, ny = n[..., 0], n[..., 1]
    drag = torch.sum((nu * ngt * ny - p_q * nx) * jxw)
    lift = -torch.sum((nu * ngt * nx + p_q * ny) * jxw)
    return drag, lift


def force_coefficients(drag, lift, u_mean, ref_length, dim, span_3d=0.41):
    """Cd/Cl from the raw integrals (cpp:913-922); the denominator is
    clamped so a pulsating inlet's sin ~ 0 crossings stay finite."""
    denom = u_mean * u_mean * ref_length
    if dim == 3:
        denom = denom * span_3d
    if isinstance(denom, torch.Tensor):
        denom = torch.clamp(denom.abs(), min=1e-12)
    else:
        denom = max(abs(denom), 1e-12)
    return 2.0 * -drag / denom, 2.0 * -lift / denom


def neumann_rhs(faces: FaceArrays, p_out: float, plan: SegmentPlan):
    """Outflow Neumann RHS -p_out * int_{Gamma_out} (n . v): (n_p2, dim).
    ``plan`` sums the (face, node) entries into the nodes in a fixed order
    (a segment plan over ``faces.vel_nodes``), so the sum is the same bits
    on every run."""
    r = -p_out * torch.einsum("fq,fqa,fqd->fad", faces.jxw, faces.phi_v,
                              faces.normals)
    return plan(r.reshape(-1, r.shape[-1]))
