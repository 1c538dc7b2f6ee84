"""Per-cell geometric factors, element matrices and boundary-face data.

Port of ``navierstokes_tpu/ops/assembly.py``: the host (numpy, float64)
preprocessing products, and as tensors on the model's device the
per-cell arrays of the generic element operator (``build_cell_arrays``),
the boundary-face quadrature data and the forcing quadrature data.
Integrands follow the reference (src/NavierStokes.cpp:191-248): mass,
viscosity, the pressure coupling, the forcing integral (cpp:240-243);
snapped (curved) boundary cells use per-quadrature-point quadratic
geometry.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from navierstokes_tpu_torch.fem.spaces import FaceData, TaylorHoodSpace
from navierstokes_tpu_torch.ops.operators import SegmentPlan, segment_plan


@dataclasses.dataclass
class CellArrays:
    """Per-cell arrays: numpy (float64) from ``cell_arrays_numpy``, tensors
    on a device from ``build_cell_arrays``."""
    cell_p2: np.ndarray | torch.Tensor  # (nc, n_v) velocity-node ids
    cell_p1: np.ndarray | torch.Tensor  # (nc, n_p) pressure-node ids
    detj: np.ndarray | torch.Tensor     # (nc,)
    jinv: np.ndarray | torch.Tensor     # (nc, dim, dim) reference<-physical
    mass: np.ndarray | torch.Tensor     # (nc, n_v, n_v) scalar mass
    stiff: np.ndarray | torch.Tensor    # (nc, n_v, n_v) scalar stiffness
    grad: np.ndarray | torch.Tensor     # (nc, n_v, dim, n_p) -int dphi psi
    # the snapped (curved) cells of the per-step convection fix
    # (ops/operators.curved_convection_fix), tensors only; None on meshes
    # without snapped boundaries
    curv_ids: torch.Tensor | None = None     # (k,) int64
    curv_nodes: torch.Tensor | None = None   # (k, n_v) int64
    curv_phi: torch.Tensor | None = None     # (n_cq, n_v)
    curv_dphys: torch.Tensor | None = None   # (k, n_cq, n_v, dim), w*detJ


@dataclasses.dataclass
class FaceArrays:
    """Boundary-face quadrature data for one tag (tensors)."""
    vel_nodes: torch.Tensor   # (nf, n_v) int64 owning cell's velocity nodes
    p_nodes: torch.Tensor     # (nf, n_p) int64
    phi_v: torch.Tensor       # (nf, n_fq, n_v)
    dphi_phys: torch.Tensor   # (nf, n_fq, n_v, dim) physical gradients
    phi_p: torch.Tensor       # (nf, n_fq, n_p)
    normals: torch.Tensor     # (nf, n_fq, dim) outward unit normals
    jxw: torch.Tensor         # (nf, n_fq)


def geometric_factors(space: TaylorHoodSpace):
    """Affine-map factors per cell: detJ and J^{-1}, J[:, k] = v_{k+1} - v_0."""
    mesh = space.mesh
    p = mesh.points[mesh.cells]                       # (nc, dim+1, dim)
    J = np.swapaxes(p[:, 1:, :] - p[:, :1, :], 1, 2)  # (nc, dim, dim)
    return np.linalg.det(J), np.linalg.inv(J)


def curved_conv_inputs(space: TaylorHoodSpace):
    """(curv_ids, curv_nodes, curv_phi, curv_dphys) numpy inputs of the
    per-step curved-cell convection fix, or (None,)*4 on unsnapped meshes.
    curv_dphys folds w_q * detJ_q into the physical gradients."""
    cd = space.curved_data()
    if cd is None:
        return None, None, None, None
    wdet = cd.qw[None, :] * cd.detj_q                       # (k, n_cq)
    dphys = np.einsum("kq,qax,kqxd->kqad", wdet, cd.dphi_v, cd.jinv_q)
    nodes = np.asarray(space.cell_p2)[cd.ids].astype(np.int64)
    return cd.ids.astype(np.int64), nodes, cd.phi_v, dphys


def cell_arrays_numpy(space: TaylorHoodSpace) -> CellArrays:
    """Host (float64) per-cell arrays; snapped cells get quadratic-map
    quadrature versions of their static element matrices (their stored
    detj/jinv stay the affine values)."""
    rs = space.rs
    detj, jinv = geometric_factors(space)
    C = np.einsum("cxd,cyd->cxy", jinv, jinv) * detj[:, None, None]
    stiff = np.einsum("xyab,cxy->cab", rs.K_hat, C)
    mass = detj[:, None, None] * rs.M_hat[None, :, :]
    grad = -np.einsum("axj,cxd,c->cadj", rs.G_hat, jinv, detj)
    cd = space.curved_data()
    if cd is not None:
        wdet = cd.qw[None, :] * cd.detj_q
        dphys = np.einsum("qax,kqxd->kqad", cd.dphi_v, cd.jinv_q)
        mass[cd.ids] = np.einsum("kq,qa,qb->kab", wdet, cd.phi_v, cd.phi_v)
        stiff[cd.ids] = np.einsum("kq,kqad,kqbd->kab", wdet, dphys, dphys)
        grad[cd.ids] = -np.einsum("kq,kqad,qj->kadj", wdet, dphys, cd.phi_p)
    return CellArrays(cell_p2=np.asarray(space.cell_p2),
                      cell_p1=np.asarray(space.cell_p1), detj=detj,
                      jinv=jinv, mass=mass, stiff=stiff, grad=grad)


def build_cell_arrays(space: TaylorHoodSpace, dtype, device,
                      host: CellArrays | None = None) -> CellArrays:
    """The per-cell arrays of ``cell_arrays_numpy`` (or of ``host``, its
    result) as tensors on ``device`` (indices int64), for any degree pair,
    with the curved-convection fields of ``curved_conv_inputs``."""
    c = host if host is not None else cell_arrays_numpy(space)
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    i = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    ci, cn, cphi, cdphys = curved_conv_inputs(space)
    curved = ci is not None
    return CellArrays(
        cell_p2=i(c.cell_p2), cell_p1=i(c.cell_p1), detj=f(c.detj),
        jinv=f(c.jinv), mass=f(c.mass), stiff=f(c.stiff), grad=f(c.grad),
        curv_ids=i(ci) if curved else None,
        curv_nodes=i(cn) if curved else None,
        curv_phi=f(cphi) if curved else None,
        curv_dphys=f(cdphys) if curved else None)


def quadrature_points(space: TaylorHoodSpace):
    """(detJ (nc,), physical quadrature points (nc, n_q, dim)) of the
    affine cells: x = sum_k lambda_k(qp) v_k."""
    detj, _ = geometric_factors(space)
    verts = space.mesh.points[space.mesh.cells]          # (nc, dim+1, dim)
    qp = space.rs.qp
    bary = np.concatenate([1.0 - qp.sum(axis=1)[:, None], qp], axis=1)
    return detj, np.einsum("qk,ckd->cqd", bary, verts)


@dataclasses.dataclass
class ForcingData:
    """Quadrature data of the per-step forcing integral
    r[(a, d)] = int f_d(x, t) phi_a dx (src/NavierStokes.cpp:240-243)."""
    xq: torch.Tensor        # (nc, n_q, dim) physical quadrature points
    w: torch.Tensor         # (nc, n_q, n_v) qw * phi_a * detJ
    plan: SegmentPlan       # (cell, a) entries -> velocity nodes


def build_forcing_data(space: TaylorHoodSpace, dtype,
                       device) -> ForcingData:
    detj, xq = quadrature_points(space)
    wq = np.einsum("q,qa,c->cqa", space.rs.qw, space.rs.phi_v, detj)
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return ForcingData(xq=f(xq), w=f(wq),
                       plan=segment_plan(space.cell_p2, space.n_p2, device))


def forcing_integral(data: ForcingData, forcing, t):
    """The forcing RHS at time ``t`` (0-d tensor): ``forcing(x (m, dim),
    t) -> (m, dim)`` at every quadrature point, cast to the data's dtype,
    integrated against the velocity basis and summed into the nodes in a
    fixed order.  Returns (n_p2, dim)."""
    xq = data.xq
    dim = xq.shape[-1]
    fq = forcing(xq.reshape(-1, dim), t).to(xq.dtype).reshape(xq.shape)
    r_c = torch.einsum("cqa,cqd->cad", data.w, fq)
    return data.plan(r_c.reshape(-1, dim))


def forcing_rhs(space: TaylorHoodSpace, f_fn, t: float = 0.0) -> np.ndarray:
    """Host-side forcing assembly r[(a, d)] = int f_d(x, t) phi_a dx with
    a numpy ``f_fn(points (n, dim), t) -> (n, dim)``: (n_p2, dim) float64.
    The reference's ForcingTerm is identically zero
    (src/NavierStokes.hpp:56-65); manufactured solutions use the hook."""
    rs, dim = space.rs, space.dim
    detj, xq = quadrature_points(space)
    fq = f_fn(xq.reshape(-1, dim), t).reshape(xq.shape)
    r_c = np.einsum("q,qa,cqd,c->cad", rs.qw, rs.phi_v, fq, detj)
    out = np.zeros((space.n_p2, dim))
    np.add.at(out, np.asarray(space.cell_p2).reshape(-1), r_c.reshape(-1, dim))
    return out


def build_face_arrays(space: TaylorHoodSpace, tag: int, dtype,
                      device) -> FaceArrays:
    fd: FaceData = space.face_data(tag)
    if fd.jinv_q is not None:
        dphi_phys = np.einsum("fqbx,fqxd->fqbd", fd.dphi_v_ref, fd.jinv_q)
    else:
        _, jinv = geometric_factors(space)
        dphi_phys = np.einsum("fqbx,fxd->fqbd", fd.dphi_v_ref,
                              jinv[fd.cells])
    f = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                                  device=device)
    i = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    return FaceArrays(vel_nodes=i(space.cell_p2[fd.cells]),
                      p_nodes=i(space.cell_p1[fd.cells]),
                      phi_v=f(fd.phi_v), dphi_phys=f(dphi_phys),
                      phi_p=f(fd.phi_p), normals=f(fd.normals),
                      jxw=f(fd.jxw))
