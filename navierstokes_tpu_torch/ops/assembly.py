"""Per-cell geometric factors, element matrices and boundary-face data.

Port of ``navierstokes_tpu/ops/assembly.py``: the host (numpy, float64)
preprocessing products, with the boundary-face quadrature data as tensors
on the model's device.  Integrands follow the reference
(src/NavierStokes.cpp:191-248): mass, viscosity, the pressure coupling;
snapped (curved) boundary cells use per-quadrature-point quadratic
geometry.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from navierstokes_tpu_torch.fem.spaces import FaceData, TaylorHoodSpace


@dataclasses.dataclass
class CellArrays:
    """Host (numpy) per-cell arrays."""
    cell_p2: np.ndarray     # (nc, n_v) velocity-node ids
    cell_p1: np.ndarray     # (nc, n_p) pressure-node ids
    detj: np.ndarray        # (nc,)
    jinv: np.ndarray        # (nc, dim, dim) reference<-physical
    mass: np.ndarray        # (nc, n_v, n_v) scalar mass element matrices
    stiff: np.ndarray       # (nc, n_v, n_v) scalar stiffness
    grad: np.ndarray        # (nc, n_v, dim, n_p) -int d_d(phi_a) psi_j


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
