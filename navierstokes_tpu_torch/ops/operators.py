"""Per-cell convection element matrices and the presorted segment sum.

Port of ``navierstokes_tpu/ops/operators.py`` ``convection_matrices``,
``curved_convection_fix`` and ``Scatter``: c_ab = int phi_a ((u_old .
grad) phi_b), the reference's T1 form (src/NavierStokes.cpp:204-208), as a
contraction of the reference tensor T_hat with per-cell J^-1 u values;
snapped (curved) cells get the quadratic-geometry quadrature version.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class SegmentPlan:
    """Presorted segment sum (n_flat,) -> (num_segments,), the JAX
    ``Scatter``: the values are permuted by the stable argsort of their
    target ids and reduced by ``torch.segment_reduce`` over the per-target
    counts.  A fixed-order sum, no atomics, so a run is bit-reproducible."""
    order: torch.Tensor      # (n_flat,) int64 stable argsort of the ids
    lengths: torch.Tensor    # (num_segments,) int64 entries per target
    num_segments: int

    def __call__(self, flat_values: torch.Tensor) -> torch.Tensor:
        return torch.segment_reduce(flat_values[self.order], "sum",
                                    lengths=self.lengths, axis=0)


def segment_plan(ids, num_segments: int, device) -> SegmentPlan:
    flat = np.asarray(ids, np.int64).reshape(-1)
    order = np.argsort(flat, kind="stable")
    lengths = np.bincount(flat, minlength=num_segments)
    return SegmentPlan(order=torch.as_tensor(order, device=device),
                       lengths=torch.as_tensor(lengths, device=device),
                       num_segments=int(num_segments))


def convection_matrices(cells, t_hat: torch.Tensor,
                        u: torch.Tensor) -> torch.Tensor:
    """(nc, n_v, n_v) convection element matrices.  ``cells`` carries
    cell_p2, jinv, detj and the curv_* fields (ops/bsr.BsrData)."""
    nv = cells.cell_p2.shape[1]
    u_c = u[cells.cell_p2]                                # (nc, n_v, dim)
    w = torch.einsum("cxd,ced->cxe", cells.jinv, u_c)     # (nc, dim, n_v)
    w = w * cells.detj[:, None, None]
    dim = w.shape[1]
    tm = t_hat.permute(2, 3, 0, 1).reshape(dim * nv, nv * nv)
    c = w.reshape(-1, dim * nv) @ tm
    return curved_convection_fix(cells, c.reshape(-1, nv, nv), u)


def curved_convection_fix(cells, c_elem: torch.Tensor,
                          u: torch.Tensor) -> torch.Tensor:
    """Replace the curved cells' element matrices with
    c_ab = sum_q (w detJ)_q phi_a(q) u_d(q) (dphi_b/dx_d)(q); no-op on
    meshes without snapped boundaries."""
    ids = cells.curv_ids
    if ids is None:
        return c_elem
    u_k = u[cells.curv_nodes]                                  # (k, n_v, dim)
    u_q = torch.einsum("qe,ked->kqd", cells.curv_phi, u_k)
    c_k = torch.einsum("qa,kqd,kqbd->kab", cells.curv_phi, u_q,
                       cells.curv_dphys)
    c_elem = c_elem.clone()
    c_elem[ids] = c_k.to(c_elem.dtype)
    return c_elem
