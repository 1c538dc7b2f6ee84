"""Sparse operators of the Taylor-Hood step, in the compact SELL layout.

Port of ``navierstokes_tpu/ops/bsr.py``.  The JAX package stores every
operator as a blocked ELL of 16x16 node blocks, shaped for the TPU's
128-lane minor axis: at the bench point 5% of its F values are nonzero.
The port keeps only the nonzeros (``ops/sell.py``).  The host part
(``build_bsr``) forms the same element COO lists as the JAX builder, sums
each operator's entries per nonzero in element order (the JAX builder's
order, so float64 values agree to the last bit) and lays the operators out
for the one SELL SpMV (``kernels/sell_spmv.py``): F, A0 and the mass on
the P2 node pattern (D = dim), G with rows node*dim + d, B = G^T, and the
P1-P1 pattern of the PCD pressure convection.

Per step, the convection part of F and the PCD pressure convection are
reduced from element matrices straight into their compact slots by
presorted segment sums: a fixed order, no atomics.  Of the JAX tables the
port keeps one, the whole-row G block table ``host.g_cols_full``
(identical to JAX's), which defines the Schur coarse assembly's block
pairs (solvers/schur.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from navierstokes_tpu_torch.fem.spaces import TaylorHoodSpace
from navierstokes_tpu_torch.kernels.sell_spmv import sell_spmv
from navierstokes_tpu_torch.ops.assembly import (CellArrays,
                                                 curved_conv_inputs)
from navierstokes_tpu_torch.ops.operators import (SegmentPlan,
                                                  convection_matrices,
                                                  segment_plan)
from navierstokes_tpu_torch.ops.sell import (SellMatrix, build_sell,
                                             unique_pairs)


@dataclasses.dataclass
class BsrHost:
    """Host (numpy) data for setup-time consumers."""
    m_nz: np.ndarray         # (nnz_F,) float64 mass of each F nonzero
    k_nz: np.ndarray         # (nnz_F,) float64 stiffness of each F nonzero
    g_cols_full: np.ndarray  # (n_vb, KG) whole-row G block columns
    g_agg: np.ndarray        # (n_vb, KG, dim, bu) float64 G summed over
    #                          each block's bp pressure nodes


@dataclasses.dataclass
class BsrData:
    # element inputs of the per-step convection rebuild
    cell_p2: torch.Tensor        # (nc, n_v) int64
    detj: torch.Tensor           # (nc,)
    jinv: torch.Tensor           # (nc, dim, dim)
    t_hat: torch.Tensor
    # F, A0 and the mass: the P2 node pattern, applied to (n_p2, dim)
    f: SellMatrix
    conv_plan: SegmentPlan       # element entries (c, a, b) -> F slots
    diag_slot: torch.Tensor      # (n_p2,) int64 F slot of each diagonal
    m_vals: object               # (n_slots_F,) mass values | None
    # pressure coupling (static): G (n_p2*dim x n_p1, row node*dim + d)
    # and B = G^T (n_p1 x n_p2*dim)
    g: SellMatrix
    g_vals: torch.Tensor
    b: SellMatrix
    b_vals: torch.Tensor
    n_p2: int
    n_p1: int
    bu: int
    bp: int
    n_vb: int                    # velocity node blocks
    n_pb: int                    # pressure node blocks
    host: BsrHost
    # curved (snapped) cell subset of the convection fix, or None
    curv_ids: object = None      # (k,) int64
    curv_nodes: object = None    # (k, n_v) int64
    curv_phi: object = None      # (n_cq, n_v)
    curv_dphys: object = None    # (k, n_cq, n_v, dim), w*detJ folded
    # the P1-P1 pattern of the PCD convection operator and the plan
    # reducing the (cell, i, j) element entries into its slots
    pp: SellMatrix = None
    pp_plan: SegmentPlan = None
    tp_hat: object = None        # (n_p, n_p, dim, n_v) P1 convection tensor


def _block_pairs(rows, cols, bu, bv, n_rb):
    """Unique (row_block, col_block) pairs -> whole-row block table, the
    sorted pair keys, the slot of each pair and the key stride."""
    RI = rows // bu
    CJ = cols // bv
    stride = np.int64(CJ.max() + 2 if len(CJ) else 2)
    uk = np.unique(RI.astype(np.int64) * stride + CJ)
    ru = uk // stride
    counts = np.bincount(ru, minlength=n_rb)
    K = max(1, int(counts.max()) if len(counts) else 1)
    row_start = np.zeros(n_rb + 1, dtype=np.int64)
    np.cumsum(counts, out=row_start[1:])
    k_of = np.arange(len(ru)) - row_start[ru]
    table = np.zeros((n_rb, K), dtype=np.int64)
    table[ru, k_of] = uk % stride
    return table, uk, k_of, stride


def build_bsr(space: TaylorHoodSpace, cells: CellArrays, dtype, device,
              bu: int | None = None, bp: int | None = None,
              with_mass: bool = True) -> BsrData:
    """Host construction of the compact operators (``cells`` from
    ops/assembly.cell_arrays_numpy), uploaded to ``device``.  ``bu`` /
    ``bp`` are the velocity / pressure node-block sizes of the block-Jacobi
    tiles and the Schur aggregates (16).  ``with_mass`` uploads the mass
    values."""
    dim = space.dim
    bu = bu or 16
    bp = bp or bu
    n_p2, n_p1 = space.n_p2, space.n_p1
    cp2 = np.asarray(space.cell_p2, dtype=np.int64)
    cp1 = np.asarray(space.cell_p1, dtype=np.int64)
    nc, nv = cp2.shape
    npp = cp1.shape[1]
    n_vb = -(-n_p2 // bu)
    n_pb = -(-n_p1 // bp)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                                  device=device)
    i64 = lambda a: torch.as_tensor(np.asarray(a).astype(np.int64),
                                    device=device)

    # ---- F / A0 / mass: entries (c, a, b) -> (cp2[c, a], cp2[c, b]) -------
    rows = np.repeat(cp2, nv, axis=1).reshape(-1)
    cols = np.tile(cp2, (1, nv)).reshape(-1)
    nz_r, nz_c, inv = unique_pairs(rows, cols, n_p2)
    fmat = build_sell(nz_r, nz_c, n_p2, n_p2, device, "F")
    nnz = len(nz_r)
    m_nz = np.bincount(inv, weights=np.asarray(cells.mass).reshape(-1),
                       minlength=nnz)
    k_nz = np.bincount(inv, weights=np.asarray(cells.stiff).reshape(-1),
                       minlength=nnz)
    diag_nz = np.searchsorted(nz_r * n_p2 + nz_c,
                              np.arange(n_p2, dtype=np.int64) * (n_p2 + 1))
    conv_plan = segment_plan(fmat.nz_slot[inv], fmat.n_slots, device)

    # ---- G (rows node*dim + d, cols p) and B = G^T, static ------------------
    grad = np.asarray(cells.grad, np.float64)            # (nc, nv, dim, npp)
    g_node = np.repeat(cp2, npp, axis=1).reshape(-1)     # entries (c, a, j)
    g_p = np.tile(cp1, (1, nv)).reshape(-1)
    g_row = (g_node[:, None] * dim + np.arange(dim)).reshape(-1)
    g_col = np.repeat(g_p, dim)
    g_v = grad.transpose(0, 1, 3, 2).reshape(-1)          # (c, a, j, d)
    gr, gc, ginv = unique_pairs(g_row, g_col, n_p1)
    g_nz = np.bincount(ginv, weights=g_v, minlength=len(gr))
    gmat = build_sell(gr, gc, n_p2 * dim, n_p1, device, "G")
    br, bc, binv = unique_pairs(g_col, g_row, n_p2 * dim)
    bmat = build_sell(br, bc, n_p1, n_p2 * dim, device, "B")
    b_nz = np.bincount(binv, weights=g_v, minlength=len(br))

    # the whole-row G block table (JAX's host_g_cols) and G summed over each
    # block's pressure nodes: the Schur coarse assembly's inputs
    g_tab, gkeys, gk_of, gstride = _block_pairs(g_node, g_p, bu, bp, n_vb)
    g_node_nz = gr // dim
    k_nz_g = gk_of[np.searchsorted(gkeys, (g_node_nz // bu) * gstride
                                   + gc // bp)]
    g_agg = np.zeros((n_vb, g_tab.shape[1], dim, bu))
    np.add.at(g_agg, (g_node_nz // bu, k_nz_g, gr % dim, g_node_nz % bu),
              g_nz)

    # ---- P1-P1 pattern of the PCD pressure convection, per-step values -----
    p_rows = np.repeat(cp1, npp, axis=1).reshape(-1)
    p_cols = np.tile(cp1, (1, npp)).reshape(-1)
    pr, pc, pinv = unique_pairs(p_rows, p_cols, n_p1)
    ppmat = build_sell(pr, pc, n_p1, n_p1, device, "PP")

    ci, cn, cphi, cdphys = curved_conv_inputs(space)
    return BsrData(
        cell_p2=i64(cp2), detj=f(cells.detj), jinv=f(cells.jinv),
        t_hat=f(space.rs.T_hat),
        f=fmat, conv_plan=conv_plan, diag_slot=i64(fmat.nz_slot[diag_nz]),
        m_vals=fmat.values(m_nz, dtype) if with_mass else None,
        g=gmat, g_vals=gmat.values(g_nz, dtype),
        b=bmat, b_vals=bmat.values(b_nz, dtype),
        n_p2=n_p2, n_p1=n_p1, bu=bu, bp=bp, n_vb=n_vb, n_pb=n_pb,
        host=BsrHost(m_nz=m_nz, k_nz=k_nz, g_cols_full=g_tab, g_agg=g_agg),
        curv_ids=None if ci is None else i64(ci),
        curv_nodes=None if ci is None else i64(cn),
        curv_phi=None if ci is None else f(cphi),
        curv_dphys=None if ci is None else f(cdphys),
        pp=ppmat,
        pp_plan=segment_plan(ppmat.nz_slot[pinv], ppmat.n_slots, device),
        tp_hat=f(space.rs.Tp_hat))


# ---------------------------------------------------------------------------
# applies
# ---------------------------------------------------------------------------


def apply_f(bsr: BsrData, f_vals, xu):
    """F xu for compact F values f_vals (n_slots,); xu (n_p2, d).  One SpMV
    for all d components.  bf16 values (``inner_bf16``) take the
    bf16-values SpMV with fp32 x."""
    return sell_spmv(bsr.f, f_vals, xu.contiguous()).to(xu.dtype)


def apply_bt(bsr: BsrData, p):
    """G p: (n_p1,) -> (n_p2, dim)."""
    return sell_spmv(bsr.g, bsr.g_vals, p.contiguous()).view(bsr.n_p2, -1)


def apply_b(bsr: BsrData, xu):
    """B xu = G^T xu: (n_p2, dim) -> (n_p1,)."""
    return sell_spmv(bsr.b, bsr.b_vals, xu.reshape(-1).contiguous())


def f_diag(bsr: BsrData, f_vals):
    return f_vals[bsr.diag_slot]


def mass_apply(bsr: BsrData, u):
    return apply_f(bsr, bsr.m_vals, u)


def convection_blk(bsr: BsrData, u):
    """Per-step convection values in the compact F slots: element matrices
    (ops/operators.convection_matrices, the reference's per-step T1 term,
    src/NavierStokes.cpp:204-208) reduced by the presorted plan."""
    return bsr.conv_plan(convection_matrices(bsr, bsr.t_hat, u).reshape(-1))


def schur_diag(bsr: BsrData, node_weights):
    """diag(B diag(w) B^T) for node weights w (n_p2,): the SpMV of the
    squared B values against w repeated over the velocity components."""
    dim = bsr.b.n_cols // bsr.n_p2
    wu = node_weights[:, None].expand(-1, dim).reshape(-1)
    return sell_spmv(bsr.b, bsr.b_vals * bsr.b_vals, wu.contiguous())


def pressure_convection_elements(cells, u):
    """(nc, n_p, n_p) element matrices of the pressure-space convection;
    ``cells`` carries cell_p2, jinv, detj and tp_hat."""
    u_c = u[cells.cell_p2]                                # (nc, n_v, dim)
    w = torch.einsum("cxd,ced->cxe", cells.jinv, u_c) \
        * cells.detj[:, None, None]
    return torch.einsum("ijxe,cxe->cij", cells.tp_hat, w)


def pressure_convection_blk(bsr: BsrData, u):
    """Per-step pressure-space convection N_p(u), np_ij = int psi_i (u .
    grad psi_j), the moving part of the PCD preconditioner's Fp, reduced
    into the compact P1-P1 slots that ``apply_pp`` reads."""
    return bsr.pp_plan(pressure_convection_elements(bsr, u).reshape(-1))


def apply_pp(bsr: BsrData, pp_vals, xp):
    """Pressure-graph matvec (n_p1,) -> (n_p1,) with the compact values of
    ``pressure_convection_blk``."""
    return sell_spmv(bsr.pp, pp_vals, xp.contiguous())


def float64_tables(bsr: BsrData) -> BsrData:
    """``bsr`` with exact float64 copies of the static values refinement's
    residual reads (the mass, G and B; solvers/refine.py)."""
    return dataclasses.replace(bsr, m_vals=bsr.m_vals.double(),
                               g_vals=bsr.g_vals.double(),
                               b_vals=bsr.b_vals.double())


class BsrOps:
    """Operator interface of the model over BsrData (one F SpMV).  The
    row-sharded ``parallel/sharded_bsr.ShardedBsrOps`` has the same
    methods."""

    def convection(self, bsr: BsrData, u):
        return convection_blk(bsr, u)

    def apply_f(self, bsr: BsrData, f_vals, xu):
        return apply_f(bsr, f_vals, xu)

    def apply_bt(self, bsr: BsrData, p):
        return apply_bt(bsr, p)

    def apply_b(self, bsr: BsrData, xu):
        return apply_b(bsr, xu)

    def pressure_convection(self, bsr: BsrData, u):
        return pressure_convection_blk(bsr, u)

    def apply_pp(self, bsr: BsrData, pp_vals, xp):
        return apply_pp(bsr, pp_vals, xp)

    def float64_tables(self, bsr: BsrData) -> BsrData:
        return float64_tables(bsr)

    def apply_blocks(self, bsr: BsrData, f_vals, xu, xp, with_f=True,
                     with_g=True, with_gt=True):
        """(F xu + G xp, B xu), each term optional."""
        yu = self.apply_f(bsr, f_vals, xu) if with_f else None
        if with_g:
            g = self.apply_bt(bsr, xp)
            yu = g if yu is None else yu + g
        if yu is None:
            yu = torch.zeros_like(xu)
        yp = self.apply_b(bsr, xu) if with_gt else torch.zeros_like(xp)
        return yu, yp

    def f_diag(self, bsr: BsrData, f_vals):
        return f_diag(bsr, f_vals)

    def mass_apply(self, bsr: BsrData, u):
        return mass_apply(bsr, u)

    def schur_diag(self, bsr: BsrData, node_weights):
        return schur_diag(bsr, node_weights)
