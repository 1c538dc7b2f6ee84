"""Helpers of the port's tests: the JAX package's blocked-ELL operator
values placed in the slots of the port's compact patterns (through
navierstokes_tpu_torch/convert.py), and either as a scipy matrix."""

import numpy as np
import scipy.sparse as sps

from navierstokes_tpu_torch import convert


def f_coo(jb, f_blk):
    """COO of JAX F-layout values (n_vb_ext, bu, K*bu)."""
    f_blk = np.asarray(f_blk, np.float64)
    n_ext = f_blk.shape[0]
    ovf = getattr(jb, "host_ovf_rows", None)
    phys = convert.blocked_ell_phys_rows(n_ext, jb.n_vb or n_ext, ovf)
    return convert.coo_from_blocked_ell(f_blk, np.asarray(jb.f_cols), phys)


def g_coo(jb):
    """COO of JAX's G (rows node*dim + d, as in the port)."""
    g = np.asarray(jb.g_blk, np.float64)
    n_ext, dim, bu, cw = g.shape
    phys = convert.blocked_ell_phys_rows(
        n_ext, jb.n_vb or n_ext,
        spill=None if jb.g_spill is None else np.asarray(jb.g_spill))
    return convert.coo_from_blocked_ell(
        g.transpose(0, 2, 1, 3).reshape(n_ext, bu * dim, cw),
        np.asarray(jb.g_cols), phys)


def b_coo(jb):
    """COO of JAX's B (columns node*dim + d, as in the port)."""
    b = np.asarray(jb.b_blk, np.float64)
    n_ext = b.shape[0]
    phys = convert.blocked_ell_phys_rows(
        n_ext, jb.n_pb or n_ext,
        spill=None if jb.b_spill is None else np.asarray(jb.b_spill))
    return convert.coo_from_blocked_ell(b, np.asarray(jb.b_cols), phys)


def p1_coo(je):
    """COO of a JAX EllBlocked (P1 Laplacian, Ap)."""
    return convert.coo_from_blocked_ell(np.asarray(je.vals, np.float64),
                                        np.asarray(je.cols))


def pp_coo(jb, np_blk):
    """COO of JAX pressure-convection blocks (n_pb, KPP, bp, bp)."""
    v = np.asarray(np_blk, np.float64)
    n_pb, kpp, bp, _ = v.shape
    return convert.coo_from_blocked_ell(
        v.transpose(0, 2, 1, 3).reshape(n_pb, bp, kpp * bp),
        np.asarray(jb.pp_cols))


def on(mat, coo, dtype):
    """The COO's values in the slots of the port's pattern ``mat``."""
    return convert.sell_values_from_coo(mat, *coo, dtype)


def scipy_of_coo(coo, shape):
    r, c, v = coo
    keep = (r < shape[0]) & (c < shape[1])
    return sps.csr_matrix((v[keep], (r[keep], c[keep])), shape=shape)


def scipy_of_sell(mat, vals):
    v = np.asarray(vals.detach().cpu().double().numpy())
    return sps.csr_matrix((v[mat.nz_slot], (mat.nz_row, mat.nz_col)),
                          shape=(mat.n_rows, mat.n_cols))
