"""Carry state and operator data from the JAX package into the port.

Everything crosses as numpy arrays, so this module imports no jax:
callers pass ``np.asarray(...)`` of the JAX arrays (a mapping of the JAX
dataclass's field names for the operator tables).  Checkpoints need no
conversion: both packages read and write the shared ``state-ns-<step>.npz``
schema (navierstokes_tpu/utils/checkpoint.py).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from navierstokes_tpu_torch.ops.bsr import BsrData, BsrHost, spill_from_ovf
from navierstokes_tpu_torch.ops.operators import SegmentPlan
from navierstokes_tpu_torch.ops.p1ell import BlockJacobiPlan, EllBlocked


@dataclasses.dataclass
class State:
    """Time-stepping state of either scheme."""
    u: torch.Tensor          # (n_p2, dim)
    p: torch.Tensor          # (n_p1,)
    u_prev: torch.Tensor     # (n_p2, dim) velocity at the previous step
    phi: torch.Tensor        # (n_p1,) last pressure increment (projection;
    #                          the monolithic step passes it through)
    time: float


def state_from_jax_numpy(u, p, u_prev, phi, t, device, dtype) -> State:
    kw = dict(dtype=dtype, device=device)
    return State(u=torch.as_tensor(np.array(u), **kw),
                 p=torch.as_tensor(np.array(p), **kw),
                 u_prev=torch.as_tensor(np.array(u_prev), **kw),
                 phi=torch.as_tensor(np.array(phi), **kw), time=float(t))


def bsr_from_jax_numpy(fields: Mapping, device, dtype) -> BsrData:
    """BsrData from the JAX ``BsrData`` fields (numpy or array-likes;
    ``host_m_blk`` / ``host_k_blk`` / ``host_g_cols`` optional).  The PCD
    tables come from ``pp_cols``, ``tp_hat`` and the ``pp_slot_scatter``
    plan (its ``order``, ``sorted_ids`` and ``num_segments``); whole-row
    G/B tables (no ``g_spill`` / ``b_spill``) pass through as they are."""
    a = lambda k: None if fields.get(k) is None else np.asarray(fields[k])
    f = lambda x: None if x is None else torch.as_tensor(
        np.array(x, np.float64), dtype=dtype, device=device)
    i32 = lambda x: None if x is None else torch.as_tensor(
        np.asarray(x).astype(np.int32), device=device)
    i64 = lambda x: None if x is None else torch.as_tensor(
        np.asarray(x).astype(np.int64), device=device)
    f_cols = a("f_cols").astype(np.int64)
    n_vb = int(fields["n_vb"]) or f_cols.shape[0]
    n_pb = int(fields["n_pb"]) or a("b_cols").shape[0]
    ovf = a("ovf_rows")
    ovf = np.zeros(0, np.int64) if ovf is None else ovf.astype(np.int64)
    seg = a("con_seg").astype(np.int64)
    K0, bu = f_cols.shape[1], int(fields["bu"])
    splits = fields.get("con_splits") or (
        (0, len(seg), 0, f_cols.shape[0] * bu),)
    lengths = tuple(i64(np.bincount(seg[i0:i1] - s0, minlength=s1 - s0))
                    for (i0, i1, s0, s1) in splits)
    f_spill = spill_from_ovf(ovf, f_cols, n_vb) if len(ovf) else None
    m_blk = a("m_blk")
    sc = fields.get("pp_slot_scatter")
    pp_plan = None if sc is None else SegmentPlan(
        order=i64(sc.order), num_segments=int(sc.num_segments),
        lengths=i64(np.bincount(np.asarray(sc.sorted_ids),
                                minlength=int(sc.num_segments))))
    return BsrData(
        cell_p2=i64(a("cell_p2")), detj=f(a("detj")), jinv=f(a("jinv")),
        t_hat=f(a("t_hat")), con_row=i64(a("con_row")),
        con_cpos=i64(a("con_cpos")), con_seg=i64(seg),
        con_splits=tuple(splits), con_lengths=lengths,
        f_cols=i32(f_cols), f_spill=i32(f_spill),
        diag_idx=i64(a("diag_idx")), m_blk=f(m_blk),
        g_cols=i32(a("g_cols")), g_blk=f(a("g_blk")),
        b_cols=i32(a("b_cols")), b_blk=f(a("b_blk")),
        g_spill=i32(a("g_spill")), b_spill=i32(a("b_spill")),
        n_p2=int(fields["n_p2"]), n_p1=int(fields["n_p1"]), bu=bu,
        bp=int(fields["bp"]), n_vb=n_vb, n_pb=n_pb,
        host=BsrHost(f_cols=f_cols, ovf_rows=ovf,
                     g_cols_full=a("host_g_cols"),
                     m_blk=a("host_m_blk"), k_blk=a("host_k_blk")),
        curv_ids=i64(a("curv_ids")), curv_nodes=i64(a("curv_nodes")),
        curv_phi=f(a("curv_phi")), curv_dphys=f(a("curv_dphys")),
        pp_cols=i32(a("pp_cols")), pp_plan=pp_plan, tp_hat=f(a("tp_hat")))


def ell_from_jax_numpy(cols, vals, diag, n: int, b: int, device,
                       dtype) -> EllBlocked:
    """EllBlocked from the JAX ``EllBlocked`` arrays (flat (n_b, b, K*b)
    values)."""
    cols = np.asarray(cols).astype(np.int64)
    vals = np.asarray(vals, np.float64)
    n_b, K = cols.shape
    return EllBlocked(
        cols=torch.as_tensor(cols.astype(np.int32), device=device),
        vals=torch.as_tensor(vals, dtype=dtype, device=device),
        diag=torch.as_tensor(np.asarray(diag, np.float64), dtype=dtype,
                             device=device),
        n=int(n), b=int(b),
        host_vals=vals.reshape(n_b, b, K, b).transpose(0, 2, 1, 3),
        host_cols=cols)


def bj_plan_from_jax_numpy(idx, n_tiles: int, S: int, bu: int, n_p2: int,
                           f_cols_shape, device) -> BlockJacobiPlan:
    """BlockJacobiPlan ("blocked" layout) from the JAX plan's flat base
    indices ``idx`` and the F table shape (n_vb_ext, KB)."""
    idx = np.asarray(idx).astype(np.int64)
    n_vb_ext, KB = f_cols_shape
    base = idx // bu
    v = base // (bu * KB)
    bidx = np.minimum(v * KB + (base - v * (bu * KB)), n_vb_ext * KB)
    return BlockJacobiPlan(idx=idx, bidx=torch.as_tensor(bidx, device=device),
                           n_tiles=int(n_tiles), S=int(S), bu=int(bu),
                           n_p2=int(n_p2))
