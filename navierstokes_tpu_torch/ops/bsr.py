"""Block-sparse-row (BSR) operators of the projection step.

Port of ``navierstokes_tpu/ops/bsr.py``.  The host part (``build_bsr``)
builds exactly the JAX package's tables: Hilbert-ordered node blocks of
``bu`` velocity / ``bp`` pressure nodes, block-ELL graphs with the same
``row_multiple`` padding and overflow split, the flat row-major value
layout (n_ext, rows, K*cb) and the row-blocked convection plan.  One
table is new: ``f_spill``, the per-physical-row list of F overflow rows
(shaped like ``g_spill``), which replaces the JAX scatter-add fold
``y[:n_vb].at[ovf_rows].add(...)`` by a fixed-order gather-sum.

The per-step part applies F, the mass, G (``apply_bt``), B
(``apply_b``), the Schur diagonal and the PCD pressure convection
(``apply_pp``) through the one blocked-ELL SpMV (``kernels/bsr_spmv.py``),
and rebuilds the convection parts of the F and pressure-convection values
with deterministic presorted segment sums.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as Fn

from navierstokes_tpu.fem.spaces import TaylorHoodSpace
from navierstokes_tpu_torch.kernels.bsr_spmv import bsr_spmv
from navierstokes_tpu_torch.ops.assembly import (CellArrays,
                                                 curved_conv_inputs)
from navierstokes_tpu_torch.ops.operators import (SegmentPlan,
                                                  convection_matrices,
                                                  segment_plan)


@dataclasses.dataclass
class BsrHost:
    """Host (numpy) copies of the tables for setup-time consumers."""
    f_cols: np.ndarray       # (n_vb_ext, K) block columns
    ovf_rows: np.ndarray     # (n_vb_ext - n_vb,) physical row of each
    #                          virtual row (padding rows map to 0)
    g_cols_full: np.ndarray  # physical (unsplit) G table
    m_blk: np.ndarray        # (n_vb_ext, bu, K*bu) float64 mass
    k_blk: np.ndarray        # (n_vb_ext, bu, K*bu) float64 stiffness


@dataclasses.dataclass
class BsrData:
    # element inputs of the per-step convection rebuild
    cell_p2: torch.Tensor        # (nc_pad, n_v) int64
    detj: torch.Tensor           # (nc_pad,)
    jinv: torch.Tensor           # (nc_pad, dim, dim)
    t_hat: torch.Tensor
    # convection plan: one contribution per (cell, row node a, extended
    # block row), sorted by destination flat row (v*bu + i); con_cpos is
    # the destination column in [0, C) of each of the n_v element-matrix
    # columns, or -1
    con_row: torch.Tensor        # (ncon,) int64 source row = cell*n_v + a
    con_cpos: torch.Tensor       # (ncon, n_v) int64
    con_seg: torch.Tensor        # (ncon,) int64 destination flat row
    con_splits: tuple            # ((i0, i1, s0, s1), ...) segment chunks
    con_lengths: tuple           # per chunk: (s1 - s0,) int64 seg lengths
    # F graph, flat row-major values (n_vb_ext, bu, K*bu)
    f_cols: torch.Tensor         # (n_vb_ext, K) int32
    f_spill: object              # None | (n_vb, S) int32 virtual rows
    diag_idx: torch.Tensor       # (n_p2,) int64 flat index of diagonal
    m_blk: object                # (n_vb_ext, bu, K*bu) mass values | None
    # pressure coupling (static)
    g_cols: torch.Tensor         # (n_vbg_ext, KG) int32
    g_blk: torch.Tensor          # (n_vbg_ext, dim, bu, KG*bp)
    b_cols: torch.Tensor         # (n_pb_ext, KBb) int32
    b_blk: torch.Tensor          # (n_pb_ext, bp, KBb*bu*dim), inner (k,j,d)
    g_spill: object              # None | (n_vb, Sg) int32
    b_spill: object              # None | (n_pb, Sb) int32
    n_p2: int
    n_p1: int
    bu: int
    bp: int
    n_vb: int                    # physical velocity block rows
    n_pb: int                    # physical pressure block rows
    host: BsrHost
    # curved (snapped) cell subset of the convection fix, or None
    curv_ids: object = None      # (k,) int64
    curv_nodes: object = None    # (k, n_v) int64
    curv_phi: object = None      # (n_cq, n_v)
    curv_dphys: object = None    # (k, n_cq, n_v, dim), w*detJ folded
    # pressure-pressure graph of the PCD convection operator: block
    # columns, and the plan reducing the (cell, i, j) element entries into
    # the JAX package's (n_pb, KPP, bp, bp) block slots
    pp_cols: object = None       # (n_pb, KPP) int32
    pp_plan: SegmentPlan = None
    tp_hat: object = None        # (n_p, n_p, dim, n_v) P1 convection tensor


def segsum_splits(seg_host, width: int, n_seg_total: int,
                  trigger_bytes: float = 4e9,
                  target_bytes: float = 1.5e9) -> tuple:
    """Segment-aligned chunk boundaries ((i0, i1, s0, s1), ...) of a
    presorted segment sum whose (n, width) rows would exceed
    ``trigger_bytes``; each chunk covers a disjoint range of segments."""
    seg_host = np.asarray(seg_host)
    n = len(seg_host)
    bytes_full = n * width * 4
    if bytes_full <= trigger_bytes:
        return ((0, n, 0, n_seg_total),)
    k = int(np.ceil(bytes_full / target_bytes))
    splits = []
    i0, s0 = 0, 0
    for j in range(1, k):
        tgt = n * j // k
        while tgt < n and seg_host[tgt] == seg_host[tgt - 1]:
            tgt += 1
        if tgt >= n or tgt <= i0:
            continue
        s_here = int(seg_host[tgt])
        splits.append((i0, tgt, s0, s_here))
        i0, s0 = tgt, s_here
    splits.append((i0, n, s0, n_seg_total))
    return tuple(splits)


def onehot_segsum(c6, con_row, cpos, lengths, width: int, splits):
    """rows[n, c] = sum_b c6[con_row[n], b] * (cpos[n, b] == c), reduced
    over the presorted segments (``lengths`` per chunk of ``splits``).

    Each contribution row is placed with one scatter into a (n, width+1)
    buffer (cpos = -1 goes to the dead last column), and the rows are
    reduced by ``torch.segment_reduce`` over the sorted segment lengths: a
    fixed-order sum, no atomics.  The one-hot product of the JAX version
    would materialise an (n, n_v, width) transient (5 GB at the bench
    point) that XLA fused away and eager PyTorch would not."""
    outs = []
    for (i0, i1, _s0, _s1), lens in zip(splits, lengths):
        ce = c6[con_row[i0:i1]]                              # (n, n_v)
        cp = cpos[i0:i1]
        col = torch.where(cp < 0, torch.full_like(cp, width), cp)
        rows = torch.zeros((i1 - i0, width + 1), dtype=c6.dtype,
                           device=c6.device)
        rows.scatter_(1, col, ce)
        red = torch.segment_reduce(rows, "sum", lengths=lens, axis=0)
        outs.append(red[:, :width])
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)
    return out.contiguous()


def _block_pairs(rows, cols, bu, bv, n_rb):
    """Unique (row_block, col_block) pairs -> ELL table + slot lookup."""
    RI = rows // bu
    CJ = cols // bv
    stride = np.int64(CJ.max() + 2 if len(CJ) else 2)
    key = RI.astype(np.int64) * stride + CJ
    order = np.argsort(key, kind="stable")
    ks = key[order]
    first = np.ones(len(ks), dtype=bool)
    first[1:] = ks[1:] != ks[:-1]
    uk = ks[first]
    ru = (uk // stride).astype(np.int64)
    cu = (uk % stride).astype(np.int64)
    counts = np.bincount(ru, minlength=n_rb)
    K = max(1, int(counts.max()) if len(counts) else 1)
    table = np.zeros((n_rb, K), dtype=np.int64)
    row_start = np.zeros(n_rb + 1, dtype=np.int64)
    np.cumsum(counts, out=row_start[1:])
    k_of = np.arange(len(ru)) - row_start[ru]
    table[ru, k_of] = cu
    return table, K, uk, ru, k_of, stride


def _split_overflow(pr_row, k_of, cols_of_pair, n_rb, k_step, rup):
    """Overflow split of a block-ELL graph: rows with more than K0 slots
    spill into virtual rows appended after the physical ones (K0 among
    multiples of ``k_step``, minimal extended storage).  ``spill`` maps
    each physical row to its virtual rows (dead entries = n_ext).

    Returns (vrow, kext, cols (n_ext, K0), spill (n_rb, S) | None, n_ext,
    K0)."""
    counts = np.bincount(pr_row, minlength=n_rb)
    kmax = max(1, int(counts.max()) if len(counts) else 1)
    cands = list(range(k_step, kmax + k_step, k_step))

    def _cost(k0):
        spillc = np.maximum(counts - k0, 0)
        return (n_rb + int(np.ceil(spillc / k0).sum())) * k0

    K0 = min(cands, key=_cost)
    over = k_of >= K0
    if not over.any():
        cols = np.zeros((n_rb, K0), dtype=np.int64)
        cols[pr_row, k_of] = cols_of_pair
        return pr_row, k_of, cols, None, n_rb, K0
    chunk = (k_of[over] - K0) // K0
    vkey = pr_row[over].astype(np.int64) * 64 + chunk
    uniq, vinv = np.unique(vkey, return_inverse=True)
    n_or = rup(len(uniq))
    n_ext = n_rb + n_or
    vrow = np.where(over, 0, pr_row).astype(np.int64)
    vrow[over] = n_rb + vinv
    kext = np.where(over, (k_of - K0) % K0, k_of)
    cols = np.zeros((n_ext, K0), dtype=np.int64)
    cols[vrow, kext] = cols_of_pair
    rows_u = (uniq // 64).astype(np.int64)
    counts_u = np.bincount(rows_u, minlength=n_rb)
    S = int(counts_u.max())
    first = np.zeros(n_rb + 1, dtype=np.int64)
    np.cumsum(counts_u, out=first[1:])
    within = np.arange(len(uniq)) - first[rows_u]
    spill = np.full((n_rb, S), n_ext, dtype=np.int64)
    spill[rows_u, within] = n_rb + np.arange(len(uniq))
    return vrow, kext, cols, spill, n_ext, K0


def spill_from_ovf(ovf_rows, f_cols, n_vb: int):
    """Per-physical-row gather table (n_vb, S) of the F overflow rows, dead
    entries = n_ext, or None without real overflow rows.  Padding virtual
    rows (physical row 0, all-zero columns: a real spill row's first slot
    always holds an off-diagonal block) carry zero values and are left
    out."""
    ovf = np.asarray(ovf_rows, np.int64)
    f_cols = np.asarray(f_cols, np.int64)
    n_ext = f_cols.shape[0]
    virt = np.arange(n_vb, n_ext)
    real = (ovf != 0) | (f_cols[n_vb:, 0] != 0)
    virt, phys = virt[real], ovf[real]
    if len(virt) == 0:
        return None
    order = np.argsort(phys, kind="stable")
    virt, phys = virt[order], phys[order]
    counts = np.bincount(phys, minlength=n_vb)
    first = np.zeros(n_vb + 1, np.int64)
    np.cumsum(counts, out=first[1:])
    within = np.arange(len(phys)) - first[phys]
    spill = np.full((n_vb, int(counts.max())), n_ext, np.int64)
    spill[phys, within] = virt
    return spill


def build_bsr(space: TaylorHoodSpace, cells: CellArrays, dtype, device,
              bu: int | None = None, bp: int | None = None,
              row_multiple: int = 1, f_kmax: int = 0, gb_kmax: int = 0,
              with_mass: bool = True) -> BsrData:
    """Host construction of the BSR tables (``cells`` from
    ops/assembly.cell_arrays_numpy), uploaded to ``device``.

    ``row_multiple`` rounds the block-row and cell counts up (padding rows
    have zero values and column 0; padding cells zero detj/jinv).
    ``with_mass`` uploads the blocked mass values (the 2D mass format)."""
    dim = space.dim
    bu = bu or 16
    bp = bp or bu
    n_p2, n_p1 = space.n_p2, space.n_p1
    cp2 = np.asarray(space.cell_p2, dtype=np.int64)
    cp1 = np.asarray(space.cell_p1, dtype=np.int64)
    nc, nv = cp2.shape
    npp = cp1.shape[1]
    rup = lambda n: -(-n // row_multiple) * row_multiple
    nc_pad = rup(nc) - nc
    n_vb = rup(-(-n_p2 // bu))
    n_pb = rup(-(-n_p1 // bp))

    # ---- F block graph ----------------------------------------------------
    rows = np.repeat(cp2, nv, axis=1).reshape(-1)
    cols = np.tile(cp2, (1, nv)).reshape(-1)
    f_cols, KB, pair_keys, pr_row, k_of_pair, stride = _block_pairs(
        rows, cols, bu, bu, n_vb)
    # slots diagonal-first, so the diagonal stays physical under the split
    pc = (pair_keys % stride).astype(np.int64)
    is_diag = pc == pr_row
    diag_pos = np.zeros(n_vb, np.int64)
    diag_pos[pr_row[is_diag]] = k_of_pair[is_diag]
    kn = np.where(is_diag, 0,
                  np.where(k_of_pair < diag_pos[pr_row],
                           k_of_pair + 1, k_of_pair))
    if f_kmax == -1:
        # auto: K0*bu a multiple of 128, minimal extended storage
        counts = np.bincount(pr_row, minlength=n_vb)
        step_k = max(1, 128 // bu)
        cands = list(range(step_k, KB + step_k, step_k))

        def _cost(k0):
            spill = np.maximum(counts - k0, 0)
            return (n_vb + int(np.ceil(spill / k0).sum())) * k0
        f_kmax = min(cands, key=_cost)
    K0 = f_kmax if f_kmax > 0 else KB
    over = kn >= K0
    # the extended row count stays a multiple of 64 (the JAX package's
    # Pallas row tile), so the tables match it row for row
    TILE = 64
    if over.any():
        chunk = (kn[over] - K0) // K0
        vkey = pr_row[over] * 64 + chunk
        uniq, vinv = np.unique(vkey, return_inverse=True)
        n_or = rup(len(uniq))
        n_or += (-(n_vb + n_or)) % TILE
        ovf_rows_host = np.zeros(n_or, np.int64)
        ovf_rows_host[:len(uniq)] = uniq // 64
        vrow_pair = np.where(over, 0, pr_row)
        vrow_pair[over] = n_vb + vinv
        kext_pair = np.where(over, (kn - K0) % K0, kn)
    else:
        n_or = (-n_vb) % TILE
        ovf_rows_host = np.zeros(n_or, np.int64)
        vrow_pair = pr_row
        kext_pair = kn
    n_vb_ext = n_vb + n_or
    f_cols = np.zeros((n_vb_ext, K0), dtype=np.int64)
    f_cols[vrow_pair, kext_pair] = pc

    want = (rows // bu).astype(np.int64) * stride + (cols // bu)
    pos = np.searchsorted(pair_keys, want)
    slot = ((vrow_pair[pos] * bu + rows % bu) * K0
            + kext_pair[pos]) * bu + (cols % bu)
    n_slots = n_vb_ext * K0 * bu * bu

    # ---- row-blocked convection-assembly plan ----------------------------
    Cw = K0 * bu
    e_cell = np.repeat(np.arange(nc, dtype=np.int64), nv * nv)
    e_a = np.tile(np.repeat(np.arange(nv, dtype=np.int64), nv), nc)
    e_b = np.tile(np.arange(nv, dtype=np.int64), nc * nv)
    e_v = vrow_pair[pos]
    e_q = kext_pair[pos] * bu + (cols % bu)
    e_fr = e_v * bu + (rows % bu)
    ckey = (e_cell * nv + e_a) * np.int64(n_vb_ext) + e_v
    uniq_ck, idx0, inv_ck = np.unique(ckey, return_index=True,
                                      return_inverse=True)
    con_fr = e_fr[idx0]
    con_row = (e_cell * nv + e_a)[idx0]
    corder = np.argsort(con_fr, kind="stable")
    rank = np.empty(len(uniq_ck), np.int64)
    rank[corder] = np.arange(len(uniq_ck))
    con_fr, con_row = con_fr[corder], con_row[corder]
    con_cpos = np.full((len(uniq_ck), nv), -1, np.int64)
    con_cpos[rank[inv_ck], e_b] = e_q
    ncon = rup(len(con_row))
    if ncon > len(con_row):
        padn = ncon - len(con_row)
        con_row = np.concatenate([con_row, np.zeros(padn, np.int64)])
        con_cpos = np.concatenate(
            [con_cpos, np.full((padn, nv), -1, np.int64)])
        con_fr = np.concatenate(
            [con_fr, np.full(padn, n_vb_ext * bu - 1, np.int64)])
    con_splits = segsum_splits(con_fr, Cw, n_vb_ext * bu)
    con_lengths = [np.bincount(con_fr[i0:i1] - s0, minlength=s1 - s0)
                   for (i0, i1, s0, s1) in con_splits]

    def reduce_blk(elem_vals):
        out = np.zeros(n_slots)
        np.add.at(out, slot, elem_vals.reshape(-1))
        return out.reshape(n_vb_ext, bu, K0 * bu)

    m_blk = reduce_blk(np.asarray(cells.mass, np.float64))
    k_blk = reduce_blk(np.asarray(cells.stiff, np.float64))

    i_all = np.arange(n_p2, dtype=np.int64)
    Iall = i_all // bu
    pos_d = np.searchsorted(pair_keys, Iall * stride + Iall)
    diag_idx = ((vrow_pair[pos_d] * bu + i_all % bu) * K0
                + kext_pair[pos_d]) * bu + (i_all % bu)

    # ---- G (u rows, p cols), static ----------------------------------------
    grad = np.asarray(cells.grad, np.float64)            # (nc, nv, dim, npp)
    g_rows = np.repeat(cp2, npp, axis=1).reshape(-1)
    g_cols_flat = np.tile(cp1, (1, nv)).reshape(-1)
    g_tab, KG, gkeys, g_ru, gk_of, gstride = _block_pairs(
        g_rows, g_cols_flat, bu, bp, n_vb)
    g_tab_full = g_tab
    g_spill = None
    n_vbg = n_vb
    if gb_kmax == -1:
        g_vrow, g_kext, g_tab, g_spill, n_vbg, KG = _split_overflow(
            g_ru, gk_of, (gkeys % gstride).astype(np.int64), n_vb,
            128 // math.gcd(128, bp), rup)
    else:
        g_vrow, g_kext = g_ru, gk_of
    gwant = (g_rows // bu).astype(np.int64) * gstride + (g_cols_flat // bp)
    gpos = np.searchsorted(gkeys, gwant)
    gkb = g_kext[gpos]
    GI = g_vrow[gpos]
    g_vals = np.zeros(n_vbg * KG * dim * bu * bp)
    vals = grad.transpose(0, 1, 3, 2).reshape(-1, dim)
    for d in range(dim):
        gslot = (((GI * dim + d) * bu + g_rows % bu) * KG + gkb) * bp \
                + (g_cols_flat % bp)
        np.add.at(g_vals, gslot, vals[:, d])
    g_blk = g_vals.reshape(n_vbg, dim, bu, KG * bp)

    # ---- B (p rows, u cols), static ----------------------------------------
    b_rows = np.repeat(cp1, nv, axis=1).reshape(-1)
    b_cols_flat = np.tile(cp2, (1, npp)).reshape(-1)
    b_tab, KBb, bkeys, b_ru, bk_of, bstride = _block_pairs(
        b_rows, b_cols_flat, bp, bu, n_pb)
    b_spill = None
    n_pbe = n_pb
    if gb_kmax == -1:
        b_vrow, b_kext, b_tab, b_spill, n_pbe, KBb = _split_overflow(
            b_ru, bk_of, (bkeys % bstride).astype(np.int64), n_pb,
            128 // math.gcd(128, bu * dim), rup)
    else:
        b_vrow, b_kext = b_ru, bk_of
    bwant = (b_rows // bp).astype(np.int64) * bstride + (b_cols_flat // bu)
    bpos = np.searchsorted(bkeys, bwant)
    bkb = b_kext[bpos]
    BI = b_vrow[bpos]
    b_vals = np.zeros(n_pbe * KBb * dim * bp * bu)
    bsrc = grad.transpose(0, 3, 1, 2).reshape(-1, dim)
    for d in range(dim):
        bslot = ((((BI * bp + b_rows % bp) * KBb + bkb) * bu
                  + b_cols_flat % bu) * dim) + d
        np.add.at(b_vals, bslot, bsrc[:, d])
    b_blk = b_vals.reshape(n_pbe, bp, KBb * bu * dim)

    def pad_cells(a):
        a = np.asarray(a)
        if not nc_pad:
            return a
        return np.concatenate(
            [a, np.zeros((nc_pad,) + a.shape[1:], a.dtype)], axis=0)

    f = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                                  device=device)
    i32 = lambda a: torch.as_tensor(np.asarray(a).astype(np.int32),
                                    device=device)
    i64 = lambda a: torch.as_tensor(np.asarray(a).astype(np.int64),
                                    device=device)
    # ---- P1-P1 pressure graph (PCD convection), per-step values ----------
    p_rows = np.repeat(cp1, npp, axis=1).reshape(-1)
    p_cols_flat = np.tile(cp1, (1, npp)).reshape(-1)
    pp_cols, KPP, pkeys, _, pk_of, pstride = _block_pairs(
        p_rows, p_cols_flat, bp, bp, n_pb)
    pwant = (p_rows // bp).astype(np.int64) * pstride + (p_cols_flat // bp)
    pkb = pk_of[np.searchsorted(pkeys, pwant)]
    pp_slot = (((p_rows // bp) * KPP + pkb) * bp + p_rows % bp) * bp \
        + (p_cols_flat % bp)
    n_pp_slots = n_pb * KPP * bp * bp
    if nc_pad:
        pp_slot = np.concatenate(
            [pp_slot, np.full(nc_pad * npp * npp, n_pp_slots - 1, np.int64)])

    f_spill = spill_from_ovf(ovf_rows_host, f_cols, n_vb) if n_or else None
    ci, cn, cphi, cdphys = curved_conv_inputs(space)
    return BsrData(
        cell_p2=i64(pad_cells(cp2)), detj=f(pad_cells(cells.detj)),
        jinv=f(pad_cells(cells.jinv)), t_hat=f(space.rs.T_hat),
        con_row=i64(con_row), con_cpos=i64(con_cpos), con_seg=i64(con_fr),
        con_splits=con_splits,
        con_lengths=tuple(i64(x) for x in con_lengths),
        f_cols=i32(f_cols),
        f_spill=None if f_spill is None else i32(f_spill),
        diag_idx=i64(diag_idx),
        m_blk=f(m_blk) if with_mass else None,
        g_cols=i32(g_tab), g_blk=f(g_blk),
        b_cols=i32(b_tab), b_blk=f(b_blk),
        g_spill=None if g_spill is None else i32(g_spill),
        b_spill=None if b_spill is None else i32(b_spill),
        n_p2=n_p2, n_p1=n_p1, bu=bu, bp=bp, n_vb=n_vb, n_pb=n_pb,
        host=BsrHost(f_cols=f_cols, ovf_rows=ovf_rows_host,
                     g_cols_full=g_tab_full, m_blk=m_blk, k_blk=k_blk),
        curv_ids=None if ci is None else i64(ci),
        curv_nodes=None if ci is None else i64(cn),
        curv_phi=None if ci is None else f(cphi),
        curv_dphys=None if ci is None else f(cdphys),
        pp_cols=i32(pp_cols),
        pp_plan=segment_plan(pp_slot, n_pp_slots, device),
        tp_hat=f(space.rs.Tp_hat))


# ---------------------------------------------------------------------------
# applies
# ---------------------------------------------------------------------------


def _ublocks(bsr: BsrData, xu):
    """(n_p2, d) -> (n_vb*bu, d), zero-padded to whole blocks."""
    return Fn.pad(xu, (0, 0, 0, bsr.n_vb * bsr.bu - bsr.n_p2))


def apply_f(bsr: BsrData, f_blk, xu):
    """F xu for flat row-major values f_blk (n_vb_ext, bu, K*bu); xu
    (n_p2, d).  One SpMV for all d components, overflow rows folded.
    bf16 values (``inner_bf16``) take the bf16-values SpMV with fp32 x."""
    d = xu.shape[1]
    y = bsr_spmv(f_blk, bsr.f_cols, _ublocks(bsr, xu), bsr.bu,
                 bsr.f_spill, bsr.n_vb)                   # (n_vb, bu, d)
    return y.reshape(-1, d)[:bsr.n_p2].to(xu.dtype)


def apply_bt(bsr: BsrData, p):
    """G p: (n_p1,) -> (n_p2, dim)."""
    n_ext, dim, bu, cw = bsr.g_blk.shape
    pb = Fn.pad(p, (0, bsr.n_pb * bsr.bp - bsr.n_p1))[:, None]
    y = bsr_spmv(bsr.g_blk.view(n_ext, dim * bu, cw), bsr.g_cols, pb,
                 bsr.bp, bsr.g_spill, bsr.n_vb)          # (n_vb, dim*bu, 1)
    y = y.view(bsr.n_vb, dim, bu).transpose(1, 2)         # (n_vb, bu, dim)
    return y.reshape(-1, dim)[:bsr.n_p2]


def apply_b(bsr: BsrData, xu):
    """B xu = G^T xu: (n_p2, dim) -> (n_p1,)."""
    dim = xu.shape[1]
    ub = _ublocks(bsr, xu).reshape(-1, 1)                 # (n_vb*bu*dim, 1)
    z = bsr_spmv(bsr.b_blk, bsr.b_cols, ub, bsr.bu * dim, bsr.b_spill,
                 bsr.n_pb)                                # (n_pb, bp, 1)
    return z.reshape(-1)[:bsr.n_p1]


def f_diag(bsr: BsrData, f_blk):
    return f_blk.reshape(-1)[bsr.diag_idx]


def mass_apply(bsr: BsrData, u):
    return apply_f(bsr, bsr.m_blk, u)


def convection_blk(bsr: BsrData, u):
    """Per-step convection assembly into the flat row-major F layout:
    element matrices (ops/operators.convection_matrices, the reference's
    per-step T1 term, src/NavierStokes.cpp:204-208) reduced into the F
    slots by the presorted convection plan."""
    c_elem = convection_matrices(bsr, bsr.t_hat, u)       # (nc, nv, nv)
    nc, nv, _ = c_elem.shape
    n_vb_ext, K0 = bsr.f_cols.shape
    Cw = K0 * bsr.bu
    vals = onehot_segsum(c_elem.reshape(nc * nv, nv), bsr.con_row,
                         bsr.con_cpos, bsr.con_lengths, Cw, bsr.con_splits)
    return vals.reshape(n_vb_ext, bsr.bu, Cw)


def schur_diag(bsr: BsrData, node_weights):
    """diag(B diag(w) B^T) for node weights w (n_p2,): the SpMV of the
    squared B values against w repeated over the velocity components."""
    dim = bsr.b_blk.shape[2] // (bsr.b_cols.shape[1] * bsr.bu)
    wu = _ublocks(bsr, node_weights[:, None].expand(-1, dim)).reshape(-1, 1)
    z = bsr_spmv(bsr.b_blk * bsr.b_blk, bsr.b_cols, wu, bsr.bu * dim,
                 bsr.b_spill, bsr.n_pb)                   # (n_pb, bp, 1)
    return z.reshape(-1)[:bsr.n_p1]


def g_blocks(bsr: BsrData):
    """The flat G values as (n_vb, KG, dim, bu, bp) blocks (the Schur
    coarse assembly); needs whole-row G tables (build with gb_kmax=0)."""
    if bsr.g_spill is not None:
        raise ValueError("g_blocks needs whole-row G tables; build with "
                         "gb_kmax=0 (the Schur coarse plan contracts G "
                         "pairs within rows)")
    n_vb, KG = bsr.g_cols.shape
    dim = bsr.g_blk.shape[1]
    return bsr.g_blk.reshape(n_vb, dim, bsr.bu, KG, bsr.bp).permute(
        0, 3, 1, 2, 4)


def pressure_convection_blk(bsr: BsrData, u):
    """Per-step pressure-space convection N_p(u), np_ij = int psi_i (u .
    grad psi_j), the moving part of the PCD preconditioner's Fp.  Reduced
    into the JAX package's (n_pb, KPP, bp, bp) blocks, returned in the
    flat row-major layout (n_pb, bp, KPP*bp) that ``apply_pp`` reads."""
    u_c = u[bsr.cell_p2]                                  # (nc, n_v, dim)
    w = torch.einsum("cxd,ced->cxe", bsr.jinv, u_c) * bsr.detj[:, None, None]
    np_elem = torch.einsum("ijxe,cxe->cij", bsr.tp_hat, w)
    n_pb, KPP = bsr.pp_cols.shape
    bp = bsr.bp
    vals = bsr.pp_plan(np_elem.reshape(-1)).reshape(n_pb, KPP, bp, bp)
    return vals.transpose(1, 2).reshape(n_pb, bp, KPP * bp)


def apply_pp(bsr: BsrData, pp_flat, xp):
    """Pressure-graph matvec (n_p1,) -> (n_p1,) with the flat values of
    ``pressure_convection_blk``."""
    n_pb = bsr.pp_cols.shape[0]
    pb = Fn.pad(xp, (0, n_pb * bsr.bp - bsr.n_p1))[:, None]
    return bsr_spmv(pp_flat, bsr.pp_cols, pb, bsr.bp).reshape(-1)[:bsr.n_p1]


class BsrOps:
    """Operator interface of the model over BsrData (one F SpMV)."""

    def convection(self, bsr: BsrData, u):
        return convection_blk(bsr, u)

    def apply_blocks(self, bsr: BsrData, f_blk, xu, xp, with_f=True,
                     with_g=True, with_gt=True):
        """(F xu + G xp, B xu), each term optional."""
        yu = apply_f(bsr, f_blk, xu) if with_f else None
        if with_g:
            g = apply_bt(bsr, xp)
            yu = g if yu is None else yu + g
        if yu is None:
            yu = torch.zeros_like(xu)
        yp = apply_b(bsr, xu) if with_gt else torch.zeros_like(xp)
        return yu, yp

    def f_diag(self, bsr: BsrData, f_blk):
        return f_diag(bsr, f_blk)

    def mass_apply(self, bsr: BsrData, u):
        return mass_apply(bsr, u)

    def schur_diag(self, bsr: BsrData, node_weights):
        return schur_diag(bsr, node_weights)
