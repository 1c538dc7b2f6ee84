"""P1 blocked-ELL operators and the block-Jacobi velocity preconditioner.

Port of ``navierstokes_tpu/ops/p1ell.py`` (the 2D blocked subset):

* ``assemble_p1_stiffness`` — the consistent P1 Laplacian of the pressure
  Poisson solve, host-assembled into a blocked ELL, applied through the
  blocked-ELL SpMV kernel (``ell_matvec``).
* ``assemble_ap`` — the Cahouet-Chabard / PCD pressure operator
  Ap = B diag(w) B^T, host-assembled the same way.
* Block-Jacobi — the 256x256 tile diagonals of the BC-masked F, gathered
  per step as whole (bu, bu) blocks ("blocked" layout), inverted by
  Newton-Schulz from the static-operator seed with an exact-inverse
  fallback, applied as batched matmuls (the reference's ILU(0) stand-in,
  src/NavierStokes.cpp:958).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as Fn

from navierstokes_tpu_torch.kernels.bsr_spmv import bsr_spmv


@dataclasses.dataclass
class EllBlocked:
    """Square blocked-ELL matrix over one scalar field (P1 pressure);
    values in the flat row-major layout (n_b, b, K*b), K*b a multiple
    of 128."""
    cols: torch.Tensor       # (n_b, K) int32 block columns
    vals: torch.Tensor       # (n_b, b, K*b)
    diag: torch.Tensor       # (n,) assembled diagonal
    n: int
    b: int
    host_vals: np.ndarray    # (n_b, K, b, b) float64 block layout
    host_cols: np.ndarray    # (n_b, K) int64


def _to_blocked_ell(rows, cols, vals, n, b, dtype, device):
    """COO (with duplicates) -> blocked ELL, summing duplicates."""
    n_b = -(-n // b)
    RI = rows // b
    CJ = cols // b
    stride = np.int64(n_b + 1)
    key = RI.astype(np.int64) * stride + CJ
    uk = np.unique(key)
    ru = (uk // stride).astype(np.int64)
    counts = np.bincount(ru, minlength=n_b)
    K = max(1, int(counts.max()))
    lane_k = max(1, 128 // b)
    K = -(-K // lane_k) * lane_k
    row_start = np.zeros(n_b + 1, np.int64)
    np.cumsum(counts, out=row_start[1:])
    k_of = np.arange(len(uk)) - row_start[ru]
    table = np.zeros((n_b, K), np.int64)
    table[ru, k_of] = uk % stride
    pos = np.searchsorted(uk, key)
    kb = k_of[pos]
    out = np.zeros((n_b, K, b, b))
    np.add.at(out, (RI, kb, rows % b, cols % b), vals)
    diag = np.zeros(n)
    d = rows == cols
    np.add.at(diag, rows[d], vals[d])
    flat = out.transpose(0, 2, 1, 3).reshape(n_b, b, K * b)
    return EllBlocked(
        cols=torch.as_tensor(table.astype(np.int32), device=device),
        vals=torch.as_tensor(flat, dtype=dtype, device=device),
        diag=torch.as_tensor(diag, dtype=dtype, device=device),
        n=n, b=b, host_vals=out, host_cols=table)


def ell_matvec(m: EllBlocked, x):
    """y = M x for x (n,)."""
    n_b = m.cols.shape[0]
    xb = Fn.pad(x, (0, n_b * m.b - m.n))[:, None]
    return bsr_spmv(m.vals, m.cols, xb, m.b).reshape(-1)[:m.n]


def assemble_ap(space, cells_host, w, dtype, device, b=16):
    """Ap = sum_d B_d diag(w) B_d^T on the P1-P1 graph (host assembly);
    ``w`` (n_p2,) are the node weights (BC mask / lumped mass) and B_d the
    per-cell gradient couplings of the reference
    (src/NavierStokes.cpp:222-229)."""
    import scipy.sparse as sp

    cp2 = np.asarray(space.cell_p2, np.int64)
    cp1 = np.asarray(space.cell_p1, np.int64)
    npp = cp1.shape[1]
    grad = np.asarray(cells_host.grad, np.float64)       # (nc, nv, dim, npp)
    rows = np.repeat(cp1, cp2.shape[1], axis=1).ravel()  # p index
    cols = np.tile(cp2, (1, npp)).ravel()                # u node index
    ap = None
    for d in range(grad.shape[2]):
        v = grad[:, :, d, :].transpose(0, 2, 1).reshape(-1)
        B = sp.csr_matrix((v, (rows, cols)), shape=(space.n_p1, space.n_p2))
        t = (B.multiply(np.asarray(w)[None, :])) @ B.T
        ap = t if ap is None else ap + t
    ap = ap.tocoo()
    return _to_blocked_ell(ap.row.astype(np.int64), ap.col.astype(np.int64),
                           ap.data, space.n_p1, b, dtype, device)


def assemble_p1_stiffness(space, cells_host, dtype, device, b=16,
                          dirichlet_nodes=None):
    """Consistent P1 stiffness Laplacian L[q, r] = int grad psi_q .
    grad psi_r (host assembly), phi = 0 pinned at ``dirichlet_nodes``
    (rows/cols zeroed, diagonal = mean |diag|)."""
    import scipy.sparse as sp

    from navierstokes_tpu_torch.ops.assembly import geometric_factors
    detj, jinv = geometric_factors(space)
    if space.dim == 2:
        gref = np.array([[-1., -1.], [1., 0.], [0., 1.]])
        meas = 0.5
    else:
        gref = np.array([[-1., -1., -1.],
                         [1., 0., 0.], [0., 1., 0.], [0., 0., 1.]])
        meas = 1.0 / 6.0
    gp = np.einsum("ax,cxd->cad", gref, jinv)
    ke = np.einsum("cad,cbd,c->cab", gp, gp, detj * meas)
    cd = space.curved_data()
    if cd is not None:
        wdet = cd.qw[None, :] * cd.detj_q
        gp_k = np.einsum("ax,kqxd->kqad", gref, cd.jinv_q)
        ke[cd.ids] = np.einsum("kq,kqad,kqbd->kab", wdet, gp_k, gp_k)
    cp1 = np.asarray(space.cell_p1, np.int64)
    npp = cp1.shape[1]
    rows = np.repeat(cp1, npp, axis=1).ravel()
    cols = np.tile(cp1, (1, npp)).ravel()
    L = sp.csr_matrix((ke.ravel(), (rows, cols)),
                      shape=(space.n_p1, space.n_p1))
    if dirichlet_nodes is not None and len(dirichlet_nodes):
        L = L.tolil()
        scale = np.abs(L.diagonal()).mean() + 1e-30
        L[dirichlet_nodes, :] = 0.0
        L[:, dirichlet_nodes] = 0.0
        L[dirichlet_nodes, dirichlet_nodes] = scale
        L = L.tocsr()
    L = L.tocoo()
    return _to_blocked_ell(L.row.astype(np.int64), L.col.astype(np.int64),
                           L.data, space.n_p1, b, dtype, device)


def coarse_from_ell(m: EllBlocked, agg_blocks: int) -> np.ndarray:
    """Galerkin coarse matrix over aggregates of ``agg_blocks`` consecutive
    blocks: S_c[a, b] = sum of entries between the aggregates (host)."""
    n_b, K = m.host_cols.shape
    n_agg = -(-n_b // agg_blocks)
    ra = np.repeat(np.arange(n_b) // agg_blocks, K)
    ca = (m.host_cols // agg_blocks).reshape(-1)
    s = m.host_vals.sum(axis=(2, 3)).reshape(-1)
    sc = np.zeros((n_agg, n_agg))
    np.add.at(sc, (ra, ca), s)
    return sc


# ---------------------------------------------------------------------------
# block-Jacobi tile preconditioner for F ("blocked" layout)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BlockJacobiPlan:
    """Static gather plan: F value blocks -> (n_tiles, S*bu, S*bu) tile
    diagonals.  ``bidx[t, s, s']`` is the (v*KB + k) index of the (bu, bu)
    value block holding tile t's (s, s') block, or n_vb_ext*KB for a
    missing pair (a zero block the tile build appends).  ``idx`` keeps the
    JAX package's flat base indices (v*bu*KB + k)*bu."""
    idx: np.ndarray          # (n_tiles, S, S) int64, host
    bidx: torch.Tensor       # (n_tiles, S, S) int64, clamped on the host
    n_tiles: int
    S: int
    bu: int
    n_p2: int


def build_block_jacobi_plan(f_cols, ovf_rows, n_vb: int, bu: int, n_p2: int,
                            S: int, device) -> BlockJacobiPlan:
    """Tile plan from the host F tables (ops/bsr.BsrHost f_cols/ovf_rows);
    virtual overflow rows belong to their physical row's tile diagonal."""
    f_cols = np.asarray(f_cols, np.int64)
    n_vb_ext, KB = f_cols.shape
    row_phys = np.arange(n_vb_ext)
    if n_vb_ext > n_vb:
        row_phys[n_vb:] = np.asarray(ovf_rows, np.int64)
    n_tiles = -(-n_vb // S)
    C = KB * bu
    zero_base = n_vb_ext * bu * C
    if zero_base + bu * C >= 2 ** 31:
        raise ValueError("block-Jacobi flat indices exceed int32 range "
                         f"(n_vb_ext={n_vb_ext}, C={C})")
    idx = np.full((n_tiles, S, S), zero_base, np.int64)
    r = np.repeat(row_phys, KB)
    v = np.repeat(np.arange(n_vb_ext), KB)
    k = np.tile(np.arange(KB), n_vb_ext)
    c = f_cols.reshape(-1)
    on_tile = (r // S) == (c // S)
    r, v, k, c = r[on_tile], v[on_tile], k[on_tile], c[on_tile]
    # ELL padding slots carry block-column 0 with zero values; write
    # k-descending, virtual rows first, so a real physical (r, 0) pair
    # (low k) overwrites any padding collision
    order = np.lexsort((-k, -v))
    r, v, k, c = r[order], v[order], k[order], c[order]
    idx[r // S, r % S, c % S] = (v * bu * KB + k) * bu
    base = idx // bu
    vv = base // (bu * KB)
    bidx = np.minimum(vv * KB + (base - vv * (bu * KB)), n_vb_ext * KB)
    return BlockJacobiPlan(idx=idx,
                           bidx=torch.as_tensor(bidx, device=device),
                           n_tiles=n_tiles, S=S, bu=bu, n_p2=n_p2)


def block_jacobi_tiles(plan: BlockJacobiPlan, f_blk, mask_flat, sigma):
    """fp32 tile diagonals of the BC-masked F: M F M + sigma (I - M)."""
    bu = plan.bu
    SB = plan.S * bu
    n_vb, _, C = f_blk.shape
    KB = C // bu
    blocks = f_blk.reshape(n_vb, bu, KB, bu).transpose(1, 2)
    flat = torch.cat([blocks.reshape(n_vb * KB, bu, bu),
                      f_blk.new_zeros((1, bu, bu))], dim=0)
    tiles = flat[plan.bidx]                               # (t, S, S, bu, bu)
    t = tiles.permute(0, 1, 3, 2, 4).reshape(plan.n_tiles, SB, SB)
    n = plan.n_tiles * SB
    m = Fn.pad(mask_flat, (0, n - plan.n_p2)).reshape(plan.n_tiles, SB)
    t = t * m[:, :, None] * m[:, None, :]
    eye = torch.eye(SB, dtype=t.dtype, device=t.device)
    t = t + (sigma * (1.0 - m))[:, :, None] * eye[None]
    return t.to(torch.float32)


def _inv(a):
    """(Batched) inverse by LU with partial pivoting.  On the card:
    ``torch.linalg.inv``.  On the CPU a single matrix (the Schur coarse
    inverse) goes through SciPy's LAPACK getrf and getrs, the routines the
    JAX package's CPU inverse calls, so the two give the same bits: its
    fp32 rounding otherwise reaches 5e-9 of p in the float64 aYosida step.
    A batch (the block-Jacobi tiles) is inverted one matrix at a time: the
    batched LAPACK path of torch's CPU build hangs with more than one
    thread (oneMKL rejects its ?LASWP call)."""
    if a.is_cuda:
        return torch.linalg.inv(a)
    if a.dim() == 2:
        import scipy.linalg
        m = a.numpy()
        lu = scipy.linalg.lu_factor(m, check_finite=False)
        return torch.as_tensor(scipy.linalg.lu_solve(
            lu, np.eye(m.shape[0], dtype=m.dtype), check_finite=False))
    return torch.stack([torch.linalg.inv(t) for t in a])


def block_jacobi_inverse(plan: BlockJacobiPlan, f_blk, mask_flat, sigma):
    """Exact tile inverses (the Newton seed of block_jacobi_invert)."""
    a = block_jacobi_tiles(plan, f_blk, mask_flat, sigma)
    return _inv(a).to(f_blk.dtype)


def block_jacobi_invert(plan: BlockJacobiPlan, f_blk, mask_flat, sigma,
                        x0=None, iters: int = 3):
    """Per-step tile inverses: ``iters`` Newton-Schulz steps
    X <- X (2I - A X) from the static seed ``x0``, in fp32, with an exact
    inverse when the seed is outside the contraction region
    (max row-sum norm of I - A X0 >= 0.9).  A deterministic function of
    the step state, so restarts reproduce the continuous run."""
    a = block_jacobi_tiles(plan, f_blk, mask_flat, sigma)
    out_dtype = f_blk.dtype
    if x0 is None or iters <= 0:
        return _inv(a).to(out_dtype)
    x = x0.to(torch.float32)
    ax = torch.matmul(a, x)
    eye = torch.eye(a.shape[-1], dtype=torch.float32, device=a.device)
    r = (eye[None] - ax).abs().sum(-1).max()
    if not bool(r < 0.9):
        return _inv(a).to(out_dtype)
    for i in range(iters):
        x = 2.0 * x - torch.matmul(x, ax)
        if i + 1 < iters:
            ax = torch.matmul(a, x)
    return x.to(out_dtype)


def block_jacobi_apply(plan: BlockJacobiPlan, inv_tiles, r):
    """x = blockdiag(F_t)^-1 r for r (n_p2, d): batched matmuls in the
    tiles' dtype (bf16 tiles under ``inner_bf16`` / ``bj_bf16``: r is
    rounded to bf16 and the product is bf16), cast back to r's dtype."""
    n = plan.n_tiles * plan.S * plan.bu
    rb = Fn.pad(r, (0, 0, 0, n - plan.n_p2)).reshape(
        plan.n_tiles, plan.S * plan.bu, -1)
    y = torch.matmul(inv_tiles, rb.to(inv_tiles.dtype))
    return y.reshape(n, -1)[:plan.n_p2].to(r.dtype)
