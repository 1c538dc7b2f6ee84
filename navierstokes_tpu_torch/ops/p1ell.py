"""P1 operators and the block-Jacobi velocity preconditioner.

Port of ``navierstokes_tpu/ops/p1ell.py`` (the subset the BSR path reads,
on triangles and tetrahedra), in the compact SELL layout of
``ops/sell.py`` where the JAX package keeps blocked ELLs:

* ``assemble_p1_stiffness`` — the consistent P1 Laplacian of the pressure
  Poisson solve, host-assembled, applied through the SELL SpMV kernel
  (``ell_matvec``, the JAX function's name).
* ``assemble_ap`` — the Cahouet-Chabard / PCD pressure operator
  Ap = B diag(w) B^T, host-assembled the same way.
* Block-Jacobi — the 256x256 tile diagonals of the BC-masked F, built
  per step from the compact F values by a static plan, inverted by
  Newton-Schulz from the static-operator seed with an exact-inverse
  fallback (the tiles by the rebuild kernel of ``kernels/bj_tiles.py``,
  the products with the guard and the updates in their epilogues by the
  GEMM of ``kernels/bj_gemm.py``, the fallback on the card by the
  Gauss-Jordan kernel of ``kernels/bj_inverse.py``), applied
  by the tile-apply kernel (``kernels/bj_apply.py``; the reference's
  ILU(0) stand-in, src/NavierStokes.cpp:958).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses

import numpy as np
import torch

from navierstokes_tpu_torch.kernels import bj_gemm, bj_inverse, bj_tiles
from navierstokes_tpu_torch.kernels.bj_apply import bj_apply
from navierstokes_tpu_torch.kernels.sell_spmv import sell_spmv
from navierstokes_tpu_torch.ops.sell import SellMatrix, sell_from_coo


@dataclasses.dataclass
class P1Matrix:
    """Square compact matrix over one scalar field (P1 pressure)."""
    mat: SellMatrix
    vals: torch.Tensor       # (n_slots,)
    diag: torch.Tensor       # (n,) assembled diagonal
    n: int
    b: int                   # node-block size of the coarse aggregates
    host_vals: np.ndarray    # (nnz,) float64, in mat's (row, col) order


def _to_p1_matrix(rows, cols, vals, n, b, dtype, device, name):
    """COO (with duplicates, summed) -> compact matrix ``name``."""
    mat, nz = sell_from_coo(rows, cols, vals, n, n, device, name)
    diag = np.zeros(n)
    d = mat.nz_row == mat.nz_col
    diag[mat.nz_row[d]] = nz[d]
    return P1Matrix(mat=mat, vals=mat.values(nz, dtype),
                    diag=torch.as_tensor(diag, dtype=dtype, device=device),
                    n=n, b=b, host_vals=nz)


def ell_matvec(m: P1Matrix, x):
    """y = M x for x (n,)."""
    return sell_spmv(m.mat, m.vals, x.contiguous())


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
    return _to_p1_matrix(ap.row.astype(np.int64), ap.col.astype(np.int64),
                         ap.data, space.n_p1, b, dtype, device, "Ap")


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
    return _to_p1_matrix(L.row.astype(np.int64), L.col.astype(np.int64),
                         L.data, space.n_p1, b, dtype, device,
                         "P1 Laplacian")


def coarse_from_ell(m: P1Matrix, agg_blocks: int) -> np.ndarray:
    """Galerkin coarse matrix over aggregates of ``agg_blocks`` consecutive
    node blocks: S_c[a, b] = sum of entries between the aggregates
    (host)."""
    agg = agg_blocks * m.b
    n_agg = -(-m.n // agg)
    sc = np.zeros((n_agg, n_agg))
    np.add.at(sc, (m.mat.nz_row // agg, m.mat.nz_col // agg), m.host_vals)
    return sc


# ---------------------------------------------------------------------------
# block-Jacobi tile preconditioner for F ("blocked" layout)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BlockJacobiPlan:
    """Static scatter plan: compact F values -> (n_tiles, S*bu, S*bu) tile
    diagonals.  Tile t covers the nodes [t*S*bu, (t+1)*S*bu); ``src`` lists
    the F slots of the nonzeros whose row and column share a tile and
    ``pos`` their flat positions in the tile stack (each position once),
    sorted by position; the pairs of row g of the stack (tile g // (S*bu))
    are ``row_ptr[g]:row_ptr[g + 1]`` (kernels/bj_tiles.plan_arrays)."""
    pos: torch.Tensor        # (n_on,) int32, ascending
    src: torch.Tensor        # (n_on,) int32
    n_tiles: int
    S: int
    bu: int
    n_p2: int
    row_ptr: torch.Tensor = None     # (n_tiles * S * bu + 1,) int32


def build_block_jacobi_plan(f: SellMatrix, bu: int, n_p2: int, S: int,
                            device, col0: int = 0) -> BlockJacobiPlan:
    """Tile plan of the F pattern ``f`` (ops/bsr.BsrData.f): S node blocks
    of ``bu`` nodes per tile.  A row shard of F (parallel/sharded_bsr.py)
    passes its ``n_p2`` rows and the node ``col0`` of its first row, a
    multiple of S * bu."""
    SB = S * bu
    n_tiles = -(-n_p2 // SB)
    if n_tiles * SB * SB >= 2 ** 31:
        raise ValueError(f"block-Jacobi tiles of {n_tiles * SB * SB} "
                         "values exceed int32 range")
    r, c = f.nz_row, f.nz_col - col0
    on = (r // SB) == (c // SB)
    pos = (r[on] // SB) * (SB * SB) + (r[on] % SB) * SB + c[on] % SB
    pos, src, row_ptr = bj_tiles.plan_arrays(pos, f.nz_slot[on],
                                             n_tiles * SB, SB)
    return BlockJacobiPlan(pos=torch.as_tensor(pos, device=device),
                           src=torch.as_tensor(src, device=device),
                           row_ptr=torch.as_tensor(row_ptr, device=device),
                           n_tiles=n_tiles, S=S, bu=bu, n_p2=n_p2)


def block_jacobi_tiles(plan: BlockJacobiPlan, f_vals, mask_flat, sigma):
    """fp32 tile diagonals of the BC-masked F: M F M + sigma (I - M), in
    one write (kernels/bj_tiles.tiles; ``mask_flat`` in ``f_vals``'
    dtype)."""
    return bj_tiles.tiles(plan, f_vals, mask_flat.contiguous(), sigma)


@contextlib.contextmanager
def _cusolver():
    """PyTorch's cuSOLVER / cuBLAS linear-algebra backend for the calls
    inside.  Its default takes MAGMA for a batch of 256x256 LU
    factorisations, which cannot be captured into a CUDA graph."""
    old = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(old)


def _inv(a):
    """(Batched) inverse by LU with partial pivoting.  On the card
    ``torch.linalg.inv_ex``, which leaves its error flag on the device (no
    host read) and gives ``torch.linalg.inv``'s bits.  On the CPU a single matrix (the Schur coarse inverse) goes through SciPy's
    LAPACK getrf and getrs, the routines the JAX package's CPU inverse
    calls, so the two give the same bits: its fp32 rounding otherwise
    reaches 5e-9 of p in the float64 aYosida step.  A batch is inverted
    one matrix at a time: the batched LAPACK path of torch's CPU build
    hangs with more than one thread (oneMKL rejects its ?LASWP call)."""
    if a.is_cuda:
        return torch.linalg.inv_ex(a).inverse
    if a.dim() == 2:
        import scipy.linalg
        m = a.numpy()
        lu = scipy.linalg.lu_factor(m, check_finite=False)
        return torch.as_tensor(scipy.linalg.lu_solve(
            lu, np.eye(m.shape[0], dtype=m.dtype), check_finite=False))
    return torch.stack([torch.linalg.inv(t) for t in a])


def _inv_capturable(a):
    """``_inv`` that a CUDA graph can capture (the Schur coarse matrix):
    on the card through the cuSOLVER / cuBLAS backend (``_cusolver``), in
    the captured step (models/step_graphs.py) and the eager one alike."""
    if not a.is_cuda:
        return _inv(a)
    with _cusolver():
        return torch.linalg.inv_ex(a).inverse


def block_jacobi_inverse(plan: BlockJacobiPlan, f_vals, mask_flat, sigma):
    """Exact tile inverses (the Newton seed of block_jacobi_invert).  On the
    card the seed is stored row-major (one copy, once per model), so that
    the GEMM of kernels/bj_gemm.py reads the right operand of every
    Newton-Schulz product along its rows; a product's bits do not depend
    on its operands' layouts."""
    a = block_jacobi_tiles(plan, f_vals, mask_flat, sigma)
    x = _inv(a).to(f_vals.dtype)
    return x.contiguous() if x.is_cuda else x


# Exact tile inversions (``BJ_INVERSIONS["exact"]``): the model flags the
# steps whose rebuild took the exact inverse (StepMetrics.exact_inverse).
BJ_INVERSIONS = collections.Counter()


def block_jacobi_invert(plan: BlockJacobiPlan, f_vals, mask_flat, sigma,
                        x0=None, iters: int = 3, out_dtype=None):
    """Per-step tile inverses: ``iters`` Newton-Schulz steps
    X <- X (2I - A X) from the static seed ``x0``, in fp32, with an exact
    inverse when the seed is outside the contraction region
    (max row-sum norm of I - A X0 >= 0.9), row-major in ``out_dtype``
    (default: ``f_vals``' dtype).  A deterministic function of the step
    state, so restarts reproduce the continuous run."""
    return block_jacobi_invert_parts([(plan, f_vals, mask_flat, sigma, x0)],
                                     iters, out_dtype)[0]


def block_jacobi_invert_parts(parts, iters: int = 3, out_dtype=None):
    """``block_jacobi_invert`` of the tile stacks of several row shards,
    ``parts`` = [(plan, f_vals, mask_flat, sigma, x0), ...] each on its own
    device.  The exact-inverse guard takes the largest norm over all
    tiles of all parts, on the first part's device, so every shard makes
    the one decision a single stack would; it is read once, before the
    branch (JAX's ``lax.cond``)."""
    g = block_jacobi_guard(parts, iters, out_dtype)
    if g.norm is None or not bool(g.norm < GUARD_LIMIT):
        return block_jacobi_exact(g)
    return block_jacobi_newton(g, iters)


# The Newton-Schulz seed is used while max row-sum |I - A X0| < GUARD_LIMIT.
GUARD_LIMIT = 0.9


@dataclasses.dataclass
class BjGuard:
    """The step's tile stacks and the Newton-Schulz guard, before the
    branch: ``norm`` the max row-sum norm of I - A X0 over every tile of
    every part (0-d, on the first part's device), None when the exact
    inverse is forced (no seed or no Newton-Schulz steps)."""
    tiles: list
    xs: list
    axs: list
    norm: torch.Tensor | None
    out_dtype: torch.dtype


def block_jacobi_guard(parts, iters: int = 3, out_dtype=None,
                       partials=None) -> BjGuard:
    """The tiles of ``parts`` (as ``block_jacobi_invert_parts``), the seed
    X0 in fp32, A X0 and the guard norm (each row of I - A X0 summed as a
    pairwise tree, in fp32), all on the devices: no host read.  On the card
    A X0 and the norm are one launch of the GEMM's guard epilogue
    (kernels/bj_gemm.guard) and the max of its partials; on the CPU
    ``torch.matmul`` and ``bj_tiles.guard_plain``, the same bits as before
    the GEMM.  ``out_dtype``: the inverses' dtype (default the first
    part's F values'); ``partials``: the guard's scratch per part
    (``bj_gemm.guard_partials``, the captured step's, allocated outside
    the capture), allocated per call when None."""
    tiles = [block_jacobi_tiles(plan, f, m, s) for plan, f, m, s, _ in parts]
    out_dtype = parts[0][1].dtype if out_dtype is None else out_dtype
    x0s = [p[4] for p in parts]
    if x0s[0] is None or iters <= 0:
        return BjGuard(tiles, [], [], None, out_dtype)
    xs = [x0.to(torch.float32) for x0 in x0s]
    res = [bj_gemm.guard(a, x, None if partials is None else partials[k])
           for k, (a, x) in enumerate(zip(tiles, xs))]
    axs = [ax for ax, _ in res]
    norms = [n for _, n in res]
    home = norms[0].device
    norm = (norms[0] if len(norms) == 1 else
            torch.stack([n.to(home) for n in norms]).max())
    return BjGuard(tiles, xs, axs, norm, out_dtype)


def block_jacobi_exact(g: BjGuard, out=None):
    """The exact tile inverses (the guard's fallback branch), row-major in
    ``g.out_dtype``, written into ``out[k]`` for part k where given (the
    captured step's tile buffer).  On the card Gauss-Jordan with partial
    pivoting in fp32, one launch per part (kernels/bj_inverse.inverse,
    csrc/bj_inverse.cu).  A part on the CPU keeps LAPACK's per-tile
    inverse (``_inv``), the CPU model's route before the kernel:
    chip_smoke.py holds the card's steps to CPU runs within the gap
    between two of them in other thread counts, and with the kernel's
    plain version (``bj_inverse.inverse_plain``, held to JAX by
    tests/test_torch_bj_inverse.py) in their place that gap shrinks below
    the card's at the ``projection p_out`` fixture's fifth step, a
    step where fp32 runs scatter by 2e-4 around float64 (PERF.md)."""
    BJ_INVERSIONS["exact"] += 1
    res = []
    for k, a in enumerate(g.tiles):
        o = None if out is None else out[k]
        if a.is_cuda:
            res.append(bj_inverse.inverse(a, out_dtype=g.out_dtype, out=o))
            continue
        x = _inv(a).to(g.out_dtype)
        res.append(x if o is None else o.copy_(x))
    return res


def block_jacobi_newton(g: BjGuard, iters: int, out=None):
    """``iters`` Newton-Schulz steps X <- 2X - X (A X) from the seed (the
    guard's main branch).  On the card each step is one launch of the
    GEMM's update epilogue (kernels/bj_gemm.update: X (A X) and 2X minus
    it) and, between steps, one of its product epilogue (A X); on the CPU
    ``torch.matmul`` and ``bj_tiles.update_plain``, the same bits as before
    the GEMM.  The updates keep the seed's layout (row-major on the card,
    ``block_jacobi_inverse``), as PyTorch's elementwise ops do; the last
    writes row-major in ``g.out_dtype``, into ``out[k]`` for part k where
    given (the captured step's tile buffer)."""
    res = []
    for k, (a, x, ax) in enumerate(zip(g.tiles, g.xs, g.axs)):
        for i in range(iters):
            if i + 1 < iters:
                x = bj_gemm.update(x, ax)
                ax = bj_gemm.product(a, x)
            else:
                x = bj_gemm.update(x, ax, out_dtype=g.out_dtype,
                                   out=None if out is None else out[k])
        res.append(x)
    return res


def block_jacobi_apply(plan: BlockJacobiPlan, inv_tiles, r):
    """x = blockdiag(F_t)^-1 r for r (n_p2, d): the tile apply of
    ``kernels/bj_apply.py`` (csrc/bj_apply.cu on the card, batched matmuls
    on the CPU) in the tiles' dtype (bf16 tiles under ``inner_bf16`` /
    ``bj_bf16``: r is rounded to bf16 and the product is bf16), cast back
    to r's dtype."""
    SB = plan.S * plan.bu
    if inv_tiles.shape[:2] != (plan.n_tiles, SB) or r.shape[0] != plan.n_p2:
        raise ValueError(f"block_jacobi_apply: tiles {tuple(inv_tiles.shape)}"
                         f" and r {tuple(r.shape)} for a plan of "
                         f"{plan.n_tiles} tiles of {SB} rows over "
                         f"{plan.n_p2} nodes")
    return bj_apply(inv_tiles, r)
