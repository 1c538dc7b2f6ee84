"""The block-Jacobi exact tile inverse of the port (``kernels/bj_inverse.py``;
its CUDA kernel csrc/bj_inverse.cu runs only on the card, see
tests/test_torch_cuda.py) against the JAX package's ``jnp.linalg.inv`` in
``navierstokes_tpu/ops/p1ell.py`` ``block_jacobi_invert``, on the CPU:

* ``inverse_plain`` within 1e-5 of max|inv| of ``jnp.linalg.inv`` on the
  same fp32 tiles at SB = 64 and 256 (seeded tiles and tiles built by
  JAX's ``block_jacobi_tiles``), with a residual max-row-sum |I - A X| at
  most 10x JAX's (both are fp32 eliminations with partial pivoting, in
  other orders: same order of error, other bits);
* the pivots: ties go to the lowest row position, the same row order as
  LAPACK's getrf on tiles whose elimination is exact; a NaN tile and a
  singular one come out non-finite, the other tiles of the batch not;
* a CPU model of the kernel's schedule (clusters of 64-column CTAs,
  panels of 16 owned cyclically and factored by their owner, the next
  panel's owner updating its columns of that panel first and factoring it
  before its other columns, the pivot rows through each panel, the other
  rows' blocks, rows left in place with their positions) equals
  ``inverse_plain`` bit for bit, SB 64 to 512, with NaN, singular, tied
  and row-swapping tiles;
* the output dtypes (fp32, bf16, fp64 rounded once from fp32) and ``out=``
  slots of a larger buffer; what the wrapper refuses;
* ``block_jacobi_invert`` with no Newton-Schulz steps and on the guard's
  exact branch against JAX's ``block_jacobi_invert``: the slice as a whole
  (on the CPU the model keeps LAPACK's per-tile inverse, see
  ``ops/p1ell.block_jacobi_exact``);
* the kernel's wrapper takes the plain version for CPU tensors: no
  launch, no plain call counted on CUDA tensors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from navierstokes_tpu.ops import p1ell as JP
from navierstokes_tpu_torch.kernels import bj_inverse as BI
from navierstokes_tpu_torch.ops import p1ell as TP
from test_torch_bj_tiles import _port_plan, _seed_case

torch.set_num_threads(2)


def _same_bits(a, b):
    """Equal dtype and shape, NaN at the same places, the same bits
    everywhere else."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    na, nb = torch.isnan(a), torch.isnan(b)
    it = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return (torch.equal(na, nb) and torch.equal(
        a.masked_fill(na, 0).contiguous().view(it),
        b.masked_fill(nb, 0).contiguous().view(it)))


def _tiles(SB, n, seed):
    """Seeded fp32 tiles, diagonally dominant like the F tiles."""
    rng = np.random.default_rng(seed)
    a = (np.eye(SB)[None] * (2.0 + rng.uniform(size=(n, SB, 1)))
         + rng.standard_normal((n, SB, SB)) / np.sqrt(SB))
    return a.astype(np.float32)


def _hadamard(n):
    h = np.ones((1, 1))
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


def _ties(SB, seed):
    """A tile of 16 x 16 Hadamard blocks, rows permuted and signed: every
    column's candidates tie, and every step is exact in fp32."""
    rng = np.random.default_rng(seed)
    t = np.kron(np.eye(SB // 16), _hadamard(16))
    return (t[rng.permutation(SB)]
            * rng.choice([-1.0, 1.0], (SB, 1))).astype(np.float32)


def _residual(a, x):
    """max row sum of |I - A X| in float64."""
    a, x = np.asarray(a, np.float64), np.asarray(x, np.float64)
    return np.abs(np.eye(a.shape[-1]) - a @ x).sum(-1).max()


def _kernel_model(a):
    """csrc/bj_inverse.cu's schedule on one fp32 tile (SB, SB): CTAs of
    COLUMNS columns, panel P (PANEL columns) in CTA P mod C (cyclic, so CTA
    c holds panels c, c + C, ...), factored by its owner (pivot by (key,
    lowest position), the row scaled by its reciprocal) into multipliers F
    and a header (pivot rows, reciprocals, the pivot rows' multipliers);
    each CTA takes the panel's pivot rows through its steps on its columns
    (B') and its other rows' blocks less the sum of the panel's products
    (B).  Look-ahead: when panel P is out, the owner of P + 1 applies P to
    its 16 columns of P + 1 first, factors P + 1 from them, and applies P
    to its other columns after; every other CTA applies P to all its
    columns.  Rows never move; the result is written at (pos[r],
    perm[g]) through the cyclic column map."""
    SB, W, NB = a.shape[0], BI.COLUMNS, BI.PANEL
    C, NP = BI.cluster(SB), SB // NB
    owner = lambda P: P % C                          # noqa: E731
    lcol = lambda P: (P // C) * NB                   # noqa: E731
    gcols = [[((lc // NB) * C + c) * NB + lc % NB for lc in range(W)]
             for c in range(C)]
    slabs = [a[:, g].clone() for g in gcols]
    pos = torch.arange(SB)
    hdr = {}

    def factor(N):
        s, lc0, k0 = slabs[owner(N)], lcol(N), N * NB
        v = s[:, lc0:lc0 + NB].clone()
        F = torch.empty(NB, SB)
        piv, rd = [], []
        for m in range(NB):
            k = k0 + m
            x = v[:, m].clone()
            key = torch.where(pos < k, -2.0,
                              torch.where(torch.isnan(x), -1.0, x.abs()))
            cand = torch.nonzero(key == key.max())[:, 0]
            p = int(cand[torch.argmin(pos[cand])])
            q = int(pos[p])
            r = 1.0 / v[p, m]
            u = v[p] * r
            u[m] = r
            F[m] = x
            nv = v.clone()
            nv[:, m] = 0.0
            v = nv - x[:, None] * u[None, :]
            v[p] = u
            pos[pos == k] = q
            pos[p] = k
            piv.append(p)
            rd.append(u[m])
        s[:, lc0:lc0 + NB] = v
        pv = torch.tensor(piv)
        hdr[N] = (F, pv, torch.stack(rd), F[:, pv])

    def apply(P, c, cols):
        """Panel P's B' and B on CTA c's local columns ``cols``."""
        if not cols:
            return
        F, pv, rd, fp = hdr[P]
        cols = torch.tensor(cols)
        others = torch.tensor([i for i in range(SB) if i not in pv.tolist()])
        s = slabs[c]
        r = s[pv][:, cols].clone()
        U = torch.empty(NB, len(cols))
        for m in range(NB):
            u = r[m] * rd[m]
            r[m] = u
            U[m] = u
            for m2 in range(NB):
                if m2 != m:
                    r[m2] = r[m2] - fp[m, m2] * u
        t = F[0, others][:, None] * U[0][None, :]
        for m in range(1, NB):
            t = t + F[m, others][:, None] * U[m][None, :]
        s[others[:, None], cols[None, :]] = s[others][:, cols] - t
        s[pv[:, None], cols[None, :]] = r

    factor(0)
    for P in range(NP):
        N = P + 1
        skip = {c: set() for c in range(C)}
        skip[owner(P)] |= set(range(lcol(P), lcol(P) + NB))
        if N < NP:                      # the look-ahead
            ahead = list(range(lcol(N), lcol(N) + NB))
            apply(P, owner(N), ahead)
            factor(N)
            skip[owner(N)] |= set(ahead)
        for c in range(C):
            apply(P, c, [j for j in range(W) if j not in skip[c]])
    x = torch.empty(SB, SB)
    for c in range(C):
        x[:, gcols[c]] = slabs[c]
    perm = torch.empty(SB, dtype=torch.long)
    perm[pos] = torch.arange(SB)
    out = torch.empty_like(x)
    out[pos[:, None], perm[None, :]] = x
    return out


@pytest.mark.parametrize("SB", [64, 256])
@pytest.mark.parametrize("source", ["seeded", "jax_tiles"])
def test_plain_matches_jax_inv(SB, source):
    """inverse_plain against jnp.linalg.inv on the same fp32 tiles: within
    1e-5 of max|inv|, residual at most 10x JAX's."""
    if source == "seeded":
        a = _tiles(SB, 3, seed=SB)
    else:       # tiles built by JAX's block_jacobi_tiles (scatter layout)
        n_tiles = 2
        raw, _ = _seed_case(SB, n_tiles, 2.0, seed=SB + 1)
        jplan = JP.BlockJacobiPlan(idx=jnp.zeros((n_tiles, 1, 1), jnp.int32),
                                   n_tiles=n_tiles, S=SB, bu=1,
                                   n_p2=n_tiles * SB, layout="scatter")
        ones = jnp.ones(n_tiles * SB, jnp.float32)
        a = np.asarray(JP.block_jacobi_tiles(jplan, None, ones, 1.0,
                                             tiles0=jnp.asarray(raw)))
        port = TP.block_jacobi_tiles(_port_plan(n_tiles, SB),
                                     torch.as_tensor(raw.ravel()),
                                     torch.ones(n_tiles * SB), 1.0)
        assert np.array_equal(port.numpy(), a)
    want = np.asarray(jnp.linalg.inv(jnp.asarray(a, jnp.float32)))
    got = BI.inverse_plain(torch.as_tensor(a.copy())).numpy()
    assert got.dtype == np.float32 and want.dtype == np.float32
    for t in range(a.shape[0]):
        scale = np.abs(want[t]).max()
        assert np.abs(got[t] - want[t]).max() <= 1e-5 * scale
        assert _residual(a[t], got[t]) <= 10 * _residual(a[t], want[t])


@pytest.mark.parametrize("n", [8, 16])
def test_ties_go_to_the_lowest_position(n):
    """On Hadamard tiles (every step exact, every column's candidates tied)
    the rows end in LAPACK getrf's order, and the inverse is exact."""
    rng = np.random.default_rng(n)
    for _ in range(4):
        a = (_hadamard(n)[rng.permutation(n)]
             * rng.choice([-1.0, 1.0], (n, 1))).astype(np.float32)
        x, perm = BI.gauss_jordan_plain(torch.as_tensor(a)[None])
        rows = list(range(n))
        for k, q in enumerate(scipy.linalg.lu_factor(
                a.astype(np.float64))[1]):
            rows[k], rows[q] = rows[q], rows[k]
        assert perm[0].tolist() == rows
        inv = BI.inverse_plain(torch.as_tensor(a)[None])[0].numpy()
        assert np.array_equal(inv, a.T / n)
    # the first of equal magnitudes, whatever its sign
    a = torch.tensor([[[-2.0, 1.0], [2.0, 3.0]]])
    assert BI.gauss_jordan_plain(a)[1].tolist() == [[0, 1]]


def test_nan_and_singular_tiles_are_non_finite():
    """A NaN anywhere in a tile, or a zero pivot (a singular tile), gives a
    non-finite inverse; the batch's other tiles equal their inverses
    alone."""
    a = torch.as_tensor(_tiles(64, 4, seed=3))
    a[1, 3, 5] = float("nan")
    a[2, :, 7] = 0.0                  # a zero column: a zero pivot
    a[3] = 1.0                        # rank one
    x = BI.inverse_plain(a)
    assert torch.isnan(x[1]).all()
    assert not torch.isfinite(x[2]).all() and not torch.isfinite(x[3]).all()
    assert torch.isfinite(x[0]).all()
    assert _same_bits(x[0], BI.inverse_plain(a[:1])[0])


@pytest.mark.parametrize("SB, kind", [(64, "seeded"), (64, "ties"),
                                      (64, "nan"), (64, "singular"),
                                      (128, "seeded"), (128, "ties"),
                                      (256, "seeded"), (256, "ties"),
                                      (256, "nan"), (256, "singular"),
                                      (256, "swaps"),
                                      (512, "seeded"), (512, "ties")])
def test_kernel_schedule_equals_plain(SB, kind):
    """The kernel's cyclic look-ahead schedule (a CPU model of
    csrc/bj_inverse.cu) gives inverse_plain's bits: which CTA does an
    operation, and when, moves no operation's order.  ``swaps`` is a tile
    with no diagonal dominance (N(0, 1) entries), whose pivots lie in rows
    that the look-ahead has just updated."""
    if kind == "ties":
        a = _ties(SB, seed=SB)
    elif kind == "swaps":
        a = np.random.default_rng(29).standard_normal(
            (SB, SB)).astype(np.float32)
    else:
        a = _tiles(SB, 1, seed=SB + 7)[0]
    if kind == "nan":
        a[9, 40] = np.nan
    if kind == "singular":
        a[:, 17] = 0.0
    t = torch.as_tensor(a)
    want = BI.inverse_plain(t[None])[0]
    assert _same_bits(_kernel_model(t), want)
    if kind == "swaps":               # pivots off the diagonal
        assert (BI.gauss_jordan_plain(t[None])[1][0]
                != torch.arange(SB)).any()


def test_out_dtypes_and_slots():
    """fp32, bf16 and fp64 results are the fp32 inverse rounded once,
    allocated or written into a slot of a larger buffer (its neighbours
    untouched); what the wrapper refuses."""
    a = torch.as_tensor(_tiles(64, 3, seed=11))
    x = BI.inverse(a)
    assert x.dtype == torch.float32 and x.is_contiguous()
    for dt in (torch.float32, torch.bfloat16, torch.float64):
        assert _same_bits(BI.inverse(a, out_dtype=dt), x.to(dt))
        big = torch.full((2, 3, 64, 72), 7.0, dtype=dt)
        slot = big[1, :, :, :64]
        assert BI.inverse(a, out=slot) is slot
        assert _same_bits(slot, x.to(dt))
        assert (big[0] == 7).all() and (big[1, :, :, 64:] == 7).all()
    with pytest.raises(TypeError, match="not"):
        BI.inverse(a, out_dtype=torch.float64, out=torch.empty(3, 64, 64))
    with pytest.raises(TypeError, match="no output"):
        BI.inverse(a, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="row-major"):
        BI.inverse(a, out=torch.empty(3, 64, 64).transpose(1, 2))
    with pytest.raises(ValueError, match="out"):
        BI.inverse(a, out=torch.empty(2, 64, 64))


def test_kernel_refuses_what_it_does_not_take():
    """The kernel's checks (run before a launch): fp32, contiguous square
    tiles, SB in TILE_SIZES; a device neither CPU nor CUDA raises."""
    BI.check_tiles(torch.zeros(2, 128, 128))
    with pytest.raises(ValueError, match="no instantiation"):
        BI.check_tiles(torch.zeros(2, 96, 96))
    with pytest.raises(TypeError, match="float32"):
        BI.check_tiles(torch.zeros(2, 64, 64, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        BI.check_tiles(torch.zeros(2, 64, 64).transpose(1, 2))
    with pytest.raises(ValueError, match="unsupported device"):
        BI.inverse(torch.zeros(2, 64, 64, device="meta"))


@pytest.mark.parametrize("case", ["iters0", "guard", "no_seed"])
@pytest.mark.parametrize("out_dtype", [None, torch.float64])
def test_invert_exact_branch_matches_jax(case, out_dtype):
    """ops/p1ell.block_jacobi_invert's exact branch (no Newton-Schulz
    steps, no seed, or the guard's fallback) against JAX's
    block_jacobi_invert (jnp.linalg.inv): the same branch, within 1e-5 of
    max|inv|, in the model's dtype; on the CPU LAPACK's per-tile
    inverse."""
    SB, n_tiles = 64, 3
    a, x0 = _seed_case(SB, n_tiles, 6.0 if case == "guard" else 0.3,
                       seed=40 + len(case))
    jplan = JP.BlockJacobiPlan(idx=jnp.zeros((n_tiles, 1, 1), jnp.int32),
                               n_tiles=n_tiles, S=SB, bu=1,
                               n_p2=n_tiles * SB, layout="scatter")
    ones = jnp.ones(n_tiles * SB, jnp.float32)
    iters = 0 if case == "iters0" else 3
    seed = None if case == "no_seed" else x0
    want = np.asarray(JP.block_jacobi_invert(
        jplan, None, ones, 1.0, x0=None if seed is None else jnp.asarray(x0),
        iters=iters, tiles0=jnp.asarray(a)))
    jexact = np.asarray(jnp.linalg.inv(jnp.asarray(a)))
    assert np.array_equal(want, jexact)          # JAX took the exact branch
    exact0 = TP.BJ_INVERSIONS["exact"]
    got = TP.block_jacobi_invert(
        _port_plan(n_tiles, SB), torch.as_tensor(a.ravel()),
        torch.ones(n_tiles * SB), 1.0,
        x0=None if seed is None else torch.as_tensor(seed), iters=iters,
        out_dtype=out_dtype)
    assert TP.BJ_INVERSIONS["exact"] == exact0 + 1
    assert got.dtype == (out_dtype or torch.float32) and got.is_contiguous()
    # the CPU model path keeps LAPACK's per-tile inverse (ops/p1ell.py
    # block_jacobi_exact); the kernel's plain version is held to JAX by
    # test_plain_matches_jax_inv
    assert _same_bits(got, TP._inv(torch.as_tensor(a)).to(got.dtype))
    for t in range(n_tiles):
        scale = np.abs(want[t]).max()
        assert np.abs(got[t].double().numpy() - want[t]).max() <= 1e-5 * scale


def test_exact_into_buffers_and_cpu_counts_nothing(monkeypatch):
    """block_jacobi_exact writes each part's inverse into ``out[k]`` (the
    captured step's buffer), on the CPU through LAPACK's per-tile inverse
    (the CPU model's route): no launch and no plain call counted."""
    calls = []
    lapack = TP._inv

    def spy(a):
        calls.append(tuple(a.shape))
        return lapack(a)

    monkeypatch.setattr(TP, "_inv", spy)
    (a1, _), (a2, _) = (_seed_case(64, 2, 0.3, seed=s) for s in (1, 2))
    g = TP.BjGuard(tiles=[torch.as_tensor(a1), torch.as_tensor(a2)], xs=[],
                   axs=[], norm=None, out_dtype=torch.bfloat16)
    bufs = [torch.empty(2, 64, 64, dtype=torch.bfloat16) for _ in range(2)]
    BI.COUNTS.reset()
    res = TP.block_jacobi_exact(g, out=bufs)
    assert all(r is b for r, b in zip(res, bufs)) and calls == [(2, 64, 64)] * 2
    for b, a in zip(bufs, (a1, a2)):
        assert _same_bits(b, lapack(torch.as_tensor(a)).to(torch.bfloat16))
    assert BI.COUNTS.launches == 0 and BI.COUNTS.plain_cuda_calls == 0


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """The kernel's wrapper hands CPU tensors to gauss_jordan_plain and
    launches nothing."""
    calls = []
    plain = BI.gauss_jordan_plain

    def spy(a):
        calls.append(tuple(a.shape))
        return plain(a)

    monkeypatch.setattr(BI, "gauss_jordan_plain", spy)
    a = torch.as_tensor(_tiles(64, 2, seed=5))
    BI.COUNTS.reset()
    x = BI.inverse(a, out_dtype=torch.float64)
    assert calls == [(2, 64, 64)] and x.dtype == torch.float64
    assert BI.COUNTS.launches == 0 and BI.COUNTS.plain_cuda_calls == 0
