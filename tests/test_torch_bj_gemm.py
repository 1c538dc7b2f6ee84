"""The Newton-Schulz products of the port's tile rebuild
(``kernels/bj_gemm.py``; its CUDA kernel csrc/bj_gemm.cu runs only on the
card, see tests/test_torch_cuda.py) on the CPU, at tiles of SB = 64 and
128 and batches of 1 to 7, inputs from numpy's default_rng:

* the plain composites (``torch.matmul``, then ``bj_tiles.guard_plain`` /
  ``bj_tiles.update_plain``) equal the chain the port ran before the GEMM
  (inlined below) bit for bit, for both layouts of X, the last update in
  fp32, bf16 and fp64, allocated and into a slot with strides; the
  wrappers take them on CPU tensors, launch nothing and count nothing;
* the port's guard norm and each Newton-Schulz iterate agree with the JAX
  package's ``ax``, ``r`` and ``xx`` (``navierstokes_tpu/ops/p1ell.py``
  :491-501, recomputed with ``jnp.matmul`` on the same inputs): within
  1e-12 in float64 and 1e-5 relative in fp32; the branch is the same on
  either side of GUARD_LIMIT under the guard's pairwise tree;
* the checks the wrappers run before a launch (``check_operands``,
  ``check_out``) refuse what the kernel does not take, with no card;
* the kernel's tiling as the wrapper mirrors it (rows a CTA, CTAs a
  launch: the guard's partials);
* row-shard parts make one decision.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokes_tpu.ops import p1ell as JP
from navierstokes_tpu_torch.kernels import bj_gemm as BG
from navierstokes_tpu_torch.kernels import bj_tiles as BT
from navierstokes_tpu_torch.ops import p1ell as TP

torch.set_num_threads(2)
OUT_DTYPES = (torch.float32, torch.bfloat16, torch.float64)


def _same_bits(a, b):
    """Equal dtype, shape and strides, NaN at the same places and the same
    bits everywhere else."""
    if a.dtype != b.dtype or a.shape != b.shape or a.stride() != b.stride():
        return False
    na, nb = torch.isnan(a), torch.isnan(b)
    ia, ib = (t.masked_fill(n, 0).contiguous().view(
        {2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])
        for t, n in ((a, na), (b, nb)))
    return torch.equal(na, nb) and torch.equal(ia, ib)


def _case(SB, n, eps, seed, dtype=np.float32):
    """Tiles A = A0 + eps E (A0 diagonally dominant) and the seed X0 =
    inv(A0), as numpy arrays in ``dtype``."""
    rng = np.random.default_rng(seed)
    a0 = (np.eye(SB)[None] * (4.0 + rng.uniform(size=(n, SB, 1)))
          + 0.5 * rng.standard_normal((n, SB, SB)) / np.sqrt(SB))
    e = rng.standard_normal((n, SB, SB)) / np.sqrt(SB)
    return (a0 + eps * e).astype(dtype), np.linalg.inv(a0).astype(dtype)


def _col(t):
    """The same values with column-major tiles."""
    return t.transpose(1, 2).contiguous().transpose(1, 2)


def _parent_guard(a, x0):
    """The parent's chain: cuBLAS / MKL's A X0, then the guard's tree."""
    ax = torch.matmul(a, x0)
    return ax, BT.guard_plain(ax)


def _parent_update(x, ax, out_dtype=None, out=None):
    return BT.update_plain(x, torch.matmul(x, ax), out_dtype=out_dtype,
                           out=out)


@pytest.mark.parametrize("SB", [64, 128])
@pytest.mark.parametrize("n", [1, 3, 7])
@pytest.mark.parametrize("x_col", [False, True])
def test_plain_composites_equal_the_parent_chain(SB, n, x_col):
    """product / guard / update, on CPU tensors, equal torch.matmul and the
    parent's passes bit for bit; the update keeps X's layout."""
    a, x0 = _case(SB, n, 0.3, seed=SB + n + x_col)
    a = torch.as_tensor(a)
    x = torch.as_tensor(x0)
    x = _col(x) if x_col else x
    assert BT.layout(x) is x_col
    BG.COUNTS.reset()
    assert _same_bits(BG.product(a, x), torch.matmul(a, x))
    assert _same_bits(BG.product_plain(a, x), torch.matmul(a, x))
    ax, norm = BG.guard(a, x)
    want_ax, want_norm = _parent_guard(a, x)
    assert _same_bits(ax, want_ax) and _same_bits(norm, want_norm)
    assert all(_same_bits(g, w) for g, w in
               zip(BG.guard_product_plain(a, x), (want_ax, want_norm)))
    y = BG.update(x, ax)
    assert _same_bits(y, _parent_update(x, ax)) and BT.layout(y) is x_col
    assert _same_bits(BG.update_product_plain(x, ax), _parent_update(x, ax))
    assert BG.COUNTS.launches == 0 and BG.COUNTS.plain_cuda_calls == 0
    assert BG.COUNTS.by_variant == {}


@pytest.mark.parametrize("out_dtype", OUT_DTYPES)
@pytest.mark.parametrize("into", ["allocated", "buffer", "slot"])
@pytest.mark.parametrize("x_col", [False, True])
def test_last_update_equals_the_parent_chain(out_dtype, into, x_col):
    """The last update in fp32, bf16 and fp64, row-major, allocated, into a
    buffer and into a slot of a larger buffer (strided tiles and rows),
    equals the parent's chain (.to(dtype).contiguous()) bit for bit and
    leaves the rest of the buffer alone."""
    SB, n = 64, 3
    a, x0 = _case(SB, n, 0.3, seed=5 + x_col)
    x = torch.as_tensor(x0)
    x = _col(x) if x_col else x
    ax = torch.matmul(torch.as_tensor(a), x)
    want = _parent_update(x, ax, out_dtype=out_dtype)
    assert want.is_contiguous()
    if into == "allocated":
        got = BG.update(x, ax, out_dtype=out_dtype)
        assert _same_bits(got, want)
        return
    big = torch.full((n, SB + 4, SB + 8), 7.0, dtype=out_dtype)
    out = (big[:, :SB, :SB].contiguous() if into == "buffer"
           else big[:, 2:2 + SB, :SB])
    if into == "buffer":
        big = out
    BG.check_out("test", x, out_dtype, out)
    assert BG.update(x, ax, out_dtype=out_dtype, out=out) is out
    assert _same_bits(out.contiguous(), want)
    if into == "slot":
        rest = big.clone()
        rest[:, 2:2 + SB, :SB] = 7.0
        assert bool((rest == 7.0).all())


def _jax_newton(a, x0, iters=3):
    """JAX's ax, r and the iterates xx of navierstokes_tpu/ops/p1ell.py
    :491-501, on the same inputs, with jnp.matmul."""
    a, x = jnp.asarray(a), jnp.asarray(x0)
    ax = jnp.matmul(a, x, preferred_element_type=a.dtype)
    eye = jnp.eye(a.shape[-1], dtype=a.dtype)
    r = jnp.abs(eye[None] - ax).sum(-1).max()
    xx, axx, its = x, ax, []
    for i in range(iters):
        xx = 2.0 * xx - jnp.matmul(xx, axx, preferred_element_type=a.dtype)
        its.append(np.asarray(xx))
        if i + 1 < iters:
            axx = jnp.matmul(a, xx, preferred_element_type=a.dtype)
    return np.asarray(ax), float(r), its


@pytest.mark.parametrize("SB", [64, 128])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_newton_iterates_agree_with_jax(SB, dtype):
    """The guard's A X0 and norm and every Newton-Schulz iterate of the
    port's calls (the CPU path: bj_gemm's plain composites) agree with the
    JAX package's: 1e-12 in float64, 1e-5 relative in fp32."""
    a, x0 = _case(SB, 4, 0.3, seed=SB + len(dtype), dtype=dtype)
    tol = 1e-12 if dtype == "float64" else 1e-5
    jax_ax, jax_r, jax_its = _jax_newton(a, x0)
    at, x = torch.as_tensor(a), _col(torch.as_tensor(x0))
    ax, norm = BG.guard(at, x)
    scale = float(np.abs(jax_ax).max())
    assert np.abs(ax.numpy() - jax_ax).max() <= tol * scale
    assert abs(float(norm) - jax_r) <= tol * jax_r
    for i, want in enumerate(jax_its):
        if i + 1 < len(jax_its):
            x = BG.update(x, ax)
            ax = BG.product(at, x)
        else:
            x = BG.update(x, ax, out_dtype=at.dtype)
        gap = np.abs(x.numpy() - want).max()
        assert gap <= tol * float(np.abs(want).max()), (i, gap)
    if dtype == "float32":
        # the whole branch through both packages' block_jacobi_invert
        n = a.shape[0]
        jplan = JP.BlockJacobiPlan(idx=jnp.zeros((n, 1, 1), jnp.int32),
                                   n_tiles=n, S=SB, bu=1, n_p2=n * SB,
                                   layout="scatter")
        jinv = np.asarray(JP.block_jacobi_invert(
            jplan, None, jnp.ones(n * SB, jnp.float32), 1.0,
            x0=jnp.asarray(x0), iters=3, tiles0=jnp.asarray(a)))
        inv = TP.block_jacobi_invert(_port_plan(n, SB), at.reshape(-1),
                                     torch.ones(n * SB), 1.0,
                                     x0=_col(torch.as_tensor(x0)), iters=3)
        assert np.abs(inv.numpy() - jinv).max() \
            <= tol * float(np.abs(jinv).max())


# how far from GUARD_LIMIT the near-limit cases put the norm: above the gap
# between the pairwise tree and XLA's sums (about 1e-7 of the norm), far
# below anything else
MARGIN = 5e-5


def _near_limit(SB, side):
    """Tiles whose guard norm lies MARGIN below (side -1) or above (+1)
    GUARD_LIMIT: A = A0 + s E with s found by bisection on the fp32
    norm."""
    a0, x0 = _case(SB, 3, 0.0, seed=40 + SB)
    e = np.random.default_rng(41).standard_normal(a0.shape) / np.sqrt(SB)
    x = _col(torch.as_tensor(x0))

    def norm(s):
        a = torch.as_tensor((a0 + s * e).astype(np.float32))
        return float(BG.guard(a, x)[1]), a

    target = TP.GUARD_LIMIT + side * MARGIN
    lo, hi = 0.0, 64.0
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if norm(mid)[0] < target:
            lo = mid
        else:
            hi = mid
    r, a = norm(lo)
    return a, x, r


@pytest.mark.parametrize("SB", [64, 128])
@pytest.mark.parametrize("side", [-1, 1])
def test_guard_branch_agrees_with_jax_at_the_limit(SB, side):
    """Tiles whose norm lies MARGIN from GUARD_LIMIT, on either side: the
    port's pairwise tree and JAX's sums agree within 1e-6 relative and take
    the same branch, and the port's block_jacobi_invert takes it."""
    a, x, r = _near_limit(SB, side)
    assert abs(r - (TP.GUARD_LIMIT + side * MARGIN)) < 1e-6
    _, jax_r, _ = _jax_newton(a.numpy(), x.numpy())
    assert abs(r - jax_r) <= 1e-6 * jax_r
    assert (jax_r < TP.GUARD_LIMIT) == (r < TP.GUARD_LIMIT) == (side < 0)
    n, SB = a.shape[0], a.shape[-1]
    plan = _port_plan(n, SB)
    exact0 = TP.BJ_INVERSIONS["exact"]
    TP.block_jacobi_invert(plan, a.reshape(-1), torch.ones(n * SB), 1.0,
                           x0=x, iters=3)
    assert (TP.BJ_INVERSIONS["exact"] > exact0) == (side > 0)


def _port_plan(n_tiles, SB):
    """A plan whose F values are the raw tile values themselves."""
    n = n_tiles * SB * SB
    pos, src, row_ptr = BT.plan_arrays(np.arange(n), np.arange(n),
                                       n_tiles * SB, SB)
    return TP.BlockJacobiPlan(pos=torch.as_tensor(pos),
                              src=torch.as_tensor(src),
                              row_ptr=torch.as_tensor(row_ptr),
                              n_tiles=n_tiles, S=SB, bu=1,
                              n_p2=n_tiles * SB)


def _bad_operands():
    t = torch.zeros(2, 64, 64)
    return {
        "float64": (t.double(), t.double(), TypeError, "float32"),
        "bfloat16 right": (t, t.bfloat16(), TypeError, "float32"),
        "strided tiles": (torch.zeros(2, 64, 128)[:, :, :64], t,
                          ValueError, "row- or column-major"),
        "permuted": (torch.zeros(64, 2, 64).permute(1, 0, 2), t, ValueError,
                     "row- or column"),
        "tile of 96": (torch.zeros(2, 96, 96), torch.zeros(2, 96, 96),
                       ValueError, "no instantiation"),
        "tile of 32": (torch.zeros(2, 32, 32), torch.zeros(2, 32, 32),
                       ValueError, "no instantiation"),
        "batches differ": (t, torch.zeros(3, 64, 64), ValueError,
                           "equal stacks"),
        "not square": (torch.zeros(2, 64, 32), torch.zeros(2, 64, 32),
                       ValueError, "square"),
        "empty": (torch.zeros(0, 64, 64), torch.zeros(0, 64, 64),
                  ValueError, "empty"),
        "misaligned": (torch.zeros(2 * 64 * 64 + 1)[1:].view(2, 64, 64), t,
                       ValueError, "aligned"),
    }


@pytest.mark.parametrize("case", sorted(_bad_operands()))
def test_check_operands_refuses(case):
    """The wrappers' check (run before every launch; needs no card)
    refuses what the kernel does not take."""
    a, b, err, match = _bad_operands()[case]
    with pytest.raises(err, match=match):
        BG.check_operands("bj_gemm", a, b)


def test_check_operands_takes_both_layouts():
    t = torch.zeros(3, 128, 128)
    for a_col in (False, True):
        for b_col in (False, True):
            a = _col(t) if a_col else t
            b = _col(t) if b_col else t
            assert BG.check_operands("bj_gemm", a, b) == (a_col, b_col)
    one = torch.zeros(1, 64, 64)
    assert BG.check_operands("bj_gemm", one, _col(one)) == (False, True)


def _bad_outs():
    x = torch.zeros(2, 64, 64)
    return {
        "float16": (torch.zeros(2, 64, 64, dtype=torch.float16), None,
                    TypeError, "no last update"),
        "dtype differs": (torch.zeros(2, 64, 64), torch.float64, TypeError,
                          "not torch.float64"),
        "column-major": (_col(x), None, ValueError, "row-major"),
        "row stride 66": (torch.zeros(2, 64, 66)[:, :, :64], None,
                          ValueError, "multiples of 4"),
        "shape": (torch.zeros(3, 64, 64), None, ValueError, "for tiles"),
        "overlapping tiles": (torch.zeros(64 * 64 + 64 * 4).as_strided(
            (2, 64, 64), (64 * 4, 64, 1)), None, ValueError, "row-major"),
        "misaligned": (torch.zeros(2 * 64 * 64 + 1)[1:].view(2, 64, 64),
                       None, ValueError, "aligned"),
        "is x": (x, None, ValueError, "not be x"),
    }


@pytest.mark.parametrize("case", sorted(_bad_outs()))
def test_check_out_refuses(case):
    out, dt, err, match = _bad_outs()[case]
    x = out if case == "is x" else torch.zeros(2, 64, 64)
    with pytest.raises(err, match=match):
        BG.check_out("bj_gemm.update", x, dt, out)


@pytest.mark.parametrize("SB,rows,ctas", [(64, 64, 7), (128, 128, 7),
                                         (256, 128, 14), (512, 64, 56)])
def test_tiling_mirrors_the_kernel(SB, rows, ctas):
    """A CTA computes min(SB, 32768 / SB) rows of one tile: the guard's
    partials, one a CTA, for 7 tiles."""
    assert BG.strip_rows(SB) == rows
    assert BG.ctas(7, SB) == ctas
    assert BG.guard_partials(7, SB, "cpu").numel() == ctas


def test_cpu_path_counts_no_launch():
    """A whole rebuild on CPU tensors (guard, Newton-Schulz) launches
    nothing, counts no plain CUDA call and builds no kernel library."""
    BG.COUNTS.reset()
    BT.COUNTS.reset()
    SB, n = 64, 2
    a, x0 = _case(SB, n, 0.3, seed=31)
    plan = _port_plan(n, SB)
    TP.block_jacobi_invert(plan, torch.as_tensor(a.ravel()),
                           torch.ones(n * SB), 1.0, x0=torch.as_tensor(x0))
    assert BG.COUNTS.launches == 0 and BG.COUNTS.plain_cuda_calls == 0
    assert BG.COUNTS.by_variant == {} and BT.COUNTS.by_variant == {}


def test_row_shard_parts_make_one_decision():
    """Two parts through the GEMM's calls: the guard's norm is the larger
    part's; one part outside the contraction region sends both to the
    exact inverse, two inside take Newton-Schulz, each part's inverses
    equal to its own call's."""
    SB = 64
    (a1, x1), (a2, x2) = (_case(SB, 2, eps, seed=s)
                          for eps, s in ((0.3, 51), (6.0, 52)))
    plan = _port_plan(2, SB)
    ones = torch.ones(2 * SB)

    def part(a, x):
        return (plan, torch.as_tensor(a.ravel()), ones, 1.0,
                _col(torch.as_tensor(x)))

    alone = [float(TP.block_jacobi_guard([part(a, x)], 3).norm)
             for a, x in ((a1, x1), (a2, x2))]
    assert alone[0] < TP.GUARD_LIMIT <= alone[1]
    g = TP.block_jacobi_guard([part(a1, x1), part(a2, x2)], 3)
    assert float(g.norm) == max(alone)
    exact0 = TP.BJ_INVERSIONS["exact"]
    TP.block_jacobi_invert_parts([part(a1, x1), part(a2, x2)], 3)
    assert TP.BJ_INVERSIONS["exact"] == exact0 + 1
    out = TP.block_jacobi_invert_parts([part(a1, x1), part(a1, x1)], 3)
    assert TP.BJ_INVERSIONS["exact"] == exact0 + 1
    one = TP.block_jacobi_invert(plan, torch.as_tensor(a1.ravel()), ones,
                                 1.0, x0=_col(torch.as_tensor(x1)))
    assert _same_bits(out[0], out[1]) and _same_bits(out[0], one)


def test_newton_into_a_slot_equals_the_parent_chain():
    """block_jacobi_newton with its last update into a slot of a larger
    buffer (the captured step's tiles at strides) equals the parent's
    chain: the guard's matmul, then 2.0 * x - matmul(x, ax) per step and
    .to(dtype).contiguous()."""
    SB, n = 64, 3
    a, x0 = _case(SB, n, 0.3, seed=61)
    plan = _port_plan(n, SB)
    x0t = _col(torch.as_tensor(x0))
    g = TP.block_jacobi_guard([(plan, torch.as_tensor(a.ravel()),
                                torch.ones(n * SB), 1.0, x0t)], 3,
                              torch.bfloat16)
    big = torch.zeros((n, SB, SB + 4), dtype=torch.bfloat16)
    slot = big[:, :, :SB]
    got = TP.block_jacobi_newton(g, 3, out=[slot])[0]
    at = torch.as_tensor(a)
    x, ax = x0t, torch.matmul(at, x0t)
    for i in range(3):
        x = 2.0 * x - torch.matmul(x, ax)
        if i < 2:
            ax = torch.matmul(at, x)
    assert got is slot
    assert _same_bits(slot.contiguous(), x.to(torch.bfloat16).contiguous())
