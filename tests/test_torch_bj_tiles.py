"""The block-Jacobi tile rebuild of the port (``kernels/bj_tiles.py``; its
CUDA kernels csrc/bj_tiles.cu and the Newton-Schulz GEMM csrc/bj_gemm.cu,
whose epilogue halves are ``guard_plain`` and ``update_plain``, run only on
the card, see
tests/test_torch_cuda.py) against the stock PyTorch chain it replaces and
against the JAX package's ``navierstokes_tpu/ops/p1ell.py``
``block_jacobi_tiles`` / ``block_jacobi_invert``, on the CPU, at tiles of
SB = 64 and 256:

* the plain tiles equal the stock chain (inlined below) bit for bit, with
  masked -0 and NaN values, fp32 and fp64 F values, a 0-d or a float
  sigma; the sorted int32 plan holds the stock plan's (pos, src) pairs,
  and each tile row's offsets bound its pairs (the kernel's bands);
* the plain guard's norm agrees with JAX's within 1e-6 relative, with the
  same branch on either side of GUARD_LIMIT and for a NaN tile; the tree
  it sums in is the kernel's (a CPU model of the lanes and shuffles);
* the plain updates equal ``2.0 * x - p`` bit for bit with the same
  strides, row- and column-major; the last update in fp32, bf16 and fp64
  equals ``.to(dtype).contiguous()``, into a given buffer too;
* row-shard parts make one decision; Newton-Schulz into a buffer equals
  the allocated result; the CPU path counts no launch and no plain CUDA
  call.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as Fn

from navierstokes_tpu.ops import p1ell as JP
from navierstokes_tpu_torch.kernels import bj_tiles as BT
from navierstokes_tpu_torch.ops import p1ell as TP

torch.set_num_threads(2)
TORCH_DT = {"f32": torch.float32, "f64": torch.float64}


def _stock_tiles(pos, src, n_tiles, SB, n_p2, f_vals, mask_flat, sigma):
    """The stock chain the tiles kernel replaces (ops/p1ell.py before the
    rebuild kernels), with the plan's unsorted int64 pairs."""
    t = f_vals.new_zeros(n_tiles * SB * SB)
    t[pos] = f_vals[src]
    t = t.view(n_tiles, SB, SB)
    n = n_tiles * SB
    m = Fn.pad(mask_flat, (0, n - n_p2)).reshape(n_tiles, SB)
    t = t * m[:, :, None] * m[:, None, :]
    eye = torch.eye(SB, dtype=t.dtype, device=t.device)
    t = t + (sigma * (1.0 - m))[:, :, None] * eye[None]
    return t.to(torch.float32)


def _pattern(SB, n_tiles, tail, seed, density=0.08):
    """A fake F pattern (rows, columns, slots) over n_p2 nodes with a tail
    tile of ``tail`` rows: the diagonal, seeded couplings inside and across
    tiles, slots shuffled."""
    rng = np.random.default_rng(seed)
    n_p2 = (n_tiles - 1) * SB + tail
    pairs = {(i, i) for i in range(n_p2)}
    k = int(density * n_p2 * SB)
    r = rng.integers(0, n_p2, k)
    c = np.clip(r + rng.integers(-SB, SB, k), 0, n_p2 - 1)
    pairs |= set(zip(r.tolist(), c.tolist()))
    rows, cols = map(np.array, zip(*sorted(pairs)))
    slots = rng.permutation(len(rows) + 5)[:len(rows)]     # spare slots
    f = types.SimpleNamespace(nz_row=rows, nz_col=cols, nz_slot=slots)
    return f, n_p2, len(rows) + 5


def _stock_pairs(f, SB):
    """The stock plan's (pos, src), unsorted int64, as the plan built
    them before it sorted them."""
    r, c = f.nz_row, f.nz_col
    on = (r // SB) == (c // SB)
    pos = (r[on] // SB) * (SB * SB) + (r[on] % SB) * SB + c[on] % SB
    return pos, f.nz_slot[on]


def _values(n_slots, n_p2, dtype, seed, on_slots):
    """Seeded F values and mask: some of the tiles' values (``on_slots``)
    -0, a few NaN, about 15% of the rows masked."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n_slots)
    mask = (rng.uniform(size=n_p2) > 0.15).astype(np.float64)
    v[rng.choice(on_slots, 40, replace=False)] = -0.0
    v[rng.choice(on_slots, 6, replace=False)] = np.nan
    return (torch.as_tensor(v, dtype=dtype), torch.as_tensor(mask,
                                                             dtype=dtype))


def _same_bits(a, b):
    """Equal dtype, shape and strides, NaN at the same places and the same
    bits everywhere else (a NaN's payload is not compared)."""
    if a.dtype != b.dtype or a.shape != b.shape or a.stride() != b.stride():
        return False
    na, nb = torch.isnan(a), torch.isnan(b)
    ia, ib = (t.masked_fill(n, 0).contiguous().view(
        {2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])
        for t, n in ((a, na), (b, nb)))
    return torch.equal(na, nb) and torch.equal(ia, ib)


@pytest.mark.parametrize("SB", [64, 256])
@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("sigma_kind", ["tensor", "float"])
def test_plain_tiles_equal_the_stock_chain(SB, dt, sigma_kind):
    """The plain tiles (through ops/p1ell.block_jacobi_tiles) equal the
    stock chain bit for bit: masked -0 values come out +0, NaN stays NaN
    where the chain keeps it, fp32 and fp64 values, a tail tile."""
    f, n_p2, n_slots = _pattern(SB, 3, SB // 2 + 3, seed=SB)
    plan = TP.build_block_jacobi_plan(f, 1, n_p2, SB, "cpu")
    pos, src = _stock_pairs(f, SB)
    vals, mask = _values(n_slots, n_p2, TORCH_DT[dt], seed=7, on_slots=src)
    sigma = (torch.tensor(3.25, dtype=TORCH_DT[dt]) if sigma_kind == "tensor"
             else 3.25)
    got = TP.block_jacobi_tiles(plan, vals, mask, sigma)
    want = _stock_tiles(torch.as_tensor(pos), torch.as_tensor(src),
                       plan.n_tiles, SB, n_p2, vals, mask, sigma)
    assert got.dtype == torch.float32 and _same_bits(got, want)
    assert bool(torch.isnan(got).any())
    # a masked -0 (a constrained row, off the diagonal) comes out +0
    neg0 = (got == 0) & torch.signbit(got)
    assert not bool(neg0.any()) and not bool(torch.signbit(want[want == 0])
                                              .any())


@pytest.mark.parametrize("SB", [64, 256])
def test_sorted_plan_holds_the_stock_pairs(SB):
    """build_block_jacobi_plan's pairs are the stock plan's, sorted by
    position, int32; row_ptr bounds each tile row's pairs, so a band of
    rows [g0, g0 + R) finds exactly its positions in
    pos[row_ptr[g0]:row_ptr[g0 + R]] (the tiles kernel's scatter)."""
    f, n_p2, _ = _pattern(SB, 4, SB, seed=3 + SB)
    plan = TP.build_block_jacobi_plan(f, 1, n_p2, SB, "cpu")
    pos, src = _stock_pairs(f, SB)
    assert plan.pos.dtype == plan.src.dtype == plan.row_ptr.dtype \
        == torch.int32
    p, s, rp = (t.numpy().astype(np.int64) for t in (plan.pos, plan.src,
                                                     plan.row_ptr))
    assert np.all(np.diff(p) > 0)
    assert sorted(zip(p, s)) == sorted(zip(pos.tolist(), src.tolist()))
    n_rows = plan.n_tiles * SB
    assert len(rp) == n_rows + 1 and rp[0] == 0 and rp[-1] == len(p)
    for g in range(n_rows):
        assert np.all(p[rp[g]:rp[g + 1]] // SB == g)
    for R in (8, 128):          # bands of the kernel's fp64 / fp32 sizes
        for g0 in range(0, n_rows, R):
            band = p[rp[g0]:rp[min(g0 + R, n_rows)]]
            assert np.all((band >= g0 * SB) & (band < (g0 + R) * SB))
    # a plan past int32 positions is refused
    with pytest.raises(ValueError):
        BT.plan_arrays(np.array([2 ** 31]), np.array([0]), 1, SB)


def _guard_model(ax):
    """A CPU model of csrc/bj_tiles.cu's guard rows: a warp per row, lane
    l holding columns [l E, l E + E), the lane's tree over them, then five
    xor-shuffle levels; the max over rows with NaN kept."""
    sb = ax.shape[-1]
    E = sb // 32
    eye = torch.eye(sb, dtype=torch.float32)
    v = (eye[None] - ax).abs().reshape(-1, 32, E)        # (rows, lane, E)
    w = E
    while w > 1:
        v = v[..., 0:w:2] + v[..., 1:w:2]
        w //= 2
    s = v[..., 0]                                         # (rows, lane)
    off = 1
    while off < 32:
        partner = s[:, torch.arange(32) ^ off]
        s = s + partner
        off *= 2
    assert bool(torch.all((s == s[:, :1]) | torch.isnan(s)))
    row = s[:, 0]
    return row[torch.isnan(row)][0] if bool(torch.isnan(row).any()) \
        else row.max()


def _seed_case(SB, n_tiles, eps, seed, nan_tile=None):
    """Tiles A = A0 + eps E (diagonally dominant A0) with the seed X0 =
    inv(A0) in fp32 (as the model stores it), mask all ones."""
    rng = np.random.default_rng(seed)
    a0 = (np.eye(SB)[None] * (4.0 + rng.uniform(size=(n_tiles, SB, 1)))
          + 0.5 * rng.standard_normal((n_tiles, SB, SB)) / np.sqrt(SB))
    e = rng.standard_normal((n_tiles, SB, SB)) / np.sqrt(SB)
    a = (a0 + eps * e).astype(np.float32)
    x0 = np.linalg.inv(a0.astype(np.float32).astype(np.float64)).astype(
        np.float32)
    if nan_tile is not None:
        a[nan_tile, 3, 5] = np.nan
    return a, x0


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


@pytest.mark.parametrize("SB", [64, 256])
@pytest.mark.parametrize("case", ["newton", "exact", "nan"])
def test_guard_agrees_with_jax(SB, case):
    """The guard's norm (plain version) within 1e-6 relative of JAX's
    block_jacobi_invert norm, the same branch in both (JAX's exact branch
    returns jnp.linalg.inv's bits), and equal to the kernel's lane model
    bit for bit."""
    n_tiles = 3
    eps = {"newton": 0.2, "exact": 6.0, "nan": 0.2}[case]
    a, x0 = _seed_case(SB, n_tiles, eps, seed=SB + len(case),
                       nan_tile=1 if case == "nan" else None)
    # JAX: the scatter layout's static base is the tile stack itself
    jplan = JP.BlockJacobiPlan(idx=jnp.zeros((n_tiles, 1, 1), jnp.int32),
                               n_tiles=n_tiles, S=SB, bu=1,
                               n_p2=n_tiles * SB, layout="scatter")
    ones = jnp.ones(n_tiles * SB, jnp.float32)
    ja = JP.block_jacobi_tiles(jplan, None, ones, 1.0, tiles0=jnp.asarray(a))
    jax_ax = jnp.matmul(ja, jnp.asarray(x0),
                        preferred_element_type=jnp.float32)
    eye = jnp.eye(SB, dtype=jnp.float32)
    jnorm = float(jnp.abs(eye[None] - jax_ax).sum(-1).max())
    jinv = np.asarray(JP.block_jacobi_invert(
        jplan, None, ones, 1.0, x0=jnp.asarray(x0), iters=3,
        tiles0=jnp.asarray(a)))
    jexact = np.asarray(jnp.linalg.inv(ja))
    j_took_exact = bool(np.array_equal(jinv, jexact, equal_nan=True))
    # the port
    plan = _port_plan(n_tiles, SB)
    vals = torch.as_tensor(a.ravel())
    g = TP.block_jacobi_guard([(plan, vals, torch.ones(n_tiles * SB), 1.0,
                                torch.as_tensor(x0))], 3)
    norm = float(g.norm)
    assert _same_bits(g.norm, _guard_model(g.axs[0]))
    exact0 = TP.BJ_INVERSIONS["exact"]
    TP.block_jacobi_invert(plan, vals, torch.ones(n_tiles * SB), 1.0,
                           x0=torch.as_tensor(x0), iters=3)
    took_exact = TP.BJ_INVERSIONS["exact"] > exact0
    assert took_exact == j_took_exact == (case != "newton")
    if case == "nan":
        assert np.isnan(norm) and np.isnan(jnorm)
    else:
        assert abs(norm - jnorm) <= 1e-6 * jnorm
        assert (norm < TP.GUARD_LIMIT) == (case == "newton")


def test_guard_pads_a_row_to_a_power_of_two():
    """A tile size that is no power of two sums as the tree over its row
    padded with zeros (adding +0 to a sum of magnitudes is exact)."""
    rng = np.random.default_rng(5)
    ax = torch.as_tensor(rng.standard_normal((2, 48, 48)), dtype=torch.float32)
    padded = Fn.pad(ax, (0, 16, 0, 16))
    padded[:, 48:, :] = 0
    eye = torch.eye(48)
    want = (eye[None] - ax).abs()
    v = Fn.pad(want, (0, 16))
    while v.shape[-1] > 1:
        v = v[..., 0::2] + v[..., 1::2]
    assert _same_bits(BT.guard_plain(ax), v.max())
    assert abs(float(BT.guard_plain(ax)) - float(want.sum(-1).max())) \
        <= 1e-6 * float(want.sum(-1).max())


def _stack(rng, n, SB, col):
    t = torch.as_tensor(rng.standard_normal((n, SB, SB)), dtype=torch.float32)
    return t.transpose(1, 2).contiguous().transpose(1, 2) if col else t


@pytest.mark.parametrize("SB", [64, 256])
@pytest.mark.parametrize("x_col", [False, True])
@pytest.mark.parametrize("p_col", [False, True])
def test_update_equals_torch(SB, x_col, p_col):
    """update_plain(x, p), the plain half of the GEMM's update epilogue
    (kernels/bj_gemm.py), equals 2.0 * x - p bit for bit with its strides
    (x's layout); the last update in fp32, bf16 and fp64 equals
    .to(dtype).contiguous(), allocated and into a given buffer."""
    rng = np.random.default_rng(SB + 2 * x_col + p_col)
    x, p = _stack(rng, 3, SB, x_col), _stack(rng, 3, SB, p_col)
    assert BT.layout(x) is x_col and BT.layout(p) is p_col
    want = 2.0 * x - p
    got = BT.update_plain(x, p)
    assert _same_bits(got, want) and BT.layout(got) is x_col
    for dt in (torch.float32, torch.bfloat16, torch.float64):
        last = want.to(dt).contiguous()
        assert _same_bits(BT.update_plain(x, p, out_dtype=dt), last)
        buf = torch.full(x.shape, 7.0, dtype=dt)
        out = BT.update_plain(x, p, out_dtype=dt, out=buf)
        assert out is buf and _same_bits(buf, last)


def test_layout_refuses_other_strides():
    t = torch.zeros(2, 64, 64)
    assert BT.layout(t) is False
    assert BT.layout(t.transpose(1, 2)) is True
    assert BT.layout(t[:, :, :32]) is None
    assert BT.layout(t.permute(1, 0, 2)) is None


@pytest.mark.parametrize("out_dtype", [None, torch.bfloat16, torch.float64])
def test_newton_into_a_buffer_equals_the_result(out_dtype):
    """block_jacobi_newton writing its last update into a given buffer
    (the captured step's tiles) equals the returned stack and the stock
    chain (2.0 * x - matmul(x, ax) per step, then .to().contiguous())."""
    SB, n = 64, 3
    a, x0 = _seed_case(SB, n, 0.4, seed=11)
    plan = _port_plan(n, SB)
    vals = torch.as_tensor(a.ravel())
    x0t = torch.as_tensor(x0).transpose(1, 2).contiguous().transpose(1, 2)
    g = TP.block_jacobi_guard([(plan, vals, torch.ones(n * SB), 1.0, x0t)],
                              3, out_dtype)
    dt = torch.float32 if out_dtype is None else out_dtype
    assert g.out_dtype == dt
    got = TP.block_jacobi_newton(g, 3)[0]
    buf = torch.empty((n, SB, SB), dtype=dt)
    into = TP.block_jacobi_newton(g, 3, out=[buf])[0]
    x, ax, at = g.xs[0], g.axs[0], g.tiles[0]
    for i in range(3):
        x = 2.0 * x - torch.matmul(x, ax)
        if i < 2:
            ax = torch.matmul(at, x)
    want = x.to(dt).contiguous()
    assert into is buf
    assert _same_bits(got, want) and _same_bits(buf, want)


def test_row_shard_parts_make_one_decision():
    """Two parts, one inside the contraction region and one outside: the
    guard's norm is the larger, and both parts take the exact inverse;
    two parts inside both take Newton-Schulz."""
    SB = 64
    (a1, x1), (a2, x2) = (_seed_case(SB, 2, eps, seed=s)
                          for eps, s in ((0.4, 21), (6.0, 22)))
    plan = _port_plan(2, SB)
    ones = torch.ones(2 * SB)

    def part(a, x):
        return (plan, torch.as_tensor(a.ravel()), ones, 1.0,
                torch.as_tensor(x))

    alone = [float(TP.block_jacobi_guard([part(a, x)], 3).norm)
             for a, x in ((a1, x1), (a2, x2))]
    assert alone[0] < TP.GUARD_LIMIT <= alone[1]
    g = TP.block_jacobi_guard([part(a1, x1), part(a2, x2)], 3)
    assert float(g.norm) == max(alone)
    exact0 = TP.BJ_INVERSIONS["exact"]
    out = TP.block_jacobi_invert_parts([part(a1, x1), part(a2, x2)], 3)
    assert TP.BJ_INVERSIONS["exact"] == exact0 + 1
    for o, t in zip(out, g.tiles):
        assert _same_bits(o, TP._inv(t).contiguous())
    out = TP.block_jacobi_invert_parts([part(a1, x1), part(a1, x1)], 3)
    assert TP.BJ_INVERSIONS["exact"] == exact0 + 1
    assert _same_bits(out[0], out[1])


def test_cpu_path_counts_nothing():
    """On CPU tensors every wrapper takes its plain version: no launch, no
    plain call counted on CUDA tensors, no kernel library built."""
    BT.COUNTS.reset()
    SB = 64
    a, x0 = _seed_case(SB, 2, 0.4, seed=31)
    plan = _port_plan(2, SB)
    TP.block_jacobi_invert(plan, torch.as_tensor(a.ravel()),
                           torch.ones(2 * SB), 1.0, x0=torch.as_tensor(x0))
    assert BT.COUNTS.launches == 0 and BT.COUNTS.plain_cuda_calls == 0
    assert BT.COUNTS.by_variant == {}
