"""The SELL SpMV of the port (kernels/sell_spmv.py) and its compact
layout (ops/sell.py) against the JAX package.

* the layout: every nonzero of the JAX blocked ELLs (F, G, B) lies in one
  slot of the compact pattern, each slot holds at most one, padding slots
  hold 0, and every lane's slots are listed once;
* the plain product against the Pallas ``fused_reduce`` (interpret mode,
  fp32 and bf16) and against ``bsr.apply_f`` (float64 and bf16);
* every operator's product against the JAX package's own function on the
  same numpy-seeded inputs: F, the mass, Ap and the P1 Laplacian
  (``p1ell.ell_matvec``), whole-row and split G (``apply_bt``) and B
  (``apply_b``), the PCD pressure convection (``apply_pp``); float64
  within 1e-12 relative, fp32 within 2e-5;
* the plain product's summation order (slot order from zero, rounded
  products), bf16 block-Jacobi tiles, and the CPU dispatch.

The CUDA kernel variants against the plain version are in
tests/test_torch_cuda.py.  Fixture: the h=0.12 cylinder channel of
tests/test_pallas_matvec.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_jax_ops as TJ
from navierstokes_tpu.fem.spaces import TaylorHoodSpace
from navierstokes_tpu.mesh import channel_with_cylinder_2d
from navierstokes_tpu.ops import assembly as JA
from navierstokes_tpu.ops import bsr as JB
from navierstokes_tpu.ops import p1ell as JP
from navierstokes_tpu.ops.pallas_matvec import apply_f_fused
from navierstokes_tpu_torch.kernels import sell_spmv as K
from navierstokes_tpu_torch.ops import assembly as TA
from navierstokes_tpu_torch.ops import bsr as TB
from navierstokes_tpu_torch.ops import p1ell as TP
from navierstokes_tpu_torch.ops import sell as TS

torch.set_num_threads(2)
# the JAX tables of the bench path (F overflow split, split G/B) and the
# whole-row G/B of the monolithic scheme
JAX_BUILDS = {"split": dict(row_multiple=128, f_kmax=-1, gb_kmax=-1),
              "whole": dict(row_multiple=128, f_kmax=-1, gb_kmax=0)}


@pytest.fixture(scope="module")
def fx():
    mesh = channel_with_cylinder_2d(h=0.12)
    sp = TaylorHoodSpace(mesh)
    jc = JA.cell_arrays_numpy(sp)
    tc = TA.cell_arrays_numpy(sp)
    jb = JB.build_bsr(sp, jc, dtype=jnp.float64, **JAX_BUILDS["split"])
    tb64 = TB.build_bsr(sp, tc, torch.float64, "cpu")
    tb32 = TB.build_bsr(sp, tc, torch.float32, "cpu")
    return sp, jc, jb, tb64, tb32


def _f_np(jb):
    return np.asarray(jb.host_k_blk, np.float64) + 0.5 * np.asarray(jb.m_blk)


def test_plain_matches_pallas_fp32(fx):
    """fp32, the bound tests/test_pallas_matvec.py uses (rtol 2e-5)."""
    sp, _, jb, _, tb32 = fx
    rng = np.random.default_rng(0)
    xu = rng.standard_normal((sp.n_p2, 2)).astype(np.float32)
    f_np = _f_np(jb).astype(np.float32)
    y_pl = apply_f_fused(jb, jnp.asarray(f_np), jnp.asarray(xu),
                         interpret=True)
    ft = TJ.on(tb32.f, TJ.f_coo(jb, f_np), torch.float32)
    y_t = TB.apply_f(tb32, ft, torch.from_numpy(xu))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_pl), rtol=2e-5,
                               atol=2e-5)


def test_plain_bf16_matches_apply_f_and_pallas(fx):
    """bf16 values: x rounded to bf16, each product rounded to bf16, fp32
    sums.  JAX ``apply_f`` rounds the same way, so only the fp32 summation
    order differs (gate 1e-4 of max|y|).  The Pallas kernel in interpret
    mode on XLA:CPU keeps the bf16 x bf16 product unrounded in fp32 (it
    matches the unrounded product to 1e-4 here), so against it the port
    differs by one bf16 rounding of each product, about 2.5e-3 of max|y|:
    the test holds it to the 2e-2 of tests/test_pallas_matvec.py."""
    sp, _, jb, _, tb32 = fx
    rng = np.random.default_rng(7)
    xu = rng.standard_normal((sp.n_p2, 2)).astype(np.float32)
    f_np = _f_np(jb).astype(np.float32)
    fj = jnp.asarray(f_np).astype(jnp.bfloat16)
    ft = TJ.on(tb32.f, TJ.f_coo(jb, f_np), torch.float32).to(torch.bfloat16)
    y_t = TB.apply_f(tb32, ft, torch.from_numpy(xu)).numpy()
    y_a = np.asarray(JB.apply_f(jb, fj, jnp.asarray(xu)), np.float32)
    y_pl = np.asarray(apply_f_fused(jb, fj, jnp.asarray(xu), interpret=True))
    scale = np.abs(y_a).max()
    assert y_t.dtype == np.float32
    assert np.abs(y_t - y_a).max() <= 1e-4 * scale
    assert np.abs(y_t - y_pl).max() <= 2e-2 * scale
    # the interpret-mode difference is the product rounding alone
    xg = torch.from_numpy(xu).to(torch.bfloat16).float()
    unrounded = K.sell_spmv_plain(tb32.f, ft.float(), xg).numpy()
    assert np.abs(unrounded - y_pl).max() <= 1e-4 * scale


def test_block_jacobi_apply_bf16_matches_jax(fx):
    """bf16 tiles: r rounded to bf16, a bf16 batched product, cast back."""
    sp, _, jb, _, tb32 = fx
    S = 16
    jplan = JP.build_block_jacobi_plan(jb, S=S, layout="blocked")
    tplan = TP.build_block_jacobi_plan(tb32.f, tb32.bu, sp.n_p2, S, "cpu")
    # JAX pads its node blocks to 128 rows, so it has more (padding) tiles
    assert tplan.n_tiles == -(-sp.n_p2 // (S * tb32.bu)) <= jplan.n_tiles
    rng = np.random.default_rng(8)
    SB = S * tb32.bu
    tiles = rng.standard_normal((jplan.n_tiles, SB, SB)).astype(np.float32)
    r = rng.standard_normal((sp.n_p2, 2)).astype(np.float32)
    yj = np.asarray(JP.block_jacobi_apply(
        jplan, jnp.asarray(tiles).astype(jnp.bfloat16), jnp.asarray(r)))
    yt = TP.block_jacobi_apply(tplan, torch.from_numpy(
        tiles[:tplan.n_tiles]).to(torch.bfloat16), torch.from_numpy(r))
    assert yt.dtype == torch.float32
    np.testing.assert_allclose(yt.numpy(), yj, rtol=0,
                               atol=1e-4 * np.abs(yj).max())


def test_plain_matches_apply_f_float64(fx):
    sp, _, jb, tb64, _ = fx
    rng = np.random.default_rng(1)
    xu = rng.standard_normal((sp.n_p2, 2))
    f_np = _f_np(jb)
    y_j = JB.apply_f(jb, jnp.asarray(f_np), jnp.asarray(xu))
    ft = TJ.on(tb64.f, TJ.f_coo(jb, f_np), torch.float64)
    y_t = TB.apply_f(tb64, ft, torch.as_tensor(xu))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-12,
                               atol=1e-12 * np.abs(np.asarray(y_j)).max())


def test_d1_uses_match_jax(fx):
    """P1 Laplacian, B and G against their JAX functions."""
    sp, jc, jb, tb64, _ = fx
    rng = np.random.default_rng(2)
    p = rng.standard_normal(sp.n_p1)
    u = rng.standard_normal((sp.n_p2, 2))
    je = JP.assemble_p1_stiffness(sp, jc, jnp.float64)
    te = TP.assemble_p1_stiffness(sp, TA.cell_arrays_numpy(sp),
                                  torch.float64, "cpu")
    pairs = [(TP.ell_matvec(te, torch.as_tensor(p)),
              JP.ell_matvec(je, jnp.asarray(p))),
             (TB.apply_b(tb64, torch.as_tensor(u)),
              JB.apply_b(jb, jnp.asarray(u))),
             (TB.apply_bt(tb64, torch.as_tensor(p)),
              JB.apply_bt(jb, jnp.asarray(p)))]
    for t, j in pairs:
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=1e-12 * np.abs(j).max())


def test_cpu_tensors_take_plain_path(fx):
    sp, _, _, tb64, _ = fx
    K.COUNTS.reset()
    u = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (sp.n_p2, 2)))
    y = TB.mass_apply(tb64, u)
    assert torch.equal(y, K.sell_spmv_plain(tb64.f, tb64.m_vals, u))
    assert K.COUNTS.launches == 0
    assert K.COUNTS.plain_cuda_calls == 0
    assert K.COUNTS.by_pattern == {}


def test_unsupported_device_raises(fx):
    _, _, _, tb64, _ = fx
    vals = torch.empty(tb64.m_vals.shape, device="meta")
    x = torch.empty((tb64.n_p2, 2), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        K.sell_spmv(tb64.f, vals, x)


# ---------------------------------------------------------------------------
# the layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("build", sorted(JAX_BUILDS))
@pytest.mark.parametrize("op", ["F", "G", "B"])
def test_every_ell_nonzero_has_one_slot(fx, build, op):
    """Every nonzero entry of the JAX blocked ELL lies in the compact
    pattern, in a slot of its own; the values agree exactly (both sum the
    element entries in element order); padding slots hold 0."""
    sp, jc, _, tb64, _ = fx
    jb = JB.build_bsr(sp, jc, dtype=jnp.float64, **JAX_BUILDS[build])
    mat, vals, coo = {
        "F": (tb64.f, tb64.m_vals, lambda: TJ.f_coo(jb, jb.m_blk)),
        "G": (tb64.g, tb64.g_vals, lambda: TJ.g_coo(jb)),
        "B": (tb64.b, tb64.b_vals, lambda: TJ.b_coo(jb))}[op]
    r, c, v = coo()
    nz = v != 0
    key = r[nz] * mat.n_cols + c[nz]
    assert len(np.unique(key)) == len(key)
    nz_key = mat.nz_row * mat.n_cols + mat.nz_col
    pos = np.searchsorted(nz_key, key)
    assert np.array_equal(nz_key[pos], key)
    vals = vals.numpy()
    assert np.array_equal(vals[mat.nz_slot[pos]], v[nz])
    pad = np.ones(mat.n_slots, bool)
    pad[mat.nz_slot] = False
    assert not vals[pad].any()
    assert len(np.unique(mat.nz_slot)) == mat.nnz


@pytest.mark.parametrize("sigma", [1, 64, TS.SIGMA])
def test_layout_slots_and_padding(fx, sigma):
    """The lanes' slot lists cover every slot once; a slice's width is its
    longest row; padding slots gather a column of their own row; rows
    ascend inside each sorting window by descending length."""
    _, _, _, tb64, _ = fx
    f = tb64.f
    m = TS.build_sell(f.nz_row, f.nz_col, f.n_rows, f.n_cols, "cpu",
                      sigma=sigma)
    order, lane_w = m.plain_order()
    order = order.numpy()
    assert np.array_equal(np.sort(order), np.arange(m.n_slots))
    assert np.array_equal(m.nz_col, m.cols.numpy()[m.nz_slot])
    counts = np.bincount(m.nz_row, minlength=m.n_rows)
    rows = m.rows.numpy()
    live = rows >= 0
    assert np.array_equal(np.sort(rows[live]), np.arange(m.n_rows))
    lane_cnt = np.where(live, counts[np.maximum(rows, 0)], 0)
    assert np.array_equal(lane_w.numpy().reshape(-1, TS.C).max(axis=1),
                          lane_cnt.reshape(-1, TS.C).max(axis=1))
    win = rows[live] // sigma
    assert np.all(np.diff(win) >= 0)
    # padding slots point at a column their row already has
    lane_of_slot = np.repeat(np.arange(len(lane_w)), lane_w.numpy())
    slot_row = np.empty(m.n_slots, np.int64)
    slot_row[order] = rows[lane_of_slot]
    pad = np.ones(m.n_slots, bool)
    pad[m.nz_slot] = False
    pad &= slot_row >= 0
    have = set(zip(m.nz_row.tolist(), m.nz_col.tolist()))
    assert all((r, c) in have for r, c in zip(
        slot_row[pad].tolist(), m.cols.numpy()[pad].tolist()))
    fill = m.nnz / m.n_slots
    assert fill > (0.9 if sigma == TS.SIGMA else 0.4)


def test_plain_sums_in_slot_order(fx):
    """The plain product sums each row's rounded products in slot order
    from zero, one rounding per product and per sum (the kernel's order)."""
    sp, _, _, _, tb32 = fx
    rng = np.random.default_rng(9)
    f = tb32.f
    nz = (rng.standard_normal(f.nnz) * 10.0 ** rng.integers(-4, 4, f.nnz))
    vals = f.values(nz, torch.float32)
    x = torch.as_tensor(rng.standard_normal((sp.n_p2, 2)),
                        dtype=torch.float32)
    y = K.sell_spmv_plain(f, vals, x).numpy()
    v32, x32 = vals.numpy(), x.numpy()
    cols = f.cols.numpy()
    order, lane_w = f.plain_order()
    order, lane_w = order.numpy(), lane_w.numpy()
    starts = np.concatenate([[0], np.cumsum(lane_w)])
    rows = f.rows.numpy()
    for lane in rng.choice(np.nonzero(rows >= 0)[0], 40, replace=False):
        acc = np.zeros(2, np.float32)
        for s in order[starts[lane]:starts[lane + 1]]:
            acc = (acc + (v32[s] * x32[cols[s]]).astype(np.float32)
                   ).astype(np.float32)
        assert np.array_equal(acc, y[rows[lane]])


# ---------------------------------------------------------------------------
# every operator against the JAX function
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ops(fx):
    """(port product, JAX product, n_in, D, extra) of every operator, on
    float64 values, with the JAX build each one is held to; F's extra is
    (port values, JAX values, JAX build)."""
    sp, jc, jb_split, tb64, _ = fx
    jb_whole = JB.build_bsr(sp, jc, dtype=jnp.float64,
                            **JAX_BUILDS["whole"])
    tc = TA.cell_arrays_numpy(sp)
    rng = np.random.default_rng(20)
    u_adv = 0.3 * rng.standard_normal((sp.n_p2, 2))
    w = rng.uniform(0.5, 2.0, sp.n_p2)
    je_ap = JP.assemble_ap(sp, jc, w, jnp.float64)
    te_ap = TP.assemble_ap(sp, tc, w, torch.float64, "cpu")
    out_nodes = np.arange(0, sp.n_p1, 7)
    je_l = JP.assemble_p1_stiffness(sp, jc, jnp.float64,
                                    dirichlet_nodes=out_nodes)
    te_l = TP.assemble_p1_stiffness(sp, tc, torch.float64, "cpu",
                                    dirichlet_nodes=out_nodes)
    np_j = JB.pressure_convection_blk(jb_split, jnp.asarray(u_adv))
    np_t = TB.pressure_convection_blk(tb64, torch.as_tensor(u_adv))
    f_j = jb_split.m_blk * 3.0 + JB.convection_blk(jb_split,
                                                   jnp.asarray(u_adv))
    f_t = tb64.m_vals * 3.0 + TB.convection_blk(tb64, torch.as_tensor(u_adv))
    return {
        "F": (lambda v, x: TB.apply_f(tb64, v(f_t), x),
              lambda x: JB.apply_f(jb_split, f_j, x), sp.n_p2, 2,
              (f_t, f_j, jb_split)),
        "mass": (lambda v, x: TB.apply_f(tb64, v(tb64.m_vals), x),
                 lambda x: JB.mass_apply(jb_split, x), sp.n_p2, 2, None),
        "Ap": (lambda v, x: K.sell_spmv(te_ap.mat, v(te_ap.vals), x),
               lambda x: JP.ell_matvec(je_ap, x), sp.n_p1, 1, None),
        "P1 Laplacian": (lambda v, x: K.sell_spmv(te_l.mat, v(te_l.vals), x),
                         lambda x: JP.ell_matvec(je_l, x), sp.n_p1, 1, None),
        "G whole": (lambda v, x: K.sell_spmv(tb64.g, v(tb64.g_vals), x),
                    lambda x: JB.apply_bt(jb_whole, x).reshape(-1),
                    sp.n_p1, 1, None),
        "G split": (lambda v, x: K.sell_spmv(tb64.g, v(tb64.g_vals), x),
                    lambda x: JB.apply_bt(jb_split, x).reshape(-1),
                    sp.n_p1, 1, None),
        "B whole": (lambda v, x: K.sell_spmv(tb64.b, v(tb64.b_vals),
                                             x.reshape(-1)),
                    lambda x: JB.apply_b(jb_whole, x), sp.n_p2, 2, None),
        "B split": (lambda v, x: K.sell_spmv(tb64.b, v(tb64.b_vals),
                                             x.reshape(-1)),
                    lambda x: JB.apply_b(jb_split, x), sp.n_p2, 2, None),
        "PCD convection": (lambda v, x: TB.apply_pp(tb64, v(np_t), x),
                           lambda x: JB.apply_pp(jb_split, np_j, x),
                           sp.n_p1, 1, None),
    }


OPS = ["F", "mass", "Ap", "P1 Laplacian", "G whole", "G split", "B whole",
       "B split", "PCD convection"]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("op", OPS)
def test_operator_matches_jax(ops, op, dtype):
    """float64 within 1e-12 of max|y| (summation order only); fp32 values
    and x (cast from the same float64 ones) within 2e-5, the fp32 bound of
    tests/test_pallas_matvec.py."""
    port, jax_fn, n_in, D, _ = ops[op]
    rng = np.random.default_rng(21)
    x = rng.standard_normal((n_in, D) if D == 2 else n_in)
    y_j = np.asarray(jax_fn(jnp.asarray(x)))
    dt, tol = ((torch.float64, 1e-12) if dtype == "float64"
               else (torch.float32, 2e-5))
    y_t = port(lambda v: v.to(dt), torch.as_tensor(x, dtype=dt))
    assert y_t.dtype == dt
    y_t = y_t.double().numpy().reshape(y_j.shape)
    assert np.abs(y_t - y_j).max() <= tol * np.abs(y_j).max()


def test_f_bf16_matches_apply_f(ops):
    """bf16 F values (with convection) against JAX ``apply_f`` on the same
    values in bf16: the same roundings of x and of each product, the fp32
    summation order apart (1e-4 of max|y|)."""
    port, _, n_in, _, (f_t, f_j, jb) = ops["F"]
    rng = np.random.default_rng(22)
    x = rng.standard_normal((n_in, 2)).astype(np.float32)
    y_t = port(lambda v: f_t.to(torch.bfloat16), torch.as_tensor(x))
    y_j = np.asarray(JB.apply_f(jb, jnp.asarray(f_j).astype(jnp.bfloat16),
                                jnp.asarray(x)), np.float32)
    assert y_t.dtype == torch.float32
    assert np.abs(y_t.numpy() - y_j).max() <= 1e-4 * np.abs(y_j).max()
