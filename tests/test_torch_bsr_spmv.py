"""The blocked-ELL SpMV of the port (kernels/bsr_spmv.py) against the JAX
package: its plain version against the Pallas ``fused_reduce`` (interpret
mode, fp32 and bf16) and against ``bsr.apply_f`` (float64 and bf16), its
D=1 uses (P1 Laplacian, B, G) against their JAX functions, bf16
block-Jacobi tiles, and the CPU dispatch.  The CUDA kernel variants
against the plain version are in tests/test_torch_cuda.py.
Fixture: the h=0.12 cylinder channel of tests/test_pallas_matvec.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokes_tpu.fem.spaces import TaylorHoodSpace
from navierstokes_tpu.mesh import channel_with_cylinder_2d
from navierstokes_tpu.ops import assembly as JA
from navierstokes_tpu.ops import bsr as JB
from navierstokes_tpu.ops import p1ell as JP
from navierstokes_tpu.ops.pallas_matvec import apply_f_fused
from navierstokes_tpu_torch.kernels import bsr_spmv as K
from navierstokes_tpu_torch.ops import assembly as TA
from navierstokes_tpu_torch.ops import bsr as TB
from navierstokes_tpu_torch.ops import p1ell as TP

torch.set_num_threads(2)
BENCH_KW = dict(row_multiple=128, f_kmax=-1, gb_kmax=-1)


@pytest.fixture(scope="module")
def fx():
    mesh = channel_with_cylinder_2d(h=0.12)
    sp = TaylorHoodSpace(mesh)
    jc = JA.cell_arrays_numpy(sp)
    tc = TA.cell_arrays_numpy(sp)
    jb = JB.build_bsr(sp, jc, dtype=jnp.float64, **BENCH_KW)
    tb64 = TB.build_bsr(sp, tc, torch.float64, "cpu", **BENCH_KW)
    tb32 = TB.build_bsr(sp, tc, torch.float32, "cpu", **BENCH_KW)
    return sp, jc, jb, tb64, tb32


def test_plain_matches_pallas_fp32(fx):
    """fp32, the bound tests/test_pallas_matvec.py uses (rtol 2e-5)."""
    sp, _, jb, _, tb32 = fx
    rng = np.random.default_rng(0)
    xu = rng.standard_normal((sp.n_p2, 2)).astype(np.float32)
    f_np = np.asarray(jb.k_blk + 0.5 * jb.m_blk, np.float32)
    y_pl = apply_f_fused(jb, jnp.asarray(f_np), jnp.asarray(xu),
                         interpret=True)
    y_t = TB.apply_f(tb32, torch.from_numpy(f_np), torch.from_numpy(xu))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_pl), rtol=2e-5,
                               atol=2e-5)


def test_plain_bf16_matches_apply_f_and_pallas(fx):
    """bf16 values: x rounded to bf16, each product rounded to bf16, fp32
    sums.  JAX ``apply_f`` rounds the same way, so only the fp32 summation
    order differs (gate 1e-4 of max|y|; measured about 9e-8).  The Pallas
    kernel in interpret mode on XLA:CPU keeps the bf16 x bf16 product
    unrounded in fp32 (it matches the unrounded product to 1e-4 here), so
    against it the port differs by one bf16 rounding of each product,
    about 2.5e-3 of max|y|: the test holds it to the 2e-2 of
    tests/test_pallas_matvec.py."""
    sp, _, jb, _, tb32 = fx
    rng = np.random.default_rng(7)
    xu = rng.standard_normal((sp.n_p2, 2)).astype(np.float32)
    f_np = np.asarray(jb.k_blk + 0.5 * jb.m_blk, np.float32)
    fj = jnp.asarray(f_np).astype(jnp.bfloat16)
    ft = torch.from_numpy(f_np).to(torch.bfloat16)
    y_t = TB.apply_f(tb32, ft, torch.from_numpy(xu)).numpy()
    y_a = np.asarray(JB.apply_f(jb, fj, jnp.asarray(xu)), np.float32)
    y_pl = np.asarray(apply_f_fused(jb, fj, jnp.asarray(xu), interpret=True))
    scale = np.abs(y_a).max()
    assert y_t.dtype == np.float32
    assert np.abs(y_t - y_a).max() <= 1e-4 * scale
    assert np.abs(y_t - y_pl).max() <= 2e-2 * scale
    # the interpret-mode difference is the product rounding alone
    xg = TB._ublocks(tb32, torch.from_numpy(xu)).to(torch.bfloat16).float()
    unrounded = K.bsr_spmv_plain(ft.float(), tb32.f_cols, xg, tb32.bu,
                                 tb32.f_spill, tb32.n_vb)
    unrounded = unrounded.reshape(-1, 2)[:sp.n_p2].numpy()
    assert np.abs(unrounded - y_pl).max() <= 1e-4 * scale


def test_block_jacobi_apply_bf16_matches_jax(fx):
    """bf16 tiles: r rounded to bf16, a bf16 batched product, cast back."""
    sp, _, jb, _, tb32 = fx
    S = 16
    jplan = JP.build_block_jacobi_plan(jb, S=S, layout="blocked")
    tplan = TP.build_block_jacobi_plan(tb32.host.f_cols, tb32.host.ovf_rows,
                                       tb32.n_vb, tb32.bu, sp.n_p2, S, "cpu")
    rng = np.random.default_rng(8)
    SB = S * tb32.bu
    tiles = rng.standard_normal((tplan.n_tiles, SB, SB)).astype(np.float32)
    r = rng.standard_normal((sp.n_p2, 2)).astype(np.float32)
    yj = np.asarray(JP.block_jacobi_apply(
        jplan, jnp.asarray(tiles).astype(jnp.bfloat16), jnp.asarray(r)))
    yt = TP.block_jacobi_apply(tplan, torch.from_numpy(tiles).to(
        torch.bfloat16), torch.from_numpy(r))
    assert yt.dtype == torch.float32
    np.testing.assert_allclose(yt.numpy(), yj, rtol=0,
                               atol=1e-4 * np.abs(yj).max())


def test_plain_matches_apply_f_float64(fx):
    sp, _, jb, tb64, _ = fx
    rng = np.random.default_rng(1)
    xu = rng.standard_normal((sp.n_p2, 2))
    f_np = np.asarray(jb.k_blk, np.float64) + 0.5 * np.asarray(jb.m_blk)
    y_j = JB.apply_f(jb, jnp.asarray(f_np), jnp.asarray(xu))
    y_t = TB.apply_f(tb64, torch.as_tensor(f_np), torch.as_tensor(xu))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-12,
                               atol=1e-12 * np.abs(np.asarray(y_j)).max())


def test_d1_uses_match_jax(fx):
    """P1 Laplacian (cb=b), B (cb=bu*dim) and G (R=dim*bu, cb=bp)."""
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
    ref = K.bsr_spmv_plain(tb64.m_blk, tb64.f_cols,
                           TB._ublocks(tb64, u), tb64.bu, tb64.f_spill,
                           tb64.n_vb).reshape(-1, 2)[:sp.n_p2]
    assert torch.equal(y, ref)
    assert K.COUNTS.launches == 0
    assert K.COUNTS.plain_cuda_calls == 0


def test_unsupported_device_raises(fx):
    _, _, _, tb64, _ = fx
    vals = torch.empty(tb64.m_blk.shape, device="meta")
    x = torch.empty((tb64.n_vb * tb64.bu, 2), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        K.bsr_spmv(vals, tb64.f_cols, x, tb64.bu)
