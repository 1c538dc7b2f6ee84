"""PyTorch port vs the JAX package: host tables and per-step operators.

The same mesh (the h=0.12 cylinder channel, reordered and with the
obstacle snapped, so curved cells are present) goes through the JAX
builders and the port's; integer tables must be identical and values and
operator applies agree to 1e-12 in float64.  Random inputs come from a
seeded numpy generator.  ``bench`` builds the tables with the main
path's parameters (128-row padding, F and G/B overflow splits).
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokes_tpu.fem.spaces import TaylorHoodSpace
from navierstokes_tpu.mesh import channel_with_cylinder_2d
from navierstokes_tpu.ops import assembly as JA
from navierstokes_tpu.ops import bsr as JB
from navierstokes_tpu.ops import forces as JF
from navierstokes_tpu.ops import operators as JO
from navierstokes_tpu.ops import p1ell as JP
from navierstokes_tpu_torch import convert
from navierstokes_tpu_torch.ops import assembly as TA
from navierstokes_tpu_torch.ops import bsr as TB
from navierstokes_tpu_torch.ops import forces as TF
from navierstokes_tpu_torch.ops import operators as TO
from navierstokes_tpu_torch.ops import p1ell as TP

torch.set_num_threads(2)
F64 = torch.float64
CPU = torch.device("cpu")
BUILDS = {"default": dict(),
          "bench": dict(row_multiple=128, f_kmax=-1, gb_kmax=-1)}


@pytest.fixture(scope="module")
def space():
    mesh = channel_with_cylinder_2d(h=0.12)
    mesh.reorder_spatial()
    sp = TaylorHoodSpace(mesh)
    assert sp.snap_boundaries(mesh.snap_projectors)
    return sp


@pytest.fixture(scope="module", params=sorted(BUILDS))
def built(request, space):
    kw = BUILDS[request.param]
    jcells = JA.cell_arrays_numpy(space)
    tcells = TA.cell_arrays_numpy(space)
    jb = JB.build_bsr(space, jcells, dtype=jnp.float64, **kw)
    tb = TB.build_bsr(space, tcells, F64, CPU, **kw)
    return space, jcells, tcells, jb, tb


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(a, b, rtol=1e-12):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(np.abs(b).max(), 1e-300)
    np.testing.assert_allclose(a, b, rtol=0, atol=rtol * scale)


def test_cell_arrays_match(built):
    _, jc, tc, _, _ = built
    for name in ("detj", "jinv", "mass", "stiff", "grad"):
        _close(getattr(tc, name), getattr(jc, name))


def test_bsr_integer_tables_identical(built):
    _, _, _, jb, tb = built
    for name in ("f_cols", "diag_idx", "g_cols", "b_cols", "con_row",
                 "con_seg", "cell_p2"):
        np.testing.assert_array_equal(_np(getattr(tb, name)),
                                      _np(getattr(jb, name)), err_msg=name)
    # int8 in JAX when C <= 128: compare widened
    np.testing.assert_array_equal(_np(tb.con_cpos),
                                  _np(jb.con_cpos).astype(np.int64))
    for name in ("g_spill", "b_spill"):
        j, t = getattr(jb, name), getattr(tb, name)
        assert (j is None) == (t is None), name
        if j is not None:
            np.testing.assert_array_equal(_np(t), _np(j), err_msg=name)
    np.testing.assert_array_equal(tb.host.ovf_rows, jb.host_ovf_rows)
    np.testing.assert_array_equal(tb.host.g_cols_full, jb.host_g_cols)
    assert tb.con_splits == (jb.con_splits or tb.con_splits)
    assert (tb.n_vb, tb.n_pb, tb.bu, tb.bp) == (jb.n_vb or tb.n_vb,
                                                jb.n_pb or tb.n_pb,
                                                jb.bu, jb.bp)


def test_bsr_values_match(built):
    _, _, _, jb, tb = built
    _close(tb.m_blk, jb.m_blk)
    _close(tb.host.k_blk, jb.host_k_blk)
    _close(tb.g_blk, jb.g_blk)
    _close(tb.b_blk, jb.b_blk)
    for name in ("detj", "jinv", "curv_phi", "curv_dphys"):
        _close(getattr(tb, name), getattr(jb, name))
    np.testing.assert_array_equal(_np(tb.curv_ids), _np(jb.curv_ids))


def test_f_spill_lists_every_real_overflow_row_once(built):
    """The per-physical-row spill table replaces the JAX scatter-add fold:
    each non-padding virtual row appears exactly once, in the row of its
    ovf_rows entry; padding rows carry zero values and are left out."""
    _, _, _, jb, tb = built
    n_vb, n_ext = tb.n_vb, tb.f_cols.shape[0]
    if tb.f_spill is None:
        assert jb.ovf_rows is None or not np.any(_np(jb.m_blk)[n_vb:])
        return
    spill = _np(tb.f_spill)
    live = spill[spill < n_ext]
    assert len(live) == len(np.unique(live))
    ovf = tb.host.ovf_rows
    rows = np.nonzero(spill < n_ext)[0]
    np.testing.assert_array_equal(ovf[live - n_vb], rows)
    dead = np.setdiff1d(np.arange(n_vb, n_ext), live)
    assert not np.any(_np(jb.m_blk)[dead])


def test_applies_match_jax(built):
    sp, _, _, jb, tb = built
    rng = np.random.default_rng(0)
    u = rng.standard_normal((sp.n_p2, 2))
    p = rng.standard_normal(sp.n_p1)
    f_np = _np(jb.m_blk) * 3.0 + 0.01 * rng.standard_normal(
        _np(jb.m_blk).shape) * (_np(jb.m_blk) != 0)
    jf, tf = jnp.asarray(f_np), torch.as_tensor(f_np)
    tu, tp = torch.as_tensor(u), torch.as_tensor(p)
    ju, jp = jnp.asarray(u), jnp.asarray(p)
    _close(TB.apply_f(tb, tf, tu), JB.apply_f(jb, jf, ju))
    _close(TB.mass_apply(tb, tu), JB.mass_apply(jb, ju))
    _close(TB.apply_bt(tb, tp), JB.apply_bt(jb, jp))
    _close(TB.apply_b(tb, tu), JB.apply_b(jb, ju))
    _close(TB.f_diag(tb, tf), JB.f_diag(jb, jf))
    ops = TB.BsrOps()
    yu, yp = ops.apply_blocks(tb, tf, tu, tp)
    _close(yu, JB.apply_f(jb, jf, ju) + JB.apply_bt(jb, jp))
    _close(yp, JB.apply_b(jb, ju))


def test_convection_matches_jax(built):
    sp, _, _, jb, tb = built
    assert tb.curv_ids is not None and len(tb.curv_ids) > 0
    rng = np.random.default_rng(1)
    u = rng.standard_normal((sp.n_p2, 2))
    _close(TO.convection_matrices(tb, tb.t_hat, torch.as_tensor(u)),
           JO.convection_matrices(jb, jb.t_hat, jnp.asarray(u)))
    _close(TB.convection_blk(tb, torch.as_tensor(u)),
           JB.convection_blk(jb, jnp.asarray(u)))


@pytest.fixture(scope="module")
def ell_pair(space):
    cells = JA.cell_arrays_numpy(space)
    out = np.arange(0, space.n_p1, 7)
    je = JP.assemble_p1_stiffness(space, cells, jnp.float64,
                                  dirichlet_nodes=out)
    te = TP.assemble_p1_stiffness(space, TA.cell_arrays_numpy(space), F64,
                                  CPU, dirichlet_nodes=out)
    return je, te


def test_p1_stiffness_and_ell_matvec(space, ell_pair):
    je, te = ell_pair
    np.testing.assert_array_equal(_np(te.cols), _np(je.cols))
    _close(te.vals, je.vals)
    _close(te.diag, je.diag)
    x = np.random.default_rng(2).standard_normal(space.n_p1)
    _close(TP.ell_matvec(te, torch.as_tensor(x)),
           JP.ell_matvec(je, jnp.asarray(x)))
    _close(TP.coarse_from_ell(te, 4), JP.coarse_from_ell(je, 4))


def test_block_jacobi_matches_jax(built):
    sp, _, _, jb, tb = built
    S = 256 // tb.bu
    jplan = JP.build_block_jacobi_plan(jb, S=S, layout="blocked")
    tplan = TP.build_block_jacobi_plan(tb.host.f_cols, tb.host.ovf_rows,
                                       tb.n_vb, tb.bu, sp.n_p2, S, CPU)
    np.testing.assert_array_equal(tplan.idx, _np(jplan.idx))
    assert tplan.n_tiles == jplan.n_tiles
    rng = np.random.default_rng(3)
    f0 = 400.0 * _np(jb.m_blk) + 1e-3 * _np(jb.host_k_blk)
    f1 = f0 + 0.05 * rng.standard_normal(f0.shape) * (f0 != 0)
    mask = (rng.uniform(size=sp.n_p2) > 0.1).astype(np.float64)
    jm, tm = jnp.asarray(mask), torch.as_tensor(mask)
    sigma = 7.5
    _close(TP.block_jacobi_tiles(tplan, torch.as_tensor(f1), tm, sigma),
           JP.block_jacobi_tiles(jplan, jnp.asarray(f1), jm, sigma),
           rtol=1e-12)        # the same float64 values rounded to fp32
    jx0 = JP.block_jacobi_inverse(jplan, jnp.asarray(f0), jm, sigma)
    tx0 = TP.block_jacobi_inverse(tplan, torch.as_tensor(f0), tm, sigma)
    _close(tx0, jx0, rtol=1e-4)          # fp32 LU of two libraries
    jinv = JP.block_jacobi_invert(jplan, jnp.asarray(f1), jm, sigma,
                                  x0=jx0, iters=3)
    tinv = TP.block_jacobi_invert(tplan, torch.as_tensor(f1), tm, sigma,
                                  x0=torch.as_tensor(np.array(jx0)), iters=3)
    _close(tinv, jinv, rtol=1e-5)        # fp32 Newton-Schulz products
    r = rng.standard_normal((sp.n_p2, 2))
    _close(TP.block_jacobi_apply(tplan, torch.as_tensor(np.array(jinv)),
                                 torch.as_tensor(r)),
           JP.block_jacobi_apply(jplan, jinv, jnp.asarray(r)))


@pytest.mark.parametrize("formula", ["reference", "st"])
def test_forces_match_jax(space, formula):
    from navierstokes_tpu.mesh.geometry import TAG_OBSTACLE
    jfa = JA.build_face_arrays(space, TAG_OBSTACLE, jnp.float64)
    tfa = TA.build_face_arrays(space, TAG_OBSTACLE, F64, CPU)
    rng = np.random.default_rng(4)
    u = rng.standard_normal((space.n_p2, 2))
    p = rng.standard_normal(space.n_p1)
    jd, jl = JF.drag_lift(jfa, jnp.asarray(u), jnp.asarray(p), 1e-3,
                          formula=formula)
    td, tl = TF.drag_lift(tfa, torch.as_tensor(u), torch.as_tensor(p), 1e-3,
                          formula=formula)
    _close(td, jd)
    _close(tl, jl)
    for um in (1.0, torch.tensor(0.2, dtype=F64)):
        jc = JF.force_coefficients(jd, jl, float(um), 0.1, 2)
        tc = TF.force_coefficients(td, tl, um, 0.1, 2)
        _close(tc[0], jc[0])
        _close(tc[1], jc[1])


def test_convert_bsr_from_jax(built):
    sp, _, _, jb, tb = built
    fields = {f.name: getattr(jb, f.name) for f in dataclasses.fields(jb)}
    fields.update(host_m_blk=jb.host_m_blk, host_k_blk=jb.host_k_blk,
                  host_g_cols=jb.host_g_cols)
    cb = convert.bsr_from_jax_numpy(fields, CPU, F64)
    for name in ("f_cols", "f_spill", "g_spill", "b_spill", "con_cpos",
                 "pp_cols"):
        a, b = getattr(cb, name), getattr(tb, name)
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b), name
    assert torch.equal(cb.pp_plan.order, tb.pp_plan.order)
    assert torch.equal(cb.pp_plan.lengths, tb.pp_plan.lengths)
    rng = np.random.default_rng(5)
    u = torch.as_tensor(rng.standard_normal((sp.n_p2, 2)))
    p = torch.as_tensor(rng.standard_normal(sp.n_p1))
    _close(TB.mass_apply(cb, u), TB.mass_apply(tb, u))
    _close(TB.convection_blk(cb, u), TB.convection_blk(tb, u))
    _close(TB.apply_bt(cb, p), TB.apply_bt(tb, p))
    npc = TB.pressure_convection_blk(cb, u)
    _close(npc, TB.pressure_convection_blk(tb, u))
    _close(TB.apply_pp(cb, npc, p), TB.apply_pp(tb, npc, p))


def test_convert_ell_plan_and_state(space, ell_pair, built):
    je, te = ell_pair
    ce = convert.ell_from_jax_numpy(je.cols, je.vals, je.diag, je.n, je.b,
                                    CPU, F64)
    np.testing.assert_array_equal(ce.host_vals, te.host_vals)
    np.testing.assert_array_equal(ce.host_cols, te.host_cols)
    _, _, _, jb, tb = built
    jplan = JP.build_block_jacobi_plan(jb, S=16, layout="blocked")
    cp = convert.bj_plan_from_jax_numpy(jplan.idx, jplan.n_tiles, 16, jb.bu,
                                        jb.n_p2, jb.f_cols.shape, CPU)
    tp = TP.build_block_jacobi_plan(tb.host.f_cols, tb.host.ovf_rows,
                                    tb.n_vb, tb.bu, space.n_p2, 16, CPU)
    assert torch.equal(cp.bidx, tp.bidx)
    rng = np.random.default_rng(6)
    arrs = [rng.standard_normal((space.n_p2, 2)),
            rng.standard_normal(space.n_p1),
            rng.standard_normal((space.n_p2, 2)),
            rng.standard_normal(space.n_p1)]
    st = convert.state_from_jax_numpy(*[jnp.asarray(a) for a in arrs], 0.25,
                                      CPU, F64)
    for a, t in zip(arrs, (st.u, st.p, st.u_prev, st.phi)):
        np.testing.assert_array_equal(t.numpy(), a)
    assert st.time == 0.25


def test_port_imports_no_jax():
    """Every module of the port imports without pulling in jax (a fresh
    interpreter: this test process has jax loaded by conftest)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import navierstokes_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "'navierstokes_tpu_torch.')]\n"
        "[importlib.import_module(m) for m in mods]\n"
        "assert len(mods) >= 12, mods\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.')]\n"
        "assert not bad, bad\n"
        "print('ok', len(mods))\n")
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root,
                         env={**os.environ, "PYTHONPATH": str(root)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
