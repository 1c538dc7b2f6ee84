"""PyTorch port vs the JAX package: host tables and per-step operators.

The same mesh (the h=0.12 cylinder channel, reordered and with the
obstacle snapped, so curved cells are present) goes through the JAX
builders and the port's.  The JAX package keeps its operators in blocked
ELLs, the port in compact SELL patterns (ops/sell.py): JAX values are
carried into the port's slots (tests/torch_jax_ops.py, through
navierstokes_tpu_torch/convert.py), the tables both keep must be
identical, and values and operator applies agree to 1e-12 in float64.
Random inputs come from a seeded numpy generator.  ``bench`` builds the
JAX tables with the main path's parameters (128-row padding, F and G/B
overflow splits).
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

import torch_jax_ops as TJ
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
    tb = TB.build_bsr(space, tcells, F64, CPU)
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
    """The tables the port keeps from the JAX layout: the cell map and the
    whole-row G block table of the Schur coarse assembly (JAX pads its
    node blocks to 128 rows with empty ones); the block sizes."""
    _, _, _, jb, tb = built
    np.testing.assert_array_equal(_np(tb.cell_p2),
                                  _np(jb.cell_p2)[:tb.cell_p2.shape[0]])
    jg = np.asarray(jb.host_g_cols)
    n_vb = tb.host.g_cols_full.shape[0]
    np.testing.assert_array_equal(tb.host.g_cols_full, jg[:n_vb])
    assert not jg[n_vb:].any()
    assert (tb.bu, tb.bp) == (jb.bu, jb.bp)
    assert tb.n_vb == -(-tb.n_p2 // tb.bu) <= (jb.n_vb or tb.n_vb)


def test_bsr_values_match(built):
    _, _, _, jb, tb = built
    _close(tb.m_vals, TJ.on(tb.f, TJ.f_coo(jb, jb.m_blk), F64))
    _close(tb.f.values(tb.host.k_nz, F64),
           TJ.on(tb.f, TJ.f_coo(jb, jb.host_k_blk), F64))
    _close(tb.g_vals, TJ.on(tb.g, TJ.g_coo(jb), F64))
    _close(tb.b_vals, TJ.on(tb.b, TJ.b_coo(jb), F64))
    nc = tb.cell_p2.shape[0]
    for name in ("detj", "jinv"):
        _close(getattr(tb, name), _np(getattr(jb, name))[:nc])
    for name in ("curv_phi", "curv_dphys"):
        _close(getattr(tb, name), getattr(jb, name))
    np.testing.assert_array_equal(_np(tb.curv_ids), _np(jb.curv_ids))


def test_applies_match_jax(built):
    sp, _, _, jb, tb = built
    rng = np.random.default_rng(0)
    u = rng.standard_normal((sp.n_p2, 2))
    p = rng.standard_normal(sp.n_p1)
    f_np = _np(jb.m_blk) * 3.0 + 0.01 * rng.standard_normal(
        _np(jb.m_blk).shape) * (_np(jb.m_blk) != 0)
    jf, tf = jnp.asarray(f_np), TJ.on(tb.f, TJ.f_coo(jb, f_np), F64)
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
    c_t = TO.convection_matrices(tb, tb.t_hat, torch.as_tensor(u))
    c_j = _np(JO.convection_matrices(jb, jb.t_hat, jnp.asarray(u)))
    # JAX pads the cells to 128 rows with empty ones
    _close(c_t, c_j[:c_t.shape[0]])
    assert not c_j[c_t.shape[0]:].any()
    _close(TB.convection_blk(tb, torch.as_tensor(u)),
           TJ.on(tb.f, TJ.f_coo(jb, JB.convection_blk(jb, jnp.asarray(u))),
                 F64))


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
    _close(te.vals, TJ.on(te.mat, TJ.p1_coo(je), F64))
    _close(te.diag, je.diag)
    x = np.random.default_rng(2).standard_normal(space.n_p1)
    _close(TP.ell_matvec(te, torch.as_tensor(x)),
           JP.ell_matvec(je, jnp.asarray(x)))
    _close(TP.coarse_from_ell(te, 4), JP.coarse_from_ell(je, 4))


def test_block_jacobi_matches_jax(built):
    """The tile diagonals scattered from the compact F values equal JAX's
    gathered from its blocked F (JAX's extra tiles cover its padding
    rows)."""
    sp, _, _, jb, tb = built
    S = 256 // tb.bu
    jplan = JP.build_block_jacobi_plan(jb, S=S, layout="blocked")
    tplan = TP.build_block_jacobi_plan(tb.f, tb.bu, sp.n_p2, S, CPU)
    n_t = tplan.n_tiles
    assert n_t == -(-sp.n_p2 // (S * tb.bu)) <= jplan.n_tiles
    rng = np.random.default_rng(3)
    f0 = 400.0 * _np(jb.m_blk) + 1e-3 * _np(jb.host_k_blk)
    f1 = f0 + 0.05 * rng.standard_normal(f0.shape) * (f0 != 0)
    t0, t1 = (TJ.on(tb.f, TJ.f_coo(jb, f), F64) for f in (f0, f1))
    mask = (rng.uniform(size=sp.n_p2) > 0.1).astype(np.float64)
    jm, tm = jnp.asarray(mask), torch.as_tensor(mask)
    sigma = 7.5
    tiles_j = np.asarray(JP.block_jacobi_tiles(jplan, jnp.asarray(f1), jm,
                                               sigma))
    tiles_t = TP.block_jacobi_tiles(tplan, t1, tm, sigma)
    assert torch.equal(tiles_t, torch.from_numpy(np.array(tiles_j[:n_t])))
    jx0 = JP.block_jacobi_inverse(jplan, jnp.asarray(f0), jm, sigma)
    tx0 = TP.block_jacobi_inverse(tplan, t0, tm, sigma)
    _close(tx0, np.asarray(jx0)[:n_t], rtol=1e-4)  # fp32 LU of two libraries
    jinv = JP.block_jacobi_invert(jplan, jnp.asarray(f1), jm, sigma,
                                  x0=jx0, iters=3)
    tinv = TP.block_jacobi_invert(
        tplan, t1, tm, sigma, x0=torch.as_tensor(np.array(jx0)[:n_t]),
        iters=3)
    _close(tinv, np.asarray(jinv)[:n_t], rtol=1e-5)  # fp32 Newton-Schulz
    r = rng.standard_normal((sp.n_p2, 2))
    _close(TP.block_jacobi_apply(tplan, torch.as_tensor(
        np.array(jinv)[:n_t]), torch.as_tensor(r)),
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
    """convert.py carries the JAX operator values into the port's compact
    slots: the convection, G, B and the PCD pressure convection give the
    port's own products; an entry outside the pattern must be zero."""
    sp, _, _, jb, tb = built
    rng = np.random.default_rng(5)
    u = rng.standard_normal((sp.n_p2, 2))
    p = torch.as_tensor(rng.standard_normal(sp.n_p1))
    tu = torch.as_tensor(u)
    conv = TJ.on(tb.f, TJ.f_coo(jb, JB.convection_blk(jb, jnp.asarray(u))),
                 F64)
    _close(TB.apply_f(tb, conv, tu),
           TB.apply_f(tb, TB.convection_blk(tb, tu), tu))
    gb = dataclasses.replace(tb, g_vals=TJ.on(tb.g, TJ.g_coo(jb), F64),
                             b_vals=TJ.on(tb.b, TJ.b_coo(jb), F64))
    _close(TB.apply_bt(gb, p), TB.apply_bt(tb, p))
    _close(TB.apply_b(gb, tu), TB.apply_b(tb, tu))
    npc = TJ.on(tb.pp, TJ.pp_coo(
        jb, JB.pressure_convection_blk(jb, jnp.asarray(u))), F64)
    _close(npc, TB.pressure_convection_blk(tb, tu))
    _close(TB.apply_pp(tb, npc, p),
           TB.apply_pp(tb, TB.pressure_convection_blk(tb, tu), p))
    r, c, v = TJ.f_coo(jb, jb.m_blk)
    far = int(np.setdiff1d(np.arange(sp.n_p2), tb.f.nz_col[
        tb.f.nz_row == 0])[-1])
    with pytest.raises(ValueError, match="outside the compact pattern"):
        convert.sell_values_from_coo(tb.f, np.r_[r, 0], np.r_[c, far],
                                     np.r_[v, 1.0], F64)


def test_convert_ell_plan_and_state(space, ell_pair, built):
    """P1 values through convert.py keep the port's pattern; the coarse
    matrices agree; the block-Jacobi tiles of the same F values agree; the
    state crosses unchanged."""
    je, te = ell_pair
    ce = TJ.on(te.mat, TJ.p1_coo(je), F64)
    assert torch.equal(ce != 0, te.vals != 0)
    _close(TP.coarse_from_ell(te, 4), JP.coarse_from_ell(je, 4))
    _, _, _, jb, tb = built
    jplan = JP.build_block_jacobi_plan(jb, S=16, layout="blocked")
    tp = TP.build_block_jacobi_plan(tb.f, tb.bu, space.n_p2, 16, CPU)
    ones = np.ones(space.n_p2)
    _close(TP.block_jacobi_tiles(tp, tb.m_vals, torch.as_tensor(ones), 1.0),
           np.asarray(JP.block_jacobi_tiles(jplan, jb.m_blk,
                                            jnp.asarray(ones), 1.0)
                      )[:tp.n_tiles])
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
    """Every module of the port (the scenario registry and CLI among
    them), and chip_smoke.py with every module it imports, load without
    pulling in jax or any module of the JAX package (a fresh interpreter:
    this test process has both loaded)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import navierstokes_tpu_torch as pkg\n"
        "import navierstokes_tpu_torch.scenarios.cli\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "'navierstokes_tpu_torch.')]\n"
        "[importlib.import_module(m) for m in mods\n"
        " if m != 'navierstokes_tpu_torch.__main__']\n"
        "assert len(mods) >= 40, mods\n"
        "assert {'navierstokes_tpu_torch.scenarios.cli', "
        "'navierstokes_tpu_torch.scenarios.registry', "
        "'navierstokes_tpu_torch.mesh.airfoil', "
        "'navierstokes_tpu_torch.utils.analysis', "
        "'navierstokes_tpu_torch.fem.interpolation', "
        "'navierstokes_tpu_torch.models.stokes'} <= set(mods)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'navierstokes_tpu')]\n"
        "assert not bad, bad\n"
        "assert 'navierstokes_tpu_torch._host_compat' not in mods\n"
        "print('ok', len(mods))\n")
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root,
                         env={**os.environ, "PYTHONPATH": str(root)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
