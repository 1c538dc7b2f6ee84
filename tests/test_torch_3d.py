"""The port in 3D (P2/P1 tetrahedra) against the JAX package, in float64.

Fixture: the h=0.15 square-column duct (``duct_with_box_obstacle_3d``,
1,206 tets, 6,954 DoF), the 3D-1Z geometry of mesh/domain3D.geo.  The
mesh, the Hilbert permutation, the space numbering, the face data and
every integer table the port keeps are identical to JAX's; values,
operator applies (the D=3 F and mass products), convection and the
block-Jacobi tiles agree to 1e-12 relative to the largest entry; 3 steps
of projection (``bj`` and ``jacobi``) and monolithic ``cc`` give equal
iteration counts with u, p, Cd and Cl within 1e-9 (Cd and Cl relative to
the force coefficient's magnitude).  Also: a JAX 3D checkpoint restarts
the port; the circular-cylinder duct (h=0.12) snaps its P2 midside nodes
radially with z kept; the diagonal F preconditioner in 2D; the 3D VTU and
gmsh reader.  Random inputs come from a seeded numpy generator.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_jax_ops as TJ
from navierstokes_tpu.config import InletConfig as JInlet
from navierstokes_tpu.config import SolverConfig as JConfig
from navierstokes_tpu.fem import reference_elements as JR
from navierstokes_tpu.fem.spaces import TaylorHoodSpace as JSpace
from navierstokes_tpu.mesh import channel_with_cylinder_2d
from navierstokes_tpu.mesh import duct_with_box_obstacle_3d as jax_duct
from navierstokes_tpu.mesh import duct_with_cylinder_3d as jax_cyl
from navierstokes_tpu.mesh.geometry import hilbert_order as jax_hilbert
from navierstokes_tpu.models.navier_stokes import NavierStokes as JaxNS
from navierstokes_tpu.ops import assembly as JA
from navierstokes_tpu.ops import boundary as JBC
from navierstokes_tpu.ops import bsr as JB
from navierstokes_tpu.ops import forces as JF
from navierstokes_tpu.ops import operators as JO
from navierstokes_tpu.ops import p1ell as JP
from navierstokes_tpu_torch import convert
from navierstokes_tpu_torch.config import InletConfig, SolverConfig
from navierstokes_tpu_torch.fem import reference_elements as TR
from navierstokes_tpu_torch.fem.spaces import TaylorHoodSpace as TSpace
from navierstokes_tpu_torch.mesh import duct_with_box_obstacle_3d as t_duct
from navierstokes_tpu_torch.mesh import duct_with_cylinder_3d as t_cyl
from navierstokes_tpu_torch.mesh.geometry import hilbert_order as t_hilbert
from navierstokes_tpu_torch.models.navier_stokes import NavierStokes as TNS
from navierstokes_tpu_torch.ops import assembly as TA
from navierstokes_tpu_torch.ops import boundary as TBC
from navierstokes_tpu_torch.ops import bsr as TB
from navierstokes_tpu_torch.ops import forces as TF
from navierstokes_tpu_torch.ops import operators as TO
from navierstokes_tpu_torch.ops import p1ell as TP

torch.set_num_threads(2)
F64 = torch.float64
CPU = torch.device("cpu")
MESH_ARRAYS = ("points", "cells", "boundary_faces", "boundary_tags")
FACE_FIELDS = ("normals", "jxw", "qp_phys", "phi_v", "dphi_v_ref", "phi_p")
# parity limits of the 3-step runs: u, p, and Cd/Cl over max(|Cd|, |Cl|)
STEP_TOL = 1e-9


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(a, b, rtol=1e-12):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(np.abs(b).max(), 1e-300)
    np.testing.assert_allclose(a, b, rtol=0, atol=rtol * scale)


def _rel(a, b):
    a, b = _np(a), _np(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _spaces(jmesh, tmesh):
    jmesh.reorder_spatial()
    tmesh.reorder_spatial()
    js, ts = JSpace(jmesh), TSpace(tmesh)
    if jmesh.snap_projectors:
        assert js.snap_boundaries(jmesh.snap_projectors) == \
            ts.snap_boundaries(tmesh.snap_projectors)
    return js, ts


@pytest.fixture(scope="module")
def pair():
    """(JAX space, port space) of the h=0.15 duct, each from its own
    package's generator."""
    return _spaces(jax_duct(h=0.15), t_duct(h=0.15))


@pytest.fixture(scope="module")
def built(pair):
    js, ts = pair
    jcells, tcells = JA.cell_arrays_numpy(js), TA.cell_arrays_numpy(ts)
    return (ts, jcells, tcells, JB.build_bsr(js, jcells, dtype=jnp.float64),
            TB.build_bsr(ts, tcells, F64, CPU))


def test_reference_tetrahedron_matches_jax():
    assert TR.EDGES_3D == JR.EDGES_3D and TR.FACETS_3D == JR.FACETS_3D
    j, t = JR.ReferenceSimplex(3), TR.ReferenceSimplex(3)
    assert (t.n_v, t.n_p, t.n_q) == (j.n_v, j.n_p, j.n_q) == (10, 4, 27)
    for name in ("qp", "qw", "phi_v", "dphi_v", "phi_p", "M_hat", "K_hat",
                 "G_hat", "T_hat", "Tp_hat", "Mlump_hat", "fqp", "fqw",
                 "facet_phi_v", "facet_dphi_v", "facet_phi_p"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))


def test_mesh_hilbert_and_space_identical():
    jm, tm = jax_duct(h=0.15), t_duct(h=0.15)
    assert (tm.n_cells, tm.n_points) == (1206, 360)
    for name in MESH_ARRAYS:
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name))
    np.testing.assert_array_equal(t_hilbert(tm.points),
                                  jax_hilbert(jm.points))
    js, ts = _spaces(jm, tm)
    for name in MESH_ARRAYS:
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name))
    assert ts.n_dofs == js.n_dofs == 6954
    np.testing.assert_array_equal(t_hilbert(ts.p2_coords),
                                  jax_hilbert(ts.p2_coords))
    for name in ("cell_p2", "cell_p1", "p2_coords", "_vertex_node",
                 "_edge_node_block", "_edge_verts", "_bf_cells",
                 "_bf_locals"):
        np.testing.assert_array_equal(getattr(ts, name), getattr(js, name))
    assert set(tm.boundary_tags.tolist()) == {0, 1, 2, 3, 4}
    for tag in range(5):
        np.testing.assert_array_equal(ts.p2_nodes_on_tag(tag),
                                      js.p2_nodes_on_tag(tag))
        jf, tf = js.face_data(tag), ts.face_data(tag)
        np.testing.assert_array_equal(tf.cells, jf.cells)
        np.testing.assert_array_equal(tf.local_facets, jf.local_facets)
        for name in FACE_FIELDS:
            _close(getattr(tf, name), getattr(jf, name))
    # the y and z walls: four 2.5 x 0.41 sides less the column's footprints
    np.testing.assert_allclose(
        sum(ts.face_data(t).jxw.sum() for t in (0, 2)),
        4 * 2.5 * 0.41 - 2 * 0.1 * 0.1, rtol=1e-12)


def test_dirichlet_data_match_jax(pair):
    """Biparabolic inlet on tag 3, the same profile on the y and z walls
    (tags 0 and 2), zero on the column (tag 4)."""
    js, ts = pair
    inlet = dict(kind="biparabolic", u_m=0.45, height=0.41)
    jb = JBC.build_dirichlet(js, JInlet(**inlet), jnp.float64)
    tb = TBC.build_dirichlet(ts, InletConfig(**inlet), F64, CPU)
    np.testing.assert_array_equal(tb.host_mask, jb.host_mask)
    _close(tb.base_values, jb.base_values)
    assert 0.0 < float(tb.base_values[:, 0].max()) <= 0.45
    assert not tb.base_values[:, 1:].any()


def test_cell_arrays_tables_and_values_match(built):
    ts, jc, tc, jb, tb = built
    for name in ("detj", "jinv", "mass", "stiff", "grad"):
        _close(getattr(tc, name), getattr(jc, name))
    np.testing.assert_array_equal(_np(tb.cell_p2),
                                  _np(jb.cell_p2)[:tb.cell_p2.shape[0]])
    jg = np.asarray(jb.host_g_cols)
    n_vb = tb.host.g_cols_full.shape[0]
    np.testing.assert_array_equal(tb.host.g_cols_full, jg[:n_vb])
    assert not jg[n_vb:].any()
    assert tb.g.n_rows == 3 * ts.n_p2 and tb.b.n_cols == 3 * ts.n_p2
    _close(tb.m_vals, TJ.on(tb.f, TJ.f_coo(jb, jb.m_blk), F64))
    _close(tb.f.values(tb.host.k_nz, F64),
           TJ.on(tb.f, TJ.f_coo(jb, jb.host_k_blk), F64))
    _close(tb.g_vals, TJ.on(tb.g, TJ.g_coo(jb), F64))
    _close(tb.b_vals, TJ.on(tb.b, TJ.b_coo(jb), F64))


def test_d3_applies_and_convection_match_jax(built):
    ts, _, _, jb, tb = built
    rng = np.random.default_rng(0)
    u = rng.standard_normal((ts.n_p2, 3))
    p = rng.standard_normal(ts.n_p1)
    m = _np(jb.m_blk)
    f_np = 3.0 * m + 0.01 * rng.standard_normal(m.shape) * (m != 0)
    jf, tf = jnp.asarray(f_np), TJ.on(tb.f, TJ.f_coo(jb, f_np), F64)
    tu, tp, ju, jp = (torch.as_tensor(u), torch.as_tensor(p),
                      jnp.asarray(u), jnp.asarray(p))
    _close(TB.apply_f(tb, tf, tu), JB.apply_f(jb, jf, ju))
    _close(TB.mass_apply(tb, tu), JB.mass_apply(jb, ju))
    _close(TB.apply_bt(tb, tp), JB.apply_bt(jb, jp))
    _close(TB.apply_b(tb, tu), JB.apply_b(jb, ju))
    _close(TB.f_diag(tb, tf), JB.f_diag(jb, jf))
    w = rng.uniform(0.5, 2.0, ts.n_p2)
    _close(TB.schur_diag(tb, torch.as_tensor(w)),
           JB.schur_diag(jb, jnp.asarray(w)))
    c_t = TO.convection_matrices(tb, tb.t_hat, tu)
    c_j = _np(JO.convection_matrices(jb, jb.t_hat, ju))
    _close(c_t, c_j[:c_t.shape[0]])
    _close(TB.convection_blk(tb, tu),
           TJ.on(tb.f, TJ.f_coo(jb, JB.convection_blk(jb, ju)), F64))
    _close(TB.pressure_convection_blk(tb, tu),
           TJ.on(tb.pp, TJ.pp_coo(jb, JB.pressure_convection_blk(jb, ju)),
                 F64))


def test_p1_operators_match_jax(pair):
    js, ts = pair
    jc, tc = JA.cell_arrays_numpy(js), TA.cell_arrays_numpy(ts)
    out = np.arange(0, ts.n_p1, 5)
    je = JP.assemble_p1_stiffness(js, jc, jnp.float64, dirichlet_nodes=out)
    te = TP.assemble_p1_stiffness(ts, tc, F64, CPU, dirichlet_nodes=out)
    _close(te.vals, TJ.on(te.mat, TJ.p1_coo(je), F64))
    _close(te.diag, je.diag)
    w = np.random.default_rng(1).uniform(0.5, 2.0, ts.n_p2)
    ja = JP.assemble_ap(js, jc, w, jnp.float64)
    ta = TP.assemble_ap(ts, tc, w, F64, CPU)
    _close(ta.vals, TJ.on(ta.mat, TJ.p1_coo(ja), F64))
    x = np.random.default_rng(2).standard_normal(ts.n_p1)
    for j, t in ((je, te), (ja, ta)):
        _close(TP.ell_matvec(t, torch.as_tensor(x)),
               JP.ell_matvec(j, jnp.asarray(x)))
        _close(TP.coarse_from_ell(t, 4), JP.coarse_from_ell(j, 4))


def test_block_jacobi_on_3d_velocity_matches_jax(built):
    ts, _, _, jb, tb = built
    S = 256 // tb.bu
    jplan = JP.build_block_jacobi_plan(jb, S=S, layout="blocked")
    tplan = TP.build_block_jacobi_plan(tb.f, tb.bu, ts.n_p2, S, CPU)
    n_t = tplan.n_tiles
    rng = np.random.default_rng(3)
    f0 = 400.0 * _np(jb.m_blk) + 1e-3 * _np(jb.host_k_blk)
    tf = TJ.on(tb.f, TJ.f_coo(jb, f0), F64)
    mask = (rng.uniform(size=ts.n_p2) > 0.1).astype(np.float64)
    jt = np.asarray(JP.block_jacobi_tiles(jplan, jnp.asarray(f0),
                                          jnp.asarray(mask), 7.5))
    tt = TP.block_jacobi_tiles(tplan, tf, torch.as_tensor(mask), 7.5)
    assert torch.equal(tt, torch.from_numpy(np.array(jt[:n_t])))
    jinv = JP.block_jacobi_inverse(jplan, jnp.asarray(f0),
                                   jnp.asarray(mask), 7.5)
    r = rng.standard_normal((ts.n_p2, 3))
    _close(TP.block_jacobi_apply(tplan, torch.as_tensor(
        np.array(jinv)[:n_t]), torch.as_tensor(r)),
           JP.block_jacobi_apply(jplan, jinv, jnp.asarray(r)))


@pytest.mark.parametrize("formula", ["reference", "st"])
def test_3d_forces_match_jax(pair, formula):
    js, ts = pair
    jfa = JA.build_face_arrays(js, 4, jnp.float64)
    tfa = TA.build_face_arrays(ts, 4, F64, CPU)
    rng = np.random.default_rng(4)
    u = rng.standard_normal((ts.n_p2, 3))
    p = rng.standard_normal(ts.n_p1)
    jd, jl = JF.drag_lift(jfa, jnp.asarray(u), jnp.asarray(p), 1e-3,
                          formula=formula)
    td, tl = TF.drag_lift(tfa, torch.as_tensor(u), torch.as_tensor(p), 1e-3,
                          formula=formula)
    _close(td, jd)
    _close(tl, jl)
    jc = JF.force_coefficients(jd, jl, 0.2, 0.1, 3, 0.41)
    tc = TF.force_coefficients(td, tl, 0.2, 0.1, 3, 0.41)
    _close(tc[0], jc[0])
    _close(tc[1], jc[1])


def _make(cls, tmp, mesh, scheme, f_precond, T=0.03, step=3, **dev):
    cfg = (JConfig if cls is JaxNS else SolverConfig)(
        dtype="float64", scheme=scheme, f_precond=f_precond, ref_length=0.1,
        force_formula="st", output_dir=os.path.join(tmp, "out"),
        cache_dir=os.path.join(tmp, "cache"),
        csv_path=os.path.join(tmp, "forces.csv"))
    inlet = (JInlet if cls is JaxNS else InletConfig)(
        kind="biparabolic" if mesh.dim == 3 else "parabolic",
        u_m=0.45 if mesh.dim == 3 else 0.3, height=0.41)
    ns = cls(mesh, 2, 1, deltat=0.01, T=T, step=step, inlet=inlet,
             config=cfg, **dev)
    ns.set_re_number(20)
    return ns.setup()


def _assert_steps_match(jns, tns, n=3):
    for _ in range(n):
        jm = jns.solve_time_step()
        tm = tns.solve_time_step()
        assert tm.iterations == int(jm.iterations)
        assert tm.converged
        assert _rel(tns._u, jns._u) < STEP_TOL
        assert _rel(tns._p, jns._p) < STEP_TOL
        scale = max(abs(float(jm.cd)), abs(float(jm.cl)))
        assert abs(tm.cd - float(jm.cd)) <= STEP_TOL * scale
        assert abs(tm.cl - float(jm.cl)) <= STEP_TOL * scale
        assert tns.time == pytest.approx(jns.time, abs=1e-15)


@pytest.mark.parametrize("scheme,f_precond", [
    ("projection", "bj"), ("projection", "jacobi"), ("monolithic", "bj")])
def test_3d_steps_match_jax(tmp_path, scheme, f_precond):
    """3 float64 steps of the 3D-1Z fixture (monolithic: Cahouet-Chabard,
    the default block preconditioner)."""
    jns = _make(JaxNS, str(tmp_path / "j"), jax_duct(h=0.15), scheme,
                f_precond)
    tns = _make(TNS, str(tmp_path / "t"), t_duct(h=0.15), scheme, f_precond,
                device="cpu")
    _assert_steps_match(jns, tns)
    assert tns._u.shape == (tns.space.n_p2, 3)
    # the CFL cell size is the equilateral-equivalent (6 vol)^(1/3)
    vol = np.abs(tns.mesh.cell_volumes())
    np.testing.assert_allclose(_np(tns._cfl_dt_over_h),
                               0.01 / (6.0 * vol) ** (1.0 / 3.0), rtol=1e-12)
    assert tns.measured_cfl() == pytest.approx(jns.measured_cfl(), rel=1e-9)


def _fp32_duct_run(tmp, refine, mass_format):
    cfg = SolverConfig(dtype="float32", scheme="monolithic", refine=refine,
                       mass_format=mass_format, ref_length=0.1,
                       force_formula="st", output_dir=os.path.join(tmp, "out"),
                       cache_dir=os.path.join(tmp, "cache"),
                       csv_path=os.path.join(tmp, "forces.csv"))
    ns = TNS(t_duct(h=0.15), 2, 1, deltat=0.01, T=0.02, step=2,
             inlet=InletConfig(kind="biparabolic", u_m=0.45, height=0.41),
             config=cfg, device="cpu")
    ns.set_re_number(20)
    ns.setup()
    ms = [ns.solve_time_step() for _ in range(2)]
    return ns, ms


def test_3d_refinement_follows_the_jax_mass_rule(tmp_path):
    """The JAX model refines only where it keeps a blocked mass
    (models/navier_stokes.py:1139-1141): in 3D under mass_format="auto"
    (its node mass) a refine=2 fp32 run is the refine=0 run bit for bit;
    under "blocked" it refines (its float64 residual moves the result)."""
    base, mb = _fp32_duct_run(str(tmp_path / "r0"), 0, "auto")
    auto, ma = _fp32_duct_run(str(tmp_path / "auto"), 2, "auto")
    blk, mk = _fp32_duct_run(str(tmp_path / "blk"), 2, "blocked")
    assert auto._ell64 is None and blk._ell64 is not None
    assert torch.equal(auto._u, base._u) and torch.equal(auto._p, base._p)
    assert [m.iterations for m in ma] == [m.iterations for m in mb]
    assert [m.residual for m in ma] == [m.residual for m in mb]
    assert not torch.equal(blk._u, base._u)
    assert all(m.residual < b.residual for m, b in zip(mk, mb))


def test_2d_jacobi_projection_matches_jax(tmp_path):
    """The diagonal F preconditioner on the 2D cylinder channel of
    tests/test_torch_model.py: no tile plan, time_prec_init 0."""
    mesh = channel_with_cylinder_2d(h=0.1, h_near=0.04)
    jns = _make(JaxNS, str(tmp_path / "j"), mesh, "projection", "jacobi")
    tns = _make(TNS, str(tmp_path / "t"), mesh, "projection", "jacobi",
                device="cpu")
    assert tns._bj_plan is None
    _assert_steps_match(jns, tns)
    assert tns.solve_time_step().prec_seconds == 0.0


def test_jax_3d_checkpoint_restarts_port(tmp_path):
    """JAX writes the 3D state-ns-2; the port restarts from it for one
    step and lands on JAX's step 3; the same state in memory
    (convert.state_from_jax_numpy, u of shape (n_p2, 3)) gives the same
    step."""
    d = str(tmp_path / "j")
    jns = _make(JaxNS, d, jax_duct(h=0.15), "projection", "bj", T=0.02,
                step=2)
    jns.solve()
    jm = jns.solve_time_step()
    tns = _make(TNS, d, t_duct(h=0.15), "projection", "bj", T=0.02, step=2,
                device="cpu")
    tns.import_data(2)
    tm = tns.solve_time_step()
    assert tm.iterations == int(jm.iterations)
    assert _rel(tns._u, jns._u) < STEP_TOL
    assert _rel(tns._p, jns._p) < STEP_TOL
    u3 = tns._u.clone()
    with np.load(os.path.join(d, "cache", "state-ns-2.npz")) as z:
        assert z["u"].shape == (tns.space.n_p2, 3)
        st = convert.state_from_jax_numpy(z["u"], z["p"], z["u_prev"],
                                          z["phi"], float(z["time"]), CPU,
                                          F64)
    assert st.u.shape == (tns.space.n_p2, 3)
    tns.load_state(st)
    tns.solve_time_step()
    assert torch.equal(tns._u, u3)


def test_cylinder_duct_snaps_with_z_kept():
    """duct_with_cylinder_3d: the tag-4 midside nodes move radially onto
    the r=0.05 cylinder and keep their z; the curved cells' data, face
    data and element matrices equal JAX's."""
    jm, tm = jax_cyl(h=0.12), t_cyl(h=0.12)
    for name in MESH_ARRAYS:
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name))
    js, ts = _spaces(jm, tm)
    before = TSpace(tm).p2_coords
    np.testing.assert_array_equal(ts.p2_coords, js.p2_coords)
    moved = np.flatnonzero(np.any(before != ts.p2_coords, axis=1))
    assert len(moved) > 0
    np.testing.assert_array_equal(ts.p2_coords[moved, 2], before[moved, 2])
    r = np.hypot(ts.p2_coords[moved, 0] - 0.45, ts.p2_coords[moved, 1] - 0.2)
    np.testing.assert_allclose(r, 0.05, rtol=1e-12)
    jcd, tcd = js.curved_data(), ts.curved_data()
    np.testing.assert_array_equal(tcd.ids, jcd.ids)
    _close(tcd.detj_q, jcd.detj_q)
    _close(tcd.jinv_q, jcd.jinv_q)
    jf, tf = js.face_data(4), ts.face_data(4)
    assert tf.jinv_q is not None
    for name in FACE_FIELDS + ("jinv_q",):
        _close(getattr(tf, name), getattr(jf, name))
    jc, tc = JA.cell_arrays_numpy(js), TA.cell_arrays_numpy(ts)
    for name in ("mass", "stiff", "grad"):
        _close(getattr(tc, name), getattr(jc, name))


def test_3d_vtu_and_msh_reader_match_jax(pair, tmp_path):
    """The 3D VTU (quadratic tets, VTK edge order) equals the JAX
    package's byte for byte; the gmsh reader takes tetrahedra."""
    from navierstokes_tpu.mesh.msh_io import read_msh as jax_read
    from navierstokes_tpu.mesh.msh_io import write_msh
    from navierstokes_tpu.utils.vtu import write_vtu_pvtu as jax_vtu
    from navierstokes_tpu_torch.mesh.msh_io import read_msh
    from navierstokes_tpu_torch.utils.vtu import write_vtu_pvtu
    js, ts = pair
    rng = np.random.default_rng(6)
    u = rng.standard_normal((ts.n_p2, 3))
    p = ts.pressure_at_p2_nodes(rng.standard_normal(ts.n_p1))
    part = np.zeros(ts.mesh.n_cells)
    args = ("o", 7, ts.p2_coords, np.asarray(ts.cell_p2), u, p, part)
    jax_vtu(str(tmp_path / "j"), *args)
    write_vtu_pvtu(str(tmp_path / "t"), *args)
    for name in ("o_000007.vtu", "o_000007.pvtu"):
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes()
    path = str(tmp_path / "duct.msh")
    write_msh(jax_duct(h=0.15), path)
    jm, tm = jax_read(path), read_msh(path)
    assert tm.dim == 3 and tm.cells.shape == (1206, 4)
    for name in MESH_ARRAYS:
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name))
