"""The port's degree-generic element path and StokesSolver against the JAX
package's, in float64 on the CPU:

* the lattice Lagrange basis (multi-indices, shape values and gradients,
  node coordinates) for (dim, k) in {2, 3} x {1, 2, 3} and (2, 4), and
  the reference tables of the P2/P1 and P3/P2 pairs, to 1e-12;
* the generic numbering (k = 3 in 2D and 3D, with and without the
  Hilbert order), and at k = 2 the P2 fast path's layout;
* ``build_cell_arrays`` and the element operator (``apply_blocks``,
  ``f_diag``, ``schur_diag``, ``mass_apply``, ``lumped_mass``) to 1e-12;
* ``StokesSolver`` on the manufactured solution of tests/test_degrees.py:
  P2/P1 at n = 4, 8 and P3/P2 at n = 4 equal JAX's (u, p within 1e-9
  relative, equal FGMRES counts, equal L2 errors), and the convergence
  rates of tests/test_convergence.py and tests/test_degrees.py.

The P3/P2 parity solve stops at 1e-11: at JAX's 1e-12 both packages end
within a few percent of the target after 28 iterations, where the last
bits of the inner BiCGStab sums decide whether a 29th is needed (JAX
stops at 28, the port at 29; u and p still agree to 2e-10).  The rate
checks keep 1e-12.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from navierstokes_tpu.config import SolverConfig as JCfg
from navierstokes_tpu.fem import interpolation as JI
from navierstokes_tpu.fem import reference_elements as JR
from navierstokes_tpu.fem import spaces as JSp
from navierstokes_tpu.mesh import generators as JG
from navierstokes_tpu.models.stokes import StokesSolver as JStokes
from navierstokes_tpu.ops import assembly as JAs
from navierstokes_tpu.ops import operators as JO
from navierstokes_tpu_torch.config import SolverConfig as TCfg
from navierstokes_tpu_torch.fem import interpolation as TI
from navierstokes_tpu_torch.fem import reference_elements as TR
from navierstokes_tpu_torch.fem import spaces as TSp
from navierstokes_tpu_torch.mesh import generators as TG
from navierstokes_tpu_torch.models.stokes import StokesSolver as TStokes
from navierstokes_tpu_torch.ops import assembly as TAs
from navierstokes_tpu_torch.ops import operators as TO

torch.set_num_threads(2)
F64 = torch.float64
TOL = 1e-12
NU = 1.0
DEGREES = [(2, 1), (2, 2), (2, 3), (2, 4), (3, 1), (3, 2), (3, 3)]


def _close(a, b, tol=TOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=tol * max(np.abs(b).max(), 1.0))


@pytest.mark.parametrize("dim,k", DEGREES)
def test_lattice_basis_equals_jax(dim, k):
    np.testing.assert_array_equal(TR.lattice_multi_indices(dim, k),
                                  JR.lattice_multi_indices(dim, k))
    assert TR.n_basis(dim, k) == JR.n_basis(dim, k)
    nodes = TR.node_ref_coords(dim, k)
    _close(nodes, JR.node_ref_coords(dim, k))
    pts = np.random.default_rng(dim * 10 + k).random((12, dim)) / dim
    _close(TR.shape_values(dim, k, pts), JR.shape_values(dim, k, pts))
    _close(TR.shape_grads(dim, k, pts), JR.shape_grads(dim, k, pts))
    # nodal on its own lattice
    _close(TR.shape_values(dim, k, nodes), np.eye(TR.n_basis(dim, k)))


@pytest.mark.parametrize("dim,kv,kp", [(2, 2, 1), (2, 3, 2), (3, 2, 1),
                                       (3, 3, 2), (2, 4, 3)])
def test_reference_tables_equal_jax(dim, kv, kp):
    t, j = TR.ReferenceSimplex(dim, kv, kp), JR.ReferenceSimplex(dim, kv, kp)
    for name in ("qp", "qw", "phi_v", "dphi_v", "phi_p", "M_hat", "K_hat",
                 "G_hat", "T_hat", "Mlump_hat", "facet_phi_v",
                 "facet_dphi_v", "facet_phi_p", "p2_nodes", "p_nodes"):
        _close(getattr(t, name), getattr(j, name))


def test_3d_degree_past_cubic_raises():
    with pytest.raises(NotImplementedError, match="3D velocity degree"):
        TR.ReferenceSimplex(3, 4, 3)


def _meshes(dim):
    if dim == 2:
        return TG.rectangle_2d(1.0, 0.7, 4, 3), JG.rectangle_2d(1.0, 0.7, 4, 3)
    return TG.box_3d(1.0, 0.7, 0.5, n=3), JG.box_3d(1.0, 0.7, 0.5, n=3)


@pytest.mark.parametrize("rcm", [True, False], ids=["hilbert", "plain"])
@pytest.mark.parametrize("dim,kv,kp", [(2, 3, 2), (3, 3, 2), (2, 4, 3)])
def test_generic_space_equals_jax(dim, kv, kp, rcm):
    tm, jm = _meshes(dim)
    t = TSp.TaylorHoodSpace(tm, kv, kp, rcm=rcm)
    j = JSp.TaylorHoodSpace(jm, kv, kp, rcm=rcm)
    assert (t.n_p2, t.n_p1) == (j.n_p2, j.n_p1)
    np.testing.assert_array_equal(t.cell_p2, j.cell_p2)
    np.testing.assert_array_equal(t.cell_p1, j.cell_p1)
    np.testing.assert_array_equal(t.p2_coords, j.p2_coords)
    for tag in np.unique(tm.boundary_tags):
        np.testing.assert_array_equal(t.p2_nodes_on_tag(tag),
                                      j.p2_nodes_on_tag(tag))
    p = np.random.default_rng(3).standard_normal(t.n_p1)
    _close(t.pressure_at_p2_nodes(p), j.pressure_at_p2_nodes(p))


@pytest.mark.parametrize("dim,k", [(2, 2), (2, 3), (3, 3)])
def test_lagrange_numbering_equals_jax(dim, k):
    """The numbering function itself; at k = 2 it reproduces the P2 fast
    path's layout (tests/test_degrees.py for JAX)."""
    tm, jm = _meshes(dim)
    sp = TSp.TaylorHoodSpace(tm, 2, 1, rcm=False)
    cell_edges = (np.asarray(sp.cell_p2)[:, dim + 1:].astype(np.int64)
                  - tm.n_points)
    args = (k, tm.cells.astype(np.int64), cell_edges, sp._edge_verts)
    t = TSp._lagrange_numbering(tm, *args)
    j = JSp._lagrange_numbering(jm, *args)
    for a, b in zip(t, j):
        if a is None or b is None:
            assert a is None and b is None
        else:
            np.testing.assert_array_equal(a, b)
    if k == 2:
        assert t[0] == sp.n_p2
        np.testing.assert_array_equal(t[1], sp.cell_p2)
        np.testing.assert_allclose(t[2], sp.p2_coords, rtol=0, atol=1e-15)


@pytest.fixture(scope="module", params=[(2, 2, 1), (2, 3, 2), (3, 2, 1)],
                ids=["2d-p2p1", "2d-p3p2", "3d-p2p1"])
def spaces(request):
    dim, kv, kp = request.param
    tm, jm = _meshes(dim)
    return (TSp.TaylorHoodSpace(tm, kv, kp), JSp.TaylorHoodSpace(jm, kv, kp))


def test_cell_arrays_equal_jax(spaces):
    ts, js = spaces
    t = TAs.build_cell_arrays(ts, F64, "cpu")
    j = JAs.build_cell_arrays(js, dtype=jnp.float64)
    for name in ("cell_p2", "cell_p1", "detj", "jinv", "mass", "stiff",
                 "grad"):
        _close(getattr(t, name).numpy(), np.asarray(getattr(j, name)))
    assert t.cell_p2.dtype == torch.int64 and t.cell_p1.dtype == torch.int64
    assert t.detj.dtype == F64 and t.grad.dtype == F64


def test_element_operator_equals_jax(spaces):
    ts, js = spaces
    t = TAs.build_cell_arrays(ts, F64, "cpu")
    j = JAs.build_cell_arrays(js, dtype=jnp.float64)
    tv = TO.segment_plan(ts.cell_p2, ts.n_p2, "cpu")
    tp = TO.segment_plan(ts.cell_p1, ts.n_p1, "cpu")
    jv = JO.build_scatter(js.cell_p2, js.n_p2)
    jp = JO.build_scatter(js.cell_p1, js.n_p1)
    rng = np.random.default_rng(7)
    dim = ts.dim
    xu = rng.standard_normal((ts.n_p2, dim))
    xp = rng.standard_normal(ts.n_p1)
    f_np = (3.0 * np.asarray(j.mass) + 0.1 * np.asarray(j.stiff)
            + 0.01 * rng.standard_normal(np.asarray(j.mass).shape))
    ft, fj = torch.as_tensor(f_np), jnp.asarray(f_np)
    T = lambda a: torch.as_tensor(a)
    for which in (dict(), dict(with_g=False, with_gt=False),
                  dict(with_f=False, with_gt=False),
                  dict(with_f=False, with_g=False)):
        yt = TO.apply_blocks(t, ft, tv, tp, T(xu), T(xp), **which)
        yj = JO.apply_blocks(j, fj, jv, jp, jnp.asarray(xu), jnp.asarray(xp),
                             **which)
        _close(yt[0].numpy(), np.asarray(yj[0]))
        _close(yt[1].numpy(), np.asarray(yj[1]))
    _close(TO.f_diag(t, ft, tv).numpy(), np.asarray(JO.f_diag(j, fj, jv)))
    w = rng.uniform(0.5, 2.0, ts.n_p2)
    _close(TO.schur_diag(t, T(w), tp).numpy(),
           np.asarray(JO.schur_diag(j, jnp.asarray(w), jp)))
    _close(TO.mass_apply(t, tv, T(xu)).numpy(),
           np.asarray(JO.mass_apply(j, jv, jnp.asarray(xu))))
    mh = ts.rs.Mlump_hat
    _close(TO.lumped_mass(t, T(mh), tv).numpy(),
           np.asarray(JO.lumped_mass(j, jnp.asarray(mh), jv)))


def _u_exact(x):
    out = np.empty_like(x)
    out[:, 0] = np.sin(np.pi * x[:, 0]) * np.cos(np.pi * x[:, 1])
    out[:, 1] = -np.cos(np.pi * x[:, 0]) * np.sin(np.pi * x[:, 1])
    return out


def _p_exact(x):
    return np.cos(np.pi * x[:, 0]) * np.cos(np.pi * x[:, 1])


def _forcing(x, t=0.0):
    # f = -nu lap(u) + grad(p)
    f = 2.0 * NU * np.pi ** 2 * _u_exact(x)
    f[:, 0] += -np.pi * np.sin(np.pi * x[:, 0]) * np.cos(np.pi * x[:, 1])
    f[:, 1] += -np.pi * np.cos(np.pi * x[:, 0]) * np.sin(np.pi * x[:, 1])
    return f


def _solve(pkg, n, kv, kp, tol):
    """(u, p, FGMRES result, L2 errors) of the manufactured Stokes problem
    on the n x n unit square."""
    if pkg == "jax":
        solver = JStokes(JG.rectangle_2d(1.0, 1.0, n, n), nu=NU,
                         config=JCfg(dtype="float64"), degree_velocity=kv,
                         degree_pressure=kp)
        rhs, interp = JAs.forcing_rhs, JI
    else:
        solver = TStokes(TG.rectangle_2d(1.0, 1.0, n, n), nu=NU,
                         config=TCfg(dtype="float64"), degree_velocity=kv,
                         degree_pressure=kp, device="cpu")
        rhs, interp = TAs.forcing_rhs, TI
    sp = solver.space
    nodes = np.unique(np.concatenate([sp.p2_nodes_on_tag(t)
                                      for t in (0, 1, 2, 3)]))
    u, p, res = solver.solve(nodes, _u_exact(sp.p2_coords[nodes]),
                             rhs_u=rhs(sp, _forcing), tol=tol, maxiter=800)
    assert bool(res.converged), (pkg, n, kv, kp)
    errs = (interp.l2_error_velocity(sp, u, _u_exact),
            interp.l2_error_pressure(sp, p, _p_exact))
    return u, p, res, errs


@pytest.mark.parametrize("n,kv,kp,tol", [(4, 2, 1, 1e-12), (8, 2, 1, 1e-12),
                                         (4, 3, 2, 1e-11)])
def test_stokes_solver_equals_jax(n, kv, kp, tol):
    ut, pt, rt, et = _solve("torch", n, kv, kp, tol)
    uj, pj, rj, ej = _solve("jax", n, kv, kp, tol)
    assert rt.iterations == int(rj.iterations)
    for a, b in ((ut, uj), (pt, pj)):
        assert np.abs(a - b).max() <= 1e-9 * np.abs(b).max()
    np.testing.assert_allclose(et, ej, rtol=1e-9)


@pytest.mark.parametrize("kv,kp,ns,rate_u,rate_p", [
    (2, 1, (4, 8, 16), 2.5, 1.5), (3, 2, (4, 8), 3.5, 2.5)],
    ids=["p2p1", "p3p2"])
def test_manufactured_solution_rates(kv, kp, ns, rate_u, rate_p):
    """O(h^(kv+1)) velocity and O(h^(kp+1)) pressure in L2, with the
    slack of tests/test_convergence.py and tests/test_degrees.py."""
    errs = [_solve("torch", n, kv, kp, 1e-12)[3] for n in ns]
    for (eu0, ep0), (eu1, ep1) in zip(errs, errs[1:]):
        assert np.log2(eu0 / eu1) > rate_u, errs
        assert np.log2(ep0 / ep1) > rate_p, errs
