"""The monolithic scheme's solvers and operators against the JAX package,
float64:

* GMRES / FGMRES on the tests/test_krylov.py fixtures (nonsymmetric,
  restarts with x0, a preconditioned tuple system, the saddle point with
  aSIMPLE and both InnerSolve methods): equal iteration counts, x to
  1e-10;
* every block preconditioner's vmult on the step-1 operators of the
  cylinder-channel fixture (h=0.1, h_near=0.04) applied to a seeded
  (ru, rp): 1e-10 relative.  Both take JAX's exact fp32 block-Jacobi tile
  inverses: the two libraries' fp32 LU differ in the last bits (held to
  1e-4 in tests/test_torch_ops.py), which the 1e-2 inner solves pass on
  to the vmult at 4e-9;
* the Schur coarse assembly (pair-plan order and lengths identical up to
  JAX's padding blocks, coarse_matrix 1e-12, its fp32 inverse 1e-6),
  schur_diag, G's block sums, the PCD pressure convection and apply_pp
  (1e-12, JAX's values carried into the port's compact slots), assemble_ap
  (1e-12), and the whole-row G/B tables the monolithic scheme builds.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_jax_ops as TJ
from navierstokes_tpu.config import InletConfig, SolverConfig
from navierstokes_tpu.mesh import channel_with_cylinder_2d
from navierstokes_tpu.models.navier_stokes import NavierStokes as JaxNS
from navierstokes_tpu.ops import bsr as JB
from navierstokes_tpu.ops import p1ell as JP
from navierstokes_tpu.solvers import krylov as JK
from navierstokes_tpu.solvers import preconditioners as JPC
from navierstokes_tpu.solvers import schur as JS
from navierstokes_tpu_torch.models.navier_stokes import NavierStokes as TNS
from navierstokes_tpu_torch.ops import bsr as TB
from navierstokes_tpu_torch.ops import p1ell as TP
from navierstokes_tpu_torch.solvers import krylov as TK
from navierstokes_tpu_torch.solvers import preconditioners as TPC
from navierstokes_tpu_torch.solvers import schur as TS

torch.set_num_threads(2)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _spd(n, seed=0):
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((n, n))
    return Q @ Q.T + n * np.eye(n)


def _both(fn):
    """fn(to_array, lib) for JAX and for the port -> (jax, port) results."""
    return (fn(jnp.asarray, "jax"),
            fn(lambda a: torch.as_tensor(np.asarray(a)), "torch"))


def _check(jr, tr, tol=1e-10):
    assert tr.iterations == int(jr.iterations)
    assert tr.converged == bool(jr.converged)
    jx = jr.x if isinstance(jr.x, tuple) else (jr.x,)
    tx = tr.x if isinstance(tr.x, tuple) else (tr.x,)
    for t, j in zip(tx, jx):
        assert _rel(t.numpy(), j) < tol
    # the Givens residual estimate, at the solves' rounding floor
    assert float(tr.residual) == pytest.approx(float(jr.residual), rel=1e-4)


def test_gmres_nonsymmetric():
    rng = np.random.default_rng(2)
    A = np.eye(80) * 4 + rng.standard_normal((80, 80)) * 0.3
    b = rng.standard_normal(80)
    jr, tr = _both(lambda f, lib: (JK if lib == "jax" else TK).gmres(
        lambda x, A=f(A): A @ x, f(b), tol=1e-10, restart=40, maxiter=200))
    _check(jr, tr)
    assert tr.iterations > 10


def test_gmres_restarts_and_x0():
    rng = np.random.default_rng(3)
    A = np.eye(100) * 3 + rng.standard_normal((100, 100)) * 0.2
    x_true = rng.standard_normal(100)
    x0 = x_true + 0.01 * rng.standard_normal(100)
    jr, tr = _both(lambda f, lib: (JK if lib == "jax" else TK).gmres(
        lambda x, A=f(A): A @ x, f(A @ x_true), x0=f(x0), tol=1e-12,
        restart=10, maxiter=300))
    _check(jr, tr)
    assert tr.iterations > 10          # several restart cycles
    assert _rel(tr.x.numpy(), x_true) < 1e-7


def test_gmres_budget_exit_and_tuple_precond():
    """A tuple system with a diagonal preconditioner; the budget exit
    (maxiter inside a cycle) returns the same iterate."""
    rng = np.random.default_rng(4)
    d1, d2 = 1.0 + rng.random(50) * 9, 1.0 + rng.random(30) * 9
    C = rng.standard_normal((50, 30)) * 0.3
    b1, b2 = rng.standard_normal(50), rng.standard_normal(30)

    def solve(f, lib, maxiter):
        mod = JK if lib == "jax" else TK
        D1, D2, Cm = f(d1), f(d2), f(C)
        mv = lambda x: (D1 * x[0] + Cm @ x[1], D2 * x[1] - Cm.T @ x[0])
        M = lambda r: (r[0] / D1, r[1] / D2)
        return mod.gmres(mv, (f(b1), f(b2)), tol=1e-12, restart=8,
                         maxiter=maxiter, precond=M)
    for maxiter in (13, 200):
        jr, tr = _both(lambda f, lib: solve(f, lib, maxiter))
        _check(jr, tr)
    assert not _both(lambda f, lib: solve(f, lib, 13))[1].converged


@pytest.mark.parametrize("method", ["bicgstab", "gmres"])
def test_fgmres_saddle_point_asimple(method):
    """tests/test_krylov.py's dense saddle point [F Bt; B 0] by FGMRES with
    aSIMPLE, inner solves by either InnerSolve method."""
    rng = np.random.default_rng(6)
    F = _spd(60, 7) / 60 + np.eye(60) * 2
    F += rng.standard_normal((60, 60)) * 0.05
    B = rng.standard_normal((20, 60))
    dinv = 1.0 / np.diag(F)
    diag_s = np.einsum("ju,u,ju->j", B, dinv, B)
    b = (rng.standard_normal(60), rng.standard_normal(20))

    def solve(f, lib):
        K, PC = (JK, JPC) if lib == "jax" else (TK, TPC)
        Fm, Bm = f(F), f(B)
        mv = lambda x: (Fm @ x[0] + Bm.T @ x[1], Bm @ x[0])
        M = PC.make_asimple(lambda u: Fm @ u, lambda u: Bm @ u,
                            lambda p: Bm.T @ p, f(dinv), f(diag_s),
                            alpha=0.5,
                            inner_f=PC.InnerSolve(1e-2, 40, method=method),
                            inner_s=PC.InnerSolve(1e-2, 40, method=method))
        return K.fgmres(mv, (f(b[0]), f(b[1])), tol=1e-9, restart=40,
                        maxiter=200, precond=M)
    jr, tr = _both(solve)
    _check(jr, tr)
    assert tr.converged and tr.iterations > 3


# ---------------------------------------------------------------------------
# the fixture's step-1 operators
# ---------------------------------------------------------------------------


def _make(cls, tmp, **kw):
    inlet = InletConfig(kind="parabolic", u_m=0.3, height=0.41)
    cfg = SolverConfig(dtype="float64", output_dir=os.path.join(tmp, "out"),
                       cache_dir=os.path.join(tmp, "cache"),
                       csv_path=os.path.join(tmp, "forces.csv"),
                       scheme="monolithic", preconditioner="asimple")
    ns = cls(channel_with_cylinder_2d(h=0.1, h_near=0.04), 2, 1,
             deltat=0.01, T=0.03, step=3, inlet=inlet, config=cfg, **kw)
    ns.set_re_number(20)
    return ns.setup()


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("precond"))
    return (_make(JaxNS, os.path.join(tmp, "j")),
            _make(TNS, os.path.join(tmp, "t"), device="cpu"))


@pytest.fixture(scope="module")
def u_adv(pair):
    return 0.3 * np.random.default_rng(10).standard_normal(
        (pair[1].space.n_p2, 2))


def _f_sigma(ns, B, u):
    """The step's F values, masked diagonal weights and sigma at u."""
    f = ns.a0_cell + B.convection_blk(ns.ell, u)
    mflat = ns.bc.mask[:, 0]
    d = B.f_diag(ns.ell, f)
    sigma = (d * mflat).sum() / max(mflat.sum(), 1.0)
    return f, d, mflat, sigma


@pytest.fixture(scope="module")
def tile_inverses(pair, u_adv):
    """JAX's exact fp32 tile inverses of the step's F at u_adv."""
    jns = pair[0]
    f, _, mflat, sigma = _f_sigma(jns, JB, jnp.asarray(u_adv))
    return np.asarray(JP.block_jacobi_invert(jns._bj_plan, f, mflat, sigma,
                                             x0=None, iters=0))


def _preconditioner(ns, lib, name, u_np, inv_np):
    """The block preconditioner ``name`` of the step at velocity u, built
    from each package's own functions as its model's step builds it."""
    J = lib == "jax"
    B, P, S, PC = (JB, JP, JS, JPC) if J else (TB, TP, TS, TPC)
    arr = jnp.asarray if J else torch.as_tensor
    where1 = ((lambda c, a: jnp.where(c, a, 1.0)) if J else
              (lambda c, a: torch.where(c, a, torch.ones_like(a))))
    cfg, ell = ns.config, ns.ell
    u = arr(u_np)
    f, d, mflat, sigma = _f_sigma(ns, B, u)
    mask = ns.bc.mask
    dinv = (1.0 / (d * mflat + sigma * (1.0 - mflat)))[:, None]
    apply_F = lambda x: B.apply_f(ell, f, x * mask) * mask \
        + sigma * (x - x * mask)
    apply_Bt = lambda p: B.apply_bt(ell, p) * mask
    apply_B = lambda x: B.apply_b(ell, x * mask)
    # JAX pads its node blocks to 128 rows, so it has more (padding) tiles
    inv = arr(np.array(inv_np)[:ns._bj_plan.n_tiles])
    pre_f = lambda r: P.block_jacobi_apply(ns._bj_plan, inv, r)
    inner = PC.InnerSolve(cfg.inner_tol, cfg.inner_maxiter_f)
    inner_f = lambda op, rhs, pre=None: inner(op, rhs, pre_f)
    inner_s = PC.InnerSolve(cfg.inner_tol, cfg.inner_maxiter_s)
    vc = dict(n_cycles=cfg.schur_vcycles, smooth_k=cfg.schur_smooth_k)
    dt, nu = cfg.deltat, ns.nu

    def vcycle_s(w, diag_s):
        sc_inv = S.coarse_inverse(S.coarse_matrix(ell, ns._coarse_plan, w))
        apply_s = lambda v: apply_B(apply_Bt(v) * w[:, None])
        lam = S.estimate_lam_max(apply_s, where1(diag_s != 0, 1.0 / diag_s),
                                 ns.space.n_p1, ns.dtype)
        return S.make_vcycle_solver(apply_s, diag_s, ns._coarse_plan,
                                    sc_inv, lam_max=lam, **vc)

    if name in ("cc", "pcd"):
        apply_ap = lambda v: P.ell_matvec(ns._ap, v)
        solve_ap = S.make_vcycle_solver(apply_ap, ns._ap.diag,
                                        ns._coarse_plan, ns._ap_sc_inv,
                                        lam_max=ns._ap_lam, **vc)
        if name == "cc":
            return PC.make_cahouet_chabard(apply_F, apply_Bt, solve_ap,
                                           ns._mp_lumped, dinv, dt, nu,
                                           inner_f)
        npb = B.pressure_convection_blk(ell, u)
        return PC.make_pcd(apply_F, apply_Bt, solve_ap, apply_ap,
                           lambda v: B.apply_pp(ell, npb, v), ns._mp_lumped,
                           dinv, dt, nu, inner_f)
    if name == "asimple":
        w = dinv[:, 0] * mflat
        diag_s = B.schur_diag(ell, w)
        return PC.make_asimple(apply_F, apply_B, apply_Bt, dinv, diag_s,
                               cfg.alpha, inner_f, inner_s,
                               solve_s=vcycle_s(w, diag_s))
    if name == "ayosida":
        w = ns.dt_mlump_inv[:, 0] * mflat
        diag_s = B.schur_diag(ell, w)
        return PC.make_ayosida(apply_F, apply_B, apply_Bt, dinv,
                               ns.dt_mlump_inv, diag_s, inner_f, inner_s,
                               solve_s=vcycle_s(w, diag_s))
    return PC.make_identity()


@pytest.mark.parametrize("name", ["cc", "pcd", "asimple", "ayosida",
                                  "identity"])
def test_preconditioner_vmults_match_jax(pair, u_adv, tile_inverses, name):
    jns, tns = pair
    rng = np.random.default_rng(11)
    ru = rng.standard_normal((tns.space.n_p2, 2))
    rp = rng.standard_normal(tns.space.n_p1)
    ju, jp = _preconditioner(jns, "jax", name, u_adv, tile_inverses)(
        (jnp.asarray(ru), jnp.asarray(rp)))
    tu, tp = _preconditioner(tns, "torch", name, u_adv, tile_inverses)(
        (torch.as_tensor(ru), torch.as_tensor(rp)))
    assert _rel(tu.numpy(), ju) < 1e-10
    assert _rel(tp.numpy(), jp) < 1e-10


def test_whole_row_gb_tables_under_monolithic(pair):
    """The JAX model builds whole-row G/B tables under monolithic
    (bsr_gb_kmax=-2, auto; the projection split: tests/test_torch_solvers
    .py).  Their entries lie in the port's compact G and B with the same
    values; the whole-row G block table and G's sums over each block's
    pressure nodes, the Schur coarse assembly's inputs, equal JAX's (which
    pads its node blocks to 128 rows with empty ones)."""
    jns, tns = pair
    je, te = jns.ell, tns.ell
    assert je.g_spill is None and je.b_spill is None
    for mat, vals, coo in ((te.g, te.g_vals, TJ.g_coo(je)),
                           (te.b, te.b_vals, TJ.b_coo(je))):
        assert _rel(vals.numpy(), TJ.on(mat, coo, torch.float64).numpy()) \
            < 1e-12
    n_vb = te.host.g_cols_full.shape[0]
    g_cols_j = np.asarray(je.host_g_cols)
    np.testing.assert_array_equal(te.host.g_cols_full, g_cols_j[:n_vb])
    assert not g_cols_j[n_vb:].any()
    g_t = tns._coarse_plan.g_agg.numpy()
    g_j = np.asarray(JB.g_blocks(je)).sum(axis=4)
    assert g_t.shape == g_j[:n_vb].shape and _rel(g_t, g_j[:n_vb]) < 1e-12
    assert not g_j[n_vb:].any()


def test_schur_coarse_matches_jax(pair):
    """The G-pair plan is JAX's without the pairs of its padding blocks
    (which come last in the stable order and add zeros)."""
    jns, tns = pair
    jplan, tplan = jns._coarse_plan, tns._coarse_plan
    assert (tplan.n_agg, tplan.agg) == (jplan.n_agg, jplan.agg)
    n_pairs = tplan.g_agg.shape[0] * tplan.g_agg.shape[1] ** 2
    order_j = np.asarray(jplan.pair_scatter.order)
    kept = order_j < n_pairs
    np.testing.assert_array_equal(tplan.pair_plan.order.numpy(),
                                  order_j[kept])
    np.testing.assert_array_equal(
        tplan.pair_plan.lengths.numpy(),
        np.bincount(np.asarray(jplan.pair_scatter.sorted_ids)[kept],
                    minlength=tplan.n_agg ** 2))
    w = np.random.default_rng(12).uniform(0.5, 2.0, tns.space.n_p2) \
        * tns.bc.host_mask[:, 0]
    sc_j = JS.coarse_matrix(jns.ell, jplan, jnp.asarray(w))
    sc_t = TS.coarse_matrix(tns.ell, tplan, torch.as_tensor(w))
    assert _rel(sc_t.numpy(), sc_j) < 1e-12
    inv_j = np.asarray(JS.coarse_inverse(sc_j))
    inv_t = TS.coarse_inverse(sc_t)
    assert inv_t.dtype == torch.float64
    assert _rel(inv_t.numpy(), inv_j) < 1e-6      # inverted in fp32
    assert _rel(TB.schur_diag(tns.ell, torch.as_tensor(w)).numpy(),
                JB.schur_diag(jns.ell, jnp.asarray(w))) < 1e-12


def test_pressure_convection_and_ap_match_jax(pair, u_adv):
    """JAX's PCD pressure convection and Ap, carried into the port's
    compact slots (every nonzero inside the port's patterns), equal the
    port's own; the products agree."""
    jns, tns = pair
    je, te = jns.ell, tns.ell
    F64 = torch.float64
    assert _rel(te.tp_hat.numpy(), je.tp_hat) < 1e-15
    np_j = JB.pressure_convection_blk(je, jnp.asarray(u_adv))
    np_t = TB.pressure_convection_blk(te, torch.as_tensor(u_adv))
    assert _rel(np_t.numpy(), TJ.on(te.pp, TJ.pp_coo(je, np_j), F64).numpy()) \
        < 1e-12
    x = np.random.default_rng(13).standard_normal(tns.space.n_p1)
    assert _rel(TB.apply_pp(te, np_t, torch.as_tensor(x)).numpy(),
                JB.apply_pp(je, np_j, jnp.asarray(x))) < 1e-12
    # the Cahouet-Chabard operator Ap = B diag(mask / M_lumped) B^T
    ap_t, ap_j = tns._ap, jns._ap
    assert _rel(ap_t.vals.numpy(),
                TJ.on(ap_t.mat, TJ.p1_coo(ap_j), F64).numpy()) < 1e-12
    assert _rel(ap_t.diag.numpy(), ap_j.diag) < 1e-12
    assert _rel(tns._ap_sc_inv.numpy(), jns._ap_sc_inv) < 1e-12
    assert float(tns._ap_lam) == pytest.approx(float(jns._ap_lam), rel=1e-12)
    assert _rel(TP.ell_matvec(ap_t, torch.as_tensor(x)).numpy(),
                JP.ell_matvec(ap_j, jnp.asarray(x))) < 1e-12
    assert _rel(tns.dt_mlump_inv.numpy(), jns.dt_mlump_inv) < 1e-15
