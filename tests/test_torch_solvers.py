"""Port solvers vs the JAX solvers on the fixture's operators (float64):
BiCGStab on the BC-masked F with the block-Jacobi preconditioner, CG on
the outlet-pinned P1 Laplacian with the two-level V-cycle, the V-cycle
alone and the lambda_max estimate.  Same iteration counts, x to 1e-10.
Fixture: the tests/test_e2e.py cylinder channel (h=0.1, h_near=0.04) in
the projection configuration.
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
from navierstokes_tpu.solvers import schur as JS
from navierstokes_tpu_torch.models.navier_stokes import NavierStokes as TNS
from navierstokes_tpu_torch.ops import bsr as TB
from navierstokes_tpu_torch.ops import p1ell as TP
from navierstokes_tpu_torch.solvers import krylov as TK
from navierstokes_tpu_torch.solvers import schur as TS

torch.set_num_threads(2)


def _make(cls, tmp, **kw):
    inlet = InletConfig(kind="parabolic", u_m=0.3, height=0.41)
    cfg = SolverConfig(dtype="float64", output_dir=os.path.join(tmp, "out"),
                       cache_dir=os.path.join(tmp, "cache"),
                       csv_path=os.path.join(tmp, "forces.csv"),
                       scheme="projection")
    ns = cls(channel_with_cylinder_2d(h=0.1, h_near=0.04), 2, 1,
             deltat=0.01, T=0.03, step=3, inlet=inlet, config=cfg, **kw)
    ns.set_re_number(20)
    return ns.setup()


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("solvers"))
    return (_make(JaxNS, os.path.join(tmp, "j")),
            _make(TNS, os.path.join(tmp, "t"), device="cpu"))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def test_projection_keeps_split_gb_tables(pair):
    """The JAX model splits its G/B tables under projection
    (bsr_gb_kmax=-2, auto); the port keeps one compact G and one compact B
    for both schemes.  Every entry of JAX's split tables lies in the
    port's patterns, with the same value (the whole-row tables of the
    monolithic scheme: tests/test_torch_preconditioners.py)."""
    jns, tns = pair
    # the split's slot count is a multiple of 128 / bp (here no row spills)
    assert jns.ell.g_cols.shape[1] % (128 // jns.ell.bp) == 0
    e = tns.ell
    for mat, vals, coo in ((e.g, e.g_vals, TJ.g_coo(jns.ell)),
                           (e.b, e.b_vals, TJ.b_coo(jns.ell))):
        assert _rel(vals.numpy(), TJ.on(mat, coo, torch.float64).numpy()) \
            < 1e-12


def test_lam_max_matches(pair):
    jns, tns = pair
    assert _rel(float(tns._ap_dir_lam), float(jns._ap_dir_lam)) < 1e-12


def _poisson(ns, mod_p, mod_s, lib):
    ap = ns._ap_dir
    apply = lambda v: mod_p.ell_matvec(ap, v)
    pre = mod_s.make_vcycle_solver(apply, ap.diag, ns._coarse_plan,
                                   ns._ap_dir_sc_inv, n_cycles=1,
                                   smooth_k=ns.config.schur_smooth_k,
                                   lam_max=ns._ap_dir_lam)
    return apply, pre


def test_vcycle_matches(pair):
    jns, tns = pair
    r = np.random.default_rng(0).standard_normal(tns.space.n_p1)
    _, jpre = _poisson(jns, JP, JS, jnp)
    _, tpre = _poisson(tns, TP, TS, torch)
    assert _rel(tpre(torch.as_tensor(r)).numpy(), jpre(jnp.asarray(r))) \
        < 1e-12


def test_cg_poisson_matches(pair):
    jns, tns = pair
    rng = np.random.default_rng(1)
    pin = np.asarray(jns._ap_dir_pin)
    rhs = rng.standard_normal(tns.space.n_p1) * pin
    x0 = rng.standard_normal(tns.space.n_p1) * pin * 0.1
    japply, jpre = _poisson(jns, JP, JS, jnp)
    tapply, tpre = _poisson(tns, TP, TS, torch)
    jr = JK.cg(japply, jnp.asarray(rhs), x0=jnp.asarray(x0), tol=1e-10,
               maxiter=60, precond=jpre)
    tr = TK.cg(tapply, torch.as_tensor(rhs), x0=torch.as_tensor(x0),
               tol=1e-10, maxiter=60, precond=tpre)
    assert tr.iterations == int(jr.iterations) > 3
    assert tr.converged == bool(jr.converged)
    assert _rel(tr.x.numpy(), jr.x) < 1e-10


@pytest.mark.parametrize("bdf2", [True, False])
def test_bicgstab_momentum_matches(pair, bdf2):
    """The u* solve's operator (BC-masked F with a convection term) and
    block-Jacobi preconditioner, built by each package from the same
    advecting velocity; no Newton-Schulz (exact tile inverses)."""
    jns, tns = pair
    rng = np.random.default_rng(2 if bdf2 else 3)
    n_p2 = tns.space.n_p2
    u_adv = 0.3 * rng.standard_normal((n_p2, 2))
    b = rng.standard_normal((n_p2, 2))
    x0 = 0.01 * rng.standard_normal((n_p2, 2))

    def system(ns, bsr_mod, p1_mod, u, lib):
        f = ns.a0_cell + bsr_mod.convection_blk(ns.ell, u)
        mask = ns.bc.mask
        mflat = mask[:, 0]
        d = bsr_mod.f_diag(ns.ell, f)
        sigma = (d * mflat).sum() / (mflat.sum())
        inv = p1_mod.block_jacobi_invert(ns._bj_plan, f, mflat, sigma,
                                         x0=None, iters=0)

        def apply_F(xu):
            xum = xu * mask
            return bsr_mod.apply_f(ns.ell, f, xum) * mask + sigma * (xu - xum)
        return apply_F, (lambda r: p1_mod.block_jacobi_apply(
            ns._bj_plan, inv, r))

    jF, jpre = system(jns, JB, JP, jnp.asarray(u_adv), jnp)
    tF, tpre = system(tns, TB, TP, torch.as_tensor(u_adv), torch)
    jr = JK.bicgstab(jF, jnp.asarray(b), x0=jnp.asarray(x0), tol=1e-10,
                     maxiter=100, precond=jpre)
    tr = TK.bicgstab(tF, torch.as_tensor(b), x0=torch.as_tensor(x0),
                     tol=1e-10, maxiter=100, precond=tpre)
    assert tr.iterations == int(jr.iterations) > 1
    assert tr.converged == bool(jr.converged)
    assert _rel(tr.x.numpy(), jr.x) < 1e-10


def test_bicgstab_budget_and_identity_precond(pair):
    """Iteration-budget exit: both stop at maxiter with the same iterate."""
    jns, tns = pair
    ap_j, ap_t = jns._ap_dir, tns._ap_dir
    rhs = np.random.default_rng(4).standard_normal(tns.space.n_p1)
    jr = JK.bicgstab(lambda v: JP.ell_matvec(ap_j, v), jnp.asarray(rhs),
                     tol=1e-14, maxiter=4)
    tr = TK.bicgstab(lambda v: TP.ell_matvec(ap_t, v), torch.as_tensor(rhs),
                     tol=1e-14, maxiter=4)
    assert tr.iterations == int(jr.iterations) == 4
    assert not tr.converged and not bool(jr.converged)
    assert _rel(tr.x.numpy(), jr.x) < 1e-10
