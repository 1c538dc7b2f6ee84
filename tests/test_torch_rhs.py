"""The outlet-pressure (``p_out``) and forcing terms of the port's
momentum RHS against the JAX model's, float64 on the CPU, on the
tests/test_torch_model.py cylinder channel (h=0.1, h_near=0.04, Re=20):

* ``neumann_rhs`` and the host ``forcing_rhs`` equal JAX's to 1e-12, and
  the per-step forcing integral equals the host one;
* p_out = 0.7, and the forcing f(x, t) = (1, 0.5 x0) (written once with
  jnp for JAX and once with torch for the port), each in both schemes
  (projection BDF2, monolithic ``cc``): 3 steps with equal iteration
  counts and u, p, Cd, Cl within 1e-9;
* the port's version of tests/test_e2e.py ``test_forcing_term_wired``: a
  run with forcing equals a run whose constant RHS carries the
  host-assembled forcing integral;
* p_out = 0 and no forcing leave the step bit-identical to the default;
* the BDF2 temporal-order check of tests/test_convergence.py on the
  port: observed order >= 1.8 against an analytic ramped Poiseuille flow.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from navierstokes_tpu.config import InletConfig as JInlet
from navierstokes_tpu.config import SolverConfig as JCfg
from navierstokes_tpu.mesh import channel_with_cylinder_2d
from navierstokes_tpu.models.navier_stokes import NavierStokes as JaxNS
from navierstokes_tpu.ops import assembly as JAs
from navierstokes_tpu.ops import forces as JF
from navierstokes_tpu.ops.operators import build_scatter
from navierstokes_tpu_torch.config import InletConfig as TInlet
from navierstokes_tpu_torch.config import SolverConfig as TCfg
from navierstokes_tpu_torch.fem.spaces import TaylorHoodSpace
from navierstokes_tpu_torch.mesh import rectangle_2d
from navierstokes_tpu_torch.models.navier_stokes import NavierStokes as TNS
from navierstokes_tpu_torch.ops import assembly as TAs
from navierstokes_tpu_torch.ops import forces as TF
from navierstokes_tpu_torch.ops.operators import segment_plan

torch.set_num_threads(2)
F64 = torch.float64
SCHEMES = {"projection": dict(scheme="projection", proj_bdf2=True),
           "monolithic": dict(scheme="monolithic", preconditioner="cc")}


@pytest.fixture(scope="module")
def mesh():
    return channel_with_cylinder_2d(h=0.1, h_near=0.04)


def f_jax(x, t):
    return jnp.stack([jnp.ones(x.shape[0]), 0.5 * x[:, 0]], axis=1)


def f_torch(x, t):
    return torch.stack([torch.ones_like(x[:, 0]), 0.5 * x[:, 0]], dim=1)


def f_numpy(x, t):
    return np.stack([np.ones(x.shape[0]), 0.5 * x[:, 0]], axis=1)


def _make(cls, mesh, tmp, forcing=None, device=None, T=0.03, step=3, **kw):
    inlet_cls, cfg_cls = ((TInlet, TCfg) if cls is TNS else (JInlet, JCfg))
    cfg = cfg_cls(dtype="float64", output_dir=os.path.join(tmp, "out"),
                  cache_dir=os.path.join(tmp, "cache"),
                  csv_path=os.path.join(tmp, "forces.csv"), **kw)
    extra = {"device": device} if cls is TNS else {}
    ns = cls(mesh, 2, 1, deltat=0.01, T=T, step=step,
             inlet=inlet_cls(kind="parabolic", u_m=0.3, height=0.41),
             config=cfg, forcing=forcing, **extra)
    ns.set_re_number(20)
    return ns.setup()


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def test_neumann_and_forcing_rhs_equal_jax(mesh):
    from navierstokes_tpu.fem.spaces import TaylorHoodSpace as JSpace
    ts, js = TaylorHoodSpace(mesh), JSpace(mesh)
    tf = TAs.build_face_arrays(ts, 1, F64, "cpu")
    jf = JAs.build_face_arrays(js, 1, dtype=jnp.float64)
    rt = TF.neumann_rhs(tf, 0.7, segment_plan(tf.vel_nodes.numpy(), ts.n_p2,
                                              "cpu"))
    rj = JF.neumann_rhs(jf, 0.7, build_scatter(np.asarray(jf.vel_nodes),
                                               js.n_p2))
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0,
                               atol=1e-12 * np.abs(np.asarray(rj)).max())
    # sum_nodes r_x = -p_out * int_outlet n_x = -0.7 * 0.41
    assert rt[:, 0].sum().item() == pytest.approx(-0.7 * 0.41, rel=1e-12)
    ft = TAs.forcing_rhs(ts, f_numpy, 0.25)
    fj = JAs.forcing_rhs(js, f_numpy, 0.25)
    np.testing.assert_allclose(ft, fj, rtol=0, atol=1e-12 * np.abs(fj).max())
    data = TAs.build_forcing_data(ts, F64, "cpu")
    fi = TAs.forcing_integral(data, f_torch, torch.tensor(0.25, dtype=F64))
    np.testing.assert_allclose(fi.numpy(), ft, rtol=0,
                               atol=1e-12 * np.abs(ft).max())


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
@pytest.mark.parametrize("term", ["p_out", "forcing"])
def test_steps_with_the_term_match_jax(mesh, tmp_path, scheme, term):
    kw = dict(SCHEMES[scheme])
    jf = tf = None
    if term == "p_out":
        kw["p_out"] = 0.7
    else:
        jf, tf = f_jax, f_torch
    jns = _make(JaxNS, mesh, str(tmp_path / "j"), forcing=jf, **kw)
    tns = _make(TNS, mesh, str(tmp_path / "t"), forcing=tf, device="cpu",
                **kw)
    for _ in range(3):
        jm, tm = jns.solve_time_step(), tns.solve_time_step()
        assert tm.iterations == int(jm.iterations) and tm.converged
        assert _rel(tns._u.numpy(), jns._u) < 1e-9
        assert _rel(tns._p.numpy(), jns._p) < 1e-9
        scale = max(abs(float(jm.cd)), abs(float(jm.cl)))
        assert abs(tm.cd - float(jm.cd)) <= 1e-9 * scale
        assert abs(tm.cl - float(jm.cl)) <= 1e-9 * scale


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_zero_terms_leave_the_step_unchanged(mesh, tmp_path, scheme):
    """p_out = 0 and no forcing: the model holds no Neumann vector and
    no forcing data, and the steps are those of a default model."""
    a = _make(TNS, mesh, str(tmp_path / "a"), device="cpu", p_out=0.0,
              **SCHEMES[scheme])
    b = _make(TNS, mesh, str(tmp_path / "b"), device="cpu",
              **SCHEMES[scheme])
    assert a.rhs_neumann is None and a._forcing_data is None
    for _ in range(2):
        a.solve_time_step()
        b.solve_time_step()
    assert torch.equal(a._u, b._u) and torch.equal(a._p, b._p)


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_forcing_term_wired(mesh, tmp_path, scheme):
    """A run with forcing f equals a run whose constant Neumann RHS
    carries the host-assembled forcing integral (f is time-constant)."""
    ns1 = _make(TNS, mesh, str(tmp_path / "a"), device="cpu", T=0.02,
                step=2, **SCHEMES[scheme])
    ns1.rhs_neumann = torch.as_tensor(TAs.forcing_rhs(ns1.space, f_numpy),
                                      dtype=F64)
    ns2 = _make(TNS, mesh, str(tmp_path / "b"), forcing=f_torch,
                device="cpu", T=0.02, step=2, **SCHEMES[scheme])
    ns1.solve()
    ns2.solve()
    np.testing.assert_allclose(ns2._u.numpy(), ns1._u.numpy(), atol=1e-10)
    np.testing.assert_allclose(ns2._p.numpy(), ns1._p.numpy(), atol=1e-10)


def test_projection_bdf2_temporal_order(tmp_path):
    """tests/test_convergence.py's analytic check on the port: the ramped
    Poiseuille flow u = g(t) 4 U y (H - y) / H^2 e_x, p = 0, driven by
    f = g'(t) U(y) e_x + 8 nu U g(t) / H^2 e_x, lies in the P2 space, so
    the final-time error is temporal only; halving dt must contract it at
    an observed order >= 1.8."""
    H, NU, UM, R, T = 0.41, 0.01, 1.0, 0.4, 0.4

    def g(t):
        return np.where(t >= R, 1.0, 0.5 - 0.5 * np.cos(np.pi * t / R))

    def forcing(x, t):
        y = x[:, 1]
        gt = torch.where(t >= R, 1.0, 0.5 - 0.5 * torch.cos(np.pi * t / R))
        gp = torch.where(t >= R, 0.0,
                         0.5 * np.pi / R * torch.sin(np.pi * t / R))
        fx = gp * 4.0 * UM * y * (H - y) / H ** 2 + 8.0 * NU * UM / H ** 2 * gt
        return torch.stack([fx, torch.zeros_like(fx)], dim=1)

    def final_error(dt):
        cfg = TCfg(dtype="float64", nu=NU, ref_length=0.1,
                   scheme="projection", proj_bdf2=True, proj_tol=1e-12,
                   proj_f_maxiter=500, proj_p_maxiter=400,
                   output_dir=str(tmp_path / "o"),
                   cache_dir=str(tmp_path / "c"),
                   csv_path=str(tmp_path / "f.csv"))
        ns = TNS(rectangle_2d(1.0, H, 8, 6), 2, 1, deltat=dt, T=T, step=0,
                 inlet=TInlet(kind="parabolic", u_m=UM, height=H, ramp=R),
                 config=cfg, forcing=forcing, device="cpu").setup()
        for _ in range(int(round(T / dt))):
            ns.solve_time_step()
        sp = ns.space
        ue = np.zeros((sp.n_p2, 2))
        ue[:, 0] = g(T) * 4.0 * UM * sp.p2_coords[:, 1] * (
            H - sp.p2_coords[:, 1]) / H ** 2
        return np.linalg.norm(ns._u.numpy() - ue)

    errs = [final_error(dt) for dt in (0.04, 0.02, 0.01)]
    r1, r2 = np.log2(errs[0] / errs[1]), np.log2(errs[1] / errs[2])
    assert r1 > 1.8 and r2 > 1.8, (errs, r1, r2)
