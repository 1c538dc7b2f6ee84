"""The solver options of the JAX model that the port took last, against
the JAX model in float64 on the CPU (the layout options ``operator="ell"``
and ``bj_tiles`` are in tests/test_torch_solver_layouts.py):

* ``proj_poisson="schur"``: 3 BDF1 projection steps on tests/test_e2e.py's
  coarse channel (h=0.1, h_near=0.04) at ``proj_tol=1e-8``; the pin set
  equals JAX's exactly, u and p within 1e-9 relative, the BiCGStab + CG
  count of each step equal (JAX's metrics hold the sum), Cd and Cl
  within 1e-8 (``test_schur_projection_matches_jax`` gives the reason);
  and the exactness property of JAX's test, the corrected
  velocity's divergence at the unpinned nodes below 0.02 of the
  Laplacian projection's;
* ``proj_p_extrap`` = 0.5 and 1.0: 4 BDF2 steps on
  tests/test_convergence.py's manufactured open channel
  (``rectangle_2d(1.0, 0.41, 8, 6)`` with its forcing, written in torch
  for the port) at ``proj_tol=1e-12``, within 1e-9 with equal counts; a
  JAX checkpoint taken under theta restarts the port onto JAX's next
  step;
* ``f_solver="richardson"``: 3 monolithic steps of ``cc`` + ``bj`` and
  ``asimple`` + ``jacobi`` on the coarse channel, within 1e-9, equal
  FGMRES counts;
* ``mass_format="node"``: 2 monolithic float64 steps of the h=0.15 duct
  (``refine=2``) against JAX's node mass, within 1e-9; with fp32
  ``refine=2``, in 2D and 3D, neither package refines (JAX refines only
  with its blocked mass), so the port's step is its refine=0 step bit
  for bit;
* row shards (``n_devices=2``) under ``schur`` and under
  ``proj_p_extrap``, bit for bit with one device;
* a change of ``proj_poisson``, ``proj_schur_pin_ratio``,
  ``proj_p_extrap`` or ``f_solver`` after setup raises at the next step.

The projection runs use ``proj_tol`` 1e-8 (1e-12 on the manufactured
channel) where tests/test_torch_model.py's default 1e-4 would leave the
two packages' fp32 tile-inverse noise in the iterates (its ``U_TOL``):
at 1e-8 the solves' iterates no longer depend on it to 1e-9.
"""

import math
import os

import numpy as np
import pytest
import torch

from navierstokes_tpu.config import InletConfig as JInlet
from navierstokes_tpu.config import SolverConfig as JConfig
from navierstokes_tpu.mesh import (channel_with_cylinder_2d,
                                   duct_with_box_obstacle_3d, rectangle_2d)
from navierstokes_tpu.models.navier_stokes import NavierStokes as JaxNS
from navierstokes_tpu_torch.config import InletConfig, SolverConfig
from navierstokes_tpu_torch.models.navier_stokes import NavierStokes as TNS

torch.set_num_threads(2)
TOL = 1e-9          # u, p relative; Cd, Cl over max(|Cd|, |Cl|)
TIGHT = dict(inner_tol=1e-10, inner_maxiter_f=1000, inner_maxiter_s=1000)
PARABOLIC = dict(kind="parabolic", u_m=0.3, height=0.41)


@pytest.fixture(scope="module")
def mesh():
    return channel_with_cylinder_2d(h=0.1, h_near=0.04)


def make(cls, mesh, tmp, kv=2, kp=1, dt=0.01, T=0.03, step=100, re=20,
         inlet=PARABOLIC, forcing=None, **kw):
    """A set-up model of either package on a JAX package mesh (the port
    takes it as it is), float64 unless ``kw`` says else (the port's on the
    CPU)."""
    jax_side = cls is JaxNS
    kw.setdefault("dtype", "float64")
    cfg = (JConfig if jax_side else SolverConfig)(
        output_dir=os.path.join(tmp, "out"),
        cache_dir=os.path.join(tmp, "cache"),
        csv_path=os.path.join(tmp, "forces.csv"), **kw)
    extra = {} if jax_side else dict(device="cpu")
    ns = cls(mesh, kv, kp, deltat=dt, T=T, step=step,
             inlet=(JInlet if jax_side else InletConfig)(**inlet),
             config=cfg, forcing=forcing, **extra)
    if re is not None:
        ns.set_re_number(re)
    return ns.setup()


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def step_both(jns, tns, n, tol=TOL, force_tol=TOL):
    """``n`` steps of each: equal iteration counts (FGMRES, or under
    projection BiCGStab + CG, the sum JAX's metrics hold), u and p within
    ``tol`` relative, Cd and Cl within ``force_tol`` of max(|Cd|, |Cl|)."""
    for _ in range(n):
        jm, tm = jns.solve_time_step(), tns.solve_time_step()
        assert tm.iterations == int(jm.iterations)
        assert tm.converged
        assert rel(tns._u.numpy(), jns._u) < tol
        assert rel(tns._p.numpy(), jns._p) < tol
        scale = max(abs(float(jm.cd)), abs(float(jm.cl)), 1e-300)
        assert abs(tm.cd - float(jm.cd)) <= force_tol * scale
        assert abs(tm.cl - float(jm.cl)) <= force_tol * scale
        assert tns.time == pytest.approx(jns.time, abs=1e-15)


# ---- proj_poisson="schur" ------------------------------------------------

SCHUR = dict(scheme="projection", proj_bdf2=False, proj_tol=1e-8)


def _div_max(ns, pin):
    """max |B u| over the nodes ``pin`` keeps (the port's B)."""
    _, d = ns._ops.apply_blocks(ns.ell, ns.a0_cell, ns._u,
                                torch.zeros(ns.space.n_p1,
                                            dtype=torch.float64),
                                with_f=False, with_g=False)
    return float((d * pin).abs().max())


def test_schur_projection_matches_jax(mesh, tmp_path):
    jns = make(JaxNS, mesh, str(tmp_path / "j"), proj_poisson="schur",
               **SCHUR)
    tns = make(TNS, mesh, str(tmp_path / "t"), proj_poisson="schur",
               **SCHUR)
    pin = tns._ap_schur_pin
    np.testing.assert_array_equal(pin.numpy(), np.asarray(jns._ap_schur_pin))
    # the pin set takes the outlet and more, not every node
    assert (int((tns._ap_dir_pin == 0).sum()) < int((pin == 0).sum())
            < tns.space.n_p1)
    assert torch.equal(pin * tns._ap_dir_pin, pin)
    # The forces of this run are small residues of the pressure integral
    # (Cd 1.3e-8 at step 1, 2.5e-2 at step 3): p's differences, 4e-10 of
    # max|p| (measured), move them by up to 3e-9 of max(|Cd|, |Cl|)
    # (measured), so they are held to 1e-8.
    step_both(jns, tns, 3, force_tol=1e-8)
    # the exactness property (tests/test_e2e.py): the Laplacian step's
    # divergence is orders above the compatible operator's
    lap = make(TNS, mesh, str(tmp_path / "l"), **SCHUR)
    for _ in range(3):
        lap.solve_time_step()
    ds, dl = _div_max(tns, pin), _div_max(lap, pin)
    assert ds < 0.02 * dl, (ds, dl)


@pytest.mark.parametrize("p_extrap", [0.0, 0.5], ids=["plain", "extrap"])
def test_schur_and_extrap_on_row_shards_equal_one_device(mesh, tmp_path,
                                                         p_extrap):
    """Two row shards under ``schur`` (with and without the pressure
    extrapolation): the pin set and 3 steps bit for bit with one device."""
    kw = dict(proj_poisson="schur", proj_p_extrap=p_extrap, **SCHUR)
    one = make(TNS, mesh, str(tmp_path / "1"), **kw)
    two = make(TNS, mesh, str(tmp_path / "2"), n_devices=2, **kw)
    assert two._sharded
    assert torch.equal(one._ap_schur_pin, two._ap_schur_pin)
    for _ in range(3):
        m1, m2 = one.solve_time_step(), two.solve_time_step()
        assert (m1.f_iterations, m1.p_iterations, m1.cd, m1.cl) == (
            m2.f_iterations, m2.p_iterations, m2.cd, m2.cl)
        for a in ("_u", "_p", "_phi"):
            assert torch.equal(getattr(one, a), getattr(two, a))


# ---- proj_p_extrap -------------------------------------------------------

# tests/test_convergence.py's manufactured open channel
H, NU, UM, R = 0.41, 0.01, 1.0, 0.2
OMEGA = np.pi / (2.0 * 0.8)
OPEN = dict(nu=NU, ref_length=0.1, scheme="projection", proj_bdf2=True,
            proj_tol=1e-12, proj_f_maxiter=500, proj_p_maxiter=400)
OPEN_INLET = dict(kind="parabolic", u_m=UM, height=H, ramp=R)


def jax_forcing(x, t):
    import jax.numpy as jnp
    y = x[:, 1]
    gj = jnp.where(t >= R, 1.0, 0.5 - 0.5 * jnp.cos(jnp.pi * t / R))
    gpj = jnp.where(t >= R, 0.0, 0.5 * jnp.pi / R * jnp.sin(jnp.pi * t / R))
    fx = (gpj * 4.0 * UM * y * (H - y) / H ** 2
          + 8.0 * NU * UM / H ** 2 * gj - jnp.sin(OMEGA * t))
    return jnp.stack([fx, jnp.zeros_like(fx)], axis=1)


def torch_forcing(x, t):
    y = x[:, 1]
    gj = torch.where(t >= R, 1.0, 0.5 - 0.5 * torch.cos(math.pi * t / R))
    gpj = torch.where(t >= R, 0.0,
                      0.5 * math.pi / R * torch.sin(math.pi * t / R))
    fx = (gpj * 4.0 * UM * y * (H - y) / H ** 2
          + 8.0 * NU * UM / H ** 2 * gj - torch.sin(OMEGA * t))
    return torch.stack([fx, torch.zeros_like(fx)], dim=1)


def open_pair(tmp, theta, T=0.08, step=100):
    common = dict(dt=0.02, T=T, step=step, re=None, inlet=OPEN_INLET,
                  proj_p_extrap=theta, **OPEN)
    jns = make(JaxNS, rectangle_2d(1.0, H, 8, 6), os.path.join(tmp, "j"),
               forcing=jax_forcing, **common)
    tns = make(TNS, rectangle_2d(1.0, H, 8, 6), os.path.join(tmp, "t"),
               forcing=torch_forcing, **common)
    return jns, tns


@pytest.mark.parametrize("theta", [0.5, 1.0])
def test_pressure_extrapolation_matches_jax(tmp_path, theta):
    """4 steps; phi carries the whole pressure change p^{n+1} - p^n."""
    jns, tns = open_pair(str(tmp_path), theta)
    jns._init_state(0)
    tns._init_state(0)
    for _ in range(4):
        p_before = tns._p.clone()
        step_both(jns, tns, 1)
        assert torch.equal(tns._phi, tns._p - p_before)
        assert rel(tns._phi.numpy(), jns._phi) < TOL


def test_pressure_extrapolation_checkpoint_restarts_port(tmp_path):
    """JAX writes state-ns-2 under theta=0.5; the port restarts from it
    and lands on JAX's step 3."""
    tmp = str(tmp_path)
    jns, _ = open_pair(tmp, 0.5, T=0.04, step=2)
    jns.solve()
    jm = jns.solve_time_step()
    tns = make(TNS, rectangle_2d(1.0, H, 8, 6), os.path.join(tmp, "j"),
               dt=0.02, T=0.04, step=2, re=None, inlet=OPEN_INLET,
               forcing=torch_forcing, proj_p_extrap=0.5, **OPEN)
    tns.import_data(2)
    tm = tns.solve_time_step()
    assert tm.iterations == int(jm.iterations)
    assert rel(tns._u.numpy(), jns._u) < TOL
    assert rel(tns._p.numpy(), jns._p) < TOL


# ---- f_solver="richardson" -----------------------------------------------

@pytest.mark.parametrize("pc,f_precond", [("cc", "bj"),
                                          ("asimple", "jacobi")])
def test_richardson_matches_jax(mesh, tmp_path, pc, f_precond):
    kw = dict(scheme="monolithic", f_solver="richardson", preconditioner=pc,
              f_precond=f_precond)
    jns = make(JaxNS, mesh, str(tmp_path / "j"), **kw)
    tns = make(TNS, mesh, str(tmp_path / "t"), **kw)
    step_both(jns, tns, 3)


# ---- the node mass ------------------------------------------------------

def test_node_mass_3d_matches_jax(tmp_path):
    """``refine=2`` is set as a 3D user would set it; neither package
    refines here (float64, and no blocked mass)."""
    kw = dict(scheme="monolithic", mass_format="node", refine=2,
              ref_length=0.1, force_formula="st")
    inlet = dict(kind="biparabolic", u_m=0.45, height=0.41)
    jns = make(JaxNS, duct_with_box_obstacle_3d(h=0.15), str(tmp_path / "j"),
               inlet=inlet, **kw)
    tns = make(TNS, duct_with_box_obstacle_3d(h=0.15), str(tmp_path / "t"),
               inlet=inlet, **kw)
    step_both(jns, tns, 2)


@pytest.mark.parametrize("dim", [2, 3])
def test_node_mass_skips_refinement(mesh, tmp_path, dim):
    """fp32 ``refine=2`` with the node mass: neither package refines (JAX
    refines only with its blocked mass), so the port builds no float64
    tables and its step is the refine=0 step bit for bit."""
    m = mesh if dim == 2 else duct_with_box_obstacle_3d(h=0.15)
    inlet = (PARABOLIC if dim == 2
             else dict(kind="biparabolic", u_m=0.45, height=0.41))
    runs = []
    for refine in (0, 2):
        ns = make(TNS, m, str(tmp_path / f"r{refine}"), dtype="float32",
                  inlet=inlet, scheme="monolithic", mass_format="node",
                  refine=refine)
        assert ns._ell64 is None and not ns._refines()
        runs.append((ns, ns.solve_time_step()))
    (a, ma), (b, mb) = runs
    assert torch.equal(a._u, b._u) and torch.equal(a._p, b._p)
    assert (ma.iterations, ma.residual) == (mb.iterations, mb.residual)
    if dim == 2:
        # the blocked mass does refine (the 2D default)
        ns = make(TNS, m, str(tmp_path / "blocked"), dtype="float32",
                  scheme="monolithic", refine=2)
        assert ns._refines()


@pytest.mark.parametrize("scheme,field,value", [
    ("projection", "proj_poisson", "schur"),
    ("projection", "proj_schur_pin_ratio", 0.5),
    ("projection", "proj_p_extrap", 0.5),
    ("monolithic", "f_solver", "richardson")])
def test_option_change_after_setup_raises(mesh, tmp_path, scheme, field,
                                          value):
    """The options setup or the captured graphs read are setup fields: a
    change after setup raises at the next step, naming it."""
    ns = make(TNS, mesh, str(tmp_path), scheme=scheme)
    ns.solve_time_step()
    setattr(ns.config, field, value)
    with pytest.raises(ValueError, match=f"SolverConfig.{field} changed"):
        ns.solve_time_step()
