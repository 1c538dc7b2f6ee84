"""The port's NavierStokes (projection scheme) against the JAX model, in
float64 on the tests/test_e2e.py cylinder channel (h=0.1, h_near=0.04):
per-step iteration counts equal, p to 1e-9 relative, u, Cd and Cl to 1e-8
(the limits' derivation is at ``U_TOL``); the csv
schema and checkpoints; restart equivalence within the port; a JAX
checkpoint restarted in the port; the options the port once refused
against JAX, and unknown option values raise; and chip_smoke.py refuses
to run without a card.  The monolithic scheme
is in tests/test_torch_monolithic*.py.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from navierstokes_tpu.config import InletConfig, SolverConfig
from navierstokes_tpu.mesh import channel_with_cylinder_2d
from navierstokes_tpu.models.navier_stokes import NavierStokes as JaxNS
from navierstokes_tpu_torch import convert
from navierstokes_tpu_torch.models.navier_stokes import NavierStokes as TNS

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def mesh():
    return channel_with_cylinder_2d(h=0.1, h_near=0.04)


def _make(cls, mesh, tmp, T=0.03, step=3, **kw):
    dev = {"device": kw.pop("device")} if "device" in kw else {}
    kw.setdefault("scheme", "projection")
    inlet = InletConfig(kind="parabolic", u_m=0.3, height=0.41)
    cfg = SolverConfig(dtype="float64", output_dir=os.path.join(tmp, "out"),
                       cache_dir=os.path.join(tmp, "cache"),
                       csv_path=os.path.join(tmp, "forces.csv"), **kw)
    ns = cls(mesh, 2, 1, deltat=0.01, T=T, step=step, inlet=inlet,
             config=cfg, **dev)
    ns.set_re_number(20)
    return ns


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


# Limits of the projection parity, derived from the fp32 tile-inverse noise
# (tools/tile_noise_sensitivity.py measures each number below).  The u*
# BiCGStab and the Poisson CG stop at proj_tol = 1e-4, so their iterates
# depend to first order on the preconditioner.  Each package builds the
# per-step block-Jacobi tile inverses in fp32, by an LU at step 1 and by
# Newton-Schulz matmuls after it, in its own summation order: on this
# fixture the two packages' inverses differ by up to 3.1e-7 relative at
# steps 1-3 (giving both the same LU would remove only step 1's share,
# 1.2e-10 of u).  Perturbing the port's own tile inverses by +-3.1e-7 moves,
# within 3 steps of either scheme, u by up to 3.6e-9, p by 2.4e-10 and Cd
# by 2.1e-9 of the force scale; the limits are about three times that.
# Measured port against JAX: u 1.5e-9 (BDF1, step 3) and 4.1e-10 (BDF2).
U_TOL, P_TOL, FORCE_TOL = 1e-8, 1e-9, 1e-8


@pytest.mark.parametrize("bdf2", [True, False], ids=["bdf2", "bdf1"])
def test_steps_match_jax(mesh, tmp_path, bdf2):
    jns = _make(JaxNS, mesh, str(tmp_path / "j"), proj_bdf2=bdf2).setup()
    tns = _make(TNS, mesh, str(tmp_path / "t"), proj_bdf2=bdf2,
                device="cpu").setup()
    for _ in range(3):
        jm = jns.solve_time_step()
        tm = tns.solve_time_step()
        assert tm.iterations == int(jm.iterations)
        assert tm.converged
        assert _rel(tns._u.numpy(), jns._u) < U_TOL
        assert _rel(tns._p.numpy(), jns._p) < P_TOL
        # Cd and Cl relative to the force coefficient's magnitude: Cl is
        # the small (here ~300x smaller) component of the same force vector
        scale = max(abs(float(jm.cd)), abs(float(jm.cl)))
        assert abs(tm.cd - float(jm.cd)) <= FORCE_TOL * scale
        assert abs(tm.cl - float(jm.cl)) <= FORCE_TOL * scale
        assert tns.time == pytest.approx(jns.time, abs=1e-15)


def test_solve_writes_csv_and_checkpoints(mesh, tmp_path):
    ns = _make(TNS, mesh, str(tmp_path), device="cpu").setup()
    ns.solve()
    with open(ns.config.csv_path) as f:
        header = f.readline().strip()
        rows = f.readlines()
    assert header == ("time,deltat,GMRES_iters,time_prec_init,time_sol,"
                      "Drag,Lift,Cd,Cl")
    assert len(rows) == 3
    vals = np.array([r.split(",") for r in rows], dtype=float)
    assert np.all(np.isfinite(vals)) and (vals[:, 2] < 100).all()
    assert (vals[:, 3] > 0).all()          # measured tile rebuild time
    for ts in (0, 3):
        assert os.path.exists(os.path.join(ns.config.cache_dir,
                                           f"state-ns-{ts}.npz"))
    assert os.path.exists(os.path.join(ns.config.output_dir,
                                       "output-stokes_000003.vtu"))
    u = ns._u.numpy()
    obst = ns.space.p2_nodes_on_tag(4)
    np.testing.assert_allclose(u[obst], 0.0, atol=1e-12)
    assert ns.measured_cfl() > 0


def test_restart_equivalence(mesh, tmp_path):
    """A restart from a checkpoint reproduces the continuous run (the
    step is a fixed-order function of the state: no atomics)."""
    a = _make(TNS, mesh, str(tmp_path / "a"), T=0.04, step=2,
              device="cpu").setup()
    a.solve()
    b = _make(TNS, mesh, str(tmp_path / "b"), T=0.04, step=2,
              device="cpu").setup()
    b.solve()
    c = _make(TNS, mesh, str(tmp_path / "b"), T=0.04, step=2,
              device="cpu").setup()
    c.solve(time_step=2)
    np.testing.assert_allclose(c._u.numpy(), a._u.numpy(), atol=1e-12)
    np.testing.assert_allclose(c._p.numpy(), a._p.numpy(), atol=1e-12)
    assert c.time == a.time


def test_jax_checkpoint_restarts_port(mesh, tmp_path):
    """JAX writes state-ns-2; the port restarts from it for one step and
    lands on JAX's step 3.  The same state handed over in memory
    (convert.state_from_jax_numpy) gives the same step."""
    jns = _make(JaxNS, mesh, str(tmp_path / "j"), T=0.02, step=2).setup()
    jns.solve()
    jm = jns.solve_time_step()
    tns = _make(TNS, mesh, str(tmp_path / "j"), T=0.02, step=2,
                device="cpu").setup()
    tns.import_data(2)
    tm = tns.solve_time_step()
    assert tm.iterations == int(jm.iterations)
    assert _rel(tns._u.numpy(), jns._u) < 1e-9
    assert _rel(tns._p.numpy(), jns._p) < 1e-9
    u3 = tns._u.clone()
    with np.load(os.path.join(str(tmp_path / "j"), "cache",
                              "state-ns-2.npz")) as z:
        st = convert.state_from_jax_numpy(z["u"], z["p"], z["u_prev"],
                                          z["phi"], float(z["time"]), "cpu",
                                          torch.float64)
    tns.load_state(st)
    tns.solve_time_step()
    assert torch.equal(tns._u, u3)


@pytest.mark.parametrize("option,value", [
    ("f_solver", "richardson"), ("operator", "ell"),
    ("proj_poisson", "schur"), ("bj_tiles", "scatter"), ("bj_tiles", "rows"),
    ("mass_format", "node"), ("proj_p_extrap", 1.0)])
def test_unported_options_raise(mesh, tmp_path, option, value):
    """The options the port once refused now build and step: 2 steps of
    the port under each against JAX under the same value, equal iteration
    counts and this file's limits (``U_TOL``).  ``f_solver`` and
    ``operator`` are monolithic options (projection needs the bsr
    operator); ``ell`` runs with the inner solves at 1e-10, where its
    round-off sensitivity (tests/test_torch_cells.py) is below 1e-9.
    ``schur`` runs as tests/test_e2e.py runs it (BDF1) at proj_tol 1e-8:
    at the default 1e-4 its CG on B W B^T stops where the two packages'
    last-bit differences still move p by 5e-8 relative (measured), at
    1e-8 by 4e-10 (tests/test_torch_solver_options.py)."""
    kw = {option: value}
    if option in ("f_solver", "operator"):
        kw["scheme"] = "monolithic"
    if option == "operator":
        kw.update(inner_tol=1e-10, inner_maxiter_f=1000,
                  inner_maxiter_s=1000)
    if option == "proj_poisson":
        kw.update(proj_tol=1e-8, proj_bdf2=False)
    jns = _make(JaxNS, mesh, str(tmp_path / "j"), **kw).setup()
    tns = _make(TNS, mesh, str(tmp_path / "t"), device="cpu", **kw).setup()
    assert getattr(tns.config, option) == value
    for _ in range(2):
        jm, tm = jns.solve_time_step(), tns.solve_time_step()
        assert tm.iterations == int(jm.iterations) and tm.converged
        assert _rel(tns._u.numpy(), jns._u) < U_TOL
        assert _rel(tns._p.numpy(), jns._p) < P_TOL
        scale = max(abs(float(jm.cd)), abs(float(jm.cl)))
        assert abs(tm.cd - float(jm.cd)) <= FORCE_TOL * scale
        assert abs(tm.cl - float(jm.cl)) <= FORCE_TOL * scale


@pytest.mark.parametrize("option,value", [
    ("scheme", "implicit"), ("operator", "csr"), ("preconditioner", "ilu"),
    ("proj_poisson", "exact"), ("f_precond", "ilu"), ("f_solver", "cg"),
    ("bj_tiles", "dense"), ("mass_format", "lumped")])
def test_unknown_option_values_raise(mesh, tmp_path, option, value):
    """A value that no option of the JAX package takes raises ValueError
    naming the option (the JAX model would run one of its branches
    instead)."""
    with pytest.raises(ValueError, match=f"SolverConfig.{option}="):
        _make(TNS, mesh, str(tmp_path), device="cpu", **{option: value})


def test_unported_model_features_raise(mesh, tmp_path):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TNS(mesh, 2, 1, 0.01, 0.03, 3, device="cuda",
                config=SolverConfig(scheme="projection"))


def _no_ok_line(stdout):
    for line in stdout.splitlines():
        try:
            if json.loads(line).get("ok") is True:
                return False
        except (ValueError, AttributeError):
            continue
    return True


def test_chip_smoke_refuses_without_cuda():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "",
           "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT, env=env)
    assert out.returncode != 0
    assert _no_ok_line(out.stdout)


def test_chip_smoke_refuses_without_the_package(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"],
                         capture_output=True, text=True, timeout=120,
                         cwd=tmp_path, env=env)
    assert out.returncode != 0
    assert _no_ok_line(out.stdout)
