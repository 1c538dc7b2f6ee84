"""Checkpoint post-processing of the port against the JAX model's, float64
on the CPU, on the tests/test_torch_model.py cylinder channel (h=0.1,
h_near=0.04, Re=20):

* ``post_process(0, 4, 2)`` on the port equals JAX's on the same
  checkpoints to 1e-10, both ways: checkpoints of a port run read by
  both, and checkpoints of a JAX run read by both;
* the replayed final Cd/Cl equal the live run's to rtol 1e-10
  (tests/test_e2e.py ``test_post_process_replay``), also for a pulsating
  inlet, which normalises by the instantaneous mean;
* ``postprocess`` through the CLI replays and writes the VTUs;
* ``assemble(0.0)`` is finite, equals JAX's operator values carried into
  the port's slots, and the step after it matches JAX's.
"""

import os

import numpy as np
import pytest
import torch

import torch_jax_ops as TJ
from navierstokes_tpu.config import InletConfig as JInlet
from navierstokes_tpu.config import SolverConfig as JCfg
from navierstokes_tpu.mesh import channel_with_cylinder_2d
from navierstokes_tpu.models.navier_stokes import NavierStokes as JaxNS
from navierstokes_tpu.scenarios import cli as jcli
from navierstokes_tpu_torch.config import InletConfig as TInlet
from navierstokes_tpu_torch.config import SolverConfig as TCfg
from navierstokes_tpu_torch.models.navier_stokes import NavierStokes as TNS
from navierstokes_tpu_torch.scenarios import cli as tcli

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def mesh():
    return channel_with_cylinder_2d(h=0.1, h_near=0.04)


def _make(cls, mesh, out, cache, T=0.04, step=2, pulsating=False):
    inlet_cls, cfg_cls = ((TInlet, TCfg) if cls is TNS else (JInlet, JCfg))
    inlet = (inlet_cls(kind="parabolic", u_m=1.5, height=0.41,
                       pulsating=True, period=8.0) if pulsating else
             inlet_cls(kind="parabolic", u_m=0.3, height=0.41))
    cfg = cfg_cls(dtype="float64", output_dir=str(out), cache_dir=str(cache),
                  csv_path=os.path.join(str(out), "forces.csv"))
    extra = {"device": "cpu"} if cls is TNS else {}
    os.makedirs(out, exist_ok=True)
    ns = cls(mesh, 2, 1, deltat=0.01, T=T, step=step, inlet=inlet,
             config=cfg, **extra)
    ns.set_re_number(100 if pulsating else 20)
    return ns.setup()


def _same_results(a, b, tol=1e-10):
    assert [r[0] for r in a] == [r[0] for r in b] == [0, 2, 4]
    for (ts, t1, cd1, cl1), (_, t2, cd2, cl2) in zip(a, b):
        assert t1 == pytest.approx(t2, abs=1e-15)
        scale = max(abs(cd2), abs(cl2), 1e-300)
        assert abs(cd1 - cd2) <= tol * scale, ts
        assert abs(cl1 - cl2) <= tol * scale, ts


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_post_process_equals_jax_on_the_same_checkpoints(mesh, tmp_path,
                                                         writer):
    cache = tmp_path / "cache"
    live = _make(TNS if writer == "port" else JaxNS, mesh, tmp_path / "run",
                 cache)
    live.solve()
    t = _make(TNS, mesh, tmp_path / "t", cache).post_process(0, 4, 2)
    j = _make(JaxNS, mesh, tmp_path / "j", cache).post_process(0, 4, 2)
    _same_results(t, j)
    assert os.path.exists(tmp_path / "t" / "output-stokes_000004.vtu")


@pytest.mark.parametrize("pulsating", [False, True],
                         ids=["steady", "pulsating"])
def test_replay_equals_the_live_run(mesh, tmp_path, pulsating):
    ns = _make(TNS, mesh, tmp_path / "out", tmp_path / "cache",
               pulsating=pulsating)
    ns.solve()
    cd_live, cl_live = ns.cd, ns.cl
    results = ns.post_process(0, 4, 2)
    assert [r[0] for r in results] == [0, 2, 4]
    np.testing.assert_allclose(results[-1][2], cd_live, rtol=1e-10)
    np.testing.assert_allclose(results[-1][3], cl_live, rtol=1e-10)
    assert (ns.cd, ns.cl) == results[-1][2:]


def test_postprocess_cli_writes_vtus(tmp_path, monkeypatch):
    monkeypatch.setattr(jcli, "_enable_cache", lambda: None)
    common = ["--h", "0.1", "--dtype", "float64", "--output-step", "2",
              "--output-dir", str(tmp_path / "out"), "--cache-dir",
              str(tmp_path / "cache"), "--csv", str(tmp_path / "f.csv"),
              "--device", "cpu"]
    assert tcli.main(["run", "2d-test1", "--T", "0.04"] + common) == 0
    for f in os.listdir(tmp_path / "out"):
        os.remove(tmp_path / "out" / f)
    assert tcli.main(["postprocess", "2d-test1", "--t0", "0", "--t1", "4",
                      "--step", "2"] + common) == 0
    for ts in (0, 2, 4):
        for ext in ("vtu", "pvtu"):
            assert os.path.exists(tmp_path / "out"
                                  / f"output-stokes_{ts:06d}.{ext}")


def test_assemble_then_step_matches_jax(mesh, tmp_path):
    """assemble(0.0) straight after setup (the reference's order,
    cpp:483-485) returns F = A0 + C(0), JAX's values in the port's slots;
    the step after it equals JAX's."""
    j = _make(JaxNS, mesh, tmp_path / "j", tmp_path / "jc")
    t = _make(TNS, mesh, tmp_path / "t", tmp_path / "tc")
    ft = t.assemble(0.0)
    fj = j.assemble(0.0)
    assert bool(torch.isfinite(ft).all())
    assert ft.shape == (t.ell.f.n_slots,)
    np.testing.assert_allclose(
        ft.numpy(), TJ.on(t.ell.f, TJ.f_coo(j.ell, fj), torch.float64).numpy(),
        rtol=0, atol=1e-12 * float(ft.abs().max()))
    mj, mt = j.solve_time_step(), t.solve_time_step()
    assert mt.iterations == int(mj.iterations)
    assert t.time == pytest.approx(0.01, abs=1e-15)
    np.testing.assert_allclose(t._u.numpy(), np.asarray(j._u), rtol=0,
                               atol=1e-9 * np.abs(np.asarray(j._u)).max())
