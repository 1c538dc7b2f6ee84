"""The cells operator in 3D and through the CLI, against the JAX package,
in float64 on the CPU:

* the h=0.15 square-column duct (tests/test_torch_3d.py, 6,954 DoF) in
  P2/P1 with ``operator="cells"`` and aSIMPLE: 2 steps with equal FGMRES
  counts and u, p, Cd and Cl within 1e-9;
* ``run 2d-test1 --operator cells`` and ``--operator ell`` (JAX's
  node-graph operator, run on cells by the port) through both CLIs at
  h=0.1: the port's csv equals the JAX CLI's to 1e-9 of each column's
  largest value (all columns but the wall-clock ones);
* within the port, P2/P1 on cells at the default inner tolerance on the
  tests/test_torch_model.py channel: ``solve`` with restart reproduces the
  continuous run bit for bit and ``post_process`` replays the live csv's
  Cd and Cl exactly.

The first two run with the inner solves at 1e-10 (tests/test_torch_cells.py
says why); the CLIs get them through a SolverConfig subclass with those
defaults, the CLI's only way to the inner tolerance.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from navierstokes_tpu.config import InletConfig as JInlet
from navierstokes_tpu.config import SolverConfig as JConfig
from navierstokes_tpu.mesh import channel_with_cylinder_2d
from navierstokes_tpu.mesh import duct_with_box_obstacle_3d as jax_duct
from navierstokes_tpu.models.navier_stokes import NavierStokes as JaxNS
from navierstokes_tpu.scenarios import cli as jcli
from navierstokes_tpu_torch.config import InletConfig, SolverConfig
from navierstokes_tpu_torch.mesh import duct_with_box_obstacle_3d as t_duct
from navierstokes_tpu_torch.models.navier_stokes import NavierStokes as TNS
from navierstokes_tpu_torch.scenarios import cli as tcli
from test_torch_cells import TIGHT, assert_steps_match, make

torch.set_num_threads(2)
WALL_CLOCK = ("time_prec_init", "time_sol")


def _duct(cls, mesh, tmp, **dev):
    cfg = (JConfig if cls is JaxNS else SolverConfig)(
        dtype="float64", scheme="monolithic", operator="cells",
        preconditioner="asimple", ref_length=0.1, force_formula="st",
        output_dir=os.path.join(tmp, "out"),
        cache_dir=os.path.join(tmp, "cache"),
        csv_path=os.path.join(tmp, "forces.csv"), **TIGHT)
    inlet = (JInlet if cls is JaxNS else InletConfig)(
        kind="biparabolic", u_m=0.45, height=0.41)
    ns = cls(mesh, 2, 1, deltat=0.01, T=0.02, step=2, inlet=inlet,
             config=cfg, **dev)
    ns.set_re_number(20)
    return ns.setup()


def test_3d_duct_cells_steps_match_jax(tmp_path):
    jns = _duct(JaxNS, jax_duct(h=0.15), str(tmp_path / "j"))
    tns = _duct(TNS, t_duct(h=0.15), str(tmp_path / "t"), device="cpu")
    assert tns._operator == "cells" and tns.space.n_dofs == 6954
    assert tns.cells.grad.shape == (tns.mesh.n_cells, 10, 3, 4)
    assert_steps_match(jns, tns, n=2)
    assert tns._u.shape == (tns.space.n_p2, 3)


def test_cells_restart_and_post_process(tmp_path):
    """solve() with restart reproduces the continuous run bit for bit, and
    post_process() replays the live csv's Cd and Cl from the checkpoints
    (the step is a fixed-order function of the state)."""
    mesh = channel_with_cylinder_2d(h=0.1, h_near=0.04)
    kw = dict(operator="cells", T=0.04, step=2, device="cpu")
    a = make(TNS, mesh, str(tmp_path / "a"), **kw)
    a.solve()
    b = make(TNS, mesh, str(tmp_path / "b"), **kw)
    b.solve()
    c = make(TNS, mesh, str(tmp_path / "b"), **kw)
    c.solve(time_step=2)
    assert torch.equal(c._u, a._u) and torch.equal(c._p, a._p)
    assert c.time == a.time
    live = np.genfromtxt(a.config.csv_path, delimiter=",", names=True)
    replay = make(TNS, mesh, str(tmp_path / "a"), **kw).post_process(2, 4, 2)
    for ts, t, cd, cl in replay:
        assert t == pytest.approx(live["time"][ts - 1], abs=1e-15)
        assert (cd, cl) == (live["Cd"][ts - 1], live["Cl"][ts - 1])


def _tight(config_cls):
    """``config_cls`` with the TIGHT inner-solve defaults."""
    fields = [(k, float if k == "inner_tol" else int,
               dataclasses.field(default=v)) for k, v in TIGHT.items()]
    return dataclasses.make_dataclass("Tight" + config_cls.__name__, fields,
                                      bases=(config_cls,))


def _run_writes_the_jax_csv(tmp_path, monkeypatch, operator):
    """``run 2d-test1 --operator <operator>`` through both CLIs at the
    inner solves' 1e-10: the port's csv equals JAX's within 1e-9."""
    import jax
    jax.config.update("jax_enable_x64", True)
    monkeypatch.setattr(jcli, "_enable_cache", lambda: None)
    monkeypatch.setattr(jcli, "SolverConfig", _tight(jcli.SolverConfig))
    monkeypatch.setattr(tcli, "SolverConfig", _tight(tcli.SolverConfig))

    def args(tag):
        d = str(tmp_path / tag)
        return ["run", "2d-test1", "--h", "0.1", "--operator", operator,
                "--T", "0.03", "--output-step", "3", "--dtype", "float64",
                "--output-dir", os.path.join(d, "out"), "--cache-dir",
                os.path.join(d, "cache"), "--csv", os.path.join(d, "f.csv")]

    assert jcli.main(args("j")) == 0
    assert tcli.main(args("t") + ["--device", "cpu"]) == 0
    j = np.genfromtxt(tmp_path / "j" / "f.csv", delimiter=",", names=True)
    t = np.genfromtxt(tmp_path / "t" / "f.csv", delimiter=",", names=True)
    assert t.dtype.names == j.dtype.names and len(t) == len(j) == 3
    for col in j.dtype.names:
        if col in WALL_CLOCK:
            continue
        scale = max(np.abs(j[col]).max(), 1e-300)
        np.testing.assert_allclose(t[col], j[col], rtol=0, atol=1e-9 * scale,
                                   err_msg=col)
    assert (t["time_prec_init"] == 0).all()       # the diagonal F scaling
    assert os.path.exists(tmp_path / "t" / "cache" / "state-ns-3.npz")
    assert os.path.exists(tmp_path / "t" / "out" / "output-stokes_000003.vtu")


def test_run_operator_cells_writes_the_jax_csv(tmp_path, monkeypatch):
    _run_writes_the_jax_csv(tmp_path, monkeypatch, "cells")


def test_run_operator_ell_writes_the_jax_csv(tmp_path, monkeypatch):
    """JAX's node-graph operator; the port runs it on cells."""
    _run_writes_the_jax_csv(tmp_path, monkeypatch, "ell")


def test_cli_operator_help_names_the_ported_operators(capsys):
    with pytest.raises(SystemExit):
        tcli.main(["run", "--help"])
    assert "ell runs on the generic cells operator" in " ".join(
        capsys.readouterr().out.split())
