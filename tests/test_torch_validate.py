"""The port's validation driver and scenario campaign against the JAX
repo's ``scripts/validate_st.py`` and ``scripts/run_scenarios.py``.

``validate.build_case`` gives each case the configuration the JAX script
builds (nu, dt, T, inlet, wake levels, mesh, every shared SolverConfig
field and the DoF count) at a coarse mesh; the statistics of the
committed JAX traces equal the JAX script's formulas computed with the
JAX package's ``utils.analysis``; the campaign's ``tail_stats`` equals
``scripts/run_scenarios.tail_stats`` on every committed campaign trace; a
``--restart-step`` leg merged with its first leg gives the rows of one
continuous run.  The two-step float64 parity of each case is in
tests/test_torch_validate_steps.py.  The JAX script parses its arguments
and starts JAX at import, so the JAX models are built here with its
arguments.
"""

import dataclasses
import importlib.util
import json
import math
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from navierstokes_tpu.config import InletConfig as JInlet
from navierstokes_tpu.config import SolverConfig as JConfig
from navierstokes_tpu.mesh import channel_with_cylinder_2d as j_channel
from navierstokes_tpu.mesh import duct_with_box_obstacle_3d as j_duct
from navierstokes_tpu.models.navier_stokes import NavierStokes as JaxNS
from navierstokes_tpu.utils import analysis as jan
from navierstokes_tpu_torch.scenarios import campaign, validate

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
ART = ROOT / "artifacts"
MESH_ARRAYS = ("points", "cells", "boundary_faces", "boundary_tags")
# coarse meshes of the construction checks
COARSE = {"2d1": dict(h=0.07), "2d2": dict(h=0.07),
          "3d1": dict(h=0.1, h_near=0.04)}
# wall-clock columns of the csv
WALL_CLOCK = (3, 4)


def jax_case(case, tmp, h, h_near=None, h_z=None, projection=False,
             f_precond="bj", refine=0, dtype="float64", T=None,
             proj_poisson="laplacian", **fields):
    """The JAX model as scripts/validate_st.py:60-126 builds it (the
    script's ``--cpu`` run in float64), set up; ``fields`` set further
    SolverConfig fields."""
    if case == "3d1":
        mesh = j_duct(h=h, h_near=h_near, h_z=h_z)
        inlet = JInlet(kind="biparabolic", u_m=0.45, height=0.41)
        dt, T0 = 0.01, 3.0
    else:
        wl = 1 if case == "2d2" else 0
        mesh = j_channel(h=h, h_near=h_near or h / 3, wake_levels=wl)
        inlet = JInlet(kind="parabolic", u_m=0.3 if case == "2d1" else 1.5,
                       height=0.41)
        dt, T0 = (0.01, 6.0) if case == "2d1" else (0.0025, 8.0)
    cfg = JConfig(dtype=dtype, nu=1.0e-3, ref_length=0.1,
                  force_formula="st",
                  scheme="projection" if projection else "monolithic",
                  refine=refine, f_precond=f_precond, proj_f_maxiter=100,
                  proj_p_maxiter=50, curved_boundary=True, bsr_block=0,
                  proj_poisson=proj_poisson, steps_per_chunk=0,
                  output_dir=os.path.join(tmp, "out"),
                  cache_dir=os.path.join(tmp, "cache"),
                  csv_path=os.path.join(tmp, "forces.csv"),
                  inner_maxiter_f=10, **fields)
    ns = JaxNS(mesh, 2, 1, deltat=dt, T=T0 if T is None else T, step=400,
               inlet=inlet, config=cfg)
    ns.setup()
    return ns


@pytest.mark.parametrize("case,projection,f_precond", [
    ("2d1", False, "bj"), ("2d2", True, "bj"), ("3d1", True, "diag")])
def test_build_case_is_the_jax_scripts_configuration(tmp_path, case,
                                                     projection, f_precond):
    kw = COARSE[case]
    jns = jax_case(case, str(tmp_path / "j"), projection=projection,
                   f_precond=f_precond, **kw)
    tns = validate.build_case(case, device="cpu", dtype="float64",
                              projection=projection, f_precond=f_precond,
                              out=str(tmp_path / "t"), **kw)
    assert tns.space.n_dofs == jns.space.n_dofs
    assert tns.nu == jns.nu == 1.0e-3
    assert dataclasses.asdict(tns.inlet) == dataclasses.asdict(jns.inlet)
    paths = ("output_dir", "cache_dir", "csv_path")
    shared = ({f.name for f in dataclasses.fields(JConfig)}
              & {f.name for f in dataclasses.fields(tns.config)})
    for name in sorted(shared - set(paths)):
        assert getattr(tns.config, name) == getattr(jns.config, name), name
    for name in MESH_ARRAYS:
        np.testing.assert_array_equal(getattr(tns.mesh, name),
                                      getattr(jns.mesh, name))
    assert (tns.config.deltat, tns.config.t_final) == {
        "2d1": (0.01, 6.0), "2d2": (0.0025, 8.0), "3d1": (0.01, 3.0)}[case]
    assert tns.config.output_step == 400
    assert tns.device == torch.device("cpu")


def test_proj_poisson_flag_is_the_jax_scripts(tmp_path):
    """``--proj-poisson schur`` (scripts/validate_st.py:49,118) reaches the
    model: the configuration and the exact projection's pin set equal the
    JAX script's; the bench case, which fixes its solver, refuses it."""
    args = validate.parse_args(["2d2", "--projection", "--proj-poisson",
                                "schur", "--device", "cpu"])
    assert args.proj_poisson == "schur"
    jns = jax_case("2d2", str(tmp_path / "j"), projection=True,
                   proj_poisson="schur", **COARSE["2d2"])
    tns = validate.build_case("2d2", device="cpu", dtype="float64",
                              projection=True,
                              proj_poisson=args.proj_poisson,
                              out=str(tmp_path / "t"), **COARSE["2d2"])
    assert tns.config.proj_poisson == jns.config.proj_poisson == "schur"
    np.testing.assert_array_equal(tns._ap_schur_pin.numpy(),
                                  np.asarray(jns._ap_schur_pin))
    with pytest.raises(SystemExit):
        validate.parse_args(["bench", "--proj-poisson", "schur"])


def test_wake_levels_and_p3_case():
    """2d2 adds one wake level (the mesh of wake_levels=1), 2d1 none;
    ``degree=3`` is the 2D-1 P3/P2 case on cells with FGMRES unrestarted
    within OUTER_MAXITER_2D1; other cases refuse it."""
    m2 = validate.case_mesh("2d2", h=0.05)
    np.testing.assert_array_equal(
        m2.points, j_channel(h=0.05, h_near=0.05 / 3, wake_levels=1).points)
    m1 = validate.case_mesh("2d1", h=0.05)
    np.testing.assert_array_equal(m1.points, j_channel(
        h=0.05, h_near=0.05 / 3, wake_levels=0).points)
    assert m2.n_cells > m1.n_cells
    ns = validate.build_case("2d1", device="cpu", h=0.1, degree=3,
                             setup=False)
    assert (ns.degree_velocity, ns.degree_pressure) == (3, 2)
    assert (ns.config.outer_maxiter, ns.config.outer_restart) == (
        validate.OUTER_MAXITER_2D1,) * 2
    assert ns.config.dtype == "float64"
    p2 = validate.build_case("2d1", device="cpu", h=0.1, setup=False)
    assert (p2.config.outer_maxiter, p2.config.outer_restart) == (
        JConfig.outer_maxiter, JConfig.outer_restart)
    with pytest.raises(ValueError):
        validate.build_case("2d2", device="cpu", h=0.1, degree=3,
                            setup=False)


def test_3d1_case_is_the_registrys_3d_test1_at_nu_1e3():
    """``chip_smoke.py`` phase 10 built 3D-1Z through the registry's
    3d-test1 (``set_re_number(20)``) and now builds it here: the same
    inlet and mesh, and nu=1e-3 set directly, which the registry reaches
    to one rounding (0.2 * 0.1 / 20)."""
    from navierstokes_tpu_torch.config import SolverConfig
    from navierstokes_tpu_torch.scenarios.registry import build_solver
    reg = build_solver("3d-test1", h=0.1, config=SolverConfig(
        dtype="float64", ref_length=0.1), mesh_kwargs=dict(h_near=0.04),
        device="cpu")
    case = validate.build_case("3d1", device="cpu", h=0.1, h_near=0.04,
                               setup=False)
    assert dataclasses.asdict(case.inlet) == dataclasses.asdict(reg.inlet)
    assert case.nu == 1.0e-3
    assert reg.nu == pytest.approx(case.nu, rel=3e-16)
    for name in MESH_ARRAYS:
        np.testing.assert_array_equal(getattr(case._mesh_source, name),
                                      getattr(reg._mesh_source, name))
    assert (case.config.deltat, case.config.t_final) == (0.01, 3.0)


def test_cuda_is_the_default_device(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        validate.main(["2d2", "--h", "0.1", "--T", "0.0025", "--out",
                       str(tmp_path)])
    args = validate.parse_args(["3d1"])
    assert (args.device, args.dtype, args.output_step) == ("cuda", None, 400)


def _jax_stats(case, path):
    """validate_st.py:135-159 on ``path``, with the JAX package's
    analysis (pandas)."""
    df = jan.load_forces(path)
    n = len(df)
    tail = df.iloc[int(n * 0.6):]
    if case == "2d1":
        settled = df.iloc[int(n * 0.9):]
        return dict(cd=float(settled["Cd"].mean()),
                    cl=float(settled["Cl"].mean()))
    if case == "3d1":
        return dict(cd=float(tail["Cd"].mean()), cl=float(tail["Cl"].mean()))
    return dict(cd_max=float(tail["Cd"].max()),
                cl_max=float(tail["Cl"].max()),
                st=jan.strouhal(path, ref_length=0.1,
                                u_mean=2.0 * 1.5 / 3.0))


@pytest.mark.parametrize("case,name", [
    ("2d1", "st_2d1_tpu_fp32_refine2_h010_T6.csv"),
    ("2d1", "st_2d1_monolithic_f64_h010.csv"),
    ("2d2", "st_2d2_projection_bdf2_h015_dt00125.csv"),
    ("2d2", "st_2d2_monolithic_h015_dt00003125.csv"),
    ("3d1", "st_3d1_projection_34M_h023.csv"),
    ("3d1", "st_3d1_projection_h030.csv")])
def test_statistics_equal_the_jax_scripts(case, name):
    path = str(ART / name)
    port, ref = validate.statistics(case, path), _jax_stats(case, path)
    assert sorted(port) == sorted(ref)
    for key, value in ref.items():
        assert port[key] == pytest.approx(value, rel=1e-12, abs=1e-15), key
    assert all(math.isfinite(v) for v in port.values())


def _run_scenarios():
    spec = importlib.util.spec_from_file_location(
        "run_scenarios", ROOT / "scripts" / "run_scenarios.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["2d-test3", "3d-test2", "3d-test3",
                                  "3d-cylinder"])
def test_tail_stats_equal_run_scenarios(name):
    ref = _run_scenarios()
    assert campaign.CAMPAIGN == ref.CAMPAIGN
    path = str(ART / f"scenario_{name}.csv")
    pulsating = "test3" in name
    assert campaign.tail_stats(path, pulsating) == \
        ref.tail_stats(path, pulsating)


def test_campaign_runs_the_cli_and_archives(tmp_path, capsys, monkeypatch):
    """Two steps of 3d-cylinder at h=0.15 through the port's CLI on the CPU:
    the csv is archived under its new name with the tail summary; a run
    that fails is recorded with its exit code and not archived."""
    art, work = tmp_path / "art", tmp_path / "work"
    extra, tmo = campaign.CAMPAIGN["3d-cylinder"]
    monkeypatch.setitem(campaign.CAMPAIGN, "3d-cylinder",
                        (extra + ["--h", "0.15", "--T", "0.02"], tmo))
    cmd, _ = campaign.run_command("3d-cylinder", str(work), "cpu")
    assert cmd[3:6] == ["navierstokes_tpu_torch", "run", "3d-cylinder"]
    assert cmd[cmd.index("--device") + 1] == "cpu"
    rc = campaign.main(["3d-cylinder", "--device", "cpu", "--artifacts",
                        str(art), "--work", str(work)])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    s = summary["3d-cylinder"]
    assert s["rc"] == 0 and s["rows"] == 2 and s["finite"]
    dst = art / "torch_scenario_3d-cylinder.csv"
    assert (dst.read_text() == (work / "3d-cylinder" / "forces.csv")
            .read_text())
    assert s["cd_tail_mean"] == campaign.tail_stats(str(dst))["cd_tail_mean"]
    rc = campaign.main(["3d-cylinder", "--device", "nope", "--artifacts",
                        str(tmp_path / "art2"), "--work", str(work)])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 1 and summary["3d-cylinder"]["rc"] != 0
    assert not (tmp_path / "art2" / "torch_scenario_3d-cylinder.csv").exists()


def _rows(path):
    """The csv's rows without the wall-clock columns, as text."""
    lines = Path(path).read_text().splitlines()
    return [",".join(v for k, v in enumerate(ln.split(","))
                     if k not in WALL_CLOCK) for ln in lines]


def test_restart_leg_merges_to_the_continuous_run(tmp_path, capsys):
    """2d2 projection at h=0.05, float64 on the CPU: one run of 6 steps
    against a first leg cut after step 5 and a second leg from the
    checkpoint of step 3; the merged trace equals the continuous one in
    every column but the wall-clock ones, bit for bit, and the statistics
    come from the merged trace."""
    base = ["2d2", "--projection", "--h", "0.05", "--device", "cpu",
            "--output-step", "3"]
    whole, split = tmp_path / "whole", tmp_path / "split"
    assert validate.main(base + ["--T", "0.015", "--out", str(whole)]) == 0
    capsys.readouterr()
    assert validate.main(base + ["--T", "0.0125", "--out", str(split)]) == 0
    capsys.readouterr()
    assert validate.main(base + ["--T", "0.015", "--out", str(split),
                                 "--restart-step", "3", "--csv",
                                 str(tmp_path / "merged.csv")]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["steps"] == 3 and last["restart_step"] == 3
    assert len(_rows(split / "forces_0.csv")) == 6
    assert len(_rows(split / "forces_3.csv")) == 4
    expect = _rows(whole / "forces.csv")
    assert len(expect) == 7
    assert _rows(split / "forces.csv") == expect
    assert _rows(tmp_path / "merged.csv") == expect
    assert last["stats"] == validate.statistics("2d2",
                                                str(whole / "forces.csv"))
    assert validate.merge_legs(str(split), 7) is None


def test_merge_legs_counts_steps_by_row(tmp_path):
    """Legs are merged by row, not by time: an fp32 run's time column
    drifts by more than half a step (2D-2 at dt=0.0003125 reaches
    t=7.9981 at step 25,600).  A later leg replaces the earlier rows from
    its restart step on, also where the earlier leg ran further."""
    header = "time,deltat,GMRES_iters,time_prec_init,time_sol,Drag,Lift,Cd,Cl"
    dt = 0.0003125

    def leg(start, n, tag):
        rows = [f"{(start + k) * dt * 0.9!r},{dt},1,0,0,0,0,{tag},{k}"
                for k in range(1, n + 1)]
        (tmp_path / f"forces_{start}.csv").write_text(
            "\n".join([header] + rows) + "\n")
        return rows

    first = leg(0, 5, 1.0)
    assert validate.merge_legs(str(tmp_path), 8) is None
    second = leg(3, 5, 2.0)
    merged = validate.merge_legs(str(tmp_path), 8)
    assert Path(merged).read_text().splitlines() == (
        [header] + first[:3] + second)
