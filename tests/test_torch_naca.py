"""The port's NACA airfoil family against the JAX package's: the analytic
section, the airfoil transforms and the .geo text equal JAX's exactly; the
NACA channel meshes are identical (points, cells, boundary faces, tags) at
0 and 8 degrees, at h=0.1 and at the scenario's default h=0.02; three
monolithic ``cc`` steps of ``2d-naca`` at h=0.1, 8 degrees, float64, equal
JAX's (equal FGMRES counts; u, p, Cd and Cl within 1e-9); the
``sweep-naca`` csvs equal the JAX CLI's column by column; and the msh
writers round-trip between the packages.
"""

import os

import numpy as np
import pytest
import torch

from navierstokes_tpu.config import SolverConfig as JCfg
from navierstokes_tpu.mesh import airfoil as JA
from navierstokes_tpu.mesh import msh_io as JM
from navierstokes_tpu.scenarios import cli as jcli
from navierstokes_tpu.scenarios import registry as jreg
from navierstokes_tpu_torch.config import SolverConfig as TCfg
from navierstokes_tpu_torch.mesh import airfoil as TA
from navierstokes_tpu_torch.mesh import msh_io as TM
from navierstokes_tpu_torch.scenarios import cli as tcli
from navierstokes_tpu_torch.scenarios import registry as treg

torch.set_num_threads(2)
MESH_FIELDS = ("points", "cells", "boundary_faces", "boundary_tags")
CSV_TOL = 1e-9
WALL_CLOCK = ("time_prec_init", "time_sol")


@pytest.fixture(autouse=True)
def _no_jax_compile_cache(monkeypatch):
    """The JAX CLI's persistent compilation cache stays off in tests."""
    monkeypatch.setattr(jcli, "_enable_cache", lambda: None)


def _same_mesh(a, b):
    for f in MESH_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)


@pytest.mark.parametrize("code,n", [("2408", 40), ("2412", 40),
                                    ("0012", 25)])
def test_polyline_equals_jax(code, n):
    np.testing.assert_array_equal(TA.naca4_polyline(code, n),
                                  JA.naca4_polyline(code, n))


def test_airfoil_transforms_and_geo_equal_jax(tmp_path):
    dat = tmp_path / "naca.dat"
    pts = JA.naca4_polyline("2408") + [0.5, 0.0]
    dat.write_text("NACA 2408\n" + "\n".join(f"{x:.6f} {y:.6f}"
                                              for x, y in pts) + "\n")
    j, t = JA.NacaAirfoil.from_dat(str(dat)), TA.NacaAirfoil.from_dat(
        str(dat))
    assert t.name == j.name == "NACA 2408"
    for a in (j, t):
        a.resize(0.4)
        a.rotate(np.radians(4.0))
    np.testing.assert_array_equal(t.points, j.points)
    assert (t.chord, t.angle) == (j.chord, j.angle)
    j.write_geo(str(tmp_path / "j.geo"), h=0.02)
    t.write_geo(str(tmp_path / "t.geo"), h=0.02)
    assert (tmp_path / "t.geo").read_text() == (tmp_path / "j.geo").read_text()
    np.testing.assert_array_equal(TA.load_airfoil(str(dat), 0.4, 8.0),
                                  JA.load_airfoil(str(dat), 0.4, 8.0))


@pytest.mark.parametrize("h", [0.1, 0.02])
@pytest.mark.parametrize("angle", [0.0, 8.0])
def test_naca_mesh_identical_to_jax(h, angle):
    tm = treg.get_scenario("2d-naca").mesh_fn(h, angle_deg=angle)
    jm = jreg.get_scenario("2d-naca").mesh_fn(h, angle_deg=angle)
    _same_mesh(tm, jm)
    assert set(tm.boundary_tags.tolist()) == {0, 1, 2, 3, 4}


@pytest.mark.parametrize("version", ["ascii", "2.2", "4.1"])
def test_msh_writers_round_trip_between_packages(tmp_path, version):
    """A mesh the port writes, JAX reads equal to the port's reading, and
    the reverse; both packages write the same bytes.  Binary files keep
    the points exactly, ASCII ones to the 16 digits they print."""
    mesh = treg.get_scenario("2d-naca").mesh_fn(0.1, angle_deg=2.0)
    for writer, tag in ((TM, "t"), (JM, "j")):
        path = str(tmp_path / f"{tag}.msh")
        if version == "ascii":
            writer.write_msh(mesh, path)
        else:
            writer.write_msh_binary(mesh, path, version=version)
        back = TM.read_msh(path)
        _same_mesh(back, JM.read_msh(path))
        np.testing.assert_array_equal(back.cells, mesh.cells)
        np.testing.assert_allclose(back.points, mesh.points, rtol=0,
                                   atol=1e-15 if version == "ascii" else 0)
        # the readers group the faces by tag
        faces = lambda m: np.unique(np.column_stack(
            [m.boundary_tags, m.boundary_faces]), axis=0)
        np.testing.assert_array_equal(faces(back), faces(mesh))
    assert (tmp_path / "t.msh").read_bytes() == (tmp_path / "j.msh").read_bytes()


def _cfg(cls, tmp, **kw):
    return cls(dtype="float64", output_dir=os.path.join(tmp, "out"),
               cache_dir=os.path.join(tmp, "cache"),
               csv_path=os.path.join(tmp, "forces.csv"), **kw)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def test_naca_steps_match_jax(tmp_path):
    """Three monolithic cc steps of 2d-naca (h=0.1, 8 degrees) in
    float64: equal FGMRES counts, u, p, Cd, Cl within 1e-9."""
    kw = dict(h=0.1, mesh_kwargs={"angle_deg": 8.0})
    jns = jreg.build_solver("2d-naca", config=_cfg(JCfg, str(tmp_path / "j")),
                            **kw).setup()
    tns = treg.build_solver("2d-naca", config=_cfg(TCfg, str(tmp_path / "t")),
                            device="cpu", **kw).setup()
    assert tns.space.n_dofs == jns.space.n_dofs
    for _ in range(3):
        jm, tm = jns.solve_time_step(), tns.solve_time_step()
        assert tm.iterations == int(jm.iterations) and tm.converged
        assert _rel(tns._u.numpy(), jns._u) < 1e-9
        assert _rel(tns._p.numpy(), jns._p) < 1e-9
        scale = max(abs(float(jm.cd)), abs(float(jm.cl)))
        assert abs(tm.cd - float(jm.cd)) <= 1e-9 * scale
        assert abs(tm.cl - float(jm.cl)) <= 1e-9 * scale


def test_sweep_csvs_equal_jax_cli(tmp_path, monkeypatch):
    import jax
    jax.config.update("jax_enable_x64", True)
    args = ["sweep-naca", "--angles", "2", "8", "--h", "0.1", "--T", "0.03",
            "--output-step", "3", "--dtype", "float64"]
    for tag, main, extra in (("j", jcli.main, []),
                             ("t", tcli.main, ["--device", "cpu"])):
        d = tmp_path / tag
        d.mkdir()
        monkeypatch.chdir(d)
        assert main(args + extra + ["--output-dir", str(d / "out"),
                                    "--cache-dir", str(d / "cache")]) == 0
    for angle in ("2", "8"):
        j = np.genfromtxt(tmp_path / "j" / f"output_{angle}.csv",
                          delimiter=",", names=True)
        t = np.genfromtxt(tmp_path / "t" / f"output_{angle}.csv",
                          delimiter=",", names=True)
        assert t.dtype.names == j.dtype.names and len(t) == len(j) == 3
        for col in j.dtype.names:
            if col in WALL_CLOCK:
                continue
            scale = max(np.abs(j[col]).max(), 1e-300)
            np.testing.assert_allclose(t[col], j[col], rtol=0,
                                       atol=CSV_TOL * scale,
                                       err_msg=f"{angle}: {col}")
    assert os.path.exists(tmp_path / "t" / "cache" / "state-ns-3.npz")
