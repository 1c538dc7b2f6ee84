"""The port's scenario registry and CLI against the JAX package's.

``list`` shows all nine scenarios and each registry entry equals JAX's
(parameters, inlet, and the mesh its generator makes at a coarse h);
``run`` writes the JAX CLI's csv, to 1e-9 of each column's largest value,
for 2d-test1 (monolithic, the default scheme) and 3d-test1 (projection)
at a coarse h in float64 on the CPU, all columns but the wall-clock
``time_prec_init`` and ``time_sol``; ``--device`` defaults to the card.
The NACA sweep and ``postprocess`` are held to JAX's in
tests/test_torch_naca.py and tests/test_torch_postprocess.py.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from navierstokes_tpu.scenarios import cli as jcli
from navierstokes_tpu.scenarios import registry as jreg
from navierstokes_tpu_torch.scenarios import cli as tcli
from navierstokes_tpu_torch.scenarios import registry as treg

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
WALL_CLOCK = ("time_prec_init", "time_sol")
CSV_TOL = 1e-9


@pytest.fixture(autouse=True)
def _no_jax_compile_cache(monkeypatch):
    """The JAX CLI's persistent compilation cache stays off in tests."""
    monkeypatch.setattr(jcli, "_enable_cache", lambda: None)


def test_list_prints_every_scenario(capsys):
    assert tcli.main(["list"]) == 0
    out = capsys.readouterr().out
    assert len(out.splitlines()) == len(jreg.SCENARIOS) == 9
    for name, sc in jreg.SCENARIOS.items():
        assert f"{name:14s} {sc.description}" in out
    listed = subprocess.run([sys.executable, "-m", "navierstokes_tpu_torch",
                             "list"], capture_output=True, text=True,
                            timeout=120, cwd=ROOT,
                            env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert listed.returncode == 0 and listed.stdout == out


def test_registry_entries_equal_jax():
    assert list(treg.SCENARIOS) == list(jreg.SCENARIOS)
    for name, j in jreg.SCENARIOS.items():
        t = treg.SCENARIOS[name]
        for f in dataclasses.fields(j):
            if f.name == "mesh_fn":
                continue
            a, b = getattr(t, f.name), getattr(j, f.name)
            if f.name == "inlet":
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == b, (name, f.name)
        h = 0.15 if j.dim == 3 else 0.12
        jm, tm = j.mesh_fn(h), t.mesh_fn(h)
        for f in ("points", "cells", "boundary_faces", "boundary_tags"):
            np.testing.assert_array_equal(getattr(tm, f), getattr(jm, f))
        assert (tm.snap_projectors is None) == (jm.snap_projectors is None)


def _run_args(tmp, csv):
    return ["--T", "0.03", "--output-step", "3", "--dtype", "float64",
            "--output-dir", os.path.join(tmp, "out"),
            "--cache-dir", os.path.join(tmp, "cache"), "--csv", csv]


@pytest.mark.parametrize("scenario,extra", [
    ("2d-test1", ["--h", "0.1"]),
    ("3d-test1", ["--h", "0.15", "--scheme", "projection"])])
def test_run_writes_the_jax_csv(tmp_path, scenario, extra):
    import jax
    jax.config.update("jax_enable_x64", True)
    j_csv, t_csv = str(tmp_path / "j.csv"), str(tmp_path / "t.csv")
    assert jcli.main(["run", scenario] + extra
                     + _run_args(str(tmp_path / "j"), j_csv)) == 0
    assert tcli.main(["run", scenario] + extra + ["--device", "cpu"]
                     + _run_args(str(tmp_path / "t"), t_csv)) == 0
    j = np.genfromtxt(j_csv, delimiter=",", names=True)
    t = np.genfromtxt(t_csv, delimiter=",", names=True)
    assert t.dtype.names == j.dtype.names and len(t) == len(j) == 3
    for col in j.dtype.names:
        if col in WALL_CLOCK:
            continue
        scale = max(np.abs(j[col]).max(), 1e-300)
        np.testing.assert_allclose(t[col], j[col], rtol=0,
                                   atol=CSV_TOL * scale, err_msg=col)
    assert os.path.exists(tmp_path / "t" / "cache" / "state-ns-3.npz")


def test_default_device_is_the_card(tmp_path):
    args = ["run", "3d-test1", "--h", "0.15", "--T", "0.01"] + _run_args(
        str(tmp_path), str(tmp_path / "f.csv"))[2:]
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device would run")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(args)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        treg.build_solver("3d-test1", h=0.15)
