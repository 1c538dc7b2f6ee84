"""The case ``bench`` of the port's validation driver
(``python -m navierstokes_tpu_torch.scenarios.validate bench``) against
the JAX repo's ``scripts/validate_bench.py``, with no step taken (the
bench mesh has 1,014,414 DoF):

* ``build_case("bench")`` makes the script's model: its SolverConfig
  field by field (the run paths apart), its inlet, deltat, T, checkpoint
  interval and the committed ``.bench_mesh.npz``.  The script's values
  are read from its source (its module-level assignments, evaluated with
  the JAX package's config classes and no environment), not restated;
* the statistics equal the script's (Cd_max and Cl_max over t > 0.75 T,
  St from the FFT of Cl over the last 25% of the rows, ``u_mean=1.0``)
  on a committed 2D-2 trace at the bench's dt and T;
* the driver takes the case with a checkpoint every 1,600 steps.
"""

import ast
import dataclasses
import math
import os
import types
from pathlib import Path

import numpy as np
import pytest

from navierstokes_tpu.config import InletConfig as JInlet
from navierstokes_tpu.config import SolverConfig as JConfig
from navierstokes_tpu.utils import analysis as jan
from navierstokes_tpu_torch.scenarios import validate

ROOT = Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "scripts" / "validate_bench.py"
TRACE = ROOT / "artifacts" / "st_2d2_projection_bdf2_h015_dt00125.csv"
PATHS = ("output_dir", "cache_dir", "csv_path")


def script_values():
    """validate_bench.py's module-level DT, T, RAMP, OUT_EVERY, inlet and
    cfg, evaluated from its source with an empty environment."""
    tree = ast.parse(SCRIPT.read_text())
    names = {"DT", "T", "RAMP", "RESTART", "OUT_EVERY", "CSV", "CACHE",
             "inlet", "cfg"}
    body = [node for node in tree.body if isinstance(node, ast.Assign)
            and {t.id for t in node.targets
                 if isinstance(t, ast.Name)} & names]
    env = {"os": types.SimpleNamespace(environ={}, path=os.path),
           "InletConfig": JInlet, "SolverConfig": JConfig}
    exec(compile(ast.Module(body=body, type_ignores=[]), str(SCRIPT),
                 "exec"), env)
    return env


def test_bench_case_is_the_scripts_configuration(tmp_path):
    ref = script_values()
    # the card's default dtype, on the CPU (no card here)
    ns = validate.build_case("bench", device="cpu", dtype="float32",
                             out=str(tmp_path), setup=False)
    cfg, jcfg = ns.config, ref["cfg"]
    # the script's NavierStokes(..., deltat=DT, T=T, step=OUT_EVERY)
    jcfg.deltat, jcfg.t_final, jcfg.output_step = (ref["DT"], ref["T"],
                                                   ref["OUT_EVERY"])
    port_fields = {f.name for f in dataclasses.fields(cfg)}
    checked = 0
    for f in dataclasses.fields(jcfg):
        if f.name in PATHS or f.name not in port_fields:
            continue      # run paths; TPU-only fields the port lacks
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
        checked += 1
    assert checked == len(port_fields) - len(PATHS)
    assert cfg.dtype == "float32" and cfg.scheme == "projection"
    assert (cfg.deltat, cfg.t_final, cfg.output_step) == (0.00125, 8.0, 1600)
    assert dataclasses.asdict(ns.inlet) == dataclasses.asdict(ref["inlet"])
    assert ns.inlet.ramp == 0.1 and ns.nu == 1.0e-3
    assert (ns.degree_velocity, ns.degree_pressure) == (2, 1)
    with np.load(ROOT / ".bench_mesh.npz") as z:
        mesh = ns._mesh_source
        for ours, key in (("points", "points"), ("cells", "cells"),
                          ("boundary_faces", "bfaces"),
                          ("boundary_tags", "btags")):
            np.testing.assert_array_equal(getattr(mesh, ours), z[key])
    assert not ns._is_setup


def test_bench_statistics_equal_the_scripts():
    """validate_bench.py:75-79 on a committed 2D-2 trace at dt=0.00125,
    T=8 (the JAX package's analysis, pandas)."""
    path = str(TRACE)
    df = jan.load_forces(path)
    tail = df[df["time"] > 0.75 * 8.0]
    ref = dict(cd_max=float(tail["Cd"].max()),
               cl_max=float(tail["Cl"].max()),
               st=jan.strouhal(path, skip_fraction=0.75, ref_length=0.1,
                               u_mean=1.0))
    port = validate.statistics("bench", path, 8.0)
    assert sorted(port) == sorted(ref)
    for key, value in ref.items():
        assert port[key] == pytest.approx(value, rel=1e-12), key
    assert all(math.isfinite(v) for v in port.values())
    assert "[t > 0.75 T]" in validate.stats_line("bench", port)


def test_driver_takes_the_bench_case():
    args = validate.parse_args(["bench"])
    assert args.case == "bench" and args.output_step == 1600
    assert validate.parse_args(["bench", "--output-step", "8"]
                               ).output_step == 8
    assert "bench" in validate.CASES
    for flags in (["--h", "0.05"], ["--projection"], ["--no-curved"],
                  ["--refine", "2"], ["--f-precond", "diag"]):
        with pytest.raises(SystemExit):
            validate.parse_args(["bench", *flags])
