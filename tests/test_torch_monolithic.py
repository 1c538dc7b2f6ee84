"""The port's monolithic step against the JAX model, float64, on the
tests/test_torch_model.py cylinder channel (h=0.1, h_near=0.04, Re=20,
dt=0.01): 3 steps with each block preconditioner, per-step FGMRES
iteration counts equal, u and p within 1e-9 relative, Cd and Cl within
1e-9 of the force scale max(|Cd|, |Cl|).

Measured differences over the 3 steps: at most 5e-11 (cc, pcd, asimple,
ayosida).  ``identity`` runs to the 200-iteration budget without
converging; GMRES(64)'s stagnating restart cycles amplify the two
libraries' last-bit differences to 1.8e-9 in Cd by step 3, so that case
runs its 200 iterations as one Arnoldi cycle (``outer_restart=200``),
where the two agree to 5e-12.
"""

import os

import numpy as np
import pytest
import torch

from navierstokes_tpu.config import InletConfig, SolverConfig
from navierstokes_tpu.mesh import channel_with_cylinder_2d
from navierstokes_tpu.models.navier_stokes import NavierStokes as JaxNS
from navierstokes_tpu_torch.models.navier_stokes import NavierStokes as TNS

torch.set_num_threads(2)
PRECONDITIONERS = {"cc": {}, "pcd": {}, "asimple": {}, "ayosida": {},
                   "identity": dict(outer_restart=200)}


@pytest.fixture(scope="module")
def mesh():
    return channel_with_cylinder_2d(h=0.1, h_near=0.04)


def make(cls, mesh, tmp, T=0.03, step=3, **kw):
    """The fixture model, monolithic float64 unless ``kw`` says else."""
    dev = {"device": kw.pop("device")} if "device" in kw else {}
    kw.setdefault("scheme", "monolithic")
    kw.setdefault("dtype", "float64")
    inlet = InletConfig(kind="parabolic", u_m=0.3, height=0.41)
    cfg = SolverConfig(output_dir=os.path.join(tmp, "out"),
                       cache_dir=os.path.join(tmp, "cache"),
                       csv_path=os.path.join(tmp, "forces.csv"), **kw)
    ns = cls(mesh, 2, 1, deltat=0.01, T=T, step=step, inlet=inlet,
             config=cfg, **dev)
    ns.set_re_number(20)
    return ns


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("pc", sorted(PRECONDITIONERS))
def test_monolithic_steps_match_jax(mesh, tmp_path, pc):
    kw = dict(preconditioner=pc, **PRECONDITIONERS[pc])
    jns = make(JaxNS, mesh, str(tmp_path / "j"), **kw).setup()
    tns = make(TNS, mesh, str(tmp_path / "t"), device="cpu", **kw).setup()
    for _ in range(3):
        jm = jns.solve_time_step()
        tm = tns.solve_time_step()
        assert tm.iterations == int(jm.iterations)
        assert rel(tns._u.numpy(), jns._u) < 1e-9
        assert rel(tns._p.numpy(), jns._p) < 1e-9
        scale = max(abs(float(jm.cd)), abs(float(jm.cl)))
        assert abs(tm.cd - float(jm.cd)) <= 1e-9 * scale
        assert abs(tm.cl - float(jm.cl)) <= 1e-9 * scale
        assert tm.residual == pytest.approx(float(jm.residual), rel=1e-6)
        assert tns.time == pytest.approx(jns.time, abs=1e-15)
    # phi passes through the monolithic step unchanged
    assert not tns._phi.any()
