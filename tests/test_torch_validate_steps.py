"""Two float64 steps of each Schaefer-Turek case of the port's validation
driver against the JAX model that ``scripts/validate_st.py`` builds, on
the CPU at a coarse mesh: 2d1 monolithic, 2d2 projection BDF2 (the
north-star run's scheme) and 3d1 projection with the diagonal F
preconditioner.  Equal iteration counts; u and p within 1e-9 of their
largest entry, Cd and Cl within 1e-9 of the force scale.

The 2d2 projection step at its relative tolerance of 1e-4 amplifies
round-off: the port and JAX differ by 1.3e-11 in u after one step and by
1.6e-9 after two at h=0.05 (and 1.5e-9 at h=0.06), the order in which
each sums its products being the only difference.  With both sub-solves
at 1e-8 the gap is 1e-12, so the 2d2 case runs both models at
``proj_tol=1e-8``; everything else is the script's configuration.
"""

import numpy as np
import pytest
import torch

from navierstokes_tpu_torch.scenarios import validate
from test_torch_validate import COARSE, jax_case

torch.set_num_threads(2)
STEP_TOL = 1e-9


def _rel(a, b):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("case,projection,f_precond,fields", [
    ("2d1", False, "bj", {}), ("2d2", True, "bj", dict(proj_tol=1e-8)),
    ("3d1", True, "diag", {})])
def test_two_steps_match_jax(tmp_path, case, projection, f_precond, fields):
    kw = COARSE[case]
    jns = jax_case(case, str(tmp_path / "j"), projection=projection,
                   f_precond=f_precond, **kw, **fields)
    tns = validate.build_case(case, device="cpu", projection=projection,
                              f_precond=f_precond, out=str(tmp_path / "t"),
                              **kw, **fields)
    assert tns.config.dtype == "float64"
    for _ in range(2):
        jm, tm = jns.solve_time_step(), tns.solve_time_step()
        assert tm.iterations == int(jm.iterations)
        assert tm.converged
        assert _rel(tns._u, jns._u) < STEP_TOL
        assert _rel(tns._p, jns._p) < STEP_TOL
        scale = max(abs(float(jm.cd)), abs(float(jm.cl)))
        assert abs(tm.cd - float(jm.cd)) <= STEP_TOL * scale
        assert abs(tm.cl - float(jm.cl)) <= STEP_TOL * scale
        assert tns.time == pytest.approx(jns.time, abs=1e-15)
