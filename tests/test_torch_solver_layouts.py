"""The JAX package's operator layouts in the port, against the JAX model
in float64 on the CPU (the options that change no function of the step;
the numerical options are in tests/test_torch_solver_options.py, whose
helpers this file takes):

* ``operator="ell"``: 2 monolithic steps of P2/P1 ``asimple`` and ``cc``
  (aSIMPLE in both packages) on the coarse channel (h=0.1, h_near=0.04)
  and of P3/P2 ``cc`` on the h=0.15 channel, against JAX's ell operator
  with the inner solves at 1e-10 (tests/test_torch_cells.py gives the
  reason), within 1e-9, equal FGMRES counts; the assembled Schur diagonal
  of ops/operators.EllCellOps equals JAX's ell one to 1e-13; projection
  on ell refused as JAX refuses it;
* ``mass_format="node"`` and ``bj_tiles="rows"`` / ``"scatter"``: 3
  projection steps on the coarse channel at ``proj_tol=1e-8``, against
  JAX under the same value, within 1e-9, equal counts.
"""

import numpy as np
import pytest
import torch

from navierstokes_tpu.mesh import channel_with_cylinder_2d
from navierstokes_tpu.models.navier_stokes import NavierStokes as JaxNS
from navierstokes_tpu_torch.models.navier_stokes import NavierStokes as TNS
from test_torch_solver_options import TIGHT, make, mesh, rel, step_both  # noqa: F401

torch.set_num_threads(2)


# ---- operator="ell" ------------------------------------------------------

@pytest.mark.parametrize("kv,kp,pc", [(2, 1, "asimple"), (2, 1, "cc"),
                                      (3, 2, "cc")],
                         ids=["p2p1-asimple", "p2p1-cc", "p3p2-cc"])
def test_ell_matches_jax(mesh, tmp_path, kv, kp, pc):
    m = mesh if kv == 2 else channel_with_cylinder_2d(h=0.15, h_near=0.06)
    kw = dict(scheme="monolithic", operator="ell", preconditioner=pc,
              **TIGHT)
    jns = make(JaxNS, m, str(tmp_path / "j"), kv, kp, **kw)
    tns = make(TNS, m, str(tmp_path / "t"), kv, kp, **kw)
    assert tns._operator == "ell" and tns.config.operator == "ell"
    assert tns._bj_plan is None and not hasattr(tns, "ell")
    # the Jacobi scale of the inner Schur solves: JAX's assembled diagonal
    w = np.random.default_rng(13).random(tns.space.n_p2)
    want = jns._ops.schur_diag(jns._params(), w)
    got = tns._ops.schur_diag(tns.cells, torch.as_tensor(w))
    assert rel(got.numpy(), want) < 1e-13
    step_both(jns, tns, 2)


def test_ell_projection_refused(mesh, tmp_path):
    """The port refuses projection on ell at setup; JAX asserts at its
    first step."""
    with pytest.raises(ValueError, match="requires operator='bsr'"):
        make(TNS, mesh, str(tmp_path / "t"), scheme="projection",
             operator="ell")
    jns = make(JaxNS, mesh, str(tmp_path / "j"), scheme="projection",
               operator="ell")
    with pytest.raises(AssertionError, match="requires operator='bsr'"):
        jns.solve_time_step()


# ---- the mass and tile layouts ------------------------------------------

LAYOUTS = {"mass-node": dict(mass_format="node"),
           "tiles-rows": dict(bj_tiles="rows"),
           "tiles-scatter": dict(bj_tiles="scatter")}


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_layouts_match_jax_projection(mesh, tmp_path, name):
    kw = dict(scheme="projection", proj_tol=1e-8, **LAYOUTS[name])
    jns = make(JaxNS, mesh, str(tmp_path / "j"), **kw)
    tns = make(TNS, mesh, str(tmp_path / "t"), **kw)
    step_both(jns, tns, 3)
