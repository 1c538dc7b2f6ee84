"""The port's generic element ("cells") operator path of NavierStokes
against the JAX model: P2/P1 with ``operator="cells"`` on the
tests/test_torch_model.py cylinder channel (h=0.1, h_near=0.04, its P2
midside nodes snapped onto the cylinder), Re=20, dt=0.01, in float64.

The cells step is sensitive to round-off at the default inner tolerance
(1e-2): its Schur solves are Jacobi-BiCGStab, whose stopping point and
iterates are not smooth functions of their input.  Perturbing the port's
A0 by 1e-15 relative moves u by 2.1e-6 after one step and changes the
FGMRES counts (24 against 23); the port and JAX, whose operators agree to
3e-16, differ by as much (measured 1.1e-6, 23 against 24).  The parity
runs therefore take the inner solves to 1e-10 (``TIGHT``), where the
preconditioner is close to a fixed linear map: there the same 1e-15
perturbation moves u and p by at most 6e-12 over 3 steps with equal
counts, and the limits below are 1e-9.  The default tolerance is held at
step 1 only, to 1e-5 and one iteration.

Also: the fallbacks of the JAX model (``cc`` and ``pcd`` run aSIMPLE, the
diagonal F preconditioner, no refinement, no V-cycle), projection refused
at setup, and the options once refused on this path (``bj_tiles``,
``operator="ell"``) against JAX.
"""

import os

import numpy as np
import pytest
import torch

from navierstokes_tpu.config import InletConfig as JInlet
from navierstokes_tpu.config import SolverConfig as JConfig
from navierstokes_tpu.mesh import channel_with_cylinder_2d
from navierstokes_tpu.models.navier_stokes import NavierStokes as JaxNS
from navierstokes_tpu_torch.config import InletConfig, SolverConfig
from navierstokes_tpu_torch.models.navier_stokes import NavierStokes as TNS

torch.set_num_threads(2)
TIGHT = dict(inner_tol=1e-10, inner_maxiter_f=1000, inner_maxiter_s=1000)
STEP_TOL = 1e-9


@pytest.fixture(scope="module")
def mesh():
    return channel_with_cylinder_2d(h=0.1, h_near=0.04)


def make(cls, mesh, tmp, kv=2, kp=1, T=0.03, step=3, **kw):
    """A set-up model of either package (``device`` for the port)."""
    dev = {"device": kw.pop("device")} if "device" in kw else {}
    kw.setdefault("scheme", "monolithic")
    kw.setdefault("dtype", "float64")
    jax_side = cls is JaxNS
    cfg = (JConfig if jax_side else SolverConfig)(
        output_dir=os.path.join(tmp, "out"),
        cache_dir=os.path.join(tmp, "cache"),
        csv_path=os.path.join(tmp, "forces.csv"), **kw)
    inlet = (JInlet if jax_side else InletConfig)(kind="parabolic", u_m=0.3,
                                                  height=0.41)
    ns = cls(mesh, kv, kp, deltat=0.01, T=T, step=step, inlet=inlet,
             config=cfg, **dev)
    ns.set_re_number(20)
    return ns.setup()


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def assert_steps_match(jns, tns, n=3, tol=STEP_TOL, its=0):
    """``n`` steps of each: FGMRES counts within ``its``, u and p within
    ``tol`` relative, Cd and Cl within ``tol`` of max(|Cd|, |Cl|)."""
    for _ in range(n):
        jm, tm = jns.solve_time_step(), tns.solve_time_step()
        assert abs(tm.iterations - int(jm.iterations)) <= its
        assert tm.converged and tm.prec_seconds == 0.0
        assert rel(tns._u.numpy(), jns._u) < tol
        assert rel(tns._p.numpy(), jns._p) < tol
        scale = max(abs(float(jm.cd)), abs(float(jm.cl)))
        assert abs(tm.cd - float(jm.cd)) <= tol * scale
        assert abs(tm.cl - float(jm.cl)) <= tol * scale
        assert tns.time == pytest.approx(jns.time, abs=1e-15)


@pytest.mark.parametrize("kw", [
    dict(preconditioner="asimple"), dict(preconditioner="ayosida"),
    dict(preconditioner="cc"), dict(preconditioner="pcd"),
    dict(preconditioner="asimple", refine=2)],
    ids=["asimple", "ayosida", "cc", "pcd", "refine2"])
def test_p2p1_cells_steps_match_jax(mesh, tmp_path, kw):
    """3 steps with equal FGMRES counts.  ``cc`` and ``pcd`` run aSIMPLE
    in both packages; ``refine`` does nothing on cells."""
    kw = dict(operator="cells", **TIGHT, **kw)
    jns = make(JaxNS, mesh, str(tmp_path / "j"), **kw)
    tns = make(TNS, mesh, str(tmp_path / "t"), device="cpu", **kw)
    assert tns._operator == "cells" and tns.config.operator == "cells"
    assert tns.space.curved_data() is not None        # snapped cylinder
    assert tns.cells.curv_ids is not None
    assert tns._bj_plan is None and tns._ell64 is None
    assert not hasattr(tns, "ell") and not hasattr(tns, "_coarse_plan")
    assert_steps_match(jns, tns)


def test_cells_default_inner_tolerance_first_step(mesh, tmp_path):
    """The default inner tolerance: step 1 within 1e-5 and one FGMRES
    iteration of JAX's (the round-off sensitivity measured above)."""
    jns = make(JaxNS, mesh, str(tmp_path / "j"), operator="cells")
    tns = make(TNS, mesh, str(tmp_path / "t"), operator="cells",
               device="cpu")
    assert_steps_match(jns, tns, n=1, tol=1e-5, its=1)


def test_cells_refine_does_nothing_in_fp32(mesh, tmp_path):
    """fp32 with refine=2 is the refine=0 run bit for bit (the JAX model
    refines on the bsr operator only)."""
    runs = []
    for refine in (0, 2):
        ns = make(TNS, mesh, str(tmp_path / f"r{refine}"), dtype="float32",
                  operator="cells", refine=refine, device="cpu")
        ms = [ns.solve_time_step() for _ in range(2)]
        runs.append((ns, ms))
    (a, ma), (b, mb) = runs
    assert torch.equal(a._u, b._u) and torch.equal(a._p, b._p)
    assert [m.iterations for m in ma] == [m.iterations for m in mb]
    assert [m.residual for m in ma] == [m.residual for m in mb]


@pytest.mark.parametrize("kv,kp,kw", [
    (2, 1, dict(operator="cells")), (3, 2, dict())],
    ids=["p2p1-cells", "p3p2"])
def test_projection_on_cells_refused(mesh, tmp_path, kv, kp, kw):
    """The port refuses the projection scheme on the cells operator at
    setup; the JAX model asserts at its first step."""
    with pytest.raises(ValueError, match="requires operator='bsr'"):
        make(TNS, mesh, str(tmp_path / "t"), kv, kp, scheme="projection",
             device="cpu", **kw)
    jns = make(JaxNS, mesh, str(tmp_path / "j"), kv, kp,
               scheme="projection", **kw)
    with pytest.raises(AssertionError, match="requires operator='bsr'"):
        jns.solve_time_step()


@pytest.mark.parametrize("option,value", [("bj_tiles", "rows"),
                                          ("operator", "ell")])
def test_unported_options_raise_on_cells(mesh, tmp_path, option, value):
    """Options the port once refused on the cells path now run: P2/P1
    under each, one step against JAX under the same value (``bj_tiles``
    does nothing off bsr; ``ell`` is JAX's node-graph operator) with the
    equal FGMRES count and STEP_TOL."""
    kw = {"operator": "cells", option: value, **TIGHT}
    jns = make(JaxNS, mesh, str(tmp_path / "j"), **kw)
    tns = make(TNS, mesh, str(tmp_path / "t"), device="cpu", **kw)
    assert tns._operator == kw["operator"]
    assert_steps_match(jns, tns, n=1)
