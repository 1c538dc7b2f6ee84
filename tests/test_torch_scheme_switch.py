"""A change of ``config.scheme`` after ``setup()``, as bench.py's
monolithic window makes it (``bench.py:173-177``), against the JAX
model's same flip, in float64 on the CPU on the tests/test_torch_monolithic.py
channel (h=0.1, h_near=0.04, Re 20, dt=0.01): 2 steps, the flip, then
more steps, with equal FGMRES (or BiCGStab + CG) counts and u, p, Cd and
Cl within 1e-9 (measured: at most 4.4e-10).

The JAX model caches its compiled chunks, so its flip clears them
(``ns._chunks = {}``) as bench.py does; it keeps A0 from setup (a
projection BDF2 setup leaves c_t = 3/2 in the monolithic step) and so
does the port.  Under ``asimple`` and ``ayosida`` the JAX model's
projection setup lays G and B out split (``bsr_gb_kmax`` "auto" is -1
under projection, ``navierstokes_tpu/models/navier_stokes.py:248-249``),
and its flipped step takes the Schur coarse matrix from that split table,
which leaves the spilled blocks out: 19 FGMRES iterations against the
port's 17, u 1.4e-5 apart.  The port's flip builds the whole-row G pairs,
as a monolithic setup does, so those cases hold JAX with
``bsr_gb_kmax=0`` (the monolithic layout), where the two agree to 8e-11;
``test_jax_flip_in_its_projection_layout`` holds the gap with JAX's
default layout (19 against 17 under ``asimple``, 17 against 15 under
``ayosida``), so that a change on either side shows.

Within the port: the flip builds what the new scheme needs (Ap, the Schur
G pairs, refinement's float64 tables) and drops the captured graphs, and
its step equals bit for bit the step of a model set up in the new scheme
and given the flipped model's A0 and state; a change of any other field
that setup reads raises ValueError; monolithic to projection on the
cells operator raises as setup does.
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
TOL = 1e-9


@pytest.fixture(scope="module")
def mesh():
    return channel_with_cylinder_2d(h=0.1, h_near=0.04)


def make(cls, mesh, tmp, kv=2, kp=1, **kw):
    """The channel model of either package, set up, float64."""
    jax_side = cls is JaxNS
    dev = {} if jax_side else {"device": kw.pop("device", "cpu")}
    kw.setdefault("dtype", "float64")
    cfg = (JConfig if jax_side else SolverConfig)(
        output_dir=os.path.join(tmp, "out"),
        cache_dir=os.path.join(tmp, "cache"),
        csv_path=os.path.join(tmp, "forces.csv"), **kw)
    inlet = (JInlet if jax_side else InletConfig)(kind="parabolic", u_m=0.3,
                                                  height=0.41)
    ns = cls(mesh, kv, kp, deltat=0.01, T=0.05, step=5, inlet=inlet,
             config=cfg, **dev)
    ns.set_re_number(20)
    return ns.setup()


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def flip(ns, scheme):
    ns.config.scheme = scheme
    if isinstance(ns, JaxNS):
        ns._chunks = {}          # bench.py's flip


def assert_step_matches(jns, tns):
    jm, tm = jns.solve_time_step(), tns.solve_time_step()
    assert tm.iterations == int(jm.iterations) and tm.converged
    assert rel(tns._u.numpy(), jns._u) < TOL
    assert rel(tns._p.numpy(), jns._p) < TOL
    scale = max(abs(float(jm.cd)), abs(float(jm.cl)))
    assert abs(tm.cd - float(jm.cd)) <= TOL * scale
    assert abs(tm.cl - float(jm.cl)) <= TOL * scale
    return tm


@pytest.mark.parametrize("start,to,pc,jax_kw", [
    ("projection", "monolithic", "cc", {}),
    ("projection", "monolithic", "asimple", dict(bsr_gb_kmax=0)),
    ("projection", "monolithic", "ayosida", dict(bsr_gb_kmax=0)),
    ("monolithic", "projection", "cc", {})],
    ids=["proj-mono-cc", "proj-mono-asimple", "proj-mono-ayosida",
         "mono-proj"])
def test_scheme_flip_matches_jax(mesh, tmp_path, start, to, pc, jax_kw):
    kw = dict(scheme=start, preconditioner=pc)
    jns = make(JaxNS, mesh, str(tmp_path / "j"), **kw, **jax_kw)
    tns = make(TNS, mesh, str(tmp_path / "t"), **kw)
    a0 = tns.a0_cell.clone()
    assert (tns._ap is None) == (start == "projection")
    for _ in range(2):
        assert_step_matches(jns, tns)
    flip(jns, to)
    flip(tns, to)
    tns._graphs = "captured before the flip"
    m = assert_step_matches(jns, tns)
    assert tns._graphs is None and torch.equal(tns.a0_cell, a0)
    if to == "monolithic":
        assert tns._ap is not None
        assert m.iterations == {"cc": 16, "asimple": 17, "ayosida": 15}[pc]
        assert (tns._coarse_plan.pair_plan is not None) == (pc != "cc")
    else:
        assert_step_matches(jns, tns)


@pytest.mark.parametrize("pc,its_jax,its_port", [("asimple", 19, 17),
                                                  ("ayosida", 17, 15)])
def test_jax_flip_in_its_projection_layout(mesh, tmp_path, pc, its_jax,
                                           its_port):
    """The known difference, with JAX's default layout: its flipped step
    under ``asimple``/``ayosida`` builds the Schur coarse matrix from the
    projection setup's split G table and takes 2 more FGMRES iterations
    than the port (measured: u 1.4e-5 and 2.4e-5 apart); the projection
    steps before the flip agree within 1e-9."""
    kw = dict(scheme="projection", preconditioner=pc)
    jns = make(JaxNS, mesh, str(tmp_path / "j"), **kw)
    tns = make(TNS, mesh, str(tmp_path / "t"), **kw)
    for _ in range(2):
        assert_step_matches(jns, tns)
    flip(jns, "monolithic")
    flip(tns, "monolithic")
    jm, tm = jns.solve_time_step(), tns.solve_time_step()
    assert (int(jm.iterations), tm.iterations) == (its_jax, its_port)
    assert tm.converged
    assert 1e-6 < rel(tns._u.numpy(), jns._u) < 1e-4


def _adopt(dst, src):
    """``dst`` takes ``src``'s A0 and state."""
    dst.a0_cell = src.a0_cell.clone()
    dst._u, dst._p = src._u.clone(), src._p.clone()
    dst._u_prev, dst._phi = src._u_prev.clone(), src._phi.clone()
    dst._t, dst.time = src._t.clone(), src.time


@pytest.mark.parametrize("kw", [
    dict(preconditioner="asimple"),
    dict(dtype="float32", refine=2, refine_tol=1e-3)],
    ids=["asimple", "fp32-refine2"])
def test_flipped_step_equals_a_monolithic_setup(mesh, tmp_path, kw):
    """The flip builds what a monolithic setup builds: given the flipped
    model's A0 and state, a model set up monolithic takes the same step
    bit for bit (refinement's float64 tables included)."""
    ns = make(TNS, mesh, str(tmp_path / "f"), scheme="projection", **kw)
    for _ in range(2):
        ns.solve_time_step()
    assert ns._ell64 is None
    flip(ns, "monolithic")
    mono = make(TNS, mesh, str(tmp_path / "m"), scheme="monolithic", **kw)
    _adopt(mono, ns)
    ma, mb = ns.solve_time_step(), mono.solve_time_step()
    assert (ns._ell64 is not None) == ("refine" in kw)
    assert ma.iterations == mb.iterations and ma.residual == mb.residual
    assert torch.equal(ns._u, mono._u) and torch.equal(ns._p, mono._p)
    assert (ma.cd, ma.cl) == (mb.cd, mb.cl)


@pytest.mark.parametrize("field,value", [
    ("preconditioner", "asimple"), ("refine", 2), ("n_devices", 2),
    ("dtype", "float32")])
def test_other_field_changed_after_setup_raises(mesh, tmp_path, field,
                                                value):
    """A difference from the JAX model, which reads most fields when it
    traces its step: the port refuses a change of a field that setup
    read, naming it, at the next step."""
    ns = make(TNS, mesh, str(tmp_path), scheme="projection")
    ns.solve_time_step()
    setattr(ns.config, field, value)
    with pytest.raises(ValueError, match=f"SolverConfig.{field} changed.*"
                       r"call setup\(\) again"):
        ns.solve_time_step()


def test_cells_monolithic_to_projection_raises(mesh, tmp_path):
    ns = make(TNS, mesh, str(tmp_path), 3, 2, scheme="monolithic")
    flip(ns, "projection")
    with pytest.raises(ValueError, match="requires operator='bsr'"):
        ns.solve_time_step()
