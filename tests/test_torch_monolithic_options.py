"""The monolithic step's options against the JAX model, on the
tests/test_torch_model.py cylinder channel (h=0.1, h_near=0.04, Re=20,
dt=0.01):

* ``inner_bf16`` / ``bj_bf16`` under monolithic ``cc`` and under
  projection: bf16 applies in fp32 runs only, so fp32 JAX against fp32
  port, 3 steps, iteration counts within 1 at every step.  Where bf16
  enters only a preconditioner (both options under monolithic, bj_bf16
  under projection) u agrees within 1e-4 relative (measured at most
  3.8e-5; plain fp32 runs of the two packages differ by 6e-6 to 3e-5,
  the fp32 noise of the solves).  Under projection, inner_bf16 puts the
  bf16 F values into the operator of the u* BiCGStab, whose solution is
  then only bf16-accurate and depends on which products round which way:
  each package drifts from the float64 run by about 1e-2 by step 3 (JAX
  8.0e-3, the port 1.2e-2, measured).  That case is held to JAX within
  1e-3 at step 1 (measured 3.1e-4), and at every step both packages to
  the float64 run within 2e-2;
* ``refine=2`` (fp32, float64 residual) held to tests/test_refine.py's
  bounds against the JAX float64 run;
* restart: a monolithic restart reproduces the continuous run, and a JAX
  monolithic checkpoint restarts the port onto JAX's next step.
"""

import os

import numpy as np
import pytest
import torch

import navierstokes_tpu_torch.kernels.sell_spmv as K
import navierstokes_tpu_torch.models.navier_stokes as TM
from navierstokes_tpu.config import InletConfig, SolverConfig
from navierstokes_tpu.mesh import channel_with_cylinder_2d
from navierstokes_tpu.models.navier_stokes import NavierStokes as JaxNS
from navierstokes_tpu_torch.models.navier_stokes import NavierStokes as TNS

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def mesh():
    return channel_with_cylinder_2d(h=0.1, h_near=0.04)


def make(cls, mesh, tmp, T=0.03, step=100, **kw):
    dev = {"device": kw.pop("device")} if "device" in kw else {}
    kw.setdefault("scheme", "monolithic")
    inlet = InletConfig(kind="parabolic", u_m=0.3, height=0.41)
    cfg = SolverConfig(output_dir=os.path.join(tmp, "out"),
                       cache_dir=os.path.join(tmp, "cache"),
                       csv_path=os.path.join(tmp, "forces.csv"), **kw)
    ns = cls(mesh, 2, 1, deltat=0.01, T=T, step=step, inlet=inlet,
             config=cfg, **dev)
    ns.set_re_number(20)
    return ns


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("scheme", ["monolithic", "projection"])
@pytest.mark.parametrize("option", ["inner_bf16", "bj_bf16"])
def test_bf16_options_match_jax_fp32(mesh, tmp_path, monkeypatch, scheme,
                                     option):
    seen = set()
    plain, apply_bj = K.sell_spmv_plain, TM.block_jacobi_apply

    def spy_spmv(mat, vals, *a, **k):
        seen.add(("spmv", vals.dtype))
        return plain(mat, vals, *a, **k)

    def spy_bj(plan, tiles, r):
        seen.add(("tiles", tiles.dtype))
        return apply_bj(plan, tiles, r)

    monkeypatch.setattr(K, "sell_spmv_plain", spy_spmv)
    monkeypatch.setattr(TM, "block_jacobi_apply", spy_bj)
    kw = dict(scheme=scheme, dtype="float32", **{option: True})
    jns = make(JaxNS, mesh, str(tmp_path / "j"), **kw).setup()
    tns = make(TNS, mesh, str(tmp_path / "t"), device="cpu", **kw).setup()
    in_operator = scheme == "projection" and option == "inner_bf16"
    if in_operator:
        ref = make(JaxNS, mesh, str(tmp_path / "r"), scheme=scheme,
                   dtype="float64").setup()
    for k in range(3):
        jm = jns.solve_time_step()
        tm = tns.solve_time_step()
        assert abs(tm.iterations - int(jm.iterations)) <= 1
        assert np.isfinite([tm.cd, tm.cl]).all()
        if not in_operator:
            assert rel(tns._u.numpy(), jns._u) < 1e-4
            continue
        if k == 0:
            assert rel(tns._u.numpy(), jns._u) < 1e-3
        ref.solve_time_step()
        assert rel(tns._u.numpy(), ref._u) < 2e-2
        assert rel(jns._u, ref._u) < 2e-2
    # bf16 tiles under both options; bf16 F values under inner_bf16 only
    assert ("tiles", torch.bfloat16) in seen
    assert (("spmv", torch.bfloat16) in seen) == (option == "inner_bf16")


def test_refined_fp32_matches_jax_f64(mesh, tmp_path):
    """tests/test_refine.py's bounds: refined fp32 within 3e-6 of the
    float64 solution, 5x closer than unrefined fp32, and a final residual
    under 0.1x the unrefined one (measured: 1.6e-7 against 2.4e-4, and
    1.1e-12 against 2.4e-6)."""
    def run(cls, tag, **kw):
        ns = make(cls, mesh, str(tmp_path / tag), **kw).setup()
        return ns, [ns.solve_time_step() for _ in range(3)]

    f64, _ = run(JaxNS, "f64", dtype="float64", outer_tol=1e-12)
    raw, m_raw = run(TNS, "raw", dtype="float32", device="cpu")
    ref, m_ref = run(TNS, "ref", dtype="float32", refine=2,
                     refine_tol=1e-3, device="cpu")
    u64 = np.asarray(f64._u)
    err_raw = rel(raw._u.numpy(), u64)
    err_ref = rel(ref._u.numpy(), u64)
    assert err_ref < 3e-6, err_ref
    assert err_ref < err_raw / 5, (err_ref, err_raw)
    assert m_ref[-1].residual < 0.1 * m_raw[-1].residual
    assert ref._u.dtype == torch.float32
    assert ref._ell64.g_vals.dtype == torch.float64
    assert raw._ell64 is None


def test_monolithic_restart_equivalence(mesh, tmp_path):
    """A restart from a checkpoint reproduces the continuous run."""
    kw = dict(dtype="float64", T=0.04, step=2, device="cpu")
    a = make(TNS, mesh, str(tmp_path / "a"), **kw).setup()
    a.solve()
    b = make(TNS, mesh, str(tmp_path / "b"), **kw).setup()
    b.solve()
    c = make(TNS, mesh, str(tmp_path / "b"), **kw).setup()
    c.solve(time_step=2)
    np.testing.assert_allclose(c._u.numpy(), a._u.numpy(), atol=1e-12)
    np.testing.assert_allclose(c._p.numpy(), a._p.numpy(), atol=1e-12)
    assert c.time == a.time
    with open(a.config.csv_path) as f:
        assert f.readline().strip() == ("time,deltat,GMRES_iters,"
                                        "time_prec_init,time_sol,Drag,Lift,"
                                        "Cd,Cl")
        its = [int(float(r.split(",")[2])) for r in f]
    assert len(its) == 4 and all(0 < i < 200 for i in its)


def test_jax_monolithic_checkpoint_restarts_port(mesh, tmp_path):
    """JAX writes state-ns-2 of a monolithic run; the port restarts from
    it for one step and lands on JAX's step 3."""
    tmp = str(tmp_path / "j")
    jns = make(JaxNS, mesh, tmp, dtype="float64", T=0.02, step=2).setup()
    jns.solve()
    jm = jns.solve_time_step()
    tns = make(TNS, mesh, tmp, dtype="float64", T=0.02, step=2,
               device="cpu").setup()
    tns.import_data(2)
    tm = tns.solve_time_step()
    assert tm.iterations == int(jm.iterations)
    assert rel(tns._u.numpy(), jns._u) < 1e-9
    assert rel(tns._p.numpy(), jns._p) < 1e-9
