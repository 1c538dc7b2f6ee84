"""P3/P2 through the port's degree switch against the JAX model, on the
cylinder channel at h=0.15, h_near=0.06 (4,916 DoF), Re=20, dt=0.01:

* ``NavierStokes(mesh, 3, 2)`` with the default ``operator="bsr"``
  switches to the cells operator and leaves the cylinder unsnapped (P2
  geometry), as JAX does; 3 float64 steps with the inner solves at 1e-10
  (tests/test_torch_cells.py says why) give equal FGMRES counts and u, p,
  Cd and Cl within 1e-9 (measured sensitivity to a 1e-15 perturbation of
  A0: 5e-11);
* a JAX P3/P2 checkpoint restarts the port onto JAX's next step, and the
  same state handed over in memory (``convert.state_from_jax_numpy``)
  gives that step bit for bit;
* ``assemble(time)`` equals JAX's per-cell matrices (P3/P2, and P2/P1 on
  cells with the snapped cylinder's curved convection);
* ``output()`` writes JAX's VTU and PVTU byte for byte (the JAX writer's
  P2 node selection for a P3 cell included);
* ``inner_bf16`` in fp32: the inner F solves take bf16-rounded values
  in fp32 (JAX's bf16-by-fp32 einsum promotes them so).  The bsr case's
  limits in tests/test_torch_monolithic_options.py (FGMRES counts within
  1, u within 1e-4 of JAX's fp32 run) do not hold on cells: the fp32
  cells step stops at the fp32 floor of its residual, and any change of
  round-off moves its counts (two CPU fp32 runs of the port that differ
  only in their thread count differ by up to 5 iterations; here JAX and
  the port take 41 and 34 at step 1) and its u by the fp32 solve's error
  (up to 1.6e-4 of the float64 run, measured).  So each fp32 run is held
  to JAX's float64 run, and the port to JAX's fp32 run, within 1e-3 of u
  over 3 steps, every solve converged.
Random states come from a seeded numpy generator.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokes_tpu.mesh import channel_with_cylinder_2d
from navierstokes_tpu.models.navier_stokes import NavierStokes as JaxNS
from navierstokes_tpu_torch import convert
from navierstokes_tpu_torch.models.navier_stokes import NavierStokes as TNS
from test_torch_cells import STEP_TOL, TIGHT, assert_steps_match, make, rel

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def mesh():
    return channel_with_cylinder_2d(h=0.15, h_near=0.06)


def test_p3p2_switches_to_cells_and_matches_jax(mesh, tmp_path, capsys):
    jns = make(JaxNS, mesh, str(tmp_path / "j"), 3, 2, **TIGHT)
    tns = make(TNS, mesh, str(tmp_path / "t"), 3, 2, device="cpu", **TIGHT)
    out = capsys.readouterr().out
    line = ("operator 'bsr' is P2/P1-optimized; degrees (3,2) use the "
            "generic 'cells' operator")
    assert out.count(line) == 2                      # JAX's and the port's
    assert tns.config.operator == jns.config.operator == "cells"
    assert mesh.snap_projectors and tns.config.curved_boundary
    assert tns.space.curved_data() is None is jns.space.curved_data()
    assert tns.cells.curv_ids is None
    assert tns.space.n_dofs == jns.space.n_dofs == 4916
    assert_steps_match(jns, tns)


def test_jax_p3p2_checkpoint_restarts_port(mesh, tmp_path):
    d = str(tmp_path / "j")
    jns = make(JaxNS, mesh, d, 3, 2, T=0.02, step=2, **TIGHT)
    jns.solve()
    jm = jns.solve_time_step()
    tns = make(TNS, mesh, d, 3, 2, T=0.02, step=2, device="cpu", **TIGHT)
    tns.import_data(2)
    tm = tns.solve_time_step()
    assert tm.iterations == int(jm.iterations)
    assert rel(tns._u.numpy(), jns._u) < STEP_TOL
    assert rel(tns._p.numpy(), jns._p) < STEP_TOL
    u3, p3 = tns._u.clone(), tns._p.clone()
    with np.load(os.path.join(d, "cache", "state-ns-2.npz")) as z:
        assert z["u"].shape == (tns.space.n_p2, 2)
        assert z["p"].shape == (tns.space.n_p1,)
        st = convert.state_from_jax_numpy(z["u"], z["p"], z["u_prev"],
                                          z["phi"], float(z["time"]), "cpu",
                                          torch.float64)
    tns.load_state(st)
    tns.solve_time_step()
    assert torch.equal(tns._u, u3) and torch.equal(tns._p, p3)


def _same_state(jns, tns, seed):
    """One numpy-seeded state (u, p, u_prev) in both models."""
    rng = np.random.default_rng(seed)
    sp = tns.space
    u = 0.3 * rng.standard_normal((sp.n_p2, sp.dim))
    p = rng.standard_normal(sp.n_p1)
    for ns, f in ((jns, jnp.asarray), (tns, torch.as_tensor)):
        ns._init_state(0)
        ns._u, ns._p, ns._u_prev = f(u), f(p), f(0.5 * u)


@pytest.mark.parametrize("kv,kp", [(3, 2), (2, 1)], ids=["p3p2", "p2p1"])
def test_assemble_equals_jax(mesh, tmp_path, kv, kp):
    """assemble(time): A0 + C(u) per cell at a seeded state; on P2/P1 the
    snapped cells take the curved convection fix."""
    jns = make(JaxNS, mesh, str(tmp_path / "j"), kv, kp, operator="cells")
    tns = make(TNS, mesh, str(tmp_path / "t"), kv, kp, operator="cells",
               device="cpu")
    _same_state(jns, tns, 11)
    a_j, a_t = jns.assemble(0.25), tns.assemble(0.25)
    nv = tns.space.cell_p2.shape[1]
    assert a_t.shape == (tns.mesh.n_cells, nv, nv) == a_j.shape
    assert rel(a_t.numpy(), a_j) < 1e-13
    assert tns.time == jns.time == 0.25
    assert (tns.cells.curv_ids is not None) == (kv == 2)
    if kv == 2:
        ids = tns.cells.curv_ids.numpy()
        assert rel(a_t.numpy()[ids], np.asarray(a_j)[ids]) < 1e-13


def test_output_equals_jax_p3p2(mesh, tmp_path):
    """One device in both (the JAX partitioning field is then 0, as the
    port's always is)."""
    kw = dict(n_devices=1)
    jns = make(JaxNS, mesh, str(tmp_path / "j"), 3, 2, **kw)
    tns = make(TNS, mesh, str(tmp_path / "t"), 3, 2, device="cpu", **kw)
    _same_state(jns, tns, 12)
    jns.output(7)
    tns.output(7)
    for name in ("output-stokes_000007.vtu", "output-stokes_000007.pvtu"):
        assert (tmp_path / "t" / "out" / name).read_bytes() == \
            (tmp_path / "j" / "out" / name).read_bytes()


def test_inner_bf16_on_cells_fp32(mesh, tmp_path):
    kw = dict(dtype="float32", inner_bf16=True)
    jns = make(JaxNS, mesh, str(tmp_path / "j"), 3, 2, **kw)
    tns = make(TNS, mesh, str(tmp_path / "t"), 3, 2, device="cpu", **kw)
    ref = make(JaxNS, mesh, str(tmp_path / "r"), 3, 2)
    seen = set()
    apply_blocks = tns._ops.apply_blocks

    def spy(cells, f_cell, *a, **k):
        seen.add((f_cell.dtype, bool(torch.equal(
            f_cell, f_cell.to(torch.bfloat16).to(f_cell.dtype)))))
        return apply_blocks(cells, f_cell, *a, **k)

    tns._ops.apply_blocks = spy
    for _ in range(3):
        jns.solve_time_step()
        tm = tns.solve_time_step()
        ref.solve_time_step()
        assert tm.converged and np.isfinite([tm.cd, tm.cl]).all()
        assert rel(tns._u.numpy(), jns._u) < 1e-3
        assert rel(tns._u.numpy(), ref._u) < 1e-3
        assert rel(jns._u, ref._u) < 1e-3
    # fp32 values throughout, bf16-representable ones in the inner F solves
    assert seen == {(torch.float32, True), (torch.float32, False)}
