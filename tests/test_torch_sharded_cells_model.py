"""Steps of the NavierStokes model on cell shards
(``navierstokes_tpu_torch/parallel/sharded_cells.py``) against the JAX
model's shard_map cells path at the same ``n_devices`` (the conftest's 8
virtual CPU devices) and against the port's one-device run, in float64 on
the CPU, 2 steps at Re 20 with the inner solves at 1e-10
(tests/test_torch_cells.py says why): equal FGMRES counts, u, p, Cd and
Cl within 1e-9 relative (measured: at most 1.1e-10).

* P2/P1 ``operator="cells"`` on 8 shards, on tests/test_sharding.py's
  channel (h=0.1, h_near=0.04, the cylinder snapped);
* P3/P2 (cells chosen by the degree switch) on 2 shards, on the h=0.15
  channel of tests/test_torch_cells_p3.py (4,916 DoF; the h=0.1 channel
  takes twice as long for the same check); in fp32 with ``inner_bf16`` on
  2 shards, within 1e-3 of u of the float64 run, as chip_smoke.py's phase
  18 holds one device.

The P2/P1 case and the P3/P2 cases run from two files
(test_torch_sharded_cells_p3p2.py imports this one), so that each stays
near a minute.
"""

import numpy as np
import pytest
import torch

from navierstokes_tpu.mesh import channel_with_cylinder_2d
from navierstokes_tpu.models.navier_stokes import NavierStokes as JaxNS
from navierstokes_tpu_torch.models.navier_stokes import NavierStokes as TNS
from navierstokes_tpu_torch.parallel.sharded_bsr import ShardVals
from test_torch_cells import STEP_TOL, TIGHT, make, rel

torch.set_num_threads(2)
OP_TOL = 1e-12


def _steps_within(a, b, n=2, tol=STEP_TOL, jax_b=False):
    """``n`` steps of two models: equal FGMRES counts, converged, u, p
    within ``tol`` relative, Cd and Cl within ``tol`` of the force
    scale."""
    for _ in range(n):
        ma, mb = a.solve_time_step(), b.solve_time_step()
        assert ma.converged and ma.iterations == int(mb.iterations)
        ub, pb = (np.asarray(b._u), np.asarray(b._p)) if jax_b else \
            (b._u.numpy(), b._p.numpy())
        assert rel(a._u.numpy(), ub) < tol
        assert rel(a._p.numpy(), pb) < tol
        scale = max(abs(float(mb.cd)), abs(float(mb.cl)))
        assert abs(ma.cd - float(mb.cd)) <= tol * scale
        assert abs(ma.cl - float(mb.cl)) <= tol * scale


def run_against_jax_and_one_device(tmp_path, kv, kp, n, h):
    """``n`` cell shards against JAX's ``n_devices=n`` run and the port's
    one-device run on the cylinder channel at (h, h_near) ``h``."""
    mesh = channel_with_cylinder_2d(h=h[0], h_near=h[1])
    kw = dict(TIGHT, n_devices=n, T=0.02, step=2)
    if kv == 2:
        kw["operator"] = "cells"
    jns = make(JaxNS, mesh, str(tmp_path / "j"), kv, kp, **kw)
    tns = make(TNS, mesh, str(tmp_path / "t"), kv, kp, device="cpu", **kw)
    one = make(TNS, mesh, str(tmp_path / "o"), kv, kp, device="cpu",
               **dict(kw, n_devices=1))
    assert tns._cell_sharded and not tns._sharded
    assert tns.config.operator == "cells" and len(tns.cells.shards) == n
    assert isinstance(tns.a0_cell, ShardVals)
    assert tns._devices() == [torch.device("cpu")]
    assert torch.equal(tns.cells.unshard(tns.a0_cell), one.a0_cell)
    # the per-cell F in global cell order, as on one device
    assert rel(tns.assemble(0.0).numpy(), one.assemble(0.0).numpy()) < \
        OP_TOL
    _steps_within(tns, jns, jax_b=True)
    for _ in range(2):
        one.solve_time_step()
    assert rel(tns._u.numpy(), one._u.numpy()) < STEP_TOL
    assert rel(tns._p.numpy(), one._p.numpy()) < STEP_TOL
    assert tns.cd == pytest.approx(one.cd, rel=STEP_TOL)


def test_p2p1_cells_8_shards_match_jax_and_one_device(tmp_path):
    run_against_jax_and_one_device(tmp_path, 2, 1, 8, (0.1, 0.04))
