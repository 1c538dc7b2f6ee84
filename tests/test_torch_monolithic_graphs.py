"""The captured monolithic step on the CPU (models/step_graphs.py
``MonolithicGraphs``), rehearsed with its segment functions where the
graphs would replay (``_dry``: each loop a while loop, its flag tested
before the first body and after each), against the plain step
``NavierStokes._step_monolithic``;
the Givens update with its bounds on the device against the call it
replaces; and which models capture (``_capture_refusal``).

Fixture: the h=0.1 cylinder channel of tests/test_torch_solvers.py
(Re=20, dt=0.01), monolithic, float64 unless a case needs fp32
(``inner_bf16`` and ``refine`` act in fp32 runs only).  Tolerance: bit
for bit everywhere.
"""

import os

import numpy as np
import pytest
import torch

from navierstokes_tpu_torch.config import InletConfig, SolverConfig
from navierstokes_tpu_torch.kernels import arnoldi_lsq as AL
from navierstokes_tpu_torch.mesh.generators import channel_with_cylinder_2d
from navierstokes_tpu_torch.models.navier_stokes import NavierStokes
from navierstokes_tpu_torch.models.step_graphs import MonolithicGraphs
from navierstokes_tpu_torch.solvers import krylov as TK

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def mesh():
    return channel_with_cylinder_2d(h=0.1, h_near=0.04)


def _model(mesh, tmp, dtype="float64", **fields):
    cfg = SolverConfig(dtype=dtype, scheme="monolithic",
                       output_dir=os.path.join(tmp, "out"),
                       cache_dir=os.path.join(tmp, "cache"),
                       csv_path=os.path.join(tmp, "forces.csv"))
    for k, v in fields.items():
        setattr(cfg, k, v)
    ns = NavierStokes(mesh, 2, 1, deltat=0.01, T=0.03, step=3,
                      inlet=InletConfig(kind="parabolic", u_m=0.3,
                                        height=0.41),
                      config=cfg, device="cpu")
    ns.set_re_number(20)
    return ns.setup()


# the monolithic options the captured step covers
CASES = {
    "cc": dict(),
    "pcd": dict(preconditioner="pcd"),
    "asimple": dict(preconditioner="asimple"),
    "ayosida": dict(preconditioner="ayosida"),
    "identity": dict(preconditioner="identity"),
    "diag": dict(f_precond="diag"),
    "cc fp32 inner_bf16": dict(dtype="float32", inner_bf16=True),
    "cc fp32 refine=2": dict(dtype="float32", refine=2, refine_tol=1e-3),
    # a second cycle and refinement's corrections reuse the block
    "cc fp32 refine=2 restart=8": dict(dtype="float32", refine=2,
                                       refine_tol=1e-3, outer_restart=8),
    # Richardson inner F sweeps: a fixed count, no conditional node
    "cc richardson": dict(f_solver="richardson"),
    "asimple jacobi richardson": dict(preconditioner="asimple",
                                      f_precond="jacobi",
                                      f_solver="richardson"),
}
FIELDS = ("time", "iterations", "residual", "converged", "drag", "lift",
          "cd", "cl", "exact_inverse")


@pytest.mark.parametrize("case", list(CASES))
def test_replay_order_equals_the_plain_step(tmp_path, mesh, monkeypatch,
                                            case):
    """MonolithicGraphs' replay order, rehearsed on its static buffers,
    against the plain step: 3 steps, the second from the plain step
    between replays, bit for bit in u, p and every metric, with the same
    FGMRES counts.  The plain step reads each flag before each iteration
    and masks none; the rehearsal reads the host at the guard and once per
    FGMRES cycle's end, and nowhere else, runs no body masked and skips
    none (every test of a flag ran a body or ended a loop); without inner
    loops (identity, richardson) and refinement its bodies are the FGMRES
    iterations and its loops the cycles."""
    kw = CASES[case]
    a = _model(mesh, str(tmp_path / "a"), **kw)
    b = _model(mesh, str(tmp_path / "b"), **kw)
    assert not b._captures()
    ma = [a.solve_time_step() for _ in range(3)]
    b._init_state(0)
    sg = b._graphs = MonolithicGraphs(b, _dry=True)
    cycles = []
    setup = TK.GmresLoop.cycle

    def counted(loop):
        cycles[-1] += 1
        setup(loop)

    monkeypatch.setattr(TK.GmresLoop, "cycle", counted)
    mb = []
    for run in (lambda: b._read_rows(*sg.run(1)),
                lambda: [b.solve_time_step(_eager=True)],
                lambda: b._read_rows(*sg.run(1))):
        cycles.append(0)
        mb += run()
    assert torch.equal(a._u, b._u) and torch.equal(a._p, b._p)
    assert b._u is sg.u               # the last step was a replay
    guard = int(b._bj_plan is not None and b.config.bj_newton > 0)
    plain = ("identity" in case or "richardson" in case) \
        and "refine" not in case
    for k, (x, y) in enumerate(zip(ma, mb)):
        for field in FIELDS:
            assert getattr(x, field) == getattr(y, field), (k, field)
        assert x.masked_iterations == 0
        if k != 1:                    # the replays
            assert y.flag_reads == guard + cycles[k] < x.flag_reads
            assert y.masked_iterations == y.skipped_bodies == 0
            assert y.bodies_run >= y.iterations > 0
            assert y.loops_entered >= cycles[k]
            if plain:
                assert (y.bodies_run, y.loops_entered) == (y.iterations,
                                                           cycles[k])
            else:
                assert y.loops_entered > cycles[k]
    if "restart" in case:
        assert max(m.iterations for m in ma) > 8      # a second cycle


def _lsq_host_bound(H, cs, sn, g, h, wnorm, j, res, active, target,
                    j_max: int):
    """The Givens update as its plain version was before its bounds moved
    to the device: the column h1 + h2 summed by the caller, j_max a host
    int."""
    if not bool(active):
        return
    J = int(j)
    h = h.clone()
    h[J + 1] = wnorm
    for i in range(J):
        hi = cs[i] * h[i] + sn[i] * h[i + 1]
        h[i + 1] = -sn[i] * h[i] + cs[i] * h[i + 1]
        h[i] = hi
    a, b = h[J], h[J + 1]
    denom = AL._sqrt_rn(a * a + b * b)
    if bool(denom > 0):
        d = torch.clamp(denom, min=1e-30)
        cj, sj = a / d, b / d
    else:
        cj, sj = torch.ones_like(a), torch.zeros_like(a)
    h[J], h[J + 1] = denom, 0.0
    cs[J], sn[J] = cj, sj
    gj = g[J].clone()
    g[J + 1] = -sj * gj
    g[J] = cj * gj
    H[:, J] = h
    res.copy_(torch.abs(g[J + 1]))
    j.add_(1)
    active.copy_((J + 1 < j_max) & (res > target))


def test_givens_with_device_bounds_equals_the_host_bound(tmp_path, mesh,
                                                         monkeypatch):
    """At every call of 3 monolithic steps with restart 8, a budget of
    12 and two refinement passes with a budget of 6 (cycles of 8, 4 and 6
    iterations: j_max varies from cycle to cycle and solve to solve), the
    update with h1, h2 and j_max on the device equals the earlier call
    with h1 + h2 and int(j_max), bit for bit in every output."""
    calls, bounds = [], set()

    def both(H, cs, sn, g, h1, h2, wnorm, j, res, active, target, j_max,
             cond=None):
        state = [t.clone() for t in (H, cs, sn, g, j, res, active)]
        AL.lsq_update(H, cs, sn, g, h1, h2, wnorm, j, res, active, target,
                      j_max)
        _lsq_host_bound(state[0], state[1], state[2], state[3], h1 + h2,
                        wnorm, state[4], state[5], state[6], target,
                        int(j_max))
        for got, want in zip((H, cs, sn, g, j, res, active), state):
            assert torch.equal(got, want)
        calls.append(int(j))
        bounds.add(int(j_max))

    monkeypatch.setattr(TK, "lsq_update", both)
    ns = _model(mesh, str(tmp_path), dtype="float32", refine=2,
                refine_tol=1e-3, outer_restart=8, outer_maxiter=12,
                refine_maxiter=6)
    ms = [ns.solve_time_step() for _ in range(3)]
    assert len(calls) > sum(m.iterations for m in ms) > 8
    assert max(calls) == 8 and {8, 6} <= bounds


@pytest.mark.parametrize("fields,reason", [
    (dict(operator="cells"), "cells operator steps eagerly"),
    (dict(n_devices=2), "row shards step eagerly"),
    (dict(operator="cells", n_devices=2), "cell shards step eagerly"),
    (dict(f_solver="gmres"), "inner GMRES solves its triangular system"),
])
def test_models_that_step_eagerly_refuse_capture(tmp_path, mesh, fields,
                                                 reason):
    """Row shards, cell shards, the cells operator and f_solver="gmres"
    step eagerly by
    a stated rule: ``capture_graphs`` raises with the reason, and a step
    runs the plain way."""
    ns = _model(mesh, str(tmp_path), **fields)
    assert not ns._captures()
    with pytest.raises(ValueError, match=reason):
        ns.capture_graphs()
    m = ns.solve_time_step()
    assert m.converged and m.iterations > 0 and ns._graphs is None


def test_one_device_bsr_captures_on_the_card_only(tmp_path, mesh):
    """The one-device bsr monolithic model is refused only for its
    device."""
    ns = _model(mesh, str(tmp_path))
    with pytest.raises(ValueError, match="on the card only"):
        ns.capture_graphs()


@pytest.mark.parametrize("with_pos", [False, True])
def test_length_bucket_segment_sum(with_pos):
    """The segment sum the card takes for long targets (length buckets,
    capturable) equals the plain sum to float64 rounding, on skewed
    lengths like the Schur coarse pairs' (one target holding most
    entries), also over a subset of a larger value array (``pos``)."""
    from navierstokes_tpu_torch.ops.operators import segment_plan
    rng = np.random.default_rng(11)
    ids = rng.integers(0, 200, 20000)
    ids[:12000] = 17
    n_flat = 25000 if with_pos else len(ids)
    pos = rng.permutation(n_flat)[:len(ids)] if with_pos else None
    vals = torch.as_tensor(rng.standard_normal((n_flat, 2)))
    plan = segment_plan(ids, 210, "cpu", passes=False, pos=pos,
                        buckets=True)
    want = np.zeros((210, 2))
    np.add.at(want, ids, vals.numpy()[np.arange(n_flat) if pos is None
                                       else pos])
    got = plan(vals).numpy()
    assert plan.order is None and len(plan.buckets) > 2
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    assert not got[200:].any()
