"""The port's device-resident loops on the CPU: the blocked Krylov loops
(solvers/krylov.py) at several block sizes and against the JAX solvers,
the plain version of the Givens kernel (kernels/arnoldi_lsq.py) against
the host arithmetic it replaces, the host reads of a solve, the chunked
``solve`` and a restart at an output boundary, the loops as while loops
(krylov ``DRY``, what the card's while nodes run) against the JAX
solvers, and the replay order of the captured projection step
(models/step_graphs.py, rehearsed with its segment functions where the
graphs would replay, its loops under ``DRY``).

Fixture: the h=0.1 cylinder channel of tests/test_torch_solvers.py in the
projection configuration, float64 (fp32 where noted).  Tolerances: the
blocked loops, the chunked solve, the restart and the replay order
equal their references bit for bit; the solvers equal JAX's counts with
x to 1e-10 (float64); the plain Givens update equals the host rotations
bit for bit.
"""

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokes_tpu.config import InletConfig as JInlet
from navierstokes_tpu.config import SolverConfig as JConfig
from navierstokes_tpu.mesh import channel_with_cylinder_2d as j_channel
from navierstokes_tpu.models.navier_stokes import NavierStokes as JaxNS
from navierstokes_tpu.ops import bsr as JB
from navierstokes_tpu.ops import p1ell as JP
from navierstokes_tpu.solvers import krylov as JK
from navierstokes_tpu.solvers import schur as JS
from navierstokes_tpu_torch.config import InletConfig, SolverConfig
from navierstokes_tpu_torch.kernels import arnoldi_lsq as AL
from navierstokes_tpu_torch.mesh.generators import channel_with_cylinder_2d
from navierstokes_tpu_torch.mesh.geometry import TAG_OUTLET, TAG_WALL_TOP
from navierstokes_tpu_torch.models.navier_stokes import NavierStokes as TNS
from navierstokes_tpu_torch.models.step_graphs import ProjectionGraphs
from navierstokes_tpu_torch.ops import bsr as TB
from navierstokes_tpu_torch.ops import p1ell as TP
from navierstokes_tpu_torch.solvers import krylov as TK
from navierstokes_tpu_torch.solvers import schur as TS

torch.set_num_threads(2)
SOLVERS = ("bicgstab", "cg", "fgmres")


def _config(cls, tmp, dtype="float64", **fields):
    cfg = cls(dtype=dtype, output_dir=os.path.join(tmp, "out"),
              cache_dir=os.path.join(tmp, "cache"),
              csv_path=os.path.join(tmp, "forces.csv"), scheme="projection")
    for k, v in fields.items():
        setattr(cfg, k, v)
    return cfg


def _torch_model(tmp, dtype="float64", mesh=None, T=0.03, step=3,
                 forcing=None, **fields):
    ns = TNS(mesh or channel_with_cylinder_2d(h=0.1, h_near=0.04), 2, 1,
             deltat=0.01, T=T, step=step,
             inlet=InletConfig(kind="parabolic", u_m=0.3, height=0.41),
             config=_config(SolverConfig, tmp, dtype, **fields),
             device="cpu", forcing=forcing)
    ns.set_re_number(20)
    return ns.setup()


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("loops"))
    return {dt: _torch_model(os.path.join(tmp, dt), dt)
            for dt in ("float64", "float32")}


@pytest.fixture(scope="module")
def jax_model(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("loops_jax"))
    ns = JaxNS(j_channel(h=0.1, h_near=0.04), 2, 1, deltat=0.01, T=0.03,
               step=3, inlet=JInlet(kind="parabolic", u_m=0.3, height=0.41),
               config=_config(JConfig, tmp))
    ns.set_re_number(20)
    return ns.setup()


def _system(ns, solver, lib, bsr_mod, p1_mod, schur_mod, seed=5):
    """(matvec, rhs, x0, preconditioner, keyword arguments) of ``solver``
    on ``ns``, from numpy data: CG on the outlet-pinned P1 Laplacian with
    its V-cycle (tests/test_torch_solvers.py), BiCGStab and FGMRES on the
    BC-masked F with convection and exact block-Jacobi tiles."""
    rng = np.random.default_rng(seed)
    arr = ((lambda a: torch.as_tensor(a, dtype=ns.dtype)) if lib is torch
           else jnp.asarray)
    if solver == "cg":
        ap = ns._ap_dir
        apply = lambda v: p1_mod.ell_matvec(ap, v)
        pre = schur_mod.make_vcycle_solver(
            apply, ap.diag, ns._coarse_plan, ns._ap_dir_sc_inv, n_cycles=1,
            smooth_k=ns.config.schur_smooth_k, lam_max=ns._ap_dir_lam)
        pin = np.asarray(ns._ap_dir_pin)
        rhs = rng.standard_normal(ns.space.n_p1) * pin
        x0 = rng.standard_normal(ns.space.n_p1) * pin * 0.1
        return apply, arr(rhs), arr(x0), pre, dict(tol=1e-10, maxiter=60)
    n_p2 = ns.space.n_p2
    f = ns.a0_cell + bsr_mod.convection_blk(
        ns.ell, arr(0.3 * rng.standard_normal((n_p2, 2))))
    mask = ns.bc.mask
    mflat = mask[:, 0]
    d = bsr_mod.f_diag(ns.ell, f)
    sigma = (d * mflat).sum() / mflat.sum()
    inv = p1_mod.block_jacobi_invert(ns._bj_plan, f, mflat, sigma, x0=None,
                                     iters=0)

    def apply_F(xu):
        xum = xu * mask
        return bsr_mod.apply_f(ns.ell, f, xum) * mask + sigma * (xu - xum)

    pre = lambda r: p1_mod.block_jacobi_apply(ns._bj_plan, inv, r)
    kw = dict(tol=1e-10, maxiter=100)
    if solver in ("fgmres", "gmres"):
        kw.update(restart=12, maxiter=60)
    return (apply_F, arr(rng.standard_normal((n_p2, 2))),
            arr(0.01 * rng.standard_normal((n_p2, 2))), pre, kw)


def _solve(solver, system):
    mv, b, x0, pre, kw = system
    return getattr(TK, solver)(mv, b, x0=x0, precond=pre, **kw)


def _block_size(monkeypatch, n):
    """Every solver's iterations per block set to ``n``."""
    monkeypatch.setattr(TK.BicgstabLoop, "check_every", n)
    monkeypatch.setattr(TK.CgLoop, "check_every", n)
    monkeypatch.setattr(TK, "GMRES_CHECK_EVERY", n)


@pytest.mark.parametrize("check_every", [1, 2, 8])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("solver", SOLVERS)
def test_blocked_loops_equal_block_size_one(models, monkeypatch, solver,
                                            dtype, check_every):
    """Blocks of masked iterations change no count and no bit."""
    ns = models[dtype]
    system = _system(ns, solver, torch, TB, TP, TS)
    with monkeypatch.context() as mp:
        _block_size(mp, 1)
        ref = _solve(solver, system)
    _block_size(monkeypatch, check_every)
    got = _solve(solver, system)
    assert got.iterations == ref.iterations > 2
    assert got.converged == ref.converged
    assert torch.equal(got.x, ref.x)
    assert torch.equal(got.residual, ref.residual)


@pytest.mark.parametrize("solver", SOLVERS + ("gmres",))
def test_loops_match_jax(models, jax_model, solver):
    """The same counts as the JAX package's lax.while_loop solvers, x to
    1e-10 (float64), at the solvers' own block sizes."""
    tr = _solve(solver, _system(models["float64"], solver, torch, TB, TP,
                                TS))
    mv, b, x0, pre, kw = _system(jax_model, solver, jnp, JB, JP, JS)
    jr = getattr(JK, solver)(mv, b, x0=x0, precond=pre, **kw)
    assert tr.iterations == int(jr.iterations) > 2
    assert tr.converged == bool(jr.converged)
    x = np.asarray(jr.x)
    assert np.abs(tr.x.numpy() - x).max() / np.abs(x).max() < 1e-10


@pytest.mark.parametrize("solver", SOLVERS + ("gmres",))
def test_while_loops_match_jax(models, jax_model, solver):
    """The loops as the card's while nodes run them (krylov ``DRY``: the
    flag tested before the first body and after each, no host read but
    FGMRES's cycle ends) give the JAX package's lax.while_loop counts, x
    to 1e-10 (float64), and the masked loops' bits; every test of a flag
    ran a body or ended a loop."""
    system = _system(models["float64"], solver, torch, TB, TP, TS)
    masked = _solve(solver, system)
    with TK.iteration_mode(TK.Mode(TK.DRY)) as mode:
        tr = _solve(solver, system)
    mv, b, x0, pre, kw = _system(jax_model, solver, jnp, JB, JP, JS)
    jr = getattr(JK, solver)(mv, b, x0=x0, precond=pre, **kw)
    assert tr.iterations == int(jr.iterations) == masked.iterations > 2
    assert tr.converged == bool(jr.converged)
    x = np.asarray(jr.x)
    assert np.abs(tr.x.numpy() - x).max() / np.abs(x).max() < 1e-10
    assert torch.equal(tr.x, masked.x)
    assert mode.runs == tr.iterations
    assert mode.tests == mode.runs + mode.entered
    # BiCGStab and CG: one loop; FGMRES: one per restart cycle
    assert mode.entered == (1 if solver in ("bicgstab", "cg")
                            else math.ceil(tr.iterations / kw["restart"]))
    assert mode.reads == (0 if solver in ("bicgstab", "cg")
                          else mode.entered)


def _host_rotations(h, j, cs, sn, g, H, npdt):
    """The host arithmetic the Givens kernel replaces (the port's FGMRES
    before its loop moved to the device), on numpy scalars of ``npdt``."""
    for i in range(j):
        hi = cs[i] * h[i] + sn[i] * h[i + 1]
        h[i + 1] = -sn[i] * h[i] + cs[i] * h[i + 1]
        h[i] = hi
    denom = np.sqrt(h[j] ** 2 + h[j + 1] ** 2)
    if denom > 0:
        cj = h[j] / np.maximum(denom, npdt(1e-30))
        sj = h[j + 1] / np.maximum(denom, npdt(1e-30))
    else:
        cj, sj = npdt(1.0), npdt(0.0)
    h[j], h[j + 1] = denom, 0.0
    cs[j], sn[j] = cj, sj
    g[j + 1] = -sj * g[j]
    g[j] = cj * g[j]
    H[:, j] = h
    return np.abs(g[j + 1])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_lsq_plain_matches_host_arithmetic(dtype):
    """The plain lsq_update equals the host rotations bit for bit over a
    cycle (its last column zero: the denom = 0 branch, res = 0, the flag
    down); a step under a down flag changes nothing."""
    npdt = np.float64 if dtype == torch.float64 else np.float32
    m, n_it = 64, 41
    rng = np.random.default_rng(7)
    cols = rng.standard_normal((n_it, m + 1)).astype(npdt)
    cols[-1] = 0.0
    # a dominant new entry keeps |g[j+1]| from decaying: 40 live columns,
    # among them roots that torch's CPU sqrt rounds one ulp off
    wn = (10.0 * np.abs(cols).max(axis=1) + 1.0).astype(npdt)
    wn[-1] = 0.0
    H, cs, sn, g = (np.zeros((m + 1, m), npdt), np.zeros(m, npdt),
                    np.zeros(m, npdt), np.zeros(m + 1, npdt))
    g[0] = npdt(2.5)
    t = lambda a: torch.tensor(a, dtype=dtype)
    tH, tcs, tsn, tg = t(H), t(cs), t(sn), t(g)
    j = torch.zeros((), dtype=torch.int32)
    res, act = t(2.5), torch.ones((), dtype=torch.bool)
    target, zero = t(1e-30), t(np.zeros(m + 1, npdt))
    j_max = torch.tensor(m, dtype=torch.int32)
    for it in range(n_it):
        h = cols[it].copy()
        h[it + 1] = wn[it]
        r = _host_rotations(h, it, cs, sn, g, H, npdt)
        AL.lsq_update(tH, tcs, tsn, tg, t(cols[it]), zero, t(wn[it]), j, res,
                      act, target, j_max)
        assert int(j) == it + 1 and bool(act) == (it + 1 < n_it)
        assert res.numpy() == r
    for a, b in ((tH, H), (tcs, cs), (tsn, sn), (tg, g)):
        assert np.array_equal(a.numpy(), b)
    assert float(res) == 0.0
    before = [x.clone() for x in (tH, tcs, tsn, tg, j, res)]
    AL.lsq_update(tH, tcs, tsn, tg, t(cols[0]), zero, t(wn[0]), j, res, act,
                  target, j_max)
    assert all(torch.equal(a, b) for a, b in
               zip(before, (tH, tcs, tsn, tg, j, res)))


@pytest.mark.parametrize("check_every", [1, 3, 8])
@pytest.mark.parametrize("solver", SOLVERS)
def test_host_reads_of_a_solve(models, monkeypatch, solver, check_every):
    """A solve reads the host ceil(its / check_every) times for its flags
    (one restart cycle for FGMRES) plus once at its end: the count and
    convergence (BiCGStab, CG) or the cycle's H, g, j and convergence
    (FGMRES)."""
    reads = []

    def counted(x):
        reads.append(x)
        return x.tolist()

    system = _system(models["float64"], solver, torch, TB, TP, TS)
    if solver == "fgmres":
        system[4].update(restart=60)
    monkeypatch.setattr(TK, "_host", counted)
    _block_size(monkeypatch, check_every)
    res = _solve(solver, system)
    assert res.converged and res.iterations > 2
    assert len(reads) == math.ceil(res.iterations / check_every) + 1


def _csv_values(path):
    """The csv's value columns (the time columns apart), as text."""
    with open(path) as f:
        rows = [ln.strip().split(",") for ln in f if ln.strip()]
    keep = [i for i, name in enumerate(rows[0])
            if name not in ("time_prec_init", "time_sol")]
    return [[r[i] for i in keep] for r in rows]


@pytest.mark.parametrize("scheme", ["projection", "monolithic"])
def test_chunked_solve_equals_step_by_step(tmp_path, scheme):
    """``solve`` in chunks of the output interval (3 steps) writes the
    value columns of ``solve`` with one step per chunk, bit for bit, and
    ends in the same state."""
    runs = {}
    for step in (3, 1):
        ns = _torch_model(str(tmp_path / f"s{step}"), T=0.06, step=step,
                          scheme=scheme)
        ns.solve()
        runs[step] = ns
    a, b = runs[3], runs[1]
    assert _csv_values(a.config.csv_path) == _csv_values(b.config.csv_path)
    assert len(_csv_values(a.config.csv_path)) == 7
    assert torch.equal(a._u, b._u) and torch.equal(a._p, b._p)
    assert (a.time, a.cd, a.cl) == (b.time, b.cd, b.cl)


def test_restart_at_an_output_boundary_is_continuous(tmp_path):
    """A run restarted from the checkpoint of step 3 (an output boundary)
    gives the continuous run's steps 4-6 and its end state bit for bit,
    as tests/test_e2e.py asks of the JAX package."""
    full = _torch_model(str(tmp_path / "run"), T=0.06, step=3)
    full.solve()
    legs = _torch_model(str(tmp_path / "run"), T=0.06, step=3,
                        csv_path=str(tmp_path / "leg.csv"))
    legs.solve(time_step=3)
    assert _csv_values(legs.config.csv_path)[1:] == \
        _csv_values(full.config.csv_path)[4:]
    assert torch.equal(legs._u, full._u) and torch.equal(legs._p, full._p)
    assert torch.equal(legs._phi, full._phi)


def _closed_channel():
    """The cylinder channel with its outlet made a wall: no pinned
    pressure node, so the Poisson solve keeps its iterate mean-free."""
    mesh = channel_with_cylinder_2d(h=0.1, h_near=0.04)
    mesh.boundary_tags = np.where(mesh.boundary_tags == TAG_OUTLET,
                                  TAG_WALL_TOP, mesh.boundary_tags)
    return mesh


def _forcing(x, t):
    return torch.stack([0.2 * torch.sin(3.0 * x[:, 1]) * (1.0 + t),
                        0.1 * torch.cos(2.0 * x[:, 0])], dim=1)


# the projection options the captured step covers
REPLAY_CASES = {
    "bj": dict(),
    "jacobi": dict(f_precond="jacobi"),
    "diag": dict(f_precond="diag"),
    "bdf1": dict(proj_bdf2=False),
    "exact tiles": dict(bj_newton=0),
    "mean-free": dict(mesh=_closed_channel),
    "forcing": dict(forcing=_forcing),
    "fp32 inner_bf16": dict(dtype="float32", inner_bf16=True),
    "fp32 bj_bf16": dict(dtype="float32", bj_bf16=True),
    "schur": dict(proj_poisson="schur"),
    "p_extrap": dict(proj_p_extrap=0.5),
}


@pytest.mark.parametrize("case", list(REPLAY_CASES))
def test_replay_order_equals_the_plain_step(tmp_path, case):
    """ProjectionGraphs' replay order, rehearsed with its segment functions
    (``_dry``: each loop a while loop) on its static buffers, against the
    plain step: 4 steps, the second and fourth from the plain step between
    replays, bit for bit, with the same counts.  The plain step reads each
    flag before each iteration (krylov ``HOST``) and masks none; the
    rehearsal reads the host only for the tile guard, enters the two loops
    once each, runs one body per iteration, none masked or skipped (every
    test of a flag ran a body or ended a loop)."""
    kw = dict(REPLAY_CASES[case])
    if "mesh" in kw:
        kw["mesh"] = kw["mesh"]()
    a = _torch_model(str(tmp_path / "a"), **kw)
    b = _torch_model(str(tmp_path / "b"), **kw)
    assert b._captures() is False
    ma = [a.solve_time_step() for _ in range(4)]
    b._init_state(0)
    sg = b._graphs = ProjectionGraphs(b, _dry=True)
    mb = (b._read_rows(*sg.run(1)) + [b.solve_time_step(_eager=True)]
          + b._read_rows(*sg.run(1)) + [b.solve_time_step(_eager=True)])
    assert torch.equal(a._u, b._u) and torch.equal(a._p, b._p)
    assert torch.equal(a._phi, b._phi)
    assert b._u is not sg.u           # the last step was the plain one
    guard = int(b._bj_plan is not None and b.config.bj_newton > 0)
    for k, (x, y) in enumerate(zip(ma, mb)):
        for field in ("time", "cd", "cl", "drag", "lift", "residual",
                      "f_iterations", "p_iterations", "converged",
                      "exact_inverse"):
            assert getattr(x, field) == getattr(y, field), field
        its = x.f_iterations + x.p_iterations
        assert x.flag_reads == guard + its + 2
        assert x.masked_iterations == y.masked_iterations == 0
        if k % 2 == 0:                # the replays
            assert y.flag_reads == guard
            assert (y.loops_entered, y.bodies_run) == (2, its)
            assert y.skipped_bodies == 0
    assert b._ap_dir_pinned is (case != "mean-free")


def test_capture_needs_the_card(models):
    """A CPU model steps eagerly: it neither captures nor offers to."""
    ns = models["float64"]
    assert not ns._captures()
    with pytest.raises(ValueError, match="on the card only"):
        ns.capture_graphs()
