"""The V-cycle's fused Chebyshev stages (kernels/vcycle.py, chained by
solvers/schur.py ``FusedVcycle``) on the CPU, where every stage runs its
plain version:

* the stagewise V-cycle equals the plain ``make_vcycle_solver`` bit for
  bit (``torch.equal``) in float32 and float64, at 1 and 2 cycles, k = 1,
  2, 3, on an outlet-pinned and an unpinned P1 Laplacian of a small
  triangulated rectangle (an aggregate size that leaves a padded tail),
  with a seeded non-dyadic lambda_max and right-hand side;
* the coefficients equal, bit for bit, the scalars that ``chebyshev``'s
  loop applies to its vectors (recorded with a TorchFunctionMode);
* the port's V-cycle, built with ``op=`` as the model builds it, and the
  stagewise one against JAX's ``make_vcycle_solver`` on the same
  operator in float64, within 1e-12 relative on the pinned Laplacian
  (1e-10 on the singular unpinned one: ``test_vcycle_matches_jax``);
* the fused V-cycle's launches: with the kernel call replaced by a CPU
  model of csrc/vcycle.cu's entries (their arguments in order), a captured
  call (``kernels/launches.record_launches``) records one launch per stage,
  ``launches(n_cycles, k)`` in all, adds nothing to the counts until the
  record is replayed, and gives the plain V-cycle's bits;
* a CPU tensor never reaches the kernel's entry, a stage missing a buffer
  it needs is refused before any launch, and the model hands its
  V-cycles the operator (one solver per operator, reused every step).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_vcycle.py -q

(about 10 s).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from navierstokes_tpu.solvers import schur as JS
from navierstokes_tpu_torch.fem.spaces import TaylorHoodSpace
from navierstokes_tpu_torch.kernels import vcycle as VC
from navierstokes_tpu_torch.kernels.launches import record_launches
from navierstokes_tpu_torch.kernels.sell_spmv import sell_spmv_plain
from navierstokes_tpu_torch.mesh.generators import rectangle_2d
from navierstokes_tpu_torch.ops import p1ell as TP
from navierstokes_tpu_torch.solvers import schur as TS

torch.set_num_threads(2)
BP, AGG_BLOCKS = 4, 2             # 8 rows per aggregate: 180 rows, 184 padded
DTYPES = {"f32": torch.float32, "f64": torch.float64}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _laplacian(pinned, dtype):
    """(P1Matrix, CoarsePlan, sc_inv, lam) of the P1 stiffness Laplacian
    on a 14 x 11 triangulated rectangle, pinned at the x = 1 side (tag 1,
    as the model pins the outlet) or not, with the model's coarse inverse
    (``NavierStokes._coarse_statics``) and a seeded non-dyadic lambda_max
    near the power estimate."""
    mesh = rectangle_2d(1.0, 0.8, 14, 11)
    sp = TaylorHoodSpace(mesh)
    pin = (np.unique(mesh.boundary_faces[mesh.boundary_tags == 1])
           if pinned else None)
    op = TP.assemble_p1_stiffness(sp, None, dtype, "cpu", b=BP,
                                  dirichlet_nodes=pin)
    plan = TS.build_coarse_plan(sp.n_p1, BP, AGG_BLOCKS)
    sc = TP.coarse_from_ell(op, AGG_BLOCKS)
    scale = np.abs(np.diag(sc)).mean() + 1e-30
    sc_inv = torch.as_tensor(
        np.linalg.inv(sc + 1e-8 * scale * np.eye(sc.shape[0])), dtype=dtype)
    sdinv = torch.where(op.diag != 0, 1.0 / op.diag, torch.ones_like(op.diag))
    est = TS.estimate_lam_max(lambda v: TP.ell_matvec(op, v), sdinv,
                              sp.n_p1, dtype)
    factor = np.random.default_rng(19 + pinned).uniform(0.93, 1.07)
    lam = torch.tensor(float(est) * factor, dtype=dtype)
    return op, plan, sc_inv, lam


@pytest.fixture(scope="module")
def ops():
    return {(pinned, name): _laplacian(pinned, dt)
            for pinned in (True, False) for name, dt in DTYPES.items()}


def _rhs(n, dtype, seed):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(n),
                           dtype=dtype)


def _plain(op, plan, sc_inv, lam, n_cycles, k):
    return TS.make_vcycle_solver(lambda v: TP.ell_matvec(op, v), op.diag,
                                 plan, sc_inv, n_cycles=n_cycles,
                                 smooth_k=k, lam_max=lam)


def test_the_operator_leaves_a_padded_tail(ops):
    op, plan, _, _ = ops[True, "f64"]
    assert plan.n_agg * plan.agg > op.n > (plan.n_agg - 1) * plan.agg
    assert bool((op.diag > 0).all())


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("n_cycles", [1, 2])
@pytest.mark.parametrize("pinned", [True, False], ids=["pinned", "unpinned"])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_stagewise_vcycle_equals_the_plain_one(ops, dt, pinned, n_cycles, k):
    op, plan, sc_inv, lam = ops[pinned, dt]
    r = _rhs(op.n, DTYPES[dt], 7 + k + 3 * n_cycles)
    want = _plain(op, plan, sc_inv, lam, n_cycles, k)(r)
    fused = TS.FusedVcycle(op, op.diag, plan, sc_inv, lam, n_cycles, k)
    got = fused(r)
    assert got.dtype == DTYPES[dt] and torch.equal(got, want)
    # the static buffers carry nothing from one call to the next
    r2 = _rhs(op.n, DTYPES[dt], 99)
    assert torch.equal(fused(r2), _plain(op, plan, sc_inv, lam, n_cycles,
                                         k)(r2))
    assert torch.equal(fused(r), want)


class _Scalars(TorchFunctionMode):
    """The 0-d tensors that scale or divide a vector, in order."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if len(args) == 2 and all(torch.is_tensor(a) for a in args):
            a, b = args
            if name == "mul" and a.dim() == 0 and b.dim() == 1:
                self.seen.append(a.clone())
            if name == "div" and a.dim() == 1 and b.dim() == 0:
                self.seen.append(b.clone())
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("k", [1, 2, 3, 5])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_coefficients_are_the_loops_scalars(ops, dt, k):
    op, _, _, lam = ops[True, dt]
    sdinv = torch.where(op.diag != 0, 1.0 / op.diag, torch.ones_like(op.diag))
    mode = _Scalars()
    with mode:
        TS.chebyshev(lambda v: TP.ell_matvec(op, v), sdinv, lam,
                     _rhs(op.n, DTYPES[dt], 3), k)
    coef = VC.coefficients(lam, k)
    assert coef.shape == (1 + 2 * (k - 1),) and coef.dtype == DTYPES[dt]
    assert len(mode.seen) == coef.numel()
    bits = torch.int32 if dt == "f32" else torch.int64
    for i, s in enumerate(mode.seen):
        assert torch.equal(coef[i].view(bits), s.view(bits)), i
    with pytest.raises(TypeError):
        VC.coefficients(float(lam), k)


def _jax_vcycle(op, plan, sc_inv, lam, n_cycles, k):
    """JAX's V-cycle on the same operator (a dense matrix of the host
    values), plan sizes, coarse inverse and lambda_max."""
    a = np.zeros((op.n, op.n))
    np.add.at(a, (op.mat.nz_row, op.mat.nz_col), op.host_vals)
    A = jnp.asarray(a)
    jplan = JS.CoarsePlan(pair_scatter=None, n_agg=plan.n_agg, agg=plan.agg,
                          n_p1=plan.n_p1)
    return JS.make_vcycle_solver(lambda v: A @ v, jnp.asarray(op.diag.numpy()),
                                 jplan, jnp.asarray(sc_inv.numpy()),
                                 n_cycles=n_cycles, smooth_k=k,
                                 lam_max=jnp.asarray(float(lam)))


@pytest.mark.parametrize("n_cycles,k", [(1, 3), (2, 2), (2, 3)])
@pytest.mark.parametrize("pinned", [True, False], ids=["pinned", "unpinned"])
def test_vcycle_matches_jax(ops, pinned, n_cycles, k):
    """1e-12 on the pinned Laplacian.  The unpinned one is singular: it
    runs as the model runs it, a mean-free right-hand side (the closed
    domain's compatible CG residual) and the output's mean taken out
    (``_proj_poisson``), and is held to 1e-10, since its coarse inverse's
    1e-8 shift scales the last-bit gaps of the two products (a dense sum
    against the SELL row sums) by up to about 1e8 (measured 2.6e-11)."""
    op, plan, sc_inv, lam = ops[pinned, "f64"]
    r = _rhs(op.n, torch.float64, 41 + n_cycles)
    out, tol = (lambda z: z), 1e-12
    if not pinned:
        r = r - r.mean()
        out, tol = (lambda z: z - z.mean()), 1e-10
    want = np.asarray(out(_jax_vcycle(op, plan, sc_inv, lam, n_cycles, k)(
        jnp.asarray(r.numpy()))))
    built = TS.make_vcycle_solver(lambda v: TP.ell_matvec(op, v), op.diag,
                                  plan, sc_inv, n_cycles=n_cycles,
                                  smooth_k=k, lam_max=lam, op=op)
    assert not isinstance(built, TS.FusedVcycle)    # the CPU: plain cycle
    assert _rel(out(built(r)).numpy(), want) < tol
    fused = TS.FusedVcycle(op, op.diag, plan, sc_inv, lam, n_cycles, k)
    assert _rel(out(fused(r)).numpy(), want) < tol


# csrc/vcycle.cu's entries: the arguments each takes after the operator
ENTRIES = {
    "first": ("coef", "sdinv", "r", "z", "y", "agg", "r0", "d", "zc",
              "znew"),
    "first_last": ("coef", "sdinv", "r", "z", "y", "agg", "out"),
    "step": ("coef", "step", "sdinv", "r0", "d", "zc", "zc_out"),
    "step_last": ("coef", "step", "sdinv", "r0", "d", "zc", "z", "out"),
    "residual": ("r", "x", "out"),
}


def _kernel_model(op, calls):
    """A CPU model of csrc/vcycle.cu's entries: the stage on the arguments
    the wrapper hands the entry, in its order (None: a null pointer)."""
    S = lambda x: sell_spmv_plain(op.mat, op.vals, x)

    def call(entry, op_, *args):
        assert op_ is op
        a = dict(zip(ENTRIES[entry], args, strict=True))
        calls.append((entry, sorted(k for k, v in a.items()
                                    if v is not None)))
        if entry in ("first", "first_last"):
            x = a["z"]
            if x is not None and a["y"] is not None:
                x = x + torch.repeat_interleave(a["y"], a["agg"])[:op.n]
            r0 = a["r"] if x is None else a["r"] - S(x)
            d = (a["sdinv"] * r0) / a["coef"][0]
            if entry == "first_last":
                a["out"].copy_((torch.zeros_like(d) if x is None else x) + d)
                return
            if x is not None:
                a["r0"].copy_(r0)
            a["d"].copy_(d)
            a["zc"].copy_(d)
            if a["y"] is not None:
                a["znew"].copy_(x)
        elif entry in ("step", "step_last"):
            c, i = a["coef"], a["step"]
            d = c[1 + 2 * i] * a["d"] + c[2 + 2 * i] * (
                a["sdinv"] * (a["r0"] - S(a["zc"])))
            zc = a["zc"] + d
            if entry == "step_last":
                z = a["z"]
                a["out"].copy_((torch.zeros_like(zc) if z is None else z)
                               + zc)
                return
            a["d"].copy_(d)
            a["zc_out"].copy_(zc)
        else:
            a["out"].copy_(a["r"] - S(a["x"]))

    return call


@pytest.mark.parametrize("n_cycles,k", [(1, 3), (2, 3), (2, 1)])
def test_launches_recorded_once_per_stage(ops, monkeypatch, n_cycles, k):
    op, plan, sc_inv, lam = ops[False, "f32"]
    calls = []
    monkeypatch.setattr(VC, "_device", lambda r: True)
    monkeypatch.setattr(VC, "_call_kernel", _kernel_model(op, calls))
    fused = TS.FusedVcycle(op, op.diag, plan, sc_inv, lam, n_cycles, k)
    r = _rhs(op.n, torch.float32, 5)
    VC.COUNTS.reset()
    with record_launches() as rec:
        got = fused(r)
    assert dict(VC.COUNTS.__dict__) == dict(cheb_first=0, cheb_step=0,
                                            residual=0, plain_cuda_calls=0)
    assert torch.equal(got, _plain(op, plan, sc_inv, lam, n_cycles, k)(r))
    fused_n, most = VC.launches(n_cycles, k)
    assert len(rec.launches) == len(calls) == fused_n
    assert most == fused_n + VC.STOCK_PER_CYCLE * n_cycles
    rec.replay(2)
    assert (VC.COUNTS.cheb_first, VC.COUNTS.cheb_step, VC.COUNTS.residual) \
        == (2 * 2 * n_cycles, 2 * 2 * (k - 1) * n_cycles, 2 * n_cycles)
    # what the wrapper hands the kernel: the first cycle's cheb_first has
    # no z (no product, no r0); the post-smoothing's takes y and writes
    # znew unless it is the last stage; a last stage writes only out
    first = [(e, names) for e, names in calls if e.startswith("first")]
    assert "z" not in first[0][1] and "r0" not in first[0][1]
    entry, post = first[1]
    assert {"z", "y"} <= set(post)
    assert ("znew" in post) == (k > 1)
    assert entry == ("first_last" if k == 1 else "first")
    steps = [e for e, _ in calls if e.startswith("step")]
    smoothing = ["step"] * (k - 2) + ["step_last"] if k > 1 else []
    assert steps == smoothing * 2 * n_cycles
    VC.COUNTS.reset()


def test_cpu_tensors_never_reach_the_kernel(ops, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("the kernel's entry was called")
    monkeypatch.setattr(VC, "_call_kernel", refuse)
    op, plan, sc_inv, lam = ops[True, "f32"]
    VC.COUNTS.reset()
    TS.FusedVcycle(op, op.diag, plan, sc_inv, lam, 1, 3)(
        _rhs(op.n, torch.float32, 1))
    assert VC.COUNTS.cheb_first == VC.COUNTS.plain_cuda_calls == 0


def test_the_model_hands_its_vcycles_the_operator(tmp_path, monkeypatch):
    """The projection step's Poisson preconditioner and the ``cc`` Ap
    solve reach ``make_vcycle_solver`` with their P1Matrix, once per
    operator (reused by the next step)."""
    from navierstokes_tpu_torch.config import InletConfig, SolverConfig
    from navierstokes_tpu_torch.mesh.generators import \
        channel_with_cylinder_2d
    from navierstokes_tpu_torch.models import navier_stokes as NSM
    made = []
    real = NSM.make_vcycle_solver

    def spy(*args, op=None, **kw):
        made.append(op)
        return real(*args, op=op, **kw)

    monkeypatch.setattr(NSM, "make_vcycle_solver", spy)
    mesh = channel_with_cylinder_2d(h=0.15)
    for scheme in ("projection", "monolithic"):
        cfg = SolverConfig(scheme=scheme, output_dir=str(tmp_path),
                           cache_dir=str(tmp_path),
                           csv_path=str(tmp_path / "forces.csv"))
        ns = NSM.NavierStokes(mesh, 2, 1, 0.01, 0.02, 1,
                              InletConfig(kind="parabolic", u_m=0.3,
                                          height=0.41), cfg, device="cpu")
        ns.set_re_number(20)
        ns.setup()
        made.clear()
        ns.solve_time_step(_eager=True)
        ns.solve_time_step(_eager=True)
        want = ns._ap_dir if scheme == "projection" else ns._ap
        assert made == [want]


def test_a_stage_missing_a_buffer_is_refused(ops, monkeypatch):
    """Before any launch: a stage without a buffer it writes or a vector
    it reads raises (its entry would read or write through a null
    pointer)."""
    called = []
    monkeypatch.setattr(VC, "_device", lambda r: True)
    monkeypatch.setattr(VC, "_call_kernel", lambda *a: called.append(a[0]))
    op = ops[True, "f32"][0]
    ex = VC.example(op, np.random.default_rng(6), agg=8)
    args = (op, ex["coef"], ex["sdinv"], ex["r"])
    with pytest.raises(ValueError, match="needs"):
        VC.cheb_first(*args, ex["x"], zc=ex["zc"], r0=ex["r0"])
    with pytest.raises(ValueError, match="needs"):
        VC.cheb_first(*args, ex["x"], d=ex["d"], zc=ex["zc"], y=ex["y"],
                      agg=8, r0=ex["r0"])
    with pytest.raises(ValueError, match="needs"):
        VC.cheb_step(op, ex["coef"], 0, ex["sdinv"], ex["r0"], ex["d"],
                     ex["x"], last=True)
    with pytest.raises(ValueError, match="needs"):
        VC.residual(op, ex["r"], None, ex["out"])
    with pytest.raises(ValueError, match="prolongation"):
        VC.cheb_first(*args, None, y=ex["y"], agg=8, out=ex["out"],
                      last=True)
    assert called == []
    VC.cheb_first(*args, None, out=ex["out"], last=True)
    VC.residual(op, ex["r"], ex["x"], ex["out"])
    assert called == ["first_last", "residual"]
    VC.COUNTS.reset()
