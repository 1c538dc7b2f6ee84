"""The V-cycle's smoothing sweeps (kernels/vcycle.py, chained by
solvers/schur.py ``FusedVcycle``) on the CPU, where every sweep runs its
plain version:

* the sweeps' V-cycle equals the plain ``make_vcycle_solver`` and the
  per-stage chain (each stage's plain version one call, r0, d and z + P y
  in work vectors) bit for bit (``torch.equal``) in float32 and float64,
  at 1 and 2 cycles, k = 1, 2, 3, on an outlet-pinned and an unpinned P1
  Laplacian of a small triangulated rectangle (an aggregate size that
  leaves a padded tail), with a seeded non-dyadic lambda_max and
  right-hand side; each sweep alone writes the per-stage chain's bits;
* the coefficients equal, bit for bit, the scalars that ``chebyshev``'s
  loop applies to its vectors (recorded with a TorchFunctionMode);
* the port's V-cycle, built with ``op=`` as the model builds it, and the
  sweeps' one against JAX's ``make_vcycle_solver`` on the same operator
  in float64, within 1e-12 relative on the pinned Laplacian (1e-10 on the
  singular unpinned one: ``test_vcycle_matches_jax``);
* the fused V-cycle's launches: with the kernel call replaced by a CPU
  model of csrc/vcycle.cu's entries (their arguments in order), a captured
  call (``kernels/launches.record_launches``) records one launch per
  sweep, ``launches(n_cycles, k)`` in all, adds nothing to the counts
  until the record is replayed, and gives the plain V-cycle's bits;
* the sweeps' plan: every slice in one CTA's range, the fullest CTA's
  slices and slots, the shared path where the operator fits, the device
  path where it does not or is asked for, rounds 0 (any number of slices
  a warp, the rows' state in the plan's vector) past the kernel's
  register rounds, up to an operator of 1.2 million rows;
* a CPU tensor never reaches the kernel's entry, a sweep missing a buffer
  it needs (or given one it does not take, or writing into memory it
  reads) is refused before any launch, and the model hands its V-cycles
  the operator (one solver per operator, reused every step).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_vcycle.py -q

(about 15 s).
"""

import dataclasses

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


def _stage_chain(op, plan, sc_inv, lam, n_cycles, k):
    """The V-cycle as one call per stage of the stages' plain versions:
    r0 and d in work vectors, z + P y written to z[1], the last step of a
    post-smoothing into z[1] in place (the per-stage chain)."""
    sdinv = torch.where(op.diag != 0, 1.0 / op.diag, torch.ones_like(op.diag))
    coef = VC.coefficients(lam, k)
    new = lambda: torch.empty_like(sdinv)
    r0, d, zc, z = new(), new(), (new(), new()), (new(), new())
    rc = torch.zeros(plan.n_agg * plan.agg, dtype=sdinv.dtype)

    def smooth(r, zin, y, out):
        znew = z[1] if y is not None else None
        VC.cheb_first_plain(op, coef, sdinv, r, zin, d=d, zc=zc[0], r0=r0,
                            y=y, agg=plan.agg, znew=znew, out=out,
                            last=k == 1)
        base = znew if y is not None else zin
        for s in range(k - 1):
            VC.cheb_step_plain(op, coef, s, sdinv, r if zin is None else r0,
                               d, zc[s % 2], zc=zc[1 - s % 2], z=base,
                               out=out, last=s == k - 2)
        return out

    def solve(r):
        zin = None
        for c in range(n_cycles):
            z1 = smooth(r, zin, None, z[0])
            VC.residual_plain(op, r, z1, rc[:op.n])
            y = sc_inv @ rc.view(plan.n_agg, plan.agg).sum(dim=1)
            zin = smooth(r, z1, y, torch.empty_like(r)
                         if c == n_cycles - 1 else z[1])
        return zin

    return solve


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("n_cycles", [1, 2])
@pytest.mark.parametrize("pinned", [True, False], ids=["pinned", "unpinned"])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_stagewise_vcycle_equals_the_plain_one(ops, dt, pinned, n_cycles, k):
    """The sweeps' V-cycle equals the plain cycle and the per-stage
    chain bit for bit, and carries nothing from one call to the next."""
    op, plan, sc_inv, lam = ops[pinned, dt]
    r = _rhs(op.n, DTYPES[dt], 7 + k + 3 * n_cycles)
    want = _plain(op, plan, sc_inv, lam, n_cycles, k)(r)
    chain = _stage_chain(op, plan, sc_inv, lam, n_cycles, k)(r)
    fused = TS.FusedVcycle(op, op.diag, plan, sc_inv, lam, n_cycles, k)
    got = fused(r)
    assert got.dtype == DTYPES[dt] and torch.equal(got, want)
    assert torch.equal(chain, want)
    r2 = _rhs(op.n, DTYPES[dt], 99)
    assert torch.equal(fused(r2), _plain(op, plan, sc_inv, lam, n_cycles,
                                         k)(r2))
    assert torch.equal(fused(r), want)


def _sweep_by_stages(kind, op, ex, b):
    """The sweep ``kind`` on ``example`` inputs as the per-stage chain runs
    its stages, into the buffers ``b``."""
    k, coef, sdinv, r = ex["k"], ex["coef"], ex["sdinv"], ex["r"]
    r0, d, znew = (torch.empty_like(r) for _ in range(3))
    zc = (b["zc0"], b["zc1"])

    def smooth(zin, y, out):
        VC.cheb_first_plain(op, coef, sdinv, r, zin, d=d, zc=zc[0], r0=r0,
                            y=y, agg=ex["agg"], znew=znew, out=out,
                            last=k == 1)
        for s in range(k - 1):
            VC.cheb_step_plain(op, coef, s, sdinv, r if zin is None else r0,
                               d, zc[s % 2], zc=zc[1 - s % 2],
                               z=znew if y is not None else zin, out=out,
                               last=s == k - 2)

    if kind == "pre":
        smooth(None, None, b["z0"])
        VC.residual_plain(op, r, b["z0"], b["rc"])
    elif kind == "mid":
        smooth(b["z0"], ex["y"], b["z1"])
        smooth(b["z1"], None, b["z0"])
        VC.residual_plain(op, r, b["z0"], b["rc"])
    else:
        smooth(b["z0"], ex["y"], b["out"])


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("kind", VC.SWEEPS)
@pytest.mark.parametrize("dt", list(DTYPES))
def test_each_sweep_equals_the_stage_chain(ops, dt, kind, k):
    """A sweep's plain version writes the per-stage chain's bits into
    every buffer it writes and leaves the others as they were."""
    op = ops[True, dt][0]
    ex = VC.example(op, np.random.default_rng(20 + k), k=k, agg=8)
    got = VC.run_case(kind, op, ex, plain=True)
    want = {b: ex[b].clone() for b in VC.BUFFERS}
    _sweep_by_stages(kind, op, ex, want)
    for b in VC.BUFFERS:
        assert torch.equal(got[b], want[b]), b
    written = {b for b in VC.BUFFERS if not torch.equal(got[b], ex[b])}
    assert written <= set(VC.WRITES[kind])
    assert ("zc0" in written) == (k > 1) and ("zc1" in written) == (k > 2)
    assert torch.equal(VC.run_case(kind, op, ex)["z0"], got["z0"])


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


# csrc/vcycle.cu's entries: the vectors each takes after the plan and the
# operator (the progress words, the neighbour lists and the stream follow)
ENTRIES = {
    "pre": ("coef", "sdinv", "r", "k", "zc0", "zc1", "z0", "rc"),
    "mid": ("coef", "sdinv", "r", "y", "agg", "k", "zc0", "zc1", "z0", "z1",
            "rc"),
    "post": ("coef", "sdinv", "r", "y", "agg", "k", "zc0", "zc1", "z0",
             "out"),
}


def _kernel_model(op, calls):
    """A CPU model of csrc/vcycle.cu's entries: the sweep on the arguments
    the wrapper hands the entry, in its order, as the stages run it."""

    def call(kind, op_, plan_, *args):
        assert op_ is op
        a = dict(zip(ENTRIES[kind], args, strict=True))
        calls.append((kind, a))
        ex = dict(k=a["k"], coef=a["coef"], sdinv=a["sdinv"], r=a["r"],
                  y=a.get("y"), agg=a.get("agg", 0))
        b = {n: a.get(n) for n in VC.BUFFERS}
        _sweep_by_stages(kind, op, ex, b)

    return call


def test_the_wrapper_hands_the_entries_their_arguments():
    assert VC.ENTRIES == ENTRIES
    assert set(VC.WRITES) == set(ENTRIES) == set(VC.SWEEPS)
    for kind, names in VC.WRITES.items():
        assert set(names) <= set(ENTRIES[kind])


@pytest.mark.parametrize("n_cycles,k", [(1, 3), (2, 3), (2, 1), (3, 2)])
def test_launches_recorded_once_per_stage(ops, monkeypatch, n_cycles, k):
    """One launch recorded per sweep: a pre, n_cycles - 1 mid and a post,
    ``launches(n_cycles, k)`` with the coarse correction's kernels."""
    op, plan, sc_inv, lam = ops[False, "f32"]
    calls = []
    monkeypatch.setattr(VC, "_device", lambda r: True)
    monkeypatch.setattr(VC, "_call_kernel", _kernel_model(op, calls))
    fused = TS.FusedVcycle(op, op.diag, plan, sc_inv, lam, n_cycles, k)
    r = _rhs(op.n, torch.float32, 5)
    VC.COUNTS.reset()
    with record_launches() as rec:
        got = fused(r)
    assert dict(VC.COUNTS.__dict__) == dict(pre=0, mid=0, post=0,
                                            plain_cuda_calls=0)
    assert torch.equal(got, _plain(op, plan, sc_inv, lam, n_cycles, k)(r))
    sweeps, most = VC.launches(n_cycles, k)
    assert (sweeps, most) == (n_cycles + 1, 3 * n_cycles + 1)
    assert len(rec.launches) == len(calls) == sweeps
    assert [kind for kind, _ in calls] == (["pre"] + ["mid"] * (n_cycles - 1)
                                           + ["post"])
    rec.replay(2)
    assert (VC.COUNTS.pre, VC.COUNTS.mid, VC.COUNTS.post) \
        == (2, 2 * (n_cycles - 1), 2)
    # what the wrapper hands the kernel: the solver's own buffers, the
    # prolongation's y and agg in the mid and post sweeps, k
    for kind, a in calls:
        assert a["k"] == k and a["z0"] is fused.z[0]
        assert a["zc0"] is fused.zc[0] and a["zc1"] is fused.zc[1]
        if kind != "pre":
            assert a["agg"] == plan.agg
            assert a["y"].shape == (plan.n_agg,)
        if kind != "post":
            assert a["rc"].data_ptr() == fused.rc.data_ptr()
    assert calls[-1][1]["out"] is got
    with pytest.raises(ValueError):
        VC.launches(0, k)
    VC.COUNTS.reset()


def test_cpu_tensors_never_reach_the_kernel(ops, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("the kernel's entry was called")
    monkeypatch.setattr(VC, "_call_kernel", refuse)
    op, plan, sc_inv, lam = ops[True, "f32"]
    VC.COUNTS.reset()
    TS.FusedVcycle(op, op.diag, plan, sc_inv, lam, 1, 3)(
        _rhs(op.n, torch.float32, 1))
    assert VC.COUNTS.pre == VC.COUNTS.post == VC.COUNTS.plain_cuda_calls == 0


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
    """Before any launch: a sweep without a buffer it writes or a vector
    it reads, given a vector it does not take, writing into memory it
    reads, or with more iterations than its coefficients serve, raises
    (its entry would read or write through a null or wrong pointer)."""
    called = []
    monkeypatch.setattr(VC, "_device", lambda r: True)
    monkeypatch.setattr(VC, "_call_kernel", lambda *a: called.append(a[0]))
    op = ops[True, "f32"][0]
    ex = VC.example(op, np.random.default_rng(6), agg=8)
    args = (op, None, ex["coef"], ex["sdinv"], ex["r"])
    bufs = dict(k=3, zc0=ex["zc0"], zc1=ex["zc1"], z0=ex["z0"])
    with pytest.raises(ValueError, match="needs"):
        VC.sweep("pre", *args, **bufs)
    with pytest.raises(ValueError, match="needs"):
        VC.sweep("mid", *args, z1=ex["z1"], rc=ex["rc"], agg=8, **bufs)
    with pytest.raises(ValueError, match="needs"):
        VC.sweep("post", *args, y=ex["y"], agg=8, **bufs)
    with pytest.raises(ValueError, match="needs"):
        VC.sweep("pre", *args, rc=ex["rc"], **dict(bufs, zc1=None))
    with pytest.raises(ValueError, match="takes no"):
        VC.sweep("pre", *args, rc=ex["rc"], y=ex["y"], agg=8, **bufs)
    with pytest.raises(ValueError, match="shares memory"):
        VC.sweep("post", *args, y=ex["y"], agg=8, out=ex["z0"], **bufs)
    with pytest.raises(ValueError, match="shares memory"):
        VC.sweep("mid", *args, y=ex["y"], agg=8, z1=ex["z1"], rc=ex["r"],
                 **bufs)
    with pytest.raises(ValueError, match="coefficients"):
        VC.sweep("pre", *args, rc=ex["rc"], **dict(bufs, k=4))
    with pytest.raises(ValueError, match="cover"):
        VC.sweep("post", *args, y=ex["y"][:3], agg=8, out=ex["out"], **bufs)
    with pytest.raises(ValueError, match="no sweep"):
        VC.sweep("first", *args, rc=ex["rc"], **bufs)
    assert called == []
    VC.sweep("pre", *args, rc=ex["rc"], **bufs)
    VC.sweep("post", *args, y=ex["y"], agg=8, out=ex["out"], **bufs)
    assert called == ["pre", "post"]
    VC.COUNTS.reset()


def _card(sms=4, optin=4096, per_sm=None):
    """A fake card for ``choose``: ``per_sm(rounds, shared, smem)`` CTAs an
    SM (default 1), and the queries made."""
    asked = []

    def query(rounds, shared, smem):
        asked.append((rounds, shared, smem))
        return dict(per_sm=1 if per_sm is None else per_sm(rounds, shared,
                                                           smem),
                    sms=sms, optin=optin, regs=40, local=0)

    return query, asked


def _ptr(widths):
    return np.concatenate([[0], np.cumsum(np.asarray(widths) * 32)]).astype(
        np.int64)


@pytest.mark.parametrize("n,grid", [(1, 1), (7, 3), (132, 132), (3543, 132),
                                    (4399, 132), (4399, 264), (5, 8)])
def test_layout_gives_each_cta_a_contiguous_range(n, grid):
    """csrc/vcycle.cu's split: CTA b takes [b n / G, (b + 1) n / G); every
    slice in exactly one range; ``layout`` the fullest one's slices and
    slots."""
    widths = np.random.default_rng(n).integers(1, 9, size=n)
    ptr = _ptr(widths)
    cut = [b * n // grid for b in range(grid + 1)]
    assert cut[0] == 0 and cut[-1] == n and sorted(cut) == cut
    slices, slots = VC.layout(ptr, grid)
    assert slices == max(b - a for a, b in zip(cut, cut[1:])) == -(-n // grid)
    assert slots == max(32 * widths[a:b].sum() for a, b in zip(cut, cut[1:]))


def test_choose_takes_shared_memory_where_the_operator_fits():
    widths = np.full(300, 4)              # 128 slots a slice
    ptr = _ptr(widths)
    query, asked = _card(sms=4, optin=300_000)
    p = VC.choose(ptr, 4, query)
    # 300 slices on 4 CTAs: 75 a CTA, 3 rounds of 32 warps -> 4
    assert (p.path, p.grid, p.rounds, p.per_sm, p.slices) == ("shared", 4, 4,
                                                             1, 75)
    assert p.smem == VC.smem_bytes(75 * 128, 4) == 16 + 75 * 128 * 8
    assert asked[-1] == (4, True, p.smem)
    # two CTAs an SM where the card holds them: 8 CTAs, 38 slices, 2 rounds
    query, _ = _card(sms=4, optin=300_000, per_sm=lambda r, s, m: 2)
    p = VC.choose(ptr, 8, query)
    assert (p.path, p.grid, p.rounds, p.per_sm) == ("shared", 8, 2, 2)
    assert p.smem == 16 + 38 * 128 * 12
    # too little shared memory, or asked: the device path, no smem
    query, _ = _card(sms=4, optin=10_000)
    p = VC.choose(ptr, 4, query)
    assert (p.path, p.smem, p.grid) == ("device", 0, 4)
    query, _ = _card(sms=4, optin=300_000)
    assert VC.choose(ptr, 4, query, path="device").path == "device"
    with pytest.raises(ValueError, match="no sweep plan"):
        VC.choose(ptr, 4, _card(sms=4, optin=10_000)[0], path="shared")
    # a grid of no more CTAs than slices
    p = VC.choose(_ptr([2, 3]), 4, _card(sms=132, optin=300_000)[0])
    assert (p.grid, p.rounds, p.slices) == (2, 1, 1)


@pytest.mark.parametrize("grid", [1, 2, 3, 5])
@pytest.mark.parametrize("pinned", [True, False], ids=["pinned", "unpinned"])
def test_neighbours_are_the_ctas_a_cta_reads_or_is_read_by(ops, pinned,
                                                            grid):
    """Brute force over the slots: CTA b waits for c exactly when one of
    b's live slots gathers a row of c or one of c's gathers a row of b."""
    op = ops[pinned, "f64"][0]
    ptr = op.mat.slice_ptr.numpy().astype(np.int64)
    rows = op.mat.rows.numpy().astype(np.int64)
    cols = op.mat.cols.numpy().astype(np.int64)
    n = len(ptr) - 1
    cta_of_slice = [next(b for b in range(grid) if b * n // grid <= s
                         < (b + 1) * n // grid) for s in range(n)]
    cta_of_row = {}
    for lane, row in enumerate(rows):
        if row >= 0:
            cta_of_row[row] = cta_of_slice[lane // 32]
    want = {b: set() for b in range(grid)}
    for s in range(n):
        w = (ptr[s + 1] - ptr[s]) // 32
        for lane in range(32):
            if rows[s * 32 + lane] < 0:
                continue
            for j in range(w):
                g = j // 4
                slot = (ptr[s] + g * 128 + lane * 4 + j % 4 if g < w // 4
                        else ptr[s] + (w // 4) * 128 + (j % 4) * 32 + lane)
                a, c = cta_of_slice[s], cta_of_row[cols[slot]]
                if a != c:
                    want[a].add(c)
                    want[c].add(a)
    nb_ptr, nb_idx = VC.neighbours(ptr, rows, cols, grid)
    assert nb_ptr[0] == 0 and nb_ptr[-1] == len(nb_idx)
    for b in range(grid):
        got = nb_idx[nb_ptr[b]:nb_ptr[b + 1]]
        assert list(got) == sorted(want[b]), b
    if grid > 1:
        assert len(nb_idx) > 0


def test_choose_refuses_past_the_kernels_rounds():
    """Past the kernel's register rounds (4 x 32 slices a CTA) the plan
    takes rounds 0, any number of slices a warp on the device path, and
    refuses nothing but a path it does not know or a shared path that
    cannot hold the CTA's slices."""
    ptr = _ptr(np.full(4 * 32 * 4 + 1, 1))     # one slice past 4 rounds
    p = VC.choose(ptr, 4, _card(sms=4, optin=10 ** 7)[0])
    assert (p.rounds, p.slices, p.path, p.smem) == (0, 129, "device", 0)
    p = VC.choose(ptr[:-1], 4, _card(sms=4, optin=10 ** 7)[0])
    assert (p.rounds, p.slices, p.path) == (4, 128, "shared")
    with pytest.raises(ValueError, match="no sweep plan"):
        VC.choose(ptr, 4, _card(sms=4, optin=10 ** 7)[0], path="shared")
    with pytest.raises(ValueError, match="no path"):
        VC.choose(ptr, 4, _card()[0], path="l2")


@pytest.mark.parametrize("itemsize", [4, 8])
def test_choose_plans_an_operator_of_a_million_rows(itemsize):
    """A P1 operator of 1.2 million rows (3D-1Z at about half its
    spacing), 15 slots a row, on the H100's 132 SMs and 227 KB of shared
    memory: the device path at rounds 0, 285 slices a CTA, and the query
    asked for that kernel."""
    n_rows = 1_200_000
    ptr = _ptr(np.full(-(-n_rows // 32), 15))
    query, asked = _card(sms=132, optin=232_448)
    p = VC.choose(ptr, itemsize, query)
    assert (p.path, p.rounds, p.grid, p.per_sm, p.smem) == ("device", 0,
                                                            132, 1, 0)
    assert p.slices == VC.layout(ptr, 132)[0] == 285
    assert asked[-1] == (0, False, 0)


def test_attach_gives_rounds_0_its_state_vector(ops, monkeypatch):
    """``attach`` hands a plan of rounds 0, and only it, r0 and d of every
    row (2 n), and a sweep refuses a plan whose state does not match its
    rounds before any launch."""
    op = ops[True, "f32"][0]
    ptr = op.mat.slice_ptr.numpy().astype(np.int64)
    chosen = VC.choose(ptr, 4, _card(sms=2, optin=10 ** 7)[0])
    assert chosen.rounds == 1 and VC.attach(op, chosen).state is None
    p0 = VC.attach(op, dataclasses.replace(chosen, rounds=0,
                                           path="device", smem=0))
    assert p0.state.shape == (2 * op.n,) and p0.state.dtype == op.vals.dtype
    assert p0.flags.shape == (p0.grid,) and not bool(p0.flags.any())
    monkeypatch.setattr(VC, "_device", lambda r: True)
    ex = VC.example(op, np.random.default_rng(7), agg=8)
    for bad in (dataclasses.replace(p0, state=None),
                dataclasses.replace(p0, state=p0.state[:op.n]),
                dataclasses.replace(VC.attach(op, chosen), state=p0.state)):
        with pytest.raises(ValueError, match="state vector"):
            VC.run_case("pre", op, ex, bad)
