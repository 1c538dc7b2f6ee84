"""BiCGStab's and CG's fused update stages (kernels/krylov_update.py) on
the CPU: each plain stage against the loop body's inline torch sequence
it replaced, bit for bit, in float64 and float32, with the flag up and
down (down: every state buffer unchanged); the CG stages' own dots and
norm against numpy's float64 sums; whole loops against that inline body
and against the JAX package's ``bicgstab`` / ``cg`` in float64 (x within
1e-12 of max|x|, the same iteration counts and stopping k: the only
difference is the dots' summation order); and the wrapper's dispatch,
which takes the plain version only for CPU tensors and raises without
the kernel library.  The kernels themselves are held to the plain
stages on the card (tests/test_torch_cuda.py, ``chip_smoke.py`` phase
26)."""

import math
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokes_tpu.solvers import krylov as JK
from navierstokes_tpu_torch.kernels import build
from navierstokes_tpu_torch.kernels import krylov_update as KU
from navierstokes_tpu_torch.solvers import krylov as TK

DTYPES = [torch.float64, torch.float32]
N = 37


def _inputs(stage, dtype, active, seed):
    """Each stage's tensors, seeded, in its argument order."""
    return KU.example(stage, N, dtype, "cpu", np.random.default_rng(seed),
                      active=active)


def _at(stage, name):
    return KU.ARGS[stage].index(name)


def _inline(stage, args):
    """The loop bodies' inline sequence before the fused stages: the new
    values of each stage's state, committed under the flag as
    ``_commit`` did (``torch.where(active, new, old)``)."""
    a = args[-1]
    where = lambda new, old: torch.where(a, new, old)
    if stage == "bicgstab_p":
        p, r, v, rho_new, rho, alpha, omega, eps, _ = args
        safe = lambda q: torch.where(q.abs() > eps, q, eps)
        beta = (rho_new / safe(rho)) * (alpha / safe(omega))
        return [where(r + beta * (p - omega * v), p)] + args[1:]
    if stage == "bicgstab_s":
        s, v_state, r, v, rho_new, denom, eps, _ = args
        safe = lambda q: torch.where(q.abs() > eps, q, eps)
        alpha = rho_new / safe(denom)
        return [r - alpha * v, where(v, v_state)] + args[2:]
    if stage == "bicgstab_xr":
        (x, r, phat, shat, s, t, rho_new, denom, ts, tt, eps, rho, alpha_s,
         omega_s, stag, k, _) = args
        safe = lambda q: torch.where(q.abs() > eps, q, eps)
        alpha = rho_new / safe(denom)
        omega = ts / torch.where(tt > eps, tt, eps)
        x_new = x + alpha * phat + omega * shat
        r_new = s - omega * t
        stag_new = (rho_new.abs() <= eps) | (denom.abs() <= eps)
        return [where(x_new, x), where(r_new, r)] + args[2:11] + [
            where(rho_new, rho), where(alpha, alpha_s),
            where(omega, omega_s), where(stag_new, stag), k + a, a]
    if stage == "cg_xr":
        x, r, p, ap, rz, pap, rnorm, _ = args
        d = _dot64(p, ap)
        alpha = rz / torch.clamp(d, min=1e-30)
        r_new = r - alpha * ap
        return [where(x + alpha * p, x), where(r_new, r)] + args[2:5] + [
            where(d, pap), where(_norm64(r_new), rnorm), a]
    p, z, r, rz, k, _ = args
    rz_new = _dot64(r, z)
    beta = rz_new / torch.clamp(rz, min=1e-30)
    return [where(z + beta * p, p), z, r, where(rz_new, rz), k + a, a]


def _dot64(a, b):
    """The CG stages' dot written out: the float64 dot, one rounding to
    a's dtype."""
    return torch.dot(a.to(torch.float64), b.to(torch.float64)).to(a.dtype)


def _norm64(v):
    """The norm written out: the float64 norm, one rounding to v's
    dtype."""
    return torch.linalg.vector_norm(v.to(torch.float64)).to(v.dtype)


@pytest.mark.parametrize("active", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("stage", KU.STAGES)
def test_plain_stage_equals_the_inline_body(stage, dtype, active):
    args = _inputs(stage, dtype, active, seed=KU.STAGES.index(stage))
    before = [t.clone() for t in args]
    want = _inline(stage, [t.clone() for t in args])
    KU.update(stage, *args)
    for i, (got, ref) in enumerate(zip(args, want)):
        assert got.dtype == ref.dtype and torch.equal(got, ref), (stage, i)
    if not active:
        # the scratch (s) aside, no buffer moved
        for name, got, old in zip(KU.ARGS[stage], args, before):
            if name not in KU.SCRATCH.get(stage, ()):
                assert torch.equal(got, old), (stage, name)


@pytest.mark.parametrize("dtype", DTYPES)
def test_guards_take_eps_and_the_clamp(dtype):
    """The breakdown guards with zero scalars: beta and alpha divide by
    eps, omega's tt by eps, CG's clamp by 1e-30; the flag records the
    breakdown."""
    args = _inputs("bicgstab_xr", dtype, True, seed=11)
    for name in ("rho_new", "denom", "tt"):
        args[_at("bicgstab_xr", name)] = torch.tensor(0.0, dtype=dtype)
    want = _inline("bicgstab_xr", [t.clone() for t in args])
    KU.update("bicgstab_xr", *args)
    assert all(torch.equal(a, b) for a, b in zip(args, want))
    assert bool(args[_at("bicgstab_xr", "stag")])
    args = _inputs("cg_p", dtype, True, seed=12)
    args[_at("cg_p", "rz")] = torch.tensor(0.0, dtype=dtype)
    want = _inline("cg_p", [t.clone() for t in args])
    KU.update("cg_p", *args)
    assert all(torch.equal(a, b) for a, b in zip(args, want))


def _system(dtype, spd, seed=3, n=48):
    """A seeded (matrix, rhs, x0, Jacobi preconditioner diagonal): SPD
    with eigenvalues in [0.5, 20], or a nonsymmetric one whose
    eigenvalues lie within about 1 of its diagonal in [1.5, 6]."""
    rng = np.random.default_rng(seed)
    if spd:
        q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        a = (q * rng.uniform(0.5, 20.0, n)) @ q.T
    else:
        a = (rng.standard_normal((n, n)) / np.sqrt(n)
             + np.diag(rng.uniform(1.5, 6.0, n)))
    return (a, rng.standard_normal(n), 0.01 * rng.standard_normal(n),
            1.0 / np.diag(a))


class _InlineBicgstab(TK.BicgstabLoop):
    """The iteration as the port wrote it before the fused stages."""

    def _iteration(self):
        eps, r0, r = self.eps, self.r0, self.r
        safe = lambda a: torch.where(a.abs() > eps, a, eps)
        rho_new = r0 @ r
        beta = (rho_new / safe(self.rho)) * (self.alpha / safe(self.omega))
        p = r + beta * (self.p - self.omega * self.v)
        phat = self.pc(p)
        v = self.mv(phat)
        denom = r0 @ v
        alpha = rho_new / safe(denom)
        s = r - alpha * v
        shat = self.pc(s)
        t = self.mv(shat)
        tt = t @ t
        omega = (t @ s) / torch.where(tt > eps, tt, eps)
        x = self.x + alpha * phat + omega * shat
        r_new = s - omega * t
        stag = (rho_new.abs() <= eps) | (denom.abs() <= eps)
        a = self.active
        KU.commit(a, ((self.x, x), (self.r, r_new), (self.rho, rho_new),
                      (self.alpha, alpha), (self.omega, omega),
                      (self.v, v), (self.p, p), (self.stag, stag)))
        self.k.add_(a)


class _InlineCg(TK.CgLoop):
    """JAX's CG body inline, its dots and norm as float64 sums rounded
    once (the function the fused stages compute)."""

    def _iteration(self):
        p, rz = self.p, self.rz
        Ap = self.mv(p)
        pap = _dot64(p, Ap)
        alpha = rz / torch.clamp(pap, min=1e-30)
        x = self.x + alpha * p
        r = self.r - alpha * Ap
        rnorm = _norm64(r)
        z = self.pc(r)
        rz_new = _dot64(r, z)
        beta = rz_new / torch.clamp(rz, min=1e-30)
        p_new = z + beta * p
        a = self.active
        KU.commit(a, ((self.x, x), (self.r, r), (self.p, p_new),
                      (self.rz, rz_new), (self.pap, pap),
                      (self.rnorm, rnorm)))
        self.k.add_(a)


@pytest.mark.parametrize("check_every", [1, 3])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("solver", ["bicgstab", "cg"])
def test_loops_equal_the_inline_body(solver, dtype, check_every,
                                     monkeypatch):
    """Whole solves, masked blocks of 1 and 3 (iterations run after the
    stop included): x, r, the count and every state buffer bit for bit
    with the inline body's."""
    a, b, x0, dinv = _system(np.float64, solver == "cg")
    t = lambda v: torch.as_tensor(v, dtype=dtype)
    A, D = t(a), t(dinv)
    kw = dict(tol=1e-6 if dtype == torch.float32 else 1e-11, maxiter=80,
              precond=lambda v: v * D)
    new_cls, old_cls = ((TK.BicgstabLoop, _InlineBicgstab)
                        if solver == "bicgstab" else (TK.CgLoop, _InlineCg))
    monkeypatch.setattr(new_cls, "check_every", check_every)
    new = new_cls(lambda v: A @ v, t(b), t(x0), **kw).run()
    old = old_cls(lambda v: A @ v, t(b), t(x0), **kw).run()
    assert int(new.k) == int(old.k) > 3
    state = ("x", "r", "p", "k", "active") + (
        ("v", "rho", "alpha", "omega", "stag") if solver == "bicgstab"
        else ("rz", "pap", "rnorm"))
    for name in state:
        assert torch.equal(getattr(new, name), getattr(old, name)), name


@pytest.mark.parametrize("precond", [True, False])
@pytest.mark.parametrize("solver", ["bicgstab", "cg"])
def test_loops_equal_jax(solver, precond):
    """The port's solvers through the fused stages against the JAX
    package's, float64: the same iteration count, x within 1e-12 of
    max|x| (the dots sum in another order)."""
    a, b, x0, dinv = _system(np.float64, solver == "cg")
    A, D = torch.as_tensor(a), torch.as_tensor(dinv)
    kw = dict(tol=1e-10, maxiter=200)
    got = getattr(TK, solver)(
        lambda v: A @ v, torch.as_tensor(b), torch.as_tensor(x0),
        precond=(lambda v: v * D) if precond else None, **kw)
    ja, jd = jnp.asarray(a), jnp.asarray(dinv)
    ref = getattr(JK, solver)(
        lambda v: ja @ v, jnp.asarray(b), jnp.asarray(x0),
        precond=(lambda v: v * jd) if precond else None, **kw)
    assert got.converged and bool(ref.converged)
    assert got.iterations == int(ref.iterations)
    x, xr = got.x.numpy(), np.asarray(ref.x)
    assert np.abs(x - xr).max() <= 1e-12 * np.abs(xr).max()


@pytest.mark.parametrize("n", [37, 5_001])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("stage", ["cg_xr", "cg_p"])
def test_cg_dots_and_norm_equal_numpy_float64_sums(stage, dtype, n):
    """The plain CG stages' dot (cg_xr's committed pap, cg_p's rz) and
    norm (cg_xr's rnorm of the new r) against numpy's float64 sums of
    float64 products: float32 within one ulp of the sum rounded once,
    float64 within ``KU.DOT_GATE`` of the sum of |a_i b_i|."""
    args = KU.example(stage, n, dtype, "cpu", np.random.default_rng(n),
                      active=True)
    before = {name: t.clone().numpy().astype(np.float64)
              for name, t in zip(KU.ARGS[stage], args)}
    KU.update(stage, *args)
    got = dict(zip(KU.ARGS[stage], args))
    pairs = ([("pap", before["p"], before["ap"]),
              ("rnorm", got["r"].numpy().astype(np.float64), None)]
             if stage == "cg_xr" else [("rz", before["r"], before["z"])])
    for name, a, b in pairs:
        if b is None:
            want, scale = np.sqrt(np.sum(a * a)), np.sqrt(np.sum(a * a))
        else:
            want, scale = np.sum(a * b), np.sum(np.abs(a * b))
        if dtype == torch.float32:
            want = torch.tensor(want, dtype=dtype)
            assert (got[name] - want).abs() <= KU.ulp(want), name
        else:
            assert abs(float(got[name]) - want) <= KU.DOT_GATE * scale, name


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("stage", ["cg_xr", "cg_p"])
def test_masked_cg_stages_leave_every_buffer(stage, dtype):
    """A CG stage run with the flag down, twice, leaves rnorm, pap, rz, k
    and every vector bit-identical (no scratch is left to differ)."""
    args = _inputs(stage, dtype, False, seed=21)
    before = [t.clone() for t in args]
    assert KU.SCRATCH.get(stage) is None
    for _ in range(2):
        KU.update(stage, *args)
    for name, got, old in zip(KU.ARGS[stage], args, before):
        assert torch.equal(got, old), name


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("stage", ["cg_xr", "cg_p"])
def test_cg_gate_takes_a_dot_one_ulp_off_and_no_more(stage, dtype, signed,
                                                    monkeypatch):
    """``KU.cg_gate``, which holds the card's CG stages to the plain ones,
    on the CPU: the plain stage against itself passes with the dots
    equal; a stage whose dot is planted one ulp above the plain one (so
    alpha or beta, and with them x, r, p and rnorm, move) passes with the
    dots unequal; one element of a vector moved 16 ulps past that, the
    dot or rnorm moved far past one ulp (float32) or ``DOT_GATE``
    (float64), or with equal dots one element one ulp off, fails.  The
    ``signed`` draws put products of both signs into the dot and keep it
    positive."""
    names = KU.ARGS[stage]
    first, second, _ = KU.CG_DOTS[stage]
    before = KU.example(stage, 4_001, dtype, "cpu",
                        np.random.default_rng(3), signed=signed)
    B = dict(zip(names, before))
    prods = B[first].double() * B[second].double()
    assert float(prods.sum()) > 0
    assert bool((prods < 0).any()) == signed
    run = lambda: [t.clone() for t in before]
    plain = run()
    KU.update(stage, *plain)
    same = [t.clone() for t in plain]
    assert KU.cg_gate(stage, same, plain, before)[:2] == (True, True)
    exact = KU.dot
    monkeypatch.setattr(KU, "dot", lambda a, b: KU.ulp(exact(a, b))
                        + exact(a, b))
    planted = run()
    KU.update(stage, *planted)
    monkeypatch.undo()
    d = "pap" if stage == "cg_xr" else "rz"
    P, K = dict(zip(names, plain)), dict(zip(names, planted))
    assert not torch.equal(K[d], P[d])
    ok, equal, err = KU.cg_gate(stage, planted, plain, before)
    assert ok and not equal and err > 0
    rel = 1e-6 if dtype == torch.float32 else 1e-12
    mutants = [(d, None, rel)] + ([("rnorm", None, rel)]
                                  if stage == "cg_xr" else [])
    w = B["p"]
    j = int(w.abs().argmax())
    mutants.append(("x" if stage == "cg_xr" else "p", j, None))
    for name, at, move in mutants:
        bad = [t.clone() for t in planted]
        t = bad[names.index(name)]
        if at is None:
            t.mul_(1 + move)
        else:
            t[at] += 16 * KU.ulp(t[at].abs() + w[at].abs())
        assert not KU.cg_gate(stage, bad, plain, before)[0], name
    v = "x" if stage == "cg_xr" else "p"
    off = [t.clone() for t in plain]
    t = off[names.index(v)]
    t[j] = torch.nextafter(t[j], torch.tensor(math.inf, dtype=dtype))
    assert not KU.cg_gate(stage, off, plain, before)[0]


@pytest.mark.parametrize("precond", [True, False])
def test_cg_loop_equals_jax_cg(precond):
    """``CgLoop`` against the JAX package's ``cg`` in float64, with the
    Jacobi preconditioner and without, on a seeded SPD system of 48
    unknowns (eigenvalues in [0.5, 20]) at tol 1e-10: the same iteration
    count (at least 10), x within 1e-12 of max|x| and the final residual
    norm within 1e-9 of JAX's relative (both sum in float64, in other
    orders; the residual is about 1e-10 of ||b||)."""
    a, b, x0, dinv = _system(np.float64, True, seed=7)
    A, D = torch.as_tensor(a), torch.as_tensor(dinv)
    loop = TK.CgLoop(lambda v: A @ v, torch.as_tensor(b),
                     torch.as_tensor(x0), tol=1e-10, maxiter=200,
                     precond=(lambda v: v * D) if precond else None).run()
    got = loop.result()
    ja, jd = jnp.asarray(a), jnp.asarray(dinv)
    ref = JK.cg(lambda v: ja @ v, jnp.asarray(b), jnp.asarray(x0),
                tol=1e-10, maxiter=200,
                precond=(lambda v: v * jd) if precond else None)
    assert got.converged and bool(ref.converged)
    assert got.iterations == int(ref.iterations) >= 10
    x, xr = got.x.numpy(), np.asarray(ref.x)
    assert np.abs(x - xr).max() <= 1e-12 * np.abs(xr).max()
    res, rres = float(got.residual), float(ref.residual)
    assert abs(res - rres) <= 1e-9 * rres
    # the loop's norm is the norm of its committed r
    assert torch.equal(loop.rnorm, KU.norm(loop.r))


@pytest.mark.parametrize("tol,maxiter", [(1e-10, 200), (1e-10, 7),
                                         (1e-3, 200), (10.0, 200)])
def test_cg_predicate_stops_at_the_jax_k(tol, maxiter):
    """The predicate on the stages' norm stops ``CgLoop`` where JAX's
    ``cond`` stops ``cg`` (float64, Jacobi): at the tolerance, at the
    budget (7), early (1e-3) and before the first iteration (a target
    above ||r0||), with the same convergence flag, in masked blocks of
    ``CG_CHECK_EVERY`` and of 1."""
    a, b, x0, dinv = _system(np.float64, True, seed=9)
    A, D = torch.as_tensor(a), torch.as_tensor(dinv)
    ja, jd = jnp.asarray(a), jnp.asarray(dinv)
    ref = JK.cg(lambda v: ja @ v, jnp.asarray(b), jnp.asarray(x0), tol=tol,
                maxiter=maxiter, precond=lambda v: v * jd)
    for every in (TK.CG_CHECK_EVERY, 1):
        loop = TK.CgLoop(lambda v: A @ v, torch.as_tensor(b),
                         torch.as_tensor(x0), tol=tol, maxiter=maxiter,
                         precond=lambda v: v * D)
        loop.check_every = every
        got = loop.run().result()
        assert got.iterations == int(ref.iterations), every
        assert got.converged == bool(ref.converged), every


def test_cpu_calls_launch_nothing(monkeypatch):
    """CPU tensors take the plain version and count no launch."""
    KU.COUNTS.reset()
    seen = []
    for stage in KU.STAGES:
        monkeypatch.setitem(KU.PLAIN, stage,
                            lambda *a, _s=stage: seen.append(_s))
        KU.update(stage, *_inputs(stage, torch.float64, True, 0))
    assert seen == list(KU.STAGES)
    assert KU.COUNTS == KU.Counts()


@pytest.mark.parametrize("stage", KU.STAGES)
def test_other_devices_raise_and_never_take_the_plain_version(
        stage, monkeypatch):
    """A tensor that is not on the CPU never takes the plain version: a
    device other than CUDA raises, and a CUDA launch (or the cluster
    size, which the library reports) without the kernel library raises
    (no fallback)."""
    monkeypatch.setitem(KU.PLAIN, stage, lambda *a: pytest.fail("plain"))
    args = [t.to("meta") for t in _inputs(stage, torch.float32, True, 1)]
    with pytest.raises(ValueError, match="unsupported device"):
        KU.update(stage, *args)

    def absent():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(build, "library", absent)
    for dt in DTYPES:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            KU._entry(dt, torch.device("cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        KU.cluster()
    with pytest.raises(TypeError, match="float32 or float64"):
        KU._entry(torch.bfloat16, torch.device("cuda"))


def test_the_kernels_take_each_stage_in_its_order():
    """csrc/krylov_update.cu agrees with ``ARGS``: each stage's kernel
    takes n and then the stage's tensors by the same names, its launch
    passes pointers 0, 1, ... cast by kind (flags bool, k int64, the rest
    the dtype), and the enum numbers the stages in ``STAGES``'s order."""
    src = (pathlib.Path(KU.__file__).parents[1] / "csrc"
           / "krylov_update.cu").read_text()
    enum = re.search(r"enum Stage \{(.*?)\}", src).group(1)
    camel = ["k" + "".join(w.capitalize() for w in st.split("_"))
             for st in KU.STAGES]
    assert [e.split("=")[0].strip() for e in enum.split(",")] == camel
    for stage, case in zip(KU.STAGES, camel):
        sig = re.search(rf"\n{stage}\((.*?)\)\s*\{{", src, re.S).group(1)
        assert [p.split()[-1] for p in sig.split(",")] == ["n",
                                                           *KU.ARGS[stage]]
        call = re.search(rf"case {case}:(.*?)break;", src, re.S).group(1)
        args = re.findall(r"(V|B|long long\*>)\(?\(?a?\[?(\d+)", call)
        want = [("B" if name in KU.FLAGS else "long long*>" if name == "k"
                 else "V", str(i)) for i, name in enumerate(KU.ARGS[stage])]
        assert args == want, stage


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("base", [0, 16 * 3, 16 * 1024 + 512])
def test_the_path_is_a_function_of_the_alignment_alone(base, itemsize):
    """``KU.path``: vector when every address is on a 16-byte boundary,
    peeled when all sit the same bytes off one, scalar when they differ;
    the same for any shift of every address by a multiple of 16 and in
    any order."""
    for offs in ([0, 0, 0], [0], [itemsize] * 3, [16 - itemsize] * 2,
                 [0, itemsize, 0], [itemsize, 0], [itemsize, 2 * itemsize]):
        addresses = [base + 16 * i + o for i, o in enumerate(offs)]
        got = KU.path(addresses)
        assert got == KU.path(addresses[::-1])
        assert got == KU.path([a + 16 * 7 for a in addresses])
        if set(offs) == {0}:
            assert got == "vector"
        elif len(set(offs)) == 1:
            assert got == "peeled"
        else:
            assert got == "scalar"


def test_the_paths_of_views_into_one_flat_vector():
    """The views the loops hand the stages: the velocity part of a flat
    (u, p) vector and fresh vectors take the vector path; a part that
    starts 1 (fp32: up to 3) elements in shares its offset with the views
    beside it (peeled), mixed with a fresh vector it takes the scalar
    path."""
    for dt in (torch.float32, torch.float64):
        flat = torch.zeros(1001, dtype=dt)
        fresh = torch.zeros(1000, dtype=dt)
        assert KU.path([flat[:1000].data_ptr(), fresh.data_ptr()]) == \
            "vector"
        tail = [flat[1:].data_ptr(), torch.zeros(1001, dtype=dt)[1:]
                .data_ptr()]
        assert KU.path(tail) == "peeled"
        assert KU.path(tail + [fresh.data_ptr()]) == "scalar"


def test_the_counts_by_path_clear_with_the_stage_counts():
    """``PATHS`` counts launches by (stage, path) and ``COUNTS.reset()``
    clears it with the stage counts; CPU calls count nothing."""
    KU.PATHS[("bicgstab_p", "vector")] = 3
    KU.COUNTS.bicgstab_p = 3
    KU.COUNTS.reset()
    assert KU.PATHS == {} and KU.COUNTS.bicgstab_p == 0
    KU.update("bicgstab_p", *_inputs("bicgstab_p", torch.float32, True, 1))
    assert KU.PATHS == {} and KU.COUNTS.bicgstab_p == 0
    KU._count("bicgstab_s", "peeled")
    assert KU.PATHS == {("bicgstab_s", "peeled"): 1}
    assert KU.COUNTS.bicgstab_s == 1
    KU.COUNTS.reset()
