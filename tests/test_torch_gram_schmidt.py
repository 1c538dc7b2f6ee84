"""FGMRES's Gram-Schmidt (kernels/gram_schmidt.py) on the CPU: the plain
version against the JAX package's masked whole-basis pass
(navierstokes_tpu/solvers/krylov.py:95-103) at j in {0, 1, m - 1}:
bit for bit in float64 where every sum is exact (integer data: the
structure, mask and order of the passes, free of BLAS's summation
order), within 1e-14 of max|.| in float64 on an orthonormal basis (the
two libraries' products sum in different orders; both passes'
coefficients against max|h1|), and within 1e-5 in float32, where the plain version sums in float64 (each fp32 product is
exact there) and so lands nearer the float64 pass than JAX's fp32 sums;
the flag down leaves V and Z unchanged; FGMRES's Z row; whole GMRES and
FGMRES solves against JAX's in float64 within 1e-12, and bit for bit with
the inline whole-basis body the port ran before; the dispatch, which
takes the plain version only for CPU tensors and raises without the
kernel library.  The kernels are held to the plain version on the card
(tests/test_torch_cuda.py, ``chip_smoke.py`` phase 26)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokes_tpu.solvers import krylov as JK
from navierstokes_tpu_torch.kernels import build
from navierstokes_tpu_torch.kernels import gram_schmidt as GS
from navierstokes_tpu_torch.solvers import krylov as TK

M, N = 12, 301
JS = [0, 1, M - 1]


def _jax_pass(V, w, j, m):
    """The JAX body's Gram-Schmidt, line for line."""
    mask = (jnp.arange(m + 1) <= j).astype(V.dtype)
    h1 = (V @ w) * mask
    w = w - h1 @ V
    h2 = (V @ w) * mask
    w = w - h2 @ V
    wnorm = jnp.linalg.norm(w)
    V = V.at[j + 1].set(w / jnp.maximum(wnorm, 1e-30))
    return [np.asarray(a) for a in (h1, h2, wnorm, V)]


def _state(j, dtype, integer=False, seed=None):
    """An Arnoldi state at step j: rows 0..j of V live, the rest zero,
    and a new vector w with a part in their span."""
    rng = np.random.default_rng(j if seed is None else seed)
    V = np.zeros((M + 1, N))
    if integer:
        V[:j + 1] = rng.integers(-3, 4, (j + 1, N))
        w = rng.integers(-5, 6, N).astype(np.float64)
    else:
        q, _ = np.linalg.qr(rng.standard_normal((N, j + 1)))
        V[:j + 1] = q.T
        w = rng.standard_normal(N) + 3.0 * q @ rng.standard_normal(j + 1)
    return V.astype(dtype), w.astype(dtype)


def _plain(V, w, j, active=True, z=None, Z=None):
    tV = torch.as_tensor(V.copy())
    dt = tV.dtype
    out = [torch.full((M + 1,), 7.0, dtype=dt),
           torch.full((M + 1,), 7.0, dtype=dt), torch.zeros((), dtype=dt)]
    GS.gram_schmidt(tV, torch.as_tensor(w), *out,
                    torch.tensor(j, dtype=torch.int32), torch.tensor(active),
                    None, z, Z)
    return [t.numpy() for t in out] + [tV.numpy()]


def _scaled(got, ref):
    """(name, got, ref, scale) of h1, h2, wnorm and V: h2, the second
    pass's correction, is at the round-off of the first, so both passes'
    coefficients are measured against max|h1|."""
    h1 = np.abs(ref[0]).max()
    return [(name, a, b, h1 if name in ("h1", "h2") else np.abs(b).max())
            for name, a, b in zip(("h1", "h2", "wnorm", "V"), got, ref)]


@pytest.mark.parametrize("j", JS)
def test_plain_equals_jax_bit_for_bit_where_sums_are_exact(j):
    V, w = _state(j, np.float64, integer=True)
    got = _plain(V, w, j)
    ref = _jax_pass(jnp.asarray(V), jnp.asarray(w), j, M)
    for name, a, b in zip(("h1", "h2", "wnorm", "V"), got, ref):
        assert a.dtype == b.dtype and np.array_equal(a, b), name


@pytest.mark.parametrize("j", JS)
def test_plain_equals_jax_in_float64(j):
    V, w = _state(j, np.float64)
    got = _plain(V, w, j)
    ref = _jax_pass(jnp.asarray(V), jnp.asarray(w), j, M)
    for name, a, b, scale in _scaled(got, ref):
        assert np.abs(a - b).max() <= 1e-14 * scale, name
    assert np.array_equal(got[3][j + 2:], ref[3][j + 2:])


@pytest.mark.parametrize("j", JS)
def test_plain_fp32_sums_in_float64(j):
    """float32: within 1e-5 of JAX's fp32 pass; h1 the float64 products'
    sum rounded once; the float64 pass of the same fp32 data nearer the
    plain version than JAX's fp32 sums."""
    V, w = _state(j, np.float32)
    got = _plain(V, w, j)
    ref = _jax_pass(jnp.asarray(V), jnp.asarray(w), j, M)
    for name, a, b, scale in _scaled(got, ref):
        assert a.dtype == np.float32
        assert np.abs(a - b).max() <= 1e-5 * scale, name
    mask = np.arange(M + 1) <= j
    h1 = (V.astype(np.float64) @ w.astype(np.float64)).astype(np.float32)
    assert np.array_equal(got[0], np.where(mask, h1, np.float32(0)))
    exact = _jax_pass(jnp.asarray(V, jnp.float64),
                      jnp.asarray(w, jnp.float64), j, M)
    err = lambda r: max(np.abs(a - e).max() / np.abs(e).max()
                        for a, e in zip(r, exact))
    assert err(got) <= err(ref)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_flag_down_leaves_the_basis(dtype):
    """With the flag down the coefficients and norm are still written
    (the Givens step ignores them), V and Z are not."""
    j = 4
    V, w = _state(j, dtype)
    Z = torch.as_tensor(np.random.default_rng(9).standard_normal(
        (M, N)).astype(dtype))
    z = torch.as_tensor(np.ones(N, dtype))
    Z0 = Z.clone()
    up = _plain(V, w, j)
    down = _plain(V, w, j, active=False, z=z, Z=Z)
    for a, b in zip(up[:3], down[:3]):
        assert np.array_equal(a, b)
    assert np.array_equal(down[3], V) and torch.equal(Z, Z0)
    assert not np.array_equal(up[3], V)


@pytest.mark.parametrize("j", [0, M - 1, M])
def test_flexible_writes_z_and_clamps_the_rows(j):
    """Z[min(j, m - 1)] = z and V[min(j + 1, m)] under the flag; the
    coefficients beyond j are zero."""
    V, w = _state(min(j, M - 1), np.float64)
    Z = torch.zeros((M, N), dtype=torch.float64)
    z = torch.as_tensor(np.random.default_rng(2).standard_normal(N))
    h1, h2, wn, V1 = _plain(V, w, j, z=z, Z=Z)
    assert torch.equal(Z[min(j, M - 1)], z)
    assert not Z[:min(j, M - 1)].any() and not Z[min(j, M - 1) + 1:].any()
    row = min(j + 1, M)
    assert not np.array_equal(V1[row], V[row])
    assert np.array_equal(np.delete(V1, row, 0), np.delete(V, row, 0))
    assert not h1[j + 1:].any() and not h2[j + 1:].any()


def _system(seed=4, n=90):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) / np.sqrt(n) + np.diag(
        rng.uniform(1.0, 8.0, n))
    return a, rng.standard_normal(n), 0.01 * rng.standard_normal(n)


@pytest.mark.parametrize("precond", [True, False])
@pytest.mark.parametrize("solver", ["gmres", "fgmres"])
def test_gmres_equals_jax(solver, precond):
    """Whole solves with restart cycles (m = 8) through the Gram-Schmidt
    function against the JAX package's, float64: the same iteration
    count, x within 1e-12 of max|x|."""
    a, b, x0 = _system()
    dinv = 1.0 / np.diag(a)
    kw = dict(tol=1e-10, restart=8, maxiter=200)
    A, D = torch.as_tensor(a), torch.as_tensor(dinv)
    got = getattr(TK, solver)(
        lambda v: A @ v, torch.as_tensor(b), torch.as_tensor(x0),
        precond=(lambda v: v * D) if precond else None, **kw)
    ja, jd = jnp.asarray(a), jnp.asarray(dinv)
    ref = getattr(JK, solver)(
        lambda v: ja @ v, jnp.asarray(b), jnp.asarray(x0),
        precond=(lambda v: v * jd) if precond else None, **kw)
    xr = np.asarray(ref.x)
    assert got.converged and bool(ref.converged)
    assert got.iterations == int(ref.iterations) > 8
    assert np.abs(got.x.numpy() - xr).max() <= 1e-12 * np.abs(xr).max()


class _WholeBasis(TK.GmresLoop):
    """The Arnoldi step as the port wrote it before the Gram-Schmidt
    function: the masked whole-basis products inline."""

    def iteration(self, cond=None):
        V, Z, j, m, active = self.V, self.Z, self.j, self.m, self.active
        jl = j.long().view(1)
        z = self.pc(V.index_select(0, jl)[0])
        w = self.mv(z)
        if self.flexible:
            jz = torch.clamp(jl, max=m - 1)
            Z.index_copy_(0, jz, torch.where(
                active, z, Z.index_select(0, jz)[0])[None])
        mask = (torch.arange(m + 1) <= j).to(self.dtype)
        h1 = (V @ w) * mask
        w = w - h1 @ V
        h2 = (V @ w) * mask
        w = w - h2 @ V
        wnorm = torch.linalg.norm(w)
        j1 = torch.clamp(jl + 1, max=m)
        V.index_copy_(0, j1, torch.where(
            active, w / torch.clamp(wnorm, min=1e-30),
            V.index_select(0, j1)[0])[None])
        return TK.lsq_update(self.H, self.cs, self.sn, self.g, h1, h2, wnorm,
                             j, self.res, active, self.target, self.j_max,
                             cond=cond)


@pytest.mark.parametrize("flexible", [True, False])
def test_float64_gmres_equals_the_whole_basis_body(flexible):
    """In float64 the plain version is the former inline body's
    arithmetic: the same bits, state included."""
    a, b, x0 = _system(seed=5)
    A = torch.as_tensor(a)
    dinv = torch.as_tensor(1.0 / np.diag(a))
    kw = dict(tol=1e-11, restart=8, maxiter=100, flexible=flexible,
              precond=lambda v: v * dinv)
    new = TK.GmresLoop(lambda v: A @ v, torch.as_tensor(b),
                       torch.as_tensor(x0), **kw).run()
    old = _WholeBasis(lambda v: A @ v, torch.as_tensor(b),
                      torch.as_tensor(x0), **kw).run()
    assert new.iterations == old.iterations > 8
    for name in ("x", "V", "H", "g", "cs", "sn", "res") + (
            ("Z",) if flexible else ()):
        assert torch.equal(getattr(new, name), getattr(old, name)), name


def test_cpu_calls_launch_nothing(monkeypatch):
    GS.COUNTS.reset()
    assert GS.workspace(M, N, torch.float32, "cpu") is None
    _plain(*_state(2, np.float32), 2)
    assert GS.COUNTS.calls == 0


def test_other_devices_raise_and_never_take_the_plain_version(monkeypatch):
    """A tensor that is not on the CPU never takes the plain version: a
    device other than CUDA raises, and a CUDA launch without the kernel
    library raises (no fallback)."""
    monkeypatch.setattr(GS, "gram_schmidt_plain",
                        lambda *a: pytest.fail("plain"))
    V, w = _state(1, np.float32)
    meta = lambda a: torch.as_tensor(a).to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        GS.gram_schmidt(meta(V), meta(w), meta(np.zeros(M + 1, np.float32)),
                        meta(np.zeros(M + 1, np.float32)),
                        meta(np.float32(0)), meta(np.int32(1)),
                        meta(np.bool_(True)), None)

    def absent():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(build, "library", absent)
    for dt in (torch.float32, torch.float64):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            GS._entry(dt, torch.device("cuda"))
    with pytest.raises(TypeError, match="float32 or float64"):
        GS._entry(torch.bfloat16, torch.device("cuda"))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [1, 31, 32, 301])
def test_basis_pads_each_row_to_128_bytes(n, dtype):
    """``GS.basis``: the (rows, n) view of a (rows, ld) buffer, ld the
    least multiple of 32 elements >= n, its pad zero; writes through the
    view leave the pad zero, and ``check_basis`` takes it (returns ld)."""
    B = GS.basis(5, n, dtype, "cpu")
    ld = -(-n // 32) * 32
    assert B.shape == (5, n) and B.stride() == (ld, 1)
    assert B.data_ptr() % 16 == 0
    assert not B.as_strided((5, ld), (ld, 1))[:, n:].any()
    B.fill_(3.0)
    B.index_copy_(0, torch.tensor([2]), torch.ones(1, n, dtype=dtype))
    full = B.as_strided((5, ld), (ld, 1))
    assert not full[:, n:].any() and (full[:, :n] != 0).all()
    assert GS.check_basis("V", B) == ld


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_the_wrapper_refuses_a_basis_the_kernels_cannot_take(dtype):
    """``check_basis`` raises on a basis whose rows do not all start on
    16-byte boundaries (a contiguous basis of an odd n, a padded one
    viewed from its second element), on a row stride below n and on a
    column stride other than 1; it never copies."""
    n = 301
    with pytest.raises(ValueError, match="16-byte"):
        GS.check_basis("V", torch.zeros((M + 1, n), dtype=dtype))
    with pytest.raises(ValueError, match="16-byte"):
        GS.check_basis("V", GS.basis(M + 1, n + 1, dtype, "cpu")[:, 1:])
    with pytest.raises(ValueError, match="row stride"):
        GS.check_basis("V", torch.zeros((n, M + 1), dtype=dtype).T)
    with pytest.raises(ValueError, match="row stride"):
        GS.check_basis("V", torch.zeros(64, dtype=dtype).as_strided(
            (3, 32), (16, 1)))
    assert GS.check_basis("V", torch.zeros((M + 1, 320), dtype=dtype)) == 320


@pytest.mark.parametrize("solver", ["gmres", "fgmres"])
def test_padded_basis_gmres_equals_jax(solver):
    """``GmresLoop`` keeps V and Z in padded bases (row stride 320 for
    n = 301) and its solves equal the JAX package's in float64: the same
    iterations over several restart cycles, x within 1e-12 of max|x|, the
    residual estimate within 1e-10 of |b|, both converged."""
    a, b, x0 = _system(seed=7, n=301)
    dinv = 1.0 / np.diag(a)
    kw = dict(tol=1e-10, restart=8, maxiter=300)
    A, D = torch.as_tensor(a), torch.as_tensor(dinv)
    loop = TK.GmresLoop(lambda v: A @ v, torch.as_tensor(b),
                        torch.as_tensor(x0), precond=lambda v: v * D,
                        flexible=solver == "fgmres", **kw)
    assert loop.V.stride() == (320, 1) and loop.V.shape == (9, 301)
    if solver == "fgmres":
        assert loop.Z.stride() == (320, 1) and loop.Z.shape == (8, 301)
    got = loop.run().result()
    ja, jd = jnp.asarray(a), jnp.asarray(dinv)
    ref = getattr(JK, solver)(lambda v: ja @ v, jnp.asarray(b),
                              jnp.asarray(x0), precond=lambda v: v * jd,
                              **kw)
    xr = np.asarray(ref.x)
    assert got.converged and bool(ref.converged)
    assert got.iterations == int(ref.iterations) > 8
    assert np.abs(got.x.numpy() - xr).max() <= 1e-12 * np.abs(xr).max()
    assert abs(float(got.residual) - float(ref.residual)) <= \
        1e-10 * np.linalg.norm(b)
