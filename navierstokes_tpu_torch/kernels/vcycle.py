"""The V-cycle's Chebyshev smoother and residuals on the device: the
hand-written CUDA kernels (csrc/vcycle.cu), one launch per stage, and
their plain PyTorch versions.

Each stage is one SELL D=1 product of an assembled P1 operator S
(``ops/p1ell.P1Matrix``: the outlet-pinned Laplacian of the projection
Poisson solve, Ap of ``cc``/``pcd``) carrying the update that follows it
in ``solvers/schur.chebyshev`` / ``make_vcycle_solver``:

* ``cheb_first``: r0 = r - S x; d = (sdinv * r0) / theta; zc = d.  x is the
  cycle's z, or, given the coarse correction y, z + P y (the
  prolongation, repeat_interleave(y, agg), taken inside the product's
  gather and at the row, written to ``znew``); with x None (z = 0) there
  is no product and r0 is r (r - S 0 equals r bit for bit).  With
  ``last`` (k = 1) it writes only out = x + d (0 + d with x None);
* ``cheb_step`` (iteration ``step`` of k - 1): resid = r0 - S zc;
  d = c1 d + c2 (sdinv * resid); zc' = zc + d into ``zc``; with ``last``
  only out = z + zc' (0 + zc' with z None);
* ``residual``: out = r - S x.

theta, c1 = rho_new * rho and c2 = 2 rho_new / delta of every iteration
come from ``coefficients``, computed once per operator with
``chebyshev``'s own torch expressions on the same 0-d lambda_max, so they
are the scalars the loop computes, to the bit.  The kernels round each
product, sum, difference and quotient on its own in the operand order of
the plain versions, and sum each row in the SELL kernel's order (the row
loop of csrc/sell_row.cuh), so every stage gives its plain version's bits
in fp32 and fp64.

They replace no Pallas kernel: XLA fuses the JAX package's smoother and
V-cycle (navierstokes_tpu/solvers/schur.py:153-201), which the plain
version runs as about 85 launches per V-cycle at one cycle and k = 3; the
fused V-cycle (solvers/schur.py ``FusedVcycle``) launches ``launches(1,
3)``: 7 stages, the restriction's sum and the coarse GEMV.

Dispatch: CPU tensors take the plain versions (the product through
``kernels/sell_spmv``, whose plain version runs on the CPU); CUDA tensors
launch the kernel or raise, through csrc/vcycle.cu's typed entry for the
call (``first`` or, with ``last``, ``first_last``; ``step`` or
``step_last``; ``residual``), handed exactly the arguments it takes.
``COUNTS`` records the launches per stage
(under capture through the graph's record, ``kernels/launches.py``) and
the plain versions' calls on CUDA tensors.
"""

from __future__ import annotations

import dataclasses

import torch

from navierstokes_tpu_torch.kernels.launches import count
from navierstokes_tpu_torch.kernels.sell_spmv import sell_spmv

STAGES = ("cheb_first", "cheb_step", "residual")
# kernels a V-cycle launches per cycle besides its stages: the
# restriction's sum (one reduction) and the coarse correction sc_inv @
# (one cuBLAS GEMV; measured on the H100 at the bench and 3D-1Z sizes)
STOCK_PER_CYCLE = 2


@dataclasses.dataclass
class Counts:
    cheb_first: int = 0
    cheb_step: int = 0
    residual: int = 0
    plain_cuda_calls: int = 0    # plain stages called on CUDA tensors

    def reset(self):
        for f in (*STAGES, "plain_cuda_calls"):
            setattr(self, f, 0)


COUNTS = Counts()


def _count(stage):
    setattr(COUNTS, stage, getattr(COUNTS, stage) + 1)


def launches(n_cycles: int, k: int) -> tuple[int, int]:
    """(stage launches, kernels in all) of one V-cycle solve of
    ``n_cycles`` cycles with k smoothing iterations: per cycle two
    smoothings of a ``cheb_first`` and k - 1 ``cheb_step``s, one
    ``residual``, and the coarse correction's STOCK_PER_CYCLE kernels."""
    fused = n_cycles * (2 * k + 1)
    return fused, fused + n_cycles * STOCK_PER_CYCLE


def coefficients(lam_max, k: int, ratio: float = 6.0):
    """(1 + 2 (k - 1),) tensor [theta, c1_0, c2_0, c1_1, c2_1, ...] of the
    Chebyshev smoother on [lam_max/ratio, lam_max]: theta, and for each
    iteration c1 = rho_new * rho and c2 = 2 rho_new / delta, computed with
    ``solvers/schur.chebyshev``'s expressions on the 0-d ``lam_max`` (on
    the vectors' device, in their dtype), so each entry has the bits the
    loop computes."""
    if not (torch.is_tensor(lam_max) and lam_max.dim() == 0):
        raise TypeError("coefficients: lam_max must be a 0-d tensor on the "
                        "vectors' device (a Python float divides another "
                        "way on the card)")
    lmin = lam_max / ratio
    theta = 0.5 * (lam_max + lmin)
    delta = 0.5 * (lam_max - lmin)
    sigma = theta / delta
    rho = 1.0 / sigma
    out = [theta]
    for _ in range(k - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        out += [rho_new * rho, 2.0 * rho_new / delta]
        rho = rho_new
    return torch.stack(out)


def _product(op, x):
    return sell_spmv(op.mat, op.vals, x)


def _plain_call(t):
    if t.is_cuda:
        COUNTS.plain_cuda_calls += 1


def cheb_first_plain(op, coef, sdinv, r, x, *, d=None, zc=None, r0=None,
                     y=None, agg=0, znew=None, out=None, last=False):
    _plain_call(r)
    if y is not None:
        x = x + torch.repeat_interleave(y, agg)[:r.shape[0]]
    res = r if x is None else r - _product(op, x)
    dv = (sdinv * res) / coef[0]
    if last:
        out.copy_((torch.zeros_like(r) if x is None else x) + dv)
        return
    if x is not None:
        r0.copy_(res)
    d.copy_(dv)
    zc.copy_(dv)
    if y is not None:
        znew.copy_(x)


def cheb_step_plain(op, coef, step, sdinv, r0, d, x, *, zc=None, z=None,
                    out=None, last=False):
    _plain_call(r0)
    resid = r0 - _product(op, x)
    dv = coef[1 + 2 * step] * d + coef[2 + 2 * step] * (sdinv * resid)
    zcv = x + dv
    if last:
        out.copy_((torch.zeros_like(zcv) if z is None else z) + zcv)
        return
    d.copy_(dv)
    zc.copy_(zcv)


def residual_plain(op, r, x, out):
    _plain_call(r)
    out.copy_(r - _product(op, x))


PLAIN = {"cheb_first": cheb_first_plain, "cheb_step": cheb_step_plain,
         "residual": residual_plain}


def _check(stage, op, vectors, optional=()):
    """Refuses, before any launch, what the kernel cannot take: an operator
    not float32 or float64 or not square, a vector of ``vectors`` (name ->
    tensor; None only for a name in ``optional``, which the kernel reads
    as absent) of another dtype or device than the operator's values, not
    contiguous, or (but ``coef`` and ``y``) not of the operator's rows."""
    vals, mat = op.vals, op.mat
    if vals.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"vcycle: the operator must be float32 or float64 "
                        f"on CUDA (got {vals.dtype}); the kernel has no other "
                        "variant")
    n = mat.n_rows
    if mat.n_cols != n:
        raise ValueError(f"vcycle: S must be square (got {n}x{mat.n_cols})")
    for name, v in vectors.items():
        if v is None:
            if name in optional:
                continue
            raise ValueError(f"vcycle: {stage} needs {name}")
        if v.dtype != vals.dtype:
            raise TypeError(f"vcycle: {stage}'s {name} must be {vals.dtype} "
                            f"(got {v.dtype})")
        if v.device != vals.device:
            raise ValueError(f"vcycle: {stage}'s {name} on {v.device}, the "
                             f"operator on {vals.device}")
        if not v.is_contiguous():
            raise ValueError(f"vcycle: {stage}'s {name} must be contiguous")
        if name not in ("coef", "y") and tuple(v.shape) != (n,):
            raise ValueError(f"vcycle: {stage}'s {name} must be of shape "
                             f"({n},) (got {tuple(v.shape)})")


def _call_kernel(entry, op, *args):
    """The library's ``nst_vcycle_<entry>_<f32|f64>`` (csrc/vcycle.cu) on
    the operator's SELL arrays and ``args`` in the entry's order (a tensor
    by its pointer, None a null pointer, an int as it is), on the current
    stream of the operator's device; raises if the launch fails."""
    from navierstokes_tpu_torch.kernels.build import library
    vals, mat = op.vals, op.mat
    for name, v in (("vals", vals), ("cols", mat.cols)):
        if v.data_ptr() % 16:
            raise ValueError(f"vcycle: the operator's {name} must be 16-byte "
                             "aligned (the row loop's vector loads)")
    lib = library()
    suffix = "f32" if vals.dtype == torch.float32 else "f64"
    fn = getattr(lib, f"nst_vcycle_{entry}_{suffix}")
    ptr = lambda a: a.data_ptr() if torch.is_tensor(a) else a
    dev = vals.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(vals.data_ptr(), mat.cols.data_ptr(), mat.slice_ptr.data_ptr(),
                mat.rows.data_ptr(), mat.slice_ptr.shape[0] - 1,
                *map(ptr, args), stream)
    if rc != 0:
        raise RuntimeError(f"vcycle ({entry}) launch failed ({rc}): "
                           f"{lib.nst_cuda_error_string(rc).decode()}")


def _device(r):
    if r.device.type == "cpu":
        return False
    if r.device.type != "cuda":
        raise ValueError(f"vcycle: unsupported device {r.device}")
    return True


def cheb_first(op, coef, sdinv, r, x, *, d=None, zc=None, r0=None, y=None,
               agg=0, znew=None, out=None, last=False):
    """The smoother's first stage (see the module docstring), writing
    ``out`` (``last``) or ``d``, ``zc``, ``r0`` (given x) and ``znew``
    (given y).  CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise."""
    if not _device(r):
        cheb_first_plain(op, coef, sdinv, r, x, d=d, zc=zc, r0=r0, y=y,
                         agg=agg, znew=znew, out=out, last=last)
        return
    if y is not None:
        if x is None:
            raise ValueError("vcycle: cheb_first's prolongation needs z")
        if y.numel() * agg < op.n:
            raise ValueError(f"vcycle: {y.numel()} aggregates of {agg} rows "
                             f"do not cover {op.n} rows")
    ins = dict(coef=coef, sdinv=sdinv, r=r, z=x, y=y)
    if last:
        _check("cheb_first", op, dict(ins, out=out), ("z", "y"))
        _call_kernel("first_last", op, coef, sdinv, r, x, y, agg, out)
    else:
        outs = dict(r0=None if x is None else r0, d=d, zc=zc,
                    znew=None if y is None else znew)
        _check("cheb_first", op, dict(ins, **outs), ("z", "y", "r0", "znew")
               if x is None else ("y", "znew") if y is None else ())
        _call_kernel("first", op, coef, sdinv, r, x, y, agg, *outs.values())
    count(_count, "cheb_first")


def cheb_step(op, coef, step, sdinv, r0, d, x, *, zc=None, z=None, out=None,
              last=False):
    """Chebyshev iteration ``step`` on zc = ``x`` (see the module
    docstring), writing ``d`` and ``zc`` in place, or with ``last`` only
    ``out`` (which may be ``z``).  CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    if not _device(r0):
        cheb_step_plain(op, coef, step, sdinv, r0, d, x, zc=zc, z=z, out=out,
                        last=last)
        return
    if not 0 <= step < (coef.numel() - 1) // 2:
        raise ValueError(f"vcycle: no coefficients for iteration {step}")
    ins = dict(coef=coef, sdinv=sdinv, r0=r0, d=d, zc=x)
    if last:
        _check("cheb_step", op, dict(ins, z=z, out=out), ("z",))
        _call_kernel("step_last", op, coef, step, sdinv, r0, d, x, z, out)
    else:
        _check("cheb_step", op, dict(ins, zc_out=zc))
        _call_kernel("step", op, coef, step, sdinv, r0, d, x, zc)
    count(_count, "cheb_step")


def residual(op, r, x, out):
    """out = r - S x.  CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    if not _device(r):
        residual_plain(op, r, x, out)
        return
    _check("residual", op, dict(r=r, x=x, out=out))
    _call_kernel("residual", op, r, x, out)
    count(_count, "residual")


# the stage calls a V-cycle makes, for the checks against the plain
# versions: (label, stage, options); ``x``/``z`` False: None (z = 0), ``y``:
# the prolongation, ``step``: the iteration, ``last``: the smoothing's last
CASES = (("first, z = 0", "cheb_first", dict(x=False)),
         ("first", "cheb_first", {}),
         ("first, prolonged", "cheb_first", dict(y=True)),
         ("first, z = 0, last", "cheb_first", dict(x=False, last=True)),
         ("first, last", "cheb_first", dict(last=True)),
         ("first, prolonged, last", "cheb_first", dict(y=True, last=True)),
         ("step", "cheb_step", dict(step=0)),
         ("step, last", "cheb_step", dict(step=1, last=True)),
         ("step, last, z = 0", "cheb_step", dict(step=1, last=True,
                                                 z=False)),
         ("residual", "residual", {}))
# the buffers a stage may write
BUFFERS = ("r0", "d", "zc", "znew", "out")


def example(op, rng, k: int = 3, agg: int = 64):
    """Seeded inputs of every stage on ``op`` (its device and dtype):
    standard normal vectors of n (``x`` the gathered one, ``z``, ``r`` and
    the BUFFERS' prior contents), ``y`` of the ceil(n / agg) aggregates,
    sdinv from op.diag as the V-cycle makes it, and the coefficients of
    k iterations for a lambda_max drawn from [1.8, 2.2]; ``rng`` a numpy
    Generator."""
    n, dt, dev = op.n, op.vals.dtype, op.vals.device
    vec = lambda m: torch.as_tensor(rng.standard_normal(m), dtype=dt).to(dev)
    lam = torch.tensor(rng.uniform(1.8, 2.2), dtype=dt, device=dev)
    ex = {name: vec(n) for name in ("r", "x", "z") + BUFFERS}
    ex.update(y=vec(-(-n // agg)), agg=agg, coef=coefficients(lam, k),
              sdinv=torch.where(op.diag != 0, 1.0 / op.diag,
                                torch.ones_like(op.diag)))
    return ex


def run_case(case, op, ex, plain=False, into=None):
    """The stage call ``case`` (one of CASES) on ``ex`` (``example``),
    launched (``plain``: its plain version); returns copies of the
    BUFFERS as the call left them (``into``: writes those of ``into``
    instead, and returns it)."""
    label, stage, opt = case
    b = into if into is not None else {name: ex[name].clone()
                                       for name in BUFFERS}
    fn = PLAIN[stage] if plain else {"cheb_first": cheb_first,
                                     "cheb_step": cheb_step,
                                     "residual": residual}[stage]
    last = opt.get("last", False)
    if stage == "cheb_first":
        fn(op, ex["coef"], ex["sdinv"], ex["r"],
           ex["x"] if opt.get("x", True) else None, d=b["d"], zc=b["zc"],
           r0=b["r0"], y=ex["y"] if opt.get("y") else None, agg=ex["agg"],
           znew=b["znew"], out=b["out"], last=last)
    elif stage == "cheb_step":
        fn(op, ex["coef"], opt["step"], ex["sdinv"], ex["r0"], b["d"],
           ex["x"], zc=b["zc"], z=ex["z"] if opt.get("z", True) else None,
           out=b["out"], last=last)
    else:
        fn(op, ex["r"], ex["x"], b["out"])
    return b
