"""FGMRES's Givens update on the device: the hand-written CUDA kernel
(csrc/arnoldi_lsq.cu) and its plain PyTorch version.

``lsq_update`` is one Arnoldi iteration's step of the small Hessenberg
least-squares problem of ``solvers/krylov.gmres`` (m the restart length,
T float32 or float64), in place and only while ``active``: the new column
h = h1 + h2 (m+1,), the sum of the two Gram-Schmidt passes'
coefficients, with h[j+1] = wnorm, the j stored Givens rotations cs, sn
(m,) applied to it, the rotation annihilating h[j+1] formed, the rotated
right-hand side g (m+1,) updated, the column written to H[:, j] of
H (m+1, m), res = |g[j+1]|, j += 1 and active = (j < j_max) and
(res > target); j and j_max (int32), res (T), active (bool) and target
(T) are 0-d tensors.  Nothing that varies from cycle to cycle or from
solve to solve is a launch argument, so one captured while node of an
FGMRES cycle serves every cycle (models/step_graphs.py).  As the last
launch of FGMRES's body under a while node (``cond``, a
kernels/conditional.Condition), it also sets the node's condition from
the flag it writes and counts the evaluation in the node's tally, as the
predicate kernel ``set_condition`` would in a launch of its own.  The arithmetic of the
JAX package's ``rot_body`` and its rotation
(navierstokes_tpu/solvers/krylov.py:108-126) and of the host code it
replaces, each product, sum, quotient and square root rounded on its own:
equal bits.

It replaces no Pallas kernel: JAX runs the rotations inside its
``lax.while_loop`` (``fori_loop(rot_body)``).  In eager PyTorch they
would cost O(j) tiny launches per iteration, or a host round trip; the
kernel makes each iteration's step one launch.  It runs as one CTA: the
algebra is serial and at most 65 values long, so the bound is the
launch, not bytes or operations; in the captured monolithic step, a
graph node's launch (PERF.md gives its in-graph time).

The cycle's triangular solve stays on the host at the cycle's end
(solvers/krylov.py), by LAPACK's trsv as before: OpenBLAS sums in its
own order, with its own kernels, so no order on the card gives its bits,
and one cycle-end solve in another rounding moves the fp32 ``inner_bf16``
3D fixture by 1.7e-4 of |u| (``chip_smoke.py`` phase 9's gate is 1e-4).

Dispatch: CPU tensors take the plain version; CUDA tensors launch the
kernel or raise.  ``COUNTS`` records the launches (under capture through
the graph's record, ``kernels/launches.py``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from navierstokes_tpu_torch.kernels.launches import count


@dataclasses.dataclass
class Counts:
    update: int = 0      # lsq_update kernel launches

    def reset(self):
        self.update = 0


COUNTS = Counts()


def _count():
    COUNTS.update += 1


_TINY = 1e-30


def _sqrt_rn(x):
    """The square root rounded once, as the kernel's ``__fsqrt_rn`` /
    ``__dsqrt_rn``: C's ``sqrt`` of the value.  torch's CPU ``sqrt`` is
    not correctly rounded (about 0.6% of fp32 and fp64 arguments land one
    ulp off); a float32 argument's double root rounds to the float root
    (53 >= 2 * 24 + 2 bits)."""
    return torch.tensor(math.sqrt(float(x)), dtype=x.dtype, device=x.device)


def lsq_update_plain(H, cs, sn, g, h1, h2, wnorm, j, res, active, target,
                     j_max):
    """The plain version of ``lsq_update`` (see the module docstring), on
    0-d tensor arithmetic in the state's dtype."""
    if not bool(active):
        return
    J = int(j)
    h = h1 + h2
    h[J + 1] = wnorm
    for i in range(J):
        hi = cs[i] * h[i] + sn[i] * h[i + 1]
        h[i + 1] = -sn[i] * h[i] + cs[i] * h[i + 1]
        h[i] = hi
    a, b = h[J], h[J + 1]
    denom = _sqrt_rn(a * a + b * b)
    if bool(denom > 0):
        d = torch.clamp(denom, min=_TINY)
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


def _check(name, t, dtype, shape, dev):
    if t.dtype != dtype:
        raise TypeError(f"arnoldi_lsq: {name} must be {dtype} (got "
                        f"{t.dtype})")
    if tuple(t.shape) != shape:
        raise ValueError(f"arnoldi_lsq: {name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if t.device != dev:
        raise ValueError(f"arnoldi_lsq: {name} on {t.device}, H on {dev}")
    if not t.is_contiguous():
        raise ValueError(f"arnoldi_lsq: {name} must be contiguous")


def _entry(H):
    if H.device.type != "cuda":
        raise ValueError(f"arnoldi_lsq: unsupported device {H.device}")
    suffix = {torch.float32: "f32", torch.float64: "f64"}.get(H.dtype)
    if suffix is None:
        raise TypeError(f"arnoldi_lsq: H must be float32 or float64 on CUDA "
                        f"(got {H.dtype}); the kernel has no other variant")
    from navierstokes_tpu_torch.kernels.build import library
    lib = library()
    return lib, getattr(lib, f"nst_lsq_update_{suffix}")


def lsq_update(H, cs, sn, g, h1, h2, wnorm, j, res, active, target, j_max,
               cond=None) -> bool:
    """One Arnoldi iteration's Givens step, in place (see the module
    docstring).  CPU tensors take ``lsq_update_plain``.  Returns whether it
    set a while node's condition (``cond``)."""
    if H.device.type == "cpu":
        lsq_update_plain(H, cs, sn, g, h1, h2, wnorm, j, res, active, target,
                         j_max)
        return False
    lib, fn = _entry(H)
    m, dt, dev = H.shape[1], H.dtype, H.device
    for name, t, dtype, shape in (
            ("H", H, dt, (m + 1, m)), ("cs", cs, dt, (m,)),
            ("sn", sn, dt, (m,)), ("g", g, dt, (m + 1,)),
            ("h1", h1, dt, (m + 1,)), ("h2", h2, dt, (m + 1,)),
            ("wnorm", wnorm, dt, ()), ("j", j, torch.int32, ()),
            ("res", res, dt, ()), ("active", active, torch.bool, ()),
            ("target", target, dt, ()), ("j_max", j_max, torch.int32, ())):
        _check(name, t, dtype, shape, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(H.data_ptr(), cs.data_ptr(), sn.data_ptr(), g.data_ptr(),
                h1.data_ptr(), h2.data_ptr(), wnorm.data_ptr(), j.data_ptr(),
                res.data_ptr(), active.data_ptr(), target.data_ptr(),
                j_max.data_ptr(), m, stream,
                0 if cond is None else cond.handle, int(cond is not None),
                None if cond is None else cond.tally.data_ptr())
    if rc != 0:
        raise RuntimeError(f"lsq_update launch failed ({rc}): "
                           f"{lib.nst_cuda_error_string(rc).decode()}")
    count(_count)
    return cond is not None
