"""Blocked-ELL SpMV: the Hopper kernel and its plain PyTorch version.

One product serves every blocked-ELL operator of the step
(``navierstokes_tpu_torch/ops``):

    y[p, i, d] = sum over v in {p} + spill[p, :] of
                 sum_c vals[v, i, c] * x[cols[v, c // cb] * cb + c % cb, d]

``vals`` is the flat row-major value layout (n_ext, R, K*cb) of the JAX
package's BSR/ELL tables; ``x`` is (n_x, D) with n_x a multiple of ``cb``;
``spill`` (n_phys, S) names the virtual overflow rows folded into each
physical row (entries >= n_ext are dead).  The result is (n_phys, R, D).

Uses: F and the mass (cb=bu, D=2), the P1 Laplacian and Ap (cb=b, D=1),
G^T p (R=dim*bu, cb=bp, D=1), B u (cb=bu*dim, D=1), the Schur diagonal
and the PCD pressure convection (cb=bp, D=1).

Three variants of one CUDA kernel (csrc/bsr_spmv.cu), chosen by the dtype
of ``vals``:

* fp32 values, fp32 x and y — replaces the fp32 branch of the Pallas TPU
  kernel ``navierstokes_tpu/ops/pallas_matvec.py`` ``fused_reduce``;
* bf16 values, fp32 x and y — its bf16 branch (the ``inner_bf16`` F):
  x rounded to bf16, each product rounded to bf16, fp32 sums;
* fp64 values, fp64 x and y — float64 runs on the card and the
  refinement residual (no Pallas counterpart).

Each is bound by device-memory traffic (402 MB of fp32 F values per
product at the 1,014,414-DoF bench point, 201 MB in bf16) and reads each
value once for all D components, with the column gather and the overflow
fold inside the kernel and no atomics.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises.  ``COUNTS`` records the launches of each variant and
any plain call made on CUDA tensors (which the main path must never make).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Counts:
    launches: int = 0            # fp32 kernel launches by bsr_spmv
    launches_bf16: int = 0       # bf16-values kernel launches
    launches_f64: int = 0        # fp64 kernel launches
    plain_cuda_calls: int = 0    # bsr_spmv_plain calls on CUDA tensors

    def reset(self):
        self.launches = self.launches_bf16 = self.launches_f64 = 0
        self.plain_cuda_calls = 0


COUNTS = Counts()

# vals dtype -> (C entry point, dtype of x and y, COUNTS field)
_VARIANTS = {
    torch.float32: ("nst_bsr_spmv_f32", torch.float32, "launches"),
    torch.bfloat16: ("nst_bsr_spmv_bf16", torch.float32, "launches_bf16"),
    torch.float64: ("nst_bsr_spmv_f64", torch.float64, "launches_f64"),
}


def bsr_spmv_plain(vals, cols, x, cb: int, spill=None, n_phys=None):
    """The same product as plain tensor ops (the JAX apply's formula:
    per-component gather, broadcast multiply, minor-axis sum, then the
    spill gather-sum with an appended zero row for the dead index).  bf16
    values meet x rounded to bf16, the product is rounded to bf16 and the
    sum is fp32, as in ``navierstokes_tpu/ops/bsr.py`` ``apply_f``."""
    if vals.is_cuda:
        COUNTS.plain_cuda_calls += 1
    n_ext, _, C = vals.shape
    D = x.shape[1]
    xb = x.reshape(-1, cb, D)
    bf16 = vals.dtype == torch.bfloat16
    ys = []
    for d in range(D):
        xg = xb[:, :, d][cols].reshape(n_ext, C)
        if bf16:
            prod = vals * xg.to(torch.bfloat16)[:, None, :]
            ys.append(prod.float().sum(-1))
        else:
            ys.append((vals * xg[:, None, :]).sum(-1))
    y = torch.stack(ys, dim=-1)                         # (n_ext, R, D)
    if spill is None:
        return y if n_phys is None else y[:n_phys]
    yz = torch.cat([y, torch.zeros_like(y[:1])], dim=0)
    return y[:n_phys] + yz[spill].sum(dim=1)


def bsr_spmv(vals, cols, x, cb: int, spill=None, n_phys=None):
    """Blocked-ELL SpMV (see the module docstring).  CPU tensors take
    ``bsr_spmv_plain``; CUDA tensors launch the kernel variant of
    ``vals.dtype``."""
    if vals.device.type == "cpu":
        return bsr_spmv_plain(vals, cols, x, cb, spill, n_phys)
    if vals.device.type != "cuda":
        raise ValueError(f"bsr_spmv: unsupported device {vals.device}")
    if vals.dtype not in _VARIANTS:
        raise TypeError(f"bsr_spmv: vals must be float32, bfloat16 or "
                        f"float64 on CUDA (got {vals.dtype}); the kernel has "
                        "no other variant")
    entry, xdt, counter = _VARIANTS[vals.dtype]
    n_ext, R, C = vals.shape
    K = cols.shape[1] if cols.dim() == 2 else -1
    D = x.shape[1] if x.dim() == 2 else -1
    n_phys = n_ext if n_phys is None else n_phys
    S = 0 if spill is None else spill.shape[1]
    dev = vals.device
    for name, t, dtype in (("vals", vals, vals.dtype),
                           ("cols", cols, torch.int32),
                           ("x", x, xdt),
                           ("spill", spill, torch.int32)):
        if t is None:
            continue
        if t.dtype != dtype:
            raise TypeError(f"bsr_spmv: {name} must be {dtype} on CUDA "
                            f"with {vals.dtype} values (got {t.dtype})")
        if t.device != dev:
            raise ValueError(f"bsr_spmv: {name} on {t.device}, vals on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"bsr_spmv: {name} must be contiguous")
    if (cols.dim() != 2 or cols.shape[0] != n_ext or K * cb != C
            or D < 1 or x.shape[0] % cb != 0):
        raise ValueError(
            f"bsr_spmv: inconsistent shapes vals {tuple(vals.shape)}, cols "
            f"{tuple(cols.shape)}, x {tuple(x.shape)}, cb={cb}")
    if not 0 < n_phys <= n_ext or (spill is not None and (
            spill.dim() != 2 or spill.shape[0] != n_phys)):
        shape = None if spill is None else tuple(spill.shape)
        raise ValueError(f"bsr_spmv: spill {shape} does not match "
                         f"n_phys={n_phys}, n_ext={n_ext}")
    from navierstokes_tpu_torch.kernels.build import library
    lib = library()
    y = torch.empty((n_phys, R, D), dtype=xdt, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = getattr(lib, entry)(
        vals.data_ptr(), cols.data_ptr(), x.data_ptr(),
        spill.data_ptr() if spill is not None else None, y.data_ptr(),
        n_phys, n_ext, R, K, cb, D, S, stream)
    if rc != 0:
        msg = (lib.nst_cuda_error_string(rc).decode() if rc > 0 else
               f"no instantiation for R={R}, D={D} in csrc/bsr_spmv.cu")
        raise RuntimeError(f"bsr_spmv ({entry}) launch failed ({rc}): {msg}")
    setattr(COUNTS, counter, getattr(COUNTS, counter) + 1)
    return y
