"""SELL-C-sigma SpMV: the Hopper kernel and its plain PyTorch version.

One product serves every sparse operator of the step
(``navierstokes_tpu_torch/ops``):

    y[rows[l], d] = sum over j < width(l) of vals[s] * x[cols[s], d]

for every lane l of a pattern (``ops/sell.SellMatrix``; s is slot j of
lane l), with x of shape (n_cols, D) or (n_cols,), D = 1, 2 or 3; y has
x's rank.  Uses: F and the mass (D = the dimension, 2 or 3), G p (rows =
velocity DoFs), B u (columns = velocity DoFs), the P1 Laplacian, Ap, the
Schur diagonal and the PCD pressure convection (D=1).

Three variants of one CUDA kernel (csrc/sell_spmv.cu), chosen by the dtype
of ``vals``:

* fp32 values, fp32 x and y — replaces the fp32 branch of the Pallas TPU
  kernel ``navierstokes_tpu/ops/pallas_matvec.py`` ``fused_reduce``;
* bf16 values, fp32 x and y — its bf16 branch (the ``inner_bf16`` F): x
  rounded to bf16, each product rounded to bf16, fp32 sums;
* fp64 values, fp64 x and y — float64 runs on the card and the
  refinement residual (no Pallas counterpart).

Each is bound by device-memory traffic: it reads each slot's value and
column once, for all D components (2 flops per 8 bytes in fp32).

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises.  ``COUNTS`` records the launches of each variant and
any plain call made on CUDA tensors (which the main path must never make).
Under CUDA graph capture (``kernels/launches.record_launches``) a call
launches nothing yet: its launch goes into the graph's ``LaunchRecord``,
which adds it to ``COUNTS`` at every replay (models/step_graphs.py).
"""

from __future__ import annotations

import dataclasses

import torch

from navierstokes_tpu_torch.kernels.launches import count
from navierstokes_tpu_torch.ops.sell import SellMatrix


@dataclasses.dataclass
class Counts:
    launches: int = 0            # fp32 kernel launches
    launches_bf16: int = 0       # bf16-values kernel launches
    launches_f64: int = 0        # fp64 kernel launches
    plain_cuda_calls: int = 0    # sell_spmv_plain calls on CUDA tensors
    # launches by (operator, value dtype): (SellMatrix.name, vals.dtype)
    by_pattern: dict = dataclasses.field(default_factory=dict)
    # launches by instantiation: (vals.dtype, D)
    by_variant: dict = dataclasses.field(default_factory=dict)

    def reset(self):
        self.launches = self.launches_bf16 = self.launches_f64 = 0
        self.plain_cuda_calls = 0
        self.by_pattern.clear()
        self.by_variant.clear()


COUNTS = Counts()


def _count(counter, pattern, variant):
    setattr(COUNTS, counter, getattr(COUNTS, counter) + 1)
    for table, key in ((COUNTS.by_pattern, pattern),
                       (COUNTS.by_variant, variant)):
        table[key] = table.get(key, 0) + 1


# vals dtype -> (C entry point, dtype of x and y, COUNTS field)
VARIANTS = {
    torch.float32: ("nst_sell_spmv_f32", torch.float32, "launches"),
    torch.bfloat16: ("nst_sell_spmv_bf16", torch.float32, "launches_bf16"),
    torch.float64: ("nst_sell_spmv_f64", torch.float64, "launches_f64"),
}


def sell_spmv_plain(mat: SellMatrix, vals, x):
    """The same product as plain tensor ops: gather x at every slot,
    multiply, sum each lane's slots in slot order from zero, place the
    lane sums at their rows.  bf16 values meet x rounded to bf16 and each
    product is rounded to bf16 before the fp32 sum, as in the JAX
    package's ``ops/bsr.py`` ``apply_f``."""
    if vals.is_cuda:
        COUNTS.plain_cuda_calls += 1
    x2 = x[:, None] if x.dim() == 1 else x
    xg = x2[mat.cols.long()]                             # (n_slots, D)
    if vals.dtype == torch.bfloat16:
        prod = (vals[:, None] * xg.to(torch.bfloat16)).float()
    else:
        prod = vals[:, None] * xg
    order, lengths = mat.plain_order()
    lane_sums = torch.segment_reduce(prod[order], "sum", lengths=lengths,
                                     axis=0)                # (n_lanes, D)
    live = mat.rows >= 0
    y = prod.new_empty((mat.n_rows, x2.shape[1]))
    y[mat.rows[live].long()] = lane_sums[live]
    return y.reshape(-1) if x.dim() == 1 else y


def sell_spmv(mat: SellMatrix, vals, x):
    """SELL-C-sigma SpMV (see the module docstring).  CPU tensors take
    ``sell_spmv_plain``; CUDA tensors launch the kernel variant of
    ``vals.dtype``."""
    if vals.device.type == "cpu":
        return sell_spmv_plain(mat, vals, x)
    if vals.device.type != "cuda":
        raise ValueError(f"sell_spmv: unsupported device {vals.device}")
    if vals.dtype not in VARIANTS:
        raise TypeError(f"sell_spmv: vals must be float32, bfloat16 or "
                        f"float64 on CUDA (got {vals.dtype}); the kernel has "
                        "no other variant")
    entry, xdt, counter = VARIANTS[vals.dtype]
    dev = vals.device
    D = 1 if x.dim() == 1 else x.shape[1]
    # the alignment of each pointer's widest load: four values (two
    # 16-byte loads in fp64), four int32 columns, one int32, and a row of
    # x (D = 1, 2: one D-wide load; D = 3: three scalar loads)
    for name, t, dtype, align in (
            ("vals", vals, vals.dtype, min(16, 4 * vals.element_size())),
            ("cols", mat.cols, torch.int32, 16),
            ("slice_ptr", mat.slice_ptr, torch.int32, 4),
            ("rows", mat.rows, torch.int32, 4),
            ("x", x, xdt, (1 if D == 3 else D) * x.element_size())):
        if t.dtype != dtype:
            raise TypeError(f"sell_spmv: {name} must be {dtype} on CUDA "
                            f"with {vals.dtype} values (got {t.dtype})")
        if t.device != dev:
            raise ValueError(f"sell_spmv: {name} on {t.device}, vals on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"sell_spmv: {name} must be contiguous")
        if t.data_ptr() % align:
            raise ValueError(f"sell_spmv: {name} must be {align}-byte "
                             "aligned (the kernel's vector loads)")
    if (vals.shape != mat.cols.shape or x.dim() > 2
            or x.shape[0] != mat.n_cols):
        raise ValueError(
            f"sell_spmv: inconsistent shapes vals {tuple(vals.shape)}, x "
            f"{tuple(x.shape)} for a {mat.n_rows}x{mat.n_cols} pattern of "
            f"{mat.n_slots} slots")
    from navierstokes_tpu_torch.kernels.build import library
    lib = library()
    y = torch.empty((mat.n_rows,) + tuple(x.shape[1:]), dtype=xdt,
                    device=dev)
    n_slices = mat.slice_ptr.shape[0] - 1
    stream = torch.cuda.current_stream(dev).cuda_stream
    # the C entry launches on the current device: make it the tensors'
    # (a row shard on another card, parallel/sharded_bsr.py)
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(
            vals.data_ptr(), mat.cols.data_ptr(), mat.slice_ptr.data_ptr(),
            mat.rows.data_ptr(), x.data_ptr(), y.data_ptr(), n_slices, D,
            stream)
    if rc != 0:
        msg = (lib.nst_cuda_error_string(rc).decode() if rc > 0 else
               f"no instantiation for D={D} in csrc/sell_spmv.cu")
        raise RuntimeError(f"sell_spmv ({entry}) launch failed ({rc}): {msg}")
    count(_count, counter, (mat.name, vals.dtype), (vals.dtype, D))
    return y
