"""Block-Jacobi tile rebuild: the Hopper kernels and their plain PyTorch
versions.

Each step rebuilds the F preconditioner's tile inverses
(``ops/p1ell.block_jacobi_invert``): the tile diagonals of the BC-masked
F, the Newton-Schulz guard, and ``iters`` Newton-Schulz updates from the
static seed X0 (or, past the guard, the exact inverse of
``kernels/bj_inverse.py``).  The products A X0, X (A X) and A X are the
batched GEMM of ``kernels/bj_gemm.py`` (csrc/bj_gemm.cu), whose epilogues
carry the guard's row sums and the updates.  This module holds the rest:

* ``tiles``: t = ((f * m_i) * m_j) + (sigma (1 - m_i)) * I, in f's dtype
  (fp32, or fp64 in float64 runs), rounded to fp32; f is scattered from
  the compact F values by the plan's (pos, src) pairs, sorted by pos, int32,
  with an offset per tile row (``plan_arrays``);
* ``guard_max``: the max of the GEMM's guard partials (each CTA's max of
  its rows' sums) into the 0-d norm on the device, NaN propagated;
* ``guard_plain`` / ``update_plain``: the plain halves of the GEMM's guard
  and update epilogues: the max over every row of every tile of the row
  sum of |I - A X0| in fp32, each row summed as a pairwise tree over its
  columns in order, NaN propagated; X <- 2 X - P in fp32 in X's layout
  (PyTorch's elementwise op keeps the seed's column-major layout, so the
  products that follow see the operands they saw before), the last update
  row-major in the tiles' dtype (fp32, bf16 under ``inner_bf16`` /
  ``bj_bf16``, fp64 in float64 runs), into a given buffer where there is
  one (the captured step's tile inverses).

Each kernel rounds every operation alone in the plain version's order, so
both give the same bits.  The guard's tree is the one deliberate difference
from the JAX package (``jnp.abs(eye - ax).sum(-1).max()``, XLA's order):
the norm's last bits, which only pick the branch.  They replace no Pallas
kernel: the JAX package lays the rebuild out by hand for the TPU
(``navierstokes_tpu/ops/p1ell.py`` ``block_jacobi_tiles`` :393-456,
``block_jacobi_invert`` :470-507) and leaves the elementwise work to
XLA's fusion.

Dispatch: CPU tensors take the plain versions; CUDA tensors launch the
kernel or raise.  ``COUNTS`` records the launches by (kernel, dtype) and
any plain call made on CUDA tensors (which the main path must never make).
Under CUDA graph capture (``kernels/launches.record_launches``) a launch
goes into the graph's ``LaunchRecord``, which adds it to ``COUNTS`` at
every replay (models/step_graphs.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as Fn

from navierstokes_tpu_torch.kernels.launches import count


@dataclasses.dataclass
class Counts:
    launches: int = 0            # kernel launches, all kernels
    plain_cuda_calls: int = 0    # plain versions called on CUDA tensors
    # launches by (kernel, dtype): ("tiles", f's dtype), ("guard_max",
    # fp32)
    by_variant: dict = dataclasses.field(default_factory=dict)

    def reset(self):
        self.launches = self.plain_cuda_calls = 0
        self.by_variant.clear()


COUNTS = Counts()


def _count(variant):
    COUNTS.launches += 1
    COUNTS.by_variant[variant] = COUNTS.by_variant.get(variant, 0) + 1


# the tile sizes SB with an instantiation in csrc/bj_tiles.cu
TILE_SIZES = (64, 128, 256, 512)


def plan_arrays(pos: np.ndarray, src: np.ndarray, n_rows: int, sb: int):
    """The plan's (pos, src) pairs sorted by pos, as int32, and the offset
    of each of the ``n_rows`` tile rows' first pair (``n_rows + 1``
    values): the rows' pairs are ``pos[row_ptr[g]:row_ptr[g + 1]]``."""
    order = np.argsort(pos, kind="stable")
    pos = np.asarray(pos)[order]
    if len(pos) and (pos[-1] >= 2 ** 31
                     or int(np.max(src, initial=0)) >= 2 ** 31):
        raise ValueError("block-Jacobi plan past int32 range")
    row_ptr = np.searchsorted(pos, np.arange(n_rows + 1) * sb)
    return (pos.astype(np.int32), np.asarray(src)[order].astype(np.int32),
            row_ptr.astype(np.int32))


def layout(t) -> bool | None:
    """True where each (SB, SB) tile of ``t`` is stored column-major, False
    where row-major, None for any other stride."""
    n, sb = t.shape[0], t.shape[-1]
    if t.dim() != 3 or t.shape[1] != sb:
        return None
    st = t.stride()
    if sb == 1 or st[1:] == (sb, 1) and (n == 1 or st[0] == sb * sb):
        return False
    if st[1:] == (1, sb) and (n == 1 or st[0] == sb * sb):
        return True
    return None


def _plain_call(t):
    if t.is_cuda:
        COUNTS.plain_cuda_calls += 1


# ---- plain versions --------------------------------------------------------


def tiles_plain(plan, f_vals, mask_flat, sigma):
    """The fp32 tile diagonals of the BC-masked F, M F M + sigma (I - M),
    as PyTorch operations (``f_vals``' dtype, rounded to fp32 last)."""
    _plain_call(f_vals)
    SB = plan.S * plan.bu
    t = f_vals.new_zeros(plan.n_tiles * SB * SB)
    t[plan.pos] = f_vals[plan.src]
    t = t.view(plan.n_tiles, SB, SB)
    n = plan.n_tiles * SB
    m = Fn.pad(mask_flat, (0, n - plan.n_p2)).reshape(plan.n_tiles, SB)
    t = t * m[:, :, None] * m[:, None, :]
    eye = torch.eye(SB, dtype=t.dtype, device=t.device)
    t = t + (sigma * (1.0 - m))[:, :, None] * eye[None]
    return t.to(torch.float32)


def guard_plain(ax):
    """max over rows of sum_j |I - ax|_ij, each row summed as the kernel
    sums it: adjacent pairs, then adjacent pairs of those (zeros pad a row
    to a power of two), in fp32; NaN propagates."""
    _plain_call(ax)
    sb = ax.shape[-1]
    eye = torch.eye(sb, dtype=ax.dtype, device=ax.device)
    v = (eye[None] - ax).abs()
    width = 1 << (sb - 1).bit_length()
    if width != sb:
        v = Fn.pad(v, (0, width - sb))
    while v.shape[-1] > 1:
        v = v[..., 0::2] + v[..., 1::2]
    return v.max()


def update_plain(x, p, *, out_dtype=None, out=None):
    """2 x - p in fp32; given ``out_dtype`` or ``out`` (the last update),
    row-major in that dtype, written into ``out`` where given."""
    _plain_call(x)
    y = 2.0 * x - p
    if out is None and out_dtype is None:
        return y
    y = y.to(out.dtype if out is not None else out_dtype).contiguous()
    if out is None:
        return y
    out.copy_(y)
    return out


# ---- kernels ---------------------------------------------------------------


def _check_cuda(name, dev, tensors):
    for what, t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: {what} on {t.device}, expected {dev}")


def _sb_ok(name, sb):
    if sb not in TILE_SIZES:
        raise ValueError(f"{name}: no instantiation for tiles of {sb}x{sb} "
                         f"in csrc/bj_tiles.cu (built for SB in "
                         f"{TILE_SIZES})")


def _launch(name, entry, dev, args):
    from navierstokes_tpu_torch.kernels.build import library
    lib = library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(*args, stream)
    if rc != 0:
        msg = (lib.nst_cuda_error_string(rc).decode() if rc > 0 else
               "no instantiation in csrc/bj_tiles.cu")
        raise RuntimeError(f"{name} ({entry}) launch failed ({rc}): {msg}")


def _is_device(name, t):
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return True


def tiles(plan, f_vals, mask_flat, sigma):
    """The tile diagonals (see the module docstring): ``tiles_plain`` on
    the CPU, csrc/bj_tiles.cu's ``tiles`` kernel on CUDA tensors."""
    if not _is_device("bj_tiles", f_vals):
        return tiles_plain(plan, f_vals, mask_flat, sigma)
    dev, dt = f_vals.device, f_vals.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"bj_tiles: F values must be float32 or float64 "
                        f"on CUDA (got {dt})")
    if mask_flat.dtype != dt:
        raise TypeError(f"bj_tiles: the mask must be {dt}, as the F values "
                        f"(got {mask_flat.dtype})")
    sigma = (sigma.to(device=dev, dtype=dt) if isinstance(sigma, torch.Tensor)
             else torch.full((), sigma, dtype=dt, device=dev))
    SB = plan.S * plan.bu
    _sb_ok("bj_tiles", SB)
    _check_cuda("bj_tiles", dev, (("mask", mask_flat), ("pos", plan.pos),
                                  ("src", plan.src),
                                  ("row_ptr", plan.row_ptr)))
    if (mask_flat.dim() != 1 or mask_flat.shape[0] != plan.n_p2
            or sigma.numel() != 1):
        raise ValueError(f"bj_tiles: mask {tuple(mask_flat.shape)} and "
                         f"sigma {tuple(sigma.shape)} for {plan.n_p2} rows")
    for name, t in (("F values", f_vals), ("mask", mask_flat),
                    ("pos", plan.pos), ("src", plan.src),
                    ("row_ptr", plan.row_ptr)):
        if not t.is_contiguous():
            raise ValueError(f"bj_tiles: {name} must be contiguous")
    if any(t.dtype != torch.int32 for t in (plan.pos, plan.src,
                                             plan.row_ptr)):
        raise TypeError("bj_tiles: the plan's pos, src and row_ptr must be "
                        "int32 (ops/p1ell.build_block_jacobi_plan)")
    out = torch.empty((plan.n_tiles, SB, SB), dtype=torch.float32,
                      device=dev)
    if plan.n_tiles == 0:
        return out
    entry = "nst_bj_tiles_f32" if dt == torch.float32 else "nst_bj_tiles_f64"
    _launch("bj_tiles", entry, dev,
            [f_vals.data_ptr(), plan.pos.data_ptr(), plan.src.data_ptr(),
             plan.row_ptr.data_ptr(), mask_flat.data_ptr(),
             sigma.data_ptr(), out.data_ptr(), SB, plan.n_tiles,
             plan.n_p2])
    count(_count, ("tiles", dt))
    return out


def guard_max(partials):
    """The max of the fp32 ``partials`` (csrc/bj_gemm.cu's guard epilogue,
    one per CTA) into a 0-d fp32 tensor on their device, NaN kept:
    ``partials.max()`` on the CPU, csrc/bj_tiles.cu's ``bj_guard_max`` on
    CUDA tensors."""
    if not _is_device("bj_guard_max", partials):
        _plain_call(partials)
        return partials.max()
    if (partials.dtype != torch.float32 or partials.dim() != 1
            or partials.numel() == 0 or not partials.is_contiguous()):
        raise ValueError(f"bj_guard_max: partials must be a non-empty "
                         f"contiguous float32 vector (got "
                         f"{tuple(partials.shape)} {partials.dtype})")
    norm = torch.empty((), dtype=torch.float32, device=partials.device)
    _launch("bj_guard_max", "nst_bj_guard_max", partials.device,
            [partials.data_ptr(), partials.numel(), norm.data_ptr()])
    count(_count, ("guard_max", torch.float32))
    return norm
