"""Block-Jacobi exact tile inverse: the Hopper kernel and its plain PyTorch
version.

When the Newton-Schulz guard fails (or the model runs without a seed) the
step inverts its tiles exactly (``ops/p1ell.block_jacobi_exact``): the JAX
package's ``jnp.linalg.inv`` under ``block_jacobi_invert``'s ``lax.cond``
(``navierstokes_tpu/ops/p1ell.py:489``, ``:506``), which XLA lowers to a
batched LU.  Here each tile is inverted by Gauss-Jordan elimination with
partial (row) pivoting, in place, in fp32, by csrc/bj_inverse.cu's kernel,
in panels of PANEL columns:

* step k picks the pivot among the rows not yet pivoted, the largest
  |a_ik|, ties to the lowest row position (LAPACK's ``isamax``), a NaN
  below every number; the pivot row takes position k (the row there takes
  the pivot's), rows are not moved;
* it scales the pivot row by its reciprocal r = 1 / d (as LAPACK's
  ``sgetf2`` scales its column): u_j = a_pj r, u_k = r; every other row i
  takes a_ij - f_i u_j for f_i = a_ik, with a_ik set to 0 first, and the
  pivot row becomes u;
* the panel's columns and its pivot rows take the steps one at a time;
  every other value takes the panel's 16 steps at once, a - (f_0 u_0 +
  f_1 u_1 + ... ), the products summed in step order, then subtracted
  (a blocked LU's trailing update does the same: 16 products a
  subtraction instead of 16 subtractions keeps the residual |I - A X|
  within twice cuSOLVER's, where one step at a time gave 3x);
* every operation is rounded alone (a product, then a sum), so the kernel
  repeats the plain version's bits; the inverse's row pos[r] is the
  tile's row r, its column perm[g] the column g; the result is rounded
  once to the output dtype (fp32, bf16 or fp64), row-major.

A tile with a NaN, or a zero pivot, comes out non-finite (as cuSOLVER's).
A tile's inverse does not depend on the other tiles of the batch.

The kernel's schedule (which CTA does an operation, and when, is free
under the rounding rule above): a tile is a cluster of SB / COLUMNS CTAs,
panel P lives in CTA P mod (SB / COLUMNS), and the owner of P + 1 applies
P to its columns of P + 1 first, factors P + 1 and sends the panel's
buffer to the other CTAs by bulk copies, then applies P to its other
columns, so the trailing update of a panel runs under the next panel's
factorisation.  At the bench point's 1,760 tiles of 256 on an H100 it
takes 5.7-6.1 ms (the earlier blocked schedule 6.8-7.4, the bound 0.88, the
rounding rule's floor 1.76; PERF.md section 6); the factorisation's
columns (about 950 clocks each, on an SM shared with another tile's
trailing update) bound it.

Dispatch: CPU tensors take ``inverse_plain``; CUDA tensors launch the
kernel or raise.  ``COUNTS`` records the launches by output dtype and any
plain call made on CUDA tensors (which the main path must never make).
Under CUDA graph capture (``kernels/launches.record_launches``) a launch
goes into the graph's ``LaunchRecord``, which adds it to ``COUNTS`` at
every replay (models/step_graphs.py).
"""

from __future__ import annotations

import dataclasses

import torch

from navierstokes_tpu_torch.kernels.bj_tiles import TILE_SIZES
from navierstokes_tpu_torch.kernels.launches import count


@dataclasses.dataclass
class Counts:
    launches: int = 0            # kernel launches
    plain_cuda_calls: int = 0    # inverse_plain called on CUDA tensors
    by_dtype: dict = dataclasses.field(default_factory=dict)  # out dtype

    def reset(self):
        self.launches = self.plain_cuda_calls = 0
        self.by_dtype.clear()


COUNTS = Counts()


def _count(dtype):
    COUNTS.launches += 1
    COUNTS.by_dtype[dtype] = COUNTS.by_dtype.get(dtype, 0) + 1


# the output dtype -> the entry's out_kind
OUT_KINDS = {torch.float32: 1, torch.bfloat16: 2, torch.float64: 3}
# the kernel's shape (csrc/bj_inverse.cu): each CTA of a tile's cluster
# holds COLUMNS of its columns, panels of PANEL columns taken cyclically
COLUMNS = 64
PANEL = 16


def cluster(sb: int) -> int:
    """The CTAs of one tile's cluster (SB / COLUMNS)."""
    return max(1, sb // COLUMNS)


# ---- plain version ---------------------------------------------------------


def gauss_jordan_plain(a):
    """Gauss-Jordan with partial pivoting on the fp32 tiles ``a`` (n, SB,
    SB), batched, in panels of PANEL columns, in the kernel's order (see
    the module docstring).  Rows stay in place; each keeps its position.
    Returns (inverse, perm): the fp32 inverses and perm (n, SB) int64, the
    original row at each final position."""
    n, sb = a.shape[0], a.shape[-1]
    dev = a.device
    x = a.to(torch.float32).clone(memory_format=torch.contiguous_format)
    ar = torch.arange(n, device=dev)
    rows = torch.arange(sb, device=dev)
    pos = rows.repeat(n, 1)                  # pos[t, r]: row r's position
    nb = min(PANEL, sb)
    for k0 in range(0, sb, nb):
        # the panel's columns, every row: one column at a time
        v = x[:, :, k0:k0 + nb].clone()
        f = x.new_empty((n, nb, sb))         # f[:, m]: column k0 + m at m
        piv = torch.empty((n, nb), dtype=torch.long, device=dev)
        for m in range(nb):
            k = k0 + m
            xm = v[:, :, m].clone()
            key = xm.abs()
            key = torch.where(torch.isnan(key), -1.0, key)
            key = torch.where(pos < k, -2.0, key)
            best = key.amax(dim=1, keepdim=True)
            q = torch.where(key == best, pos, sb).amin(dim=1)
            p = (pos == q[:, None]).int().argmax(dim=1)
            r = 1.0 / v[ar, p, m]
            u = v[ar, p] * r[:, None]
            u[:, m] = r
            f[:, m] = xm
            v[:, :, m] = 0.0
            v = v - xm[:, :, None] * u[:, None, :]
            v[ar, p] = u
            at_k = (pos == k).int().argmax(dim=1)
            pos[ar, at_k] = q
            pos[ar, p] = k
            piv[:, m] = p
        x[:, :, k0:k0 + nb] = v
        oc = torch.cat([rows[:k0], rows[k0 + nb:]])      # the other columns
        # the pivot rows through the panel's steps, one step at a time
        fp = f.gather(2, piv[:, None, :].expand(n, nb, nb))
        pr = x[ar[:, None], piv][:, :, oc]
        us = x.new_empty((n, nb, oc.numel()))
        for m in range(nb):
            u = pr[:, m] * (1.0 / fp[:, m, m])[:, None]
            pr[:, m] = u
            us[:, m] = u
            for m2 in range(nb):
                if m2 != m:
                    pr[:, m2] = pr[:, m2] - fp[:, m, m2, None] * u
        # the other rows: the panel's products summed in step order, then
        # subtracted once
        t = f[:, 0, :, None] * us[:, 0, None, :]
        for m in range(1, nb):
            t = t + f[:, m, :, None] * us[:, m, None, :]
        isp = torch.zeros((n, sb), dtype=torch.bool, device=dev)
        isp[ar[:, None], piv] = True
        rest = x[:, :, oc]
        x[:, :, oc] = torch.where(isp[:, :, None], rest, rest - t)
        x[ar[:, None, None], piv[:, :, None], oc[None, None, :]] = pr
    perm = torch.empty_like(pos)
    perm.scatter_(1, pos, rows.repeat(n, 1))
    y = torch.empty_like(x)
    y[ar[:, None, None], pos[:, :, None], perm[:, None, :]] = x
    return y, perm


def _write(y, out_dtype, out):
    if out is None:
        return y if out_dtype in (None, torch.float32) else y.to(out_dtype)
    out.copy_(y)
    return out


def _plain_call(t):
    if t.is_cuda:
        COUNTS.plain_cuda_calls += 1


def inverse_plain(a, *, out_dtype=None, out=None):
    """The tiles' inverses as PyTorch operations, with the kernel's bits:
    fp32, rounded once to ``out_dtype`` (default fp32), row-major, written
    into ``out`` where given."""
    _plain_call(a)
    _check_out(a, out_dtype, out)
    return _write(gauss_jordan_plain(a)[0], out_dtype, out)


# ---- kernel ----------------------------------------------------------------


def _check_out(a, out_dtype, out):
    if out is None:
        if out_dtype is not None and out_dtype not in OUT_KINDS:
            raise TypeError(f"bj_inverse: no output in {out_dtype} "
                            "(float32, bfloat16 or float64)")
        return
    if out_dtype is not None and out.dtype != out_dtype:
        raise TypeError(f"bj_inverse: out is {out.dtype}, not {out_dtype}")
    if out.dtype not in OUT_KINDS:
        raise TypeError(f"bj_inverse: no output in {out.dtype} (float32, "
                        "bfloat16 or float64)")
    if out.shape != a.shape or out.device != a.device:
        raise ValueError(f"bj_inverse: out {tuple(out.shape)} on "
                         f"{out.device} for tiles {tuple(a.shape)} on "
                         f"{a.device}")
    sb = out.shape[-1]
    if out.stride(2) != 1 or out.stride(1) < sb or (
            out.shape[0] > 1 and out.stride(0) < sb * out.stride(1)):
        raise ValueError(f"bj_inverse: out must hold row-major tiles "
                         f"(strides {out.stride()})")


def _launch(entry, dev, args):
    from navierstokes_tpu_torch.kernels.build import library
    lib = library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(*args, stream)
    if rc != 0:
        msg = (lib.nst_cuda_error_string(rc).decode() if rc > 0 else
               "no instantiation in csrc/bj_inverse.cu")
        raise RuntimeError(f"bj_inverse ({entry}) launch failed ({rc}): "
                           f"{msg}")


def check_tiles(a):
    """Raise unless the kernel takes the tiles ``a``: fp32, a contiguous,
    16-byte aligned stack (n, SB, SB) with SB in ``TILE_SIZES``."""
    if a.dtype != torch.float32:
        raise TypeError(f"bj_inverse: tiles must be float32 (got {a.dtype})")
    if a.dim() != 3 or a.shape[1] != a.shape[2] or not a.is_contiguous():
        raise ValueError(f"bj_inverse: tiles must be a contiguous stack of "
                         f"square tiles, got {tuple(a.shape)} strides "
                         f"{a.stride()}")
    if a.shape[-1] not in TILE_SIZES:
        raise ValueError(f"bj_inverse: no instantiation for tiles of "
                         f"{a.shape[-1]}x{a.shape[-1]} in csrc/bj_inverse.cu "
                         f"(built for SB in {TILE_SIZES})")
    if a.data_ptr() % 16:
        raise ValueError("bj_inverse: tiles must be 16-byte aligned (the "
                         "kernel's vector loads)")


def inverse(a, *, out_dtype=None, out=None):
    """The inverses of the fp32 tiles ``a`` (n, SB, SB), contiguous (see
    the module docstring): ``inverse_plain`` on the CPU, csrc/bj_inverse.cu's
    kernel on CUDA tensors.  fp32 results rounded once to ``out_dtype``
    (default fp32), row-major; into ``out`` where given, whose tiles may
    lie at any tile and row stride (a slot of a larger buffer)."""
    if a.device.type == "cpu":
        return inverse_plain(a, out_dtype=out_dtype, out=out)
    if a.device.type != "cuda":
        raise ValueError(f"bj_inverse: unsupported device {a.device}")
    check_tiles(a)
    _check_out(a, out_dtype, out)
    if out is None:
        out = torch.empty(a.shape, dtype=out_dtype or torch.float32,
                          device=a.device)
    if a.shape[0] == 0:
        return out
    _launch("nst_bj_inverse", a.device,
            [a.data_ptr(), out.data_ptr(), a.shape[-1], a.shape[0],
             OUT_KINDS[out.dtype], out.stride(0), out.stride(1)])
    count(_count, out.dtype)
    return out


def max_clusters(sb: int, device_index: int = 0) -> int:
    """The clusters of the kernel at tiles of ``sb`` that the card holds at
    once (``cudaOccupancyMaxActiveClusters``): tiles in flight."""
    import ctypes
    from navierstokes_tpu_torch.kernels.build import library
    n = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        rc = library().nst_bj_inverse_occupancy(sb, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"bj_inverse occupancy query failed ({rc})")
    return n.value
