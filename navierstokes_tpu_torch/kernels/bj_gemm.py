"""Block-Jacobi Newton-Schulz products: the Hopper GEMM and its plain
PyTorch versions.

Each step's tile rebuild (``ops/p1ell.block_jacobi_invert``) multiplies
stacks of fp32 tiles (n_tiles, SB, SB): A X0 for the guard, then ``iters``
Newton-Schulz steps X <- 2 X - X (A X) with A X between them.  The JAX
package runs them as batched ``jnp.matmul`` on the TPU
(``navierstokes_tpu/ops/p1ell.py`` ``block_jacobi_invert``: :491, :498,
:501) and fuses the guard (:493) and the updates around them.  Here one
batched fp32 GEMM of csrc/bj_gemm.cu computes C_t = A_t B_t for every tile
and carries the pass that follows each product in its epilogue:

* ``product(a, b)``: C row-major (A X);
* ``guard(a, x0, partials)``: C = A X0 row-major and the guard's norm, the
  max over every row of every tile of the row sum of |I - C| in fp32, each
  row summed as ``bj_tiles.guard_plain``'s pairwise tree, NaN propagated:
  the GEMM's CTAs write their max into ``partials``, and csrc/bj_tiles.cu's
  ``bj_guard_max`` (``bj_tiles.guard_max``) reduces them into a 0-d tensor
  on the device;
* ``update(x, ax, out_dtype=, out=)``: 2 X - X (A X) in fp32 in X's layout,
  or, for the last update, row-major in ``out_dtype`` (fp32, bf16 or fp64)
  into ``out`` where given, at its tile and row strides (the captured
  step's tile buffer).

Each operand is a stack of row-major or column-major tiles
(``bj_tiles.layout``).  On the card every operand of the rebuild is
row-major: the tiles A, the seed X0 (``ops/p1ell.block_jacobi_inverse``
stores it so), the updates' X (in X's layout) and A X.  The kernel sums
each output in one fp32 accumulator, k ascending, one fused multiply-add a
step; the epilogues round every operation alone in the plain versions'
order (``torch.matmul``, then ``bj_tiles.guard_plain`` /
``bj_tiles.update_plain``).  A tile's product does not depend on the
batch.

Dispatch: CPU tensors take the plain versions, so the CPU path keeps
LAPACK's / MKL's products; CUDA tensors launch the kernel or raise (no
copy, no fallback).  ``COUNTS`` records the launches by (epilogue, output
dtype) and any plain call made on CUDA tensors (which the main path must
never make).  Under CUDA graph capture (``kernels/launches.record_launches``)
a launch goes into the graph's ``LaunchRecord``, which adds it to
``COUNTS`` at every replay (models/step_graphs.py).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from navierstokes_tpu_torch.kernels import bj_tiles
from navierstokes_tpu_torch.kernels.bj_tiles import TILE_SIZES, layout
from navierstokes_tpu_torch.kernels.launches import count


@dataclasses.dataclass
class Counts:
    launches: int = 0            # kernel launches
    plain_cuda_calls: int = 0    # plain versions called on CUDA tensors
    # launches by (epilogue, output dtype): ("product", fp32), ("guard",
    # fp32), ("update", fp32), ("update_last", the output's dtype)
    by_variant: dict = dataclasses.field(default_factory=dict)

    def reset(self):
        self.launches = self.plain_cuda_calls = 0
        self.by_variant.clear()


COUNTS = Counts()


def _count(variant):
    COUNTS.launches += 1
    COUNTS.by_variant[variant] = COUNTS.by_variant.get(variant, 0) + 1


# the last update's output dtype -> the entry's out_kind
OUT_KINDS = {torch.float32: 1, torch.bfloat16: 2, torch.float64: 3}
EPILOGUES = ("product", "guard", "update")
# outputs of one CTA at SB >= 256 (csrc/bj_gemm.cu kOutputs); a CTA takes
# a strip of BM = min(SB, OUTPUTS / SB) rows of one tile
OUTPUTS = 32768
ALIGN = 16


def strip_rows(sb: int) -> int:
    """BM, the rows of a tile that one CTA computes."""
    return sb if sb * sb < OUTPUTS else OUTPUTS // sb


def ctas(n_tiles: int, sb: int) -> int:
    """The CTAs of one launch over ``n_tiles`` tiles of ``sb``: the
    guard's partials."""
    return n_tiles * (sb // strip_rows(sb))


def guard_partials(n_tiles: int, sb: int, device) -> torch.Tensor:
    """The guard's scratch for a stack of ``n_tiles`` tiles of ``sb``: one
    fp32 max a CTA."""
    return torch.empty(max(1, ctas(n_tiles, sb)), dtype=torch.float32,
                       device=device)


def _plain_call(t):
    if t.is_cuda:
        COUNTS.plain_cuda_calls += 1


# ---- plain versions --------------------------------------------------------


def product_plain(a, b):
    """A B as ``torch.matmul`` (fp32, row-major)."""
    _plain_call(a)
    return torch.matmul(a, b)


def guard_product_plain(a, x0):
    """(A X0, the guard's norm): ``torch.matmul``, then
    ``bj_tiles.guard_plain``."""
    _plain_call(a)
    ax = torch.matmul(a, x0)
    return ax, bj_tiles.guard_plain(ax)


def update_product_plain(x, ax, *, out_dtype=None, out=None):
    """2 X - X (A X): ``torch.matmul``, then ``bj_tiles.update_plain``."""
    _plain_call(x)
    return bj_tiles.update_plain(x, torch.matmul(x, ax), out_dtype=out_dtype,
                                 out=out)


# ---- kernel ----------------------------------------------------------------


def check_operands(name, a, b):
    """Raise unless the kernel takes the operand stacks ``a`` and ``b``:
    fp32, on one device, equal non-empty stacks (n, SB, SB) with SB in
    ``TILE_SIZES``, each row- or column-major per tile (``layout``) and
    16-byte aligned.  Returns their layouts (True: column-major)."""
    for what, t in (("left", a), ("right", b)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the {what} operand must be float32 "
                            f"(got {t.dtype})")
    if a.device != b.device:
        raise ValueError(f"{name}: operands on {a.device} and {b.device}")
    if a.dim() != 3 or a.shape != b.shape or a.shape[1] != a.shape[2]:
        raise ValueError(f"{name}: operands {tuple(a.shape)} and "
                         f"{tuple(b.shape)} must be equal stacks of square "
                         "tiles")
    if a.shape[0] == 0:
        raise ValueError(f"{name}: an empty stack of tiles")
    sb = a.shape[-1]
    if sb not in TILE_SIZES:
        raise ValueError(f"{name}: no instantiation for tiles of {sb}x{sb} "
                         f"in csrc/bj_gemm.cu (built for SB in "
                         f"{TILE_SIZES})")
    cols = layout(a), layout(b)
    if None in cols:
        raise ValueError(f"{name}: operands must be row- or column-major "
                         f"stacks of tiles (strides {a.stride()}, "
                         f"{b.stride()})")
    if a.data_ptr() % ALIGN or b.data_ptr() % ALIGN:
        raise ValueError(f"{name}: operands must be 16-byte aligned (the "
                         "kernel's vector loads)")
    return cols


def check_out(name, x, out_dtype, out):
    """Raise unless the last update can write into ``out`` (or allocate
    ``out_dtype``): fp32, bf16 or fp64, x's shape and device, row-major
    tiles at tile and row strides that are multiples of 4 elements,
    16-byte aligned, not x's memory."""
    dt = out.dtype if out is not None else out_dtype
    if dt not in OUT_KINDS:
        raise TypeError(f"{name}: no last update into {dt} (float32, "
                        "bfloat16 or float64)")
    if out is None:
        return
    if out_dtype is not None and out.dtype != out_dtype:
        raise TypeError(f"{name}: out is {out.dtype}, not {out_dtype}")
    if out.shape != x.shape or out.device != x.device:
        raise ValueError(f"{name}: out {tuple(out.shape)} on {out.device} "
                         f"for tiles {tuple(x.shape)} on {x.device}")
    n, sb = x.shape[0], x.shape[-1]
    st = out.stride()
    if (st[2] != 1 or st[1] < sb or st[1] % 4
            or (n > 1 and (st[0] < sb * st[1] or st[0] % 4))):
        raise ValueError(f"{name}: out must hold row-major tiles at tile "
                         f"and row strides that are multiples of 4 "
                         f"(strides {st})")
    if out.data_ptr() % ALIGN:
        raise ValueError(f"{name}: out must be 16-byte aligned")
    if out.data_ptr() == x.data_ptr():
        raise ValueError(f"{name}: out must not be x")


def _is_device(name, t):
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return True


def _launch(name, entry, dev, args):
    from navierstokes_tpu_torch.kernels.build import library
    lib = library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(*args, stream)
    if rc != 0:
        msg = (lib.nst_cuda_error_string(rc).decode() if rc > 0 else
               "no instantiation in csrc/bj_gemm.cu")
        raise RuntimeError(f"{name} ({entry}) launch failed ({rc}): {msg}")


def product(a, b):
    """A B over the stacks (see the module docstring), fp32 row-major:
    ``product_plain`` on the CPU, csrc/bj_gemm.cu's product epilogue on
    CUDA tensors."""
    if not _is_device("bj_gemm.product", a):
        return product_plain(a, b)
    a_col, b_col = check_operands("bj_gemm.product", a, b)
    n, sb = a.shape[0], a.shape[-1]
    c = torch.empty((n, sb, sb), dtype=torch.float32, device=a.device)
    _launch("bj_gemm.product", "nst_bj_gemm_product", a.device,
            [a.data_ptr(), b.data_ptr(), c.data_ptr(), sb, n, int(a_col),
             int(b_col)])
    count(_count, ("product", torch.float32))
    return c


def guard(a, x0, partials=None):
    """(A X0 row-major, the guard's 0-d norm) (see the module docstring):
    ``guard_product_plain`` on the CPU, csrc/bj_gemm.cu's guard epilogue
    and bj_tiles' max of its partials on CUDA tensors.  ``partials``: the
    scratch of ``guard_partials`` (allocated here when None)."""
    if not _is_device("bj_gemm.guard", a):
        return guard_product_plain(a, x0)
    a_col, b_col = check_operands("bj_gemm.guard", a, x0)
    n, sb = a.shape[0], a.shape[-1]
    grid = ctas(n, sb)
    if partials is None:
        partials = guard_partials(n, sb, a.device)
    if (partials.dtype != torch.float32 or partials.device != a.device
            or not partials.is_contiguous() or partials.numel() < grid):
        raise ValueError(f"bj_gemm.guard: partials must be {grid} contiguous "
                         f"float32 values on {a.device} (got "
                         f"{partials.numel()} {partials.dtype} on "
                         f"{partials.device})")
    c = torch.empty((n, sb, sb), dtype=torch.float32, device=a.device)
    _launch("bj_gemm.guard", "nst_bj_gemm_guard", a.device,
            [a.data_ptr(), x0.data_ptr(), c.data_ptr(), partials.data_ptr(),
             sb, n, int(a_col), int(b_col)])
    count(_count, ("guard", torch.float32))
    return c, bj_tiles.guard_max(partials[:grid])


def update(x, ax, *, out_dtype=None, out=None):
    """One Newton-Schulz update 2 X - X (A X) (see the module docstring):
    ``update_product_plain`` on the CPU, csrc/bj_gemm.cu's update epilogue
    on CUDA tensors.  Without ``out_dtype`` and ``out``: fp32 in x's
    layout; with either (the last update): row-major in that dtype, into
    ``out`` where given."""
    if not _is_device("bj_gemm.update", x):
        return update_product_plain(x, ax, out_dtype=out_dtype, out=out)
    x_col, p_col = check_operands("bj_gemm.update", x, ax)
    n, sb = x.shape[0], x.shape[-1]
    last = out is not None or out_dtype is not None
    if last:
        check_out("bj_gemm.update", x, out_dtype, out)
        if out is not None and out.data_ptr() == ax.data_ptr():
            raise ValueError("bj_gemm.update: out must not be ax")
        if out is None:
            out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
        kind, ts, rs = OUT_KINDS[out.dtype], out.stride(0), out.stride(1)
    else:
        out = torch.empty_strided(
            x.shape, (sb * sb, 1, sb) if x_col else (sb * sb, sb, 1),
            dtype=torch.float32, device=x.device)
        kind, ts, rs = 0, sb * sb, sb
    _launch("bj_gemm.update", "nst_bj_gemm_update", x.device,
            [x.data_ptr(), ax.data_ptr(), out.data_ptr(), sb, n, int(x_col),
             int(p_col), kind, ts, rs])
    count(_count, ("update_last", out.dtype) if last
          else ("update", torch.float32))
    return out


def occupancy(sb: int, epilogue: str, device_index: int = 0) -> int:
    """CTAs of the epilogue's kernel at tiles of ``sb`` that one SM holds
    at once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    from navierstokes_tpu_torch.kernels.build import library
    n = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        rc = library().nst_bj_gemm_occupancy(sb, EPILOGUES.index(epilogue),
                                             ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"bj_gemm occupancy query failed ({rc})")
    return n.value
