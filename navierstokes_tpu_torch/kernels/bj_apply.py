"""Block-Jacobi tile apply: the Hopper kernel and its plain PyTorch version.

The inner F solve's preconditioner (``ops/p1ell.block_jacobi_apply``):

    y[t*SB + i, c] = sum over k < SB of inv_tiles[t, i, k] * r[t*SB + k, c]

for r of shape (n_p2, d), d = 2 or 3, and inv_tiles of shape
(n_tiles, SB, SB) with (n_tiles - 1) * SB < n_p2 <= n_tiles * SB; rows
of r at or beyond n_p2 count as 0.  Every tile apply of the port goes
through it: the eager step's F preconditioner, the captured step
(models/step_graphs.py) and each row shard (parallel/sharded_bsr.py).

Three variants of the CUDA kernels of csrc/bj_apply.cu, chosen by the
dtype of the tiles, for SB = 128, 256 (the port's default) or 512:

* fp32 tiles, fp32 r and y, sums in float64 — replaces the Pallas TPU
  kernel ``scripts/exp_fused.py`` ``bj_kern`` (and its planar twin in
  ``scripts/exp_fused2.py``), the JAX package's
  ``navierstokes_tpu/ops/p1ell.py`` ``block_jacobi_apply`` in fp32;
* bf16 tiles, fp32 r and y (``inner_bf16`` / ``bj_bf16``) — ``bj_kern16``,
  with the JAX package's rounding (``p1ell.py:510-516``): r rounded to
  bf16, products summed in fp32, the result rounded to bf16, then cast to
  r's dtype (the prototype's fp32 output skips the last rounding);
* fp64 tiles, fp64 r and y — float64 runs on the card (no Pallas
  counterpart).

It is bound by device-memory traffic: each tile value is read once for d
multiply-adds.  fp64 tiles stream through bulk copies into a shared-memory
ring on a persistent grid (one CTA per SM, each walking a contiguous range
of row blocks, ``partition``), each tile's block of r staged once per tile
a CTA enters; fp32 and bf16 tiles keep a register stream of one CTA per 64
rows, which measured faster on their tiles (the source note of
csrc/bj_apply.cu).  Each row sums in the same fixed order in both, so a
tile's result does not depend on the grid, the tile count or its place in
the batch, and repeats are bit-identical.

Dispatch: CPU tensors take the plain version; CUDA tensors launch the
kernel or raise.  ``COUNTS`` records the launches by (tiles dtype, d) and
any plain call made on CUDA tensors (which the main path must never make).
Under CUDA graph capture (``kernels/launches.record_launches``) a call
launches nothing yet: its launch goes into the graph's ``LaunchRecord``,
which adds it to ``COUNTS`` at every replay (models/step_graphs.py).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as Fn

from navierstokes_tpu_torch.kernels.launches import count


@dataclasses.dataclass
class Counts:
    launches: int = 0            # kernel launches, all variants
    plain_cuda_calls: int = 0    # block_jacobi_apply_plain on CUDA tensors
    # launches by instantiation: (tiles dtype, d)
    by_variant: dict = dataclasses.field(default_factory=dict)

    def reset(self):
        self.launches = self.plain_cuda_calls = 0
        self.by_variant.clear()


COUNTS = Counts()


def _count(variant):
    COUNTS.launches += 1
    COUNTS.by_variant[variant] = COUNTS.by_variant.get(variant, 0) + 1


# tiles dtype -> (C entry point, dtype of r and y)
VARIANTS = {
    torch.float32: ("nst_bj_apply_f32", torch.float32),
    torch.bfloat16: ("nst_bj_apply_bf16", torch.float32),
    torch.float64: ("nst_bj_apply_f64", torch.float64),
}
# the tile sizes SB with an instantiation in csrc/bj_apply.cu
TILE_SIZES = (128, 256, 512)
# the ring's bulk copies take fp64 tiles and r at 16-byte addresses
ALIGN = 16
# rows of a CTA of the register stream (fp32, bf16 tiles)
STREAM_ROWS = 64


@dataclasses.dataclass(frozen=True)
class Partition:
    """The persistent grid's split of ``n_items`` work items (blocks of
    consecutive rows of the tile batch): CTA b of ``grid`` takes
    ``per_cta + (b < n_long)`` items, after those of CTAs 0..b-1, in
    order.  The kernel gets ``grid``, ``per_cta`` and ``n_long`` and
    derives its range [b * per_cta + min(b, n_long), + per_cta + (b <
    n_long))."""
    n_items: int
    grid: int
    per_cta: int
    n_long: int


def partition(n_p2, rows_per_item, resident):
    """The work items of ``n_p2`` rows in blocks of ``rows_per_item``,
    dealt to at most ``resident`` CTAs (the card's resident CTAs) and at
    most one CTA per item, the first CTAs taking one more."""
    n_items = -(-n_p2 // rows_per_item)
    grid = max(1, min(resident, n_items))
    return Partition(n_items, grid, n_items // grid, n_items % grid)


@functools.lru_cache(maxsize=None)
def ring(device_index, sb, d):
    """The fp64 ring's (SB, d) instantiation on card ``device_index``:
    ``nst_bj_apply_f64_setup`` raises its shared memory limit there (once
    per instantiation and card, at its first launch) and reports its
    residency and ring."""
    from navierstokes_tpu_torch.kernels.build import library
    info = (ctypes.c_int * 7)()
    with torch.cuda.device(device_index):
        rc = library().nst_bj_apply_f64_setup(sb, d, info)
    if rc != 0:
        msg = {-1: f"no instantiation for SB={sb}, d={d}",
               -2: "the kernel does not fit on an SM"}.get(rc)
        if msg is None:
            msg = library().nst_cuda_error_string(rc).decode()
        raise RuntimeError(f"bj_apply (nst_bj_apply_f64_setup) failed "
                           f"({rc}): {msg}")
    keys = ("ctas_per_sm", "sms", "rows_per_item", "stages", "stage_bytes",
            "smem_bytes", "r_slots")
    return dict(zip(keys, info))


def launch_config(inv_tiles, r):
    """The grid a launch on these CUDA tensors takes: for fp64 tiles the
    ring and its partition, for fp32 and bf16 the register stream's CTAs."""
    n_p2, d = r.shape
    n_tiles, sb = inv_tiles.shape[0], inv_tiles.shape[1]
    if inv_tiles.dtype != torch.float64:
        return {"design": "register stream", "grid": n_tiles * sb
                // STREAM_ROWS, "rows_per_cta": STREAM_ROWS}
    g = ring(inv_tiles.device.index, sb, d)
    part = partition(n_p2, g["rows_per_item"], g["ctas_per_sm"] * g["sms"])
    return {"design": "ring", **g, **dataclasses.asdict(part)}


def block_jacobi_apply_plain(inv_tiles, r):
    """The same product as batched matmuls: r padded with zero rows to
    whole tiles and cast to the tiles' dtype, the padding rows cut, the
    result cast back to r's dtype.  bf16 tiles: a bf16 product.  fp32
    tiles: the product in float64 (each fp32 product is exact there),
    rounded once to fp32, as the kernel sums, so the two agree bit for bit
    but where a float64 sum lands within its own rounding of an fp32 tie;
    the JAX package's fp32 matmul sums in fp32 (within 1e-6 of max|y|)."""
    if inv_tiles.is_cuda:
        COUNTS.plain_cuda_calls += 1
    n_tiles, sb = inv_tiles.shape[0], inv_tiles.shape[1]
    n = n_tiles * sb
    rb = Fn.pad(r, (0, 0, 0, n - r.shape[0])).reshape(n_tiles, sb, -1)
    if inv_tiles.dtype == torch.float32:
        y = torch.matmul(inv_tiles.double(), rb.double()).float()
    else:
        y = torch.matmul(inv_tiles, rb.to(inv_tiles.dtype))
    return y.reshape(n, -1)[:r.shape[0]].to(r.dtype)


def bj_apply(inv_tiles, r):
    """The tile apply (see the module docstring).  CPU tensors take
    ``block_jacobi_apply_plain``; CUDA tensors launch the kernel variant of
    ``inv_tiles.dtype``."""
    if inv_tiles.device.type == "cpu":
        return block_jacobi_apply_plain(inv_tiles, r)
    if inv_tiles.device.type != "cuda":
        raise ValueError(f"bj_apply: unsupported device {inv_tiles.device}")
    if inv_tiles.dtype not in VARIANTS:
        raise TypeError(f"bj_apply: tiles must be float32, bfloat16 or "
                        f"float64 on CUDA (got {inv_tiles.dtype}); the kernel "
                        "has no other variant")
    entry, rdt = VARIANTS[inv_tiles.dtype]
    dev = inv_tiles.device
    if r.dtype != rdt:
        raise TypeError(f"bj_apply: r must be {rdt} on CUDA with "
                        f"{inv_tiles.dtype} tiles (got {r.dtype})")
    if r.device != dev:
        raise ValueError(f"bj_apply: r on {r.device}, tiles on {dev}")
    if inv_tiles.dim() != 3 or inv_tiles.shape[1] != inv_tiles.shape[2]:
        raise ValueError(f"bj_apply: tiles must be (n_tiles, SB, SB), got "
                         f"{tuple(inv_tiles.shape)}")
    n_tiles, sb = inv_tiles.shape[0], inv_tiles.shape[1]
    if sb not in TILE_SIZES:
        raise ValueError(f"bj_apply: no instantiation for tiles of "
                         f"{sb}x{sb} in csrc/bj_apply.cu (built for SB in "
                         f"{TILE_SIZES})")
    if r.dim() != 2 or r.shape[1] not in (2, 3):
        raise ValueError(f"bj_apply: r must be (n_p2, 2) or (n_p2, 3), got "
                         f"{tuple(r.shape)}")
    n_p2, d = r.shape
    if not (n_tiles - 1) * sb < n_p2 <= n_tiles * sb:
        raise ValueError(f"bj_apply: {n_p2} rows of r for {n_tiles} tiles "
                         f"of {sb} rows")
    for name, t in (("tiles", inv_tiles), ("r", r)):
        if not t.is_contiguous():
            raise ValueError(f"bj_apply: {name} must be contiguous")
    bulk = inv_tiles.dtype == torch.float64      # the ring's bulk copies
    # the register stream's widest load is four values (16 bytes in fp32,
    # 8 in bf16); it reads r without alignment
    stream_align = 4 * inv_tiles.element_size()
    for name, t, align in (("tiles", inv_tiles,
                            ALIGN if bulk else stream_align),
                           ("r", r, ALIGN if bulk else 1)):
        if t.data_ptr() % align:
            raise ValueError(f"bj_apply: {name} must be {align}-byte aligned "
                             "(the kernel's " + ("bulk copies)" if bulk else
                                                 "vector loads)"))
    from navierstokes_tpu_torch.kernels.build import library
    lib = library()
    y = torch.empty((n_p2, d), dtype=rdt, device=dev)
    if n_p2 == 0:
        return y
    args = [inv_tiles.data_ptr(), r.data_ptr(), y.data_ptr()]
    if bulk:
        cfg = launch_config(inv_tiles, r)
        args += [sb, n_p2, d, cfg["grid"], cfg["per_cta"], cfg["n_long"]]
    else:
        args += [n_tiles, sb, n_p2, d]
    stream = torch.cuda.current_stream(dev).cuda_stream
    # the C entry launches on the current device: make it the tensors'
    # (a row shard on another card, parallel/sharded_bsr.py)
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(*args, stream)
    if rc != 0:
        msg = (lib.nst_cuda_error_string(rc).decode() if rc > 0 else
               f"no instantiation for SB={sb}, d={d} in csrc/bj_apply.cu")
        raise RuntimeError(f"bj_apply ({entry}) launch failed ({rc}): {msg}")
    count(_count, (inv_tiles.dtype, d))
    return y
