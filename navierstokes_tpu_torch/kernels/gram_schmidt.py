"""FGMRES's two-pass modified Gram-Schmidt on the device: the hand-written
CUDA kernels (csrc/gram_schmidt.cu) and their plain PyTorch version.

``gram_schmidt`` orthogonalises the Arnoldi step's new vector w (n,)
against rows 0..j of the basis V (m + 1, n) in two passes, as the JAX
package's ``gmres`` body does (navierstokes_tpu/solvers/krylov.py:95-103):
h1 = V w, w1 = w - h1 V, h2 = V w1, w2 = w1 - h2 V, with h1 and h2
(m + 1,) zero beyond j (the JAX mask), and ||w2||; while the 0-d flag
``active`` is up it writes V[min(j + 1, m)] = w2 / max(||w2||, 1e-30)
and, given ``Z`` (m, n) (FGMRES), Z[min(j, m - 1)] = z.  h1, h2 and the
0-d ``wnorm`` are written in place for the Givens kernel
(kernels/arnoldi_lsq.py); w is not written.  ``j`` (int32) and
``active`` are 0-d device tensors: no launch argument varies between
iterations or restart cycles.

Every product is summed in float64, for float32 data too (each product
of two floats is exact in float64, so the result, rounded once, hardly
depends on the order of the sum), in the kernels and in the plain
version alike: the card and the CPU then agree to within an ulp, as the
tile apply's float64 sums keep them (kernels/bj_apply.py).  For float64
data the plain version is the JAX body's products exactly (``V @ w`` over
the whole masked basis, ``torch.linalg.norm``).

On the card the kernels read rows 0..j only (the plain version, like the
JAX package, multiplies all m + 1 rows): six launches per step, the
partial sums in a fixed order, no atomics.  It replaces no Pallas kernel:
XLA runs the JAX body's masked products inside its ``lax.while_loop``.

Dispatch: CPU tensors take ``gram_schmidt_plain``; CUDA tensors launch
the kernels or raise.  ``COUNTS.calls`` counts the launched steps (each
the six kernels; under capture through the graph's record,
``kernels/launches.py``).
"""

from __future__ import annotations

import dataclasses

import torch

from navierstokes_tpu_torch.kernels.launches import count

TILE = 256                  # elements per CTA of the passes


@dataclasses.dataclass
class Counts:
    calls: int = 0          # steps launched (3 passes, 2 reductions and
                            # the finish each)

    def reset(self):
        self.calls = 0


COUNTS = Counts()


def _count():
    COUNTS.calls += 1


@dataclasses.dataclass
class Workspace:
    """The kernels' scratch: the per-CTA partial sums ((m + 1) * parts
    float64) and the vector w1 / w2 (n)."""
    part: torch.Tensor
    w: torch.Tensor


def workspace(m: int, n: int, dtype, device) -> Workspace | None:
    """The scratch for a basis of m + 1 rows of n on ``device``; None on
    the CPU (the plain version needs none)."""
    device = torch.device(device)
    if device.type == "cpu":
        return None
    parts = -(-n // TILE)
    return Workspace(torch.empty((m + 1) * parts, dtype=torch.float64,
                                 device=device),
                     torch.empty(n, dtype=dtype, device=device))


def gram_schmidt_plain(V, w, h1, h2, wnorm, j, active, z=None, Z=None):
    """The plain version (see the module docstring): the JAX body's masked
    whole-basis products, summed in float64 for float32 data."""
    m = V.shape[0] - 1
    mask = (torch.arange(m + 1, device=V.device) <= j).to(V.dtype)
    if V.dtype == torch.float64:
        dots = lambda x: V @ x
        minus = lambda x, h: x - h @ V
        norm = torch.linalg.norm
    else:
        Vd = V.double()
        dots = lambda x: (Vd @ x.double()).to(V.dtype)
        minus = lambda x, h: (x.double() - h.double() @ Vd).to(V.dtype)

        def norm(x):
            xd = x.double()
            return torch.sqrt(xd @ xd).to(x.dtype)
    a = dots(w) * mask
    w = minus(w, a)
    b = dots(w) * mask
    w = minus(w, b)
    wn = norm(w)
    h1.copy_(a)
    h2.copy_(b)
    wnorm.copy_(wn)
    jl = j.long().view(1)
    j1 = torch.clamp(jl + 1, max=m)
    V.index_copy_(0, j1, torch.where(
        active, w / torch.clamp(wn, min=1e-30),
        V.index_select(0, j1)[0])[None])
    if Z is not None:
        jz = torch.clamp(jl, max=m - 1)
        Z.index_copy_(0, jz, torch.where(
            active, z, Z.index_select(0, jz)[0])[None])


def _entry(dtype, device):
    """The library's entry for ``dtype`` on ``device`` (a CUDA device):
    builds or loads the library, or raises."""
    if device.type != "cuda":
        raise ValueError(f"gram_schmidt: unsupported device {device}")
    suffix = {torch.float32: "f32", torch.float64: "f64"}.get(dtype)
    if suffix is None:
        raise TypeError(f"gram_schmidt: V must be float32 or float64 on CUDA "
                        f"(got {dtype}); the kernel has no other variant")
    from navierstokes_tpu_torch.kernels.build import library
    lib = library()
    return lib, getattr(lib, f"nst_gram_schmidt_{suffix}")


def _check(name, t, dtype, shape, dev):
    if t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"gram_schmidt: {name} must be {dtype} of shape "
                         f"{shape} (got {t.dtype} {tuple(t.shape)})")
    if t.device != dev:
        raise ValueError(f"gram_schmidt: {name} on {t.device}, V on {dev}")
    if not t.is_contiguous():
        raise ValueError(f"gram_schmidt: {name} must be contiguous")


def gram_schmidt(V, w, h1, h2, wnorm, j, active, work: Workspace | None,
                 z=None, Z=None):
    """The Arnoldi step's Gram-Schmidt (see the module docstring), in
    place.  CPU tensors take ``gram_schmidt_plain``; CUDA tensors launch
    the kernels (``work`` from ``workspace``) or raise."""
    if V.device.type == "cpu":
        gram_schmidt_plain(V, w, h1, h2, wnorm, j, active, z, Z)
        return
    dev, dt = V.device, V.dtype
    lib, fn = _entry(dt, dev)
    if V.dim() != 2 or V.shape[0] < 2:
        raise ValueError(f"gram_schmidt: V must be (m + 1, n) with m >= 1, "
                         f"got {tuple(V.shape)}")
    m, n = V.shape[0] - 1, V.shape[1]
    if (Z is None) != (z is None):
        raise ValueError("gram_schmidt: z and Z go together")
    if work is None:
        raise ValueError("gram_schmidt: CUDA tensors need a workspace")
    checks = [("V", V, dt, (m + 1, n)), ("w", w, dt, (n,)),
              ("h1", h1, dt, (m + 1,)), ("h2", h2, dt, (m + 1,)),
              ("wnorm", wnorm, dt, ()), ("j", j, torch.int32, ()),
              ("active", active, torch.bool, ()),
              ("part", work.part, torch.float64, ((m + 1) * -(-n // TILE),)),
              ("work.w", work.w, dt, (n,))]
    if Z is not None:
        checks += [("z", z, dt, (n,)), ("Z", Z, dt, (m, n))]
    for name, t, dtype, shape in checks:
        _check(name, t, dtype, shape, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(V.data_ptr(), w.data_ptr(), h1.data_ptr(), h2.data_ptr(),
                wnorm.data_ptr(), j.data_ptr(), active.data_ptr(),
                None if z is None else z.data_ptr(),
                None if Z is None else Z.data_ptr(), work.part.data_ptr(),
                work.w.data_ptr(), m, n, stream)
    if rc != 0:
        msg = (lib.nst_cuda_error_string(rc).decode() if rc > 0
               else "m < 1 or n < 1")
        raise RuntimeError(f"gram_schmidt launch failed ({rc}): {msg}")
    count(_count)
