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
JAX package, multiplies all m + 1 rows): four launches per step, the
partial sums in a fixed order, no atomics on values.  They stage the
basis rows with 16-byte copies, so the basis comes from ``basis``: a
(rows, ld) buffer, ld = n rounded up to a multiple of 32 elements (128
bytes; the pad zero), seen as its (rows, n) view; ``GmresLoop`` allocates V and Z
so, and its ``index_select``, ``y @ Z`` and ``zero_()`` take the views
as they are.  The wrapper raises on a basis whose rows or base are not
16-byte aligned; it never copies.  It replaces no Pallas kernel: XLA
runs the JAX body's masked products inside its ``lax.while_loop``.

Dispatch: CPU tensors take ``gram_schmidt_plain`` (which takes the same
views); CUDA tensors launch the kernels or raise.  ``COUNTS.calls``
counts the launched steps (each ``LAUNCHES`` kernels; under capture
through the graph's record, ``kernels/launches.py``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from navierstokes_tpu_torch.kernels.launches import count

OWNERS = 256                # CTAs of a pass, each summing its tiles
LAUNCHES = 4                # kernels per step (three passes and the write)
ALIGN = 32                  # the basis's row stride, in elements


@dataclasses.dataclass
class Counts:
    calls: int = 0          # steps launched (LAUNCHES kernels each)

    def reset(self):
        self.calls = 0


COUNTS = Counts()


def _count():
    COUNTS.calls += 1


def basis(rows: int, n: int, dtype, device) -> torch.Tensor:
    """A basis of ``rows`` rows of n for the kernels: the (rows, n) view of
    a (rows, ld) buffer, ld = n rounded up to a multiple of ALIGN
    elements, so that every row starts on a 128-byte boundary.  The rows
    are left unset, as ``torch.empty`` leaves them (``GmresLoop`` zeroes V
    and Z at every cycle; a zeroed buffer would add a memset of the whole
    basis to every captured monolithic step, which builds its loop inside
    the capture); the pad is zero, and nothing writes or reads past
    column n."""
    ld = -(-n // ALIGN) * ALIGN
    buf = torch.empty((rows, ld), dtype=dtype, device=device)
    if ld > n:
        buf[:, n:].zero_()
    return buf[:, :n]


def padded(B: torch.Tensor) -> torch.Tensor:
    """The whole (rows, ld) buffer behind a view from ``basis``, pad
    included: zeroing it is one contiguous fill, where the view's is a
    strided one."""
    return B.as_strided((B.shape[0], B.stride(0)), (B.stride(0), 1))


@dataclasses.dataclass
class Workspace:
    """The kernels' scratch: two sets of each row's owner sums (a pass
    reads the last pass's set and writes the other: 2 (m + 1) OWNERS
    float64) and the vector w1 / w2 (n)."""
    sums: torch.Tensor
    w: torch.Tensor


def workspace(m: int, n: int, dtype, device) -> Workspace | None:
    """The scratch for a basis of m + 1 rows of n on ``device``; None on
    the CPU (the plain version needs none).  On a card it also raises the
    passes' shared-memory limit there (``setup``), before any capture."""
    device = torch.device(device)
    if device.type == "cpu":
        return None
    setup(device, dtype)
    return Workspace(torch.empty(2 * (m + 1) * OWNERS, dtype=torch.float64,
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


def _suffix(dtype):
    suffix = {torch.float32: "f32", torch.float64: "f64"}.get(dtype)
    if suffix is None:
        raise TypeError(f"gram_schmidt: V must be float32 or float64 on CUDA "
                        f"(got {dtype}); the kernel has no other variant")
    return suffix


def _entry(dtype, device):
    """The library's entry for ``dtype`` on ``device`` (a CUDA device):
    builds or loads the library, or raises."""
    if device.type != "cuda":
        raise ValueError(f"gram_schmidt: unsupported device {device}")
    suffix = _suffix(dtype)
    from navierstokes_tpu_torch.kernels.build import library
    lib = library()
    return lib, getattr(lib, f"nst_gram_schmidt_{suffix}")


@functools.lru_cache(maxsize=None)
def _setup(device_index: int, dtype) -> dict:
    from navierstokes_tpu_torch.kernels.build import library
    info = (ctypes.c_int * 2)()
    lib = library()
    with torch.cuda.device(device_index):
        rc = getattr(lib, f"nst_gram_schmidt_setup_{_suffix(dtype)}")(info)
    if rc != 0:
        raise RuntimeError(f"gram_schmidt setup failed ({rc}): "
                           f"{lib.nst_cuda_error_string(rc).decode()}")
    return dict(zip(("sms", "max_rows"), info))


def setup(device, dtype) -> dict:
    """The passes' shared-memory limit raised to the card's opt-in limit
    on a CUDA ``device`` (once per card and dtype: what a launch takes
    depends on m alone, so no basis lowers another's limit); returns its
    SMs and the most rows a basis may have."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"gram_schmidt: unsupported device {device}")
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return _setup(index, dtype)


def aligned(t: torch.Tensor) -> bool:
    """Whether ``t`` starts on a 16-byte boundary."""
    return t.data_ptr() % 16 == 0


def _check(name, t, dtype, shape, dev, contiguous=True):
    if t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"gram_schmidt: {name} must be {dtype} of shape "
                         f"{shape} (got {t.dtype} {tuple(t.shape)})")
    if t.device != dev:
        raise ValueError(f"gram_schmidt: {name} on {t.device}, V on {dev}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"gram_schmidt: {name} must be contiguous")


def check_basis(name, B):
    """Raise unless the kernels can stage B's rows with 16-byte copies:
    unit column stride, a row stride of at least n whose bytes are a
    multiple of 16, and a 16-byte aligned base (``basis`` gives all
    three).  Returns the row stride."""
    n, ld = B.shape[1], B.stride(0)
    if B.stride(1) != 1 or ld < n:
        raise ValueError(f"gram_schmidt: {name} needs unit column stride "
                         f"and a row stride >= n (got strides "
                         f"{B.stride()}); allocate it with basis()")
    if (ld * B.element_size()) % 16 or not aligned(B):
        raise ValueError(f"gram_schmidt: {name}'s rows must start on "
                         f"16-byte boundaries (row stride {ld}, base "
                         f"{B.data_ptr() % 16} bytes off); allocate it "
                         "with basis()")
    return ld


def gram_schmidt(V, w, h1, h2, wnorm, j, active, work: Workspace | None,
                 z=None, Z=None):
    """The Arnoldi step's Gram-Schmidt (see the module docstring), in
    place.  CPU tensors take ``gram_schmidt_plain``; CUDA tensors launch
    the kernels (``work`` from ``workspace``, V and Z from ``basis``) or
    raise."""
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
    checks = [("V", V, dt, (m + 1, n), False), ("w", w, dt, (n,), True),
              ("h1", h1, dt, (m + 1,), True), ("h2", h2, dt, (m + 1,), True),
              ("wnorm", wnorm, dt, (), True), ("j", j, torch.int32, (), True),
              ("active", active, torch.bool, (), True),
              ("sums", work.sums, torch.float64, (2 * (m + 1) * OWNERS,),
               True),
              ("work.w", work.w, dt, (n,), True)]
    if Z is not None:
        checks += [("z", z, dt, (n,), True), ("Z", Z, dt, (m, n), False)]
    for name, t, dtype, shape, contiguous in checks:
        _check(name, t, dtype, shape, dev, contiguous)
    ld = check_basis("V", V)
    ldz = check_basis("Z", Z) if Z is not None else 0
    if not aligned(work.w):
        raise ValueError("gram_schmidt: the workspace's vector must be "
                         "16-byte aligned")
    info = setup(dev, dt)
    if m + 1 > info["max_rows"]:
        raise ValueError(f"gram_schmidt: a basis of {m + 1} rows exceeds "
                         f"the passes' shared memory ({info['max_rows']} "
                         "rows at most)")
    stream = torch.cuda.current_stream(dev).cuda_stream
    # the write: a 16-byte vector per thread, at most a full card's
    # threads (8 CTAs of 256 per SM)
    write_ctas = max(1, min(-(-n // (256 * (16 // V.element_size()))),
                            info["sms"] * 8))
    with torch.cuda.device(dev):
        rc = fn(V.data_ptr(), ld, w.data_ptr(), int(aligned(w)),
                h1.data_ptr(), h2.data_ptr(), wnorm.data_ptr(), j.data_ptr(),
                active.data_ptr(), None if z is None else z.data_ptr(),
                int(z is not None and aligned(z)),
                None if Z is None else Z.data_ptr(), ldz,
                work.sums.data_ptr(), work.w.data_ptr(), m, n, write_ctas,
                stream)
    if rc != 0:
        msg = (lib.nst_cuda_error_string(rc).decode() if rc > 0
               else "m < 1 or n < 1")
        raise RuntimeError(f"gram_schmidt launch failed ({rc}): {msg}")
    count(_count)
