"""The V-cycle's Chebyshev smoothing sweeps on the device: the
hand-written CUDA kernel (csrc/vcycle.cu), one persistent launch per
sweep, and its plain PyTorch version.

A V-cycle's stages on an assembled P1 operator S
(``ops/p1ell.P1Matrix``: the outlet-pinned Laplacian of the projection
Poisson solve, Ap of ``cc``/``pcd``), each one SELL D=1 product carrying
the update that follows it in ``solvers/schur.chebyshev`` /
``make_vcycle_solver`` (their plain versions below):

* ``cheb_first_plain``: r0 = r - S x; d = (sdinv * r0) / theta; zc = d.  x
  is the smoothing's z, or, given the coarse correction y, z + P y (the
  prolongation, repeat_interleave(y, agg)); with x None (z = 0) there is
  no product and r0 is r (r - S 0 equals r bit for bit).  With ``last``
  (k = 1) it writes only out = x + d (0 + d with x None);
* ``cheb_step_plain`` (iteration ``step`` of k - 1): resid = r0 - S zc;
  d = c1 d + c2 (sdinv * resid); zc' = zc + d; with ``last`` only
  out = z + zc' (0 + zc' with z None);
* ``residual_plain``: out = r - S x.

A sweep (``sweep``) is every stage between two coarse corrections, the
restriction's sum and the coarse GEMV, which stay torch calls:

* ``pre``: the first cycle's pre-smoothing at z = 0 into ``z0``, then the
  residual of z0 into ``rc``;
* ``mid`` (between two cycles): the post-smoothing of z0 + P y into
  ``z1``, the next cycle's pre-smoothing of z1 into z0, the residual of z0
  into rc;
* ``post``: the last post-smoothing of z0 + P y into ``out``.

So a V-cycle of n cycles launches n + 1 sweeps and the coarse
correction's 2 n kernels (``launches``).  ``sweep_plain``, the sweep's
plain version, is the composition of the stages' plain versions; it
writes the buffers the kernel writes (zc0 and zc1, ping-ponged, for
k > 1 and k > 2, and the sweep's outputs) and keeps r0, d and z + P y,
which the kernel holds in registers, in temporaries.

theta, c1 = rho_new * rho and c2 = 2 rho_new / delta of every iteration
come from ``coefficients``, computed once per operator with
``chebyshev``'s own torch expressions on the same 0-d lambda_max, so they
are the scalars the loop computes, to the bit.  The kernel rounds each
product, sum, difference and quotient on its own in the operand order of
the plain versions, and sums each row in the SELL kernel's order (the row
loop of csrc/sell_row.cuh), so every sweep gives its plain version's bits
in fp32 and fp64.

They replace no Pallas kernel: XLA fuses the JAX package's smoother and
V-cycle (navierstokes_tpu/solvers/schur.py:153-201), which the plain
version runs as about 85 launches per V-cycle at one cycle and k = 3.

The launch (``plan``, once per operator; ``SweepPlan``): a persistent,
cooperative grid of as many CTAs as the card holds at once (every CTA
resident, so the kernel's barriers complete), each CTA a contiguous range
of slices (``layout``), each warp ``rounds`` (1, 2 or 4) slices of it
with their rows' state in registers, or, where the fullest CTA holds more
than 4 x 32 slices, any number of them one after another (``rounds`` 0)
with r0 and d in the plan's ``state`` vector, on the device path, so no
operator is too large.  On the ``shared`` path each CTA copies its slices' values and
columns into shared memory once per launch; where the fullest CTA's
slots do not fit the card's shared memory, the ``device`` path reads
them from device memory (``plan(op, path=...)`` forces either).  Stages
are parted by
neighbour barriers: before a stage a CTA waits only for its neighbours
(``neighbours``: the CTAs whose rows its slots gather, and those that
gather its rows) to have finished the stage before.  The plan holds their
lists and one progress word per CTA, which count on from launch to
launch, so a solver's sweeps, run one after another on a stream, share
them.

Dispatch: CPU tensors take the plain versions (the product through
``kernels/sell_spmv``, whose plain version runs on the CPU); CUDA tensors
launch the kernel or raise, through csrc/vcycle.cu's typed entry for the
sweep and dtype (``nst_vcycle_<pre|mid|post>_<f32|f64>``), handed exactly
the arguments it takes.  ``COUNTS`` records the launches per sweep (under
capture through the graph's record, ``kernels/launches.py``) and the
plain stages' calls on CUDA tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from navierstokes_tpu_torch.kernels.launches import count
from navierstokes_tpu_torch.kernels.sell_spmv import sell_spmv
from navierstokes_tpu_torch.ops.sell import C, _lane_slots

SWEEPS = ("pre", "mid", "post")
# kernels a V-cycle launches per cycle besides its sweeps: the
# restriction's sum (one reduction) and the coarse correction sc_inv @
# (one cuBLAS GEMV; measured on the H100 at the bench and 3D-1Z sizes)
STOCK_PER_CYCLE = 2
ROUNDS = (1, 2, 4)    # slices a warp in registers: the kernel's variants
# besides rounds 0: any number of slices a warp, the state in device memory
WARPS = 32            # warps a CTA (csrc/vcycle.cu kThreads / 32)
PATHS = ("shared", "device")


@dataclasses.dataclass
class Counts:
    pre: int = 0
    mid: int = 0
    post: int = 0
    plain_cuda_calls: int = 0    # plain stages called on CUDA tensors

    def reset(self):
        for f in (*SWEEPS, "plain_cuda_calls"):
            setattr(self, f, 0)


COUNTS = Counts()


def _count(kind):
    setattr(COUNTS, kind, getattr(COUNTS, kind) + 1)


def launches(n_cycles: int, k: int) -> tuple[int, int]:
    """(sweep launches, kernels in all) of one V-cycle solve of
    ``n_cycles`` cycles with k smoothing iterations: a ``pre`` sweep,
    n_cycles - 1 ``mid`` and a ``post``, and the coarse correction's
    STOCK_PER_CYCLE kernels per cycle; k changes the stages inside a
    sweep, not the launches."""
    if n_cycles < 1 or k < 1:
        raise ValueError(f"launches: n_cycles {n_cycles} and k {k} must be "
                         "at least 1")
    sweeps = n_cycles + 1
    return sweeps, sweeps + n_cycles * STOCK_PER_CYCLE


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


def _smooth_plain(op, coef, sdinv, r, z, y, agg, k, zc0, zc1, out):
    """out = x + chebyshev(r - S x) for x = z (None: 0) or z + P y, as the
    stages' plain versions chain it; r0, d and z + P y in temporaries."""
    d, r0 = torch.empty_like(r), torch.empty_like(r)
    znew = torch.empty_like(r) if y is not None else None
    cheb_first_plain(op, coef, sdinv, r, z, d=d, zc=zc0, r0=r0, y=y,
                     agg=agg, znew=znew, out=out, last=k == 1)
    r0 = r if z is None else r0
    base = znew if y is not None else z
    zc = (zc0, zc1)
    for s in range(k - 1):
        cheb_step_plain(op, coef, s, sdinv, r0, d, zc[s % 2],
                        zc=zc[1 - s % 2], z=base, out=out, last=s == k - 2)


def sweep_plain(kind, op, coef, sdinv, r, *, k, zc0, zc1, z0, z1=None,
                rc=None, y=None, agg=0, out=None):
    """The sweep ``kind`` (see the module docstring) as its stages' plain
    versions."""
    if kind == "pre":
        _smooth_plain(op, coef, sdinv, r, None, None, agg, k, zc0, zc1, z0)
        residual_plain(op, r, z0, rc)
    elif kind == "mid":
        _smooth_plain(op, coef, sdinv, r, z0, y, agg, k, zc0, zc1, z1)
        _smooth_plain(op, coef, sdinv, r, z1, None, agg, k, zc0, zc1, z0)
        residual_plain(op, r, z0, rc)
    elif kind == "post":
        _smooth_plain(op, coef, sdinv, r, z0, y, agg, k, zc0, zc1, out)
    else:
        raise ValueError(f"vcycle: no sweep {kind!r} (one of {SWEEPS})")


@dataclasses.dataclass(frozen=True)
class SweepPlan:
    """How a sweep on one operator launches (``plan``)."""
    grid: int              # CTAs, every one resident
    rounds: int            # slices a warp in registers, or 0: any number
    path: str              # "shared" or "device" (the operator's home)
    smem: int              # dynamic shared-memory bytes a CTA (shared)
    per_sm: int            # CTAs an SM holds
    slices: int            # slices of the fullest CTA
    regs: int = 0          # registers a thread (the compiler's)
    local: int = 0         # local-memory bytes a thread (spills)
    neighbours: int = 0    # the most neighbours a CTA waits for
    # on the operator's device: (grid,) int32 progress words, zeros at
    # first; (grid + 1,) and (edges,) int32 neighbour lists (CSR); at
    # rounds 0, (2 n,) r0 and d of each row, interleaved
    flags: torch.Tensor | None = None
    state: torch.Tensor | None = None
    nb_ptr: torch.Tensor | None = None
    nb_idx: torch.Tensor | None = None


def layout(ptr, grid: int):
    """(slices, slots) of the fullest of ``grid`` CTAs, each taking the
    slices [b n / grid, (b + 1) n / grid) of the slice pointer ``ptr``
    ((n + 1,) int64), as csrc/vcycle.cu splits them."""
    n = len(ptr) - 1
    cut = (np.arange(grid + 1, dtype=np.int64) * n) // grid
    return (int((cut[1:] - cut[:-1]).max()),
            int((ptr[cut[1:]] - ptr[cut[:-1]]).max()))


def neighbours(ptr, rows, cols, grid: int):
    """(nb_ptr, nb_idx) int64: CTA b's neighbours nb_idx[nb_ptr[b] :
    nb_ptr[b + 1]], ascending, itself excluded: every CTA that owns the
    row of a column one of b's live slots holds (padding slots included:
    the kernel gathers them too), and every CTA one of whose slots holds a
    row of b.  ``ptr`` the slice pointer, ``rows`` each lane's row (-1
    for padding lanes), ``cols`` each slot's column, host arrays of the
    operator's SELL layout."""
    n = len(ptr) - 1
    cut = (np.arange(grid + 1, dtype=np.int64) * n) // grid
    slice_cta = np.repeat(np.arange(grid), np.diff(cut))
    lane_cta = np.repeat(slice_cta, C)
    live = rows >= 0
    row_cta = np.empty(int(rows.max()) + 1, np.int64)
    row_cta[rows[live]] = lane_cta[live]
    order, lane_w = _lane_slots(ptr)
    slot_lane = np.empty(len(order), np.int64)
    slot_lane[order] = np.repeat(np.arange(len(lane_w)), lane_w)
    used = live[slot_lane]
    a = lane_cta[slot_lane[used]]
    b = row_cta[cols[used]]
    pairs = np.unique(np.concatenate([a * grid + b, b * grid + a]))
    pairs = pairs[pairs // grid != pairs % grid]
    nb_ptr = np.zeros(grid + 1, np.int64)
    np.cumsum(np.bincount(pairs // grid, minlength=grid), out=nb_ptr[1:])
    return nb_ptr, pairs % grid


def smem_bytes(slots: int, itemsize: int) -> int:
    """A CTA's dynamic shared memory on the shared path: the bulk copies'
    mbarrier (16 bytes), then the values and the int32 columns."""
    return 16 + slots * (itemsize + 4)


def choose(ptr, itemsize: int, query, path=None) -> SweepPlan:
    """The plan of a sweep on the slice pointer ``ptr`` with values of
    ``itemsize`` bytes: the shared path if the fullest CTA's operator fits
    (``path`` None) or as told, at 2 CTAs an SM or else 1, the fewest
    register rounds that cover the fullest CTA, or rounds 0 (any number;
    the device path only) past the last.  ``query(rounds, shared, smem)`` returns the card's
    dict (``per_sm``, ``sms``, ``optin``, ``regs``, ``local``) for the
    kernels of that shape."""
    n = len(ptr) - 1
    if n < 1:
        raise ValueError("vcycle: an operator with no slice")
    if path is not None and path not in PATHS:
        raise ValueError(f"vcycle: no path {path!r} (one of {PATHS})")
    card = query(ROUNDS[0], False, 0)
    for p in PATHS if path is None else (path,):
        for per_sm in (2, 1):
            grid = min(per_sm * card["sms"], n)
            slices, slots = layout(ptr, grid)
            rounds = next((r for r in ROUNDS if slices <= WARPS * r), 0)
            smem = smem_bytes(slots, itemsize) if p == "shared" else 0
            if smem > card["optin"] or (rounds == 0 and p == "shared"):
                continue
            got = query(rounds, p == "shared", smem)
            if got["per_sm"] >= per_sm:
                return SweepPlan(grid=grid, rounds=rounds, path=p,
                                 smem=smem, per_sm=per_sm, slices=slices,
                                 regs=got["regs"], local=got["local"])
    raise ValueError(
        f"vcycle: no sweep plan for {n} slices on the {path or 'any'} path "
        f"({card['optin']} bytes of shared memory)")


def _query(device, dtype, rounds, shared, smem):
    """The library's ``nst_vcycle_setup_<f32|f64>`` on ``device``."""
    import ctypes

    from navierstokes_tpu_torch.kernels.build import library
    lib = library()
    info = (ctypes.c_int * 6)()
    fn = getattr(lib, "nst_vcycle_setup_"
                 + ("f32" if dtype == torch.float32 else "f64"))
    with torch.cuda.device(device):
        rc = fn(rounds, int(shared), smem, info)
    if rc != 0:
        raise RuntimeError(f"vcycle setup failed ({rc}): "
                           f"{lib.nst_cuda_error_string(rc).decode()}")
    if info[3] != WARPS * 32:
        raise RuntimeError(f"vcycle: the kernel's CTA has {info[3]} threads, "
                           f"the plan assumes {WARPS * 32}")
    return dict(zip(("per_sm", "sms", "optin", "threads", "regs", "local"),
                    info))


def _operator(op):
    if op.vals.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"vcycle: the operator must be float32 or float64 "
                        f"on CUDA (got {op.vals.dtype}); the kernel has no "
                        "other variant")
    return op.mat.slice_ptr.cpu().numpy().astype(np.int64)


def card_query(op):
    """``choose``'s query on the card that holds ``op`` (a P1Matrix on a
    CUDA device), for its dtype."""
    _operator(op)
    return lambda *a: _query(op.vals.device, op.vals.dtype, *a)


def attach(op, chosen: SweepPlan) -> SweepPlan:
    """``chosen`` (``choose``'s plan for ``op``) with what its launches
    need on the operator's device: the neighbour lists, the progress
    words (zeros) and, at rounds 0, the state vector."""
    ptr = _operator(op)
    dev = op.vals.device
    nb_ptr, nb_idx = neighbours(ptr, op.mat.rows.cpu().numpy().astype(
        np.int64), op.mat.cols.cpu().numpy().astype(np.int64), chosen.grid)
    i32 = lambda a: torch.as_tensor(a, dtype=torch.int32, device=dev)
    state = (torch.zeros(2 * op.n, dtype=op.vals.dtype, device=dev)
             if chosen.rounds == 0 else None)
    return dataclasses.replace(
        chosen, neighbours=int(np.diff(nb_ptr).max()), nb_ptr=i32(nb_ptr),
        nb_idx=i32(nb_idx),
        flags=torch.zeros(chosen.grid, dtype=torch.int32, device=dev),
        state=state)


def plan(op, path=None) -> SweepPlan:
    """The sweep's plan on ``op`` (a P1Matrix on a CUDA device; its SELL
    arrays read to the host once), on the path ``choose`` picks or
    ``path``, with its device tensors (``attach``).  Make it outside any
    capture."""
    return attach(op, choose(_operator(op), op.vals.element_size(),
                             card_query(op), path))


# the vectors each sweep takes (its C entry's order), and those it writes
ENTRIES = {
    "pre": ("coef", "sdinv", "r", "k", "zc0", "zc1", "z0", "rc"),
    "mid": ("coef", "sdinv", "r", "y", "agg", "k", "zc0", "zc1", "z0", "z1",
            "rc"),
    "post": ("coef", "sdinv", "r", "y", "agg", "k", "zc0", "zc1", "z0",
             "out"),
}
WRITES = {"pre": ("zc0", "zc1", "z0", "rc"),
          "mid": ("zc0", "zc1", "z0", "z1", "rc"),
          "post": ("zc0", "zc1", "out")}


def _check(kind, op, vectors):
    """Refuses, before any launch, what the kernel cannot take: an operator
    not float32 or float64 or not square, a vector missing (None) or of
    another dtype or device than the operator's values, not contiguous,
    or (but ``coef`` and ``y``) not of the operator's rows, and a written
    vector that shares memory with another."""
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
            raise ValueError(f"vcycle: the {kind} sweep needs {name}")
        if v.dtype != vals.dtype:
            raise TypeError(f"vcycle: {kind}'s {name} must be {vals.dtype} "
                            f"(got {v.dtype})")
        if v.device != vals.device:
            raise ValueError(f"vcycle: {kind}'s {name} on {v.device}, the "
                             f"operator on {vals.device}")
        if not v.is_contiguous():
            raise ValueError(f"vcycle: {kind}'s {name} must be contiguous")
        if name not in ("coef", "y") and tuple(v.shape) != (n,):
            raise ValueError(f"vcycle: {kind}'s {name} must be of shape "
                             f"({n},) (got {tuple(v.shape)})")
    span = lambda v: (v.data_ptr(), v.data_ptr() + v.numel()
                      * v.element_size())
    for name in WRITES[kind]:
        a0, a1 = span(vectors[name])
        for other, v in vectors.items():
            b0, b1 = span(v)
            if other != name and a0 < b1 and b0 < a1:
                raise ValueError(f"vcycle: {kind}'s {name} shares memory "
                                 f"with {other}")


def _call_kernel(kind, op, sweep_plan, *args):
    """The library's ``nst_vcycle_<kind>_<f32|f64>`` (csrc/vcycle.cu) on
    the plan's launch shape, the operator's SELL arrays, ``args`` in the
    entry's order (a tensor by its pointer, an int as it is) and the plan's
    progress words and neighbour lists, on the current stream of the
    operator's device; raises if the launch fails."""
    from navierstokes_tpu_torch.kernels.build import library
    vals, mat = op.vals, op.mat
    if sweep_plan is None or sweep_plan.flags is None:
        raise ValueError("vcycle: a sweep on the card needs its plan "
                         "(vcycle.plan(op))")
    if (sweep_plan.state is None) == (sweep_plan.rounds == 0) or (
            sweep_plan.state is not None
            and sweep_plan.state.numel() < 2 * op.n):
        raise ValueError("vcycle: a plan of rounds 0 needs its state vector "
                         "of 2 n, and only it (vcycle.attach)")
    if sweep_plan.flags.device != vals.device:
        raise ValueError(f"vcycle: the plan's words on "
                         f"{sweep_plan.flags.device}, the operator on "
                         f"{vals.device}")
    for name, v in (("vals", vals), ("cols", mat.cols)):
        if v.data_ptr() % 16:
            raise ValueError(f"vcycle: the operator's {name} must be 16-byte "
                             "aligned (the row loop's vector loads and the "
                             "bulk copies)")
    lib = library()
    suffix = "f32" if vals.dtype == torch.float32 else "f64"
    fn = getattr(lib, f"nst_vcycle_{kind}_{suffix}")
    ptr = lambda a: a.data_ptr() if torch.is_tensor(a) else a
    p = sweep_plan
    dev = vals.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(p.grid, p.rounds, int(p.path == "shared"), p.smem,
                vals.data_ptr(), mat.cols.data_ptr(), mat.slice_ptr.data_ptr(),
                mat.rows.data_ptr(), mat.slice_ptr.shape[0] - 1,
                *map(ptr, args),
                0 if p.state is None else p.state.data_ptr(),
                p.flags.data_ptr(), p.nb_ptr.data_ptr(), p.nb_idx.data_ptr(),
                stream)
    if rc != 0:
        raise RuntimeError(f"vcycle ({kind}) launch failed ({rc}): "
                           f"{lib.nst_cuda_error_string(rc).decode()}")


def _device(r):
    if r.device.type == "cpu":
        return False
    if r.device.type != "cuda":
        raise ValueError(f"vcycle: unsupported device {r.device}")
    return True


def sweep(kind, op, sweep_plan, coef, sdinv, r, *, k, zc0, zc1, z0,
          z1=None, rc=None, y=None, agg=0, out=None):
    """The sweep ``kind`` (see the module docstring) with ``k`` smoothing
    iterations, on ``sweep_plan`` (``plan(op)``; None on the CPU).  CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    given = dict(coef=coef, sdinv=sdinv, r=r, zc0=zc0, zc1=zc1, z0=z0,
                 z1=z1, rc=rc, y=y, out=out)
    if kind not in SWEEPS:
        raise ValueError(f"vcycle: no sweep {kind!r} (one of {SWEEPS})")
    if not _device(r):
        sweep_plain(kind, op, coef, sdinv, r, k=k, agg=agg,
                    **{n: v for n, v in given.items()
                       if n not in ("coef", "sdinv", "r")})
        return
    names = [n for n in ENTRIES[kind] if n not in ("k", "agg")]
    extra = [n for n, v in given.items() if v is not None and n not in names]
    if extra:
        raise ValueError(f"vcycle: the {kind} sweep takes no {extra}")
    vectors = {n: given[n] for n in names}
    _check(kind, op, vectors)
    if not 1 <= k <= (coef.numel() + 1) // 2:
        raise ValueError(f"vcycle: {coef.numel()} coefficients do not "
                         f"serve k = {k}")
    if y is not None and (agg < 1 or y.numel() * agg < op.n):
        raise ValueError(f"vcycle: {y.numel()} aggregates of {agg} rows "
                         f"do not cover {op.n} rows")
    args = dict(vectors, k=k, agg=agg)
    _call_kernel(kind, op, sweep_plan, *(args[n] for n in ENTRIES[kind]))
    count(_count, kind)


# the buffers a sweep may write
BUFFERS = ("zc0", "zc1", "z0", "z1", "rc", "out")


def example(op, rng, k: int = 3, agg: int = 64):
    """Seeded inputs of every sweep on ``op`` (its device and dtype):
    standard normal vectors of n (``r`` and the BUFFERS' prior contents;
    z0 is the mid and post sweeps' input), ``y`` of the ceil(n / agg)
    aggregates, sdinv from op.diag as the V-cycle makes it, and the
    coefficients of k iterations for a lambda_max drawn from [1.8, 2.2];
    ``rng`` a numpy Generator."""
    n, dt, dev = op.n, op.vals.dtype, op.vals.device
    vec = lambda m: torch.as_tensor(rng.standard_normal(m), dtype=dt).to(dev)
    lam = torch.tensor(rng.uniform(1.8, 2.2), dtype=dt, device=dev)
    ex = {name: vec(n) for name in ("r",) + BUFFERS}
    ex.update(y=vec(-(-n // agg)), agg=agg, k=k, coef=coefficients(lam, k),
              sdinv=torch.where(op.diag != 0, 1.0 / op.diag,
                                torch.ones_like(op.diag)))
    return ex


def run_case(kind, op, ex, sweep_plan=None, plain=False, into=None, r=None):
    """The sweep ``kind`` on ``ex`` (``example``) and ``sweep_plan``,
    launched (``plain``: its plain version); ``r`` replaces ex's right-hand
    side (a view at an odd offset, say).  Returns copies of the BUFFERS as
    the call left them (``into``: writes those of ``into`` instead, and
    returns it)."""
    b = into if into is not None else {name: ex[name].clone()
                                       for name in BUFFERS}
    kw = dict(k=ex["k"], zc0=b["zc0"], zc1=b["zc1"], z0=b["z0"])
    if kind == "pre":
        kw.update(rc=b["rc"])
    elif kind == "mid":
        kw.update(y=ex["y"], agg=ex["agg"], z1=b["z1"], rc=b["rc"])
    else:
        kw.update(y=ex["y"], agg=ex["agg"], out=b["out"])
    r = ex["r"] if r is None else r
    if plain:
        sweep_plain(kind, op, ex["coef"], ex["sdinv"], r, **kw)
    else:
        sweep(kind, op, sweep_plan, ex["coef"], ex["sdinv"], r, **kw)
    return b
