"""BiCGStab's and CG's vector updates on the device: the hand-written
CUDA kernels (csrc/krylov_update.cu), one launch per update stage, and
their plain PyTorch versions.

The stages of one iteration (solvers/krylov.py ``BicgstabLoop._iteration``
and ``CgLoop._iteration``), between the products and dots that stay
where they are:

* ``bicgstab_p``: beta = (rho_new / g(rho)) (alpha / g(omega)),
  p = r + beta (p - omega v), with g(a) = a where |a| > eps, else eps;
* ``bicgstab_s``: alpha = rho_new / g(denom), s = r - alpha v into the
  scratch ``s``, and the product's output v into the loop's ``v``;
* ``bicgstab_xr``: alpha again, omega = ts / (tt where tt > eps, else
  eps), x = (x + alpha phat) + omega shat, r = s - omega t, rho = rho_new,
  the committed alpha and omega, stag = |rho_new| <= eps or
  |denom| <= eps, k += 1;
* ``cg_xr``: alpha = rz / clamp(pAp, 1e-30), x += alpha p, r -= alpha Ap,
  and rz kept in the scratch ``rz_prev``;
* ``cg_p``: beta = rz_new / clamp(rz_prev, 1e-30), p = z + beta p,
  rz = rz_new, k += 1.

Each writes the loop's state in place and only while the 0-d flag
``active`` is up, so an iteration run after the stop (krylov ``MASKED``)
leaves every state buffer bit-identical; the scalars (0-d tensors) are
read on the device, so no scalar operation is a launch of its own and no
launch argument varies between iterations (one captured while body serves
every iteration).  The plain versions are the loop bodies' torch
operations, committed under ``torch.where(active, new, old)``; the
kernels round each product, sum and quotient on its own in torch's order,
so the two agree bit for bit in float32 and float64.

They replace no Pallas kernel: XLA fuses the JAX package's loop bodies
(navierstokes_tpu/solvers/krylov.py:204-224, :258-268), which eager
PyTorch runs as about 50 (BiCGStab) and 19 (CG) launches per iteration.

On the card every stage runs one element loop on one of three paths,
which ``path`` picks from the vectors' addresses alone: ``vector`` (all
on 16-byte boundaries: 16-byte loads and stores), ``peeled`` (all the
same bytes off one: a scalar head up to it, then as ``vector``) or
``scalar`` (one element per thread); the tail of n is scalar in the same
launch, and every path rounds each element alike.

Dispatch: CPU tensors take the plain versions; CUDA tensors launch the
kernel or raise.  ``COUNTS`` records the launches per stage, ``PATHS``
per (stage, path) (both under capture through the graph's record,
``kernels/launches.py``; ``COUNTS.reset()`` clears both).
"""

from __future__ import annotations

import ctypes
import dataclasses
import inspect

import torch

from navierstokes_tpu_torch.kernels.launches import count

# stage -> its index in csrc/krylov_update.cu
STAGES = ("bicgstab_p", "bicgstab_s", "bicgstab_xr", "cg_xr", "cg_p")


# the element loop's paths, by their index in csrc/krylov_update.cu
PATH_NAMES = ("scalar", "vector", "peeled")
# launches per (stage, path), cleared with COUNTS
PATHS: dict = {}


@dataclasses.dataclass
class Counts:
    bicgstab_p: int = 0
    bicgstab_s: int = 0
    bicgstab_xr: int = 0
    cg_xr: int = 0
    cg_p: int = 0

    def reset(self):
        for f in STAGES:
            setattr(self, f, 0)
        PATHS.clear()


COUNTS = Counts()


def _count(stage, path):
    setattr(COUNTS, stage, getattr(COUNTS, stage) + 1)
    PATHS[stage, path] = PATHS.get((stage, path), 0) + 1


def path(addresses):
    """The path of a launch whose vectors start at ``addresses`` (bytes):
    ``vector`` when every one is on a 16-byte boundary, ``peeled`` when
    all sit the same bytes off one (the kernel peels a scalar head up to
    it), else ``scalar``."""
    offsets = {a % 16 for a in addresses}
    if offsets == {0}:
        return "vector"
    return "peeled" if len(offsets) == 1 else "scalar"


def commit(active, pairs):
    """state <- where(active, new, state) for each (state, new), in
    place."""
    for old, new in pairs:
        old.copy_(torch.where(active, new, old))


def _guard(a, eps):
    return torch.where(a.abs() > eps, a, eps)


def bicgstab_p_plain(p, r, v, rho_new, rho, alpha, omega, eps, active):
    beta = (rho_new / _guard(rho, eps)) * (alpha / _guard(omega, eps))
    commit(active, ((p, r + beta * (p - omega * v)),))


def bicgstab_s_plain(s, v_state, r, v, rho_new, denom, eps, active):
    alpha = rho_new / _guard(denom, eps)
    s.copy_(r - alpha * v)
    commit(active, ((v_state, v),))


def bicgstab_xr_plain(x, r, phat, shat, s, t, rho_new, denom, ts, tt, eps,
                      rho, alpha_state, omega_state, stag, k, active):
    alpha = rho_new / _guard(denom, eps)
    omega = ts / torch.where(tt > eps, tt, eps)
    x_new = x + alpha * phat + omega * shat
    r_new = s - omega * t
    stag_new = (rho_new.abs() <= eps) | (denom.abs() <= eps)
    commit(active, ((x, x_new), (r, r_new), (rho, rho_new),
                    (alpha_state, alpha), (omega_state, omega),
                    (stag, stag_new)))
    k.add_(active)


def cg_xr_plain(x, r, p, ap, rz, pap, rz_prev, active):
    rz_prev.copy_(rz)
    alpha = rz / torch.clamp(pap, min=1e-30)
    commit(active, ((x, x + alpha * p), (r, r - alpha * ap)))


def cg_p_plain(p, z, rz_new, rz_prev, rz, k, active):
    beta = rz_new / torch.clamp(rz_prev, min=1e-30)
    commit(active, ((p, z + beta * p), (rz, rz_new)))
    k.add_(active)


PLAIN = {"bicgstab_p": bicgstab_p_plain, "bicgstab_s": bicgstab_s_plain,
         "bicgstab_xr": bicgstab_xr_plain, "cg_xr": cg_xr_plain,
         "cg_p": cg_p_plain}

# each stage's tensors by name, in the kernel's order (the pointer lists
# of csrc/krylov_update.cu): the plain version's parameters
ARGS = {stage: tuple(inspect.signature(fn).parameters)
        for stage, fn in PLAIN.items()}
# the vectors of n elements; every other name is a 0-d scalar of the
# loop's dtype, but the flags (bool) and the count k (int64)
VECTORS = frozenset(("p", "r", "v", "s", "v_state", "x", "phat", "shat",
                     "t", "z", "ap"))
FLAGS = frozenset(("stag", "active"))
# the scratch a stage writes whatever the flag (read only later in the
# same iteration)
SCRATCH = {"bicgstab_s": ("s",), "cg_xr": ("rz_prev",)}
# the scalars a converging loop only ever has positive
POSITIVE = frozenset(("tt", "pap", "rz", "rz_new", "rz_prev"))


def _want(name, dtype, n):
    """The dtype and shape of the tensor ``name`` of a stage on n
    elements of ``dtype``."""
    if name in VECTORS:
        return dtype, (n,)
    if name in FLAGS:
        return torch.bool, ()
    return (torch.int64 if name == "k" else dtype), ()


def example(stage, n, dtype, device, rng, *, active=True, scalars=None,
            offset=0):
    """A stage's tensors for checks and timings: standard normal vectors
    of n from ``rng`` (a numpy Generator), each a view ``offset`` elements
    into its storage (the pressure part of a flat (u, p) vector sits off a
    16-byte boundary); eps 1e-30, the breakdown flag down, k = 3, the flag
    ``active``; every other scalar ``scalars[name]`` where given, else
    drawn from [0.3, 0.9] with a random sign (positive in ``POSITIVE``),
    so that no product of a scalar and an element is exact."""
    out = []
    for name in ARGS[stage]:
        dt, shape = _want(name, dtype, n)
        if shape:
            t = torch.as_tensor(rng.standard_normal(n + offset), dtype=dt)
            out.append(t.to(device)[offset:])
            continue
        if name == "active":
            value = active
        elif name == "stag":
            value = False
        elif name == "k":
            value = 3
        elif name == "eps":
            value = 1e-30
        elif scalars is not None and name in scalars:
            value = scalars[name]
        else:
            value = rng.uniform(0.3, 0.9)
            if name not in POSITIVE and rng.integers(2):
                value = -value
        out.append(torch.tensor(value, dtype=dt, device=device))
    return out


def _entry(dtype, device):
    """The library's entry for ``dtype`` on ``device`` (a CUDA device):
    builds or loads the library, or raises."""
    if device.type != "cuda":
        raise ValueError(f"krylov_update: unsupported device {device}")
    suffix = {torch.float32: "f32", torch.float64: "f64"}.get(dtype)
    if suffix is None:
        raise TypeError(f"krylov_update: the vectors must be float32 or "
                        f"float64 on CUDA (got {dtype}); the kernel has no "
                        "other variant")
    from navierstokes_tpu_torch.kernels.build import library
    lib = library()
    return lib, getattr(lib, f"nst_krylov_update_{suffix}")


def update(stage: str, *args):
    """One update stage (see the module docstring) on its tensors, in
    place.  CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise."""
    head = args[0]
    if head.device.type == "cpu":
        PLAIN[stage](*args)
        return
    names = ARGS[stage]
    if len(args) != len(names):
        raise TypeError(f"krylov_update: {stage} takes {len(names)} "
                        f"tensors (got {len(args)})")
    dev, dt, n = head.device, head.dtype, head.numel()
    lib, fn = _entry(dt, dev)
    for name, t in zip(names, args):
        dtype, shape = _want(name, dt, n)
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"krylov_update: {stage}'s {name} must be "
                             f"{dtype} of shape {shape} (got {t.dtype} "
                             f"{tuple(t.shape)})")
        if t.device != dev:
            raise ValueError(f"krylov_update: {stage}'s {name} on "
                             f"{t.device}, the first on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"krylov_update: {stage}'s {name} must be "
                             "contiguous")
    ptrs = (ctypes.c_void_p * len(args))(*[t.data_ptr() for t in args])
    way = path([t.data_ptr() for name, t in zip(names, args)
                if name in VECTORS])
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(STAGES.index(stage), ptrs, n, PATH_NAMES.index(way), stream)
    if rc != 0:
        msg = ("unknown stage or path" if rc < 0
               else lib.nst_cuda_error_string(rc).decode())
        raise RuntimeError(f"krylov_update ({stage}) launch failed ({rc}): "
                           f"{msg}")
    count(_count, stage, way)
