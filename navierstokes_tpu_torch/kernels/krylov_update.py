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
* ``cg_xr``: pap = p.Ap, alpha = rz / clamp(pap, 1e-30), x += alpha p,
  r -= alpha Ap, and rnorm = ||r|| of the new r (the loop's predicate
  reads it: no norm of its own);
* ``cg_p``: rz_new = r.z, beta = rz_new / clamp(rz, 1e-30),
  p = z + beta p, rz = rz_new, k += 1.

The CG stages take their dots themselves (``dot`` and ``norm``: each
product in float64, summed in float64, rounded once to the vectors'
dtype; in float64 the plain versions keep the bits of the loop's dot and
norm before the fused stages), so a CG iteration launches the product,
``cg_xr``, the preconditioner, ``cg_p`` and the predicate, and nothing
else.

Each writes the loop's state in place and only while the 0-d flag
``active`` is up, so an iteration run after the stop (krylov ``MASKED``)
leaves every state buffer bit-identical; the scalars (0-d tensors) are
read on the device, so no scalar operation is a launch of its own and no
launch argument varies between iterations (one captured while body serves
every iteration).  The plain versions are the loop bodies' torch
operations, committed under ``torch.where(active, new, old)``; the
kernels round each product, sum and quotient on its own in torch's order,
so the BiCGStab stages agree bit for bit in float32 and float64.  The CG
stages' float64 sums run in another order on the card (one thread-block
cluster, fixed and without atomics: csrc/krylov_update.cu) than in torch:
in float32 a dot or the norm is equal or one ulp apart, and where it is
equal every vector equals the plain one bit for bit; in float64 each is
within ``DOT_GATE`` of the sum of |a_i b_i|.  ``cg_gate`` holds a card's
result to its plain version by these rules.  ``cg_xr`` commits its dot as
``pap``, which no later operation of the loop reads: it is the stage's
observable dot for the checks.

They replace no Pallas kernel: XLA fuses the JAX package's loop bodies
(navierstokes_tpu/solvers/krylov.py:204-224, :258-268), which eager
PyTorch runs as about 50 (BiCGStab) and 19 (CG) launches per iteration.

On the card every BiCGStab stage runs one element loop, and every CG stage
one cluster's two passes, on one of three paths,
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
import math

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


def dot(a, b):
    """sum a_i b_i in float64 (the products exact for float32 data),
    rounded once to a's dtype (0-d, on a's device).  ``torch.dot`` on the
    float64 vectors: for float64 data the loop's dot before the fused
    stages, bit for bit."""
    return torch.dot(a.double(), b.double()).to(a.dtype)


def norm(v):
    """||v||: sqrt of the float64 sum of squares, rounded once to v's
    dtype (0-d, on v's device); for float64 data ``torch.linalg.norm``'s
    bits, the loop's predicate before the fused stages."""
    return torch.linalg.vector_norm(v.double()).to(v.dtype)


def cg_xr_plain(x, r, p, ap, rz, pap, rnorm, active):
    d = dot(p, ap)
    alpha = rz / torch.clamp(d, min=1e-30)
    r_new = r - alpha * ap
    commit(active, ((x, x + alpha * p), (r, r_new), (pap, d),
                    (rnorm, norm(r_new))))


def cg_p_plain(p, z, r, rz, k, active):
    rz_new = dot(r, z)
    beta = rz_new / torch.clamp(rz, min=1e-30)
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
SCRATCH = {"bicgstab_s": ("s",)}
# the scalars a converging loop only ever has positive
POSITIVE = frozenset(("tt", "pap", "rz", "rnorm"))
# the CG stages' dots and norm against the plain version's, float64: within
# DOT_GATE of the sum of |a_i b_i|.  The two sum in different orders (a
# tree over the cluster's threads, BLAS's order); 1e-13 lies far above the
# last-bit gaps of such sums and far below the (m - 1) 2^-53 = 1.3e-11
# that bounds any order of the m = 113,378 terms of the bench point
DOT_GATE = 1e-13


def _want(name, dtype, n):
    """The dtype and shape of the tensor ``name`` of a stage on n
    elements of ``dtype``."""
    if name in VECTORS:
        return dtype, (n,)
    if name in FLAGS:
        return torch.bool, ()
    return (torch.int64 if name == "k" else dtype), ()


# the CG stages' dot: (its first input, the input made from it, the
# factor range of rz over the dot's value)
CG_DOTS = {"cg_xr": ("p", "ap", (0.3, 0.9)), "cg_p": ("r", "z", (1.2, 2.5))}


def ulp(t):
    """The spacing of floats above |t| in t's dtype, element by element."""
    a = t.abs()
    return torch.nextafter(a, torch.full_like(a, math.inf)) - a


def cg_gate(stage, kern, plain, before):
    """A CG stage's result ``kern`` (the kernel's) against its plain
    version's ``plain`` from the same inputs ``before``, each a list in
    ``ARGS`` order.  The dot (cg_xr's pap, cg_p's rz) within one ulp of the
    plain one in float32, within ``DOT_GATE`` of the sum of |a_i b_i| in
    float64.  Where the dots are equal, x, r and p equal the plain ones
    bit for bit; where not, the stage's factor s (alpha = rz / clamp(pap),
    beta = rz_new / clamp(rz)) moves by ds, and each element of a vector
    it updates (x += alpha p, r -= alpha Ap; p = z + beta p) lies within
    |ds| |w| + ulp(s w) + ulp(v) of the plain one, w being the vector s
    multiplies (one rounding of the product and one of the sum on each
    side).  rnorm within one ulp (float32) or ``DOT_GATE`` of itself
    (float64) of ``norm`` of the kernel's own r.  Every other tensor, and
    everything with the flag down, equal bit for bit.  Returns (passed,
    dot and rnorm bit-equal to the plain ones, max |kernel - plain| over
    the stage's outputs)."""
    names = ARGS[stage]
    K, P, B = (dict(zip(names, v)) for v in (kern, plain, before))
    first, second, _ = CG_DOTS[stage]
    if stage == "cg_xr":
        d, updates = "pap", (("x", "p"), ("r", "ap"))
        factor = lambda dot: B["rz"] / torch.clamp(dot, min=1e-30)
    else:
        d, updates = "rz", (("p", "p"),)
        factor = lambda dot: dot / torch.clamp(B["rz"], min=1e-30)
    outputs = (d, *(v for v, _ in updates)) + (
        ("rnorm",) if stage == "cg_xr" else ())
    err = max(float((K[v].double() - P[v].double()).abs().max())
              for v in outputs)
    same = [torch.equal(K[v], P[v]) for v in names if v not in outputs]
    if not bool(B["active"]):
        return all(torch.equal(K[v], P[v]) for v in names), True, err
    f32 = K[d].dtype == torch.float32
    gap = abs(float(K[d]) - float(P[d]))
    ok = all(same) and (gap <= float(ulp(P[d])) if f32 else gap <= DOT_GATE
                        * float((B[first].double() * B[second].double())
                                .abs().sum()))
    equal = torch.equal(K[d], P[d])
    s_k, s_p = factor(K[d]), factor(P[d])
    for v, w in updates:
        if equal:
            ok = ok and torch.equal(K[v], P[v])
            continue
        prod = torch.maximum((s_k * B[w]).abs(), (s_p * B[w]).abs())
        tol = ((s_k.double() - s_p.double()).abs() * B[w].double().abs()
               + ulp(prod).double()
               + ulp(torch.maximum(K[v].abs(), P[v].abs())).double())
        ok = ok and bool(((K[v].double() - P[v].double()).abs()
                          <= tol).all())
    if stage == "cg_xr":
        want = norm(K["r"])
        miss = abs(float(K["rnorm"]) - float(want))
        ok = ok and (miss <= float(ulp(want)) if f32
                     else miss <= DOT_GATE * float(want))
        equal = equal and torch.equal(K["rnorm"], P["rnorm"])
    return ok, equal, err


def example(stage, n, dtype, device, rng, *, active=True, scalars=None,
            offset=0, signed=False):
    """A stage's tensors for checks and timings: standard normal vectors
    of n from ``rng`` (a numpy Generator), each a view ``offset`` elements
    into its storage (the pressure part of a flat (u, p) vector sits off a
    16-byte boundary); eps 1e-30, the breakdown flag down, k = 3, the flag
    ``active``; every other scalar ``scalars[name]`` where given, else
    drawn from [0.3, 0.9] with a random sign (positive in ``POSITIVE``),
    so that no product of a scalar and an element is exact.  For a CG
    stage the dot's second vector is its first times factors drawn from
    [0.5, 2] (Ap of an SPD operator, z of an SPD preconditioner: the dot
    is positive), or with ``signed`` from [-1, 2] (products of both signs,
    as in a preconditioned r.z; the second vector negated if the dot is
    not positive), and rz, unless given, the dot's value times a factor
    drawn from ``CG_DOTS`` (alpha in [0.3, 0.9], beta in (0.4, 0.84), as
    in a converging loop, so repeated calls stay bounded)."""
    vals = {}
    for name in ARGS[stage]:
        dt, shape = _want(name, dtype, n)
        if shape:
            vals[name] = rng.standard_normal(n + offset)
        elif name == "active":
            vals[name] = active
        elif name == "stag":
            vals[name] = False
        elif name == "k":
            vals[name] = 3
        elif name == "eps":
            vals[name] = 1e-30
        elif scalars is not None and name in scalars:
            vals[name] = scalars[name]
        else:
            value = rng.uniform(0.3, 0.9)
            if name not in POSITIVE and rng.integers(2):
                value = -value
            vals[name] = value
    if stage in CG_DOTS:
        first, second, (lo, hi) = CG_DOTS[stage]
        vals[second] = vals[first] * rng.uniform(-1.0 if signed else 0.5,
                                                 2.0, n + offset)
        t = lambda v: torch.as_tensor(v[offset:], dtype=dtype)
        if float(dot(t(vals[first]), t(vals[second]))) <= 0:
            vals[second] = -vals[second]
        if scalars is None or "rz" not in scalars:
            vals["rz"] = float(dot(t(vals[first]), t(vals[second]))
                               ) * rng.uniform(lo, hi)
    out = []
    for name in ARGS[stage]:
        dt, shape = _want(name, dtype, n)
        if shape:
            t = torch.as_tensor(vals[name], dtype=dt)
            out.append(t.to(device)[offset:])
        else:
            out.append(torch.tensor(vals[name], dtype=dt, device=device))
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


def cluster() -> int:
    """The CTAs of a CG stage's one thread-block cluster, as the library
    was built (csrc/krylov_update.cu ``kCluster``); builds or loads it."""
    from navierstokes_tpu_torch.kernels.build import library
    return library().nst_krylov_cg_cluster()


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
