"""The Gram-Schmidt kernels (csrc/gram_schmidt.cu) against a parent
revision's on the card, at the shapes of ``chip_smoke.py`` phase 26.

Builds the parent's ``navierstokes_tpu_torch/csrc/gram_schmidt.cu`` (the
file given with ``--parent-source``; ``git show REV:...`` writes it) alone
with ``kernels/build.NVCC_FLAGS`` into ``build/gram_schmidt_ab/``.  On the
flat bench vector (n = 1,014,414, restart m = 64, an orthonormal basis in
rows 0..j and a seeded w with a part in their span), for each dtype and j
in JS, it runs the parent's step on a contiguous (m + 1, n) basis (the
layout the parent's solver allocated) and the package's
(``kernels/gram_schmidt.gram_schmidt``) on the padded basis of
``kernels/gram_schmidt.basis`` (rows 128-byte aligned, the layout
``GmresLoop`` allocates) in ROUNDS rounds of alternating bursts
(``chip_smoke._burst_ms``, REPS bursts after one warm-up call, the order
reversed every other round), each call finding its data outside the L2
(copies that exceed twice the L2 are cycled through).  It prints each
one's median ms, its rounds and the bytes a step reads and writes once,
with the card's name and power limit; checks that the parent's and the
package's h1, h2, ||w||, V and Z are equal bit for bit, and exits 1 if any
differ.

``--split`` adds, at each j in SPLIT_JS, each launch's device time by
kernel (``torch.profiler``, L2-cold calls as above) and the launches per
call, for the parent and the package.  Imports no JAX.

    git show HEAD~1:navierstokes_tpu_torch/csrc/gram_schmidt.cu \\
        > build/gs_parent.cu
    python3 tools/gram_schmidt_ab.py --parent-source build/gs_parent.cu \\
        [--split] [--json PATH]
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as CS  # noqa: E402
from navierstokes_tpu_torch.kernels import build as KB  # noqa: E402
from navierstokes_tpu_torch.kernels import gram_schmidt as GS  # noqa: E402

OUT = os.path.join(ROOT, "build", "gram_schmidt_ab")
ROUNDS = 6
REPS = 5
JS = (0, 5, 13, 20, 38, 63)
SPLIT_JS = (0, 5, 13, 20, 38)
SPLIT_CALLS = 24
SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
PARENT_TILE = 256                 # the parent's elements per partial sum


def build(source: bytes) -> ctypes.CDLL:
    """``source`` compiled alone into a shared library under OUT."""
    flags = list(KB.NVCC_FLAGS)
    h = hashlib.sha256(source + " ".join(flags).encode()).hexdigest()[:16]
    os.makedirs(OUT, exist_ok=True)
    lib = os.path.join(OUT, f"alone_{h}.so")
    if not os.path.exists(lib):
        src = os.path.join(OUT, f"alone_{h}.cu")
        with open(src, "wb") as f:
            f.write(source)
        subprocess.run([KB._find_nvcc(), *flags, "-shared", "-o", lib, src],
                       check=True, capture_output=True)
    return ctypes.CDLL(lib)


def parent_workspace(m, n, dt):
    """The parent's scratch: (m + 1) * ceil(n / 256) float64 partials and
    a vector of n."""
    parts = -(-n // PARENT_TILE)
    return (torch.empty((m + 1) * parts, dtype=torch.float64, device="cuda"),
            torch.empty(n, dtype=dt, device="cuda"))


def parent_step(lib, dtype):
    """The parent's C entry, called as ``gram_schmidt`` is (contiguous V
    and Z, ``work`` from ``parent_workspace``)."""
    fn = getattr(lib, f"nst_gram_schmidt_{SUFFIX[dtype]}")
    p = ctypes.c_void_p
    fn.argtypes = [p] * 11 + [ctypes.c_int, ctypes.c_longlong, p]
    fn.restype = ctypes.c_int

    def run(V, w, h1, h2, wnorm, j, active, work, z, Z):
        rc = fn(V.data_ptr(), w.data_ptr(), h1.data_ptr(), h2.data_ptr(),
                wnorm.data_ptr(), j.data_ptr(), active.data_ptr(),
                z.data_ptr(), Z.data_ptr(), work[0].data_ptr(),
                work[1].data_ptr(), V.shape[0] - 1, V.shape[1],
                torch.cuda.current_stream().cuda_stream)
        CS.check(rc == 0, f"parent launch ({rc})")
    return run


def state(V, w, z, Z, dt, padded):
    """A call's tensors: V and Z copied into a padded basis (the
    package's) or contiguous ones (the parent's)."""
    m = V.shape[0] - 1
    if padded:
        Vs, Zs = GS.basis(m + 1, V.shape[1], dt, "cuda"), GS.basis(
            m, V.shape[1], dt, "cuda")
        Vs.copy_(V)
        Zs.copy_(Z)
    else:
        Vs, Zs = V.clone(), Z.clone()
    return dict(V=Vs, w=w.clone(), z=z.clone(), Z=Zs,
                h1=torch.zeros(m + 1, dtype=dt, device="cuda"),
                h2=torch.zeros(m + 1, dtype=dt, device="cuda"),
                wnorm=torch.zeros((), dtype=dt, device="cuda"))


def call(fn, st, jt, on, work):
    return lambda: fn(st["V"], st["w"], st["h1"], st["h2"], st["wnorm"], jt,
                      on, work, st["z"], st["Z"])


def _trace(fns, calls):
    """{kernel: (device us per launch, launches per call)} of one
    ``torch.profiler`` CUDA trace of ``calls`` calls cycling ``fns``
    (copies and fills are not kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            fns[i % len(fns)]()
        torch.cuda.synchronize()
    rows = {}
    for e in prof.key_averages():
        if (e.device_type == DeviceType.CUDA
                and not e.key.startswith(("Memcpy", "Memset"))):
            name = e.key.replace("void ", "", 1).replace(
                "(anonymous namespace)::", "").split("(")[0]
            us, c = rows.get(name, (0.0, 0))
            rows[name] = (us + e.self_device_time_total, c + e.count)
    return {k: (us / c, c / calls) for k, (us, c) in rows.items()}


def profiled_kernels(fns, calls, traces=3):
    """{kernel: (device us per launch, launches per call)} of ``calls``
    calls cycling the callables ``fns`` (after one call of each), from
    ``traces`` profiler traces: each kernel's count from the trace that
    holds the most of its launches (a trace on the card at times loses
    launches, never adds one)."""
    for f in fns:
        f()
    torch.cuda.synchronize()
    best = {}
    for _ in range(traces):
        for k, (us, c) in _trace(fns, calls).items():
            if c > best.get(k, (0.0, 0))[1]:
                best[k] = (us, c)
    return best


def split(calls):
    """({kernel: (device us per launch, launches per call)}, launches per
    call, device us per call) of SPLIT_CALLS calls cycling ``calls``,
    from ``profiled_kernels``."""
    rows = profiled_kernels(calls, SPLIT_CALLS)
    launches = sum(c for _, c in rows.values())
    total = sum(us * c for us, c in rows.values())
    return rows, launches, total


def ab(dt, j, fns, q, w64, z64, do_split):
    n, m = CS.GS_N, CS.GS_M
    V = torch.zeros((m + 1, n), dtype=dt, device="cuda")
    V[:j + 1] = q[:j + 1].to(dt)
    w, z = w64.to(dt), z64.to(dt)
    Z = torch.zeros((m, n), dtype=dt, device="cuda")
    jt = torch.tensor(j, dtype=torch.int32, device="cuda")
    on = torch.tensor(True, device="cuda")
    works = {name: (parent_workspace(m, n, dt) if name == "parent"
                    else GS.workspace(m, n, dt, "cuda")) for name in fns}
    padded = {name: name != "parent" for name in fns}
    out = {}
    for name, fn in fns.items():
        st = state(V, w, z, Z, dt, padded[name])
        call(fn, st, jt, on, works[name])()
        out[name] = st
    torch.cuda.synchronize()
    same = all(torch.equal(out["parent"][k], out[name][k])
               for name in fns for k in out[name])
    s = V.element_size()
    foot = (j + 5) * n * s
    copies = max(1, -(-2 * CS.L2_BYTES // foot))
    sets = {name: [call(fn, state(V, w, z, Z, dt, padded[name]), jt, on,
                        works[name])
                   for _ in range(copies)] for name, fn in fns.items()}
    rounds = {name: [] for name in fns}
    for r in range(ROUNDS):
        order = list(fns) if r % 2 == 0 else list(fns)[::-1]
        for name in order:
            rounds[name].append(CS._burst_ms(sets[name], reps=REPS))
    splits = ({name: split(sets[name]) for name in fns}
              if do_split and j in SPLIT_JS else None)
    nbytes = (j + 5) * n * s + 4 * (m + 1) * s
    return dict(dtype=str(dt).replace("torch.", ""), j=j, bits_equal=same,
                bytes=nbytes,
                bound_ms=nbytes / CS.HBM_BYTES_PER_S * 1e3,
                **{f"{name}_ms": statistics.median(v)
                   for name, v in rounds.items()},
                rounds=rounds, split=splits)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-source", required=True)
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--json")
    args = ap.parse_args()
    CS.check(torch.cuda.is_available(), "needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    with open(args.parent_source, "rb") as f:
        lib = build(f.read())
    q, w64 = CS._gs_basis(CS.GS_N, CS.GS_M)
    g = torch.Generator(device="cuda").manual_seed(27)
    z64 = torch.randn(CS.GS_N, generator=g, device="cuda",
                      dtype=torch.float64)
    rows = []
    for dt in (torch.float32, torch.float64):
        fns = {"parent": parent_step(lib, dt), "kernel": GS.gram_schmidt}
        for j in JS:
            o = ab(dt, j, fns, q, w64, z64, args.split)
            rows.append(o)
            times = ", ".join(
                f"{name} {o[name + '_ms']:.4f} ms (rounds "
                f"{[round(x, 4) for x in o['rounds'][name]]})"
                for name in fns)
            bits = "equal" if o["bits_equal"] else "DIFFER"
            print(f"{o['dtype']} j={j}: {times}; bound {o['bound_ms']:.4f} "
                  f"ms ({o['bytes']} bytes); bits {bits}; {card}",
                  flush=True)
            for name, (kern, launches, total) in (o["split"] or {}).items():
                parts = "; ".join(f"{k} {us:.2f} us x {c:g}"
                                  for k, (us, c) in kern.items())
                print(f"  split {name} j={j}: {launches:g} launches per "
                      f"call, {total:.2f} us of kernels per call: {parts}",
                      flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)
    return 0 if all(o["bits_equal"] for o in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
