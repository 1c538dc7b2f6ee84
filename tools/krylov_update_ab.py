"""BiCGStab's update stages (csrc/krylov_update.cu) against a parent
revision's on the card, at the bench point's BiCGStab size.

Builds the parent's ``navierstokes_tpu_torch/csrc/krylov_update.cu`` (the
file given with ``--parent-source``; ``git show REV:...`` writes it) alone
with ``kernels/build.NVCC_FLAGS`` into ``build/krylov_update_ab/``.  For
each of ``bicgstab_p``, ``bicgstab_s`` and ``bicgstab_xr``, in float32 and
float64, at n = 901,036 (the F system of ``chip_smoke.py`` phase 26), on
views that start on a 16-byte boundary and on views 1 and (float32) 2
elements past one, it

* runs the parent's stage and the package's (``kernels/krylov_update.
  update``) once on copies of the same seeded inputs (drawn scalars, the
  flag up) and checks every output equal bit for bit, and both equal to
  the plain version;
* times both in ROUNDS rounds of alternating bursts
  (``chip_smoke._burst_ms``, REPS bursts, the order reversed every other
  round), each call finding its vectors outside the L2 (input sets that
  exceed twice the L2 are cycled through);

and prints the path the package took, each one's median ms, its rounds,
the byte bound and each one's share of it, with the card's name and
power limit.  Exits 1 if any bits differ.  ``--scan`` times the package's stages alone (fp32, aligned, L2-cold
bursts) at n in SCAN times 901,036 and fits time = fixed + bytes / rate
over them: the fixed cost per launch and the rate the loop streams at.
Imports no JAX.

    git show HEAD~1:navierstokes_tpu_torch/csrc/krylov_update.cu \\
        > build/ku_parent.cu
    python3 tools/krylov_update_ab.py --parent-source build/ku_parent.cu \\
        [--scan] [--json PATH]
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import hashlib
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as CS  # noqa: E402
from navierstokes_tpu_torch.kernels import build as KB  # noqa: E402
from navierstokes_tpu_torch.kernels import krylov_update as KU  # noqa: E402

OUT = os.path.join(ROOT, "build", "krylov_update_ab")
ROUNDS = 6
REPS = 5
STAGES = ("bicgstab_p", "bicgstab_s", "bicgstab_xr")
N = CS.KRY_N["bicgstab"]
SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
OFFSETS = {torch.float32: (0, 1, 2), torch.float64: (0, 1)}


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


def parent_update(lib, dtype):
    """The parent's C entry (stage, pointers, n, stream), called as
    ``update`` is."""
    fn = getattr(lib, f"nst_krylov_update_{SUFFIX[dtype]}")
    p = ctypes.c_void_p
    fn.argtypes = [ctypes.c_int, p, ctypes.c_longlong, p]
    fn.restype = ctypes.c_int

    def run(stage, *args):
        ptrs = (p * len(args))(*[t.data_ptr() for t in args])
        rc = fn(KU.STAGES.index(stage), ptrs, args[0].numel(),
                torch.cuda.current_stream().cuda_stream)
        CS.check(rc == 0, f"parent launch ({rc})")
    return run


def ab(stage, dt, offset, fns):
    """Bits and alternating timings of one stage, dtype and offset."""
    kern = KU.example(stage, N, dt, "cuda", np.random.default_rng(1),
                      offset=offset)
    runs = {name: [t.clone() for t in kern] for name in fns}
    plain = [t.clone() for t in kern]
    for name, fn in fns.items():
        fn(stage, *runs[name])
    KU.PLAIN[stage](*plain)
    torch.cuda.synchronize()
    bits = all(torch.equal(t, p) for name in fns
               for t, p in zip(runs[name], plain))
    names = KU.ARGS[stage]
    way = KU.path([t.data_ptr() for name, t in zip(names, kern)
                   if name in KU.VECTORS])
    reads, writes, _ = CS.KRY_VECTORS[stage]
    nbytes = (reads + writes) * N * kern[0].element_size()
    copies = max(2, -(-2 * CS.L2_BYTES // nbytes))
    sets = {name: [functools.partial(fn, stage, *KU.example(
        stage, N, dt, "cuda", np.random.default_rng(2 + i),
        scalars=CS.KRY_TAME, offset=offset)) for i in range(copies)]
        for name, fn in fns.items()}
    rounds = {name: [] for name in fns}
    for r in range(ROUNDS):
        order = list(fns) if r % 2 == 0 else list(fns)[::-1]
        for name in order:
            rounds[name].append(CS._burst_ms(sets[name], reps=REPS))
    bound = nbytes / CS.HBM_BYTES_PER_S * 1e3
    return dict(stage=stage, dtype=str(dt).replace("torch.", ""),
                offset_bytes=offset * kern[0].element_size(), path=way,
                bits_equal=bits, bytes=nbytes, bound_ms=bound,
                **{f"{name}_ms": statistics.median(v)
                   for name, v in rounds.items()}, rounds=rounds)


SCAN = (1 / 8, 1 / 4, 1 / 2, 1, 2, 4)


def scan(stage):
    """(n, ms, bytes) of the package's stage alone at n = SCAN x N (fp32,
    aligned, L2-cold bursts), and the least-squares fit of ms on bytes:
    (fixed us, GB/s)."""
    reads, writes, _ = CS.KRY_VECTORS[stage]
    pts = []
    for f in SCAN:
        n = int(N * f)
        nbytes = (reads + writes) * n * 4
        sets = [KU.example(stage, n, torch.float32, "cuda",
                           np.random.default_rng(2 + i), scalars=CS.KRY_TAME)
                for i in range(max(2, -(-2 * CS.L2_BYTES // nbytes)))]
        ms = CS._burst_ms([functools.partial(KU.update, stage, *st)
                           for st in sets], reps=REPS)
        pts.append((n, ms, nbytes))
        del sets
    x = np.array([p[2] for p in pts], float)
    y = np.array([p[1] for p in pts], float)
    slope, icpt = np.polyfit(x, y, 1)
    return pts, icpt * 1e3, 1e-6 / slope


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-source", required=True)
    ap.add_argument("--scan", action="store_true")
    ap.add_argument("--json")
    args = ap.parse_args()
    CS.check(torch.cuda.is_available(), "needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    with open(args.parent_source, "rb") as f:
        lib = build(f.read())
    rows = []
    for dt in (torch.float32, torch.float64):
        fns = {"parent": parent_update(lib, dt), "kernel": KU.update}
        for stage in STAGES:
            for offset in OFFSETS[dt]:
                o = ab(stage, dt, offset, fns)
                rows.append(o)
                print(f"{stage} {o['dtype']} n={N} offset "
                      f"{o['offset_bytes']} B ({o['path']} path): "
                      f"parent {o['parent_ms']:.4f} ms "
                      f"({100 * o['bound_ms'] / o['parent_ms']:.1f}% of "
                      f"the bound), kernel {o['kernel_ms']:.4f} ms "
                      f"({100 * o['bound_ms'] / o['kernel_ms']:.1f}%); "
                      "rounds parent "
                      f"{[round(x, 4) for x in o['rounds']['parent']]}, "
                      f"kernel "
                      f"{[round(x, 4) for x in o['rounds']['kernel']]}; "
                      f"bound {o['bound_ms']:.4f} ms ({o['bytes']} bytes); "
                      f"bits {'equal' if o['bits_equal'] else 'DIFFER'}; "
                      f"{card}", flush=True)
    scans = {}
    if args.scan:
        for stage in STAGES:
            pts, fixed_us, gbs = scan(stage)
            scans[stage] = dict(points=pts, fixed_us=fixed_us, gb_s=gbs)
            print(f"scan {stage} float32 (n, ms, bytes): {pts}; fit: "
                  f"{fixed_us:.2f} us fixed per launch + bytes at "
                  f"{gbs:.0f} GB/s; {card}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": card, "rows": rows, "scan": scans}, f,
                      indent=1)
    return 0 if all(o["bits_equal"] for o in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
