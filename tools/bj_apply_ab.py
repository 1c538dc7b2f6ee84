"""The tile-apply kernel (csrc/bj_apply.cu) against a parent revision's on
the card, at the tiles of ``chip_smoke.py`` phase 24's uses.

Builds the parent's ``navierstokes_tpu_torch/csrc/bj_apply.cu`` (``git show
REV:...`` with ``--rev``, or the file given with ``--parent-source`` where
the checkout is no git repository) with ``kernels/build.NVCC_FLAGS`` into
``build/bj_apply_ab/``.  At each use (seeded tiles near the identity, of
the real shapes: the bench point's 1,760 x 256 x 256 tiles over 450,518
rows in fp32, bf16 and fp64; NACA's 274 tiles over 69,970 rows in fp32 and
fp64; the float64 small fixture's 6 tiles over 1,498 rows, phase 24's fp64
path; 3D-1Z's 4,236 tiles over 1,084,214 rows at d=3 in fp32 and bf16) it
runs the parent's kernel, the package's (``kernels/bj_apply.bj_apply``) and
``torch.matmul`` (the library yardstick) in ROUNDS rounds of alternating
bursts, the order reversed every other round (parent, kernel, library, then
library, kernel, parent), each call finding its tiles outside the L2
(copies that exceed twice the L2 are cycled through).  Two protocols:

* ``back-to-back``: each round's entry is ``chip_smoke._burst_ms(fns,
  reps=5)``, five bursts of one function after one warm-up call of it, as
  ``chip_smoke.py`` phase 24 times the fp64 apply against
  ``torch.matmul``;
* ``flushed``: the same five bursts, each one (and its warm-up call) after
  a read of FLUSH_BYTES.

Last, at the fp64 bench tiles, phase 24's pair: the kernel against
``torch.matmul`` over a copy of the tiles (as phase 24 gates it), then
over the same tiles.  It prints each one's median ms, the spread and every
value of its rounds (so a time that depends on the function run before it
shows as rounds that alternate), GB/s and the bound, with the card's name
and power limit; then each of the three at the fp64 bench tiles right after
each of STATES (what the L2 holds before a call); checks that the parent's
and the package's outputs are equal bit for bit, and exits 1 if any use
differs.  Imports no JAX.

    python3 tools/bj_apply_ab.py --rev HEAD~1
    git show HEAD~1:navierstokes_tpu_torch/csrc/bj_apply.cu > build/parent.cu
    python3 tools/bj_apply_ab.py --parent-source build/parent.cu \\
        [--protocol back-to-back flushed] [--json PATH]
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
from navierstokes_tpu_torch.kernels import bj_apply as BJ  # noqa: E402
from navierstokes_tpu_torch.kernels import build as KB  # noqa: E402

SOURCE = "navierstokes_tpu_torch/csrc/bj_apply.cu"
OUT = os.path.join(ROOT, "build", "bj_apply_ab")
ROUNDS = 8
REPS = 5
PROTOCOLS = ("back-to-back", "flushed")
NAMES = ("parent", "kernel", "library")
# (use, tiles dtype, n_tiles, n_p2, d, functions in a round): phase 24's
# uses, and last the fp64 bench tiles with the kernel and the library alone
# in each round, as phase 24's own rounds run them
USES = [("bench", torch.float32, 1760, 450_518, 2, NAMES),
        ("bench", torch.bfloat16, 1760, 450_518, 2, NAMES),
        ("bench", torch.float64, 1760, 450_518, 2, NAMES),
        ("NACA", torch.float32, 274, 69_970, 2, NAMES),
        ("NACA", torch.float64, 274, 69_970, 2, NAMES),
        ("small fixture", torch.float64, 6, 1_498, 2, NAMES),
        ("3D-1Z", torch.float32, 4236, 1_084_214, 3, NAMES),
        ("3D-1Z", torch.bfloat16, 4236, 1_084_214, 3, NAMES),
        ("bench, phase 24's pair", torch.float64, 1760, 450_518, 2,
         ("kernel", "library_copy")),
        ("bench, phase 24's pair over the same tiles", torch.float64, 1760,
         450_518, 2, ("kernel", "library"))]
# what runs right before a burst in ``l2_states`` (the buffer read is
# FLUSH_BYTES; the parent's kernel reads the same tiles)
STATES = ("its own calls", "a read of 128 MB of another buffer",
          "torch.matmul over the tiles", "torch.matmul over a copy",
          "a read of the tiles' last 64 MB", "a read of a copy's last 64 MB",
          "the parent's kernel")
STATE_TRIALS = 3
SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float64: "f64"}


def build(source: bytes, tag: str) -> ctypes.CDLL:
    """``source`` compiled alone into a shared library under OUT."""
    flags = list(KB.NVCC_FLAGS)
    h = hashlib.sha256(source + " ".join(flags).encode()).hexdigest()[:16]
    os.makedirs(OUT, exist_ok=True)
    lib = os.path.join(OUT, f"{tag}_{h}.so")
    if not os.path.exists(lib):
        src = os.path.join(OUT, f"{tag}_{h}.cu")
        with open(src, "wb") as f:
            f.write(source)
        subprocess.run([KB._find_nvcc(), *flags, "-shared", "-o", lib, src],
                       check=True, capture_output=True)
    return ctypes.CDLL(lib)


def parent_entry(lib, dtype):
    """The parent's C entry: (tiles, r, y, n_tiles, sb, n_p2, D, stream)."""
    fn = getattr(lib, f"nst_bj_apply_{SUFFIX[dtype]}")
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, i, i, i, i, p]
    fn.restype = i

    def run(tiles, r, y):
        rc = fn(tiles.data_ptr(), r.data_ptr(), y.data_ptr(), tiles.shape[0],
                tiles.shape[1], r.shape[0], r.shape[1],
                torch.cuda.current_stream().cuda_stream)
        CS.check(rc == 0, f"parent launch ({rc})")
    return run


def round_ms(fns, protocol, flush):
    """One round's entry: the median of REPS bursts of ``fns``."""
    if protocol == "back-to-back":
        return CS._burst_ms(fns, reps=REPS)
    times = []
    for _ in range(REPS):
        flush.sum()
        times.append(CS._burst_ms(fns, reps=1))
    return statistics.median(times)


def seeded(dtype, n_tiles, n_p2, d, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    tiles = 0.05 * torch.randn((n_tiles, 256, 256), generator=g,
                               device="cuda", dtype=torch.float32)
    tiles.diagonal(dim1=1, dim2=2).add_(1.0)
    rdt = BJ.VARIANTS[dtype][1]
    r = torch.randn((n_p2, d), generator=g, device="cuda",
                    dtype=torch.float32).to(rdt)
    return tiles.to(dtype), r


def ab_use(use, dtype, n_tiles, n_p2, d, names, parent, seed, flush,
           protocols):
    tiles, r = seeded(dtype, n_tiles, n_p2, d, seed)
    nbytes = tiles.numel() * tiles.element_size()
    copies = [(tiles, r)] + [(tiles.clone(), r.clone()) for _ in range(
        max(0, -(-2 * CS.L2_BYTES // nbytes) - 1))]
    old = parent_entry(parent, dtype)
    y_old = torch.empty_like(r)
    old(tiles, r, y_old)
    y_new = BJ.bj_apply(tiles, r)
    torch.cuda.synchronize()
    same = torch.equal(y_old, y_new)
    differ = int((y_old != y_new).sum())
    outs = [torch.empty_like(r) for _ in copies]
    rbs = [torch.nn.functional.pad(rr, (0, 0, 0, n_tiles * 256 - n_p2))
           .reshape(n_tiles, 256, d).to(dtype) for _, rr in copies]
    fns = {"parent": [lambda t=t, rr=rr, y=y: old(t, rr, y)
                      for (t, rr), y in zip(copies, outs)],
           "kernel": [lambda t=t, rr=rr: BJ.bj_apply(t, rr)
                      for t, rr in copies],
           "library": [lambda t=t, rb=rb: torch.matmul(t, rb)
                       for (t, _), rb in zip(copies, rbs)]}
    if "library_copy" in names:
        # torch.matmul over tiles of its own, as no other kernel of the
        # main path reads the tile array
        fns["library_copy"] = [lambda t=t.clone(), rb=rb: torch.matmul(t, rb)
                               for (t, _), rb in zip(copies, rbs)]
    read = (n_p2 * 256 * tiles.element_size()
            + 2 * n_p2 * d * r.element_size())
    bound = read / CS.HBM_BYTES_PER_S * 1e3
    out = {"use": use, "dtype": str(dtype).replace("torch.", ""),
           "tiles": [n_tiles, 256, 256], "n_p2": n_p2, "d": d,
           "names": list(names), "copies": len(copies),
           "bit_equal_parent": same, "values_differing": differ, "bound_ms": bound,
           "bound_bytes": read, "launch": BJ.launch_config(tiles, r)}
    for protocol in protocols:
        times = {k: [] for k in names}
        for i in range(ROUNDS):
            for k in (names if i % 2 == 0 else names[::-1]):
                times[k].append(round_ms(fns[k], protocol, flush))
        out[protocol] = {
            k: {"median_ms": statistics.median(v), "min_ms": min(v),
                "max_ms": max(v), "spread_ms": max(v) - min(v),
                "GB_per_s": read / statistics.median(v) / 1e6, "rounds": v}
            for k, v in times.items()}
    del copies, outs, rbs, y_old, y_new
    torch.cuda.empty_cache()
    return out


def l2_states(parent, flush):
    """ms per call of the parent's kernel, the package's and torch.matmul
    at the fp64 bench tiles in bursts of 40 right after each of STATES (the
    median of STATE_TRIALS), so the L2's content before a call shows."""
    n_tiles, n_p2, d = 1760, 450_518, 2
    tiles, r = seeded(torch.float64, n_tiles, n_p2, d, 1499)
    c = tiles.clone()
    rb = torch.nn.functional.pad(r, (0, 0, 0, n_tiles * 256 - n_p2)).reshape(
        n_tiles, 256, d)
    old = parent_entry(parent, torch.float64)
    y = torch.empty_like(r)
    n64 = (64 << 20) // 8
    fns = {"parent": lambda: old(tiles, r, y),
           "kernel": lambda: BJ.bj_apply(tiles, r),
           "library": lambda: torch.matmul(tiles, rb)}
    before = dict(zip(STATES, (
        None, flush.sum, lambda: torch.matmul(tiles, rb),
        lambda: torch.matmul(c, rb), lambda: tiles.view(-1)[-n64:].sum(),
        lambda: c.view(-1)[-n64:].sum(), fns["parent"])))
    times = {(k, s): [] for k in fns for s in STATES}
    for _ in range(STATE_TRIALS):
        for k, fn in fns.items():
            for s, pre in before.items():
                fn()
                if pre is not None:
                    pre()
                torch.cuda._sleep(40 * 200_000)
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                for _ in range(40):
                    fn()
                b.record()
                b.synchronize()
                times[k, s].append(a.elapsed_time(b) / 40)
    med = {key: statistics.median(v) for key, v in times.items()}
    print("fp64 bench tiles, ms per call in a burst of 40 right after:",
          flush=True)
    for s in STATES:
        print(f"  {s:36s} " + "  ".join(f"{k} {med[k, s]:.4f}" for k in fns),
              flush=True)
    del tiles, c, rb
    torch.cuda.empty_cache()
    return {f"{k} after {s}": {"median_ms": med[k, s], "trials": times[k, s]}
            for k, s in times}


def report(o, protocol):
    t = o[protocol]
    print(f"  {protocol}:", flush=True)
    for k in o["names"]:
        print(f"    {k:8s} median {t[k]['median_ms']:.4f} ms (rounds "
              f"{t[k]['min_ms']:.4f}-{t[k]['max_ms']:.4f}, spread "
              f"{t[k]['spread_ms']:.4f}), {t[k]['GB_per_s']:.0f} GB/s, "
              f"{o['bound_ms'] / t[k]['median_ms']:.1%} of the bound; rounds "
              + " ".join(f"{x:.4f}" for x in t[k]["rounds"]), flush=True)
    lib = "library_copy" if "library_copy" in t else "library"
    line = (f"    kernel - {lib} "
            f"{t['kernel']['median_ms'] - t[lib]['median_ms']:+.4f} ms")
    if "parent" in t:
        slower = t["kernel"]["median_ms"] - t["parent"]["median_ms"]
        spread = max(t["kernel"]["spread_ms"], t["parent"]["spread_ms"])
        line += (f"; kernel - parent {slower:+.4f} ms (spread {spread:.4f}): "
                 + ("slower than the parent beyond the spread"
                    if slower > spread else "not slower beyond the spread"))
    print(line, flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--rev", help="git revision of the parent's source")
    g.add_argument("--parent-source", help="the parent's bj_apply.cu")
    ap.add_argument("--protocol", nargs="+", choices=PROTOCOLS,
                    default=list(PROTOCOLS))
    ap.add_argument("--json", help="write the results there")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bj_apply_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if args.rev:
        parent_src = subprocess.run(
            ["git", "show", f"{args.rev}:{SOURCE}"], cwd=ROOT, check=True,
            capture_output=True).stdout
    else:
        with open(args.parent_source, "rb") as f:
            parent_src = f.read()
    parent = build(parent_src, "parent")
    card = CS.card_line()
    flush = torch.ones(CS.FLUSH_BYTES // 4, device="cuda")
    results = []
    for k, (use, dtype, n_tiles, n_p2, d, names) in enumerate(USES):
        o = ab_use(use, dtype, n_tiles, n_p2, d, names, parent, 1500 + k,
                   flush, args.protocol)
        results.append(o)
        print(f"{use} {o['dtype']} d={d} ({n_tiles} tiles, {n_p2} rows, "
              f"{o['copies']} copies): bit for bit with the parent "
              f"{o['bit_equal_parent']} ({o['values_differing']} values "
              f"differ); {CS.launch_line(o['launch'])}; bound "
              f"{o['bound_ms']:.4f} ms", flush=True)
        for protocol in args.protocol:
            report(o, protocol)
    states = l2_states(parent, flush)
    print(card, flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": card, "uses": results, "l2_states": states},
                      f, indent=1)
    ok = all(o["bit_equal_parent"] for o in results)
    print(json.dumps({"ok": ok, "card": card}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
