"""Where the exact tile inverse's time goes: csrc/bj_inverse.cu's kernel,
copied with clock64() counters between its phases, on one card; and the
kernel against another version of its source, in alternating rounds.

    python3 tools/bj_inverse_profile.py [--source PATH] [--tiles 1760]
        [--sb 256] [--extra-smem BYTES] [--seed 0] [--fine]
        [--ab PARENT.cu] [--rounds 8] [--json PATH]

The copy (``--source``, default the checkout's csrc/bj_inverse.cu) gets a
counter at each of the source's ``// -- phase: NAME`` lines, read by thread
0 of each CTA: the clocks since the last line go to the phase that was
running, summed over the grid with atomic adds at the CTA's end.  With
``--fine`` A's column is split into its parts (the reciprocal and the
scaled copy, the block barrier, the warps' pairs, the pivot row's read, the
update, the next column's search); their counters sit inside the column
loop and slow it, so by default the loop is one phase.  Per panel it keeps, apart
for the CTA that factors the next panel (the look-ahead CTA) and for the
others, the clocks spent waiting for the panel, in the look-ahead's update
of the next panel's columns, in A and in the trailing update (B' and B),
and reports each panel's critical path (the look-ahead CTA's look-ahead
and A, from the panel's arrival to the next panel's copies) and the share of the other CTAs' trailing update that
ran under it (min(their B' + B, look-ahead + A) over their B' + B).
Counters cost time: the instrumented kernel's ms is printed beside the
plain build's.  ``--extra-smem`` adds shared memory to the SB = 256 kernel
(e.g. 100000 holds one CTA per SM), which shows what sharing an SM costs
each phase.

With ``--ab PARENT.cu`` it builds that source and ``--source`` as they
are (no counters) and, on the same seeded tiles, checks that they give
the same bits and times them in ``--rounds`` alternating rounds (parent
then change, change then parent, ...), each round one launch L2-cold (a 128 MB read before it) and
a burst of 5 warm launches, at ``--tiles`` and at the NACA step's 274
tiles; the figures are medians over the rounds.

To profile the previous kernel (blocked ownership, one cluster barrier a
panel), use its own tool and file from the commit before the redesign:

    git show 50b4d58:tools/bj_inverse_profile.py > build/bji_prof_parent.py
    git show 50b4d58:navierstokes_tpu_torch/csrc/bj_inverse.cu \\
        > build/bj_inverse_parent.cu
    python3 build/bji_prof_parent.py --source build/bj_inverse_parent.cu

The tiles are seeded fp32, N(0, 1) / sqrt(SB) + 4 I (numpy's
default_rng(--seed)).  Builds go into ``build/bj_inverse_profile/``.  It
prints the card's name and power limit first, and as its last line one
JSON object with every figure.  Imports no JAX; the checkout's package is
not used.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "bj_inverse_profile")
MARK = re.compile(r"^(\s*)// -- phase: (.*)$", re.M)
NACA_TILES = 274
# per-panel categories: a phase's clocks go to the first whose word it holds
CATEGORIES = (("wait", ("waiting for panel",)),
              ("look-ahead", ("look-ahead",)),
              ("A", ("A,", "A's end")),
              ("B", ("B' (", "B (")))


# the parts of A's column (inside its loop): counted with --fine only,
# else the column loop's clocks go to its first phase
COLUMN_PARTS = ("A, the reciprocal and the scaled copy", "A, the block barrier",
                "A, the warps' pairs", "A, the pivot row's read",
                "A, the update", "A, the next column's pivot search")
FIRST = "A, the first column's pivot search"


def coarse(src: str) -> str:
    """The source without the markers of A's column parts; its first
    phase then holds the whole column loop."""
    src = MARK.sub(lambda m: "" if m.group(2) in COLUMN_PARTS else m.group(0),
                   src)
    return src.replace(f"// -- phase: {FIRST}",
                       "// -- phase: A, the panel's 16 columns")


def phases(src: str):
    """The source's phase names, in order of first appearance (index 0 is
    the load before the first line)."""
    names = ["load (and the cluster's start)"]
    for m in MARK.finditer(src):
        if m.group(2) not in names:
            names.append(m.group(2))
    return names


def category(name: str) -> int:
    for i, (_, words) in enumerate(CATEGORIES):
        if any(name.startswith(w) for w in words):
            return i
    return -1


def instrument(src: str, extra: int) -> str:
    """The source with the phase counters (see the module docstring)."""
    names = phases(src)
    ncat = len(CATEGORIES)

    def rep(a, b):
        nonlocal src
        if a not in src:
            raise SystemExit(f"bj_inverse_profile: no anchor {a[:60]!r} in "
                             "the source")
        src = src.replace(a, b, 1)

    src = MARK.sub(lambda m: f"{m.group(1)}PROF_ENTER("
                   f"{names.index(m.group(2))});", src)
    cats = ", ".join(str(category(n)) for n in names)
    rep("namespace {\n",
        f"#define NST_NPH {len(names)}\n#define NST_NCAT {ncat}\n"
        "__device__ unsigned long long g_prof[NST_NPH];\n"
        "__device__ unsigned long long g_panel[40][2 * NST_NCAT + 1];\n"
        f"__constant__ int c_cat[NST_NPH] = {{{cats}}};\n"
        "namespace {\n")
    rep("  extern __shared__ __align__(16) unsigned char smem[];\n",
        "  extern __shared__ __align__(16) unsigned char smem[];\n"
        "  __shared__ long long prof_acc[NST_NPH];\n"
        "  __shared__ long long prof_pp[C::kPanels + 1][2 * NST_NCAT + 1];\n"
        "  int prof_it = 0, prof_cur = 0, prof_ahead = 0;\n"
        "  long long prof_t0 = 0;\n"
        "  if (threadIdx.x == 0) {\n"
        "    for (int i = 0; i < NST_NPH; ++i) prof_acc[i] = 0;\n"
        "    for (int i = 0; i <= C::kPanels; ++i)\n"
        "      for (int j = 0; j < 2 * NST_NCAT + 1; ++j) prof_pp[i][j] = 0;\n"
        "    prof_t0 = clock64();\n"
        "  }\n"
        "#define PROF_ENTER(i) if (threadIdx.x == 0) { const long long "
        "t_ = clock64(), d_ = t_ - prof_t0; prof_acc[prof_cur] += d_; "
        "if (c_cat[prof_cur] >= 0) prof_pp[prof_it][prof_ahead * NST_NCAT "
        "+ c_cat[prof_cur]] += d_; prof_t0 = t_; prof_cur = (i); }\n")
    rep("  for (int P = -1; P < C::kPanels; ++P) {\n"
        "    const int N = P + 1;        // the next panel\n"
        "    const bool ahead = N < C::kPanels && rank == owner(N);\n",
        "  for (int P = -1; P < C::kPanels; ++P) {\n"
        "    const int N = P + 1;        // the next panel\n"
        "    const bool ahead = N < C::kPanels && rank == owner(N);\n"
        "    PROF_ENTER(prof_cur);\n"
        "    prof_it = P + 1;\n"
        "    prof_ahead = ahead ? 1 : 0;\n"
        "    if (threadIdx.x == 0 && ahead) prof_pp[prof_it][2 * NST_NCAT]"
        " += 1;\n")
    rep("  if (kC > 1) {                 // no CTA leaves while another may "
        "reach it\n",
        "  PROF_ENTER(0);\n"
        "  if (threadIdx.x == 0) {\n"
        "    for (int i = 0; i < NST_NPH; ++i)\n"
        "      atomicAdd(&g_prof[i], (unsigned long long)prof_acc[i]);\n"
        "    for (int i = 0; i <= C::kPanels; ++i)\n"
        "      for (int j = 0; j < 2 * NST_NCAT + 1; ++j)\n"
        "        atomicAdd(&g_panel[i][j], (unsigned long long)prof_pp[i][j]);"
        "\n  }\n"
        "  if (kC > 1) {                 // no CTA leaves while another may "
        "reach it\n")
    rep("2 * (kBytes + 1024) <= 233472",
        f"2 * (kBytes - (SB == 256 ? {int(extra)} : 0) + 1024) <= 233472")
    rep("  static constexpr size_t kBytes = kBar + 4 * 8;",
        "  static constexpr size_t kBytes = kBar + 4 * 8 + "
        f"(SB == 256 ? {int(extra)} : 0);")
    rep('extern "C" {',
        'extern "C" {\nint nst_prof_read(unsigned long long* out, '
        'unsigned long long* panel) {\n'
        '  int e = (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));\n'
        '  if (e) return e;\n'
        '  return (int)cudaMemcpyFromSymbol(panel, g_panel, sizeof(g_panel));'
        '\n}\nint nst_prof_zero() {\n'
        '  static unsigned long long z[40 * (2 * NST_NCAT + 1)] = {0};\n'
        '  int e = (int)cudaMemcpyToSymbol(g_prof, z, sizeof(g_prof));\n'
        '  if (e) return e;\n'
        '  return (int)cudaMemcpyToSymbol(g_panel, z, sizeof(g_panel));\n}\n')
    return src


def nvcc():
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")


def build(src_text: str, tag: str) -> ctypes.CDLL:
    """nvcc of ``src_text`` into ``build/bj_inverse_profile/lib<tag>.so``;
    prints ptxas's registers, spills and shared memory."""
    os.makedirs(OUT, exist_ok=True)
    cu = os.path.join(OUT, f"{tag}.cu")
    with open(cu, "w") as fh:
        fh.write(src_text)
    so = os.path.join(OUT, f"lib{tag}.so")
    r = subprocess.run([nvcc(), "-gencode=arch=compute_90a,code=sm_90a",
                        "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
                        "-Xptxas", "-v", "-o", so, cu],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"nvcc failed ({tag}):\n{r.stderr}")
    for line in r.stderr.splitlines():
        if "bj_inverse_kernel" in line and "Compiling" in line:
            print(f"  ptxas {tag}: {line.strip()}", flush=True)
        elif "registers" in line or "spill" in line:
            print(f"    {line.strip()}", flush=True)
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.nst_bj_inverse.argtypes = [p, p, i, i, i, ctypes.c_longlong, i, p]
    lib.nst_bj_inverse.restype = i
    if hasattr(lib, "nst_prof_read"):
        lib.nst_prof_read.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)] * 2
    return lib


def tiles(n, sb, seed):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal((n, sb, sb)) / np.sqrt(sb)
                           + 4.0 * np.eye(sb), dtype=torch.float32,
                           device="cuda")


def launcher(lib, a, out):
    sb, n = a.shape[-1], a.shape[0]
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        rc = lib.nst_bj_inverse(a.data_ptr(), out.data_ptr(), sb, n, 1,
                                sb * sb, sb, stream)
        if rc:
            raise SystemExit(f"launch failed ({rc})")
    return run


def timed(fn, flush=None, reps=1):
    """ms per call of ``reps`` calls between two events, after ``flush``."""
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    if flush is not None:
        flush()
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def profile(args, card):
    with open(args.source) as fh:
        src = fh.read()
    plain = build(src, "plain")
    if not args.fine:
        src = coarse(src)
    names = phases(src)
    lib = build(instrument(src, args.extra_smem),
                f"prof_{args.extra_smem}_{int(args.fine)}")
    sb, n = args.sb, args.tiles
    a = tiles(n, sb, args.seed)
    out, out_p = torch.empty_like(a), torch.empty_like(a)
    run, run_p = launcher(lib, a, out), launcher(plain, a, out_p)
    run()
    run_p()
    torch.cuda.synchronize()
    same = bool(torch.equal(out.view(torch.int32), out_p.view(torch.int32)))
    plain_ms = statistics.median(timed(run_p) for _ in range(5))
    lib.nst_prof_zero()
    ms = timed(run)
    buf = (ctypes.c_ulonglong * 64)()
    ncat = len(CATEGORIES)
    pan = (ctypes.c_ulonglong * (40 * (2 * ncat + 1)))()
    lib.nst_prof_read(buf, pan)
    ctas = n * max(1, sb // 64)
    panels = sb // 16
    clocks = {k: buf[j] / ctas for j, k in enumerate(names)}
    print(f"kernel ms {ms:.4f} instrumented, {plain_ms:.4f} as built "
          f"(median of 5; {n} tiles of {sb}, extra shared memory "
          f"{args.extra_smem} B, the two give the same bits: {same}) on "
          f"{card}", flush=True)
    for k, v in clocks.items():
        print(f"  {k}: {v:.0f} clocks per CTA, {v / panels:.0f} per panel",
              flush=True)
    parts = {k[3:]: v * max(1, sb // 64) / sb for k, v in clocks.items()
             if k.startswith("A,") and "waiting" not in k}
    per_col = sum(parts.values())   # the owners' clocks a column
    print(f"  A per column (owner): {per_col:.0f} clocks"
          + (f"; by part: " + ", ".join(f"{k} {v:.0f}" for k, v in parts.items())
             if args.fine else ""), flush=True)
    # per panel: the look-ahead CTA (one a tile) and the others
    cat = [c for c, _ in CATEGORIES]
    rows = []
    for it in range(panels + 1):
        base = it * (2 * ncat + 1)
        n_ahead = pan[base + 2 * ncat]
        n_other = (n * max(1, sb // 64) - n_ahead) if it > 0 else 0
        oth = {c: pan[base + j] / max(n_other, 1) for j, c in enumerate(cat)}
        ahd = {c: pan[base + ncat + j] / max(n_ahead, 1)
               for j, c in enumerate(cat)}
        crit = ahd["look-ahead"] + ahd["A"]
        hidden = (min(oth["B"], ahd["look-ahead"] + ahd["A"]) / oth["B"]
                  if oth["B"] else None)
        rows.append(dict(panel=it - 1, next=it, ahead=ahd, others=oth,
                         critical=crit, hidden=hidden))
        h = "n/a" if hidden is None else f"{hidden:.2f}"
        print(f"  iteration P={it - 1:2d} (factors {it:2d}): look-ahead CTA "
              + ", ".join(f"{c} {ahd[c]:.0f}" for c in cat)
              + f"; others " + ", ".join(f"{c} {oth[c]:.0f}" for c in cat)
              + f"; critical path {crit:.0f}, others' B' + B under it {h}",
              flush=True)
    return dict(kernel_ms_instrumented=ms, kernel_ms=plain_ms,
                same_bits=same, clocks_per_cta=clocks,
                a_clocks_per_column=per_col, a_column_parts=parts,
                panels=rows)


def ab(args, card):
    with open(args.source) as fh:
        src = fh.read()
    with open(args.ab) as fh:
        libs = {"parent": build(fh.read(), "ab_parent"),
                "change": build(src, "ab_change")}
    flush_buf = torch.empty(32 * 1024 * 1024, dtype=torch.float32,
                            device="cuda")
    flush = lambda: flush_buf.add_(1.0)
    res = {}
    for n in (args.tiles, NACA_TILES):
        a = tiles(n, args.sb, args.seed)
        outs = {k: torch.empty_like(a) for k in libs}
        runs = {k: launcher(libs[k], a, outs[k]) for k in libs}
        for r in runs.values():
            r()
        torch.cuda.synchronize()
        same = bool(torch.equal(outs["parent"].view(torch.int32),
                                outs["change"].view(torch.int32)))
        cold = {k: [] for k in libs}
        warm = {k: [] for k in libs}
        for i in range(args.rounds):          # P C, then C P, ...
            for k in (("parent", "change") if i % 2 == 0
                      else ("change", "parent")):
                cold[k].append(timed(runs[k], flush))
                warm[k].append(timed(runs[k], reps=5))
        med = {k: dict(cold=statistics.median(cold[k]),
                       warm=statistics.median(warm[k]),
                       cold_spread=max(cold[k]) - min(cold[k])) for k in libs}
        print(f"A/B at {n} tiles of {args.sb}: same bits {same}; "
              + "; ".join(f"{k} cold {m['cold']:.4f} (spread "
                          f"{m['cold_spread']:.4f}), warm {m['warm']:.4f}"
                          for k, m in med.items())
              + f" ms (medians of {args.rounds} rounds each) on {card}",
              flush=True)
        if not same:
            raise SystemExit("the parent and the change give other bits")
        res[str(n)] = dict(same_bits=same, medians=med, cold=cold, warm=warm)
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", default=os.path.join(
        ROOT, "navierstokes_tpu_torch", "csrc", "bj_inverse.cu"))
    ap.add_argument("--tiles", type=int, default=1760)
    ap.add_argument("--sb", type=int, default=256)
    ap.add_argument("--extra-smem", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ab", default=None)
    ap.add_argument("--fine", action="store_true")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bj_inverse_profile: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    res = dict(card=card, tiles=args.tiles, sb=args.sb,
               extra_smem=args.extra_smem, fine=args.fine)
    if args.ab:
        res["ab"] = ab(args, card)
    else:
        res.update(profile(args, card))
    line = json.dumps(res)
    if args.json:
        with open(args.json, "w") as fh:
            fh.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
