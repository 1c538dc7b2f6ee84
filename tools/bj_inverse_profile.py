"""Where the exact tile inverse's time goes: csrc/bj_inverse.cu's kernel,
copied with clock64() counters between its phases, on one card.

    python3 tools/bj_inverse_profile.py [--source PATH] [--tiles 1760]
        [--sb 256] [--extra-smem BYTES] [--seed 0]

The copy (``--source``, default the checkout's csrc/bj_inverse.cu; a
parent's file for a comparison) gets a counter per CTA at each phase
boundary, summed over the grid with one atomic add per CTA: the load of
the CTA's columns, A (the owner's panel factorisation and its push), the
cluster barrier's wait, the panel's pivots and multipliers read back, B'
(the pivot rows), B (the other rows' blocks) and the output write.  It is
built by nvcc into ``build/bj_inverse_profile/`` and launched through its
own C entry on seeded diagonally dominant fp32 tiles.  ``--extra-smem``
adds shared memory to the SB = 256 kernel (e.g. 100000 holds one CTA per
SM), which shows what sharing an SM costs each phase.

It prints the card's name and power limit, the kernel's ms (CUDA events,
one launch after a warm-up), each phase's clocks per CTA and per panel,
cuSOLVER's batched inverse of the same tiles (the parent's route, ms over
3 calls), and as its last line one JSON object with every figure.
Imports no JAX; the checkout's package is not used.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("load", "A (owner) + push", "cluster barrier", "pivots read back",
          "B' (pivot rows)", "B (other rows)", "output")


def instrument(src: str) -> str:
    """The source with the phase counters (see the module docstring)."""
    def rep(a, b):
        nonlocal src
        if a not in src:
            raise SystemExit(f"bj_inverse_profile: no anchor {a[:60]!r} in "
                             "the source")
        src = src.replace(a, b, 1)

    rep("namespace {\n", "__device__ unsigned long long g_prof[16];\n"
        "namespace {\n")
    rep("  cluster_arrive_relaxed();     // this CTA runs: others may store "
        "into it\n",
        "  cluster_arrive_relaxed();     // this CTA runs: others may store "
        "into it\n  long long T0 = clock64(), T1;\n  long long acc_[8] = "
        "{0, 0, 0, 0, 0, 0, 0, 0};\n#define TICK(i) { T1 = clock64(); "
        "acc_[i] += T1 - T0; T0 = T1; }\n")
    rep("  __syncthreads();\n  cluster_wait();\n",
        "  __syncthreads();\n  cluster_wait();\n  TICK(0)\n")
    rep("    cluster_arrive();\n    cluster_wait();\n",
        "    TICK(1)\n    cluster_arrive();\n    cluster_wait();\n    TICK(2)\n")
    rep("    const bool own_panel = rank == owner;\n",
        "    TICK(3)\n    const bool own_panel = rank == owner;\n")
    rep("    __syncthreads();\n\n    // B: the other rows",
        "    __syncthreads();\n    TICK(4)\n\n    // B: the other rows")
    rep("    __syncthreads();\n  }\n\n  // the inverse:",
        "    __syncthreads();\n    TICK(5)\n  }\n\n  // the inverse:")
    rep("        cvt<O>(slab[r * kLd + c]);\n  }\n}",
        "        cvt<O>(slab[r * kLd + c]);\n  }\n  TICK(6)\n  if (tid == 0)"
        "\n    for (int i = 0; i < 7; ++i) atomicAdd(&g_prof[i], "
        "(unsigned long long)acc_[i]);\n}")
    rep("  static constexpr size_t kBytes = kStep + size_t(SB) * 4;",
        "  static constexpr size_t kBytes = kStep + size_t(SB) * 4 + "
        "(SB == 256 ? NST_EXTRA_SMEM : 0);")
    rep('extern "C" {',
        'extern "C" {\nint nst_prof_read(unsigned long long* out) {\n'
        '  return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));\n}'
        '\nint nst_prof_zero() {\n  unsigned long long z[16] = {0};\n'
        '  return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));\n}\n')
    return src


def build(source: str, extra: int) -> ctypes.CDLL:
    out_dir = os.path.join(ROOT, "build", "bj_inverse_profile")
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, "bj_inverse_profile.cu")
    with open(source) as fh, open(cu, "w") as out:
        out.write(instrument(fh.read()))
    so = os.path.join(out_dir, f"libbj_inverse_profile_{extra}.so")
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    r = subprocess.run([nvcc, "-gencode=arch=compute_90a,code=sm_90a",
                        "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
                        f"-DNST_EXTRA_SMEM={extra}", "-o", so, cu],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"nvcc failed:\n{r.stderr}")
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.nst_bj_inverse.argtypes = [p, p, i, i, i, ctypes.c_longlong, i, p]
    lib.nst_bj_inverse.restype = i
    lib.nst_prof_read.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    return lib


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", default=os.path.join(
        ROOT, "navierstokes_tpu_torch", "csrc", "bj_inverse.cu"))
    ap.add_argument("--tiles", type=int, default=1760)
    ap.add_argument("--sb", type=int, default=256)
    ap.add_argument("--extra-smem", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bj_inverse_profile: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    lib = build(args.source, args.extra_smem)
    rng = np.random.default_rng(args.seed)
    sb, n = args.sb, args.tiles
    a = torch.as_tensor(rng.standard_normal((n, sb, sb)) / np.sqrt(sb)
                        + 4.0 * np.eye(sb), dtype=torch.float32,
                        device="cuda")
    out = torch.empty_like(a)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        rc = lib.nst_bj_inverse(a.data_ptr(), out.data_ptr(), sb, n, 1,
                                sb * sb, sb, stream)
        if rc:
            raise SystemExit(f"launch failed ({rc})")

    run()
    torch.cuda.synchronize()
    lib.nst_prof_zero()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    run()
    e.record()
    torch.cuda.synchronize()
    ms = s.elapsed_time(e)
    buf = (ctypes.c_ulonglong * 16)()
    lib.nst_prof_read(buf)
    ctas = n * max(1, sb // 64)
    panels = sb // 16
    clocks = {k: buf[j] / ctas for j, k in enumerate(PHASES)}
    print(f"kernel ms {ms:.4f} ({n} tiles of {sb}, extra shared memory "
          f"{args.extra_smem} B) on {card}", flush=True)
    for k, v in clocks.items():
        print(f"  {k}: {v:.0f} clocks per CTA, {v / panels:.0f} per panel",
              flush=True)
    old = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    torch.linalg.inv_ex(a)
    torch.cuda.synchronize()
    s.record()
    for _ in range(3):
        torch.linalg.inv_ex(a)
    e.record()
    torch.cuda.synchronize()
    torch.backends.cuda.preferred_linalg_library(old)
    cus = s.elapsed_time(e) / 3
    print(f"cuSOLVER batched inverse ms {cus:.4f}", flush=True)
    print(json.dumps({"card": card, "tiles": n, "sb": sb,
                      "extra_smem": args.extra_smem, "kernel_ms": ms,
                      "clocks_per_cta": clocks, "cusolver_ms": cus}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
