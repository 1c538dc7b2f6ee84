"""Build and load the hand-written CUDA kernels.

Every ``navierstokes_tpu_torch/csrc/*.cu`` file is compiled by ``nvcc``
for ``sm_90a``, one process per source, all started together, and the
objects are linked into one shared library with a plain C interface, at
first use, and loaded with ``ctypes``.  The library lands in ``build/kernels/``
at the repository root (git-ignored) under a name that hashes the sources,
the headers they share (``csrc/*.cuh``) and the flags, so an edited source
or header rebuilds and an unchanged tree loads the existing file.  There
is no fallback: without ``nvcc`` the build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@functools.lru_cache(maxsize=1)
def build_info() -> dict:
    """Compile (if needed) and load the kernel library.

    Returns ``{"lib": CDLL, "path": str, "seconds": float, "log": str}``;
    ``seconds`` is the compile time of this call (0.0 when the library
    was already built) and ``log`` the compiler's ``-Xptxas -v`` output."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    lib_path = BUILD_DIR / f"libnst_kernels_{h.hexdigest()[:16]}.so"
    seconds, log = 0.0, ""
    if not lib_path.exists():
        nvcc = _find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
        objs = [BUILD_DIR / f"{s.stem}.{tag}.o" for s in sources]
        t0 = time.perf_counter()
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o),
                                   str(s)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(sources, objs)]
        outs = [p.communicate()[0] for p in procs]
        log = "".join(outs)
        failed = [s.name for s, p in zip(sources, procs) if p.returncode]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        seconds = time.perf_counter() - t0
        log += proc.stdout + proc.stderr
        for o in objs:
            o.unlink(missing_ok=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{log}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    p, i = ctypes.c_void_p, ctypes.c_int
    for entry in ("nst_sell_spmv_f32", "nst_sell_spmv_bf16",
                  "nst_sell_spmv_f64"):
        fn = getattr(lib, entry)
        fn.argtypes = [p, p, p, p, p, p, i, i, p]
        fn.restype = i
    for suffix in ("f32", "bf16"):
        fn = getattr(lib, f"nst_bj_apply_{suffix}")
        fn.argtypes = [p, p, p, i, i, i, i, p]
        fn.restype = i
    lib.nst_bj_apply_f64.argtypes = [p, p, p, i, i, i, i, i, i, p]
    lib.nst_bj_apply_f64.restype = i
    lib.nst_bj_apply_f64_setup.argtypes = [i, i, ctypes.POINTER(i)]
    lib.nst_bj_apply_f64_setup.restype = i
    # the tile rebuild: the masked tiles, the guard's max of its partials
    for suffix in ("f32", "f64"):
        fn = getattr(lib, f"nst_bj_tiles_{suffix}")
        fn.argtypes = [p] * 7 + [i, i, i, p]
        fn.restype = i
    lib.nst_bj_guard_max.argtypes = [p, i, p, p]
    lib.nst_bj_guard_max.restype = i
    # the Newton-Schulz products: operands, output (partials), sb, n_tiles,
    # the operands' layouts (update: out_kind, the out's tile and row
    # strides), the stream
    lib.nst_bj_gemm_product.argtypes = [p, p, p, i, i, i, i, p]
    lib.nst_bj_gemm_product.restype = i
    lib.nst_bj_gemm_guard.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.nst_bj_gemm_guard.restype = i
    i64 = ctypes.c_longlong
    lib.nst_bj_gemm_update.argtypes = [p, p, p, i, i, i, i, i, i64, i64, p]
    lib.nst_bj_gemm_update.restype = i
    lib.nst_bj_gemm_ctas.argtypes = [i, i]
    lib.nst_bj_gemm_ctas.restype = i
    lib.nst_bj_gemm_occupancy.argtypes = [i, i, ctypes.POINTER(i)]
    lib.nst_bj_gemm_occupancy.restype = i
    # the exact tile inverse: tiles, out, sb, n_tiles, out_kind, the out's
    # tile and row strides, the stream; the clusters the card holds at once
    lib.nst_bj_inverse.argtypes = [p, p, i, i, i, ctypes.c_longlong, i, p]
    lib.nst_bj_inverse.restype = i
    lib.nst_bj_inverse_occupancy.argtypes = [i, ctypes.POINTER(i)]
    lib.nst_bj_inverse_occupancy.restype = i
    u64, i64 = ctypes.c_ulonglong, ctypes.c_longlong
    for suffix in ("f32", "f64"):
        fn = getattr(lib, f"nst_lsq_update_{suffix}")
        fn.argtypes = [p] * 12 + [i, p, u64, i, p]
        fn.restype = i
        fn = getattr(lib, f"nst_set_condition_{suffix}")
        fn.argtypes = [p, u64, i, p, p, p, p, i64, p, p]
        fn.restype = i
    for suffix in ("f32", "f64"):
        fn = getattr(lib, f"nst_krylov_update_{suffix}")
        fn.argtypes = [i, p, i64, i, p]
        fn.restype = i
        fn = getattr(lib, f"nst_gram_schmidt_{suffix}")
        fn.argtypes = [p, i64, p, i] + [p] * 5 + [p, i, p, i64] + [p] * 2 \
            + [i, i64, i, p]
        fn.restype = i
        fn = getattr(lib, f"nst_gram_schmidt_setup_{suffix}")
        fn.argtypes = [ctypes.POINTER(i)]
        fn.restype = i
    # the V-cycle's sweeps: the plan (grid, rounds, shared, smem), the SELL
    # arrays (vals, cols, slice_ptr, rows, n_slices), the vectors, the
    # state vector, the progress words and neighbour lists, the stream
    head = [i] * 4 + [p] * 4 + [i]
    for suffix in ("f32", "f64"):
        for entry, args in (("pre", [p] * 3 + [i] + [p] * 4),
                            ("mid", [p] * 4 + [i, i] + [p] * 5),
                            ("post", [p] * 4 + [i, i] + [p] * 4)):
            fn = getattr(lib, f"nst_vcycle_{entry}_{suffix}")
            fn.argtypes = head + args + [p] * 5
            fn.restype = i
        fn = getattr(lib, f"nst_vcycle_setup_{suffix}")
        fn.argtypes = [i, i, i, ctypes.POINTER(i)]
        fn.restype = i
    lib.nst_krylov_cg_cluster.argtypes = []
    lib.nst_krylov_cg_cluster.restype = i
    lib.nst_while_begin.argtypes = [p, p, p, p, ctypes.POINTER(u64),
                                    ctypes.POINTER(i)]
    lib.nst_while_begin.restype = i
    lib.nst_while_end.argtypes = [p]
    lib.nst_while_end.restype = i
    lib.nst_stream_create.argtypes = [ctypes.POINTER(p)]
    lib.nst_stream_create.restype = i
    lib.nst_cuda_error_string.argtypes = [i]
    lib.nst_cuda_error_string.restype = ctypes.c_char_p
    return {"lib": lib, "path": str(lib_path), "seconds": seconds,
            "log": log}


def library() -> ctypes.CDLL:
    return build_info()["lib"]


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    toolkit = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                           "bin", "nvcc")
    if nvcc is None and os.path.exists(toolkit):
        nvcc = toolkit
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of navierstokes_tpu_torch are "
            "built from source at first use and need the CUDA toolkit")
    return nvcc


def nvcc_release() -> str:
    """The ``release ...`` line of ``nvcc --version``."""
    out = subprocess.run([_find_nvcc(), "--version"], capture_output=True,
                         text=True).stdout
    lines = [ln for ln in out.splitlines() if "release" in ln]
    return lines[0].strip() if lines else out.strip()
