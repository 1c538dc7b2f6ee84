"""The Krylov update stages (csrc/krylov_update.cu) against a parent
revision's on the card.

Builds the parent's ``navierstokes_tpu_torch/csrc/krylov_update.cu`` (the
file given with ``--parent-source``; ``git show REV:...`` writes it; its C
entry takes (stage, pointers, n, path, stream)) alone with
``kernels/build.NVCC_FLAGS`` into ``build/krylov_update_ab/``.  The parent
is either the CG stages' earlier form, which take their dots as given
(PR 17's), or a copy of this form (its library exports
``nst_krylov_cg_cluster``), for example this source with another cluster
size or CTA shape edited in, launched and checked like the package.  Then,
on the card, with the card's name and power limit on every line:

* **CG's stages** (``cg_xr``, ``cg_p``; fp32 and fp64, at the P1 size of
  the bench point's Poisson solve, n = 113,378, on aligned views and
  views one element off a 16-byte boundary): the package's stage and the
  parent's launches that the stage replaces (cg_xr: cuBLAS ``p @ Ap``,
  the parent's stage, ``torch.linalg.norm(r)``; cg_p:
  ``r @ z``, the parent's stage) in ROUNDS rounds of alternating bursts
  (``chip_smoke._burst_ms``, REPS bursts, the order reversed every other
  round), L2-cold (input sets that exceed twice the L2, cycled) and
  L2-warm (one set); each one's median ms, its rounds, the byte bound of
  the new stage and each one's share of it; the package's stage checked
  against the plain version under ``krylov_update.cg_gate``.
* **One CG iteration** with the identity preconditioner on a SPD
  5-point Laplacian of n unknowns (the SELL kernel's product): the
  product, the stages, the dots, the norm and the predicate of the
  parent (``p @ Ap``, parent ``cg_xr``, ``r @ z``, parent ``cg_p``,
  ``torch.linalg.norm(r)``, ``set_condition``) and of the package
  (product, ``cg_xr``, ``cg_p``, ``set_condition``) captured as one
  CUDA graph while node (kernels/conditional.WhileNodes, the main path's
  form) that runs ITERS iterations, replayed in alternating rounds from
  the same state: ms per iteration, and the kernels one iteration records
  into a graph (``chip_smoke.kernel_launches``).  A revision whose while
  body cannot be captured is reported as such.
* with ``--bicgstab``: the three BiCGStab stages at n = 901,036 against
  the parent's, fp32 and fp64, aligned and offset views, bits compared
  (the comparison the BiCGStab stages' redesign was measured by);
* with ``--scan``: each stage of the package alone (fp32, aligned,
  L2-cold bursts) at n in SCAN times its size, and the fit time = fixed +
  bytes / rate: the fixed cost per launch and the rate it streams at.

Exits 1 if any check fails.  Imports no JAX.

    git show HEAD~1:navierstokes_tpu_torch/csrc/krylov_update.cu \\
        > build/ku_parent.cu
    python3 tools/krylov_update_ab.py --parent-source build/ku_parent.cu \\
        [--bicgstab] [--scan] [--json PATH]
    sed 's/kCluster = 16;/kCluster = 8;/' \\
        navierstokes_tpu_torch/csrc/krylov_update.cu > build/ku_cluster8.cu
    python3 tools/krylov_update_ab.py --parent-source build/ku_cluster8.cu
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
from navierstokes_tpu_torch.kernels.conditional import (  # noqa: E402
    WhileNodes, set_condition)
from navierstokes_tpu_torch.ops.sell import sell_from_coo  # noqa: E402
from navierstokes_tpu_torch.kernels.sell_spmv import sell_spmv  # noqa: E402

OUT = os.path.join(ROOT, "build", "krylov_update_ab")
ROUNDS = 6
REPS = 5
ITERS = 40
BICGSTAB = ("bicgstab_p", "bicgstab_s", "bicgstab_xr")
CG = ("cg_xr", "cg_p")
SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
# the CG stages before they took their own dots: the dots given, and the
# scratch rz_prev
PARENT_ARGS = {"cg_xr": ("x", "r", "p", "ap", "rz", "pap", "rz_prev",
                         "active"),
               "cg_p": ("p", "z", "rz_new", "rz_prev", "rz", "k", "active")}
SCAN = (1 / 8, 1 / 4, 1 / 2, 1, 2, 4)
# the revisions whose CG stages take their dots as given (PR 17's form)
DOTS_GIVEN = set()


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


def entry(lib, dtype):
    """A library's C entry for ``dtype``: (stage, pointers, n, path,
    stream) -> cudaError_t."""
    fn = getattr(lib, f"nst_krylov_update_{SUFFIX[dtype]}")
    p = ctypes.c_void_p
    fn.argtypes = [ctypes.c_int, p, ctypes.c_longlong, ctypes.c_int, p]
    fn.restype = ctypes.c_int
    return fn


def launcher(fn, stage, names, st):
    """A call that launches ``stage`` through the C entry ``fn`` on the
    tensors ``st[name]`` for ``names`` (pointers and path fixed once)."""
    args = [st[name] for name in names]
    ptrs = (ctypes.c_void_p * len(args))(*[t.data_ptr() for t in args])
    way = KU.PATH_NAMES.index(KU.path([t.data_ptr() for name, t in
                                       zip(names, args)
                                       if name in KU.VECTORS]))
    n = st["r"].numel()

    def run():
        rc = fn(KU.STAGES.index(stage), ptrs, n, way,
                torch.cuda.current_stream().cuda_stream)
        CS.check(rc == 0, f"{stage} launch ({rc})")
    return run


def cg_state(stage, n, dt, seed, offset=0):
    """Every tensor either revision's CG stage takes, by name: the
    package's seeded example (``KU.example``) and the parent's scalars
    (pap, rz_new the dots on these vectors, the scratch rz_prev = rz)."""
    st = dict(zip(KU.ARGS[stage], KU.example(
        stage, n, dt, "cuda", np.random.default_rng(seed), offset=offset)))
    if stage == "cg_xr":
        st["rz_prev"] = st["rz"].clone()
    else:
        st["rz_new"] = KU.dot(st["r"], st["z"])
        st["rz_prev"] = st["rz"].clone()
    return st


def sequences(stage, st, fns):
    """name -> one call of the revision's launches for ``stage`` on the
    state ``st``: for a revision in DOTS_GIVEN the dot, its stage (and
    for cg_xr the predicate's norm), for any other its stage."""
    out = {}
    for name, fn in fns.items():
        if name not in DOTS_GIVEN:
            out[name] = launcher(fn, stage, KU.ARGS[stage], st)
            continue
        stage_fn = launcher(fn, stage, PARENT_ARGS[stage], st)
        if stage == "cg_xr":
            rn = torch.empty_like(st["rz"])

            def run(stage_fn=stage_fn, rn=rn):
                torch.dot(st["p"], st["ap"], out=st["pap"])
                stage_fn()
                torch.linalg.vector_norm(st["r"], out=rn)
        else:
            def run(stage_fn=stage_fn):
                torch.dot(st["r"], st["z"], out=st["rz_new"])
                stage_fn()
        out[name] = run
    return out


def cg_stage_ab(stage, dt, offset, fns, card):
    """Checks and alternating timings of one CG stage."""
    n = CS.KRY_N["cg"]
    ok = True
    for name, fn in fns.items():
        if name in DOTS_GIVEN:
            continue
        st = cg_state(stage, n, dt, 1, offset)
        plain = [st[a].clone() for a in KU.ARGS[stage]]
        before = [t.clone() for t in plain]
        launcher(fn, stage, KU.ARGS[stage], st)()
        KU.PLAIN[stage](*plain)
        torch.cuda.synchronize()
        passed, equal, err = KU.cg_gate(
            stage, [st[a] for a in KU.ARGS[stage]], plain, before)
        ok = ok and passed
        print(f"{stage} {dt} offset {offset} {name}: gate "
              f"{'passed' if passed else 'FAILED'}, dots "
              f"{'bit-equal' if equal else 'differ'}, max |kernel - plain| "
              f"{err:.3e}", flush=True)
    reads, writes, flops = CS.KRY_VECTORS[stage]
    size = torch.empty((), dtype=dt).element_size()
    nbytes = (reads + writes) * n * size
    copies = max(2, -(-2 * CS.L2_BYTES // nbytes))
    states = [cg_state(stage, n, dt, 2 + i, offset) for i in range(copies)]
    runs = [sequences(stage, s, fns) for s in states]
    cold = {name: [] for name in fns}
    warm = {name: [] for name in fns}
    for r in range(ROUNDS):
        order = list(fns) if r % 2 == 0 else list(fns)[::-1]
        for name in order:
            cold[name].append(CS._burst_ms([c[name] for c in runs],
                                           reps=REPS))
            warm[name].append(CS._burst_ms([runs[0][name]], reps=REPS))
    peak = CS.FP32_OPS_PER_S if dt == torch.float32 else CS.FP64_OPS_PER_S
    bound = max(nbytes / CS.HBM_BYTES_PER_S, flops * n / peak) * 1e3
    row = dict(stage=stage, dtype=str(dt).replace("torch.", ""),
               offset_bytes=offset * size, n=n, bytes=nbytes, bound_ms=bound,
               gate_passed=ok,
               cold_ms={k: statistics.median(v) for k, v in cold.items()},
               warm_ms={k: statistics.median(v) for k, v in warm.items()},
               cold_rounds=cold, warm_rounds=warm)
    print(f"{stage} {row['dtype']} n={n} offset {row['offset_bytes']} B: "
          + "; ".join(f"{k} {row['cold_ms'][k]:.4f} ms cold "
                      f"({100 * bound / row['cold_ms'][k]:.1f}% of the "
                      f"bound), {row['warm_ms'][k]:.4f} warm"
                      for k in fns)
          + f"; rounds cold {({k: [round(x, 4) for x in v] for k, v in cold.items()})}"
          f"; bound {bound:.4f} ms ({nbytes} bytes); {card}", flush=True)
    return row


def laplacian(n, dt):
    """A SPD 5-point Laplacian on n nodes (rows of 337, the last one
    short), shifted by 0.05, as a SELL pattern and its values."""
    m = 337
    i = np.arange(n)
    rows, cols, vals = [i], [i], [np.full(n, 4.05)]
    for d in (1, m):
        j = i[i + d < n]
        if d == 1:
            j = j[(j % m) != m - 1]
        rows += [j, j + d]
        cols += [j + d, j]
        vals += [np.full(len(j), -1.0)] * 2
    mat, v = sell_from_coo(np.concatenate(rows), np.concatenate(cols),
                           np.concatenate(vals), n, n, "cuda")
    slots = np.zeros(mat.cols.numel())
    slots[mat.nz_slot] = v
    return mat, torch.as_tensor(slots, dtype=dt, device="cuda")


def iteration_ab(dt, fns, card):
    """One CG iteration (identity preconditioner) of each revision under
    one while node that runs ITERS iterations: ms per iteration in
    alternating rounds, and kernels per iteration."""
    n = CS.KRY_N["cg"]
    mat, vals = laplacian(n, dt)
    rng = np.random.default_rng(40)
    b = torch.as_tensor(rng.standard_normal(n), dtype=dt, device="cuda")
    mv = lambda v: sell_spmv(mat, vals, v)
    zero = torch.zeros((), dtype=dt, device="cuda")
    st = dict(x=torch.zeros(n, dtype=dt, device="cuda"), r=b.clone(),
              p=b.clone(), rz=KU.dot(b, b), pap=zero.clone(),
              rnorm=KU.norm(b), rz_new=zero.clone(), rz_prev=zero.clone(),
              k=torch.zeros((), dtype=torch.int64, device="cuda"),
              active=torch.ones((), dtype=torch.bool, device="cuda"),
              rn=zero.clone())
    start = {k: v.clone() for k, v in st.items()}
    target = zero.clone()

    def body(name, cond):
        fn = fns[name]
        ap = mv(st["p"])
        s = dict(st, ap=ap, z=st["r"])
        if name in DOTS_GIVEN:
            torch.dot(st["p"], ap, out=st["pap"])
            launcher(fn, "cg_xr", PARENT_ARGS["cg_xr"], s)()
            torch.dot(st["r"], st["r"], out=st["rz_new"])
            launcher(fn, "cg_p", PARENT_ARGS["cg_p"], s)()
            torch.linalg.vector_norm(st["r"], out=st["rn"])
            res = st["rn"]
        else:
            launcher(fn, "cg_xr", KU.ARGS["cg_xr"], s)()
            launcher(fn, "cg_p", KU.ARGS["cg_p"], s)()
            res = st["rnorm"]
        return set_condition(st["active"], res, target, st["k"], ITERS,
                             cond=cond)

    def restore():
        for k, v in start.items():
            st[k].copy_(v)

    graphs, nodes, kernels, failed = {}, {}, {}, {}
    for name in fns:
        restore()
        kernels[name] = CS.kernel_launches(lambda: body(name, None))[0]
        restore()
        whiles = WhileNodes("cuda")
        tally = torch.zeros(3, dtype=torch.int64, device="cuda")
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        g = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(g, stream=stream), whiles.routed():
                whiles.loop(st["active"], lambda c: body(name, c), tally)
        except RuntimeError as e:
            failed[name] = str(e)
            print(f"iteration {name}: the while body was not captured: {e}",
                  flush=True)
            continue
        graphs[name], nodes[name] = g, whiles
    times = {name: [] for name in graphs}
    ends = {}
    for r in range(ROUNDS):
        order = list(graphs) if r % 2 == 0 else list(graphs)[::-1]
        for name in order:
            reps = []
            for _ in range(REPS):
                restore()
                torch.cuda.synchronize()
                a = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                a.record()
                graphs[name].replay()
                e.record()
                e.synchronize()
                CS.check(int(st["k"]) == ITERS, f"{name}: {int(st['k'])} "
                         f"iterations, not {ITERS}")
                reps.append(a.elapsed_time(e) / ITERS)
            times[name].append(statistics.median(reps))
            ends[name] = float(KU.norm(st["r"]))
    row = dict(dtype=str(dt).replace("torch.", ""), n=n, iterations=ITERS,
               kernels_per_iteration=kernels, capture_failed=failed,
               ms={k: statistics.median(v) for k, v in times.items()},
               rounds=times, final_residual=ends)
    print(f"CG iteration {row['dtype']} n={n}, identity preconditioner, "
          f"under one while node ({ITERS} iterations a replay): "
          + "; ".join(f"{k} {row['ms'][k]:.5f} ms per iteration, "
                      f"{kernels[k]} kernels, ||r|| after {ITERS} "
                      f"{ends[k]:.6e}" for k in times)
          + f"; rounds {({k: [round(x, 5) for x in v] for k, v in times.items()})}"
          f"; {card}", flush=True)
    for g in nodes.values():
        g.close()
    return row


def bicgstab_ab(stage, dt, offset, fns, card):
    """Bits and alternating timings of one BiCGStab stage, dtype and
    offset."""
    n = CS.KRY_N["bicgstab"]
    kern = KU.example(stage, n, dt, "cuda", np.random.default_rng(1),
                      offset=offset)
    names = KU.ARGS[stage]
    runs = {name: [t.clone() for t in kern] for name in fns}
    plain = [t.clone() for t in kern]
    for name, fn in fns.items():
        launcher(fn, stage, names, dict(zip(names, runs[name])))()
    KU.PLAIN[stage](*plain)
    torch.cuda.synchronize()
    bits = all(torch.equal(t, p) for name in fns
               for t, p in zip(runs[name], plain))
    reads, writes, _ = CS.KRY_VECTORS[stage]
    nbytes = (reads + writes) * n * kern[0].element_size()
    copies = max(2, -(-2 * CS.L2_BYTES // nbytes))
    sets = [dict(zip(names, KU.example(stage, n, dt, "cuda",
                                       np.random.default_rng(2 + i),
                                       scalars=CS.KRY_TAME, offset=offset)))
            for i in range(copies)]
    calls = {name: [launcher(fn, stage, names, s) for s in sets]
             for name, fn in fns.items()}
    rounds = {name: [] for name in fns}
    for r in range(ROUNDS):
        order = list(fns) if r % 2 == 0 else list(fns)[::-1]
        for name in order:
            rounds[name].append(CS._burst_ms(calls[name], reps=REPS))
    bound = nbytes / CS.HBM_BYTES_PER_S * 1e3
    ms = {k: statistics.median(v) for k, v in rounds.items()}
    print(f"{stage} {dt} n={n} offset {offset * kern[0].element_size()} B: "
          + "; ".join(f"{k} {v:.4f} ms ({100 * bound / v:.1f}% of the "
                      "bound)" for k, v in ms.items())
          + f"; bound {bound:.4f} ms; bits "
          f"{'equal' if bits else 'DIFFER'}; {card}", flush=True)
    return dict(stage=stage, dtype=str(dt).replace("torch.", ""),
                offset=offset, bits_equal=bits, bound_ms=bound, ms=ms,
                rounds=rounds)


def scan(stage, card):
    """(n, ms, bytes) of the package's stage alone at SCAN times its size
    (fp32, aligned, L2-cold bursts), and the least-squares fit of ms on
    bytes: (fixed us, GB/s)."""
    reads, writes, _ = CS.KRY_VECTORS[stage]
    size = CS.KRY_N[stage.split("_")[0]]
    pts = []
    for f in SCAN:
        n = int(size * f)
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
    print(f"scan {stage} float32 (n, ms, bytes): {pts}; fit: "
          f"{icpt * 1e3:.2f} us fixed per launch + bytes at "
          f"{1e-6 / slope:.0f} GB/s; {card}", flush=True)
    return dict(points=pts, fixed_us=icpt * 1e3, gb_s=1e-6 / slope)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-source", required=True)
    ap.add_argument("--bicgstab", action="store_true")
    ap.add_argument("--scan", action="store_true")
    ap.add_argument("--json")
    args = ap.parse_args()
    CS.check(torch.cuda.is_available(), "needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    with open(args.parent_source, "rb") as f:
        libs = {"parent": build(f.read())}
    from navierstokes_tpu_torch.kernels.build import library
    libs["kernel"] = library()
    for name, lib in libs.items():
        if hasattr(lib, "nst_krylov_cg_cluster"):
            print(f"{name}: CG stages in one cluster of "
                  f"{lib.nst_krylov_cg_cluster()} CTAs", flush=True)
        else:
            DOTS_GIVEN.add(name)
            print(f"{name}: CG stages with their dots given", flush=True)
    out = dict(card=card, cg=[], iteration=[], bicgstab=[], scan={})
    for dt in (torch.float32, torch.float64):
        fns = {name: entry(lib, dt) for name, lib in libs.items()}
        for stage in CG:
            for offset in (0, 1):
                out["cg"].append(cg_stage_ab(stage, dt, offset, fns, card))
        out["iteration"].append(iteration_ab(dt, fns, card))
        if args.bicgstab:
            bf = {k: fns[k] for k in ("parent", "kernel")}
            for stage in BICGSTAB:
                for offset in (0, 1):
                    out["bicgstab"].append(bicgstab_ab(stage, dt, offset, bf,
                                                       card))
    if args.scan:
        for stage in KU.STAGES:
            out["scan"][stage] = scan(stage, card)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    ok = (all(r["gate_passed"] for r in out["cg"])
          and all(r["bits_equal"] for r in out["bicgstab"])
          and "kernel" not in out["iteration"][0]["capture_failed"])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
