"""The paths of the presorted segment sum on the step's three plans.

    python3 tools/segment_plan_timing.py [--small]

``ops/operators.SegmentPlan`` sums each target's entries in input order
either in gather-add passes (one pass per rank, for plans whose targets
have at most ``MAX_PASSES`` entries), with ``torch.segment_reduce`` or,
on the card, in length buckets (a CUDA graph can capture them).
This script builds each plan of the step all three ways and times them on the
card at the bench point (``chip_smoke.py``'s configuration under
``scheme="monolithic"``, ``preconditioner="asimple"``, so that the Schur
coarse assembly's plan exists): the convection plan (element entries ->
F slots), the PCD pressure-convection plan (element entries -> P1-P1
slots) and the Schur coarse plan (G block pairs -> coarse matrix
entries).  For each it prints the entry count, the entries per target
(max, 99th percentile, median), the number of passes, the median
L2-cold device time of each path (CUDA events, a 128 MB read before each
call), the largest difference between the results and whether a
repeated ``segment_reduce`` gives the same bits.  ``--small``
uses the h=0.1 cylinder channel instead of the bench mesh.

The last line is one JSON object with these numbers.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "?"


def model(small, work):
    from navierstokes_tpu_torch.config import InletConfig, SolverConfig
    from navierstokes_tpu_torch.mesh.generators import (
        channel_with_cylinder_2d)
    from navierstokes_tpu_torch.mesh.geometry import Mesh
    from navierstokes_tpu_torch.models.navier_stokes import NavierStokes
    cfg = SolverConfig(dtype="float32", output_dir=os.path.join(work, "out"),
                       cache_dir=os.path.join(work, "cache"),
                       csv_path=os.path.join(work, "forces.csv"),
                       scheme="monolithic", preconditioner="asimple")
    if small:
        mesh = channel_with_cylinder_2d(h=0.1, h_near=0.04)
    else:
        z = np.load(os.path.join(ROOT, ".bench_mesh.npz"))
        mesh = Mesh(2, z["points"], z["cells"], z["bfaces"], z["btags"])
    ns = NavierStokes(mesh, 2, 1, deltat=0.00125, T=1.0, step=10,
                      inlet=InletConfig(kind="parabolic", u_m=1.5,
                                        height=0.41, ramp=0.05),
                      config=cfg, device="cuda")
    ns.set_re_number(100)
    return ns.setup()


def plan_ids(ns):
    """name -> (target of each entry, number of targets), as the model's
    builders (ops/bsr.build_bsr, solvers/schur.build_coarse_plan) make
    them."""
    from navierstokes_tpu_torch.ops.sell import unique_pairs
    e, sp = ns.ell, ns.space
    cp2 = np.asarray(sp.cell_p2, np.int64)
    cp1 = np.asarray(sp.cell_p1, np.int64)
    nv, npp = cp2.shape[1], cp1.shape[1]
    _, _, inv = unique_pairs(np.repeat(cp2, nv, axis=1).reshape(-1),
                             np.tile(cp2, (1, nv)).reshape(-1), sp.n_p2)
    _, _, pinv = unique_pairs(np.repeat(cp1, npp, axis=1).reshape(-1),
                              np.tile(cp1, (1, npp)).reshape(-1), sp.n_p1)
    plan = ns._coarse_plan
    agg_blocks = plan.agg // e.bp
    a_cols = np.asarray(e.host.g_cols_full, np.int64) // agg_blocks
    pairs = (a_cols[:, :, None] * plan.n_agg + a_cols[:, None, :]).reshape(-1)
    return {"convection -> F": (e.f.nz_slot[inv], e.f.n_slots),
            "PCD convection -> PP": (e.pp.nz_slot[pinv], e.pp.n_slots),
            "Schur coarse pairs": (pairs, plan.n_agg * plan.n_agg)}


def time_ms(fn, n):
    flush = torch.ones(32 << 20, dtype=torch.float32, device="cuda")
    fn()
    times = []
    for _ in range(n):
        flush.sum()
        torch.cuda._sleep(200_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("segment_plan_timing: no CUDA device", file=sys.stderr)
        return 2
    from navierstokes_tpu_torch.ops import operators
    card = card_line()
    ns = model(args.small, os.path.join(ROOT, "build", "segment_plans"))
    rng = np.random.default_rng(7)
    out = []
    for name, (ids, n_targets) in plan_ids(ns).items():
        lengths = np.bincount(ids, minlength=n_targets)
        live = lengths[lengths > 0]
        vals = torch.as_tensor(rng.standard_normal(len(ids)),
                               dtype=torch.float32, device="cuda")
        row = dict(plan=name, entries=len(ids), targets=int(n_targets),
                   max=int(live.max()), p99=float(np.percentile(live, 99)),
                   median=float(np.median(live)))
        saved = operators.MAX_PASSES
        try:
            operators.MAX_PASSES = 0
            reduce_plan = operators.segment_plan(ids, n_targets, "cuda",
                                                 buckets=False)
            bucket_plan = operators.segment_plan(ids, n_targets, "cuda")
            operators.MAX_PASSES = 1 << 62
            t0 = time.perf_counter()
            passes_plan = operators.segment_plan(ids, n_targets, "cuda")
            row["passes_build_s"] = time.perf_counter() - t0
        finally:
            operators.MAX_PASSES = saved
        row["passes"] = len(passes_plan.passes)
        row["segment_reduce_ms"] = time_ms(lambda: reduce_plan(vals), 30)
        n = 30 if row["passes"] <= 1000 else 3
        row["passes_ms"] = time_ms(lambda: passes_plan(vals), n)
        row["buckets_ms"] = time_ms(lambda: bucket_plan(vals), 30)
        ya, yb, yc = reduce_plan(vals), passes_plan(vals), bucket_plan(vals)
        row["max_abs_diff"] = float((ya - yb).abs().max())
        row["buckets_max_abs_diff"] = float((ya - yc).abs().max())
        row["max_abs"] = float(ya.abs().max())
        row["segment_reduce_repeat_equal"] = bool(
            torch.equal(ya, reduce_plan(vals)))
        out.append(row)
        print(f"{name}: {row['entries']} entries into {row['targets']} "
              f"targets, per target max {row['max']} p99 {row['p99']:.0f} "
              f"median {row['median']:.0f}; segment_reduce "
              f"{row['segment_reduce_ms']:.4f} ms, {row['passes']} passes "
              f"{row['passes_ms']:.4f} ms (built in "
              f"{row['passes_build_s']:.1f} s), "
              f"{len(bucket_plan.buckets)} buckets "
              f"{row['buckets_ms']:.4f} ms; max |diff| of the passes "
              f"{row['max_abs_diff']:.3e}, of the buckets "
              f"{row['buckets_max_abs_diff']:.3e}, of max |y| "
              f"{row['max_abs']:.3e}; "
              f"segment_reduce repeat bit-identical "
              f"{row['segment_reduce_repeat_equal']} on {card}", flush=True)
        del passes_plan, reduce_plan, bucket_plan
    print(json.dumps({"card": card, "small": args.small, "plans": out}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
