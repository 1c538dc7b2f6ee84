"""Device time of the V-cycle's sweeps (csrc/vcycle.cu) by sweep, k and
operator path, and the cost of one stage, on the card.

    python3 tools/vcycle_sweep_cost.py [--ks 1 2 3 4] [--rounds 2]
        [--json PATH]

On the bench point's outlet-pinned P1 Laplacian (n = 113,378, as
``chip_smoke.bench_model`` builds it), fp32: per (path, sweep, k) a CUDA
graph of GRAPH_CALLS launches on seeded inputs (``vcycle.example``),
replayed in bursts (``chip_smoke._burst_ms``), the median per launch over
``--rounds`` rounds.  Printed per path: each sweep's us at each k, and the
slope over k of a least-squares line (us per stage: one stage and one
barrier for pre and post, half the mid sweep's slope), with the card's
name and power limit.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAPH_CALLS = 20


def times(op, agg, ks):
    """{f"{path} {kind} {k}": us per launch} on ``op``."""
    import numpy as np
    import torch

    import chip_smoke as CS
    from navierstokes_tpu_torch.kernels import vcycle as VC
    out = {}
    for path in VC.PATHS:
        sp = VC.plan(op, path)
        for k in ks:
            ex = VC.example(op, np.random.default_rng(1), k=k, agg=agg)
            b = {n: ex[n].clone() for n in VC.BUFFERS}
            for kind in VC.SWEEPS:
                fn = lambda: VC.run_case(kind, op, ex, sp, into=b)
                s = torch.cuda.Stream()
                s.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(s):
                    fn()
                torch.cuda.current_stream().wait_stream(s)
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    for _ in range(GRAPH_CALLS):
                        fn()
                out[f"{path} {kind} {k}"] = 1e3 * CS._burst_ms(
                    [g.replay], reps=7) / GRAPH_CALLS
    return out


def slope(ks, ys):
    mk, my = statistics.mean(ks), statistics.mean(ys)
    return (sum((k - mk) * (y - my) for k, y in zip(ks, ys))
            / sum((k - mk) ** 2 for k in ks))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ks", nargs="+", type=int, default=[1, 2, 3, 4])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--json")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as CS
    if not torch.cuda.is_available():
        print("vcycle_sweep_cost: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = CS.card_line()
    ns = CS.bench_model("cuda").setup()
    op, agg = ns._ap_dir, ns._coarse_plan.agg
    del ns
    torch.cuda.empty_cache()
    runs = [times(op, agg, args.ks) for _ in range(args.rounds)]
    med = {key: statistics.median(r[key] for r in runs) for key in runs[0]}
    for path in ("shared", "device"):
        parts = []
        for kind in ("pre", "mid", "post"):
            ys = [med[f"{path} {kind} {k}"] for k in args.ks]
            per = slope(args.ks, ys) / (2 if kind == "mid" else 1)
            parts.append(f"{kind} " + " ".join(f"{y:.2f}" for y in ys)
                         + f" (slope {per:.2f} us a stage)")
        print(f"[vcycle_sweep_cost] {path}, us at k = {args.ks}: "
              + "; ".join(parts) + f" on {card}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": card, "us": med, "rounds": runs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
