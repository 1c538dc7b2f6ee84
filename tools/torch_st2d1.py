"""Schaefer-Turek 2D-1 in P3/P2 through the port's NavierStokes, on one GPU.

    python3 tools/torch_st2d1.py [--dtype float64] [--T 4.0]
        [--restart-step N] [--output-step N] [--out DIR]

The case of ``scripts/validate_st.py 2d1`` in ``NavierStokes(mesh, 3,
2)``, as ``tools/torch_step_profile.py``'s ``model_2d1`` builds it
(654,022 DoF): the generic element ("cells") operator with aSIMPLE,
diagonal F scaling and no refinement; the cylinder stays polygonal, since
snapping is P2 geometry; FGMRES unrestarted within a budget of 400
(``OUTER_MAXITER_2D1`` says why).

``NavierStokes.solve`` writes ``<out>/forces_<restart>.csv`` (one row per
step), checkpoints every ``--output-step`` steps into ``<out>/cache`` and
VTUs into ``<out>/out``; ``--restart-step N`` continues from the
checkpoint of step N in ``<out>/cache``.  At the end it prints the settled
Cd and Cl (the mean over the last 10% of the steps, from all
``forces_*.csv`` in ``<out>``, as ``validate_st.py`` reports 2D-1) against
the published band, the setup seconds, steps/s, FGMRES iterations, peak
device memory and the card's name and power limit; the last line is one
JSON object with these numbers.
"""

import argparse
import glob
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

from torch_step_profile import (OUTER_MAXITER_2D1, card_line,  # noqa: E402
                                model_2d1)


def settled(out_dir, n_total):
    """(rows, Cd, Cl): every step's csv row from ``out_dir`` (a restart's
    rows replace the earlier ones from its step on) and the mean Cd and Cl
    over the last 10% of ``n_total`` steps (None until they are all
    there)."""
    from navierstokes_tpu_torch.utils.analysis import load_forces
    by_step = {}
    for path in sorted(glob.glob(os.path.join(out_dir, "forces_*.csv")),
                       key=lambda p: int(p.rsplit("_", 1)[1][:-4])):
        for r in load_forces(path):
            by_step[int(round(r["time"] / r["deltat"]))] = r
    rows = [by_step[k] for k in sorted(by_step)]
    if sorted(by_step) != list(range(1, n_total + 1)):
        return rows, None, None
    tail = rows[n_total - max(1, n_total // 10):]
    return (rows, float(np.mean([r["Cd"] for r in tail])),
            float(np.mean([r["Cl"] for r in tail])))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", default="float64",
                    choices=["float32", "float64"])
    ap.add_argument("--T", type=float, default=4.0)
    ap.add_argument("--restart-step", type=int, default=0)
    ap.add_argument("--output-step", type=int, default=200)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "st2d1"))
    args = ap.parse_args()
    card = card_line()
    os.makedirs(args.out, exist_ok=True)
    t0 = time.perf_counter()
    ns = model_2d1(args.out, dtype=args.dtype, T=args.T,
                   step=args.output_step,
                   csv_name=f"forces_{args.restart_step}.csv")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t0
    print(f"[st2d1] P3/P2 {args.dtype}: {ns.space.n_dofs} DoF on "
          f"{ns.config.operator}, setup {setup_s:.1f} s", flush=True)
    t0 = time.perf_counter()
    ns.solve(time_step=args.restart_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    n_total = int(np.floor(args.T / 0.01 + 0.5))
    n_run = n_total - args.restart_step
    rows, cd, cl = settled(args.out, n_total)
    its = [int(r["GMRES_iters"]) for r in rows]
    print(f"[st2d1] {n_run} steps in {wall:.1f} s ({n_run / wall:.4f} "
          f"steps/s), peak {peak} bytes, on {card}", flush=True)
    print(f"[st2d1] FGMRES iterations per step: {' '.join(map(str, its))}",
          flush=True)
    if cd is not None:
        print(f"[st2d1] settled (last 10%): Cd = {cd:.4f} (band 5.57-5.59), "
              f"Cl = {cl:.4f} (band 0.0104-0.0110)", flush=True)
    print(json.dumps({
        "dtype": args.dtype, "n_dofs": ns.space.n_dofs,
        "card": card, "setup_s": setup_s, "steps": n_run, "seconds": wall,
        "steps_per_s": n_run / wall, "peak_bytes": peak,
        "iterations": its, "max_iterations": max(its) if its else None,
        "budget": OUTER_MAXITER_2D1, "cd": cd, "cl": cl,
        "final_cd": float(rows[-1]["Cd"]) if rows else None,
        "final_cl": float(rows[-1]["Cl"]) if rows else None}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
