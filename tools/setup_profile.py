"""cProfile of a model's host setup: where the time to the first step goes.

    python3 tools/setup_profile.py [--case 3d1] [--h 0.023] [--h-near 0.007]
                                   [--device cuda] [--top 20]

Profiles ``scenarios.validate.build_case(case, projection=True,
f_precond="diag", h=H, h_near=H_NEAR)`` as a whole: the mesh generator
and ``NavierStokes.setup`` (with the defaults, 3D-1Z at 3,393,382 DoF,
the run of ``validate 3d1 --projection --f-precond diag``).  It prints
the profiled wall seconds and the share of the three host passes that
the JAX package can hand to its C++ meshkit
(``navierstokes_tpu/native/meshkit.cpp``) and the port runs in numpy:

* unique edges: ``np.unique`` and ``_encode_pairs`` under
  ``TaylorHoodSpace.__init__`` (JAX ``fem/spaces.py:197-201``);
* boundary facets: ``Mesh.compute_boundary_faces`` (JAX
  ``mesh/geometry.py:177-178``);
* scatter-plan argsorts: ``np.argsort`` under
  ``ops/operators.segment_plan`` (JAX ``ops/operators.py:43-44``);

then the port's functions by cumulative time and every function by its
own time.  The last line is one JSON object with these numbers.
"""

import argparse
import cProfile
import json
import os
import pstats
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
PORT = os.path.join("navierstokes_tpu_torch", "")


def card_line():
    if not torch.cuda.is_available():
        return "no CUDA device"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _short(key):
    path, line, name = key
    if PORT in path:
        path = path[path.index(PORT):]
    else:
        path = os.path.basename(path)
    return f"{path}:{line}({name})"


def _under(stats, name, caller_file, caller_name):
    """Seconds (cumulative) spent in functions called ``name`` when called
    from ``caller_name`` in a file ending with ``caller_file``."""
    total = 0.0
    for (path, _, fn), (_, _, _, _, callers) in stats.items():
        if fn != name:
            continue
        for (cpath, _, cname), vals in callers.items():
            if cpath.endswith(caller_file) and cname == caller_name:
                total += vals[3]
    return total


def _cumulative(stats, file_end, name):
    return sum(v[3] for (path, _, fn), v in stats.items()
               if path.endswith(file_end) and fn == name)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--case", default="3d1")
    ap.add_argument("--h", type=float, default=0.023)
    ap.add_argument("--h-near", type=float, default=0.007)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args()
    from navierstokes_tpu_torch.scenarios.validate import build_case
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    ns = build_case(args.case, device=args.device, projection=True,
                    f_precond="diag", h=args.h, h_near=args.h_near,
                    out=os.path.join(ROOT, "build", "setup_profile"))
    if ns.device.type == "cuda":
        torch.cuda.synchronize()
    prof.disable()
    wall = time.perf_counter() - t0
    stats = pstats.Stats(prof).stats
    spaces = os.path.join("fem", "spaces.py")
    passes = {
        "unique edges": _under(stats, "unique", spaces, "__init__")
        + _under(stats, "_encode_pairs", spaces, "__init__"),
        "boundary facets": _cumulative(
            stats, os.path.join("mesh", "geometry.py"),
            "compute_boundary_faces"),
        "scatter-plan argsorts": _under(
            stats, "argsort", os.path.join("ops", "operators.py"),
            "segment_plan"),
    }
    plan_total = _cumulative(stats, os.path.join("ops", "operators.py"),
                             "segment_plan")
    port = sorted(((v[3], _short(k)) for k, v in stats.items()
                   if PORT in k[0]), reverse=True)[:args.top]
    own = sorted(((v[2], _short(k)) for k, v in stats.items()),
                 reverse=True)[:args.top]
    card = card_line()
    print(f"{args.case} h={args.h} h_near={args.h_near}: "
          f"{ns.space.n_dofs} DoF, setup {wall:.1f} s under cProfile on "
          f"{card}")
    for name, sec in passes.items():
        print(f"  meshkit pass {name}: {sec:.3f} s ({100 * sec / wall:.2f}%)")
    print(f"  segment_plan in all: {plan_total:.3f} s")
    print("  the port's functions by cumulative seconds:")
    for sec, name in port:
        print(f"    {sec:9.3f}  {name}")
    print("  every function by own seconds:")
    for sec, name in own:
        print(f"    {sec:9.3f}  {name}")
    print(json.dumps({
        "case": args.case, "h": args.h, "h_near": args.h_near,
        "n_dofs": ns.space.n_dofs, "setup_s": wall,
        "meshkit_passes_s": passes,
        "meshkit_share": sum(passes.values()) / wall,
        "segment_plan_s": plan_total,
        "top_cumulative": [[n, s] for s, n in port],
        "top_own": [[n, s] for s, n in own], "card": card}))


if __name__ == "__main__":
    main()
