"""Schaefer-Turek benchmark validation runs of the port.

    python -m navierstokes_tpu_torch.scenarios.validate [case] [--h H]
        [--projection] [--device cpu] ...

  case: 2d1 (Re=20 steady) | 2d2 (Re=100 vortex shedding)
      | 3d1 (3D-1Z square column, Re=20 steady)
      | bench (2D-2 on the 1,014,414-DoF bench mesh)

The port's copy of the JAX repo's ``scripts/validate_st.py``: the same
three cases with the same meshes, inlets, time steps and solver settings
(nu=1e-3, ``ref_length=0.1``, the Schaefer-Turek force formula, budgets
100 BiCGStab / 50 CG, ``inner_maxiter_f=10``, a checkpoint every 400
steps), and the same statistics against the published intervals
(2D-1: Cd 5.57-5.59, Cl 0.0104-0.0110 over the last 10%; 2D-2: Cd_max
3.22-3.24, Cl_max 0.99-1.01 over the last 40%, St 0.295-0.305; 3D-1Z:
Cd 7.5-7.7, Cl 0.06-0.08 over the last 40%).

The case ``bench`` is the port of the JAX repo's
``scripts/validate_bench.py``: the physics-validated scheme (projection
BDF2, rotational pressure update) on the committed bench mesh
``.bench_mesh.npz`` (1,014,414 DoF) with true 2D-2 physics (nu=1e-3,
parabolic U_m=1.5 with a ramp of 0.1, ``ref_length=0.1``, the
Schaefer-Turek force formula), fp32 on the card, dt=0.00125 to T=8, a
checkpoint every 1,600 steps and the SolverConfig defaults otherwise (not
the budgets above); its statistics are Cd_max and Cl_max over t > 0.75 T
and St from the FFT of Cl over the last 25% of the rows
(``u_mean=1.0``), against 3.22-3.24 / 0.99-1.01 / 0.295-0.305.  Its
environment variables map to the flags: DT to ``--dt``, T to ``--T``,
RESTART to ``--restart-step``, OUT_EVERY to ``--output-step``, CSV to
``--csv``, CACHE to ``--out``; RAMP stays 0.1, and NS_OVERRIDES (a JSON
of SolverConfig fields) is left out.  ``--projection``, ``--h`` and the
mesh and solver flags do not apply to it (the driver refuses them; its
record's ``h`` is null).

Differences from the JAX scripts:

* ``--device`` (default ``cuda``, fp32; raises without a card) takes the
  place of ``--cpu``; ``--device cpu`` runs in float64 as ``--cpu`` did,
  and ``--dtype`` overrides either (float64 on the card).
* ``--steps-per-chunk`` is dropped: it capped the length of a jitted
  ``lax.scan`` chunk, a limit of TPU executables.  The port runs chunks
  of the output interval (``NavierStokes.solve``, on the card from
  captured CUDA graphs under ``--projection``), as the JAX script does
  without the cap; each step's line comes after its chunk, with the
  chunk's wall time per step.
* ``--degree 3`` (2d1 only) runs the case in P3/P2 on the generic element
  ("cells") operator, with FGMRES unrestarted within OUTER_MAXITER_2D1.
* ``--restart-step N`` continues from the checkpoint of step N in
  ``<out>/cache`` (``NavierStokes.solve(time_step=N)``); each leg writes
  ``<out>/forces_<N>.csv``, and the statistics come from all legs merged
  by step, a later leg's rows replacing the earlier ones from its step on.
  The merged trace is ``<out>/forces.csv`` (and ``--csv``, if given),
  written once every step of the run is there.
* The "HBM after setup" line reports ``torch.cuda.max_memory_allocated``,
  and the last line is one JSON object: the case, DoF, setup seconds,
  steps/s, peak bytes, Krylov iterations, SELL launches per step by
  (dtype, D), the exact block-Jacobi inversions, the statistics and the
  card's name and power limit.

Nothing runs at import; ``build_case`` builds any case for the tests,
``chip_smoke.py`` and ``tools/torch_step_profile.py``.
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

CASES = ("2d1", "2d2", "3d1", "bench")
# FGMRES budget and restart length of 2D-1 on the cells operator: P3/P2 at
# 654,022 DoF does not converge within 400 iterations at the default restart
# of 64, in fp32 or float64; unrestarted it takes 202 and 290 at steps 1-2
# (H100).
OUTER_MAXITER_2D1 = 400
REF_LENGTH = 0.1
U_MEAN_2D2 = 2.0 * 1.5 / 3.0
# the bench case: the committed mesh, its checkpoint interval (OUT_EVERY)
# and the start of its statistics window (as a fraction of T)
BENCH_MESH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                          "..", ".bench_mesh.npz")
BENCH_OUTPUT_STEP = 1600
BENCH_TAIL = 0.75
# the driver's mesh and solver flags, which the bench case refuses
BENCH_FIXED = ("h", "hnear", "projection", "refine", "no_curved",
               "wake_levels", "bsr_block", "f_precond", "proj_poisson")


def case_defaults(case):
    """(inlet, dt, T) of ``case``, as validate_st.py sets them."""
    from navierstokes_tpu_torch.config import InletConfig
    if case == "3d1":
        # ST 3D-1Z: bi-parabolic inlet U_m=0.45 (the reference's
        # tests/3D/test_01/src/test_01.cpp:15,24), TRUE Re = 0.2*0.1/1e-3
        return InletConfig(kind="biparabolic", u_m=0.45, height=0.41), \
            0.01, 3.0
    if case == "2d1":
        # T=6: the start-up Cl oscillation decays by ~t=4.5
        return InletConfig(kind="parabolic", u_m=0.3, height=0.41), 0.01, 6.0
    if case == "2d2":
        return InletConfig(kind="parabolic", u_m=1.5, height=0.41), \
            0.0025, 8.0
    if case == "bench":
        return InletConfig(kind="parabolic", u_m=1.5, height=0.41,
                           ramp=0.1), 0.00125, 8.0
    raise ValueError(f"unknown case {case!r}; one of {CASES}")


def case_mesh(case, h=0.015, h_near=None, h_z=None, wake_levels=None):
    """The case's mesh: the committed bench mesh, the 3D-1Z duct, or the
    2D cylinder channel with h_near = h/3 and one wake level for 2d2
    unless given."""
    from navierstokes_tpu_torch.mesh import (channel_with_cylinder_2d,
                                             duct_with_box_obstacle_3d)
    if case == "bench":
        from navierstokes_tpu_torch.mesh.geometry import Mesh
        with np.load(BENCH_MESH) as z:
            return Mesh(2, z["points"], z["cells"], z["bfaces"], z["btags"])
    if case == "3d1":
        return duct_with_box_obstacle_3d(h=h, h_near=h_near, h_z=h_z)
    wl = wake_levels if wake_levels is not None else (
        1 if case == "2d2" else 0)
    return channel_with_cylinder_2d(h=h, h_near=h_near or h / 3,
                                    wake_levels=wl)


def build_case(case, *, device="cuda", dtype=None, h=0.015, h_near=None,
               h_z=None, T=None, dt=None, projection=False, refine=0,
               curved=True, wake_levels=None, bsr_block=0, f_precond="bj",
               proj_poisson="laplacian", degree=2, out=None,
               csv_name="forces_0.csv", output_step=None, setup=True,
               shard_devices=None, **fields):
    """The NavierStokes model of ``case`` as validate_st.py builds it, set
    up (unless ``setup=False``) on ``device``: nu=1e-3 set directly (no
    ``set_re_number``), float64 on the CPU and fp32 on the card unless
    ``dtype`` says otherwise; checkpoints every ``output_step`` steps
    (default 400, the bench case 1,600) into ``<out>/cache``, VTUs into
    ``<out>/out`` and the csv ``<out>/csv_name``; ``shard_devices`` places
    the ``n_devices`` shards (NavierStokes).  The bench case is
    validate_bench.py's configuration (the module docstring) and takes
    none of the mesh and solver arguments.
    ``degree=3`` (2d1 only) is P3/P2, which runs on the cells operator
    with FGMRES unrestarted within OUTER_MAXITER_2D1, as does 2d1 with
    ``operator="cells"``.  ``proj_poisson`` is the projection's Poisson
    operator (``--proj-poisson``).  ``fields`` set further SolverConfig
    fields."""
    from navierstokes_tpu_torch.config import SolverConfig
    from navierstokes_tpu_torch.models.navier_stokes import NavierStokes
    inlet, dt0, T0 = case_defaults(case)
    if degree != 2 and case != "2d1":
        raise ValueError("--degree 3 is defined for 2d1 only")
    if dtype is None:
        dtype = "float64" if str(device) == "cpu" else "float32"
    out = out or os.path.join("build", "validate", case)
    paths = dict(output_dir=os.path.join(out, "out"),
                 cache_dir=os.path.join(out, "cache"),
                 csv_path=os.path.join(out, csv_name))
    if case == "bench":
        cfg = dict(dtype=dtype, nu=1.0e-3, ref_length=REF_LENGTH,
                   force_formula="st", scheme="projection", proj_bdf2=True,
                   **paths)
        if output_step is None:
            output_step = BENCH_OUTPUT_STEP
    else:
        cfg = dict(dtype=dtype, nu=1.0e-3, ref_length=REF_LENGTH,
                   force_formula="st",
                   scheme="projection" if projection else "monolithic",
                   refine=refine, f_precond=f_precond, proj_f_maxiter=100,
                   proj_p_maxiter=50, curved_boundary=curved,
                   bsr_block=bsr_block, proj_poisson=proj_poisson,
                   inner_maxiter_f=10, **paths)
    if output_step is None:
        output_step = 400
    if case == "2d1" and (degree != 2 or fields.get("operator") == "cells"):
        cfg.update(outer_maxiter=OUTER_MAXITER_2D1,
                   outer_restart=OUTER_MAXITER_2D1)
    cfg.update(fields)
    ns = NavierStokes(case_mesh(case, h, h_near, h_z, wake_levels), degree,
                      degree - 1, deltat=dt0 if dt is None else dt,
                      T=T0 if T is None else T, step=output_step,
                      inlet=inlet, config=SolverConfig(**cfg), device=device,
                      shard_devices=shard_devices)
    return ns.setup() if setup else ns


def n_steps(T, dt):
    """The number of steps ``NavierStokes.solve`` takes from 0 to T."""
    return int(np.floor(T / dt + 0.5))


def _leg_step(path):
    return int(path.rsplit("_", 1)[1][:-4])


def merge_legs(out, n_total, dst=None):
    """Merge ``<out>/forces_<N>.csv`` by step (a later leg's rows replace
    the earlier ones from its step on) into ``dst`` (default
    ``<out>/forces.csv``) once steps 1..n_total are all there; returns
    ``dst``, or None while steps are missing.  Row k of the leg from step
    N is step N + k (the time column accumulates in the run's dtype and
    drifts by more than half a step over a long fp32 run).  Rows are
    copied as text."""
    header, by_step = None, {}
    for path in sorted(glob.glob(os.path.join(out, "forces_*.csv")),
                       key=_leg_step):
        with open(path) as f:
            lines = f.read().splitlines()
        if not lines:
            continue
        header, start = lines[0], _leg_step(path)
        by_step = {k: v for k, v in by_step.items() if k <= start}
        for k, ln in enumerate(lines[1:], start + 1):
            by_step[k] = ln
    if sorted(by_step) != list(range(1, n_total + 1)):
        return None
    dst = dst or os.path.join(out, "forces.csv")
    os.makedirs(os.path.dirname(os.path.abspath(dst)), exist_ok=True)
    with open(dst, "w") as f:
        f.write("\n".join([header] + [by_step[k] for k in sorted(by_step)])
                + "\n")
    return dst


def statistics(case, csv_path, T=None):
    """validate_st.py's figures of a trace: 2d1 the settled mean of the
    last 10% (cd, cl); 3d1 the mean of the last 40% (cd, cl); 2d2 the
    maxima of the last 40% (cd_max, cl_max) and the Strouhal number
    (st).  bench: validate_bench.py's, the maxima over t > 0.75 ``T`` and
    St from the last 25% of the rows."""
    from navierstokes_tpu_torch.utils.analysis import load_forces, strouhal
    d = load_forces(csv_path)
    if case == "bench":
        tail = d[d["time"] > BENCH_TAIL * T]
        st = strouhal(csv_path, skip_fraction=BENCH_TAIL,
                      ref_length=REF_LENGTH, u_mean=1.0)
        return dict(cd_max=float(tail["Cd"].max()),
                    cl_max=float(tail["Cl"].max()),
                    st=None if math.isnan(st) else st)
    n = len(d)
    tail = d[int(n * 0.6):]
    if case == "2d1":
        settled = d[int(n * 0.9):]
        return dict(cd=float(settled["Cd"].mean()),
                    cl=float(settled["Cl"].mean()))
    if case == "3d1":
        return dict(cd=float(tail["Cd"].mean()), cl=float(tail["Cl"].mean()))
    st = strouhal(csv_path, ref_length=REF_LENGTH, u_mean=U_MEAN_2D2)
    return dict(cd_max=float(tail["Cd"].max()),
                cl_max=float(tail["Cl"].max()),
                st=None if math.isnan(st) else st)


def stats_line(case, s):
    """validate_st.py's printed line of the statistics ``s``."""
    if case == "2d1":
        return (f"[standard ST] Cd = {s['cd']:.4f} (target 5.57-5.59), "
                f"Cl = {s['cl']:.4f} (target 0.0104-0.0110)  "
                "[settled: last 10%]")
    if case == "3d1":
        return (f"[standard ST 3D-1Z] Cd = {s['cd']:.4f} (target 7.5-7.7), "
                f"Cl = {s['cl']:.4f} (target 0.06-0.08)")
    window = " [t > 0.75 T]" if case == "bench" else ""
    return (f"[standard ST] Cd_max = {s['cd_max']:.4f} (target 3.22-3.24), "
            f"Cl_max = {s['cl_max']:.4f} (target 0.99-1.01), "
            + (f"St = {s['st']:.4f}" if s["st"] is not None else
               "St = n/a (under 16 rows)") + " (target 0.295-0.305)"
            + window)


def card_line():
    """``nvidia-smi``'s name and power limit of the card, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m navierstokes_tpu_torch.scenarios.validate",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("case", nargs="?", default="2d1", choices=CASES)
    ap.add_argument("--h", type=float, default=0.015,
                    help="far-field spacing")
    ap.add_argument("--hnear", type=float, default=None,
                    help="near-obstacle spacing (default: h/3 in 2D)")
    ap.add_argument("--hz", type=float, default=None,
                    help="3D z spacing (3d1 only; default couples to "
                         "--hnear)")
    ap.add_argument("--T", type=float, default=None,
                    help="final time override")
    ap.add_argument("--dt", type=float, default=None,
                    help="time step override")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, cuda:N or cpu; cpu runs in "
                         "float64)")
    ap.add_argument("--dtype", default=None, choices=["float32", "float64"],
                    help="compute dtype (default: float32 on the card, "
                         "float64 on the CPU)")
    ap.add_argument("--projection", action="store_true",
                    help="projection scheme instead of monolithic")
    ap.add_argument("--refine", type=int, default=0,
                    help="iterative-refinement passes (monolithic, fp32)")
    ap.add_argument("--no-curved", action="store_true",
                    help="disable curved (boundary-snapped P2) geometry")
    ap.add_argument("--csv", default=None,
                    help="copy of the merged trace (all legs by step)")
    ap.add_argument("--wake-levels", type=int, default=None,
                    help="extra wake-band refinement levels (2d2 default 1)")
    ap.add_argument("--bsr-block", type=int, default=0,
                    help="BSR block size (0 = auto, see SolverConfig)")
    ap.add_argument("--f-precond", default="bj", choices=["bj", "diag"],
                    help="momentum-solve preconditioner (diag avoids the "
                         "block-Jacobi tiles)")
    ap.add_argument("--proj-poisson", default="laplacian",
                    choices=["laplacian", "schur"],
                    help="projection Poisson operator (schur = exact "
                         "discrete projection via the compatible B W B^T)")
    ap.add_argument("--degree", type=int, default=2, choices=[2, 3],
                    help="velocity degree (3: P3/P2 on cells, 2d1 only)")
    ap.add_argument("--restart-step", type=int, default=0,
                    help="continue from the checkpoint of this step")
    ap.add_argument("--output-step", type=int, default=None,
                    help="checkpoint and VTU every this many steps "
                         "(default 400, bench 1600)")
    ap.add_argument("--out", default=None,
                    help="run directory (default build/validate/<case>)")
    args = ap.parse_args(argv)
    if args.hz is not None and args.case != "3d1":
        print("note: --hz is only used for 3d1; ignoring", file=sys.stderr)
        args.hz = None
    if args.degree != 2 and args.case != "2d1":
        ap.error("--degree 3 is defined for 2d1 only")
    if args.case == "bench":
        given = [f for f in BENCH_FIXED
                 if getattr(args, f) != ap.get_default(f)]
        if given:
            ap.error("the bench case fixes its mesh and solver: "
                     + ", ".join("--" + f.replace("_", "-") for f in given)
                     + " do not apply to it")
    if args.output_step is None:
        args.output_step = BENCH_OUTPUT_STEP if args.case == "bench" else 400
    return args


def main(argv=None):
    args = parse_args(argv)
    import torch
    from navierstokes_tpu_torch.kernels.sell_spmv import COUNTS
    on_card = torch.device(args.device).type == "cuda"
    card = card_line() if on_card else None
    out = args.out or os.path.join("build", "validate", args.case)
    os.makedirs(out, exist_ok=True)
    t0 = time.perf_counter()
    ns = build_case(args.case, device=args.device, dtype=args.dtype,
                    h=args.h, h_near=args.hnear, h_z=args.hz, T=args.T,
                    dt=args.dt, projection=args.projection,
                    refine=args.refine, curved=not args.no_curved,
                    wake_levels=args.wake_levels, bsr_block=args.bsr_block,
                    f_precond=args.f_precond,
                    proj_poisson=args.proj_poisson, degree=args.degree,
                    out=out,
                    csv_name=f"forces_{args.restart_step}.csv",
                    output_step=args.output_step)
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cfg = ns.config
    print(f"[validate] {args.case} {cfg.scheme} {cfg.dtype} on "
          f"{ns.device}: {ns.space.n_dofs} DoF ({ns.mesh.n_cells} cells, "
          f"P{ns.degree_velocity}/P{ns.degree_pressure} "
          f"{cfg.operator}), dt {cfg.deltat}, T {cfg.t_final}, setup "
          f"{setup_s:.1f} s", flush=True)
    if on_card:
        print("HBM after setup: "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB peak "
              "allocated", flush=True)

    # per step: (iterations, f its, p its, converged, wall seconds (the
    # chunk's per step), whether the tile rebuild took the exact inverse)
    steps = []

    def record(ts, m, wall):
        steps.append((m.iterations, m.f_iterations, m.p_iterations,
                      bool(m.converged), wall, m.exact_inverse))

    COUNTS.reset()
    t0 = time.perf_counter()
    ns.solve(time_step=args.restart_step, on_step=record)
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if on_card else None
    n_run = len(steps)
    n_total = n_steps(cfg.t_final, cfg.deltat)
    merged = merge_legs(out, n_total)
    stats = None
    if merged is not None:
        if args.csv:
            merge_legs(out, n_total, args.csv)
        stats = statistics(args.case, merged, cfg.t_final)
        print(stats_line(args.case, stats), flush=True)
    else:
        print(f"[validate] steps 1-{n_total} not all in {out} yet: no "
              "statistics", flush=True)
    its = [s[0] for s in steps]
    launches = {f"{str(dt).replace('torch.', '')} D={d}": c / max(n_run, 1)
                for (dt, d), c in sorted(COUNTS.by_variant.items(),
                                         key=str)}
    exact = [s[5] for s in steps]
    k_exact = next((k for k, e in enumerate(exact) if e), None)
    after = [s[4] for s in steps[k_exact:]] if k_exact is not None else []
    result = {
        "case": args.case, "scheme": cfg.scheme, "dtype": cfg.dtype,
        "device": str(ns.device), "n_dofs": ns.space.n_dofs,
        "degree": ns.degree_velocity, "operator": cfg.operator,
        "h": None if args.case == "bench" else args.h, "dt": cfg.deltat, "T": cfg.t_final,
        "restart_step": args.restart_step, "steps": n_run,
        "setup_s": setup_s, "seconds": wall,
        "steps_per_s": n_run / wall if wall > 0 else None,
        "peak_bytes": peak,
        "iterations_total": int(sum(its)),
        "iterations_max": max(its) if its else None,
        "f_iterations_total": int(sum(s[1] for s in steps)),
        "p_iterations_total": int(sum(s[2] for s in steps)),
        "p_budget_steps": sum(1 for s in steps
                              if cfg.scheme == "projection"
                              and s[2] >= cfg.proj_p_maxiter),
        "unconverged_steps": sum(1 for s in steps if not s[3]),
        "sell_launches_per_step": launches,
        "exact_inverse_first_step": (None if k_exact is None
                                     else args.restart_step + k_exact + 1),
        "exact_inverse_steps": sum(1 for e in exact if e),
        "ms_per_step_from_first_exact": (1e3 * sum(after) / len(after)
                                         if after else None),
        "stats": stats, "card": card}
    print(json.dumps(result), flush=True)
    finite = stats is None or all(math.isfinite(v) for v in stats.values()
                                  if v is not None)
    return 0 if finite else 1


if __name__ == "__main__":
    sys.exit(main())
