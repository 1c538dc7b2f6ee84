"""Command-line interface of the port.

The port's copy of ``navierstokes_tpu/scenarios/cli.py``:

    python -m navierstokes_tpu_torch list
    python -m navierstokes_tpu_torch run 3d-test1 [--h 0.04] [--T 2.0] ...
    python -m navierstokes_tpu_torch postprocess 2d-test1 --t0 0 --t1 20 \
        --step 2
    python -m navierstokes_tpu_torch sweep-naca --angles 0 2 4 8

with the JAX CLI's flags plus ``--device`` (default ``cuda``; ``cpu``
runs the same step on the host).  ``postprocess`` replays the
checkpoints in ``--cache-dir`` (forces and VTUs, no solve);
``sweep-naca`` runs the 2d-naca scenario once per angle of attack and
writes ``output_<angle>.csv`` into the current directory
(tests/2D/test_naca/run_test.sh).
"""

from __future__ import annotations

import argparse

from navierstokes_tpu_torch.config import SolverConfig
from navierstokes_tpu_torch.scenarios.registry import SCENARIOS, build_solver


def _add_common(p):
    p.add_argument("--h", type=float, default=None, help="mesh size")
    p.add_argument("--deltat", type=float, default=None)
    p.add_argument("--T", type=float, default=None)
    p.add_argument("--output-step", type=int, default=None)
    p.add_argument("--re", type=float, default=None)
    p.add_argument("--mesh", type=str, default=None,
                   help="gmsh .msh path (overrides the native generator)")
    p.add_argument("--dtype", type=str, default="float32")
    p.add_argument("--preconditioner", type=str,
                   default=SolverConfig.preconditioner,
                   choices=["identity", "asimple", "ayosida", "cc", "pcd"])
    p.add_argument("--operator", type=str, default=SolverConfig.operator,
                   choices=["bsr", "ell", "cells"],
                   help="bsr and cells are ported, ell is not")
    p.add_argument("--scheme", type=str, default=SolverConfig.scheme,
                   choices=["monolithic", "projection"],
                   help="monolithic = reference-parity coupled solve; "
                        "projection = pressure-correction (fast)")
    p.add_argument("--n-devices", type=int, default=SolverConfig.n_devices,
                   help="shards of the operator, by rows on bsr and by "
                        "blocks of cells on cells (0 or 1: one device); "
                        "N > 1 puts them on cuda:0 .. cuda:N-1, or all on "
                        "the CPU with --device cpu")
    p.add_argument("--refine", type=int, default=SolverConfig.refine,
                   help="float64-residual refinement passes per monolithic "
                        "fp32 solve (solvers/refine.py)")
    p.add_argument("--output-dir", type=str, default="output")
    p.add_argument("--cache-dir", type=str, default="cache")
    p.add_argument("--csv", type=str, default="forces_vs_time.csv")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the run (cuda, cuda:N or cpu)")


def _build(args, name, mesh_kwargs=None):
    cfg = SolverConfig(dtype=args.dtype, preconditioner=args.preconditioner,
                       operator=args.operator, n_devices=args.n_devices,
                       scheme=args.scheme, refine=args.refine,
                       output_dir=args.output_dir, cache_dir=args.cache_dir,
                       csv_path=args.csv)
    names = {"deltat": "deltat", "T": "t_final",
             "output_step": "output_step", "re": "re"}
    overrides = {key: getattr(args, flag) for flag, key in names.items()
                 if getattr(args, flag) is not None}
    mesh = None
    if args.mesh:
        from navierstokes_tpu_torch.mesh.msh_io import read_msh
        mesh = read_msh(args.mesh)
    return build_solver(name, h=args.h, config=cfg, mesh=mesh,
                        mesh_kwargs=mesh_kwargs, device=args.device,
                        **overrides)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="navierstokes_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sub.add_parser("list", help="list scenarios")

    p_run = sub.add_parser("run", help="run a scenario")
    p_run.add_argument("scenario", choices=sorted(SCENARIOS))
    p_run.add_argument("--restart-step", type=int, default=0)
    _add_common(p_run)

    p_post = sub.add_parser("postprocess",
                            help="replay checkpoints -> forces + VTU "
                                 "(src/postprocess.cpp parity)")
    p_post.add_argument("scenario", choices=sorted(SCENARIOS))
    p_post.add_argument("--t0", type=int, default=0)
    p_post.add_argument("--t1", type=int, default=20)
    p_post.add_argument("--step", type=int, default=2)
    _add_common(p_post)

    p_naca = sub.add_parser("sweep-naca",
                            help="angle-of-attack sweep "
                                 "(tests/2D/test_naca/run_test.sh parity)")
    p_naca.add_argument("--angles", type=float, nargs="+", required=True)
    p_naca.add_argument("--chord", type=float, default=0.4)
    p_naca.add_argument("--code", type=str, default="2408")
    _add_common(p_naca)

    args = ap.parse_args(argv)
    if args.cmd == "list":
        for name, sc in sorted(SCENARIOS.items()):
            print(f"{name:14s} {sc.description}")
        return 0
    if args.cmd == "run":
        ns = _build(args, args.scenario)
        ns.setup()
        ns.solve(time_step=args.restart_step)
        print(f"final Cd = {ns.cd:.6f}, Cl = {ns.cl:.6f}")
        return 0
    if args.cmd == "postprocess":
        ns = _build(args, args.scenario)
        ns.setup()
        ns.post_process(args.t0, args.t1, args.step)
        return 0
    for angle in args.angles:               # sweep-naca
        args.csv = f"output_{angle:g}.csv"
        ns = _build(args, "2d-naca",
                    mesh_kwargs=dict(code=args.code, chord=args.chord,
                                     angle_deg=angle))
        ns.setup()
        ns.solve()
        print(f"angle {angle}: Cd = {ns.cd:.6f}, Cl = {ns.cl:.6f} "
              f"-> {args.csv}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
