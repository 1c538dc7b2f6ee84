"""fp32 noise of a small fixture: CUDA against CPU, and CPU against CPU in
other thread counts.

    python3 tools/fp32_noise.py [--tree DIR]
        [--case small|3d-inner-bf16|3d-projection-bj] [--threads N ...]
        [--proj-tol TOL] [--steps N] [--witness]

Cases: ``small`` (the default) is the fixture of ``chip_smoke.py`` phase
4 (h=0.1 cylinder channel, Re 20, dt 0.01, BDF2 projection, fp32);
``3d-inner-bf16`` and ``3d-projection-bj`` are phase 9's ``cc+inner_bf16``
and ``projection bj`` configurations (the h=0.15 square-column duct of
``3d-test1``, 6,954 DoF, fp32: monolithic ``cc`` with bf16 inner F values,
and BDF2 projection with the block-Jacobi F preconditioner).  The package
``navierstokes_tpu_torch`` is taken from ``--tree`` (default: this
checkout), so that two versions of the port are measured on the same host
in one run.  One model steps on the card,
one on the CPU in torch's default thread count, and one more on the CPU
in each of ``--threads`` (default: one thread, four where the default is
one).  For each step it prints the gap of Cd and Cl (over the force scale
max(|Cd|, |Cl|) of the default CPU run) and of u (max abs over max |u|)
between the card and the CPU, and the same gaps between each other CPU
run and the default one, which differ only in their summation order.
``chip_smoke.py``'s card-against-CPU gate (phase 4's rule) is 1e-4, and
1e-3 only where the card's gap is at most three times the CPU-CPU noise.
``--proj-tol`` sets both sub-solves' relative tolerance of the projection
cases (default: the configuration's 1e-4), to show how much of each gap
the solves' stopping point leaves.  ``--witness`` steps the case once more
on the CPU in float64 and prints, for each step, the card's and the fp32
CPU run's gaps to it: which of the two fp32 runs a change of rounding
moved away from the float64 solution.

The last line is one JSON object with the per-step and worst gaps.
"""

import argparse
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = ("small", "3d-inner-bf16", "3d-projection-bj")


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "?"


def cylinder_mesh(**kw):
    try:
        from navierstokes_tpu_torch.mesh.generators import (
            channel_with_cylinder_2d)
    except ImportError:   # a port that took its mesh from the JAX package
        from navierstokes_tpu.mesh import channel_with_cylinder_2d
    return channel_with_cylinder_2d(**kw)


def _config(work, dtype="float32", **fields):
    from navierstokes_tpu_torch.models import navier_stokes as M
    return M.SolverConfig(dtype=dtype,
                          output_dir=os.path.join(work, "out"),
                          cache_dir=os.path.join(work, "cache"),
                          csv_path=os.path.join(work, "forces.csv"),
                          **fields)


def small_model(device, work, proj_tol, dtype="float32"):
    from navierstokes_tpu_torch.models import navier_stokes as M
    cfg = _config(work, dtype, scheme="projection", proj_bdf2=True)
    if proj_tol is not None:
        cfg.proj_tol = proj_tol
    ns = M.NavierStokes(cylinder_mesh(h=0.1, h_near=0.04), 2, 1,
                        deltat=0.01, T=0.05, step=5,
                        inlet=M.InletConfig(kind="parabolic", u_m=0.3,
                                            height=0.41),
                        config=cfg, device=device)
    ns.set_re_number(20)
    return ns.setup()


def duct_model(device, work, dtype, **fields):
    """``chip_smoke.py``'s ``duct_model`` under ``fields``."""
    from navierstokes_tpu_torch.scenarios.registry import build_solver
    cfg = _config(work, dtype, ref_length=0.1, force_formula="st", **fields)
    return build_solver("3d-test1", h=0.15, config=cfg, device=device,
                        t_final=0.05, output_step=5).setup()


def duct_inner_bf16_model(device, work, proj_tol, dtype="float32"):
    """Phase 9's ``cc+inner_bf16`` configuration (float64: no bf16)."""
    return duct_model(device, work, dtype, scheme="monolithic",
                      inner_bf16=dtype == "float32")


def duct_projection_bj_model(device, work, proj_tol, dtype="float32"):
    """Phase 9's ``projection bj`` configuration."""
    fields = {} if proj_tol is None else dict(proj_tol=proj_tol)
    return duct_model(device, work, dtype, scheme="projection", **fields)


def gaps(ma, mb, a, b):
    """(Cd, Cl, u) gaps of run a against run b."""
    scale = max(abs(mb.cd), abs(mb.cl), 1e-30)
    ua, ub = a._u.cpu().double(), b._u.cpu().double()
    return (abs(ma.cd - mb.cd) / scale, abs(ma.cl - mb.cl) / scale,
            float((ua - ub).abs().max() / ub.abs().max()))


def iterations(m):
    if getattr(m, "p_iterations", 0):
        return f"{m.f_iterations}+{m.p_iterations}"
    return str(m.iterations)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT,
                    help="checkout whose navierstokes_tpu_torch is measured")
    ap.add_argument("--case", choices=CASES, default="small")
    ap.add_argument("--threads", type=int, nargs="+", default=None,
                    help="CPU thread counts held against the default one")
    ap.add_argument("--proj-tol", type=float, default=None)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--witness", action="store_true",
                    help="also step a float64 CPU run and print each fp32 "
                         "run's gaps to it")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fp32_noise: no CUDA device", file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    tag = (f"[{os.path.basename(tree)} {args.case} proj_tol "
           f"{args.proj_tol if args.proj_tol is not None else 'default'}]")
    work = os.path.join(tree, "build", "fp32_noise", args.case)
    make = {"small": small_model,
            "3d-inner-bf16": duct_inner_bf16_model,
            "3d-projection-bj": duct_projection_bj_model}[args.case]
    n_threads = torch.get_num_threads()
    alts = args.threads or [1 if n_threads > 1 else 4]
    alts = [k for k in alts if k != n_threads]
    gpu = make("cuda", os.path.join(work, "gpu"), args.proj_tol)
    cpu = make("cpu", os.path.join(work, "cpu"), args.proj_tol)
    others = {k: make("cpu", os.path.join(work, f"cpu{k}"), args.proj_tol)
              for k in alts}
    f64 = (make("cpu", os.path.join(work, "cpu_f64"), args.proj_tol,
                "float64") if args.witness else None)
    steps = []
    for k in range(args.steps):
        mg = gpu.solve_time_step()
        mc = cpu.solve_time_step()
        cpu_cpu, its = {}, [iterations(mg), iterations(mc)]
        for nt, ns in others.items():
            torch.set_num_threads(nt)
            ma = ns.solve_time_step()
            torch.set_num_threads(n_threads)
            cpu_cpu[nt] = gaps(ma, mc, ns, cpu)
            its.append(iterations(ma))
        card_cpu = gaps(mg, mc, gpu, cpu)
        spread = tuple(max(g[i] for g in cpu_cpu.values())
                       for i in range(3))
        steps.append(dict(step=k + 1, cd=mc.cd, cl=mc.cl, its=its,
                          card_cpu=card_cpu, cpu_cpu=spread,
                          cpu_cpu_by_threads=cpu_cpu))
        if f64 is not None:
            mw = f64.solve_time_step()
            steps[-1].update(f64_its=iterations(mw),
                             card_f64=gaps(mg, mw, gpu, f64),
                             cpu_f64=gaps(mc, mw, cpu, f64))
            print(f"{tag} step {k + 1} against float64 on the CPU (its "
                  f"{iterations(mw)}, Cd {mw.cd:.6f} Cl {mw.cl:.6f}): card "
                  + " ".join(f"{q} {g:.3e}" for q, g in zip(
                      ("Cd", "Cl", "u"), steps[-1]["card_f64"]))
                  + f"; cpu {n_threads} threads " + " ".join(
                      f"{q} {g:.3e}" for q, g in zip(
                          ("Cd", "Cl", "u"), steps[-1]["cpu_f64"])),
                  flush=True)
        print(f"{tag} step {k + 1}: its card/cpu/" + "/".join(
            f"cpu{nt}" for nt in others) + f" {' '.join(its)}; Cd "
            f"{mc.cd:.6f} Cl {mc.cl:.6f}; card-cpu Cd {card_cpu[0]:.3e} Cl "
            f"{card_cpu[1]:.3e} u {card_cpu[2]:.3e}; cpu {n_threads} "
            "threads against " + ", ".join(
                f"{nt}: Cd {g[0]:.3e} Cl {g[1]:.3e} u {g[2]:.3e}"
                for nt, g in cpu_cpu.items()), flush=True)
    worst = {key: max(max(s[key]) for s in steps)
             for key in ("card_cpu", "cpu_cpu")}
    gap = worst["card_cpu"]
    gate = 1e-3 if 1e-4 < gap <= 1e-3 and gap <= 3 * worst["cpu_cpu"] \
        else 1e-4
    card = card_line()
    print(f"{tag} worst of Cd, Cl, u: card-cpu {gap:.3e}, cpu-cpu "
          f"{worst['cpu_cpu']:.3e} ({n_threads} against {alts} threads); "
          f"phase 4's rule gives the gate {gate:g}: "
          f"{'holds' if gap <= gate else 'fails'}; on {card}", flush=True)
    print(json.dumps({"tree": os.path.basename(tree), "case": args.case,
                      "card": card, "proj_tol": args.proj_tol,
                      "threads": [n_threads] + alts, "steps": steps,
                      "worst": worst, "gate": gate}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
