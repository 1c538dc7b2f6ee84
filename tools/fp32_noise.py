"""fp32 noise of the small projection fixture: CUDA against CPU, and CPU
against CPU in another thread count.

    python3 tools/fp32_noise.py [--tree DIR] [--proj-tol TOL] [--steps N]

Runs the fixture of ``chip_smoke.py`` phase 4 (h=0.1 cylinder channel,
Re 20, dt 0.01, BDF2 projection, fp32) with the ``navierstokes_tpu_torch``
package found under ``--tree`` (default: this checkout), so that two
versions of the port are measured on the same host in one run.  Three
models step side by side: on the card, on the CPU in torch's default thread
count, and on the CPU in one thread (four where the default is one).  For
each step it prints the gap of Cd and Cl (over the force scale
max(|Cd|, |Cl|) of the CPU run) and of u (max abs over max |u|) between
the card and the CPU, and the same gaps between the two CPU runs, which
differ only in their summation order.  ``--proj-tol`` sets both
sub-solves' relative tolerance (default: the configuration's 1e-4), to
show how much of each gap the solves' stopping point leaves.

The last line is one JSON object with the per-step and worst gaps.
"""

import argparse
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def small_model(device, work, proj_tol):
    from navierstokes_tpu_torch.models import navier_stokes as M
    cfg = M.SolverConfig(dtype="float32",
                         output_dir=os.path.join(work, "out"),
                         cache_dir=os.path.join(work, "cache"),
                         csv_path=os.path.join(work, "forces.csv"),
                         scheme="projection", proj_bdf2=True)
    if proj_tol is not None:
        cfg.proj_tol = proj_tol
    ns = M.NavierStokes(cylinder_mesh(h=0.1, h_near=0.04), 2, 1,
                        deltat=0.01, T=0.05, step=5,
                        inlet=M.InletConfig(kind="parabolic", u_m=0.3,
                                            height=0.41),
                        config=cfg, device=device)
    ns.set_re_number(20)
    return ns.setup()


def gaps(ma, mb, a, b):
    """(Cd, Cl, u) gaps of run a against run b."""
    scale = max(abs(mb.cd), abs(mb.cl), 1e-30)
    ua, ub = a._u.cpu().double(), b._u.cpu().double()
    return (abs(ma.cd - mb.cd) / scale, abs(ma.cl - mb.cl) / scale,
            float((ua - ub).abs().max() / ub.abs().max()))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT,
                    help="checkout whose navierstokes_tpu_torch is measured")
    ap.add_argument("--proj-tol", type=float, default=None)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fp32_noise: no CUDA device", file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    tag = (f"[{os.path.basename(tree)} proj_tol "
           f"{args.proj_tol if args.proj_tol is not None else 'default'}]")
    work = os.path.join(tree, "build", "fp32_noise")
    n_threads = torch.get_num_threads()
    alt_threads = 1 if n_threads > 1 else 4
    gpu = small_model("cuda", os.path.join(work, "gpu"), args.proj_tol)
    cpu = small_model("cpu", os.path.join(work, "cpu"), args.proj_tol)
    alt = small_model("cpu", os.path.join(work, "alt"), args.proj_tol)
    steps = []
    for k in range(args.steps):
        mg = gpu.solve_time_step()
        mc = cpu.solve_time_step()
        torch.set_num_threads(alt_threads)
        ma = alt.solve_time_step()
        torch.set_num_threads(n_threads)
        card_cpu, cpu_cpu = gaps(mg, mc, gpu, cpu), gaps(ma, mc, alt, cpu)
        its = [f"{m.f_iterations}+{m.p_iterations}" for m in (mg, mc, ma)]
        steps.append(dict(step=k + 1, cd=mc.cd, cl=mc.cl, its=its,
                          card_cpu=card_cpu, cpu_cpu=cpu_cpu))
        print(f"{tag} step {k + 1}: its card/cpu/cpu-alt {' '.join(its)}; "
              f"Cd {mc.cd:.6f} Cl {mc.cl:.6f}; card-cpu Cd {card_cpu[0]:.3e}"
              f" Cl {card_cpu[1]:.3e} u {card_cpu[2]:.3e}; cpu {n_threads}-"
              f"{alt_threads} threads Cd {cpu_cpu[0]:.3e} Cl "
              f"{cpu_cpu[1]:.3e} u {cpu_cpu[2]:.3e}", flush=True)
    worst = {key: max(max(s[key]) for s in steps)
             for key in ("card_cpu", "cpu_cpu")}
    card = card_line()
    print(f"{tag} worst of Cd, Cl, u: card-cpu {worst['card_cpu']:.3e}, "
          f"cpu-cpu {worst['cpu_cpu']:.3e} ({n_threads} vs {alt_threads} "
          f"threads) on {card}", flush=True)
    print(json.dumps({"tree": os.path.basename(tree), "card": card,
                      "proj_tol": args.proj_tol, "threads": [n_threads,
                                                             alt_threads],
                      "steps": steps, "worst": worst}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
