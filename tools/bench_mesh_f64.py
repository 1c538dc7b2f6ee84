"""Float64 steps of the bench case in the port against the JAX package,
on the CPU.

    JAX_PLATFORMS=cpu python3 tools/bench_mesh_f64.py [--h H]
        [--steps 2] [--proj-tol 1e-8] [--work DIR]

The case is ``scripts/validate_bench.py``'s: projection BDF2 with the
rotational pressure update, nu=1e-3, parabolic U_m=1.5 with a 0.1 ramp,
dt=0.00125, the Schaefer-Turek force formula.  The port's model is
``validate.build_case("bench")`` in float64 on the CPU; the JAX model gets
the same SolverConfig field by field (tests/test_torch_validate_bench.py
holds ``build_case("bench")`` to the script's configuration), both with
both sub-solves at ``--proj-tol`` (default 1e-8, as
tests/test_torch_validate_steps.py runs 2d2: at the case's 1e-4 the two
packages' summation orders alone move u by 1e-9 in two steps).

Without ``--h`` the mesh is the committed ``.bench_mesh.npz`` (1,014,414
DoF).  With ``--h H`` it is made by the recipe that made that file
(``bench.py`` ``build_mesh``: ``channel_with_cylinder_2d(h, h_near=h/2)``,
saved as its arrays and loaded back, so the cylinder is polygonal and
carries no snap projectors), at a coarser h.

For each step it prints both packages' iteration totals and the largest
gaps: u and p over their largest entry, Cd and Cl over the force scale
max(|Cd|, |Cl|); then the process's peak resident memory.  The last line
is one JSON object.  Needs the JAX package (the port's tests' host).
"""

import argparse
import dataclasses
import json
import os
import resource
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def mesh_file(h, work):
    """The bench mesh, or one made by its recipe at ``h`` (saved under
    ``work``)."""
    if h is None:
        return os.path.join(ROOT, ".bench_mesh.npz")
    from navierstokes_tpu.mesh import channel_with_cylinder_2d
    path = os.path.join(work, f"bench_recipe_h{h:g}.npz")
    mesh = channel_with_cylinder_2d(h=h, h_near=h / 2)
    np.savez(path, points=mesh.points, cells=mesh.cells,
             bfaces=mesh.boundary_faces, btags=mesh.boundary_tags)
    return path


def port_model(path, work, proj_tol):
    from navierstokes_tpu_torch.scenarios import validate
    validate.BENCH_MESH = path
    return validate.build_case("bench", device="cpu", dtype="float64",
                               out=os.path.join(work, "port"),
                               proj_tol=proj_tol, setup=False)


def jax_model(path, tns, work):
    """The JAX model of the port's ``tns``: its mesh file, inlet, dt, T,
    output step and every SolverConfig field the JAX package has."""
    from navierstokes_tpu.config import InletConfig, SolverConfig
    from navierstokes_tpu.mesh.geometry import Mesh
    from navierstokes_tpu.models.navier_stokes import NavierStokes
    with np.load(path) as z:
        mesh = Mesh(2, z["points"], z["cells"], z["bfaces"], z["btags"])
    tcfg = tns.config
    names = {f.name for f in dataclasses.fields(SolverConfig)}
    cfg = SolverConfig(**{f.name: getattr(tcfg, f.name)
                          for f in dataclasses.fields(tcfg)
                          if f.name in names})
    for name, sub in (("output_dir", "out"), ("cache_dir", "cache"),
                      ("csv_path", "forces.csv")):
        setattr(cfg, name, os.path.join(work, "jax", sub))
    inlet = InletConfig(**dataclasses.asdict(tns.inlet))
    return NavierStokes(mesh, 2, 1, deltat=tcfg.deltat, T=tcfg.t_final,
                        step=tcfg.output_step, inlet=inlet, config=cfg)


def _rel(a, b):
    a = a.detach().cpu().numpy() if hasattr(a, "detach") else a
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def peak_rss_bytes():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--h", type=float, default=None,
                    help="mesh size of the bench recipe (default: the "
                    "committed bench mesh)")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--proj-tol", type=float, default=1e-8)
    ap.add_argument("--work", default=os.path.join(ROOT, "build",
                                                   "bench_mesh_f64"))
    args = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    os.makedirs(args.work, exist_ok=True)
    path = mesh_file(args.h, args.work)
    t0 = time.perf_counter()
    tns = port_model(path, args.work, args.proj_tol)
    jns = jax_model(path, tns, args.work)
    tns.setup()
    jns.setup()
    setup_s = time.perf_counter() - t0
    print(f"mesh {os.path.basename(path)}: {tns.space.n_dofs} DoF (JAX "
          f"{jns.space.n_dofs}), setup of both {setup_s:.1f} s; proj_tol "
          f"{args.proj_tol:g}, float64", flush=True)
    steps = []
    for k in range(args.steps):
        jm, tm = jns.solve_time_step(), tns.solve_time_step()
        scale = max(abs(float(jm.cd)), abs(float(jm.cl)), 1e-300)
        s = dict(step=k + 1, its_port=tm.iterations,
                 its_jax=int(jm.iterations), converged=bool(tm.converged),
                 u=_rel(tns._u, jns._u), p=_rel(tns._p, jns._p),
                 cd=abs(tm.cd - float(jm.cd)) / scale,
                 cl=abs(tm.cl - float(jm.cl)) / scale,
                 cd_port=tm.cd, cl_port=tm.cl)
        steps.append(s)
        print(f"step {k + 1}: BiCGStab + CG iterations port "
              f"{s['its_port']} ({tm.f_iterations}+{tm.p_iterations}) JAX "
              f"{s['its_jax']}, port converged {s['converged']}; gaps u "
              f"{s['u']:.3e} p {s['p']:.3e} Cd {s['cd']:.3e} Cl "
              f"{s['cl']:.3e} (Cd {tm.cd!r}, Cl {tm.cl!r})", flush=True)
    worst = {key: max(s[key] for s in steps) for key in ("u", "p", "cd",
                                                          "cl")}
    peak = peak_rss_bytes()
    print(f"largest gaps over {args.steps} steps: {worst}; peak resident "
          f"memory {peak} bytes ({peak / 2**30:.2f} GiB)", flush=True)
    print(json.dumps({"mesh": os.path.basename(path), "h": args.h,
                      "n_dofs": tns.space.n_dofs, "proj_tol": args.proj_tol,
                      "steps": steps, "worst": worst,
                      "peak_rss_bytes": peak}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
