"""Per-step profile of the PyTorch port at a full-size point, on one GPU.

    python3 tools/torch_step_profile.py [--tree DIR] [--case C] [--scheme S]
        [--operator O] [--eager] [--set FIELD=VALUE ...]

Builds, with the ``navierstokes_tpu_torch`` package found under ``--tree``
(default: this checkout), so that two versions of the port can be
measured in one run on the same card, one of five cases:

* ``--case bench`` (default): the ``chip_smoke.py`` bench configuration
  (Schaefer-Turek 2D-2, ``.bench_mesh.npz``, 1,014,414 DoF, fp32, Poisson
  CG budget 100) in ``--scheme`` monolithic or projection, with the
  ``SolverConfig`` fields of ``--set`` on top (e.g. ``--set
  proj_poisson=schur``, ``--set f_solver=richardson``);
* ``--case 3d1``: Schaefer-Turek 3D-1Z as ``python -m
  navierstokes_tpu_torch.scenarios.validate 3d1 --projection --f-precond
  diag --h 0.023 --hnear 0.007`` builds it (3,393,382 DoF, biparabolic
  U_m=0.45, nu=1e-3, projection BDF2 with the diagonal F preconditioner,
  budgets 100 BiCGStab / 50 CG, dt=0.01, fp32); ``--scheme`` is ignored;
* ``--case naca``: the ``sweep-naca`` step, the 2d-naca scenario at its
  default h=0.02 and 8 degrees (157,859 DoF, uniform inlet U=1, nu=1e-3,
  monolithic ``cc``, dt=0.01, fp32); ``--scheme`` is ignored;
* ``--case p3``: Schaefer-Turek 2D-1 in P3/P2 on the generic element
  ("cells") operator, as ``chip_smoke.py``'s phase 18 window runs it
  (``validate 2d1 --degree 3 --h 0.010 --hnear 0.0033``: 654,022 DoF,
  parabolic U_m=0.3, nu=1e-3, monolithic with the default ``cc``, which
  runs aSIMPLE on cells, dt=0.01, fp32, FGMRES unrestarted within its
  budget of 400);
* ``--case 2d1``: the same mesh and physics in P2/P1 (268,539 DoF, the
  cylinder snapped) on ``--operator`` bsr (default) or cells.

The Schaefer-Turek cases come from ``scenarios.validate.build_case``, so
a ``--tree`` measured with them must have that module.  Otherwise the
script uses only the port's public surface (the package's
``InletConfig``/``SolverConfig``, ``NavierStokes``, the mesh generators,
``a0_cell``, ``_op`` and ``_ops.convection``).

It prints, for the case:
* steps/s over ``--steps`` timed steps after ``--warm`` warm-up steps
  (host clock between two synchronisations), iterations per step, the
  tile inverses' branch per step (Newton-Schulz or exact) and the peak
  device memory;
* the per-step F rebuild (``a0_cell + convection``) in ms, from CUDA
  events, median of 30 calls, L2-cold (a 128 MB read before each call)
  and warm;
* the captured step's device time per step from CUDA events around each
  graph replay over ``--steps`` further steps (``graph_device_ms``), and
  its share of the unprofiled step time;
* the captured step's memory: the capture's peak and reserved growth,
  and bytes (allocated, reserved) by pool (the graphs' pool, the
  conditional nodes' pool, torch's default pools) before and after the capture, after the timed steps and after
  the plain steps below, with those plain steps' peak (``pool_bytes``);
* a ``torch.profiler`` trace of ``--profile-steps`` further steps: the
  device time per step (kernels, copies and memsets), its share of the
  unprofiled step time, the SpMV kernels' part of it, calls and ms per
  step by kernel kind (``KINDS``: the Newton-Schulz GEMM of
  csrc/bj_gemm.cu ahead of the library GEMMs, the tile rebuild's other
  kernels, the exact
  tile inverse (csrc/bj_inverse.cu; a parent's cuSOLVER kernels), the V-cycle's
  sweeps or stages, SpMV, tile apply, the Krylov updates, Gram-Schmidt,
  dots, GEMMs, elementwise,
  ...), and the kernels with the most time (name, calls, ms).  The trace holds no kernel launched
  inside a while node's body, so a captured step is not traced: the
  split comes from ``--profile-steps`` plain steps of the same model
  (``solve_time_step(_eager=True)``, the same kernels on the same bits),
  printed beside the graph device time; the JSON's ``kernel_ms_per_step``,
  ``spmv_ms_per_step`` and ``top`` are null for a captured run and the
  split is under ``plain_split``.

On the card the one-device bsr step, in either scheme, replays its
captured CUDA graphs (models/step_graphs.py; each Krylov loop a while
node, the inner BiCGStab nested in FGMRES's body); ``--eager`` steps it
with the plain (eager) step instead (``solve_time_step(_eager=True)``),
so the two can be compared in one call.  The cells operator (``--case
p3``, ``--operator cells``) steps eagerly either way, and so does a
``--tree`` without captured graphs (or, before them, without captured
monolithic graphs).  The capture seconds, and per step the host reads,
the masked iterations and the skipped bodies, are printed beside the
times.

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


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "?"


def model_3d1(work):
    from navierstokes_tpu_torch.scenarios.validate import build_case
    return build_case("3d1", device="cuda", h=0.023, h_near=0.007,
                      projection=True, f_precond="diag", out=work)


def model_naca(work):
    import navierstokes_tpu_torch as pkg
    from navierstokes_tpu_torch.scenarios.registry import build_solver
    cfg = pkg.SolverConfig(
        dtype="float32", output_dir=os.path.join(work, "out"),
        cache_dir=os.path.join(work, "cache"),
        csv_path=os.path.join(work, "forces.csv"))
    return build_solver("2d-naca", config=cfg,
                        mesh_kwargs=dict(angle_deg=8.0), device="cuda",
                        output_step=1000).setup()


def model_2d1(work, degree=3, operator="bsr"):
    """Schaefer-Turek 2D-1 as ``validate 2d1 --h 0.010 --hnear 0.0033``
    builds it, in P``degree``/P``degree - 1`` on ``operator`` (P3/P2 runs
    on cells), fp32 on the card."""
    from navierstokes_tpu_torch.scenarios.validate import build_case
    return build_case("2d1", device="cuda", h=0.010, h_near=0.0033,
                      degree=degree, operator=operator, out=work)


def bench_model(scheme, work, fields=()):
    import navierstokes_tpu_torch as pkg
    from navierstokes_tpu_torch.models import navier_stokes as M
    z = np.load(os.path.join(ROOT, ".bench_mesh.npz"))
    mesh = M.Mesh(2, z["points"], z["cells"], z["bfaces"], z["btags"])
    cfg = pkg.SolverConfig(
        dtype="float32", output_dir=os.path.join(work, "out"),
        cache_dir=os.path.join(work, "cache"),
        csv_path=os.path.join(work, "forces.csv"), nu=1.0e-3, ref_length=0.1,
        force_formula="st", scheme="projection", proj_bdf2=True,
        outer_maxiter=128, proj_p_maxiter=100)
    if scheme == "monolithic":
        cfg.scheme, cfg.preconditioner = "monolithic", "cc"
    for name, value in fields:
        setattr(cfg, name, value)
    inlet = pkg.InletConfig(kind="parabolic", u_m=1.5, height=0.41,
                            ramp=0.05)
    ns = M.NavierStokes(mesh, 2, 1, deltat=0.00125, T=1.0, step=10,
                        inlet=inlet, config=cfg, device="cuda")
    ns.set_re_number(100)
    return ns.setup()


def time_ms(fn, cold, n=30):
    flush = torch.ones(32 << 20, dtype=torch.float32, device="cuda")
    fn()
    times = []
    for _ in range(n):
        if cold:
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


# kernel kinds of the profiled split, by a part of the kernel's name (the
# first that matches)
KINDS = (("Newton-Schulz GEMM", ("bj_gemm_kernel",)),
         # bj_guard_rows, bj_update_kernel: a parent tree's standalone passes
         ("tile rebuild", ("bj_tiles_kernel", "bj_guard_rows", "bj_guard_max",
                           "bj_update_kernel")),
         ("exact tile inverse", ("bj_inverse_kernel",)),
         ("cuSOLVER", ("getrf", "getrs", "getri", "laswp", "trsm_",
                       "cusolver", "magma")),
         ("V-cycle", ("vcycle_sweep", "vcycle_first", "vcycle_step",
                      "vcycle_residual")),
         ("spmv", ("sell_spmv",)),
         ("tile apply", ("stream_kernel", "ring_kernel")),
         ("Krylov update", ("bicgstab_p", "bicgstab_s", "bicgstab_xr",
                            "cg_xr", "cg_p")),
         ("Gram-Schmidt", ("gs_pass", "gs_reduce", "gs_finish",
                           "gs_write")),
         ("Givens", ("lsq_update",)), ("predicate", ("set_condition",)),
         ("dot", ("dot_kernel", "reduce_1Block", "dot_")),
         ("GEMM/GEMV", ("gemm", "gemv", "xmma", "cutlass", "Kernel2",
                        "sm90_", "ampere_")),
         ("elementwise", ("elementwise_kernel", "index_elementwise",
                          "CatArrayBatched", "fill_kernel")),
         ("reduction", ("reduce_kernel",)),
         ("copy / memset", ("Memcpy", "Memset", "memcpy", "memset")))


def by_kind(rows, steps):
    """{kind: [calls per step, device ms per step]} of profiler rows
    (device us, calls, name)."""
    out = {}
    for us, n, key in rows:
        kind = next((k for k, parts in KINDS
                     if any(part in key for part in parts)), "other")
        c = out.setdefault(kind, [0.0, 0.0])
        c[0] += n / steps
        c[1] += us / 1e3 / steps
    return dict(sorted(out.items(), key=lambda kv: -kv[1][1]))


def its(m):
    if getattr(m, "f_iterations", None) is not None and \
            getattr(m, "p_iterations", None) is not None and \
            m.p_iterations > 0:
        return f"{m.f_iterations}+{m.p_iterations}"
    return str(m.iterations)


def pool_bytes(ns):
    """[allocated, reserved] bytes on the card by memory pool, from
    ``torch.cuda.memory_snapshot()``: the captured graphs' pool
    (``graphs``), the conditional nodes' pool (``bodies``: the tensors
    allocated inside bodies, and since the while nodes every allocation
    of a capture) and torch's default pools (``other``)."""
    names = {}
    sg = getattr(ns, "_graphs", None)
    if sg is not None:
        names[tuple(sg.pool)] = "graphs"
        nodes = getattr(sg, "whiles", None) or getattr(sg, "ifs", None)
        if nodes is not None:
            names[tuple(nodes.pool)] = "bodies"
    out = {"graphs": [0, 0], "bodies": [0, 0], "other": [0, 0]}
    for seg in torch.cuda.memory_snapshot():
        pool = names.get(tuple(seg.get("segment_pool_id", (0, 0))), "other")
        out[pool][0] += seg["allocated_size"]
        out[pool][1] += seg["total_size"]
    return out


def graph_device_ms(step, n):
    """Device time per step of ``n`` steps replayed from captured graphs:
    a pair of CUDA events around every ``CUDAGraph.replay``, summed.  The
    profiler's trace has no kernel launched inside a conditional while
    node's body, so this is the captured step's device time; it counts the
    gap between the first event and the graph's start, a launch's worth,
    as busy, and leaves out the few launches between replays."""
    pairs = []
    replay = torch.cuda.CUDAGraph.replay

    def timed(graph):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        replay(graph)
        b.record()
        pairs.append((a, b))

    torch.cuda.CUDAGraph.replay = timed
    try:
        for _ in range(n):
            step()
    finally:
        torch.cuda.CUDAGraph.replay = replay
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / n


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT,
                    help="checkout whose navierstokes_tpu_torch is measured")
    ap.add_argument("--case", default="bench",
                    choices=["bench", "3d1", "naca", "p3", "2d1"])
    ap.add_argument("--operator", default="bsr", choices=["bsr", "cells"],
                    help="operator of --case 2d1")
    ap.add_argument("--scheme", default="monolithic",
                    choices=["monolithic", "projection"])
    ap.add_argument("--warm", type=int, default=5)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--profile-steps", type=int, default=2)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--eager", action="store_true",
                    help="the plain step, not the captured graphs")
    ap.add_argument("--set", action="append", default=[],
                    metavar="FIELD=VALUE",
                    help="a SolverConfig field of --case bench (a number, "
                         "or else a string)")
    args = ap.parse_args()
    fields = []
    for item in args.set:
        name, _, value = item.partition("=")
        try:
            value = float(value) if "." in value else int(value)
        except ValueError:
            pass
        fields.append((name, value))
    if not torch.cuda.is_available():
        print("torch_step_profile: no CUDA device", file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    card = card_line()
    label = {"3d1": "3d1", "naca": "naca", "p3": "p3 cells",
             "2d1": f"2d1 {args.operator}"}.get(args.case, args.scheme)
    if args.eager:
        label += " eager"
    label += "".join(f" {n}={v}" for n, v in fields)
    tag = f"[{os.path.basename(tree)} {label}]"
    work = os.path.join(tree, "build", "step_profile")
    t0 = time.perf_counter()
    ns = (model_3d1(work) if args.case == "3d1"
          else model_naca(work) if args.case == "naca"
          else model_2d1(work) if args.case == "p3"
          else model_2d1(work, 2, args.operator) if args.case == "2d1"
          else bench_model(args.scheme, work, fields))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    print(f"{tag} setup {setup_s:.1f} s, {ns.space.n_dofs} DoF", flush=True)
    import inspect
    has_eager = "_eager" in inspect.signature(ns.solve_time_step).parameters
    kw = {"_eager": True} if args.eager and has_eager else {}
    step = lambda: ns.solve_time_step(**kw)
    captured = (not kw and hasattr(ns, "_captures") and ns._captures()
                and hasattr(ns, "capture_graphs"))
    mem = {}
    if captured:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reserved0 = torch.cuda.memory_reserved()
        mem["before_capture"] = pool_bytes(ns)
        ns.capture_graphs()
        torch.cuda.synchronize()
        mem["capture_peak"] = torch.cuda.max_memory_allocated()
        mem["capture_reserved_growth"] = (torch.cuda.memory_reserved()
                                          - reserved0)
        mem["after_capture"] = pool_bytes(ns)

    torch.cuda.reset_peak_memory_stats()
    ms = [step() for _ in range(args.warm)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ms += [step() for _ in range(args.steps)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    mem["after_steps"] = pool_bytes(ns)
    step_ms = wall / args.steps * 1e3
    timed = ms[args.warm:]
    reads = statistics.mean(getattr(m, "flag_reads", 0) for m in timed)
    masked = statistics.mean(getattr(m, "masked_iterations", 0)
                             for m in timed)
    skipped = statistics.mean(getattr(m, "skipped_bodies", 0) for m in timed)
    graphs = getattr(ns, "_graphs", None)
    capture_s = graphs.capture_seconds if graphs is not None else None
    graph_ms = graph_device_ms(step, args.steps) if captured else None

    u = torch.as_tensor(np.random.default_rng(1234).standard_normal(
        (ns.space.n_p2, ns.dim)), dtype=torch.float32, device="cuda")
    rebuild = lambda: ns.a0_cell + ns._ops.convection(ns._op, u)
    rebuild_cold, rebuild_warm = time_ms(rebuild, True), time_ms(rebuild,
                                                                 False)

    # the per-kernel split: the trace holds no kernel launched inside a
    # while node's body, so a captured step is split from its plain step,
    # which launches the same kernels on the same bits
    profiled = ((lambda: ns.solve_time_step(_eager=True)) if captured
                else step)
    rows = []
    if not captured or has_eager:
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            ms += [profiled() for _ in range(args.profile_steps)]
            torch.cuda.synchronize()
        if captured:
            mem["eager_peak"] = torch.cuda.max_memory_allocated()
            mem["after_eager"] = pool_bytes(ns)
        # device-side events only (kernels, copies, memsets): the operator
        # events above them carry the same device time again
        from torch.autograd import DeviceType
        rows = sorted(((e.self_device_time_total, e.count, e.key)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA
                       and e.self_device_time_total > 0), reverse=True)
    per_step = lambda us: us / 1e3 / max(args.profile_steps, 1)
    kernel_ms = per_step(sum(r[0] for r in rows))
    kinds = by_kind(rows, max(args.profile_steps, 1))
    spmv_ms = per_step(sum(r[0] for r in rows if "spmv" in r[2]))

    print(f"{tag} iterations per step: " + " ".join(its(m) for m in ms),
          flush=True)
    print(f"{tag} Cd per step: " + " ".join(f"{m.cd:.5f}" for m in ms),
          flush=True)
    print(f"{tag} every solve converged: {all(m.converged for m in ms)}",
          flush=True)
    branch = "".join({True: "E", False: "N", None: "-"}[
        getattr(m, "exact_inverse", None)] for m in ms)
    print(f"{tag} tile inverses per step (N Newton-Schulz, E exact, - none):"
          f" {branch}", flush=True)
    print(f"{tag} steps/s {args.steps / wall:.4f} ({args.steps} steps in "
          f"{wall:.3f} s, {step_ms:.1f} ms/step), peak {peak} bytes "
          f"({peak / 2**30:.2f} GiB) on {card}", flush=True)
    print(f"{tag} host reads per step {reads:.2f}, masked iterations per "
          f"step {masked:.2f}, skipped bodies per step {skipped:.2f}; capture "
          f"{'not captured' if capture_s is None else f'{capture_s:.2f} s'}",
          flush=True)
    if captured:
        print(f"{tag} capture: peak {mem['capture_peak']} bytes, reserved "
              f"growth {mem['capture_reserved_growth']} bytes; bytes "
              "(allocated, reserved) by pool before the capture "
              f"{mem['before_capture']}, after it {mem['after_capture']}, "
              f"after the captured steps {mem['after_steps']}", flush=True)
        if "eager_peak" in mem:
            print(f"{tag} {args.profile_steps} plain steps of the captured "
                  f"model: peak {mem['eager_peak']} bytes, by pool after "
                  f"them {mem['after_eager']}", flush=True)
    print(f"{tag} F rebuild (a0 + convection) ms: cold {rebuild_cold:.4f}, "
          f"warm {rebuild_warm:.4f}", flush=True)
    if graph_ms is not None:
        print(f"{tag} graph device time {graph_ms:.2f} ms per step (CUDA "
              f"events around each replay, {args.steps} steps), "
              f"{100 * graph_ms / step_ms:.0f}% of an unprofiled step",
              flush=True)
    split = "plain-step " if captured else ""
    if rows:
        print(f"{tag} {split}device time {kernel_ms:.1f} ms per step over "
              f"{args.profile_steps} profiled "
              + ("plain steps (solve_time_step(_eager=True): the captured "
                 "step's kernels, not its time)" if captured else
                 f"steps, {100 * kernel_ms / step_ms:.0f}% of an unprofiled "
                 "step")
              + f"; SpMV kernels {spmv_ms:.1f} ms per step", flush=True)
        print(f"{tag} {split}kernels per step by kind (calls, ms): "
              + "; ".join(f"{k} {c:.1f}, {t:.3f}" for k, (c, t)
                          in kinds.items()), flush=True)
        for dev_us, n, key in rows[:args.top]:
            print(f"{tag}   {dev_us / 1e3:9.3f} ms {n:6d} calls  "
                  f"{key[:90]}", flush=True)
    else:
        print(f"{tag} torch.profiler recorded no device time: kernel time "
              "not measured", flush=True)
    top = [[k, n, us / 1e3] for us, n, k in rows[:args.top]]
    print(json.dumps({
        "tree": os.path.basename(tree), "case": args.case,
        "scheme": label, "card": card, "setup_s": setup_s,
        "eager": not captured, "n_dofs": ns.space.n_dofs,
        "steps_per_s": args.steps / wall,
        "step_ms": step_ms, "cd": [m.cd for m in ms],
        "flag_reads_per_step": reads, "masked_per_step": masked,
        "skipped_per_step": skipped,
        "capture_s": capture_s, "memory": mem,
        "converged": all(m.converged for m in ms),
        "peak_bytes": peak, "iterations": [its(m) for m in ms],
        "tile_inverses": branch,
        "rebuild_ms_cold": rebuild_cold, "rebuild_ms_warm": rebuild_warm,
        "graph_ms_per_step": graph_ms,
        # a trace of a captured step misses the loop bodies: null there
        "kernel_ms_per_step": kernel_ms if rows and not captured else None,
        "spmv_ms_per_step": spmv_ms if rows and not captured else None,
        "top": top if not captured else None,
        "by_kind": kinds if rows and not captured else None,
        "plain_split": ({"kernel_ms_per_step": kernel_ms,
                         "spmv_ms_per_step": spmv_ms, "top": top,
                         "by_kind": kinds}
                        if rows and captured else None)}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
