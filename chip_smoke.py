"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths — the Schaefer-Turek 2D-2 step on the
committed 1,014,414-DoF bench mesh (``.bench_mesh.npz``), fp32, in the
projection scheme and in the monolithic scheme — and checks them:

1. device: the card's name and power limit, the toolchain (torch CUDA,
   nvcc, triton);
2. build of the CUDA kernels from ``navierstokes_tpu_torch/csrc``;
3. setup at the bench point (projection); the fp32 blocked-ELL SpMV
   kernel against its plain PyTorch version at the five shapes the step
   gives it (F, mass, P1 Laplacian, B, G^T), with times from CUDA events;
4. a small fixture (h=0.1 cylinder channel): 5 BDF2 projection steps on
   the card against the same steps on the CPU, both fp32;
5. 20 bench-point projection steps (10 warm-up + 10 timed) through
   ``NavierStokes.solve_time_step``, with the kernel's launch count;
6. the bf16-values and fp64 kernel variants against their plain versions
   at the bench-point F shape;
7. the small fixture under ``scheme="monolithic"``: 5 steps on the card
   against the CPU, fp32, with ``cc``, ``asimple``, ``cc`` + ``inner_bf16``
   (the bf16 variant's path) and ``cc`` + ``refine=2`` (the fp64
   variant's path);
8. the monolithic bench point (FGMRES + Cahouet-Chabard, BDF1): 5 warm-up
   and 5 timed steps, after the projection model is freed.

Each path is driven with the launch counts set to 0 just before it and
read just after.  Any failed check raises, so the exit code is not 0.
The last two lines of standard output are the kernel record and the
result, each one JSON object.  Imports no jax and nothing of the JAX
package that does.
"""

import gc
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(HERE, "build", "chip_smoke")
EXPECTED_DOFS = 1_014_414
KERNEL_SOURCE = "navierstokes_tpu_torch/csrc/bsr_spmv.cu"
# the Pallas kernel body's fp32 and bf16 branches (fused_reduce's _kernel)
REPLACES = "navierstokes_tpu/ops/pallas_matvec.py:59"
REPLACES_BF16 = "navierstokes_tpu/ops/pallas_matvec.py:53"
# The bench configuration (bench.py) with one change: the Poisson CG budget
# is 100, not the default 50.  At 50 the start-up steps 1, 2 and 4 stop at
# the budget (3+50, 6+50, 4+50 BiCGStab+CG iterations; the JAX run on the
# TPU shows the same totals), and this script requires every solve of the
# 20 steps to converge.
CG_BUDGET = 100


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def check(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def phase_device():
    check(torch.cuda.is_available(), "torch.cuda.is_available()")
    card = card_line()
    log(f"[1] card: {card}")
    from navierstokes_tpu_torch.kernels.build import nvcc_release
    try:
        import triton
        tri = f"import triton ok ({triton.__version__})"
    except ImportError as e:
        tri = f"import triton failed ({e})"
    log(f"[1] torch {torch.__version__}, torch.version.cuda "
        f"{torch.version.cuda}, nvcc: {nvcc_release()}; {tri}")
    log(f"[1] device {torch.cuda.get_device_name(0)}, count "
        f"{torch.cuda.device_count()}")
    return card


def phase_build():
    from navierstokes_tpu_torch.kernels.build import build_info
    t0 = time.perf_counter()
    info = build_info()
    wall = time.perf_counter() - t0
    regs = [ln.strip() for ln in info["log"].splitlines()
            if "registers" in ln]
    log(f"[2] kernel library {info['path']}: nvcc {info['seconds']:.2f} s "
        f"(load {wall:.2f} s); {len(regs)} instantiations, "
        f"{regs[0] if regs else 'no ptxas report'}")


def bench_model(device, **overrides):
    # the port first: its package init lets navierstokes_tpu.mesh load on
    # a host without matplotlib
    from navierstokes_tpu_torch.models.navier_stokes import NavierStokes
    from navierstokes_tpu.config import InletConfig, SolverConfig
    from navierstokes_tpu.mesh.geometry import Mesh
    z = np.load(os.path.join(HERE, ".bench_mesh.npz"))
    mesh = Mesh(2, z["points"], z["cells"], z["bfaces"], z["btags"])
    inlet = InletConfig(kind="parabolic", u_m=1.5, height=0.41, ramp=0.05)
    cfg = SolverConfig(dtype="float32", output_dir=os.path.join(WORK, "out"),
                       cache_dir=os.path.join(WORK, "cache"),
                       csv_path=os.path.join(WORK, "forces.csv"),
                       nu=1.0e-3, ref_length=0.1, force_formula="st",
                       scheme="projection", proj_bdf2=True,
                       outer_maxiter=128, proj_p_maxiter=CG_BUDGET)
    for k, v in overrides.items():
        setattr(cfg, k, v)
    ns = NavierStokes(mesh, 2, 1, deltat=0.00125, T=1.0, step=10,
                      inlet=inlet, config=cfg, device=device)
    ns.set_re_number(100)
    return ns


def _median_ms(fn, n=20, burst=10):
    """Median over ``n`` samples of the device time per call, each sample
    a burst of back-to-back calls between two CUDA events (so the host's
    launch cost hides behind the device work, as on the main path)."""
    fn()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(burst):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / burst)
    return statistics.median(times)


def spmv_uses(ns, rng):
    """(name, args) of the five SpMV uses at the bench-point shapes, with
    the setup's values and numpy-seeded x."""
    e, dev = ns.ell, ns.device
    x = lambda n, d: torch.as_tensor(rng.standard_normal((n, d)),
                                     dtype=torch.float32, device=dev)
    nu = e.n_vb * e.bu
    ap = ns._ap_dir
    n_ext, dim, bu, cw = e.g_blk.shape
    return [
        ("F (a0, d=2)", (ns.a0_cell, e.f_cols, x(nu, 2), e.bu, e.f_spill,
                         e.n_vb)),
        ("mass (d=2)", (e.m_blk, e.f_cols, x(nu, 2), e.bu, e.f_spill,
                        e.n_vb)),
        ("P1 Laplacian (d=1)", (ap.vals, ap.cols,
                                x(ap.cols.shape[0] * ap.b, 1), ap.b)),
        ("B (cb=bu*dim, d=1)", (e.b_blk, e.b_cols, x(nu * dim, 1),
                                e.bu * dim, e.b_spill, e.n_pb)),
        ("G^T (R=dim*bu, d=1)", (e.g_blk.view(n_ext, dim * bu, cw),
                                 e.g_cols, x(e.n_pb * e.bp, 1), e.bp,
                                 e.g_spill, e.n_vb)),
    ]


def phase_kernel_vs_plain(ns):
    from navierstokes_tpu_torch.kernels.bsr_spmv import (bsr_spmv,
                                                         bsr_spmv_plain)
    from navierstokes_tpu_torch.ops.bsr import convection_blk
    rng = np.random.default_rng(1234)
    uses = []
    for name, args in spmv_uses(ns, rng):
        yk = bsr_spmv(*args)
        yp = bsr_spmv_plain(*args)
        torch.cuda.synchronize()
        check(tuple(yk.shape) == tuple(yp.shape), f"{name} shape")
        abs_err = float((yk - yp).abs().max())
        rel = abs_err / max(float(yp.abs().max()), 1e-30)
        ms = _median_ms(lambda: bsr_spmv(*args))
        plain_ms = _median_ms(lambda: bsr_spmv_plain(*args))
        vals = args[0]
        log(f"[3] {name}: vals {tuple(vals.shape)}, max rel err {rel:.3e}, "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
            f"({vals.numel() * 4 / ms / 1e6:.0f} GB/s of values)")
        check(rel <= 1e-5, f"{name} kernel vs plain rel err {rel:.3e}")
        uses.append(dict(use=name, rel_err=rel, max_abs_err=abs_err, ms=ms,
                         plain_ms=plain_ms))
    # the convection rebuild is a fixed-order reduction: bit-identical
    u = torch.as_tensor(rng.standard_normal((ns.space.n_p2, 2)),
                        dtype=torch.float32, device=ns.device)
    check(torch.equal(convection_blk(ns.ell, u), convection_blk(ns.ell, u)),
          "convection_blk bit-identical on repeat")
    log("[3] convection rebuild bit-identical on repeat")
    return uses


def small_model(device, tmp, dtype="float32", **overrides):
    from navierstokes_tpu_torch.models.navier_stokes import NavierStokes
    from navierstokes_tpu.config import InletConfig, SolverConfig
    from navierstokes_tpu.mesh import channel_with_cylinder_2d
    inlet = InletConfig(kind="parabolic", u_m=0.3, height=0.41)
    cfg = SolverConfig(dtype=dtype, output_dir=os.path.join(tmp, "out"),
                       cache_dir=os.path.join(tmp, "cache"),
                       csv_path=os.path.join(tmp, "forces.csv"),
                       scheme="projection", proj_bdf2=True)
    for k, v in overrides.items():
        setattr(cfg, k, v)
    ns = NavierStokes(channel_with_cylinder_2d(h=0.1, h_near=0.04), 2, 1,
                      deltat=0.01, T=0.05, step=5, inlet=inlet, config=cfg,
                      device=device)
    ns.set_re_number(20)
    return ns.setup()


def phase_small_fixture():
    """CUDA fp32 against CPU fp32 (the gate), each also against CPU float64
    (printed only).  Cd and Cl are compared relative to the force
    coefficient's magnitude max(|Cd|, |Cl|): both are components of one
    force vector, and Cl is up to ~400x smaller than Cd here, so its own
    relative error would measure fp32 noise in Cd's units."""
    gpu = small_model("cuda", os.path.join(WORK, "small_gpu"))
    cpu = small_model("cpu", os.path.join(WORK, "small_cpu"))
    ref = small_model("cpu", os.path.join(WORK, "small_f64"), "float64")

    def rel_u(a, b):
        a, b = a.cpu().double(), b.cpu().double()
        return float((a - b).abs().max() / b.abs().max())

    worst = dict(cd=0.0, cl=0.0, u=0.0, its=0)
    for k in range(5):
        mg = gpu.solve_time_step()
        mc = cpu.solve_time_step()
        mr = ref.solve_time_step()
        scale = max(abs(mc.cd), abs(mc.cl), 1e-30)
        dcd = abs(mg.cd - mc.cd) / scale
        dcl = abs(mg.cl - mc.cl) / scale
        du = rel_u(gpu._u, cpu._u)
        dits = max(abs(mg.f_iterations - mc.f_iterations),
                   abs(mg.p_iterations - mc.p_iterations))
        log(f"[4] step {k + 1}: its cuda {mg.f_iterations}+{mg.p_iterations}"
            f" cpu {mc.f_iterations}+{mc.p_iterations}; Cd {mg.cd:.6f} vs "
            f"{mc.cd:.6f}, Cl {mg.cl:.6f} vs {mc.cl:.6f} (diff / max(|Cd|,"
            f"|Cl|): Cd {dcd:.2e}, Cl {dcl:.2e}), u rel {du:.2e}; against "
            f"CPU float64 ({mr.f_iterations}+{mr.p_iterations} its): u rel "
            f"cuda {rel_u(gpu._u, ref._u):.2e}, cpu {rel_u(cpu._u, ref._u):.2e}")
        for key, v in (("cd", dcd), ("cl", dcl), ("u", du), ("its", dits)):
            worst[key] = max(worst[key], v)
    log(f"[4] worst: Cd {worst['cd']:.2e}, Cl {worst['cl']:.2e}, u "
        f"{worst['u']:.2e} (limits 1e-4), iteration diff {worst['its']} "
        "(limit 1)")
    check(worst["cd"] <= 1e-4 and worst["cl"] <= 1e-4, "small Cd/Cl")
    check(worst["u"] <= 1e-4, "small u")
    check(worst["its"] <= 1, "small iteration counts")


def phase_bench(ns, card):
    from navierstokes_tpu_torch.kernels.bsr_spmv import COUNTS
    cfg = ns.config
    n_warm, n_meas = 10, 10
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    COUNTS.reset()
    ms_all = []
    for _ in range(n_warm):
        ms_all.append(ns.solve_time_step())
    torch.cuda.synchronize()
    launches_warm = COUNTS.launches
    t0 = time.perf_counter()
    for _ in range(n_meas):
        ms_all.append(ns.solve_time_step())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain_cuda = COUNTS.launches, COUNTS.plain_cuda_calls
    peak = torch.cuda.max_memory_allocated()
    sps = n_meas / wall
    log(f"[5] iterations BiCGStab+CG per step: "
        + " ".join(f"{m.f_iterations}+{m.p_iterations}" for m in ms_all))
    log(f"[5] tile rebuild ms per step: "
        + " ".join(f"{m.prec_seconds * 1e3:.2f}" for m in ms_all))
    last = ms_all[-1]
    log(f"[5] Cd {last.cd:.6f}, Cl {last.cl:.6f}, residual "
        f"{last.residual:.3e}, t {last.time:.5f}; measured CFL "
        f"{ns.measured_cfl():.3f}")
    log(f"[5] steps/s {sps:.4f} ({n_meas} steps in {wall:.3f} s) on {card}")
    log(f"[5] peak device memory {peak} bytes ({peak / 2**30:.2f} GiB) on "
        f"{card}")
    log(f"[5] kernel launches: {launches} over {n_warm + n_meas} steps, "
        f"{launches - launches_warm} in the timed window; plain-version "
        f"CUDA calls {plain_cuda}")
    tol = max(cfg.proj_tol, 3.0e-6)
    for m in ms_all:
        check(m.converged, f"converged at t={m.time}")
        check(m.f_iterations < cfg.proj_f_maxiter
              and m.p_iterations < cfg.proj_p_maxiter,
              f"iteration budget at t={m.time}")
        check(all(np.isfinite([m.cd, m.cl, m.residual])),
              f"finite forces at t={m.time}")
    check(bool(torch.isfinite(ns._u).all() and torch.isfinite(ns._p).all()),
          "finite u, p")
    check(launches > 0, "kernel launched on the main path")
    check(plain_cuda == 0, "no plain-version calls on CUDA tensors")
    log(f"[5] all {len(ms_all)} solves converged (rel tol {tol:g})")
    return dict(launches=launches, steps_per_s=sps, peak_bytes=peak)


def phase_variants(ns):
    """The bf16-values and fp64 kernels against their plain versions at the
    bench-point F shape: A0 cast to bf16 (x fp32) and to float64."""
    from navierstokes_tpu_torch.kernels.bsr_spmv import (bsr_spmv,
                                                         bsr_spmv_plain)
    e, dev = ns.ell, ns.device
    rng = np.random.default_rng(4321)
    x = rng.standard_normal((e.n_vb * e.bu, 2))
    out = {}
    for name, vdt, xdt, limit in (("bsr_spmv_bf16", torch.bfloat16,
                                   torch.float32, 1e-5),
                                  ("bsr_spmv_f64", torch.float64,
                                   torch.float64, 1e-12)):
        args = (ns.a0_cell.to(vdt), e.f_cols,
                torch.as_tensor(x, dtype=xdt, device=dev), e.bu, e.f_spill,
                e.n_vb)
        yk = bsr_spmv(*args)
        yp = bsr_spmv_plain(*args)
        torch.cuda.synchronize()
        check(yk.dtype == yp.dtype == xdt, f"{name} output dtype")
        abs_err = float((yk - yp).abs().max())
        rel = abs_err / max(float(yp.abs().max()), 1e-30)
        ms = _median_ms(lambda: bsr_spmv(*args))
        plain_ms = _median_ms(lambda: bsr_spmv_plain(*args))
        vals = args[0]
        gbs = vals.numel() * vals.element_size() / ms / 1e6
        log(f"[6] {name}: vals {tuple(vals.shape)} {vals.dtype}, max rel "
            f"err {rel:.3e} (limit {limit:g}), kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms ({gbs:.0f} GB/s of values)")
        check(rel <= limit, f"{name} kernel vs plain rel err {rel:.3e}")
        out[name] = dict(rel_err=rel, max_abs_err=abs_err, ms=ms,
                         plain_ms=plain_ms, gb_per_s=gbs)
    return out


# the small-fixture monolithic configurations of phase 7, and the launch
# count each must show
MONO_SMALL = (("cc", {}, "launches"),
              ("asimple", dict(preconditioner="asimple"), "launches"),
              ("cc+inner_bf16", dict(inner_bf16=True), "launches_bf16"),
              ("cc+refine=2", dict(refine=2, refine_tol=1e-3),
               "launches_f64"))


def phase_monolithic_small():
    """CUDA fp32 against CPU fp32 (the gate: phase 4's limits) and both
    against CPU float64 (printed), 5 monolithic steps per configuration;
    every kernel the configuration's path runs must launch."""
    from navierstokes_tpu_torch.kernels.bsr_spmv import COUNTS
    launches = {}

    def rel_u(a, b):
        a, b = a.cpu().double(), b.cpu().double()
        return float((a - b).abs().max() / b.abs().max())

    for tag, kw, field in MONO_SMALL:
        kw = dict(scheme="monolithic", **kw)
        d = os.path.join(WORK, "mono_" + tag.replace("+", "_")
                         .replace("=", ""))
        gpu = small_model("cuda", d + "_gpu", **kw)
        cpu = small_model("cpu", d + "_cpu", **kw)
        ref = small_model("cpu", d + "_f64", "float64", **kw)
        worst = dict(cd=0.0, cl=0.0, u=0.0, its=0, u64=0.0)
        counts = dict(launches=0, launches_bf16=0, launches_f64=0)
        for k in range(5):
            torch.cuda.synchronize()
            COUNTS.reset()
            mg = gpu.solve_time_step()
            torch.cuda.synchronize()
            check(COUNTS.plain_cuda_calls == 0,
                  f"[7] {tag}: no plain-version calls on CUDA tensors")
            for f in counts:
                counts[f] += getattr(COUNTS, f)
            mc = cpu.solve_time_step()
            mr = ref.solve_time_step()
            scale = max(abs(mc.cd), abs(mc.cl), 1e-30)
            dcd = abs(mg.cd - mc.cd) / scale
            dcl = abs(mg.cl - mc.cl) / scale
            du = rel_u(gpu._u, cpu._u)
            du64 = min(rel_u(gpu._u, ref._u), rel_u(cpu._u, ref._u))
            dits = abs(mg.iterations - mc.iterations)
            check(mg.converged and mc.converged,
                  f"[7] {tag}: FGMRES converged at step {k + 1}")
            log(f"[7] {tag} step {k + 1}: FGMRES its cuda {mg.iterations} "
                f"cpu {mc.iterations} (float64 {mr.iterations}); Cd "
                f"{mg.cd:.6f} vs {mc.cd:.6f} (diff / max(|Cd|,|Cl|): Cd "
                f"{dcd:.2e}, Cl {dcl:.2e}), u rel {du:.2e}; against CPU "
                f"float64: u rel cuda {rel_u(gpu._u, ref._u):.2e}, cpu "
                f"{rel_u(cpu._u, ref._u):.2e}; residual cuda "
                f"{mg.residual:.2e}")
            for key, v in (("cd", dcd), ("cl", dcl), ("u", du),
                           ("its", dits), ("u64", du64)):
                worst[key] = max(worst[key], v)
        # phase 4's gate, 1e-4; 1e-3 only where the CUDA-CPU gap is fp32
        # noise of the solves: below both fp32 runs' distance to float64
        gate = 1e-4
        gap = max(worst["cd"], worst["cl"], worst["u"])
        if 1e-4 < gap <= 1e-3 and gap <= worst["u64"]:
            gate = 1e-3
        log(f"[7] {tag} worst: Cd {worst['cd']:.2e}, Cl {worst['cl']:.2e}, "
            f"u {worst['u']:.2e} (gate {gate:g}; fp32 runs to float64 up "
            f"to {worst['u64']:.2e}), iteration diff {worst['its']} (limit "
            f"1); launches over 5 steps: fp32 {counts['launches']}, bf16 "
            f"{counts['launches_bf16']}, fp64 {counts['launches_f64']}")
        check(worst["cd"] <= gate and worst["cl"] <= gate, f"{tag} Cd/Cl")
        check(worst["u"] <= gate, f"{tag} u")
        check(worst["its"] <= 1, f"{tag} iteration counts")
        check(counts[field] > 0, f"{tag}: {field} > 0 on its path")
        check(counts["launches"] > 0, f"{tag}: fp32 launches > 0")
        launches[tag] = counts
    return launches


def phase_monolithic_bench(card):
    """The bench configuration under scheme="monolithic" (FGMRES with the
    Cahouet-Chabard preconditioner, BDF1): 5 warm-up + 5 timed steps, or
    3 + 3 when a warm-up step takes more than 10 s."""
    from navierstokes_tpu_torch.kernels.bsr_spmv import COUNTS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ns = bench_model("cuda", scheme="monolithic", preconditioner="cc")
    ns.setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cfg = ns.config
    check(ns.space.n_dofs == EXPECTED_DOFS, "monolithic DoF count")
    log(f"[8] monolithic bench point: {ns.space.n_dofs} DoF, setup "
        f"{setup_s:.1f} s, G/B whole rows: {ns.ell.g_spill is None}")
    COUNTS.reset()
    ms_all, step_s = [], []
    n_warm = n_meas = 5
    k = 0
    while k < n_warm:
        t1 = time.perf_counter()
        ms_all.append(ns.solve_time_step())
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t1)
        k += 1
        if step_s[-1] > 10.0 and n_warm == 5:
            n_warm = n_meas = 3
            log(f"[8] a warm-up step took {step_s[-1]:.1f} s: running 3 "
                "warm-up + 3 timed steps instead of 5 + 5")
    t0 = time.perf_counter()
    for _ in range(n_meas):
        ms_all.append(ns.solve_time_step())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain_cuda = COUNTS.launches, COUNTS.plain_cuda_calls
    peak = torch.cuda.max_memory_allocated()
    sps = n_meas / wall
    log(f"[8] FGMRES iterations per step: "
        + " ".join(str(m.iterations) for m in ms_all))
    log(f"[8] residual per step: "
        + " ".join(f"{m.residual:.2e}" for m in ms_all))
    log(f"[8] tile rebuild ms per step: "
        + " ".join(f"{m.prec_seconds * 1e3:.2f}" for m in ms_all))
    log(f"[8] warm-up step s: " + " ".join(f"{t:.3f}" for t in step_s))
    last = ms_all[-1]
    log(f"[8] Cd {last.cd:.6f}, Cl {last.cl:.6f}, t {last.time:.5f}; "
        f"measured CFL {ns.measured_cfl():.3f}")
    log(f"[8] steps/s {sps:.4f} ({n_meas} steps in {wall:.3f} s), setup "
        f"{setup_s:.1f} s, on {card}")
    log(f"[8] peak device memory {peak} bytes ({peak / 2**30:.2f} GiB) on "
        f"{card}")
    log(f"[8] kernel launches over {n_warm + n_meas} steps: {launches}; "
        f"plain-version CUDA calls {plain_cuda}")
    tol = max(cfg.outer_tol, 3.0e-6)
    for m in ms_all:
        check(m.converged, f"[8] FGMRES converged (rel tol {tol:g}) at "
              f"t={m.time}")
        check(m.iterations < cfg.outer_maxiter, f"[8] budget at t={m.time}")
        check(all(np.isfinite([m.cd, m.cl, m.residual])),
              f"[8] finite forces at t={m.time}")
    check(bool(torch.isfinite(ns._u).all() and torch.isfinite(ns._p).all()),
          "[8] finite u, p")
    check(launches > 0, "[8] kernel launched on the monolithic path")
    check(plain_cuda == 0, "[8] no plain-version calls on CUDA tensors")
    log(f"[8] all {len(ms_all)} FGMRES solves converged (rel tol {tol:g})")
    return dict(launches=launches, steps_per_s=sps, peak_bytes=peak,
                setup_s=setup_s)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    os.makedirs(WORK, exist_ok=True)
    card = phase_device()
    phase_build()
    t0 = time.perf_counter()
    ns = bench_model("cuda").setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_dofs = ns.space.n_dofs
    log(f"[3] bench point: {n_dofs} DoF, setup {setup_s:.1f} s")
    check(n_dofs == EXPECTED_DOFS, f"DoF count {n_dofs}")
    uses = phase_kernel_vs_plain(ns)
    phase_small_fixture()
    bench = phase_bench(ns, card)
    variants = phase_variants(ns)
    del ns
    gc.collect()
    torch.cuda.empty_cache()
    small = phase_monolithic_small()
    mono = phase_monolithic_bench(card)
    f_use = uses[0]
    bf16, f64 = variants["bsr_spmv_bf16"], variants["bsr_spmv_f64"]
    record = {"kernels": [
        {"name": "bsr_spmv", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES,
         "launches": bench["launches"] + mono["launches"],
         "max_abs_err": max(u["max_abs_err"] for u in uses),
         "ms": f_use["ms"], "plain_ms": f_use["plain_ms"], "uses": uses,
         "launches_by_path": {"projection bench (phase 5)": bench["launches"],
                              "monolithic bench (phase 8)": mono["launches"]}},
        {"name": "bsr_spmv_bf16", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES_BF16,
         "launches": small["cc+inner_bf16"]["launches_bf16"],
         "max_abs_err": bf16["max_abs_err"], "ms": bf16["ms"],
         "plain_ms": bf16["plain_ms"]},
        {"name": "bsr_spmv_f64", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": None,
         "launches": small["cc+refine=2"]["launches_f64"],
         "max_abs_err": f64["max_abs_err"], "ms": f64["ms"],
         "plain_ms": f64["plain_ms"]}]}
    log(card)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
