"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths — the Schaefer-Turek 2D-2 step on the
committed 1,014,414-DoF bench mesh (``.bench_mesh.npz``), fp32, in the
projection scheme and in the monolithic scheme; the Schaefer-Turek 3D-1Z
step at 3,393,382 DoF through the scenario registry; the CLI on the card —
and checks them:

1. device: the card's name and power limit, the toolchain (torch CUDA,
   nvcc, triton);
2. build of the CUDA kernels from ``navierstokes_tpu_torch/csrc``;
3. setup at the bench point (projection); the fp32 SELL SpMV kernel
   against its plain PyTorch version in every use the two schemes give it
   (F, mass, P1 Laplacian, Ap, G, B, PCD convection), bit-identical on
   repeat, with times from CUDA events: per call in bursts, L2-cold
   (cycling through copies of the operator that exceed the L2) and warm,
   and one call alone; beside them the plain version, the bound (bytes
   over 3.35 TB/s) and a PyTorch CSR product of the same matrix
   (``library_ms``, a yardstick the port never calls, timed like the
   kernel); the F rebuild (A0 + convection) per step;
4. a small fixture (h=0.1 cylinder channel): 5 BDF2 projection steps on
   the card against the same steps on the CPU, both fp32, with a second
   CPU fp32 run in another thread count as the measure of fp32 noise;
5. 20 bench-point projection steps (10 warm-up + 10 timed) through
   ``NavierStokes.solve_time_step``, replayed from the step's captured
   CUDA graphs (models/step_graphs.py, captured first), with the kernel's
   launch count per operator (from the graphs' replay records);
6. the bf16-values and fp64 kernel variants against their plain versions
   in every use, timed as in phase 3;
7. the small fixture under ``scheme="monolithic"``: 5 steps on the card
   (captured) against the CPU, fp32, with ``cc``, ``asimple``, ``cc`` +
   ``inner_bf16`` (the bf16 variant's path) and ``cc`` + ``refine=2`` (the
   fp64 variant's path), and against 5 eager steps on the card, bit for
   bit with the same SELL and Givens launches;
8. the monolithic bench point (FGMRES + Cahouet-Chabard, BDF1), after the
   projection model is freed: the step captured (models/step_graphs.py
   ``MonolithicGraphs``: FGMRES and inner BiCGStab iterations under
   conditional nodes; capture seconds, graphs, bodies per block, peak and
   reserved-memory growth), then 5 warm-up and 5 timed steps through
   ``solve_time_step``; host reads and skipped bodies per step, one
   Givens launch per FGMRES iteration;
9. a 3D small fixture (the h=0.15 square-column duct, 6,954 DoF): 5 steps
   on the card against the CPU, fp32, under phase 4's rule, for projection
   with ``bj`` and with ``jacobi``, monolithic ``cc``, ``cc`` +
   ``inner_bf16`` and ``cc`` + ``refine=2`` (the D=3 bf16 and fp64 paths);
10. 3D-1Z at full width (``scenarios.validate.build_case("3d1")`` on
   ``duct_with_box_obstacle_3d(h=0.023, h_near=0.007)``, the run of
   ``validate 3d1 --projection --f-precond diag``, nu=1e-3): 3
   warm-up and 5 timed steps, captured like phase 5's; setup seconds,
   capture seconds, steps/s, peak memory, the
   per-step iteration totals and Cd beside the TPU log's
   (``logs/st_3d1_34M_diagp1.log``, for information only);
11. the SpMV kernel in every 3D use on the 3D-1Z operators (F and the mass
   with D=3; the P1 Laplacian, G and B with D=1), all three variants,
   timed as in phase 3;
12. the CLI on the card: ``run 3d-test1`` for two steps at the scenario's
   default h with the default device;
13. a NACA small fixture (``2d-naca`` at h=0.1, 8 degrees, monolithic
   ``cc``): 5 steps on the card against the CPU, fp32, under phase 4's
   rule;
14. the NACA 2408 sweep at full size, as users run it:
   ``sweep-naca --angles 0 2 4 8 --T 1.0 --output-step 100`` through the
   CLI's main on the default device at the scenario's h=0.02 (157,634 to
   157,958 DoF, 100 monolithic ``cc`` steps per angle), inside
   ``build/chip_smoke/naca``; the DoF counts of the TPU sweep's log, every
   step's FGMRES count under its budget, finite rows, the thin-airfoil
   criteria of tests/test_naca_values.py on the four final Cl; setup
   seconds and steps/s per angle, peak memory, the steps' launches per
   step (the setups' launches apart) and the final Cd/Cl beside the TPU
   csv's (``artifacts/naca_sweep``, for information only); the sweep's
   steps are captured, and its 8 degree run again through the CLI with the
   plain step gives the same FGMRES counts, Cd and Cl at every step; then
   the fp32
   kernel against its plain version in every use of the NACA step (F,
   mass, P1 Laplacian, Ap, G, B) on a 2d-naca model at h=0.02, timed as
   in phase 3 (the record's ``sell_spmv_naca`` entry);
15. checkpoint post-processing: ``run 2d-test1`` for 4 steps with
   ``--output-step 2``, then ``postprocess --t0 0 --t1 4 --step 2``
   through the CLI (the VTUs), and the same replay through
   ``NavierStokes.post_process``, whose Cd/Cl equal the live csv rows to
   1e-6 relative;
16. the outlet pressure ``p_out`` and a forcing term on the phase 4 small
   fixture, in both schemes: 5 steps on the card against the CPU, fp32,
   under phase 4's rule;
17. ``StokesSolver`` in float64 on the card: the manufactured solution of
   tests/test_torch_stokes.py on the unit square, P2/P1 (n = 4, 8, 16) and
   P3/P2 (n = 4, 8); the L2 errors equal the CPU's to 1e-9 relative and
   converge at the Taylor-Hood rates (P2/P1: u > 2.5, p > 1.5; P3/P2:
   u > 3.5, p > 2.5);
18. the generic element ("cells") operator of ``NavierStokes``: on the
   h=0.15 cylinder channel, P2/P1 with ``operator="cells"`` and aSIMPLE,
   P3/P2 with ``cc`` (aSIMPLE on cells) and with ``ayosida``, and on the
   3D small fixture P2/P1 cells, 1 step each on the card against the
   CPU in float64 with the inner solves at 1e-10 within 1e-9;
   P3/P2 ``cc`` and ``cc`` + ``inner_bf16`` in fp32, 2 steps, card and
   CPU each within 1e-3 of the CPU float64 run; then Schaefer-Turek 2D-1
   in P3/P2 at full width (``validate.build_case("2d1", degree=3)`` on
   ``channel_with_cylinder_2d(h=0.010, h_near=0.0033)``, 654,022 DoF,
   fp32, FGMRES unrestarted): 1 warm-up and 2 timed steps, every step
   converged, Cd against the float64 run's, no SELL launch; steps/s,
   FGMRES iterations, setup seconds and peak memory on a line of their
   own before the kernel record;
19. the validation driver as users run it, in a process of its own:
   ``python -m navierstokes_tpu_torch.scenarios.validate 2d2 --projection
   --h 0.05 --T 0.05`` (13,518 DoF, 20 steps) on the default device; exit
   code 0, a last JSON line with finite Cd_max, Cl_max and St, every step
   converged and the fp32 SELL kernel launched with D=1 and D=2;
20. row sharding (``n_devices=2``, both shards on ``cuda:0``, right after
   phase 6 while the phase 5 model lives): the bench point's projection
   model on two row shards, 3 steps bit for bit against phase 5's first 3
   (u, p, Cd, Cl, iteration counts) with their ms per step beside phase
   5's; the sharded F (the step's values at phase 5's state), mass, G
   and B products, the convection slot values and the block-Jacobi tiles
   (the seed's exact inverse, Newton-Schulz, the per-step exact inverse) bit
   for bit against the unsharded ones;
   each shard's operator bytes against the one-device operators' and the
   home device's memory; then the phase 4 small fixture in monolithic
   ``cc`` on three shards against one, bit for bit (the sharded steps are
   eager, phase 5's captured);
21. (right after phase 5) the device-resident loops: from phase 5's end
   state, 10 bench-point steps eager (``solve_time_step(_eager=True)``)
   and 10 captured, in the order eager, captured, captured, eager, every
   run equal bit for bit (u, p, Cd, Cl, BiCGStab + CG counts) and with the
   same SELL launches per step, the first captured run with
   ``set_sync_debug_mode("error")`` around each replay; steps/s of each
   run, flag reads and masked iterations per step, capture seconds, peak
   memory; the exact tile inverse at the bench point's 1,760 tiles
   (``inv_ex`` gives ``inv``'s bits; the capturable cuSOLVER LU against
   it); one chunked ``solve`` of 16 steps from the initial state (chunks
   of 8) whose csv equals phase 5's first 16 steps; the Givens kernel
   (csrc/arnoldi_lsq.cu, its bounds read from the device) against its
   plain version at every call of 5 eager FGMRES steps of the monolithic
   small fixture, bit for bit, and its time per launch from the host and
   replayed from a graph;
22. (right after phase 8) the captured monolithic step: from phase 8's
   end state, 5 bench-point steps captured, eager, captured, eager, every
   run equal bit for bit (u, p, Cd, Cl, FGMRES counts, residuals) with
   the same SELL and Givens launches per step, the first captured run
   with ``set_sync_debug_mode("error")`` around each replay; steps/s of
   each run, host reads and skipped (captured) or masked (eager)
   iterations per step, the capture's seconds and memory, peak memory;
   then the conditional nodes' kernel (csrc/graph_cond.cu) against the
   host read it replaces on 64 seeded flags, and its device time per node
   skipped and run (the record's ``set_condition`` entry);
23. the cells operator on cell shards (parallel/sharded_cells.py, two
   shards of ``cuda:0``): the four configurations of phase 18 in float64,
   1 step against phase 18's one-card step within 1e-9 with equal FGMRES
   counts; every cells product on one shard bit for bit and on two
   within 1e-12 of ``CellOps``; P3/P2 ``cc`` + ``inner_bf16`` in fp32
   within 1e-3 of phase 18's float64 run; then the 2D-1 P3/P2 window of
   phase 18 at 654,022 DoF on two shards, 1 step, converged with its Cd
   within CD_2D1_P3_GATE of the float64 run's, no SELL launch, the bytes
   per shard and the step's seconds beside phase 18's step 1; then
   ``config.scheme`` changed after 2 steps of the small fixture, in both
   directions: the captured model captures the new scheme's graphs and
   equals the eager model bit for bit.

Each path is driven with the launch counts set to 0 just before it and
read just after.  Any failed check raises, so the exit code is not 0.
The last two lines of standard output are the kernel record and the
result, each one JSON object.  Imports no jax and nothing of the JAX
package.
"""

import collections
import dataclasses
import functools
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
EXPECTED_DOFS_3D1 = 3_393_382
# The TPU run of 3D-1Z at the same configuration (logs/st_3d1_34M_diagp1.log,
# steps 1-10): BiCGStab + CG iteration totals and Cd, for information only.
TPU_3D1_ITERATIONS = (50, 53, 53, 53, 50, 49, 45, 47, 42, 46)
TPU_3D1_CD = (359.26416, 63.56329, -106.23231, -31.44829, 44.90467,
              32.63485, 2.34678, 0.40246, 10.37975, 12.54377)
KERNEL_SOURCE = "navierstokes_tpu_torch/csrc/sell_spmv.cu"
# the Pallas kernel body's fp32 and bf16 branches (fused_reduce's _kernel)
REPLACES = "navierstokes_tpu/ops/pallas_matvec.py:59"
REPLACES_BF16 = "navierstokes_tpu/ops/pallas_matvec.py:53"
# The bench configuration (bench.py) with one change: the Poisson CG budget
# is 100, not the default 50.  At 50 the start-up steps 1, 2 and 4 stop at
# the budget (3+50, 6+50, 4+50 BiCGStab+CG iterations; the JAX run on the
# TPU shows the same totals), and this script requires every solve of the
# 20 steps to converge.
CG_BUDGET = 100
# The NACA 2408 sweep of tests/2D/test_naca/run_test.sh as the TPU round ran
# it (artifacts/naca_sweep/sweep.log): the DoF count of the 2d-naca mesh at
# its default h=0.02 per angle of attack, and T=1.0 (100 steps of 0.01).
NACA_DOFS = {0: 157_634, 2: 157_958, 4: 157_670, 8: 157_859}
NACA_SWEEP_ARGS = ("--T", "1.0", "--output-step", "100")
NACA_TPU_CSV = os.path.join(HERE, "artifacts", "naca_sweep",
                            "output_{:g}.csv")
HBM_BYTES_PER_S = 3.35e12     # published H100 SXM device-memory rate
FLUSH_BYTES = 128 << 20       # read between calls timed L2-cold
L2_BYTES = 50 << 20           # H100 L2
BURST = 40                    # calls per timed burst of the kernel


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


def bench_model(device, shard_devices=None, **overrides):
    from navierstokes_tpu_torch.config import InletConfig, SolverConfig
    from navierstokes_tpu_torch.mesh.geometry import Mesh
    from navierstokes_tpu_torch.models.navier_stokes import NavierStokes
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
                      inlet=inlet, config=cfg, device=device,
                      shard_devices=shard_devices)
    ns.set_re_number(100)
    return ns


@functools.lru_cache(maxsize=1)
def _flush_buffer():
    return torch.ones(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")


def per_step_launches(n_steps, by_pattern=None):
    """Kernel launches per step by operator and value dtype (``by_pattern``,
    by default the launch counts of the path just driven)."""
    from navierstokes_tpu_torch.kernels.sell_spmv import COUNTS
    by_pattern = COUNTS.by_pattern if by_pattern is None else by_pattern
    return {f"{name} {str(dt).replace('torch.', '')}": v / n_steps
            for (name, dt), v in by_pattern.items()}


def _time_ms(fn, cold, n=30):
    """Median device time of one call of ``fn`` over ``n`` calls, each
    between two CUDA events.  A spin on the stream before each call keeps
    the host's launch cost out of the interval; ``cold`` first reads a
    FLUSH_BYTES buffer (a read, so L2 holds no dirty lines to write back),
    so the call finds its inputs outside the 50 MB L2, as on the main path,
    where the 461 MB tile apply runs between products."""
    flush = _flush_buffer()
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


def _burst_ms(fns, reps=10):
    """Median device time per call of bursts of BURST calls cycling through
    ``fns``, between two CUDA events.  A spin on the stream holds the card
    while the host queues the burst, so the calls run back to back and
    neither the host's launch cost nor the events' own latency enter the
    time; a burst whose spin ended before the host finished queuing is run
    again with a longer spin."""
    calls = [fns[i % len(fns)] for i in range(max(BURST, len(fns)))]
    for f in fns:
        f()
    spin = len(calls) * 200_000          # cycles, about 0.1 ms per call
    times = []
    while len(times) < reps:
        torch.cuda._sleep(spin)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for f in calls:
            f()
        b.record()
        if a.query():                    # the card waited for the host
            b.synchronize()
            spin *= 2
            check(spin < 2 ** 31, "burst timing: the host cannot keep up")
            continue
        b.synchronize()
        times.append(a.elapsed_time(b) / len(calls))
    return statistics.median(times)


def _copies(mat, vals):
    """Copies of a pattern and its values that together exceed twice the
    L2, so that a burst cycling through them finds each one in HBM, as on
    the main path, where the 461 MB tile apply runs between products."""
    size = (vals.numel() * vals.element_size()
            + 4 * (mat.cols.numel() + mat.slice_ptr.numel()
                   + mat.rows.numel()))
    k = max(2, -(-2 * L2_BYTES // size))
    return [(dataclasses.replace(mat, cols=mat.cols.clone(),
                                 slice_ptr=mat.slice_ptr.clone(),
                                 rows=mat.rows.clone()), vals.clone())
            for _ in range(k)]


# value dtype -> (x dtype, kernel-vs-plain limit, record name)
VARIANTS = {torch.float32: (torch.float32, 1e-5, "sell_spmv"),
            torch.bfloat16: (torch.float32, 1e-5, "sell_spmv_bf16"),
            torch.float64: (torch.float64, 1e-12, "sell_spmv_f64")}


def spmv_uses(ns, rng):
    """(use, pattern, fp32 values, fp32 x) of every SpMV use of the two
    schemes at the bench-point shapes: the projection setup's operators,
    Ap (the monolithic Cahouet-Chabard operator) assembled on the same
    mesh, F and the PCD convection at a numpy-seeded velocity.  The Schur
    diagonal is B's pattern with squared values, the same product as B."""
    from navierstokes_tpu_torch.ops.bsr import (convection_blk,
                                                pressure_convection_blk)
    from navierstokes_tpu_torch.ops.p1ell import assemble_ap
    e, dev, sp = ns.ell, ns.device, ns.space
    x = lambda *shape: torch.as_tensor(rng.standard_normal(shape),
                                       dtype=torch.float32, device=dev)
    u = 0.5 * x(sp.n_p2, 2)
    ap = assemble_ap(sp, ns._cells_host,
                     ns.bc.host_mask[:, 0] / ns._lumped_host, torch.float32,
                     dev, b=e.bp)
    lap = ns._ap_dir
    return [
        ("F", e.f, ns.a0_cell + convection_blk(e, u), x(sp.n_p2, 2)),
        ("mass", e.f, e.m_vals, x(sp.n_p2, 2)),
        ("P1 Laplacian", lap.mat, lap.vals, x(sp.n_p1)),
        ("Ap", ap.mat, ap.vals, x(sp.n_p1)),
        ("G", e.g, e.g_vals, x(sp.n_p1)),
        ("B", e.b, e.b_vals, x(sp.n_p2 * 2)),
        ("PCD convection", e.pp, pressure_convection_blk(e, u),
         x(sp.n_p1)),
    ]


def _library_fn(mat, vals, x):
    """One PyTorch call computing the same product: torch.sparse.mm on a
    CSR tensor of the same nonzeros (the port never calls it)."""
    idx = torch.as_tensor(mat.nz_slot, device=vals.device)
    crow = np.zeros(mat.n_rows + 1, np.int64)
    np.cumsum(np.bincount(mat.nz_row, minlength=mat.n_rows), out=crow[1:])
    a = torch.sparse_csr_tensor(
        torch.as_tensor(crow, device=vals.device),
        torch.as_tensor(mat.nz_col, device=vals.device), vals[idx],
        size=(mat.n_rows, mat.n_cols), check_invariants=False)
    x2 = x[:, None] if x.dim() == 1 else x
    return lambda: torch.sparse.mm(a, x2)


def check_and_time(use, mat, vals, x, tag):
    """The kernel against its plain version on one use, bit-identical
    repeats, and its times beside the bound and the library call."""
    from navierstokes_tpu_torch.kernels.sell_spmv import (sell_spmv,
                                                          sell_spmv_plain)
    xdt, limit, _ = VARIANTS[vals.dtype]
    x = x.to(xdt)
    yk = sell_spmv(mat, vals, x)
    yk2 = sell_spmv(mat, vals, x)
    yp = sell_spmv_plain(mat, vals, x)
    torch.cuda.synchronize()
    check(tuple(yk.shape) == tuple(yp.shape) and yk.dtype == yp.dtype == xdt,
          f"{use} {vals.dtype}: shape/dtype")
    check(torch.equal(yk, yk2), f"{use} {vals.dtype}: bit-identical repeat")
    abs_err = float((yk - yp).abs().max())
    rel = abs_err / max(float(yp.abs().max()), 1e-30)
    check(rel <= limit, f"{use} {vals.dtype}: kernel vs plain rel err "
          f"{rel:.3e} (limit {limit:g})")
    D = 1 if x.dim() == 1 else x.shape[1]
    nbytes = (mat.nnz * (vals.element_size() + 4)
              + (mat.n_cols + mat.n_rows) * D * x.element_size())
    copies = _copies(mat, vals)
    kernel = lambda m, v: (lambda: sell_spmv(m, v, x))
    out = dict(use=use, rel_err=rel, max_abs_err=abs_err, nnz=mat.nnz,
               slots=mat.n_slots,
               ms=_burst_ms([kernel(m, v) for m, v in copies]),
               warm_ms=_burst_ms([kernel(mat, vals)]),
               single_ms=_time_ms(kernel(mat, vals), cold=True),
               plain_ms=_time_ms(lambda: sell_spmv_plain(mat, vals, x),
                                 cold=True),
               bound_bytes=nbytes,
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
               library_ms=None)
    if vals.dtype != torch.bfloat16:   # no library call rounds like it
        out["library_ms"] = _burst_ms([_library_fn(m, v, x)
                                       for m, v in copies])
    del copies
    lib = ("n/a" if out["library_ms"] is None
           else f"{out['library_ms']:.4f}")
    log(f"[{tag}] {use} {vals.dtype}: {mat.n_rows}x{mat.n_cols}, nnz "
        f"{mat.nnz}, slots {mat.n_slots}; rel err {rel:.3e} (limit "
        f"{limit:g}); ms cold {out['ms']:.4f} warm {out['warm_ms']:.4f} "
        f"(one call between events, cold {out['single_ms']:.4f}) plain "
        f"{out['plain_ms']:.4f} library {lib}; bound "
        f"{out['bound_ms']:.4f} ({nbytes} B, "
        f"{nbytes / out['ms'] / 1e6:.0f} GB/s cold)")
    return out


def phase_kernel_vs_plain(ns, dtypes, tag):
    """Every use in each value dtype of ``dtypes`` (fp32 values: the
    setup's; bf16 and fp64: the fp32 values cast)."""
    from navierstokes_tpu_torch.ops.bsr import convection_blk
    rng = np.random.default_rng(1234)
    uses = spmv_uses(ns, rng)
    out = {dt: [check_and_time(use, mat, vals.to(dt), x, tag)
                for use, mat, vals, x in uses] for dt in dtypes}
    if torch.float32 in dtypes:
        # the launch floor: the kernel on a one-slice pattern, in a burst
        # and alone between two events
        from navierstokes_tpu_torch.kernels.sell_spmv import sell_spmv
        from navierstokes_tpu_torch.ops.sell import build_sell
        tiny = build_sell(np.arange(32), np.arange(32), 32, 32, ns.device)
        ones = torch.ones(32, device=ns.device)
        one = lambda: sell_spmv(tiny, ones, ones)
        out["floor_ms"] = _burst_ms([one])
        single = _time_ms(one, cold=False)
        log(f"[{tag}] launch floor (one 32-row slice): {out['floor_ms']:.4f}"
            f" ms per call in a burst, {single:.4f} ms alone between two "
            "events")
        # the per-step F rebuild: fixed-order reductions, bit-identical
        e = ns.ell
        u = torch.as_tensor(rng.standard_normal((ns.space.n_p2, 2)),
                            dtype=torch.float32, device=ns.device)
        check(torch.equal(convection_blk(e, u), convection_blk(e, u)),
              "convection rebuild bit-identical on repeat")
        from navierstokes_tpu_torch.ops.operators import convection_matrices
        ms = _time_ms(lambda: ns.a0_cell + convection_blk(e, u), cold=True)
        c_elem = convection_matrices(e, e.t_hat, u).reshape(-1)
        elem_ms = _time_ms(lambda: convection_matrices(e, e.t_hat, u),
                           cold=True)
        plan_ms = _time_ms(lambda: e.conv_plan(c_elem), cold=True)
        log(f"[{tag}] F rebuild (A0 + convection into the compact slots) "
            f"{ms:.4f} ms: element matrices {elem_ms:.4f}, reduction into "
            f"the slots ({len(e.conv_plan.passes)} passes) {plan_ms:.4f}; "
            "bit-identical on repeat")
        out["rebuild_ms"] = ms
    return out


def small_model(device, tmp, dtype="float32", forcing=None,
                shard_devices=None, **overrides):
    from navierstokes_tpu_torch.config import InletConfig, SolverConfig
    from navierstokes_tpu_torch.mesh.generators import (
        channel_with_cylinder_2d)
    from navierstokes_tpu_torch.models.navier_stokes import NavierStokes
    inlet = InletConfig(kind="parabolic", u_m=0.3, height=0.41)
    cfg = SolverConfig(dtype=dtype, output_dir=os.path.join(tmp, "out"),
                       cache_dir=os.path.join(tmp, "cache"),
                       csv_path=os.path.join(tmp, "forces.csv"),
                       scheme="projection", proj_bdf2=True)
    for k, v in overrides.items():
        setattr(cfg, k, v)
    ns = NavierStokes(channel_with_cylinder_2d(h=0.1, h_near=0.04), 2, 1,
                      deltat=0.01, T=0.05, step=5, inlet=inlet, config=cfg,
                      device=device, forcing=forcing,
                      shard_devices=shard_devices)
    ns.set_re_number(20)
    return ns.setup()


def phase_small_fixture():
    """CUDA fp32 against CPU fp32 (the gate), each also against CPU float64
    (printed only).  Cd and Cl are compared relative to the force
    coefficient's magnitude max(|Cd|, |Cl|): both are components of one
    force vector, and Cl is up to ~400x smaller than Cd here, so its own
    relative error would measure fp32 noise in Cd's units.

    The gate is 1e-4, and 1e-3 only where the CUDA-CPU gap is fp32 noise:
    at most three times the gap between two CPU fp32 runs that differ only
    in their summation order (the default thread count and one other).
    Two such CPU runs alone differ by about 1e-4 of the force scale from
    step 2 on, where the tile inverses take the Newton-Schulz matmuls:
    1.27e-4 on an H100 host, 1.29e-4 with the blocked-ELL SpMV the port
    had before its SELL layout, and still 6e-5 with both solves at a
    relative tolerance of 1e-6 (tools/fp32_noise.py), so it is the fp32
    arithmetic of the step, not the solves' stopping point."""
    gpu = small_model("cuda", os.path.join(WORK, "small_gpu"))
    cpu = small_model("cpu", os.path.join(WORK, "small_cpu"))
    alt = small_model("cpu", os.path.join(WORK, "small_cpu_alt"))
    ref = small_model("cpu", os.path.join(WORK, "small_f64"), "float64")
    n_threads = torch.get_num_threads()
    alt_threads = 1 if n_threads > 1 else 4

    def gaps(ma, mb, a, b):
        scale = max(abs(mb.cd), abs(mb.cl), 1e-30)
        return (abs(ma.cd - mb.cd) / scale, abs(ma.cl - mb.cl) / scale,
                _rel(a._u, b._u))

    worst = dict(cd=0.0, cl=0.0, u=0.0, its=0, noise=0.0)
    for k in range(5):
        mg = gpu.solve_time_step()
        mc = cpu.solve_time_step()
        torch.set_num_threads(alt_threads)
        ma = alt.solve_time_step()
        torch.set_num_threads(n_threads)
        mr = ref.solve_time_step()
        dcd, dcl, du = gaps(mg, mc, gpu, cpu)
        noise = max(gaps(ma, mc, alt, cpu))
        dits = max(abs(mg.f_iterations - mc.f_iterations),
                   abs(mg.p_iterations - mc.p_iterations))
        log(f"[4] step {k + 1}: its cuda {mg.f_iterations}+{mg.p_iterations}"
            f" cpu {mc.f_iterations}+{mc.p_iterations}; Cd {mg.cd:.6f} vs "
            f"{mc.cd:.6f}, Cl {mg.cl:.6f} vs {mc.cl:.6f} (diff / max(|Cd|,"
            f"|Cl|): Cd {dcd:.2e}, Cl {dcl:.2e}), u rel {du:.2e}; CPU "
            f"{n_threads} vs {alt_threads} threads: worst of Cd, Cl, u "
            f"{noise:.2e}; against CPU float64 ({mr.f_iterations}+"
            f"{mr.p_iterations} its): u rel cuda {_rel(gpu._u, ref._u):.2e},"
            f" cpu {_rel(cpu._u, ref._u):.2e}")
        for key, v in (("cd", dcd), ("cl", dcl), ("u", du), ("its", dits),
                       ("noise", noise)):
            worst[key] = max(worst[key], v)
    gate = 1e-4
    gap = max(worst["cd"], worst["cl"], worst["u"])
    if 1e-4 < gap <= 1e-3 and gap <= 3 * worst["noise"]:
        gate = 1e-3
    log(f"[4] worst: Cd {worst['cd']:.2e}, Cl {worst['cl']:.2e}, u "
        f"{worst['u']:.2e} (gate {gate:g}; two CPU fp32 runs differ by up "
        f"to {worst['noise']:.2e}), iteration diff {worst['its']} (limit 1)")
    check(worst["cd"] <= gate and worst["cl"] <= gate, "small Cd/Cl")
    check(worst["u"] <= gate, "small u")
    check(worst["its"] <= 1, "small iteration counts")


def phase_bench(ns, card):
    from navierstokes_tpu_torch.kernels.sell_spmv import COUNTS
    cfg = ns.config
    n_warm, n_meas = 10, 10
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sg = ns.capture_graphs()
    capture_peak = torch.cuda.max_memory_allocated()
    log(f"[5] captured the projection step: {len(sg.graphs)} graphs in "
        f"{sg.capture_seconds:.2f} s (with a warm-up step), peak "
        f"{capture_peak} bytes")
    torch.cuda.reset_peak_memory_stats()
    COUNTS.reset()
    ms_all, first = [], dict(ms=[])
    for k in range(n_warm):
        t1 = time.perf_counter()
        ms_all.append(ns.solve_time_step())
        if k < SHARD_STEPS:      # phase 20's reference
            torch.cuda.synchronize()
            first["ms"].append((time.perf_counter() - t1) * 1e3)
        if k + 1 == SHARD_STEPS:
            first.update(u=ns._u.clone(), p=ns._p.clone(),
                         metrics=list(ms_all))
    torch.cuda.synchronize()
    launches_warm = COUNTS.launches
    t0 = time.perf_counter()
    for _ in range(n_meas):
        ms_all.append(ns.solve_time_step())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain_cuda = COUNTS.launches, COUNTS.plain_cuda_calls
    per_step = per_step_launches(n_warm + n_meas)
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
        f"CUDA calls {plain_cuda}; per step by operator {per_step}")
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
    end = {a: getattr(ns, a).clone() for a in ("_u", "_p", "_u_prev",
                                               "_phi", "_t")}
    end["time"] = ns.time
    return dict(launches=launches, steps_per_s=sps, peak_bytes=peak,
                per_step=per_step, first=first, metrics=ms_all, end=end,
                capture_s=sg.capture_seconds)


# phase 21: steps of each mode from phase 5's end state, and the chunked
# solve's length and chunk
GRAPH_STEPS = 10
CHUNK_STEPS, CHUNK_EVERY = 16, 8
GIVENS_SOURCE = "navierstokes_tpu_torch/csrc/arnoldi_lsq.cu"
# the JAX algebra the Givens kernel runs (no Pallas kernel): the stored
# rotations, fori_loop(rot_body), and the new rotation
GIVENS_REPLACES = "navierstokes_tpu/solvers/krylov.py:116"
FP32_OPS_PER_S = 67e12        # published H100 SXM fp32 rate, no tensor core


def _load_state(ns, state):
    for attr in ("_u", "_p", "_u_prev", "_phi", "_t"):
        setattr(ns, attr, state[attr].clone())
    ns.time = state["time"]


def phase_graphs(ns, bench, card):
    """Phase 21: eager against captured at the bench point, the exact
    tile inverse, the chunked solve, the Givens kernel.  Leaves ``ns`` in
    phase 5's end state."""
    from navierstokes_tpu_torch.kernels.sell_spmv import COUNTS
    from navierstokes_tpu_torch.ops import p1ell
    t_phase = time.perf_counter()
    sg = ns.capture_graphs()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for mode in ("eager", "captured", "captured", "eager"):
        _load_state(ns, bench["end"])
        sg.sync_check = mode == "captured" and not any(
            r["mode"] == "captured" for r in runs)
        COUNTS.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ms = [ns.solve_time_step(_eager=mode == "eager")
              for _ in range(GRAPH_STEPS)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs.append(dict(
            mode=mode, sync_check=sg.sync_check, steps_per_s=GRAPH_STEPS / wall,
            metrics=ms, u=ns._u.clone(), p=ns._p.clone(),
            launches=per_step_launches(GRAPH_STEPS),
            plain_cuda=COUNTS.plain_cuda_calls,
            flag_reads=sum(m.flag_reads for m in ms) / GRAPH_STEPS,
            masked=sum(m.masked_iterations for m in ms) / GRAPH_STEPS))
        log(f"[21] {mode}{' (sync-checked replays)' if sg.sync_check else ''}"
            f": {runs[-1]['steps_per_s']:.4f} steps/s ({GRAPH_STEPS} steps "
            f"in {wall:.3f} s), flag reads per step "
            f"{runs[-1]['flag_reads']:.2f}, masked iterations per step "
            f"{runs[-1]['masked']:.2f}, on {card}")
    sg.sync_check = False
    peak = torch.cuda.max_memory_allocated()
    ref = runs[0]
    its = [f"{m.f_iterations}+{m.p_iterations}" for m in ref["metrics"]]
    log(f"[21] iterations BiCGStab+CG per step: {' '.join(its)}; masked "
        "per step (captured): "
        + " ".join(str(m.masked_iterations) for m in runs[1]["metrics"]))
    for r in runs[1:]:
        same = (torch.equal(r["u"], ref["u"]) and torch.equal(r["p"], ref["p"])
                and all((a.cd, a.cl, a.f_iterations, a.p_iterations)
                        == (b.cd, b.cl, b.f_iterations, b.p_iterations)
                        for a, b in zip(r["metrics"], ref["metrics"])))
        check(same, f"[21] the {r['mode']} run equals the first eager run "
              "bit for bit (u, p, Cd, Cl, counts)")
        check(r["launches"] == ref["launches"],
              f"[21] {r['mode']}: SELL launches per step equal the eager "
              f"run's ({r['launches']} against {ref['launches']})")
    check(all(r["plain_cuda"] == 0 for r in runs),
          "[21] no plain-version calls on CUDA tensors")
    sps = {m: [r["steps_per_s"] for r in runs if r["mode"] == m]
           for m in ("eager", "captured")}
    log(f"[21] captured equals eager bit for bit in all four runs; SELL "
        f"launches per step (captured, from the replay records) "
        f"{runs[1]['launches']}")
    log(f"[21] capture {bench['capture_s']:.2f} s (phase 5), peak device "
        f"memory over the four runs {peak} bytes ({peak / 2**30:.2f} GiB); "
        f"steps/s eager {sps['eager']}, captured {sps['captured']} on "
        f"{card}")

    # the exact tile inverse at phase 5's end state
    _load_state(ns, bench["end"])
    mflat = ns.bc.mask[:, 0]
    f = ns.a0_cell + ns._ops.convection(ns.ell, ns._u)
    d = ns._ops.f_diag(ns.ell, f)
    sigma = torch.sum(d * mflat) / torch.clamp(torch.sum(mflat), min=1.0)
    tiles = p1ell.block_jacobi_tiles(ns._bj_plan, f, mflat, sigma)
    inv = torch.linalg.inv(tiles)
    same = torch.equal(torch.linalg.inv_ex(tiles).inverse, inv)
    cus = p1ell._inv_capturable(tiles)
    gap = float((cus - inv).abs().max() / inv.abs().max())
    inv_ms = _time_ms(lambda: torch.linalg.inv(tiles), cold=False, n=5)
    cus_ms = _time_ms(lambda: p1ell._inv_capturable(tiles), cold=False,
                      n=5)
    log(f"[21] exact inverse of the {tiles.shape[0]} tiles: inv_ex equals "
        f"inv bit for bit {same}; the capturable cuSOLVER LU against inv: "
        f"max gap {gap:.3e} of max|inv|; {cus_ms:.3f} ms against inv's "
        f"{inv_ms:.3f} ms")
    check(same, "[21] inv_ex gives inv's bits")
    check(gap < 1e-4, "[21] the cuSOLVER tile inverse within 1e-4 of inv")
    del tiles, inv, cus

    # one chunked solve from the initial state against phase 5's steps
    cfg = ns.config
    saved = (cfg.t_final, cfg.output_step, cfg.csv_path)
    cfg.t_final, cfg.output_step = CHUNK_STEPS * cfg.deltat, CHUNK_EVERY
    cfg.csv_path = os.path.join(WORK, "chunked.csv")
    t0 = time.perf_counter()
    ns.solve()
    wall = time.perf_counter() - t0
    cfg.t_final, cfg.output_step, cfg.csv_path = saved
    rows = _csv_rows(os.path.join(WORK, "chunked.csv"))
    want = bench["metrics"][:CHUNK_STEPS]
    same = len(rows) == CHUNK_STEPS and all(
        (r["time"], int(r["GMRES_iters"]), r["Drag"], r["Lift"], r["Cd"],
         r["Cl"]) == (m.time, m.iterations, m.drag, m.lift, m.cd, m.cl)
        for r, m in zip(rows, want))
    log(f"[21] chunked solve: {CHUNK_STEPS} steps in chunks of "
        f"{CHUNK_EVERY}, {wall:.2f} s with the VTU and checkpoint writes; "
        f"csv rows equal phase 5's steps 1-{CHUNK_STEPS} {same}; "
        f"time_prec_init {rows['time_prec_init'][-1]:.5f} s, time_sol "
        f"{rows['time_sol'][-1]:.5f} s at the last step")
    check(same, "[21] the chunked solve's csv equals phase 5's steps")
    check(np.isfinite(rows["time_sol"]).all()
          and (rows["time_prec_init"] > 0).all(), "[21] csv time columns")
    _load_state(ns, bench["end"])
    givens = phase_givens()
    log(f"[21] phase {time.perf_counter() - t_phase:.1f} s")
    return dict(runs=[{k: r[k] for k in ("mode", "sync_check",
                                         "steps_per_s", "flag_reads",
                                         "masked", "launches")}
                      for r in runs],
                peak_bytes=peak, capture_s=bench["capture_s"],
                inverse_gap=gap, givens=givens)


def _restore(dst, src):
    for a, b in zip(dst, src):
        a.copy_(b)


def phase_givens():
    """The Givens kernel against its plain version at every call of 5
    eager FGMRES steps of the monolithic small fixture (restart 64), bit
    for bit; then its time over 40 successive columns from the fixture's
    first Arnoldi state (target 0, so none stops early): launched from the
    host in a burst, and replayed from a captured graph of the 40 launches
    (its cost inside the captured monolithic step)."""
    from navierstokes_tpu_torch.kernels import arnoldi_lsq as AL
    from navierstokes_tpu_torch.kernels.launches import record_launches
    from navierstokes_tpu_torch.solvers import krylov
    calls = 0
    kept = {}

    def update(*args):
        nonlocal calls
        state = [a.clone() for a in args]
        AL.lsq_update(*args)
        plain = [a.cpu().clone() for a in state]
        AL.lsq_update_plain(*plain)
        for k in (0, 1, 2, 3, 7, 8, 9):
            check(torch.equal(args[k].cpu(), plain[k]),
                  f"[21] lsq_update kernel against plain, argument {k}")
        calls += 1
        if "update" not in kept and int(state[7]) == 0:
            kept["update"] = state

    orig = krylov.lsq_update
    krylov.lsq_update = update
    try:
        ns = small_model("cuda", os.path.join(WORK, "givens"),
                         scheme="monolithic", preconditioner="cc")
        ms = [ns.solve_time_step(_eager=True) for _ in range(5)]
    finally:
        krylov.lsq_update = orig
    torch.cuda.synchronize()
    check(calls > 0, "[21] the Givens kernel ran in the fixture's FGMRES")
    log(f"[21] Givens kernel against its plain version at every call of "
        f"5 monolithic small-fixture steps (FGMRES "
        f"{[m.iterations for m in ms]}): {calls} calls, all bit for bit")

    # lsq_update: 40 successive columns j = 0..39, restored between bursts
    H, cs, sn, g, h1, h2, wn, j, res, act, tgt, j_max = kept["update"]
    m = H.shape[1]
    # target 0 and a dominant new entry (each rotation's sine near 1, so
    # |g[j+1]| does not decay): every launch of the burst stays active
    tgt = torch.zeros_like(tgt)
    wn = torch.full_like(wn, 10.0 * float((h1 + h2).abs().max()) + 1.0)
    work = [t.clone() for t in (H, cs, sn, g, j, res, act)]
    init = [t.clone() for t in work]
    n = 40

    def timed(fn):
        times = []
        for _ in range(10):
            _restore(work, init)
            torch.cuda.synchronize()
            torch.cuda._sleep(n * 200_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / n)
        return statistics.median(times)

    kernel = lambda: AL.lsq_update(work[0], work[1], work[2], work[3], h1, h2,
                                   wn, work[4], work[5], work[6], tgt, j_max)
    plain = lambda: AL.lsq_update_plain(work[0], work[1], work[2], work[3],
                                        h1, h2, wn, work[4], work[5],
                                        work[6], tgt, j_max)

    def burst(fn):
        return lambda: [fn() for _ in range(n)]

    upd_ms, upd_plain_ms = timed(burst(kernel)), timed(burst(plain))
    check(int(work[4]) == n, "[21] lsq_update timing: 40 active columns")
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    _restore(work, init)
    with record_launches(), torch.cuda.graph(graph, stream=stream):
        burst(kernel)()
    in_graph_ms = timed(graph.replay)
    check(int(work[4]) == n, "[21] lsq_update in a graph: 40 active columns")
    del graph
    s = H.element_size()
    # reads h1, h2, the j stored rotations, g[j], wnorm, j, j_max, the
    # flag and the target; writes H[:, j], cs[j], sn[j], g[j:j+2], res, j
    # and the flag
    upd_bytes = [s * (3 * (m + 1) + 2 * jj + 8) + 14 for jj in range(n)]
    upd_ops = [6 * jj + 9 + (m + 1) for jj in range(n)]
    upd_bound = statistics.mean(
        max(b / HBM_BYTES_PER_S, o / FP32_OPS_PER_S) * 1e3
        for b, o in zip(upd_bytes, upd_ops))
    log(f"[21] lsq_update (m={m}, j=0..{n - 1}): {upd_ms:.4f} ms per launch "
        f"in a burst, {in_graph_ms:.4f} ms per launch replayed from a "
        f"graph, plain {upd_plain_ms:.4f} ms, bound {upd_bound:.2e} ms "
        f"(bytes)")
    return dict(ms=upd_ms, in_graph_ms=in_graph_ms, plain_ms=upd_plain_ms,
                bound_ms=upd_bound, library_ms=None, calls=calls)


# the small-fixture monolithic configurations of phase 7, and the launch
# count each must show
MONO_SMALL = (("cc", {}, "launches"),
              ("asimple", dict(preconditioner="asimple"), "launches"),
              ("cc+inner_bf16", dict(inner_bf16=True), "launches_bf16"),
              ("cc+refine=2", dict(refine=2, refine_tol=1e-3),
               "launches_f64"))


def phase_monolithic_small():
    """CUDA fp32 (captured) against CPU fp32 (the gate: phase 4's limits)
    and both against CPU float64 (printed), 5 monolithic steps per
    configuration, and the captured steps against eager ones on the card,
    bit for bit with the same launches; every kernel the configuration's
    path runs must launch."""
    from navierstokes_tpu_torch.kernels import arnoldi_lsq
    from navierstokes_tpu_torch.kernels.sell_spmv import COUNTS
    launches = {}

    def step(ns, **kw):
        torch.cuda.synchronize()
        COUNTS.reset()
        arnoldi_lsq.COUNTS.reset()
        m = ns.solve_time_step(**kw)
        torch.cuda.synchronize()
        return m, (dict(COUNTS.by_variant), arnoldi_lsq.COUNTS.update,
                   COUNTS.plain_cuda_calls), {
                       f: getattr(COUNTS, f) for f in (
                           "launches", "launches_bf16", "launches_f64")}

    for tag, kw, field in MONO_SMALL:
        kw = dict(scheme="monolithic", **kw)
        d = os.path.join(WORK, "mono_" + tag.replace("+", "_")
                         .replace("=", ""))
        gpu = small_model("cuda", d + "_gpu", **kw)
        eag = small_model("cuda", d + "_eager", **kw)
        cpu = small_model("cpu", d + "_cpu", **kw)
        ref = small_model("cpu", d + "_f64", "float64", **kw)
        gpu.capture_graphs()
        worst = dict(cd=0.0, cl=0.0, u=0.0, its=0, u64=0.0)
        counts = dict(launches=0, launches_bf16=0, launches_f64=0)
        for k in range(5):
            mg, cg, fields = step(gpu)
            me, ce, _ = step(eag, _eager=True)
            check(cg[2] == 0 and ce[2] == 0,
                  f"[7] {tag}: no plain-version calls on CUDA tensors")
            for f in counts:
                counts[f] += fields[f]
            same = (torch.equal(gpu._u, eag._u)
                    and torch.equal(gpu._p, eag._p)
                    and (mg.cd, mg.cl, mg.iterations, mg.residual)
                    == (me.cd, me.cl, me.iterations, me.residual))
            check(same, f"[7] {tag} step {k + 1}: captured equals eager "
                  "bit for bit")
            check(cg[:2] == ce[:2], f"[7] {tag} step {k + 1}: captured "
                  f"launches {cg[:2]} equal eager {ce[:2]}")
            mc = cpu.solve_time_step()
            mr = ref.solve_time_step()
            scale = max(abs(mc.cd), abs(mc.cl), 1e-30)
            dcd = abs(mg.cd - mc.cd) / scale
            dcl = abs(mg.cl - mc.cl) / scale
            du = _rel(gpu._u, cpu._u)
            du64 = min(_rel(gpu._u, ref._u), _rel(cpu._u, ref._u))
            dits = abs(mg.iterations - mc.iterations)
            check(mg.converged and mc.converged,
                  f"[7] {tag}: FGMRES converged at step {k + 1}")
            log(f"[7] {tag} step {k + 1}: FGMRES its cuda {mg.iterations} "
                f"cpu {mc.iterations} (float64 {mr.iterations}); Cd "
                f"{mg.cd:.6f} vs {mc.cd:.6f} (diff / max(|Cd|,|Cl|): Cd "
                f"{dcd:.2e}, Cl {dcl:.2e}), u rel {du:.2e}; against CPU "
                f"float64: u rel cuda {_rel(gpu._u, ref._u):.2e}, cpu "
                f"{_rel(cpu._u, ref._u):.2e}; residual cuda "
                f"{mg.residual:.2e}; host reads captured {mg.flag_reads} "
                f"eager {me.flag_reads}")
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
            f"1); launches over 5 captured steps: fp32 "
            f"{counts['launches']}, bf16 {counts['launches_bf16']}, fp64 "
            f"{counts['launches_f64']}; captured equal to eager bit for bit "
            "at every step")
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
    from navierstokes_tpu_torch.kernels.sell_spmv import COUNTS
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
        f"{setup_s:.1f} s")
    from navierstokes_tpu_torch.kernels import arnoldi_lsq, conditional
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reserved0 = torch.cuda.memory_reserved()
    sg = ns.capture_graphs()
    capture = dict(
        capture_s=sg.capture_seconds,
        capture_peak_bytes=torch.cuda.max_memory_allocated(),
        reserved_growth_bytes=torch.cuda.memory_reserved() - reserved0,
        graphs=len(sg.graphs), nodes_per_block=sg.nodes_per_block,
        block=sg.ce)
    log(f"[8] captured the monolithic step: {len(sg.graphs)} graphs, "
        f"{sg.nodes_per_block} conditional bodies per FGMRES block of "
        f"{sg.ce}, in {sg.capture_seconds:.2f} s (with a warm-up step); "
        f"peak {capture['capture_peak_bytes']} bytes, reserved memory grew "
        f"by {capture['reserved_growth_bytes']} bytes (the graph pool and "
        f"the body pool) on {card}")
    torch.cuda.reset_peak_memory_stats()
    COUNTS.reset()
    arnoldi_lsq.COUNTS.reset()
    conditional.COUNTS.reset()
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
    per_step = per_step_launches(n_warm + n_meas)
    givens = dataclasses.asdict(arnoldi_lsq.COUNTS)
    nodes = conditional.COUNTS.set_condition
    peak = torch.cuda.max_memory_allocated()
    sps = n_meas / wall
    log(f"[8] Givens kernel launches over {n_warm + n_meas} steps: "
        f"{givens}; set_condition launches {nodes}")
    log(f"[8] host reads per step: "
        + " ".join(str(m.flag_reads) for m in ms_all)
        + "; skipped conditional bodies per step: "
        + " ".join(str(m.masked_iterations) for m in ms_all))
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
        f"plain-version CUDA calls {plain_cuda}; per step by operator "
        f"{per_step}")
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
    check(givens["update"] == sum(m.iterations for m in ms_all),
          "[8] the Givens kernel launched once per FGMRES iteration")
    check(nodes > 0, "[8] the conditional nodes' kernel launched")
    check(plain_cuda == 0, "[8] no plain-version calls on CUDA tensors")
    log(f"[8] all {len(ms_all)} FGMRES solves converged (rel tol {tol:g})")
    end = {a: getattr(ns, a).clone() for a in ("_u", "_p", "_u_prev",
                                               "_phi", "_t")}
    end["time"] = ns.time
    return dict(launches=launches, steps_per_s=sps, peak_bytes=peak,
                setup_s=setup_s, per_step=per_step, givens=givens,
                set_condition=nodes, n_steps=n_warm + n_meas, ns=ns,
                end=end, capture=capture)


# phase 22: bench-point monolithic steps of each run from phase 8's end
# state, and the conditional-node check's node count
MONO_GRAPH_STEPS = 5
NODE_CHECK = 64
COND_SOURCE = "navierstokes_tpu_torch/csrc/graph_cond.cu"
# JAX's loop predicate: the cond of FGMRES's lax.while_loop
COND_REPLACES = "navierstokes_tpu/solvers/krylov.py:132"


def phase_monolithic_graphs(mono, card):
    """Phase 22: from phase 8's end state, captured / eager / captured /
    eager runs of MONO_GRAPH_STEPS bench-point monolithic steps, bit for
    bit with the same SELL, Givens launches per step, the first captured
    run under set_sync_debug_mode("error"); then the conditional nodes'
    kernel against its plain version (a host read of the flag)."""
    from navierstokes_tpu_torch.kernels import arnoldi_lsq, conditional
    from navierstokes_tpu_torch.kernels.sell_spmv import COUNTS
    t_phase = time.perf_counter()
    ns, n = mono["ns"], MONO_GRAPH_STEPS
    sg = ns.capture_graphs()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for mode in ("captured", "eager", "captured", "eager"):
        _load_state(ns, mono["end"])
        sg.sync_check = mode == "captured" and not runs
        COUNTS.reset()
        arnoldi_lsq.COUNTS.reset()
        conditional.COUNTS.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ms = [ns.solve_time_step(_eager=mode == "eager") for _ in range(n)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs.append(dict(
            mode=mode, sync_check=sg.sync_check, steps_per_s=n / wall,
            metrics=ms, u=ns._u.clone(), p=ns._p.clone(),
            launches=per_step_launches(n),
            givens=arnoldi_lsq.COUNTS.update / n,
            set_condition=conditional.COUNTS.set_condition / n,
            plain_cuda=COUNTS.plain_cuda_calls,
            flag_reads=sum(m.flag_reads for m in ms) / n,
            masked=sum(m.masked_iterations for m in ms) / n))
        r = runs[-1]
        checked = " (sync-checked replays)" if r["sync_check"] else ""
        log(f"[22] {mode}{checked}"
            f": {r['steps_per_s']:.4f} steps/s ({n} steps in {wall:.3f} s), "
            f"host reads per step {r['flag_reads']:.2f}, "
            + ("skipped conditional bodies" if mode == "captured"
               else "masked iterations")
            + f" per step {r['masked']:.2f}, Givens launches per step "
            f"{r['givens']:.2f}, set_condition per step "
            f"{r['set_condition']:.2f}, on {card}")
    sg.sync_check = False
    peak = torch.cuda.max_memory_allocated()
    ref = runs[0]
    log(f"[22] FGMRES iterations per step: "
        + " ".join(str(m.iterations) for m in ref["metrics"])
        + "; host reads per step captured "
        + " ".join(str(m.flag_reads) for m in ref["metrics"]) + ", eager "
        + " ".join(str(m.flag_reads) for m in runs[1]["metrics"]))
    for r in runs[1:]:
        same = (torch.equal(r["u"], ref["u"]) and torch.equal(r["p"], ref["p"])
                and all((a.cd, a.cl, a.iterations, a.residual)
                        == (b.cd, b.cl, b.iterations, b.residual)
                        for a, b in zip(r["metrics"], ref["metrics"])))
        check(same, f"[22] the {r['mode']} run equals the first captured "
              "run bit for bit (u, p, Cd, Cl, FGMRES counts)")
        check((r["launches"], r["givens"]) == (ref["launches"], ref["givens"]),
              f"[22] {r['mode']}: SELL and Givens launches per step "
              f"({r['launches']}, {r['givens']}) equal the captured run's "
              f"({ref['launches']}, {ref['givens']})")
    check(all(r["plain_cuda"] == 0 for r in runs),
          "[22] no plain-version calls on CUDA tensors")
    check(all(m.flag_reads < e.flag_reads for m, e in
              zip(ref["metrics"], runs[1]["metrics"])),
          "[22] the captured step reads the host less often")
    check(ref["givens"] * n == sum(m.iterations for m in ref["metrics"]),
          "[22] one Givens launch per FGMRES iteration")
    sps = {m: [r["steps_per_s"] for r in runs if r["mode"] == m]
           for m in ("captured", "eager")}
    cap = mono["capture"]
    log(f"[22] captured equals eager bit for bit in all four runs, with the "
        f"same launches per step (SELL {ref['launches']}, Givens "
        f"{ref['givens']:.2f}); capture {cap['capture_s']:.2f} s (phase 8), "
        f"{cap['nodes_per_block']} bodies per block; peak device memory "
        f"over the four runs {peak} bytes ({peak / 2**30:.2f} GiB); steps/s "
        f"captured {sps['captured']}, eager {sps['eager']} on {card}")
    nodes = phase_if_nodes()
    log(f"[22] phase {time.perf_counter() - t_phase:.1f} s")
    return dict(runs=[{k: r[k] for k in ("mode", "sync_check", "steps_per_s",
                                         "flag_reads", "masked", "launches",
                                         "givens", "set_condition")}
                      for r in runs],
                peak_bytes=peak, nodes=nodes)


def phase_if_nodes():
    """The conditional nodes (csrc/graph_cond.cu's set_condition and the
    if node it feeds) against their plain version, a host read of the
    flag deciding the body: NODE_CHECK nodes on seeded flags, each body
    adding one to its slot, the slots equal to the flags; then the device
    time per node skipped and run (a body of one add) from bursts of
    replays, and the host read's time."""
    from navierstokes_tpu_torch.kernels.conditional import IfNodes
    from navierstokes_tpu_torch.kernels.launches import record_launches
    gen = torch.Generator().manual_seed(22)
    want = torch.rand(NODE_CHECK, generator=gen) < 0.5
    flags = want.cuda()
    slots = torch.zeros(NODE_CHECK, dtype=torch.int32, device="cuda")
    ifs = IfNodes("cuda")
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with record_launches(), torch.cuda.graph(graph, stream=stream), \
            ifs.routed():
        for i in range(NODE_CHECK):
            ifs.body(flags[i], lambda i=i: slots[i].add_(1))
    graph.replay()
    got = slots.cpu()
    err = int((got - want.int()).abs().max())
    check(err == 0, "[22] set_condition and its if node against the host "
          "read of the flag")

    def per_node_ms(value):
        flags.fill_(value)
        times = []
        for _ in range(10):
            torch.cuda._sleep(2_000_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            graph.replay()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / NODE_CHECK)
        return statistics.median(times)

    skip_ms, run_ms = per_node_ms(False), per_node_ms(True)
    flag = flags[0]
    t0 = time.perf_counter()
    for _ in range(200):
        bool(flag)
    plain_ms = (time.perf_counter() - t0) / 200 * 1e3
    del graph
    ifs.close()
    log(f"[22] if nodes: {NODE_CHECK} nodes on seeded flags, bodies run "
        f"where the flag is up, max |error| {err}; per node {skip_ms:.5f} ms "
        f"skipped, {run_ms:.5f} ms with a body of one add (device time), "
        f"the plain version's host read {plain_ms:.5f} ms (host clock)")
    # set_condition reads one flag byte and sets the handle: a 1-byte
    # read and one operation
    bound = max(1 / HBM_BYTES_PER_S, 1 / FP32_OPS_PER_S) * 1e3
    return dict(max_abs_err=err, ms=skip_ms, run_ms=run_ms,
                plain_ms=plain_ms, bound_ms=bound)


def duct_model(device, tmp, dtype="float32", shard_devices=None,
               **overrides):
    """The 3D small fixture: the h=0.15 square-column duct (6,954 DoF),
    biparabolic inlet, Re=20, dt=0.01."""
    from navierstokes_tpu_torch.scenarios.registry import build_solver
    cfg = _config(tmp, dtype, ref_length=0.1, force_formula="st",
                  **overrides)
    return build_solver("3d-test1", h=0.15, config=cfg, device=device,
                        shard_devices=shard_devices, t_final=0.05,
                        output_step=5).setup()


def _config(tmp, dtype, **fields):
    from navierstokes_tpu_torch.config import SolverConfig
    return SolverConfig(dtype=dtype, output_dir=os.path.join(tmp, "out"),
                        cache_dir=os.path.join(tmp, "cache"),
                        csv_path=os.path.join(tmp, "forces.csv"), **fields)


# the 3D small-fixture configurations of phase 9 and the kernel
# instantiations (value dtype, D) each path must launch
SMALL_3D = (
    ("projection bj", dict(scheme="projection"), (torch.float32,)),
    ("projection jacobi", dict(scheme="projection", f_precond="jacobi"),
     (torch.float32,)),
    ("monolithic cc", dict(scheme="monolithic"), (torch.float32,)),
    ("cc+inner_bf16", dict(scheme="monolithic", inner_bf16=True),
     (torch.float32, torch.bfloat16)),
    # "blocked": the JAX model refines in 3D only with its blocked mass
    ("cc+refine=2", dict(scheme="monolithic", refine=2, refine_tol=1e-3,
                         mass_format="blocked"),
     (torch.float32, torch.float64)))


def _rel(a, b):
    a, b = a.cpu().double(), b.cpu().double()
    return float((a - b).abs().max() / b.abs().max())


def card_against_cpu(phase, tag, make, n_steps=5, gate=None):
    """CUDA against CPU in the models' dtype, ``n_steps`` steps, under
    phase 4's rule: 1e-4 of the force scale and of |u|, 1e-3 only where the
    gap is at most three times the gap between two CPU fp32 runs that
    differ only in their thread count; iteration totals within 1; no
    plain-version call on a CUDA tensor.  A fixed ``gate`` (the float64
    runs of phase 18) replaces the fp32 limits, and no noise run is made.
    ``make(device, name)`` builds a set-up model.  Returns the card run's
    launches by (value dtype, D) and its StepMetrics."""
    from navierstokes_tpu_torch.kernels.sell_spmv import COUNTS
    n_threads = torch.get_num_threads()
    alt_threads = 1 if n_threads > 1 else 4
    gpu, cpu = make("cuda", "gpu"), make("cpu", "cpu")
    alt = make("cpu", "alt") if gate is None else None
    worst = dict(cd=0.0, cl=0.0, u=0.0, its=0, noise=0.0)
    counts, card_steps = {}, []
    for k in range(n_steps):
        torch.cuda.synchronize()
        COUNTS.reset()
        mg = gpu.solve_time_step()
        torch.cuda.synchronize()
        card_steps.append(mg)
        check(COUNTS.plain_cuda_calls == 0,
              f"[{phase}] {tag}: no plain-version calls on CUDA tensors")
        for key, v in COUNTS.by_variant.items():
            counts[key] = counts.get(key, 0) + v
        mc = cpu.solve_time_step()
        check(mg.converged and mc.converged,
              f"[{phase}] {tag}: converged at step {k + 1}")
        scale = max(abs(mc.cd), abs(mc.cl), 1e-30)
        gap = dict(cd=abs(mg.cd - mc.cd) / scale,
                   cl=abs(mg.cl - mc.cl) / scale, u=_rel(gpu._u, cpu._u),
                   its=abs(mg.iterations - mc.iterations), noise=0.0)
        noise = ""
        if alt is not None:
            torch.set_num_threads(alt_threads)
            ma = alt.solve_time_step()
            torch.set_num_threads(n_threads)
            gap["noise"] = max(abs(ma.cd - mc.cd) / scale,
                               abs(ma.cl - mc.cl) / scale,
                               _rel(alt._u, cpu._u))
            noise = (f"; CPU {n_threads} vs {alt_threads} threads: "
                     f"{gap['noise']:.2e}")
        log(f"[{phase}] {tag} step {k + 1}: its cuda {mg.iterations} cpu "
            f"{mc.iterations}; Cd {mg.cd:.6f} vs {mc.cd:.6f} (diff / "
            f"max(|Cd|,|Cl|): Cd {gap['cd']:.2e}, Cl {gap['cl']:.2e}), "
            f"u rel {gap['u']:.2e}{noise}")
        for key, v in gap.items():
            worst[key] = max(worst[key], v)
    if gate is None:
        gate = 1e-4
        gap = max(worst["cd"], worst["cl"], worst["u"])
        if 1e-4 < gap <= 1e-3 and gap <= 3 * worst["noise"]:
            gate = 1e-3
    noise = "" if alt is None else f"; CPU-CPU noise {worst['noise']:.2e}"
    log(f"[{phase}] {tag} worst: Cd {worst['cd']:.2e}, Cl {worst['cl']:.2e}, "
        f"u {worst['u']:.2e} (gate {gate:g}{noise}), iteration diff "
        f"{worst['its']} (limit 1); launches over {n_steps} steps by (dtype, D): "
        + ", ".join(f"{str(dt).replace('torch.', '')} D={D}: {n}"
                    for (dt, D), n in sorted(counts.items(), key=str)))
    check(worst["cd"] <= gate and worst["cl"] <= gate,
          f"[{phase}] {tag} Cd/Cl")
    check(worst["u"] <= gate, f"[{phase}] {tag} u")
    check(worst["its"] <= 1, f"[{phase}] {tag} iteration counts")
    return counts, card_steps


def phase_small_3d():
    """CUDA fp32 against CPU fp32 on the 3D small fixture, 5 steps per
    configuration, under phase 4's rule (``card_against_cpu``).  Returns
    the launches by (value dtype, D) of each configuration's card run."""
    launches = {}
    for tag, kw, want in SMALL_3D:
        d = os.path.join(WORK, "duct_" + tag.replace(" ", "_")
                         .replace("+", "_").replace("=", ""))
        counts, _ = card_against_cpu(
            9, tag, lambda dev, name: duct_model(dev, f"{d}_{name}", **kw))
        for dt in want:
            check(counts.get((dt, 3), 0) > 0,
                  f"[9] {tag}: the D=3 {dt} kernel launched on its path")
        launches[tag] = counts
    return launches


def model_3d1():
    """3D-1Z at full width, as ``python -m
    navierstokes_tpu_torch.scenarios.validate 3d1 --projection --f-precond
    diag --h 0.023 --hnear 0.007`` builds it (biparabolic U_m=0.45,
    nu=1e-3, ref_length 0.1, the Schaefer-Turek force formula, BDF2
    projection, budgets 100 BiCGStab / 50 CG, dt=0.01, fp32), not set
    up."""
    from navierstokes_tpu_torch.scenarios.validate import build_case
    return build_case("3d1", device="cuda", h=0.023, h_near=0.007,
                      projection=True, f_precond="diag",
                      out=os.path.join(WORK, "st3d1"), setup=False)


def phase_3d1(card):
    """3 warm-up and 5 timed steps of 3D-1Z; every solve converged within
    its budget, finite values, the D=3 kernel launched.  Returns the model
    and the numbers of the run."""
    from navierstokes_tpu_torch.kernels.sell_spmv import COUNTS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ns = model_3d1().setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cfg = ns.config
    check(ns.space.n_dofs == EXPECTED_DOFS_3D1,
          f"[10] 3D-1Z DoF count {ns.space.n_dofs}")
    check(ns.nu == 1.0e-3, f"[10] 3D-1Z nu {ns.nu}")
    log(f"[10] 3D-1Z: {ns.space.n_dofs} DoF ({ns.mesh.n_cells} tets, "
        f"{ns.ell.f.nnz} F nonzeros), setup {setup_s:.1f} s")
    sg = ns.capture_graphs()
    log(f"[10] captured the projection step: {len(sg.graphs)} graphs in "
        f"{sg.capture_seconds:.2f} s")
    n_warm, n_meas = 3, 5
    COUNTS.reset()
    ms_all = [ns.solve_time_step() for _ in range(n_warm)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ms_all += [ns.solve_time_step() for _ in range(n_meas)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    d3 = COUNTS.by_variant.get((torch.float32, 3), 0)
    launches, plain_cuda = COUNTS.launches, COUNTS.plain_cuda_calls
    per_step = per_step_launches(n_warm + n_meas)
    peak = torch.cuda.max_memory_allocated()
    sps = n_meas / wall
    n = len(ms_all)
    log(f"[10] iterations BiCGStab+CG per step: "
        + " ".join(f"{m.f_iterations}+{m.p_iterations}" for m in ms_all))
    log(f"[10] totals per step: "
        + " ".join(str(m.iterations) for m in ms_all)
        + f" (TPU log: {' '.join(map(str, TPU_3D1_ITERATIONS[:n]))})")
    log(f"[10] Cd per step: " + " ".join(f"{m.cd:.5f}" for m in ms_all)
        + f" (TPU log: {' '.join(f'{c:.5f}' for c in TPU_3D1_CD[:n])})")
    log(f"[10] Cl {ms_all[-1].cl:.5f}, t {ms_all[-1].time:.4f}, measured "
        f"CFL {ns.measured_cfl():.3f}")
    log(f"[10] steps/s {sps:.4f} ({n_meas} steps in {wall:.3f} s), setup "
        f"{setup_s:.1f} s, on {card}")
    log(f"[10] peak device memory {peak} bytes ({peak / 2**30:.2f} GiB) on "
        f"{card}")
    log(f"[10] kernel launches over {n} steps: {launches} (D=3: {d3}); "
        f"plain-version CUDA calls {plain_cuda}; per step by operator "
        f"{per_step}")
    for m in ms_all:
        check(m.converged, f"[10] converged at t={m.time}")
        check(m.f_iterations < cfg.proj_f_maxiter
              and m.p_iterations < cfg.proj_p_maxiter,
              f"[10] iteration budget at t={m.time}")
        check(all(np.isfinite([m.cd, m.cl, m.residual])),
              f"[10] finite forces at t={m.time}")
    check(bool(torch.isfinite(ns._u).all() and torch.isfinite(ns._p).all()),
          "[10] finite u, p")
    check(d3 > 0, "[10] the D=3 kernel launched on the 3D-1Z path")
    check(plain_cuda == 0, "[10] no plain-version calls on CUDA tensors")
    log(f"[10] all {n} steps' solves converged within their budgets")
    return ns, dict(launches=d3, steps_per_s=sps, peak_bytes=peak,
                    setup_s=setup_s, per_step=per_step,
                    capture_s=sg.capture_seconds)


def spmv_uses_3d(ns, rng):
    """(use, pattern, fp32 values, fp32 x) of every SpMV use of the 3D
    projection step at the 3D-1Z shapes: F (A0 + convection at a
    numpy-seeded velocity) and the mass with D=3, the P1 Laplacian, G and
    B with D=1."""
    from navierstokes_tpu_torch.ops.bsr import convection_blk
    e, dev, sp = ns.ell, ns.device, ns.space
    x = lambda *shape: torch.as_tensor(rng.standard_normal(shape),
                                       dtype=torch.float32, device=dev)
    u = 0.2 * x(sp.n_p2, 3)
    lap = ns._ap_dir
    return [
        ("F (D=3)", e.f, ns.a0_cell + convection_blk(e, u), x(sp.n_p2, 3)),
        ("mass (D=3)", e.f, e.m_vals, x(sp.n_p2, 3)),
        ("P1 Laplacian", lap.mat, lap.vals, x(sp.n_p1)),
        ("G", e.g, e.g_vals, x(sp.n_p1)),
        ("B", e.b, e.b_vals, x(sp.n_p2 * 3)),
    ]


def phase_kernel_3d(ns):
    rng = np.random.default_rng(4321)
    uses = spmv_uses_3d(ns, rng)
    return {dt: [check_and_time(use, mat, vals.to(dt), x, "11")
                 for use, mat, vals, x in uses]
            for dt in (torch.float32, torch.bfloat16, torch.float64)}


def phase_cli():
    """``run 3d-test1`` through the CLI's main with the default device for
    two steps at the scenario's default h; the kernel must launch and the
    csv hold two finite rows."""
    from navierstokes_tpu_torch.kernels.sell_spmv import COUNTS
    from navierstokes_tpu_torch.scenarios.cli import main as cli_main
    d = os.path.join(WORK, "cli")
    csv = os.path.join(d, "forces.csv")
    torch.cuda.synchronize()
    COUNTS.reset()
    t0 = time.perf_counter()
    rc = cli_main(["run", "3d-test1", "--T", "0.02", "--output-dir",
                   os.path.join(d, "out"), "--cache-dir",
                   os.path.join(d, "cache"), "--csv", csv])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(rc == 0, "[12] CLI run exit code")
    rows = np.atleast_2d(np.genfromtxt(csv, delimiter=",", skip_header=1))
    log(f"[12] CLI run 3d-test1 (default device, h, scheme): {wall:.1f} s "
        f"with setup; csv rows {rows.shape[0]}, GMRES_iters "
        f"{rows[:, 2].tolist()}, Cd {rows[:, 7].tolist()}; kernel launches "
        f"{COUNTS.launches} (D=3: "
        f"{COUNTS.by_variant.get((torch.float32, 3), 0)}), plain-version "
        f"CUDA calls {COUNTS.plain_cuda_calls}")
    check(rows.shape == (2, 9) and np.isfinite(rows).all(), "[12] csv rows")
    check(COUNTS.by_variant.get((torch.float32, 3), 0) > 0,
          "[12] the D=3 kernel launched from the CLI")
    check(COUNTS.plain_cuda_calls == 0,
          "[12] no plain-version calls on CUDA tensors")


def naca_small(device, tmp, dtype="float32"):
    """The NACA small fixture: the 2d-naca scenario at h=0.1 and 8 degrees,
    monolithic ``cc`` (the scenario's defaults), fp32."""
    from navierstokes_tpu_torch.scenarios.registry import build_solver
    return build_solver("2d-naca", h=0.1, config=_config(tmp, dtype),
                        mesh_kwargs=dict(angle_deg=8.0), device=device,
                        t_final=0.05, output_step=5).setup()


def phase_naca_small():
    d = os.path.join(WORK, "naca_small")
    counts, _ = card_against_cpu(
        13, "2d-naca h=0.1 8 deg", lambda dev, name: naca_small(
            dev, f"{d}_{name}"))
    check(counts.get((torch.float32, 2), 0) > 0,
          "[13] the fp32 kernel launched on the NACA path")


def _csv_rows(path):
    rows = np.genfromtxt(path, delimiter=",", names=True)
    return np.atleast_1d(rows)


def thin_airfoil_fit(angles, cl):
    """tests/test_naca_values.py's criteria on final Cl per angle (degrees):
    (slope per degree, Cl at 0 degrees, R^2, whether all four hold)."""
    angles, cl = np.asarray(angles, float), np.asarray(cl, float)
    a = np.vstack([angles, np.ones_like(angles)]).T
    (slope, cl0), res, _, _ = np.linalg.lstsq(a, cl, rcond=None)
    r2 = 1.0 - float(res[0]) / float(((cl - cl.mean()) ** 2).sum())
    two_pi_per_deg = 2.0 * np.pi * np.pi / 180.0
    ok = (bool(np.all(np.diff(cl) > 0))
          and 0.55 * two_pi_per_deg < slope < two_pi_per_deg
          and r2 > 0.98 and 0.0 < cl0 < 2.0 * np.pi * np.radians(2.5))
    return float(slope), float(cl0), r2, ok


def _take_counts(into):
    """Add the launch counts by pattern and the plain-version CUDA calls
    to the Counter ``into`` and set the counts to 0."""
    from navierstokes_tpu_torch.kernels.sell_spmv import COUNTS
    into.update(COUNTS.by_pattern)
    into["plain"] += COUNTS.plain_cuda_calls
    COUNTS.reset()


def phase_naca_sweep(card):
    """``sweep-naca --angles 0 2 4 8`` through the CLI's main on the default
    device at the scenario's h, inside build/chip_smoke/naca (the sweep
    writes output_<angle>.csv into the working directory).  The CLI's
    build_solver is wrapped for the run only, to time each angle's mesh
    and setup and to count the setup's launches apart from the steps'."""
    from navierstokes_tpu_torch.config import SolverConfig
    from navierstokes_tpu_torch.kernels.sell_spmv import COUNTS
    from navierstokes_tpu_torch.scenarios import cli
    d = os.path.join(WORK, "naca")
    os.makedirs(d, exist_ok=True)
    setups = []
    steps_c, setup_c = collections.Counter(), collections.Counter()
    build = cli.build_solver

    def timed_build(*args, **kwargs):
        t0 = time.perf_counter()
        ns = build(*args, **kwargs)
        setup = ns.setup

        def timed_setup():
            _take_counts(steps_c)        # the previous angle's steps
            out = setup()
            torch.cuda.synchronize()
            setups.append((ns.space.n_dofs, time.perf_counter() - t0))
            _take_counts(setup_c)
            return out
        ns.setup = timed_setup
        return ns

    argv = (["sweep-naca", "--angles"] + [str(a) for a in NACA_DOFS]
            + list(NACA_SWEEP_ARGS))
    cwd = os.getcwd()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    COUNTS.reset()
    t0 = time.perf_counter()
    cli.build_solver = timed_build
    os.chdir(d)
    try:
        rc = cli.main(argv)
    finally:
        os.chdir(cwd)
        cli.build_solver = build
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    _take_counts(steps_c)
    plain_cuda = steps_c.pop("plain") + setup_c.pop("plain")
    launches = sum(v for (_, dt), v in steps_c.items()
                   if dt == torch.float32)
    setup_launches = sum(v for (_, dt), v in setup_c.items()
                         if dt == torch.float32)
    f_launches = steps_c.get(("F", torch.float32), 0)
    check(rc == 0, "[14] sweep-naca exit code")
    check(len(setups) == len(NACA_DOFS), "[14] one model per angle")
    budget = SolverConfig().outer_maxiter
    final, n_steps, runs = {}, 0, []
    for (angle, dofs), (n_dofs, setup_s) in zip(NACA_DOFS.items(), setups):
        rows = _csv_rows(os.path.join(d, f"output_{angle:g}.csv"))
        n_steps += len(rows)
        step_s = rows["time_prec_init"] + rows["time_sol"]
        its = rows["GMRES_iters"].astype(int)
        tpu = _csv_rows(NACA_TPU_CSV.format(angle))[-1]
        final[angle] = (float(rows["Cd"][-1]), float(rows["Cl"][-1]))
        sps = len(rows) / float(step_s.sum())
        late = (len(rows) - 10) / float(step_s[10:].sum() or np.nan)
        runs.append(dict(angle=angle, dofs=n_dofs, setup_s=setup_s,
                         steps_per_s=sps, steps_per_s_after_10=late,
                         steps=len(rows)))
        log(f"[14] {angle:g} deg: {n_dofs} DoF (TPU log {dofs}), setup "
            f"{setup_s:.2f} s, {len(rows)} steps at {sps:.4f} steps/s "
            f"(steps 11-{len(rows)}: {late:.4f}); FGMRES "
            f"its per step {' '.join(map(str, its))}; final Cd "
            f"{final[angle][0]:.5f}, Cl {final[angle][1]:.5f} (TPU csv "
            f"{tpu['Cd']:.5f}, {tpu['Cl']:.5f}, for information)")
        check(n_dofs == dofs, f"[14] {angle:g} deg DoF count {n_dofs}")
        check(len(rows) == 100, f"[14] {angle:g} deg: 100 csv rows")
        check(bool(np.all(its < budget)),
              f"[14] {angle:g} deg: every FGMRES count under {budget}")
        check(all(np.isfinite(rows[c]).all() for c in rows.dtype.names),
              f"[14] {angle:g} deg: finite csv rows")
    slope, cl0, r2, ok = thin_airfoil_fit(
        list(final), [cl for _, cl in final.values()])
    per_step = per_step_launches(n_steps, steps_c)
    log(f"[14] thin-airfoil fit of the final Cl: slope "
        f"{slope / (2 * np.pi * np.pi / 180):.4f} x 2 pi per radian, Cl(0) "
        f"{cl0:.5f}, R^2 {r2:.5f}")
    log(f"[14] sweep {wall:.1f} s with setup on {card}; peak device memory "
        f"{peak} bytes ({peak / 2**30:.2f} GiB); fp32 kernel launches "
        f"{launches} (F {f_launches}) over {n_steps} steps, and "
        f"{setup_launches} in the four setups; plain-version CUDA calls "
        f"{plain_cuda}; per step by operator {per_step}")
    check(ok, "[14] thin-airfoil criteria (monotone, slope 0.55-1.0 x "
          "2 pi, R^2 > 0.98, 0 < Cl(0) < 2 pi 2.5 deg)")
    check(f_launches >= n_steps, "[14] the F product launched every step")
    check(plain_cuda == 0, "[14] no plain-version calls on CUDA tensors")
    eager = naca_eager_angle(build, d)
    return dict(launches=launches, setup_launches=setup_launches,
                per_step=per_step, peak_bytes=peak, runs=runs, final=final,
                eager=eager)


# the sweep's angle run again with the plain step (phase 14)
NACA_EAGER_ANGLE = 8


def naca_eager_angle(build, sweep_dir):
    """The sweep's NACA_EAGER_ANGLE run again through the CLI with the
    plain (eager) step: its csv's FGMRES counts, Cd and Cl equal the
    captured sweep's at every step."""
    from navierstokes_tpu_torch.scenarios import cli
    d = os.path.join(WORK, "naca_eager")
    os.makedirs(d, exist_ok=True)

    def eager_build(*args, **kwargs):
        ns = build(*args, **kwargs)
        solve = ns.solve
        ns.solve = lambda *a, **k: solve(*a, _eager=True, **k)
        return ns

    cwd = os.getcwd()
    t0 = time.perf_counter()
    cli.build_solver = eager_build
    os.chdir(d)
    try:
        rc = cli.main(["sweep-naca", "--angles", str(NACA_EAGER_ANGLE),
                       *NACA_SWEEP_ARGS])
    finally:
        os.chdir(cwd)
        cli.build_solver = build
    wall = time.perf_counter() - t0
    name = f"output_{NACA_EAGER_ANGLE:g}.csv"
    a = _csv_rows(os.path.join(sweep_dir, name))
    b = _csv_rows(os.path.join(d, name))
    same = len(a) == len(b) and all(
        np.array_equal(a[c], b[c]) for c in ("GMRES_iters", "Cd", "Cl"))
    sps = len(b) / float((b["time_prec_init"] + b["time_sol"]).sum())
    log(f"[14] {NACA_EAGER_ANGLE} deg again with the plain step: FGMRES "
        f"total {int(b['GMRES_iters'].sum())} (captured "
        f"{int(a['GMRES_iters'].sum())}), final Cl {b['Cl'][-1]!r} "
        f"(captured {a['Cl'][-1]!r}), csv equal {same}; {sps:.4f} steps/s "
        f"eager, run {wall:.1f} s with setup")
    check(rc == 0 and same, "[14] the captured sweep's angle equals the "
          "eager run (FGMRES counts, Cd, Cl at every step)")
    return dict(angle=NACA_EAGER_ANGLE, steps_per_s=sps,
                fgmres_total=int(b["GMRES_iters"].sum()))


# the SpMV uses of the monolithic cc step (no PCD convection)
NACA_USES = ("F", "mass", "P1 Laplacian", "Ap", "G", "B")


def phase_kernel_naca():
    """The fp32 kernel against its plain version in every use of the NACA
    step, on the 2d-naca operators at the scenario's h (0 degrees), timed
    as in phase 3."""
    from navierstokes_tpu_torch.scenarios.registry import build_solver
    ns = build_solver("2d-naca", config=_config(os.path.join(
        WORK, "naca_kernel"), "float32"), device="cuda").setup()
    check(ns.space.n_dofs == NACA_DOFS[0],
          f"[14] 2d-naca model DoF count {ns.space.n_dofs}")
    uses = spmv_uses(ns, np.random.default_rng(5678))
    return [check_and_time(use, mat, vals, x, "14")
            for use, mat, vals, x in uses if use in NACA_USES]


def phase_postprocess():
    """``run 2d-test1`` for 4 steps with output every 2, then the CLI's
    ``postprocess`` (VTUs) and ``NavierStokes.post_process`` on the same
    checkpoints, whose Cd/Cl must equal the live csv rows."""
    from navierstokes_tpu_torch.scenarios.cli import main as cli_main
    from navierstokes_tpu_torch.scenarios.registry import build_solver
    d = os.path.join(WORK, "post")
    out, csv = os.path.join(d, "out"), os.path.join(d, "forces.csv")
    common = ["--output-step", "2", "--output-dir", out, "--cache-dir",
              os.path.join(d, "cache"), "--csv", csv]
    check(cli_main(["run", "2d-test1", "--T", "0.04"] + common) == 0,
          "[15] CLI run exit code")
    live = _csv_rows(csv)
    for f in os.listdir(out):
        os.remove(os.path.join(out, f))
    check(cli_main(["postprocess", "2d-test1", "--t0", "0", "--t1", "4",
                    "--step", "2"] + common) == 0,
          "[15] CLI postprocess exit code")
    for ts in (0, 2, 4):
        for ext in ("vtu", "pvtu"):
            check(os.path.exists(os.path.join(
                out, f"output-stokes_{ts:06d}.{ext}")),
                f"[15] the replay wrote output-stokes_{ts:06d}.{ext}")
    ns = build_solver("2d-test1", config=_config(d, "float32"), t_final=0.04,
                      output_step=2).setup()
    replay = ns.post_process(2, 4, 2)
    worst = 0.0
    for ts, t, cd, cl in replay:
        row = live[ts - 1]
        check(abs(t - row["time"]) <= 1e-6, f"[15] replay time at {ts}")
        for a, b in ((cd, row["Cd"]), (cl, row["Cl"])):
            worst = max(worst, abs(a - b) / max(abs(b), 1e-30))
        log(f"[15] ts {ts}: replayed Cd {cd!r}, Cl {cl!r}; live {row['Cd']!r},"
            f" {row['Cl']!r}")
    log(f"[15] replay against the live csv: worst relative gap {worst:.3e} "
        "(limit 1e-6)")
    check(worst <= 1e-6, "[15] replayed Cd/Cl equal the live run's")


def _forcing(x, t):
    """f(x, t) = (1, 0.5 x_0): the forcing of tests/test_torch_rhs.py."""
    return torch.stack([torch.ones_like(x[:, 0]), 0.5 * x[:, 0]], dim=1)


RHS_SMALL = (("projection p_out", dict(scheme="projection", p_out=0.7)),
             ("monolithic p_out", dict(scheme="monolithic", p_out=0.7)),
             ("projection forcing", dict(scheme="projection",
                                         forcing=_forcing)),
             ("monolithic forcing", dict(scheme="monolithic",
                                         forcing=_forcing)))


def phase_rhs_terms():
    for tag, kw in RHS_SMALL:
        d = os.path.join(WORK, "rhs_" + tag.replace(" ", "_"))
        counts, _ = card_against_cpu(
            16, tag, lambda dev, name: small_model(dev, f"{d}_{name}", **kw))
        check(counts.get((torch.float32, 2), 0) > 0,
              f"[16] {tag}: the fp32 kernel launched")


STOKES_NU = 1.0
# (degree_velocity, degree_pressure, meshes n x n, least rates of u, p)
STOKES_CASES = ((2, 1, (4, 8, 16), 2.5, 1.5), (3, 2, (4, 8), 3.5, 2.5))


def _stokes_u(x):
    u = np.empty_like(x)
    u[:, 0] = np.sin(np.pi * x[:, 0]) * np.cos(np.pi * x[:, 1])
    u[:, 1] = -np.cos(np.pi * x[:, 0]) * np.sin(np.pi * x[:, 1])
    return u


def _stokes_p(x):
    return np.cos(np.pi * x[:, 0]) * np.cos(np.pi * x[:, 1])


def _stokes_f(x, t=0.0):
    """-nu lap(u) + grad(p) of the manufactured solution."""
    f = 2.0 * STOKES_NU * np.pi ** 2 * _stokes_u(x)
    f[:, 0] -= np.pi * np.sin(np.pi * x[:, 0]) * np.cos(np.pi * x[:, 1])
    f[:, 1] -= np.pi * np.cos(np.pi * x[:, 0]) * np.sin(np.pi * x[:, 1])
    return f


def stokes_errors(device, n, kv, kp):
    """(L2 error of u, of p, FGMRES iterations, seconds) of the
    manufactured Stokes problem on the n x n unit square."""
    from navierstokes_tpu_torch.config import SolverConfig
    from navierstokes_tpu_torch.fem.interpolation import (l2_error_pressure,
                                                          l2_error_velocity)
    from navierstokes_tpu_torch.mesh import rectangle_2d
    from navierstokes_tpu_torch.models.stokes import StokesSolver
    from navierstokes_tpu_torch.ops.assembly import forcing_rhs
    t0 = time.perf_counter()
    solver = StokesSolver(rectangle_2d(1.0, 1.0, n, n), nu=STOKES_NU,
                          config=SolverConfig(dtype="float64"),
                          degree_velocity=kv, degree_pressure=kp,
                          device=device)
    sp = solver.space
    nodes = np.unique(np.concatenate([sp.p2_nodes_on_tag(t)
                                      for t in (0, 1, 2, 3)]))
    u, p, res = solver.solve(nodes, _stokes_u(sp.p2_coords[nodes]),
                             rhs_u=forcing_rhs(sp, _stokes_f), tol=1e-12,
                             maxiter=800)
    check(bool(res.converged), f"[17] P{kv}/P{kp} n={n} on {device}: "
          "FGMRES converged")
    return (l2_error_velocity(sp, u, _stokes_u),
            l2_error_pressure(sp, p, _stokes_p), int(res.iterations),
            time.perf_counter() - t0)


def phase_stokes():
    out = []
    for kv, kp, ns, rate_u, rate_p in STOKES_CASES:
        errs = []
        for n in ns:
            eu, ep, its, sec = stokes_errors("cuda", n, kv, kp)
            cu, cp, cits, _ = stokes_errors("cpu", n, kv, kp)
            gap = max(abs(eu - cu) / cu, abs(ep - cp) / cp)
            log(f"[17] P{kv}/P{kp} n={n}: L2 error u {eu:.6e}, p {ep:.6e} "
                f"({its} FGMRES its, {sec:.2f} s with setup); CPU {cu:.6e}, "
                f"{cp:.6e} ({cits} its); relative gap {gap:.2e} (limit 1e-9)")
            check(gap <= 1e-9, f"[17] P{kv}/P{kp} n={n}: errors equal the "
                  "CPU's")
            errs.append((eu, ep))
            out.append(dict(kv=kv, kp=kp, n=n, err_u=eu, err_p=ep,
                            iterations=its, seconds=sec))
        for (n0, (u0, p0)), (n1, (u1, p1)) in zip(zip(ns, errs),
                                                  zip(ns[1:], errs[1:])):
            ru, rp = np.log2(u0 / u1), np.log2(p0 / p1)
            log(f"[17] P{kv}/P{kp} rates n={n0}->{n1}: u {ru:.3f} (> "
                f"{rate_u}), p {rp:.3f} (> {rate_p})")
            check(ru > rate_u and rp > rate_p,
                  f"[17] P{kv}/P{kp} rates n={n0}->{n1}")
    return out


EXPECTED_DOFS_2D1_P3 = 654_022
# Cd of the 2D-1 P3/P2 window's steps 1-4 in float64 (``validate 2d1
# --degree 3 --dtype float64`` on an H100); the fp32 window was within
# 1.7e-3 of them, relative
CD_2D1_P3_FLOAT64 = (196.47550, 14.02107, 10.87792, 9.33736)
CD_2D1_P3_GATE = 5e-3
# Inner solves of the cells card-against-CPU runs (tests/test_torch_cells.py
# measures why): at the default 1e-2 the cells step's Jacobi-BiCGStab Schur
# solves make it sensitive to round-off (a 1e-15 change of A0 moves u by
# 2e-6 and the FGMRES counts by several), at 1e-10 it is not (6e-12).
CELLS_TIGHT = dict(inner_tol=1e-10, inner_maxiter_f=1000,
                   inner_maxiter_s=1000)


def cells_small(device, tmp, kv, kp, dtype="float64", shard_devices=None,
                **overrides):
    """The cells small fixture: the cylinder channel at h=0.15,
    h_near=0.06 (P3/P2 4,916 DoF; P2/P1 with the cylinder snapped),
    parabolic U_m=0.3, Re=20, dt=0.01, monolithic."""
    from navierstokes_tpu_torch.config import InletConfig
    from navierstokes_tpu_torch.mesh.generators import (
        channel_with_cylinder_2d)
    from navierstokes_tpu_torch.models.navier_stokes import NavierStokes
    ns = NavierStokes(channel_with_cylinder_2d(h=0.15, h_near=0.06), kv, kp,
                      deltat=0.01, T=0.05, step=5,
                      inlet=InletConfig(kind="parabolic", u_m=0.3,
                                        height=0.41),
                      config=_config(tmp, dtype, scheme="monolithic",
                                     **overrides), device=device,
                      shard_devices=shard_devices)
    ns.set_re_number(20)
    return ns.setup()


# the cells configurations held card against CPU in float64 (phase 18) and
# on cell shards against one card (phase 23, ``kw`` the shards)
CELLS_SMALL = (
    ("P2/P1 cells asimple", lambda dev, d, **kw: cells_small(
        dev, d, 2, 1, operator="cells", preconditioner="asimple",
        **CELLS_TIGHT, **kw)),
    ("P3/P2 cc", lambda dev, d, **kw: cells_small(dev, d, 3, 2,
                                                  **CELLS_TIGHT, **kw)),
    ("P3/P2 ayosida", lambda dev, d, **kw: cells_small(
        dev, d, 3, 2, preconditioner="ayosida", **CELLS_TIGHT, **kw)),
    ("3D P2/P1 cells", lambda dev, d, **kw: duct_model(
        dev, d, "float64", operator="cells", preconditioner="asimple",
        **CELLS_TIGHT, **kw)))


# phase 18's runs that phase 23 reuses: per CELLS_SMALL configuration the
# card model after its step and the step's metrics, and the CPU float64
# P3/P2 ``cc`` run's (metrics, u) of steps 1-2
CellsRuns = collections.namedtuple("CellsRuns", "one_card f64_ref")


def phase_cells_small():
    """Card against CPU on the cells operator.  The four configurations
    of CELLS_SMALL in float64, 1 step, within 1e-9 (the CPU parity
    tests' limit; ``card_against_cpu``); in fp32 phase 4's rule cannot
    hold between any two runs of the cells step, two CPU runs included
    (their FGMRES counts differ by up to 5 and Cd by up to 1.5e-3 of the
    force scale, the error of its fp32 solve).  The fp32 step (P3/P2
    ``cc``), plain and with ``inner_bf16``, is held, card and CPU alike,
    to the CPU float64 run within 1e-3 of |u| over 2 steps, every solve
    converged.  No SELL kernel launches on the cells path.  Returns the
    runs phase 23 holds the cell shards to (``CellsRuns``)."""
    from navierstokes_tpu_torch.kernels.sell_spmv import COUNTS
    t0 = time.perf_counter()
    one_card = {}
    for tag, fn in CELLS_SMALL:
        d = os.path.join(WORK, "cells_" + tag.replace(" ", "_")
                         .replace("/", ""))
        built = []

        def make(dev, name, fn=fn, d=d, built=built):
            built.append(fn(dev, f"{d}_{name}"))
            return built[-1]

        counts, steps = card_against_cpu(18, tag, make, n_steps=1,
                                         gate=1e-9)
        check(all(ns._operator == "cells" for ns in built),
              f"[18] {tag}: the cells operator")
        one_card[tag] = (built[0], steps[0])
        check(sum(counts.values()) == 0, f"[18] {tag}: no SELL launch")
    d = os.path.join(WORK, "cells_fp32")
    ref = cells_small("cpu", d + "_f64", 3, 2, "float64")
    ref_steps = [(ref.solve_time_step(), ref._u.clone()) for _ in range(2)]
    for tag, kw in (("cc", {}), ("cc+inner_bf16", dict(inner_bf16=True))):
        gpu = cells_small("cuda", f"{d}_{tag}_gpu", 3, 2, "float32", **kw)
        cpu = cells_small("cpu", f"{d}_{tag}_cpu", 3, 2, "float32", **kw)
        torch.cuda.synchronize()
        COUNTS.reset()
        worst = 0.0
        for k, (mr, u_ref) in enumerate(ref_steps):
            mg, mc = gpu.solve_time_step(), cpu.solve_time_step()
            gaps = (_rel(gpu._u, u_ref), _rel(cpu._u, u_ref),
                    _rel(gpu._u, cpu._u))
            worst = max(worst, *gaps)
            log(f"[18] P3/P2 {tag} fp32 step {k + 1}: FGMRES its cuda "
                f"{mg.iterations} cpu {mc.iterations} (float64 "
                f"{mr.iterations}); u rel to float64: cuda {gaps[0]:.2e}, "
                f"cpu {gaps[1]:.2e}; cuda to cpu {gaps[2]:.2e}")
            check(mg.converged and mc.converged,
                  f"[18] {tag} fp32: converged at step {k + 1}")
        torch.cuda.synchronize()
        check(COUNTS.launches == 0 and COUNTS.plain_cuda_calls == 0,
              f"[18] {tag} fp32: no SELL launch, no plain-version CUDA call")
        log(f"[18] P3/P2 {tag} fp32 worst u gap {worst:.2e} (limit 1e-3)")
        check(worst <= 1e-3, f"[18] {tag} fp32 within 1e-3 of float64")
    log(f"[18] small cells cases in {time.perf_counter() - t0:.1f} s")
    return CellsRuns(one_card, ref_steps)


def phase_2d1_p3(card):
    """The 2D-1 P3/P2 window (``validate.build_case("2d1", degree=3)``
    at h=0.010, h_near=0.0033): 1 warm-up and 2 timed steps (a start-up
    step takes 15-30 s on an H100); every step converged, finite Cd and
    Cl, the Cd of steps 1-3 within CD_2D1_P3_GATE of the float64 run's,
    no SELL launch."""
    from navierstokes_tpu_torch.kernels.sell_spmv import COUNTS
    from navierstokes_tpu_torch.scenarios.validate import build_case
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ns = build_case("2d1", device="cuda", h=0.010, h_near=0.0033, degree=3,
                    out=os.path.join(WORK, "st2d1_p3"))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_dofs = ns.space.n_dofs
    check(n_dofs == EXPECTED_DOFS_2D1_P3, f"[18] 2D-1 P3/P2 DoF {n_dofs}")
    check(ns._operator == "cells", "[18] 2D-1 P3/P2 on the cells operator")
    log(f"[18] 2D-1 P3/P2: {n_dofs} DoF ({ns.mesh.n_cells} cells), setup "
        f"{setup_s:.1f} s with the mesh")
    n_warm, n_meas = 1, 2
    COUNTS.reset()
    t0 = time.perf_counter()
    ms = [ns.solve_time_step() for _ in range(n_warm)]
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ms += [ns.solve_time_step() for _ in range(n_meas)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain_cuda = COUNTS.launches, COUNTS.plain_cuda_calls
    peak = torch.cuda.max_memory_allocated()
    sps = n_meas / wall
    its = [m.iterations for m in ms]
    cd_gaps = [abs(m.cd - ref) / abs(ref)
               for m, ref in zip(ms, CD_2D1_P3_FLOAT64)]
    log(f"[18] FGMRES iterations per step: {' '.join(map(str, its))} (budget "
        f"{ns.config.outer_maxiter})")
    log(f"[18] Cd per step: " + " ".join(f"{m.cd:.5f}" for m in ms)
        + f"; Cl {ms[-1].cl:.5f}, t {ms[-1].time:.4f}; relative to float64: "
        + " ".join(f"{g:.2e}" for g in cd_gaps)
        + f" (limit {CD_2D1_P3_GATE:g})")
    for m in ms:
        check(m.converged, f"[18] 2D-1 P3/P2 converged at t={m.time}")
        check(all(np.isfinite([m.cd, m.cl, m.residual])),
              f"[18] 2D-1 P3/P2 finite forces at t={m.time}")
    check(max(cd_gaps) <= CD_2D1_P3_GATE,
          "[18] 2D-1 P3/P2 Cd against the float64 run")
    check(bool(torch.isfinite(ns._u).all() and torch.isfinite(ns._p).all()),
          "[18] 2D-1 P3/P2 finite u, p")
    check(launches == 0 and plain_cuda == 0,
          f"[18] 2D-1 P3/P2: SELL launches {launches}, plain-version CUDA "
          f"calls {plain_cuda} (0 each)")
    out = dict(n_dofs=n_dofs, steps_per_s=sps, setup_s=setup_s,
               step1_s=warm_s, peak_bytes=peak, iterations=its,
               iterations_timed=sum(its[n_warm:]) / n_meas,
               cd_gap_float64=max(cd_gaps), sell_launches=launches)
    log(f"[18] 2D-1 P3/P2 window: {json.dumps(out)} on {card}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return out


# The validation driver's phase: 2D-2 projection on the h=0.05 channel
# (13,518 DoF), 20 steps of dt=0.0025, enough for the Strouhal FFT (it
# needs 8 rows in the trace's second half).
VALIDATE_ARGS = ("2d2", "--projection", "--h", "0.05", "--T", "0.05")


def phase_validate(card):
    """``python -m navierstokes_tpu_torch.scenarios.validate`` as a user
    runs it, in a process of its own on the card: exit code 0, a last line
    of JSON with finite statistics and the fp32 SELL kernel launched."""
    t0 = time.perf_counter()
    out = os.path.join(WORK, "validate")
    r = subprocess.run(
        [sys.executable, "-m", "navierstokes_tpu_torch.scenarios.validate",
         *VALIDATE_ARGS, "--out", out], cwd=HERE, capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": os.pathsep.join(
            [HERE] + [p for p in os.environ.get("PYTHONPATH", "").split(
                os.pathsep) if p])})
    wall = time.perf_counter() - t0
    lines = r.stdout.strip().splitlines()
    check(r.returncode == 0, f"[19] validate exit code {r.returncode}: "
          f"{r.stderr.strip()[-2000:]}")
    res = json.loads(lines[-1])
    stats = res["stats"] or {}
    launches = res["sell_launches_per_step"]
    log(f"[19] validate {' '.join(VALIDATE_ARGS)}: {res['n_dofs']} DoF, "
        f"{res['steps']} steps, {res['steps_per_s']:.2f} steps/s, setup "
        f"{res['setup_s']:.1f} s, peak {res['peak_bytes']} bytes, stats "
        f"{stats}, SELL launches per step {launches}, on {res['card']}; "
        f"phase {wall:.1f} s")
    check(sorted(stats) == ["cd_max", "cl_max", "st"] and all(
        v is not None and np.isfinite(v) for v in stats.values()),
        "[19] finite statistics")
    check(res["unconverged_steps"] == 0, "[19] every step converged")
    check(launches.get("float32 D=1", 0) > 0
          and launches.get("float32 D=2", 0) > 0,
          "[19] the fp32 SELL kernel launched (D=1 and D=2)")
    check(res["card"] == card, "[19] the card's line in the record")
    return res


# phase 23: the cells operator on two cell shards of one card
CELL_SHARDS = ("cuda:0", "cuda:0")
CELL_SHARD_STEPS = 1


def cell_products_on_card(ns):
    """Every cells product on seeded float64 inputs: ``CellOps`` of the
    one-device model ``ns`` (float64, on the card) against one shard (bit
    for bit) and two shards of cuda:0 (within 1e-12 of max|y|).  Returns
    the worst gap of two shards.  tests/test_torch_cuda.py runs it too."""
    from navierstokes_tpu_torch.parallel.sharded_bsr import ShardVals
    from navierstokes_tpu_torch.parallel.sharded_cells import (
        ShardedCellOps, ShardedCells)
    rng = np.random.default_rng(23)
    sp = ns.space
    nc, nv = np.asarray(sp.cell_p2).shape
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device="cuda")
    u, xp = t(rng.standard_normal((sp.n_p2, sp.dim))), t(
        rng.standard_normal(sp.n_p1))
    w, f = t(rng.random(sp.n_p2)), rng.standard_normal((nc, nv, nv))

    def products(ops, op, fv):
        out = [ops.f_diag(op, fv), ops.mass_apply(op, u),
               ops.schur_diag(op, w)]
        for c in ((True, True, True), (True, False, False),
                  (False, True, False), (False, False, True)):
            out += list(ops.apply_blocks(op, fv, u, xp, *c))
        return out

    ref = products(ns._ops, ns.cells, t(f))
    ref_c = ns._ops.convection(ns.cells, u)
    worst = 0.0
    for devs in (CELL_SHARDS[:1], CELL_SHARDS):
        sc = ShardedCells(sp, ns._cells_host, sp.rs.T_hat, torch.float64,
                          "cuda", list(devs))
        fv = ShardVals(t(f[s.cells[0]:s.cells[1]]) for s in sc.shards)
        got = products(ShardedCellOps(), sc, fv)
        got_c = sc.unshard(ShardedCellOps().convection(sc, u))
        if len(devs) == 1:
            check(all(torch.equal(a, b) for a, b in zip(got, ref))
                  and torch.equal(got_c, ref_c),
                  "[23] one cell shard equals CellOps bit for bit")
        else:
            worst = max(_rel(a, b) for a, b in zip(got + [got_c],
                                                   ref + [ref_c]))
            check(worst <= 1e-12, f"[23] two cell shards' products within "
                  f"1e-12 ({worst:.2e})")
    return worst


def phase_cell_shards_small(runs):
    """The four CELLS_SMALL configurations in float64 on two cell shards
    of cuda:0 against phase 18's one-card run (``runs``, a CellsRuns),
    1 step: equal FGMRES counts,
    u, p, Cd and Cl within 1e-9 (the CPU parity tests' limit);
    the products per operator (``cell_products_on_card``); P3/P2 ``cc`` +
    ``inner_bf16`` in fp32 on two shards within 1e-3 of u of phase 18's
    CPU float64 run over 2 steps; no SELL launch."""
    from navierstokes_tpu_torch.kernels.sell_spmv import COUNTS
    t0 = time.perf_counter()
    shards = dict(n_devices=len(CELL_SHARDS), shard_devices=CELL_SHARDS)
    out = {}
    for tag, fn in CELLS_SMALL:
        d = os.path.join(WORK, "cell_shards_" + tag.replace(" ", "_")
                         .replace("/", ""))
        one, m1 = runs.one_card[tag]
        sh = fn("cuda", d + "_sh", **shards)
        check(sh._cell_sharded and len(sh.cells.shards) == 2,
              f"[23] {tag}: two cell shards")
        torch.cuda.synchronize()
        COUNTS.reset()
        m2 = sh.solve_time_step()
        torch.cuda.synchronize()
        check(COUNTS.launches == 0 and COUNTS.plain_cuda_calls == 0,
              f"[23] {tag}: no SELL launch")
        scale = max(abs(m1.cd), abs(m1.cl), 1e-30)
        gap = max(_rel(sh._u, one._u), _rel(sh._p, one._p),
                  abs(m2.cd - m1.cd) / scale, abs(m2.cl - m1.cl) / scale)
        log(f"[23] {tag} on two cell shards of cuda:0 against one card: "
            f"FGMRES {m2.iterations} ({m1.iterations}); worst of u, p, Cd, "
            f"Cl {gap:.2e} (limit 1e-9); bytes per shard "
            f"{sh.cells.shard_bytes()}")
        check(m1.converged and m2.converged, f"[23] {tag}: converged")
        check(m2.iterations == m1.iterations, f"[23] {tag}: FGMRES counts")
        check(gap <= 1e-9, f"[23] {tag}: within 1e-9 of one card")
        out[tag] = gap
        if tag == "P3/P2 cc":
            out["ops"] = cell_products_on_card(one)
            log(f"[23] P3/P2 products: one shard bit for bit, two shards "
                f"within {out['ops']:.2e} of CellOps")
    bf = cells_small("cuda", os.path.join(WORK, "cell_shards_bf16"), 3, 2,
                     "float32", inner_bf16=True, **shards)
    worst = 0.0
    for k, (mr, u_ref) in enumerate(runs.f64_ref):
        mb = bf.solve_time_step()
        check(mr.converged and mb.converged,
              f"[23] P3/P2 cc+inner_bf16 fp32 shards converged, step {k + 1}")
        worst = max(worst, _rel(bf._u, u_ref))
    log(f"[23] P3/P2 cc+inner_bf16 fp32 on two cell shards: u within "
        f"{worst:.2e} of the float64 run (limit 1e-3)")
    check(worst <= 1e-3, "[23] inner_bf16 on cell shards")
    log(f"[23] small cell-shard cases in {time.perf_counter() - t0:.1f} s")
    return out


def phase_2d1_p3_shards(card, p18):
    """The 2D-1 P3/P2 window of phase 18 on two cell shards of cuda:0,
    CELL_SHARD_STEPS steps: every step converged, the Cd of each within
    CD_2D1_P3_GATE of the float64 run's, no SELL launch; the bytes each
    shard holds against the one-device cell arrays, and the seconds of
    step 1 beside phase 18's step 1."""
    from navierstokes_tpu_torch.kernels.sell_spmv import COUNTS
    from navierstokes_tpu_torch.parallel.sharded_bsr import operator_bytes
    from navierstokes_tpu_torch.scenarios.validate import build_case
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ns = build_case("2d1", device="cuda", h=0.010, h_near=0.0033, degree=3,
                    n_devices=len(CELL_SHARDS), shard_devices=CELL_SHARDS,
                    out=os.path.join(WORK, "st2d1_p3_shards"))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    check(ns.space.n_dofs == EXPECTED_DOFS_2D1_P3,
          f"[23] 2D-1 P3/P2 DoF {ns.space.n_dofs}")
    check(ns._cell_sharded and len(ns.cells.shards) == 2,
          "[23] 2D-1 P3/P2 on two cell shards")
    per_shard = ns.cells.shard_bytes()
    whole = sum(operator_bytes(s.arrays) for s in ns.cells.shards)
    log(f"[23] 2D-1 P3/P2 on cell shards {list(CELL_SHARDS)}: "
        f"{ns.space.n_dofs} DoF, cells {[s.cells for s in ns.cells.shards]}"
        f", setup {setup_s:.1f} s; bytes per shard {per_shard} "
        f"({', '.join(f'{b / sum(per_shard):.3f}' for b in per_shard)} of "
        f"their sum; cell arrays {whole} bytes in all)")
    torch.cuda.synchronize()
    COUNTS.reset()
    ms, walls = [], []
    for _ in range(CELL_SHARD_STEPS):
        t0 = time.perf_counter()
        ms.append(ns.solve_time_step())
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches, plain_cuda = COUNTS.launches, COUNTS.plain_cuda_calls
    peak = torch.cuda.max_memory_allocated()
    cd_gaps = [abs(m.cd - ref) / abs(ref)
               for m, ref in zip(ms, CD_2D1_P3_FLOAT64)]
    sps = 1.0 / walls[0]
    log(f"[23] FGMRES per step {[m.iterations for m in ms]} (one card "
        f"{p18['iterations'][:CELL_SHARD_STEPS]}); Cd "
        + " ".join(f"{m.cd:.5f}" for m in ms) + "; relative to float64 "
        + " ".join(f"{g:.2e}" for g in cd_gaps)
        + f" (limit {CD_2D1_P3_GATE:g}); s per step "
        + " ".join(f"{w:.2f}" for w in walls))
    log(f"[23] step 1: {walls[0]:.2f} s ({sps:.4f} steps/s) on two cell "
        f"shards against phase 18's {p18['step1_s']:.2f} s on one card "
        f"(its steps 2-3: {p18['steps_per_s']:.4f} steps/s); peak {peak} "
        f"bytes (phase 18 {p18['peak_bytes']}); "
        f"SELL launches {launches}; on {card}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    for m in ms:
        check(m.converged and all(np.isfinite([m.cd, m.cl, m.residual])),
              f"[23] 2D-1 P3/P2 on shards converged, finite at t={m.time}")
    check(max(cd_gaps) <= CD_2D1_P3_GATE,
          "[23] 2D-1 P3/P2 on shards: Cd against the float64 run")
    check(launches == 0 and plain_cuda == 0,
          f"[23] 2D-1 P3/P2 on shards: SELL launches {launches}, "
          f"plain-version CUDA calls {plain_cuda} (0 each)")
    return dict(steps_per_s=sps, setup_s=setup_s, peak_bytes=peak,
                shard_bytes=per_shard, iterations=[m.iterations for m in ms],
                cd_gap_float64=max(cd_gaps), seconds=walls)


def phase_scheme_flip():
    """``config.scheme`` changed after setup, as bench.py's monolithic
    window changes it, on the small fixture (fp32, ``cc``): in each
    direction, a model stepping from its captured graphs and one stepping
    eagerly take 2 steps, flip, and take 2 more; the captured model
    captures the new scheme's graphs and its steps equal the eager ones
    bit for bit (u, p, Cd, Cl, counts)."""
    from navierstokes_tpu_torch.models import step_graphs
    t0 = time.perf_counter()
    for start, to, cls in (("projection", "monolithic",
                            step_graphs.MonolithicGraphs),
                           ("monolithic", "projection",
                            step_graphs.ProjectionGraphs)):
        d = os.path.join(WORK, f"flip_{start}")
        cap = small_model("cuda", d + "_cap", scheme=start)
        eag = small_model("cuda", d + "_eager", scheme=start)
        rows = {"captured": [], "eager": []}
        for k in range(4):
            if k == 2:
                cap.config.scheme = eag.config.scheme = to
            rows["captured"].append(cap.solve_time_step())
            rows["eager"].append(eag.solve_time_step(_eager=True))
            if k == 1:
                check(cap._graphs is not None, f"[23] {start}: captured")
        check(isinstance(cap._graphs, cls), f"[23] {start} -> {to}: the "
              f"captured model replays {cls.__name__}")
        same = torch.equal(cap._u, eag._u) and torch.equal(cap._p, eag._p)
        for a, b in zip(rows["captured"], rows["eager"]):
            same = same and (a.cd, a.cl, a.iterations, a.converged) == (
                b.cd, b.cl, b.iterations, b.converged)
        log(f"[23] {start} -> {to} after 2 steps: captured against eager "
            f"{'bit for bit' if same else 'DIFFER'}; iterations "
            f"{[m.iterations for m in rows['captured']]}")
        check(same, f"[23] {start} -> {to}: captured equals eager")
        check(all(m.converged for m in rows["captured"]),
              f"[23] {start} -> {to}: converged")
    log(f"[23] scheme flips in {time.perf_counter() - t0:.1f} s")


# phase 20: steps of the sharded bench point held to phase 5's first ones
SHARD_STEPS = 3


def phase_sharded(ns, bench, card, devices=("cuda:0", "cuda:0"),
                  small_devices=("cuda:0",) * 3):
    """Row sharding: the bench point's projection model on ``devices``
    (one shard each; by default two shards on one card, the vectors and
    the pressure side on the home device ``cuda:0``) against the
    unsharded model ``ns`` of phase 5, bit for bit; then the small
    fixture on ``small_devices`` against one device."""
    from navierstokes_tpu_torch.kernels.sell_spmv import COUNTS
    from navierstokes_tpu_torch.ops import p1ell
    from navierstokes_tpu_torch.ops.bsr import BsrOps
    from navierstokes_tpu_torch.parallel import sharded_bsr
    from navierstokes_tpu_torch.parallel.sharded_bsr import (ShardedBsrOps,
                                                             operator_bytes)
    t_phase = time.perf_counter()
    cards = sorted({torch.device(d) for d in devices}, key=str)
    for d in cards:
        torch.cuda.synchronize(d)
    mem0 = {d: torch.cuda.memory_allocated(d) for d in cards}
    t0 = time.perf_counter()
    sh = bench_model("cuda:0", shard_devices=list(devices),
                     n_devices=len(devices)).setup()
    for d in cards:
        torch.cuda.synchronize(d)
    setup_s = time.perf_counter() - t0
    model_bytes = {str(d): torch.cuda.memory_allocated(d) - mem0[d]
                   for d in cards}
    rows = [(str(s.device), s.rows, s.prows) for s in sh.ell.shards]
    log(f"[20] {len(devices)} row shards of the bench point: setup "
        f"{setup_s:.1f} s, device / velocity / pressure rows {rows}")
    check(len(sh.ell.shards) == len(devices), "[20] one shard per device")
    first = bench["first"]
    COUNTS.reset()
    torch.cuda.reset_peak_memory_stats()
    ms, walls = [], []
    for _ in range(SHARD_STEPS):
        t1 = time.perf_counter()
        ms.append(sh.solve_time_step())
        for d in cards:
            torch.cuda.synchronize(d)
        walls.append((time.perf_counter() - t1) * 1e3)
    launches, plain_cuda = COUNTS.launches, COUNTS.plain_cuda_calls
    per_step = per_step_launches(SHARD_STEPS)
    peak = torch.cuda.max_memory_allocated()
    for k, (a, b) in enumerate(zip(ms, first["metrics"])):
        log(f"[20] step {k + 1}: its {a.f_iterations}+{a.p_iterations} "
            f"(one device {b.f_iterations}+{b.p_iterations}), Cd {a.cd!r} "
            f"({b.cd!r}), Cl {a.cl!r} ({b.cl!r}); {walls[k]:.2f} ms "
            f"(one device {first['ms'][k]:.2f} ms)")
        check((a.f_iterations, a.p_iterations, a.cd, a.cl)
              == (b.f_iterations, b.p_iterations, b.cd, b.cl),
              f"[20] step {k + 1} equals phase 5's bit for bit")
    gap_u = (sh._u - first["u"]).abs().max().item()
    gap_p = (sh._p - first["p"]).abs().max().item()
    eq_u = torch.equal(sh._u, first["u"])
    eq_p = torch.equal(sh._p, first["p"])
    log(f"[20] after {SHARD_STEPS} steps: u equal {eq_u} (max gap "
        f"{gap_u:.3e}), p equal {eq_p} (max gap {gap_p:.3e})")
    check(eq_u and eq_p, "[20] u and p equal phase 5's bit for bit")
    check(launches > 0, "[20] kernel launched on the sharded path")
    check(plain_cuda == 0, "[20] no plain-version calls on CUDA tensors")
    log(f"[20] kernel launches: {launches} over {SHARD_STEPS} steps; per "
        f"step by operator {per_step}")

    # products at phase 5's state, the sharded against the unsharded kernel
    ops, sops = BsrOps(), ShardedBsrOps()
    gen = torch.Generator(device="cuda").manual_seed(20)
    rand = lambda *shape: torch.randn(*shape, device="cuda", generator=gen)
    xu, xp = rand(ns.space.n_p2, 2), rand(ns.space.n_p1)
    conv1 = ops.convection(ns.ell, ns._u)
    conv2 = sops.convection(sh.ell, ns._u)
    f1, f2 = ns.a0_cell + conv1, sh.a0_cell + conv2
    same = {"convection slots": torch.equal(sh.ell.unshard(conv2), conv1),
            "F slots": torch.equal(sh.ell.unshard(f2), f1)}
    for name, a, b in (
            ("F", ops.apply_f(ns.ell, f1, xu), sops.apply_f(sh.ell, f2, xu)),
            ("mass", ops.mass_apply(ns.ell, xu),
             sops.mass_apply(sh.ell, xu)),
            ("G", ops.apply_bt(ns.ell, xp), sops.apply_bt(sh.ell, xp)),
            ("B", ops.apply_b(ns.ell, xu), sops.apply_b(sh.ell, xu))):
        same[name] = a.shape == b.shape and torch.equal(a, b)
    # the block-Jacobi tiles at that state: the exact inverse (the fallback
    # from step 19 on) and a Newton-Schulz step from it
    mflat = ns.bc.mask[:, 0]
    d = ops.f_diag(ns.ell, f1)
    sigma = torch.sum(d * mflat) / torch.clamp(torch.sum(mflat), min=1.0)
    x1 = p1ell.block_jacobi_inverse(ns._bj_plan, f1, mflat, sigma)
    x2 = sharded_bsr.block_jacobi_inverse(sh._bj_plan, f2, mflat, sigma)
    home = lambda parts: torch.cat([t.to(x1.device) for t in parts])
    same["exact tile inverse"] = torch.equal(home(x2.parts), x1)
    n1 = p1ell.block_jacobi_invert(ns._bj_plan, f1, mflat, sigma, x0=x1)
    n2 = sharded_bsr.block_jacobi_invert(sh._bj_plan, f2, mflat, sigma,
                                         x0=x2)
    same["Newton-Schulz tiles"] = torch.equal(home(n2.parts), n1)
    # the per-step exact fallback (the capturable cuSOLVER LU)
    e1 = p1ell.block_jacobi_invert(ns._bj_plan, f1, mflat, sigma, x0=None,
                                   iters=0)
    e2 = sharded_bsr.block_jacobi_invert(sh._bj_plan, f2, mflat, sigma,
                                         x0=None, iters=0)
    same["exact tile inverse, per step"] = torch.equal(home(e2.parts), e1)
    del x1, x2, n1, n2, e1, e2
    log(f"[20] sharded against unsharded, bit for bit: {same}")
    check(all(same.values()), "[20] sharded products equal the unsharded")

    # memory: each shard's operators against the one-device operators
    shard_bytes = sh.ell.shard_bytes()
    one_bytes = operator_bytes(ns.ell)
    log(f"[20] operator bytes per shard {shard_bytes} (sum "
        f"{sum(shard_bytes)}) against one device {one_bytes}; the sharded "
        f"model holds {model_bytes} bytes per card after setup (home "
        f"cuda:0), home peak {peak} bytes over its steps, on {card}")

    # the small fixture, monolithic cc, three shards against one
    small = {}
    for n, devs in ((1, None), (len(small_devices), list(small_devices))):
        m = small_model("cuda", os.path.join(WORK, f"shard_small{n}"),
                        shard_devices=devs, n_devices=n,
                        scheme="monolithic", preconditioner="cc")
        small[n] = ([m.solve_time_step() for _ in range(SHARD_STEPS)],
                    m._u, m._p)
    (m1, u1, p1), (mn, un, pn) = small[1], small[len(small_devices)]
    its = [(a.iterations, b.iterations) for a, b in zip(mn, m1)]
    eq = (torch.equal(un.to(u1.device), u1)
          and torch.equal(pn.to(p1.device), p1)
          and all((a.cd, a.cl, a.iterations) == (b.cd, b.cl, b.iterations)
                  for a, b in zip(mn, m1)))
    log(f"[20] small fixture, monolithic cc, {len(small_devices)} shards "
        f"on {list(small_devices)} against 1: FGMRES {its}, bit for bit "
        f"{eq}")
    check(eq, "[20] small fixture on shards equals 1 bit for bit")
    wall = time.perf_counter() - t_phase
    log(f"[20] ms per step sharded {[round(w, 2) for w in walls]} against "
        f"phase 5's first steps {[round(w, 2) for w in first['ms']]}; phase "
        f"{wall:.1f} s")
    return dict(launches=launches, per_step=per_step, setup_s=setup_s,
                shard_bytes=shard_bytes, one_device_bytes=one_bytes,
                model_bytes=model_bytes, peak_bytes=peak, ms=walls,
                one_device_ms=first["ms"])


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    os.makedirs(WORK, exist_ok=True)
    t_start = time.perf_counter()
    card = phase_device()
    phase_build()
    t0 = time.perf_counter()
    ns = bench_model("cuda").setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_dofs = ns.space.n_dofs
    log(f"[3] bench point: {n_dofs} DoF, setup {setup_s:.1f} s")
    check(n_dofs == EXPECTED_DOFS, f"DoF count {n_dofs}")
    fp32 = phase_kernel_vs_plain(ns, (torch.float32,), "3")
    phase_small_fixture()
    bench = phase_bench(ns, card)
    graphs = phase_graphs(ns, bench, card)
    variants = phase_kernel_vs_plain(ns, (torch.bfloat16, torch.float64),
                                     "6")
    sharded = phase_sharded(ns, bench, card)
    del ns
    gc.collect()
    torch.cuda.empty_cache()
    small = phase_monolithic_small()
    mono = phase_monolithic_bench(card)
    mono_graphs = phase_monolithic_graphs(mono, card)
    del mono["ns"]
    gc.collect()
    torch.cuda.empty_cache()
    small3d = phase_small_3d()
    ns3, st3d1 = phase_3d1(card)
    uses3d = phase_kernel_3d(ns3)
    del ns3
    gc.collect()
    torch.cuda.empty_cache()
    phase_cli()
    phase_naca_small()
    naca = phase_naca_sweep(card)
    uses_naca = phase_kernel_naca()
    gc.collect()
    torch.cuda.empty_cache()
    phase_postprocess()
    phase_rhs_terms()
    stokes = phase_stokes()
    gc.collect()
    torch.cuda.empty_cache()
    cells_runs = phase_cells_small()
    cells_2d1 = phase_2d1_p3(card)
    phase_validate(card)
    cell_shards_small = phase_cell_shards_small(cells_runs)
    cell_shards = phase_2d1_p3_shards(card, cells_2d1)
    phase_scheme_flip()
    paths = {"projection": bench["per_step"], "monolithic": mono["per_step"],
             "sharded": sharded["per_step"]}
    # F and the mass share the F pattern, so one count covers both
    pattern_of = {"F": "F", "mass": "F", "P1 Laplacian": "P1 Laplacian",
                  "Ap": "Ap", "G": "G", "B": "B", "PCD convection": "PP"}

    def entry(dt, uses, launches, replaces, paths=paths, suffix=""):
        f_use = uses[0]
        for u in uses:
            key = f"{pattern_of[u['use']]} {str(dt).replace('torch.', '')}"
            u["launches_per_step"] = {p: c.get(key, 0.0)
                                      for p, c in paths.items()}
        return {"name": VARIANTS[dt][2] + suffix, "route": "cuda",
                "source": KERNEL_SOURCE, "replaces": replaces,
                "launches": launches,
                "max_abs_err": max(u["max_abs_err"] for u in uses),
                **{k: f_use[k] for k in ("ms", "warm_ms", "plain_ms",
                                         "bound_ms", "bound_by",
                                         "bound_bytes", "library_ms")},
                "uses": uses}

    kernels = []
    for dt, launches, replaces in (
            (torch.float32,
             bench["launches"] + mono["launches"] + sharded["launches"],
             REPLACES),
            (torch.bfloat16, small["cc+inner_bf16"]["launches_bf16"],
             REPLACES_BF16),
            (torch.float64, small["cc+refine=2"]["launches_f64"], None)):
        uses = (fp32 if dt == torch.float32 else variants)[dt]
        kernels.append(entry(dt, uses, launches, replaces))
    kernels[0]["rebuild_ms"] = fp32["rebuild_ms"]
    kernels[0]["floor_ms"] = fp32["floor_ms"]
    kernels[0]["stokes"] = stokes
    # D=3: launches on 3D-1Z (fp32) and on the 3D small fixture's bf16 and
    # refinement paths; the uses are the 3D-1Z operators (phase 11)
    d3_pattern = {"F (D=3)": "F", "mass (D=3)": "F", "P1 Laplacian":
                  "P1 Laplacian", "G": "G", "B": "B"}
    for dt, launches, replaces in (
            (torch.float32, st3d1["launches"], REPLACES),
            (torch.bfloat16, small3d["cc+inner_bf16"][(torch.bfloat16, 3)],
             REPLACES_BF16),
            (torch.float64, small3d["cc+refine=2"][(torch.float64, 3)],
             None)):
        uses = uses3d[dt]
        for u in uses:
            key = f"{d3_pattern[u['use']]} {str(dt).replace('torch.', '')}"
            u["launches_per_step"] = {"3d1": st3d1["per_step"].get(key, 0.0)}
        kernels.append({
            "name": VARIANTS[dt][2] + "_d3", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": replaces,
            "launches": launches,
            "max_abs_err": max(u["max_abs_err"] for u in uses),
            **{k: uses[0][k] for k in ("ms", "warm_ms", "plain_ms",
                                       "bound_ms", "bound_by", "bound_bytes",
                                       "library_ms")},
            "uses": uses})
    kernels[3]["steps_per_s_3d1"] = st3d1["steps_per_s"]
    kernels[3]["setup_s_3d1"] = st3d1["setup_s"]
    kernels[3]["peak_bytes_3d1"] = st3d1["peak_bytes"]
    # the NACA sweep: its step launches, and the uses at its own shapes
    kernels.append(entry(torch.float32, uses_naca, naca["launches"],
                         REPLACES, paths={"naca": naca["per_step"]},
                         suffix="_naca"))
    kernels[-1].update({k: naca[k] for k in ("setup_launches", "runs",
                                             "peak_bytes")})
    # the Givens kernel: launches on the monolithic bench path (phase 8,
    # captured)
    g = graphs["givens"]
    kernels.append({
        "name": "lsq_update", "route": "cuda", "source": GIVENS_SOURCE,
        "replaces": GIVENS_REPLACES, "launches": mono["givens"]["update"],
        "max_abs_err": 0.0, "ms": g["ms"], "in_graph_ms": g["in_graph_ms"],
        "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"],
        "bound_by": "bytes", "library_ms": g["library_ms"],
        "launches_per_captured_step": (mono["givens"]["update"]
                                       / mono["n_steps"]),
        "launches_per_step_phase22": {r["mode"]: r["givens"]
                                      for r in mono_graphs["runs"]}})
    # the conditional nodes' kernel: launches on the same path
    nd = mono_graphs["nodes"]
    kernels.append({
        "name": "set_condition", "route": "cuda", "source": COND_SOURCE,
        "replaces": COND_REPLACES, "launches": mono["set_condition"],
        "max_abs_err": float(nd["max_abs_err"]), "ms": nd["ms"],
        "run_node_ms": nd["run_ms"], "plain_ms": nd["plain_ms"],
        "bound_ms": nd["bound_ms"], "bound_by": "bytes", "library_ms": None,
        "launches_per_captured_step": mono["set_condition"] / mono["n_steps"],
        "capture": {k: v for k, v in mono["capture"].items()}})
    kernels[0]["graphs"] = {k: graphs[k] for k in ("runs", "peak_bytes",
                                                   "capture_s",
                                                   "inverse_gap")}
    kernels[0]["monolithic_graphs"] = {
        "runs": mono_graphs["runs"], "peak_bytes": mono_graphs["peak_bytes"],
        **mono["capture"]}
    record = {"kernels": kernels}
    log(f"chip_smoke: every phase passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    log(f"2D-1 P3/P2 cells window: {cells_2d1['steps_per_s']:.4f} steps/s, "
        f"FGMRES {cells_2d1['iterations_timed']:.1f} per timed step, setup "
        f"{cells_2d1['setup_s']:.1f} s, peak {cells_2d1['peak_bytes']} bytes")
    log(f"2D-1 P3/P2 on two cell shards of cuda:0: step 1 "
        f"{cell_shards['steps_per_s']:.4f} steps/s (one card "
        f"{1.0 / cells_2d1['step1_s']:.4f}), "
        f"FGMRES {cell_shards['iterations']}, bytes per shard "
        f"{cell_shards['shard_bytes']}, peak {cell_shards['peak_bytes']} "
        f"bytes; small cases' worst gap to one card "
        f"{max(cell_shards_small.values()):.2e}")
    log(card)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
