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
   CUDA graphs (models/step_graphs.py, captured first: BiCGStab and CG
   each one while node), with the kernel's launch count per operator
   (from the graphs' replay records); per step one host read (the tile
   guard), two loops entered, one body per iteration, no masked
   iteration and no skipped body, set_condition launches, beside PR 10's
   figures; the capture's seconds, peak and reserved-memory growth;
6. the bf16-values and fp64 kernel variants against their plain versions
   in every use, timed as in phase 3;
7. the small fixture under ``scheme="monolithic"``: 5 steps on the card
   (captured) against the CPU, fp32, with ``cc``, ``asimple``, ``cc`` +
   ``inner_bf16`` (the bf16 variant's path) and ``cc`` + ``refine=2`` (the
   fp64 variant's path), and against 5 eager steps on the card, bit for
   bit with the same SELL and Givens launches;
8. the monolithic bench point (FGMRES + Cahouet-Chabard, BDF1), after the
   projection model is freed: the step captured (models/step_graphs.py
   ``MonolithicGraphs``: each FGMRES cycle one while node, the inner
   BiCGStab a while node nested in its body; capture seconds, graphs,
   while nodes, peak and reserved-memory growth beside PR 10's, bytes by
   pool), then 5
   warm-up and 5 timed steps through ``solve_time_step``; host reads
   (the guard and one per cycle's end), loops entered, bodies run, no
   masked iteration and no skipped body, set_condition launches per
   step beside PR 10's; one Givens launch per FGMRES iteration;
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
   run, host reads, masked iterations, skipped bodies, loops entered,
   bodies run and set_condition launches per step (captured: one read,
   none masked or skipped, set_condition the eager run's plus one per
   loop entered), capture seconds, peak memory; the exact tile inverse at the bench point's 1,760 tiles
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
   each run, host reads, masked iterations, skipped bodies, loops entered,
   bodies run and set_condition launches per step (captured: none masked
   or skipped, set_condition the eager run's plus one per loop entered),
   the capture's seconds and memory, peak memory (each run's, with bytes
   by pool), beside PR 10's; then the while node (csrc/graph_cond.cu)
   against the host loop at 64 seeded trip counts 0..64, its predicate
   kernel against its plain version, its device time per iteration (a
   one-add body, and a body ending in the Givens kernel) and alone (the
   record's ``set_condition`` entry);
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
   equals the eager model bit for bit;
24. the block-Jacobi tile-apply kernel (csrc/bj_apply.cu; its launches
   are counted on every path above that applies tiles: phases 5, 7, 8,
   14, 20, 21, 22, each path's tiles in its own dtype only, no plain
   call): right after phase 22, against its plain version at the fp32
   tiles of the captured projection (phase 21's last replay) and
   monolithic (phase 22's) bench steps, the same tiles in bf16 (``bj_bf16``)
   and, for the monolithic step, in fp64, within 1e-5 (fp32), one bf16
   ulp (bf16) and 1e-12 (fp64) of max|y|, bit-identical on repeat, the
   tail tile alone equal to the batch's rows, with its ms per call in
   bursts, the plain version's, the bound (tile rows read + r + y bytes
   over 3.35 TB/s) and the library's batched GEMM (``torch.matmul``),
   the fp64 apply and ``torch.matmul`` again in 8 rounds of alternating
   bursts, the library over its own copy of the tiles (medians; the fp64
   ring no slower than the library), then over the kernel's tiles
   (printed); the launches per step of each path; before
   those, the edges of the fp64 ring and its persistent grid for every
   tile type (one tile, a count of items the grid does not divide, a
   one-row tail tile, SB 128 and 512, d=3, ``tiles[t:]`` slices, and 12
   launches with 40 MB of tiles read into the L2 before each), each
   against its plain version, on repeat and tile by tile alone, with the
   grid, stages and bytes per stage printed; 2 captured float64 steps of
   the phase 4 small fixture on the card (the fp64 variant) against the
   CPU within 1e-9; then the same check and times, d=3, at the exact tile
   inverses of 3D-1Z's F (right after phase 11, fp32 and bf16) and, d=2,
   of the NACA model's static operator (phase 14's kernel model);
25. the solver options the port took last (right after phase 24's bench
   part): at the bench point, fp32, one model each, set up and captured,
   ``proj_poisson="schur"`` and ``proj_p_extrap=0.5`` from phase 5's end
   state and monolithic ``cc`` with ``f_solver="richardson"`` from phase
   8's, 5 steps captured (replays sync-checked), eager and captured
   again, every run equal bit for bit (u, p, phi, Cd, Cl, counts,
   residuals) with the same SELL and tile-apply launches per step, every
   step finite, no captured step with a masked iteration or a skipped
   body; the converged flags and counts (Richardson's FGMRES may
   stall at this CFL, as the JAX package measured, so no convergence
   gate), steps/s, setup and capture seconds; schur's max |B u| over its
   unpinned nodes after one step below the Laplacian step's from the
   same state (computed while the phase 5 model lives); then the six
   options on the phase 4 small fixture card against CPU: fp32 schur,
   p_extrap, richardson, ``mass_format="node"``, ``bj_tiles="rows"`` and
   ``"scatter"`` under phase 4's rule, and ``operator="ell"`` in float64
   within 1e-9 at the inner solves' 1e-10 (phase 18's gate), 1 step; the
   phase's seconds;
26. the Krylov loops' kernels (right after phase 25; their launches are
   counted on phases 5, 8, 21, 22 and 25, per step by kind: each fused
   update stage of csrc/krylov_update.cu, also by the path its element
   loop took (``stage:path``: vector, peeled or scalar), and the
   Gram-Schmidt steps of csrc/gram_schmidt.cu, equal between captured
   and eager runs, one launch of each BiCGStab stage per BiCGStab
   iteration and of each CG stage per CG iteration in phases 5 and 21,
   one Gram-Schmidt step per FGMRES iteration in phases 8 and 22; in
   phase 5 one captured CG iteration of the bench step launches 3 kernels
   besides its product and its preconditioner, cg_xr, cg_p and the
   predicate, so no cuBLAS dot and no norm reduction, counted as graph
   kernel nodes): at the bench point's shapes (BiCGStab n = 901,036, CG
   n = 113,378), fp32 and fp64, each BiCGStab stage against its plain
   version bit for bit with the flag up and down (down: no state buffer
   moves), each CG stage (one thread-block cluster that takes its own
   float64 dots) over 8 seeded draws, every other one with products of
   both signs in its dot, under ``krylov_update.cg_gate`` (fp32: the dot
   and the norm within one ulp, every tensor bit for bit where they are
   equal, the bit-equal draws counted; fp64 within 1e-13 of the sum of
   |a b|; where the dots differ, each vector element within what the
   gap moves it) and bit for bit with the flag down, timed on aligned views (the
   vector path) and on views one element off (the peeled path), the CG
   stages L2-warm too and beside the cuBLAS dots and the norm they took
   over; cuBLAS's ``y @ Z`` on the padded basis against a contiguous
   copy (whether the row stride moves its bits); Gram-Schmidt on the
   flat 1,014,414-element vector in the padded basis at restart 64 and
   j = 0, 5, 13, 20, 38, 63 against its plain version within one ulp or
   2^-24 (fp32) / 1e-12 (fp64) of the scale, bit-identical on repeat, V
   and Z untouched with the flag down, its kernel launches per call
   counted in a captured call's graph; each
   timed in bursts over input sets that exceed twice the L2, beside its
   bound (bytes over 3.35 TB/s), its plain version (launched eagerly)
   and, for Gram-Schmidt, one cuBLAS ``V @ w`` over the whole basis (the
   record's ``library_ms``) and the whole-basis sequence the port ran
   before;
27. the V-cycle's smoothing sweeps (csrc/vcycle.cu: every stage between
   two coarse corrections in one persistent launch; right after phase
   14's kernel model; their launches are counted on phases 5, 8, 21, 22
   and 25, per step by sweep: each V-cycle a pre and a post sweep and
   n_cycles - 1 mid, none of the plain stages; in phase 5 the V-cycle of
   one captured CG iteration launches exactly the kernels
   ``vcycle.launches(1, k)`` states (4), graph nodes counted, and the
   iteration 8): at the bench point's and 3D-1Z's outlet-pinned
   Laplacians (n = 113,378 and 140,740) and the NACA step's Ap, in fp32
   and fp64, each sweep on each path that holds the operator (its slices
   in shared memory, or read from device memory) and on the plan of
   rounds 0 (as if the card had one SM for every 300 slices: any number
   of slices a warp, the rows' state in device memory) against its plain
   version on seeded inputs bit for bit in every buffer, on repeat and on
   an odd-offset right-hand side, every CTA's progress word equal; each
   plan (CTAs, slices a warp, shared-memory bytes a CTA, the compiler's
   registers and local memory); the whole fused V-cycle at 1 cycle and at
   the model's cycles against the plain cycle bit for bit (aligned and
   odd-offset r; the plan of rounds 0 too) and its captured kernel nodes
   held to
   ``vcycle.launches(n, k)`` (4 at 1 cycle, 7 at 2); fp32 times: each
   sweep in L2-cold and warm bursts beside its bound and its plain
   version (both paths at the bench point), the fused and the plain
   (stock) V-cycle per call;
28. the block-Jacobi tile rebuild's kernels (csrc/bj_tiles.cu: the masked
   tiles in one write, the max of the guard's partials; the guard's row
   sums and each Newton-Schulz update are epilogues of csrc/bj_gemm.cu,
   phase 30; the launches of both are counted on phases
   5, 8, 14, 20, 21, 22 and 25 per step by kernel and epilogue, each held
   to the step's branch, and the plain versions (cuBLAS's products among
   them) make no CUDA call there): right after phase 20, at phase 5's end
   state (F values, mask, sigma and the static seed; 1,760 tiles of 256 x
   256), and in phase 14's kernel model after one plain step at the NACA
   step's 274 tiles, each kernel against its plain version bit for bit
   (the tiles from fp32 and fp64 F values, the guard's A X0 and norm, each
   update and the product after it, the last update in fp32, bf16 and
   fp64), the Newton-Schulz rebuild against the stock PyTorch chain the
   port ran before (the same tile inverses; the guard's norm within 1e-6
   of the stock sums', the same branch); the tiles kernel's ms per call
   L2-cold and warm beside its bound and its plain version; one
   Newton-Schulz rebuild (segments (a) and (b)) captured, the kernels'
   graph against the stock chain's in alternating rounds;
29. the exact tile inverse (csrc/bj_inverse.cu; see its section below);
30. the Newton-Schulz products (csrc/bj_gemm.cu: one batched fp32 GEMM,
   k ascending in one accumulator as cuBLAS's batched kernel sums, with
   the guard's row sums, the update 2 X - X (A X) or nothing in its
   epilogue): right after phase 28 at phase 5's end state and after phase
   28's NACA part, each epilogue at the operands the step gives it against
   its plain version (torch.matmul, then the plain pass) bit for bit; ms
   per call L2-cold and warm beside the bound (operations), the plain
   version and torch.matmul alone (the record's ``library_ms``), a line
   where the bare product is the slower; CTAs an SM; one eager rebuild
   under torch.profiler: the GEMM's kernel and no library GEMM.

Each path is driven with the launch counts set to 0 just before it and
read just after.  Any failed check raises, so the exit code is not 0.
The last two lines of standard output are the kernel record and the
result, each one JSON object.  Imports no jax and nothing of the JAX
package.
"""

import collections
import ctypes
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


@functools.lru_cache(maxsize=1)
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


def kry_reset():
    """Set the Krylov loops' kernel counts to 0 (csrc/krylov_update.cu's
    stages, csrc/gram_schmidt.cu's steps, csrc/vcycle.cu's V-cycle
    sweeps) and the tile rebuild's (csrc/bj_tiles.cu, csrc/bj_gemm.cu,
    csrc/bj_inverse.cu)."""
    from navierstokes_tpu_torch.kernels import (gram_schmidt, krylov_update,
                                                vcycle)
    krylov_update.COUNTS.reset()
    gram_schmidt.COUNTS.reset()
    vcycle.COUNTS.reset()
    rebuild_reset()


def rebuild_reset():
    """Set the tile rebuild's kernel counts to 0."""
    from navierstokes_tpu_torch.kernels import bj_gemm, bj_inverse, bj_tiles
    bj_tiles.COUNTS.reset()
    bj_gemm.COUNTS.reset()
    bj_inverse.COUNTS.reset()


def rebuild_counts():
    """The tile rebuild's launches since its counts were last set to 0, by
    kernel and dtype (``rebuild:<kernel> <dtype>``: csrc/bj_tiles.cu's
    ``tiles`` and ``guard_max``, csrc/bj_gemm.cu's epilogues ``guard``,
    ``product``, ``update`` and ``update_last``, the exact inverse of
    csrc/bj_inverse.cu as ``rebuild:inverse <out dtype>``), and its plain
    versions' calls on CUDA tensors (``rebuild_plain``; the GEMM's plain
    versions are cuBLAS's products, so 0 means no cuBLAS GEMM from the
    rebuild)."""
    from navierstokes_tpu_torch.kernels import bj_gemm, bj_inverse, bj_tiles
    variants = {**bj_tiles.COUNTS.by_variant, **bj_gemm.COUNTS.by_variant}
    c = {f"rebuild:{k} {str(dt).replace('torch.', '')}": v
         for (k, dt), v in sorted(variants.items(), key=str)}
    c.update({f"rebuild:inverse {str(dt).replace('torch.', '')}": v
              for dt, v in sorted(bj_inverse.COUNTS.by_dtype.items(),
                                  key=str)})
    c["rebuild_plain"] = (bj_tiles.COUNTS.plain_cuda_calls
                          + bj_gemm.COUNTS.plain_cuda_calls
                          + bj_inverse.COUNTS.plain_cuda_calls)
    return c


def kry_per_step(n_steps):
    """Launches per step of the Krylov loops' kernels by kind since
    ``kry_reset``: each fused update stage, each stage by the path its
    element loop took (``stage:path``: vector, peeled or scalar), the
    Gram-Schmidt calls (``gram_schmidt``; phase 26 counts each call's
    kernels in a captured call's graph), each V-cycle sweep
    (``vcycle_<pre|mid|post>``) and the V-cycle's plain stages on CUDA
    tensors (``vcycle_plain``, 0 on every path), and the tile rebuild's
    kernels (``rebuild_counts``)."""
    from navierstokes_tpu_torch.kernels import (gram_schmidt, krylov_update,
                                                vcycle)
    c = dataclasses.asdict(krylov_update.COUNTS)
    c.update({f"{stage}:{way}": v for (stage, way), v
              in sorted(krylov_update.PATHS.items())})
    c["gram_schmidt"] = gram_schmidt.COUNTS.calls
    c.update({f"vcycle_{kind}": getattr(vcycle.COUNTS, kind)
              for kind in vcycle.SWEEPS})
    c["vcycle_plain"] = vcycle.COUNTS.plain_cuda_calls
    c.update(rebuild_counts())
    return {k: v / n_steps for k, v in c.items()}


def vcycle_per_step(phase, tag, kry, n_cycles, k, calls=None):
    """The V-cycle's sweep launches per step in ``kry`` (``kry_per_step``):
    logged; every V-cycle of the path fused (``vcycle_plain`` 0), each a
    ``pre`` and a ``post`` sweep and n_cycles - 1 ``mid``; given
    ``calls``, V-cycle solves per step, exactly ``calls`` of them.  Returns
    the V-cycle solves per step."""
    solves = kry["vcycle_pre"]
    log(f"[{phase}] {tag}: V-cycle (csrc/vcycle.cu) sweeps per step: pre "
        f"{solves:.2f}, mid {kry['vcycle_mid']:.2f}, post "
        f"{kry['vcycle_post']:.2f}; {solves:.2f} V-cycles of {n_cycles} "
        f"cycle(s), k = {k}"
        + ("" if calls is None else f" ({calls:.2f} expected)"))
    check(kry["vcycle_plain"] == 0 and solves > 0
          and abs(kry["vcycle_post"] - solves) < 1e-9
          and abs(kry["vcycle_mid"] - (n_cycles - 1) * solves) < 1e-9,
          f"[{phase}] {tag}: every V-cycle runs the sweeps, a pre, a post "
          f"and n_cycles - 1 mid: {kry}")
    if calls is not None:
        check(abs(solves - calls) < 1e-9,
              f"[{phase}] {tag}: {solves:.2f} fused V-cycles per step, "
              f"expected {calls:.2f}")
    return solves


def check_rebuild(phase, tag, per_step, ms, parts=1, iters=3,
                  dtype="float32", seeds=0):
    """The path rebuilt its tiles through csrc/bj_tiles.cu, csrc/bj_gemm.cu
    and csrc/bj_inverse.cu (``per_step``: launches per step with
    ``rebuild_counts``' keys): per step and row shard (``parts``) one tiles
    launch (and ``seeds`` more over the window where it built the static
    seed), the GEMM's guard epilogue and the max of its partials, on each
    Newton-Schulz step (``StepMetrics.exact_inverse`` False) iters - 1
    update and as many product epilogues and one last update into
    ``dtype`` tiles, on each exact step one exact inverse into ``dtype``
    tiles; no plain version on CUDA tensors (so no cuBLAS GEMM).  Logs the
    branch per step (N Newton-Schulz, E exact) beside the exact inverse's
    launches per step and returns it."""
    n = len(ms)
    newton = sum(not m.exact_inverse for m in ms)
    exact = n - newton
    got = {k.split(":", 1)[1]: v for k, v in per_step.items()
           if k.startswith("rebuild:")}
    want = {"guard float32": parts, "guard_max float32": parts}
    if newton and iters > 1:
        want["update float32"] = parts * (iters - 1) * newton / n
        want["product float32"] = parts * (iters - 1) * newton / n
    if newton:
        want[f"update_last {dtype}"] = parts * newton / n
    if exact:
        want[f"inverse {dtype}"] = parts * exact / n
    branch = "".join("E" if m.exact_inverse else "N" for m in ms)
    log(f"[{phase}] {tag}: tile rebuild (csrc/bj_tiles.cu, csrc/bj_gemm.cu, "
        f"csrc/bj_inverse.cu) launches per step {got}; tile inverses per "
        f"step {branch} (N Newton-Schulz, E exact), exact-inverse launches "
        f"per step {got.get(f'inverse {dtype}', 0.0):.2f} ({parts} a shard "
        f"on each E step, 0 on N); plain-version CUDA calls "
        f"{per_step['rebuild_plain']}")
    tiles_ok = any(abs(got.get("tiles float32", 0.0) - parts - s / n) < 1e-9
                   for s in {0, seeds})
    check(per_step["rebuild_plain"] == 0 and tiles_ok
          and set(got) == set(want) | {"tiles float32"}
          and all(abs(got[k] - want[k]) < 1e-9 for k in want),
          f"[{phase}] {tag}: the tile rebuild's kernels per step {got} "
          f"for {parts} part(s), {newton} Newton-Schulz steps of {n} "
          f"(want {want}, tiles {parts} + seeds), no plain call")
    return branch


def check_kry_projection(phase, kry, ms, ploop=None, k=3):
    """A projection step's BiCGStab iterations each launch the three
    BiCGStab stages once, its CG iterations the two CG stages; no
    Gram-Schmidt; one fused V-cycle of one cycle and k smoothing
    iterations (``vcycle_per_step``) per CG iteration and one for CG's
    set-up.  Given the step's CG loop (after its run, the counts read),
    also that one captured CG iteration launches no cuBLAS dot and no norm
    reduction: CG_ITERATION_KERNELS kernels besides its product and its
    preconditioner (``check_cg_iteration``), the preconditioner, its
    V-cycle, exactly ``vcycle.launches(1, k)`` kernels.  Returns that
    count, or None."""
    from navierstokes_tpu_torch.kernels import vcycle
    n = len(ms)
    f_its = sum(m.f_iterations for m in ms) / n
    p_its = sum(m.p_iterations for m in ms) / n
    check(all(abs(kry[s] - f_its) < 1e-9 for s in
              ("bicgstab_p", "bicgstab_s", "bicgstab_xr"))
          and all(abs(kry[s] - p_its) < 1e-9 for s in ("cg_xr", "cg_p"))
          and kry["gram_schmidt"] == 0 and f_its > 0 and p_its > 0,
          f"[{phase}] one launch of each BiCGStab stage per BiCGStab "
          f"iteration ({f_its:.2f}) and of each CG stage per CG iteration "
          f"({p_its:.2f}) per step: {kry}")
    vcycle_per_step(phase, "projection", kry, 1, k, calls=p_its + 1)
    if ploop is None:
        return None
    it = cg_iteration_launches(ploop)
    check_cg_iteration(phase, it)
    fused, stated = vcycle.launches(1, k)
    log(f"[{phase}] the captured CG iteration's preconditioner, the fused "
        f"V-cycle: {it['preconditioner']} kernels ({fused} sweeps, "
        f"{stated} in all stated); the iteration's kernels in all "
        f"{it['body']}")
    check(it["preconditioner"] == stated,
          f"[{phase}] the V-cycle of a captured CG iteration launches "
          f"{stated} kernels (got {it['preconditioner']})")
    return it


# PR 10's figures of the captured steps, printed beside this run's
# (PERF.md section 6: H100 (700 W), calls AX and BN): the projection step's
# host reads and masked iterations per step, the monolithic step's host
# reads and set_condition launches per step, its capture's seconds,
# reserved-memory growth and phase 22's peak
PR10 = dict(proj_reads="8.00", proj_masked="5.20", mono_reads="4.8-5.4",
            mono_set_condition="310.2 (phase 8), 226.4 (phase 22)",
            capture_s="1.05-1.30", reserved_growth=4_370_464_768,
            peak_22=6_680_577_024)
WHILE_FIELDS = ("flag_reads", "masked_iterations", "skipped_bodies",
                "loops_entered", "bodies_run")


def while_counts(phase, tag, ms, captured):
    """Per step over ``ms``: host reads, masked iterations, skipped bodies,
    while loops entered and bodies run; a captured run must show no masked
    iteration and no skipped body at any step."""
    out = {f: sum(getattr(m, f) for m in ms) / len(ms) for f in WHILE_FIELDS}
    if captured:
        check(all(m.masked_iterations == 0 and m.skipped_bodies == 0
                  for m in ms),
              f"[{phase}] {tag}: no masked iteration and no skipped body in "
              "any captured step")
    return out


def while_line(w, set_condition=None):
    """The per-step figures of ``while_counts`` as a log phrase."""
    return (f"host reads {w['flag_reads']:.2f}, masked iterations "
            f"{w['masked_iterations']:.2f}, skipped bodies "
            f"{w['skipped_bodies']:.2f}, loops entered "
            f"{w['loops_entered']:.2f}, bodies run {w['bodies_run']:.2f}"
            + ("" if set_condition is None
               else f", set_condition launches {set_condition:.2f}")
            + " per step")


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


def _csr(mat, vals):
    """A PyTorch CSR tensor of the same nonzeros (for the library calls;
    the port never builds one)."""
    idx = torch.as_tensor(mat.nz_slot, device=vals.device)
    crow = np.zeros(mat.n_rows + 1, np.int64)
    np.cumsum(np.bincount(mat.nz_row, minlength=mat.n_rows), out=crow[1:])
    return torch.sparse_csr_tensor(
        torch.as_tensor(crow, device=vals.device),
        torch.as_tensor(mat.nz_col, device=vals.device), vals[idx],
        size=(mat.n_rows, mat.n_cols), check_invariants=False)


def _library_fn(mat, vals, x):
    """One PyTorch call computing the same product: torch.sparse.mm on a
    CSR tensor of the same nonzeros (the port never calls it)."""
    a = _csr(mat, vals)
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
    from navierstokes_tpu_torch.kernels import bj_apply, conditional
    from navierstokes_tpu_torch.kernels.sell_spmv import COUNTS
    cfg = ns.config
    n_warm, n_meas = 10, 10
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reserved0 = torch.cuda.memory_reserved()
    sg = ns.capture_graphs()
    capture_peak = torch.cuda.max_memory_allocated()
    growth = torch.cuda.memory_reserved() - reserved0
    log(f"[5] captured the projection step: {len(sg.graphs)} graphs, "
        f"{sg.nodes} while nodes, in {sg.capture_seconds:.2f} s (with a "
        f"warm-up step), peak {capture_peak} bytes, reserved memory grew by "
        f"{growth} bytes")
    torch.cuda.reset_peak_memory_stats()
    COUNTS.reset()
    bj_apply.COUNTS.reset()
    conditional.COUNTS.reset()
    kry_reset()
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
    bj, bj_plain = bj_snapshot()
    peak = torch.cuda.max_memory_allocated()
    sps = n_meas / wall
    whiles = while_counts(5, "projection", ms_all, captured=True)
    conds = conditional.COUNTS.set_condition / (n_warm + n_meas)
    kry = kry_per_step(n_warm + n_meas)
    log(f"[5] Krylov loop kernels (csrc/krylov_update.cu stages, "
        f"csrc/gram_schmidt.cu steps) per step: {kry}")
    cg_iteration = check_kry_projection(5, kry, ms_all,
                                        ns._graphs.ws.ploop,
                                        k=cfg.schur_smooth_k)
    branch = check_rebuild(5, "projection captured", kry, ms_all)
    log(f"[5] captured steps: {while_line(whiles, conds)} (PR 10: host "
        f"reads {PR10['proj_reads']}, masked iterations "
        f"{PR10['proj_masked']} per step, AX) on {card}")
    check(all(m.flag_reads == 1 for m in ms_all),
          "[5] one host read per step, the tile guard's")
    check(all(m.loops_entered == 2
              and m.bodies_run == m.f_iterations + m.p_iterations
              for m in ms_all),
          "[5] two while loops per step, one body per iteration")
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
    check_bj_path(5, bj, bj_plain, n_warm + n_meas, torch.float32, 2)
    log(f"[5] all {len(ms_all)} solves converged (rel tol {tol:g})")
    end = {a: getattr(ns, a).clone() for a in ("_u", "_p", "_u_prev",
                                               "_phi", "_t")}
    end["time"] = ns.time
    return dict(launches=launches, steps_per_s=sps, peak_bytes=peak,
                per_step=per_step, first=first, metrics=ms_all, end=end,
                capture_s=sg.capture_seconds, capture_peak_bytes=capture_peak,
                reserved_growth_bytes=growth, whiles=whiles,
                set_condition_per_step=conds, bj=bj,
                bj_per_step=bj_per_step(bj, n_warm + n_meas),
                kry_per_step=kry, n_steps=n_warm + n_meas,
                cg_iteration=cg_iteration, branch=branch)


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
    from navierstokes_tpu_torch.kernels import bj_apply, conditional
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
        bj_apply.COUNTS.reset()
        conditional.COUNTS.reset()
        kry_reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ms = [ns.solve_time_step(_eager=mode == "eager")
              for _ in range(GRAPH_STEPS)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        w = while_counts(21, mode, ms, captured=mode == "captured")
        runs.append(dict(
            mode=mode, sync_check=sg.sync_check, steps_per_s=GRAPH_STEPS / wall,
            metrics=ms, u=ns._u.clone(), p=ns._p.clone(),
            launches=per_step_launches(GRAPH_STEPS),
            bj=bj_per_step(bj_snapshot()[0], GRAPH_STEPS),
            kry=kry_per_step(GRAPH_STEPS),
            plain_cuda=COUNTS.plain_cuda_calls + bj_snapshot()[1],
            flag_reads=w["flag_reads"], masked=w["masked_iterations"],
            whiles=w, set_condition=(conditional.COUNTS.set_condition
                                     / GRAPH_STEPS)))
        log(f"[21] {mode}{' (sync-checked replays)' if sg.sync_check else ''}"
            f": {runs[-1]['steps_per_s']:.4f} steps/s ({GRAPH_STEPS} steps "
            f"in {wall:.3f} s), "
            f"{while_line(w, runs[-1]['set_condition'])} (PR 10 captured: "
            f"host reads {PR10['proj_reads']}, masked iterations "
            f"{PR10['proj_masked']}), on {card}")
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
        check((r["launches"], r["bj"], r["kry"])
              == (ref["launches"], ref["bj"], ref["kry"]),
              f"[21] {r['mode']}: SELL, tile-apply and Krylov-kernel "
              f"launches per step equal the eager run's ({r['launches']}, "
              f"{r['bj']}, {r['kry']} against {ref['launches']}, "
              f"{ref['bj']}, {ref['kry']})")
        check_kry_projection(21, r["kry"], r["metrics"],
                             k=ns.config.schur_smooth_k)
        # the graph adds one set_condition per loop entered: the test
        # before each while node
        extra = r["whiles"]["loops_entered"] if r["mode"] == "captured" \
            else 0.0
        check(abs(r["set_condition"] - ref["set_condition"] - extra) < 1e-9,
              f"[21] {r['mode']}: set_condition launches per step "
              f"{r['set_condition']:.2f} = the eager run's "
              f"{ref['set_condition']:.2f} + loops entered {extra:.2f}")
    for r in runs:
        check_rebuild(21, r["mode"], r["kry"], r["metrics"])
    check(all(m.flag_reads == 1 for r in runs if r["mode"] == "captured"
              for m in r["metrics"]),
          "[21] the captured step reads the host once, for the tile guard")
    check(all(r["plain_cuda"] == 0 for r in runs),
          "[21] no plain-version calls on CUDA tensors")
    sps = {m: [r["steps_per_s"] for r in runs if r["mode"] == m]
           for m in ("eager", "captured")}
    log(f"[21] captured equals eager bit for bit in all four runs; SELL "
        f"launches per step (captured, from the replay records) "
        f"{runs[1]['launches']}; tile-apply launches per step "
        f"{runs[1]['bj']}; Krylov-kernel launches per step "
        f"{runs[1]['kry']}")
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
                                         "masked", "whiles", "set_condition",
                                         "launches", "bj", "kry")}
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

    def update(*args, cond=None):
        nonlocal calls
        state = [a.clone() for a in args]
        AL.lsq_update(*args, cond=cond)
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
    from navierstokes_tpu_torch.kernels import arnoldi_lsq, bj_apply
    from navierstokes_tpu_torch.kernels.sell_spmv import COUNTS
    launches = {}

    def step(ns, **kw):
        torch.cuda.synchronize()
        COUNTS.reset()
        arnoldi_lsq.COUNTS.reset()
        bj_apply.COUNTS.reset()
        m = ns.solve_time_step(**kw)
        torch.cuda.synchronize()
        bj, bj_plain = bj_snapshot()
        return m, (dict(COUNTS.by_variant), arnoldi_lsq.COUNTS.update, bj,
                   COUNTS.plain_cuda_calls + bj_plain), {
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
        bj = collections.Counter()
        for k in range(5):
            mg, cg, fields = step(gpu)
            me, ce, _ = step(eag, _eager=True)
            check(cg[3] == 0 and ce[3] == 0,
                  f"[7] {tag}: no plain-version calls on CUDA tensors")
            for f in counts:
                counts[f] += fields[f]
            bj.update(cg[2])
            same = (torch.equal(gpu._u, eag._u)
                    and torch.equal(gpu._p, eag._p)
                    and (mg.cd, mg.cl, mg.iterations, mg.residual)
                    == (me.cd, me.cl, me.iterations, me.residual))
            check(same, f"[7] {tag} step {k + 1}: captured equals eager "
                  "bit for bit")
            check(cg[:3] == ce[:3], f"[7] {tag} step {k + 1}: captured "
                  f"launches {cg[:3]} equal eager {ce[:3]}")
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
            f"{counts['launches_f64']}; tile apply by (tiles dtype, d) "
            f"{bj_per_step(bj, 1)}; captured equal to eager bit for bit "
            "at every step")
        check(worst["cd"] <= gate and worst["cl"] <= gate, f"{tag} Cd/Cl")
        check(worst["u"] <= gate, f"{tag} u")
        check(worst["its"] <= 1, f"{tag} iteration counts")
        check(counts[field] > 0, f"{tag}: {field} > 0 on its path")
        check(counts["launches"] > 0, f"{tag}: fp32 launches > 0")
        want = torch.bfloat16 if "inner_bf16" in tag else torch.float32
        check(set(bj) == {(want, 2)},
              f"[7] {tag}: the tile apply launched with {want} tiles only")
        counts["bj"] = dict(bj)
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
    from navierstokes_tpu_torch.kernels import (arnoldi_lsq, bj_apply,
                                                conditional)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reserved0 = torch.cuda.memory_reserved()
    sg = ns.capture_graphs()
    from tools.torch_step_profile import pool_bytes
    capture = dict(
        capture_s=sg.capture_seconds,
        capture_peak_bytes=torch.cuda.max_memory_allocated(),
        reserved_growth_bytes=torch.cuda.memory_reserved() - reserved0,
        graphs=len(sg.graphs), while_nodes=sg.nodes, pools=pool_bytes(ns))
    log(f"[8] captured the monolithic step: {len(sg.graphs)} graphs, "
        f"{sg.nodes} while nodes (each FGMRES cycle's, the inner BiCGStab's "
        f"nested in its body), in {sg.capture_seconds:.2f} s (with a warm-up "
        f"step; PR 10: {PR10['capture_s']} s with 88 if-node bodies per "
        f"block); peak {capture['capture_peak_bytes']} bytes, reserved "
        f"memory grew by {capture['reserved_growth_bytes']} bytes (PR 10: "
        f"{PR10['reserved_growth']}); bytes (allocated, reserved) by pool "
        f"{capture['pools']} on {card}")
    torch.cuda.reset_peak_memory_stats()
    COUNTS.reset()
    arnoldi_lsq.COUNTS.reset()
    conditional.COUNTS.reset()
    bj_apply.COUNTS.reset()
    kry_reset()
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
    kry = kry_per_step(n_warm + n_meas)
    bj, bj_plain = bj_snapshot()
    peak = torch.cuda.max_memory_allocated()
    sps = n_meas / wall
    whiles = while_counts(8, "monolithic", ms_all, captured=True)
    log(f"[8] Givens kernel launches over {n_warm + n_meas} steps: "
        f"{givens}; set_condition launches {nodes}")
    log(f"[8] Krylov loop kernels (csrc/krylov_update.cu stages, "
        f"csrc/gram_schmidt.cu steps) per step: {kry}")
    log(f"[8] captured steps: "
        f"{while_line(whiles, nodes / (n_warm + n_meas))} (PR 10: host "
        f"reads {PR10['mono_reads']}, set_condition "
        f"{PR10['mono_set_condition']} per step, BN) on {card}")
    log(f"[8] host reads per step: "
        + " ".join(str(m.flag_reads) for m in ms_all)
        + "; loops entered per step: "
        + " ".join(str(m.loops_entered) for m in ms_all)
        + "; bodies run per step: "
        + " ".join(str(m.bodies_run) for m in ms_all))
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
    check(abs(kry["gram_schmidt"] * (n_warm + n_meas)
              - sum(m.iterations for m in ms_all)) < 1e-6,
          "[8] the Gram-Schmidt kernels ran once per FGMRES iteration")
    check(all(kry[s] > 0 for s in ("bicgstab_p", "bicgstab_s",
                                   "bicgstab_xr")),
          "[8] the inner BiCGStab's stages launched")
    vc = vcycle_per_step(8, "monolithic cc", kry, cfg.schur_vcycles,
                         cfg.schur_smooth_k)
    log(f"[8] fused Ap V-cycles per FGMRES iteration: "
        f"{vc * (n_warm + n_meas) / sum(m.iterations for m in ms_all):.3f}")
    check(nodes > 0, "[8] the while nodes' kernel launched")
    if not sg.refine:
        # the guard, and one read per restart cycle's end (a cycle but the
        # last runs the whole restart length)
        m_r = cfg.outer_restart
        check(all(m.flag_reads == 1 + -(-m.iterations // m_r)
                  for m in ms_all),
              "[8] host reads per step: the guard and the cycles' ends")
    check(plain_cuda == 0, "[8] no plain-version calls on CUDA tensors")
    check_bj_path(8, bj, bj_plain, n_warm + n_meas, torch.float32, 2)
    branch = check_rebuild(8, "monolithic captured", kry, ms_all)
    log(f"[8] all {len(ms_all)} FGMRES solves converged (rel tol {tol:g})")
    end = {a: getattr(ns, a).clone() for a in ("_u", "_p", "_u_prev",
                                               "_phi", "_t")}
    end["time"] = ns.time
    return dict(launches=launches, steps_per_s=sps, peak_bytes=peak,
                setup_s=setup_s, per_step=per_step, givens=givens,
                set_condition=nodes, n_steps=n_warm + n_meas, ns=ns,
                kry_per_step=kry, branch=branch,
                end=end, capture=capture, whiles=whiles, bj=bj,
                bj_per_step=bj_per_step(bj, n_warm + n_meas))


# phase 22: bench-point monolithic steps of each run from phase 8's end
# state, the while-node check's trip counts and the timed loop's length
MONO_GRAPH_STEPS = 5
NODE_CHECK = 64
WHILE_TIMED = 256
COND_SOURCE = "navierstokes_tpu_torch/csrc/graph_cond.cu"
# JAX's loop predicate: the cond of FGMRES's lax.while_loop
COND_REPLACES = "navierstokes_tpu/solvers/krylov.py:132"


def phase_monolithic_graphs(mono, card):
    """Phase 22: from phase 8's end state, captured / eager / captured /
    eager runs of MONO_GRAPH_STEPS bench-point monolithic steps, bit for
    bit with the same SELL, Givens launches per step, the first captured
    run under set_sync_debug_mode("error"); then the conditional nodes'
    kernel against its plain version (a host read of the flag)."""
    from navierstokes_tpu_torch.kernels import (arnoldi_lsq, bj_apply,
                                                conditional)
    from navierstokes_tpu_torch.kernels.sell_spmv import COUNTS
    from tools.torch_step_profile import pool_bytes
    t_phase = time.perf_counter()
    ns, n = mono["ns"], MONO_GRAPH_STEPS
    sg = ns.capture_graphs()
    torch.cuda.synchronize()
    runs = []
    for mode in ("captured", "eager", "captured", "eager"):
        _load_state(ns, mono["end"])
        sg.sync_check = mode == "captured" and not runs
        COUNTS.reset()
        arnoldi_lsq.COUNTS.reset()
        conditional.COUNTS.reset()
        bj_apply.COUNTS.reset()
        kry_reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ms = [ns.solve_time_step(_eager=mode == "eager") for _ in range(n)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        w = while_counts(22, mode, ms, captured=mode == "captured")
        runs.append(dict(whiles=w,
            mode=mode, sync_check=sg.sync_check, steps_per_s=n / wall,
            metrics=ms, u=ns._u.clone(), p=ns._p.clone(),
            launches=per_step_launches(n),
            givens=arnoldi_lsq.COUNTS.update / n,
            set_condition=conditional.COUNTS.set_condition / n,
            bj=bj_per_step(bj_snapshot()[0], n), kry=kry_per_step(n),
            plain_cuda=COUNTS.plain_cuda_calls + bj_snapshot()[1],
            flag_reads=sum(m.flag_reads for m in ms) / n,
            masked=sum(m.masked_iterations for m in ms) / n,
            peak=torch.cuda.max_memory_allocated(), pools=pool_bytes(ns)))
        r = runs[-1]
        checked = " (sync-checked replays)" if r["sync_check"] else ""
        log(f"[22] {mode}{checked}"
            f": {r['steps_per_s']:.4f} steps/s ({n} steps in {wall:.3f} s), "
            f"{while_line(w, r['set_condition'])}, Givens launches per step "
            f"{r['givens']:.2f} (PR 10 captured: host reads "
            f"{PR10['mono_reads']}, set_condition "
            f"{PR10['mono_set_condition']}), on {card}")
        log(f"[22] {mode}: peak {r['peak']} bytes; bytes (allocated, "
            f"reserved) by pool after the run {r['pools']}")
    sg.sync_check = False
    peak = max(r["peak"] for r in runs)
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
        check((r["launches"], r["givens"], r["bj"], r["kry"])
              == (ref["launches"], ref["givens"], ref["bj"], ref["kry"]),
              f"[22] {r['mode']}: SELL, Givens, tile-apply and Krylov-kernel "
              f"launches per step ({r['launches']}, {r['givens']}, "
              f"{r['bj']}, {r['kry']}) equal the captured run's "
              f"({ref['launches']}, {ref['givens']}, {ref['bj']}, "
              f"{ref['kry']})")
    check(all(r["plain_cuda"] == 0 for r in runs),
          "[22] no plain-version calls on CUDA tensors")
    check(all(m.flag_reads < e.flag_reads for m, e in
              zip(ref["metrics"], runs[1]["metrics"])),
          "[22] the captured step reads the host less often")
    for r in runs:
        extra = r["whiles"]["loops_entered"] if r["mode"] == "captured" \
            else 0.0
        check(abs(r["set_condition"] - runs[1]["set_condition"] - extra)
              < 1e-9,
              f"[22] {r['mode']}: set_condition launches per step "
              f"{r['set_condition']:.2f} = the eager run's "
              f"{runs[1]['set_condition']:.2f} + loops entered {extra:.2f}")
    check(ref["givens"] * n == sum(m.iterations for m in ref["metrics"]),
          "[22] one Givens launch per FGMRES iteration")
    check(ref["kry"]["gram_schmidt"] == ref["givens"],
          "[22] one Gram-Schmidt step per FGMRES iteration")
    cfg22 = mono["ns"].config
    for r in runs:
        vcycle_per_step(22, r["mode"], r["kry"], cfg22.schur_vcycles,
                        cfg22.schur_smooth_k)
        check_rebuild(22, r["mode"], r["kry"], r["metrics"])
    sps = {m: [r["steps_per_s"] for r in runs if r["mode"] == m]
           for m in ("captured", "eager")}
    cap = mono["capture"]
    log(f"[22] captured equals eager bit for bit in all four runs, with the "
        f"same launches per step (SELL {ref['launches']}, Givens "
        f"{ref['givens']:.2f}, tile apply {ref['bj']}, Krylov kernels "
        f"{ref['kry']}); capture "
        f"{cap['capture_s']:.2f} s (phase 8; PR 10: {PR10['capture_s']} s), "
        f"{cap['while_nodes']} while nodes; peak device memory over the "
        f"four runs {peak} bytes ({peak / 2**30:.2f} GiB; PR 10: "
        f"{PR10['peak_22']}); steps/s captured {sps['captured']}, eager "
        f"{sps['eager']} on {card}")
    nodes = phase_while_nodes()
    log(f"[22] phase {time.perf_counter() - t_phase:.1f} s")
    return dict(runs=[{k: r[k] for k in ("mode", "sync_check", "steps_per_s",
                                         "flag_reads", "masked", "whiles",
                                         "launches", "givens",
                                         "set_condition", "bj", "kry",
                                         "peak", "pools")}
                      for r in runs],
                peak_bytes=peak, nodes=nodes,
                branch="".join("E" if m.exact_inverse else "N"
                               for m in ref["metrics"]))


def _while_graph(whiles, fn):
    """A graph of ``fn()`` captured with the port's while nodes."""
    from navierstokes_tpu_torch.kernels.launches import record_launches
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with record_launches(), torch.cuda.graph(graph, stream=stream), \
            whiles.routed():
        fn()
    torch.cuda.synchronize()
    return graph


def _replay_ms(run, per, reps=10):
    """Median device time of ``run()`` over ``reps`` calls, each between
    two CUDA events after a spin, divided by ``per``."""
    times = []
    for _ in range(reps):
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per)
    return statistics.median(times)


def phase_while_nodes():
    """Phase 22's kernel part: csrc/graph_cond.cu's while node against its
    plain version, the host loop that reads the flag before each
    iteration, for NODE_CHECK seeded trip counts from 0 to 64 (a body
    x += r, r -= 1, k += 1 ending in the predicate kernel), bit for bit
    with the node's device tally n + 1 evaluations, n bodies, none masked;
    the predicate kernel against its plain version (torch operations) on
    256 seeded fp32 scalar sets, ties and breakdown flags among them;
    then device times: per while iteration of WHILE_TIMED iterations with
    a body of one add and a count ending in the predicate kernel, and the
    same launches in a plain graph without a node; per iteration of an
    FGMRES-like body ending in the Givens kernel (m=64), which sets the
    node's condition itself; the predicate kernel alone in bursts, its
    plain version's launches, and the host read."""
    from navierstokes_tpu_torch.kernels import arnoldi_lsq as AL
    from navierstokes_tpu_torch.kernels.conditional import (
        WhileNodes, set_condition, set_condition_plain)
    whiles = WhileNodes("cuda")
    f32 = dict(dtype=torch.float32, device="cuda")
    i64 = dict(dtype=torch.int64, device="cuda")
    half = torch.tensor(0.5, **f32)
    r, x = torch.zeros((), **f32), torch.zeros((), **f32)
    k = torch.zeros((), **i64)
    active = torch.zeros((), dtype=torch.bool, device="cuda")
    tally = torch.zeros(3, **i64)

    def body(cond):
        x.add_(r)
        r.sub_(1.0)
        k.add_(1)
        return set_condition(active, r, half, k, 1000, cond=cond)

    def start(n):
        r.fill_(float(n))
        x.zero_()
        k.zero_()
        tally.zero_()
        set_condition(active, r, half, k, 1000)

    graph = _while_graph(whiles, lambda: whiles.loop(active, body, tally))
    gen = torch.Generator().manual_seed(22)
    trips = [0, 64] + torch.randint(0, 65, (NODE_CHECK - 2,),
                                    generator=gen).tolist()
    err = 0
    for n in trips:
        start(n)
        torch.cuda.set_sync_debug_mode("error")
        try:
            graph.replay()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        got = (int(k), float(x), tally.tolist())
        start(n)
        while bool(active):
            body(None)
        want = (int(k), float(x), [n + 1, n, 0])
        err = max(err, abs(got[0] - want[0]), abs(got[1] - want[1]),
                  max(abs(a - b) for a, b in zip(got[2], want[2])))
    check(err == 0, "[22] the while node against the host loop at "
          f"{len(trips)} seeded trip counts 0..64 (max |error| {err})")
    del graph

    # the predicate kernel against its plain version
    rng = np.random.default_rng(22)
    n_sets, maxiter = 256, 3
    res = rng.standard_normal(n_sets).astype(np.float32)
    tgt = np.where(rng.random(n_sets) < 0.25, res,
                   rng.standard_normal(n_sets).astype(np.float32))
    ks = rng.integers(0, maxiter + 2, n_sets)
    stags = rng.random(n_sets) < 0.25
    differ = 0
    for i in range(n_sets):
        flags = []
        for dev in ("cpu", "cuda"):
            a = torch.tensor(not stags[i], device=dev)
            set_condition(a, torch.tensor(res[i], device=dev),
                          torch.tensor(tgt[i], device=dev),
                          torch.tensor(int(ks[i]), device=dev), maxiter,
                          torch.tensor(bool(stags[i]), device=dev))
            flags.append(bool(a))
        differ += flags[0] != flags[1]
    check(differ == 0, f"[22] the predicate kernel against its plain "
          f"version on {n_sets} seeded scalar sets")

    # device time per while iteration, a body of one add and a count
    z = torch.zeros(1024, **f32)
    c = torch.zeros((), **i64)
    up = torch.ones((), dtype=torch.bool, device="cuda")
    big, zero = torch.tensor(1e30, **f32), torch.tensor(0.0, **f32)
    t_loop = torch.zeros(3, **i64)

    def add_pred(cond):
        z.add_(1.0)
        c.add_(1)
        return set_condition(up, big, zero, c, WHILE_TIMED, cond=cond)

    g = _while_graph(whiles, lambda: whiles.loop(up, add_pred, t_loop))

    def run():
        c.zero_()
        up.fill_(True)
        g.replay()
    pred_ms = _replay_ms(run, WHILE_TIMED)
    check(int(c) == WHILE_TIMED, "[22] a timed while loop ran its "
          f"{WHILE_TIMED} iterations")
    del g
    plain_graph = _while_graph(whiles, lambda: [
        add_pred(None) for _ in range(WHILE_TIMED)])
    plain_graph_ms = _replay_ms(plain_graph.replay, WHILE_TIMED)
    del plain_graph

    # an FGMRES-like body: the Givens kernel setting the node's condition
    m, n_cols = 64, 40
    gen = torch.Generator().manual_seed(21)
    H = torch.zeros((m + 1, m), **f32)
    cs, sn = torch.zeros(m, **f32), torch.zeros(m, **f32)
    gv = torch.zeros(m + 1, **f32)
    h1 = torch.randn(m + 1, generator=gen).cuda()
    h2 = 1e-3 * torch.randn(m + 1, generator=gen).cuda()
    wn = torch.tensor(10.0 * float(h1.abs().max()) + 1.0, **f32)
    j = torch.zeros((), dtype=torch.int32, device="cuda")
    res_g = torch.tensor(3.0, **f32)
    ga = torch.ones((), dtype=torch.bool, device="cuda")
    j_max = torch.tensor(n_cols, dtype=torch.int32, device="cuda")
    work = (H, cs, sn, gv, j, res_g, ga)
    init = [t.clone() for t in work]
    init[3][0] = 3.0

    def givens(cond):
        return AL.lsq_update(H, cs, sn, gv, h1, h2, wn, j, res_g, ga, zero,
                             j_max, cond=cond)
    g = _while_graph(whiles, lambda: whiles.loop(ga, givens, t_loop))

    def run_givens():
        _restore(work, init)
        g.replay()
    lsq_handle_ms = _replay_ms(run_givens, n_cols)
    check(int(j) == n_cols, f"[22] the Givens while loop ran {n_cols} "
          "iterations")
    del g

    # the predicate kernel alone, its plain version, the host read
    res1, tgt1 = torch.tensor(1.0, **f32), torch.tensor(0.5, **f32)
    kernel_ms = _burst_ms([lambda: set_condition(up, res1, tgt1, c, 1000)])
    plain_ms = _burst_ms([lambda: set_condition_plain(up, res1, tgt1, c,
                                                      1000)])
    t0 = time.perf_counter()
    for _ in range(200):
        bool(up)
    read_ms = (time.perf_counter() - t0) / 200 * 1e3
    whiles.close()
    log(f"[22] while nodes: {len(trips)} seeded trip counts 0..64 against "
        f"the host loop, max |error| {err}; the predicate kernel against "
        f"its plain version on {n_sets} scalar sets, {differ} differ")
    log(f"[22] per while iteration (a body of one add and a count, "
        f"{WHILE_TIMED} iterations, device time, ending in the predicate "
        f"kernel) {pred_ms:.5f} ms; the same launches in a plain graph "
        f"without a node {plain_graph_ms:.5f} ms (PR 10's if node: 0.00533 "
        f"ms skipped, 0.00931 ms run with a one-add body); an FGMRES-like "
        f"body (ending in the Givens kernel, m={m}, {n_cols} iterations) "
        f"{lsq_handle_ms:.5f} ms per iteration")
    log(f"[22] the predicate kernel alone {kernel_ms:.5f} ms per launch in "
        f"bursts, its plain version (torch operations) {plain_ms:.5f} ms, "
        f"the host read of the flag {read_ms:.5f} ms (host clock)")
    # set_condition reads ||r||, the target (fp32), the breakdown flag, k
    # (int64) and the flag, and writes the flag: 18 bytes, 3 comparisons
    bound = max(18 / HBM_BYTES_PER_S, 3 / FP32_OPS_PER_S) * 1e3
    return dict(max_abs_err=err + differ, ms=kernel_ms, plain_ms=plain_ms,
                host_read_ms=read_ms, bound_ms=bound,
                while_iteration_ms=pred_ms, plain_graph_ms=plain_graph_ms,
                givens_sets_condition_ms=lsq_handle_ms)


# phase 24: the block-Jacobi tile apply (csrc/bj_apply.cu) at the real tiles
BJ_SOURCE = "navierstokes_tpu_torch/csrc/bj_apply.cu"
# the Pallas kernels it replaces: bj_kern (fp32 tiles), bj_kern16 (bf16)
BJ_REPLACES = "scripts/exp_fused.py:237"
BJ_REPLACES_BF16 = "scripts/exp_fused.py:265"
FP64_OPS_PER_S = 34e12        # published H100 SXM fp64 rate, no tensor core
# tiles dtype -> (record name, kernel-vs-plain limit over max|y|; None:
# one bf16 ulp of max|y|, since both round a fp32 sum to bf16 in their own
# order)
BJ_VARIANTS = {torch.float32: ("bj_apply", 1e-5),
               torch.bfloat16: ("bj_apply_bf16", None),
               torch.float64: ("bj_apply_f64", 1e-12)}


def bj_snapshot():
    """The tile-apply kernel's launches by (tiles dtype, d) and its
    plain-version calls on CUDA tensors since its counts were last reset."""
    from navierstokes_tpu_torch.kernels import bj_apply
    return (dict(bj_apply.COUNTS.by_variant),
            bj_apply.COUNTS.plain_cuda_calls)


def bj_per_step(by_variant, n_steps):
    return {f"{str(dt).replace('torch.', '')} d={d}": v / n_steps
            for (dt, d), v in sorted(by_variant.items(), key=str)}


def check_bj_path(phase, by_variant, plain, n_steps, dtype, d):
    """The path's tile applies went through the kernel, in ``dtype`` tiles
    with ``d`` components only, never through the plain version."""
    log(f"[{phase}] tile-apply kernel launches per step "
        f"{bj_per_step(by_variant, n_steps)}; plain-version CUDA calls "
        f"{plain}")
    check(set(by_variant) == {(dtype, d)} and by_variant[(dtype, d)] > 0,
          f"[{phase}] the tile apply launched, {dtype} tiles, d={d}")
    check(plain == 0, f"[{phase}] no plain tile apply on CUDA tensors")


def _bf16_ulp(y):
    return 2.0 ** (np.floor(np.log2(float(y.abs().max()))) - 7)


def check_and_time_bj(use, tiles, r):
    """The tile-apply kernel against its plain version at one use's tiles
    and a seeded r: the stated limit, a bit-identical repeat, the tail
    tile alone equal to the batch's rows; then its ms per call in bursts
    (the tiles exceed the L2, so each call reads them from HBM) beside the
    plain version, the bound and the library's batched GEMM
    (``torch.matmul`` on r padded to whole tiles, today's yardstick, which
    the port no longer calls)."""
    from navierstokes_tpu_torch.kernels.bj_apply import (
        bj_apply, block_jacobi_apply_plain, launch_config)
    name, limit = BJ_VARIANTS[tiles.dtype]
    yk = bj_apply(tiles, r)
    yk2 = bj_apply(tiles, r)
    yp = block_jacobi_apply_plain(tiles, r)
    n_tiles, sb = tiles.shape[0], tiles.shape[1]
    t = n_tiles - 1
    alone = bj_apply(tiles[t:], r[t * sb:])
    torch.cuda.synchronize()
    check(yk.shape == yp.shape == r.shape and yk.dtype == r.dtype,
          f"[24] {use} {name}: shape/dtype")
    check(torch.equal(yk, yk2), f"[24] {use} {name}: bit-identical repeat")
    check(torch.equal(alone, yk[t * sb:]),
          f"[24] {use} {name}: the tail tile alone equals the batch's rows")
    abs_err = float((yk - yp).abs().max())
    differ = int((yk != yp).sum())
    lim = (_bf16_ulp(yp) if limit is None
           else limit * float(yp.abs().max()))
    check(abs_err <= lim, f"[24] {use} {name}: kernel vs plain max abs err "
          f"{abs_err:.3e} (limit {lim:.3e})")
    n_p2, d = r.shape
    nbytes = (n_p2 * sb * tiles.element_size()
              + 2 * n_p2 * d * r.element_size())
    ops = 2 * n_p2 * sb * d
    rate = FP64_OPS_PER_S if tiles.dtype == torch.float64 else FP32_OPS_PER_S
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
    rb = torch.nn.functional.pad(r, (0, 0, 0, n_tiles * sb - n_p2)).reshape(
        n_tiles, sb, d).to(tiles.dtype)
    out = dict(use=use, tiles=list(tiles.shape), d=d, max_abs_err=abs_err,
               limit=lim, differing=differ,
               ms=_burst_ms([lambda: bj_apply(tiles, r)]),
               plain_ms=_burst_ms(
                   [lambda: block_jacobi_apply_plain(tiles, r)]),
               library_ms=_burst_ms([lambda: torch.matmul(tiles, rb)]),
               bound_bytes=nbytes, bound_ops=ops,
               bound_ms=max(by_bytes, by_ops),
               bound_by="bytes" if by_bytes >= by_ops else "operations")
    del rb
    out["launch"] = launch_config(tiles, r)
    log(f"[24] {use} {name}: tiles {tuple(tiles.shape)}, r ({n_p2}, {d}); "
        f"{launch_line(out['launch'])}; "
        f"max abs err {abs_err:.3e} (limit {lim:.3e}), {differ} of "
        f"{yk.numel()} values differ; ms {out['ms']:.4f} "
        f"({nbytes / out['ms'] / 1e6:.0f} GB/s) plain {out['plain_ms']:.4f} "
        f"library {out['library_ms']:.4f}; bound {out['bound_ms']:.4f} "
        f"({out['bound_by']}: {nbytes} B, {ops} flop) on {card_line()}")
    return out


def launch_line(c):
    if c["design"] != "ring":
        return (f"{c['design']}: grid {c['grid']}, one CTA per "
                f"{c['rows_per_cta']} rows")
    return (f"ring: grid {c['grid']} ({c['ctas_per_sm']} per SM x {c['sms']} "
            f"SMs) over {c['n_items']} items of {c['rows_per_item']} rows, "
            f"{c['stages']} stages of {c['stage_bytes']} B, {c['r_slots']} "
            f"r slots, {c['smem_bytes']} B of shared memory per CTA")


# the edges of the tile apply's ring and persistent grid: case -> (SB, d,
# n_tiles, live rows of the tail tile); None: sized from the grid
BJ_EDGES = {"one tile (fewer items than CTAs)": (256, 2, 1, 256),
            "items not a multiple of the grid": None,
            "one-row tail tile": (256, 2, 5, 1),
            "SB 128": (128, 2, 5, 77),
            "SB 512": (512, 2, 5, 77),
            "d=3": (256, 3, 7, 200)}


def _edge_inputs(dtype, sb, d, n_tiles, tail, seed):
    from navierstokes_tpu_torch.kernels.bj_apply import VARIANTS
    rng = np.random.default_rng(seed)
    tiles = np.eye(sb)[None] + 0.05 * rng.standard_normal((n_tiles, sb, sb))
    r = rng.standard_normal(((n_tiles - 1) * sb + tail, d))
    return (torch.as_tensor(tiles, dtype=torch.float32).to(
                device="cuda", dtype=dtype),
            torch.as_tensor(r, dtype=VARIANTS[dtype][1], device="cuda"))


def phase_tile_apply_edges():
    """Phase 24: the kernel at the edges of its ring and persistent grid
    (BJ_EDGES, and a slice ``tiles[t:]``), every tile type: against its
    plain version under BJ_VARIANTS' limit, a repeat bit for bit, and the
    first, a middle and the last tile alone equal to the batch's rows."""
    from navierstokes_tpu_torch.kernels.bj_apply import (
        bj_apply, block_jacobi_apply_plain, launch_config, ring)
    out = {}
    # the grid's edges are the fp64 ring's; the register stream of fp32
    # and bf16 tiles runs the same shapes
    g = ring(0, 256, 2)
    resident = g["ctas_per_sm"] * g["sms"]
    n_tiles = resident * g["rows_per_item"] // 256 + 2
    tail = 77
    while -(-((n_tiles - 1) * 256 + tail) // g["rows_per_item"]) \
            % resident == 0:
        tail += g["rows_per_item"]
    cases = {**BJ_EDGES, "items not a multiple of the grid":
             (256, 2, n_tiles, tail)}
    for dtype, (name, limit) in BJ_VARIANTS.items():
        out[name] = []
        for k, (case, (sb, d, nt, tl)) in enumerate(cases.items()):
            tiles, r = _edge_inputs(dtype, sb, d, nt, tl, 2400 + k)
            c = launch_config(tiles, r)
            ring_case = dtype == torch.float64
            if case.startswith("one tile") and ring_case:
                check(c["grid"] == c["n_items"] < resident,
                      f"[24] {name} {case}: fewer items than CTAs")
            if case.startswith("items not") and ring_case:
                check(c["n_items"] > c["grid"] and c["n_long"] > 0,
                      f"[24] {name} {case}: the grid does not divide them")
            y = bj_apply(tiles, r)
            y2 = bj_apply(tiles, r)
            yp = block_jacobi_apply_plain(tiles, r)
            torch.cuda.synchronize()
            err = float((y - yp).abs().max())
            lim = (_bf16_ulp(yp) if limit is None
                   else limit * float(yp.abs().max()))
            check(err <= lim, f"[24] {name} {case}: kernel vs plain max abs "
                  f"err {err:.3e} (limit {lim:.3e})")
            check(torch.equal(y, y2), f"[24] {name} {case}: bit-identical "
                  "repeat")
            for t in sorted({0, nt // 2, nt - 1}):
                rows = slice(t * sb, min((t + 1) * sb, r.shape[0]))
                check(torch.equal(bj_apply(tiles[t:t + 1], r[rows]),
                                  y[rows]),
                      f"[24] {name} {case}: tile {t} alone equals the "
                      "batch's rows")
            if case == "one-row tail tile":
                # the slice tiles[t:] of the batch, each t
                for t in range(1, nt):
                    check(torch.equal(bj_apply(tiles[t:], r[t * sb:]),
                                      y[t * sb:]),
                          f"[24] {name} tiles[{t}:] equals the batch's rows")
            log(f"[24] edge {name} {case}: tiles {tuple(tiles.shape)}, r "
                f"{tuple(r.shape)}; {launch_line(c)}; max abs err "
                f"{err:.3e} (limit {lim:.3e}), repeat and tiles alone bit "
                "for bit" + (", tiles[t:] slices bit for bit"
                              if case == "one-row tail tile" else ""))
            out[name].append(dict(case=case, tiles=list(tiles.shape),
                                  d=d, max_abs_err=err, limit=lim,
                                  launch=c))
        # every stage reused, the tiles (about 40 MB) read into the L2 right
        # before each launch, so each bulk copy lands within a few hundred
        # cycles: a stage given back before the warp's reads of it landed
        # would be overwritten under them
        nt = (40 << 20) // (256 * 256 * torch.finfo(dtype).bits // 8)
        tiles, r = _edge_inputs(dtype, 256, 2, nt, 130, 2499)
        c = launch_config(tiles, r)
        check(dtype != torch.float64 or c["n_items"] > c["stages"] * c["grid"],
              f"[24] {name} L2 case: stages reused")
        ys = []
        for _ in range(12):
            tiles.sum()
            ys.append(bj_apply(tiles, r))
        yp = block_jacobi_apply_plain(tiles, r)
        torch.cuda.synchronize()
        err = float((ys[0] - yp).abs().max())
        lim = (_bf16_ulp(yp) if limit is None
               else limit * float(yp.abs().max()))
        check(err <= lim and all(torch.equal(y, ys[0]) for y in ys),
              f"[24] {name} L2 case: 12 launches bit for bit, max abs err "
              f"{err:.3e} (limit {lim:.3e})")
        log(f"[24] edge {name} stages reused with the tiles in L2: tiles "
            f"{tuple(tiles.shape)}; {launch_line(c)}; 12 launches bit for "
            f"bit, max abs err {err:.3e} (limit {lim:.3e})")
        out[name].append(dict(case="stages reused, tiles in L2",
                              tiles=list(tiles.shape), d=2,
                              max_abs_err=err, limit=lim, launch=c))
    return out


BJ_F64_ROUNDS = 8


def retime_f64(use, tiles, r):
    """Phase 24: the fp64 tile apply against ``torch.matmul`` in
    BJ_F64_ROUNDS rounds of alternating bursts (kernel, library, then
    library, kernel; five bursts per entry, no read between), twice:
    the library over its own copy of the tiles, the medians set as the
    use's ``ms`` and ``library_ms`` (the single figures kept as
    ``ms_single``, ``library_ms_single``) and the kernel's no slower; then
    the library over the kernel's own tiles, printed.  On the main path no
    other kernel reads the tile array; a ``torch.matmul`` over it leaves its
    last 50 MB in the L2 at normal priority, after which the ring's
    evict-first copies run at the unhinted ring's speed
    (``tools/bj_apply_ab.py``'s L2 states, PERF.md section 6)."""
    from navierstokes_tpu_torch.kernels.bj_apply import bj_apply
    n_tiles, sb = tiles.shape[0], tiles.shape[1]
    n_p2, d = r.shape
    rb = torch.nn.functional.pad(r, (0, 0, 0, n_tiles * sb - n_p2)).reshape(
        n_tiles, sb, d)
    copy = tiles.clone()
    out = {}
    for lib_tiles, what in ((copy, "its own copy of the tiles"),
                            (tiles, "the kernel's tiles")):
        fns = {"kernel": lambda: bj_apply(tiles, r),
               "library": lambda t=lib_tiles: torch.matmul(t, rb)}
        times = {"kernel": [], "library": []}
        for i in range(BJ_F64_ROUNDS):
            for name in (("kernel", "library") if i % 2 == 0
                         else ("library", "kernel")):
                times[name].append(_burst_ms([fns[name]], reps=5))
        med = {k: statistics.median(v) for k, v in times.items()}
        verdict = ("slower than" if med["kernel"] > med["library"]
                   else "not slower than")
        log(f"[24] fp64 tile apply against torch.matmul over {what}, "
            f"{BJ_F64_ROUNDS} rounds of alternating bursts: medians "
            f"{med['kernel']:.4f} ms against {med['library']:.4f} ms (the "
            f"kernel {verdict} the library); rounds kernel "
            + " ".join(f"{t:.4f}" for t in times["kernel"]) + ", library "
            + " ".join(f"{t:.4f}" for t in times["library"])
            + f"; bound {use['bound_ms']:.4f} ms on {card_line()}")
        out[what] = (med, times)
    del rb, copy
    (med, times), (med_same, times_same) = out.values()
    use.update(ms_single=use["ms"], library_ms_single=use["library_ms"],
               ms=med["kernel"], library_ms=med["library"],
               ms_rounds=times["kernel"], library_ms_rounds=times["library"],
               same_tiles_ms=med_same["kernel"],
               same_tiles_library_ms=med_same["library"])
    check(med["kernel"] <= med["library"], "[24] the fp64 tile apply no "
          f"slower than torch.matmul over its own copy of the tiles: "
          f"{med['kernel']:.4f} ms against {med['library']:.4f}")


def _r(n_p2, d, dtype, seed):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal((n_p2, d)), dtype=dtype,
                           device="cuda")


def phase_tile_apply_bench(proj_tiles, mono, paths, card):
    """Phase 24 at the bench point (right after phase 22): the kernel
    against its plain version at the fp32 tiles of the captured projection
    step (its graphs' last replay, in phase 21: ``proj_tiles``, kept on
    the host through phases 7, 8 and 22) and monolithic step (phase
    22's), and at the same tiles in bf16
    (``bj_bf16`` / ``inner_bf16``) and fp64, timed (``check_and_time_bj``); the launches per step of each
    path (``paths``: path -> the tile apply's launches per step by
    variant); then the fp64 variant on its path, 2 captured float64 steps
    of the phase 4 small fixture against the CPU within 1e-9."""
    from navierstokes_tpu_torch.kernels import bj_apply
    t_phase = time.perf_counter()
    ns = mono["ns"]
    check(ns._graphs is not None and ns._graphs.tiles is not None,
          "[24] the monolithic graphs' tiles")
    mono_tiles = ns._graphs.tiles
    n_p2 = ns.space.n_p2
    r32 = _r(n_p2, 2, torch.float32, 24)
    out = {dt: [] for dt in BJ_VARIANTS}
    out["edges"] = phase_tile_apply_edges()
    for use, tiles in (("bench projection", proj_tiles.cuda()),
                       ("bench monolithic", mono_tiles)):
        out[torch.float32].append(check_and_time_bj(use, tiles, r32))
        out[torch.bfloat16].append(check_and_time_bj(
            use, tiles.to(torch.bfloat16), r32))
    out[torch.float64].append(check_and_time_bj(
        "bench monolithic", mono_tiles.double(), r32.double()))
    retime_f64(out[torch.float64][-1], mono_tiles.double(), r32.double())
    for path, per_step in paths.items():
        log(f"[24] tile-apply launches per step, {path}: {per_step}")
    # the fp64 variant on its path: a float64 model on the card
    runs = {}
    for dev in ("cuda", "cpu"):
        m = small_model(dev, os.path.join(WORK, f"bj_f64_{dev}"), "float64",
                        proj_tol=1e-10)
        bj_apply.COUNTS.reset()
        ms = [m.solve_time_step() for _ in range(2)]
        runs[dev] = (m, ms, bj_snapshot())
    (g, mg, (bj, plain)), (c, mc, _) = runs["cuda"], runs["cpu"]
    gap = _rel(g._u, c._u)
    log(f"[24] float64 small fixture, 2 captured steps on the card against "
        f"the CPU: u rel {gap:.2e} (limit 1e-9), Cd {mg[-1].cd!r} "
        f"({mc[-1].cd!r})")
    check_bj_path(24, bj, plain, 2, torch.float64, 2)
    check(gap <= 1e-9 and all(m.converged for m in mg),
          "[24] float64 card steps equal the CPU's within 1e-9")
    out["f64_launches"] = bj[(torch.float64, 2)]
    log(f"[24] bench part {time.perf_counter() - t_phase:.1f} s on {card}")
    return out


# phase 25: the solver options the port took last, at the bench point from
# phase 5's (projection) and phase 8's (monolithic) end states, and the
# six options on the phase 4 small fixture
OPTION_STEPS = 5
OPTIONS_BENCH = (
    ("schur", dict(proj_poisson="schur")),
    ("p_extrap=0.5", dict(proj_p_extrap=0.5)),
    ("richardson", dict(scheme="monolithic", preconditioner="cc",
                        f_solver="richardson")))
OPTIONS_SMALL = (
    ("schur", dict(proj_poisson="schur")),
    ("p_extrap=0.5", dict(proj_p_extrap=0.5)),
    ("richardson", dict(scheme="monolithic", f_solver="richardson")),
    ("mass_format=node", dict(mass_format="node")),
    ("bj_tiles=rows", dict(bj_tiles="rows")),
    ("bj_tiles=scatter", dict(bj_tiles="scatter")))
# the ell case in float64 with the inner solves at 1e-10, as phase 18
OPTION_ELL = dict(scheme="monolithic", operator="ell",
                  preconditioner="asimple", inner_tol=1e-10,
                  inner_maxiter_f=1000, inner_maxiter_s=1000)


def _divergence(ns):
    """B u of the model's state, (n_p1,) on its device."""
    zero = torch.zeros(ns.space.n_p1, dtype=ns.dtype, device=ns.device)
    _, d = ns._ops.apply_blocks(ns.ell, ns.a0_cell, ns._u, zero,
                                with_f=False, with_g=False)
    return d


def laplacian_divergence(ns, bench):
    """Phase 25's yardstick, while the phase 5 model lives: B u after one
    Laplacian projection step from phase 5's end state; the end state
    back after it."""
    _load_state(ns, bench["end"])
    ns.solve_time_step()
    d = _divergence(ns).clone()
    _load_state(ns, bench["end"])
    return d


def _option_run(ns, end, mode, sync_check=False):
    """OPTION_STEPS steps from ``end``, captured or eager, with the SELL and
    tile-apply launches per step and the while loops' counts per step."""
    from navierstokes_tpu_torch.kernels import bj_apply, conditional
    from navierstokes_tpu_torch.kernels.sell_spmv import COUNTS
    _load_state(ns, end)
    ns._graphs.sync_check = sync_check
    COUNTS.reset()
    bj_apply.COUNTS.reset()
    conditional.COUNTS.reset()
    kry_reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ms = [ns.solve_time_step(_eager=mode == "eager")
          for _ in range(OPTION_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ns._graphs.sync_check = False
    bj, bj_plain = bj_snapshot()
    return dict(mode=mode, sync_check=sync_check, metrics=ms,
                whiles=while_counts(25, f"{ns.config.scheme} {mode}", ms,
                                    captured=mode == "captured"),
                set_condition=conditional.COUNTS.set_condition / OPTION_STEPS,
                steps_per_s=OPTION_STEPS / wall, launches=COUNTS.launches,
                per_step=per_step_launches(OPTION_STEPS),
                bj=bj, bj_per_step=bj_per_step(bj, OPTION_STEPS),
                kry=kry_per_step(OPTION_STEPS),
                plain_cuda=COUNTS.plain_cuda_calls + bj_plain,
                state=[ns._u.clone(), ns._p.clone(), ns._phi.clone()])


def _metrics_key(m):
    return (m.cd, m.cl, m.iterations, m.f_iterations, m.p_iterations,
            m.residual, m.converged)


def phase_options_bench(bench, mono, lap_div, card):
    """Phase 25 (a)-(c): each option's bench model set up, then from phase
    5's end state (schur, p_extrap; its phi the Laplacian step's
    increment) or phase 8's (richardson) OPTION_STEPS steps captured
    (replays sync-checked), eager and captured again, every run equal bit
    for bit (u, p, phi, Cd, Cl, counts, residuals) with the same SELL and
    tile-apply launches per step, every step finite; schur's B u at its
    unpinned nodes after one step below the Laplacian step's
    (``lap_div``)."""
    out = {}
    for tag, fields in OPTIONS_BENCH:
        t0 = time.perf_counter()
        ns = bench_model("cuda", **fields).setup()
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        mono_path = ns.config.scheme == "monolithic"
        end = mono["end"] if mono_path else bench["end"]
        _load_state(ns, end)
        sg = ns.capture_graphs()
        runs = [_option_run(ns, end, "captured", sync_check=True),
                _option_run(ns, end, "eager"),
                _option_run(ns, end, "captured")]
        ref = runs[0]
        for r in runs[1:]:
            same = (all(torch.equal(a, b)
                        for a, b in zip(r["state"], ref["state"]))
                    and [_metrics_key(m) for m in r["metrics"]]
                    == [_metrics_key(m) for m in ref["metrics"]])
            check(same, f"[25] {tag}: the {r['mode']} run equals the first "
                  "captured run bit for bit (u, p, phi, Cd, Cl, counts)")
            check((r["per_step"], r["bj"], r["kry"])
                  == (ref["per_step"], ref["bj"], ref["kry"]),
                  f"[25] {tag}: {r['mode']} SELL, tile-apply and "
                  f"Krylov-kernel launches per step ({r['per_step']}, "
                  f"{r['bj']}, {r['kry']}) equal the captured run's "
                  f"({ref['per_step']}, {ref['bj']}, {ref['kry']})")
        check(all(r["plain_cuda"] == 0 for r in runs),
              f"[25] {tag}: no plain-version calls on CUDA tensors")
        check(ref["launches"] > 0, f"[25] {tag}: the SELL kernel launched")
        check_bj_path(25, ref["bj"], 0, OPTION_STEPS, torch.float32, 2)
        check_rebuild(25, tag, ref["kry"], ref["metrics"])
        for m in ref["metrics"]:
            check(all(np.isfinite([m.cd, m.cl, m.residual])),
                  f"[25] {tag}: finite forces at t={m.time}")
        check(all(bool(torch.isfinite(x).all()) for x in ref["state"]),
              f"[25] {tag}: finite u, p, phi")
        ms = ref["metrics"]
        its = (" ".join(str(m.iterations) for m in ms) if mono_path else
               " ".join(f"{m.f_iterations}+{m.p_iterations}" for m in ms))
        log(f"[25] {tag} ({'FGMRES' if mono_path else 'BiCGStab+CG'} "
            f"{its}; converged {[m.converged for m in ms]}; residuals "
            + " ".join(f"{m.residual:.2e}" for m in ms)
            + f"): setup {setup_s:.1f} s, capture {sg.capture_seconds:.2f}"
            f" s; steps/s captured {runs[0]['steps_per_s']:.4f} (sync-"
            f"checked), {runs[2]['steps_per_s']:.4f}, eager "
            f"{runs[1]['steps_per_s']:.4f}; SELL launches per step "
            f"{ref['per_step']}; tile-apply launches per step "
            f"{ref['bj_per_step']}; Krylov-kernel launches per step "
            f"{ref['kry']}; Cd {ms[-1].cd:.6f}, Cl {ms[-1].cl:.6f}"
            f" on {card}")
        for r in runs:
            log(f"[25] {tag} {r['mode']}: "
                f"{while_line(r['whiles'], r['set_condition'])}")
        cfg = ns.config
        if mono_path:
            vcycle_per_step(25, tag, ref["kry"], cfg.schur_vcycles,
                            cfg.schur_smooth_k)
        else:
            vcycle_per_step(25, tag, ref["kry"], 1, cfg.schur_smooth_k,
                            calls=sum(m.p_iterations + 1 for m in ms)
                            / len(ms))
        res = dict(setup_s=setup_s, capture_s=sg.capture_seconds,
                   steps_per_s={r["mode"] + str(i): r["steps_per_s"]
                                for i, r in enumerate(runs)},
                   launches=ref["launches"], per_step=ref["per_step"],
                   bj=ref["bj"], bj_per_step=ref["bj_per_step"],
                   kry_per_step=ref["kry"],
                   iterations=[m.iterations for m in ms],
                   converged=[m.converged for m in ms],
                   whiles=ref["whiles"], set_condition=ref["set_condition"])
        if tag == "schur":
            _load_state(ns, end)
            ns.solve_time_step()
            free = ns._ap_schur_pin != 0
            ds = float(_divergence(ns)[free].abs().max())
            dl = float(lap_div[free].abs().max())
            log(f"[25] schur: max |B u| over the {int(free.sum())} unpinned "
                f"of {ns.space.n_p1} pressure nodes after one step: "
                f"{ds:.3e} against the Laplacian step's {dl:.3e}; CG "
                f"counts {[m.p_iterations for m in ms]}")
            check(ds < dl, "[25] schur: the exact projection's divergence "
                  "below the Laplacian's")
            res.update(div_schur=ds, div_laplacian=dl)
        out[tag] = res
        del ns, sg
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_options_small():
    """Phase 25 (d): the six options on the phase 4 small fixture, card
    against CPU (``card_against_cpu``): fp32 under phase 4's rule, its
    noise clause extended to the iteration totals (schur's CG stops 24 to
    26 iterations into step 3 as the thread count changes the CPU's
    summation order), and ``operator="ell"`` in float64 within 1e-9 at
    the inner solves' 1e-10 (phase 18's gate), no SELL launch on it."""
    launches = {}
    for tag, kw in OPTIONS_SMALL:
        d = os.path.join(WORK, "opt_" + tag.replace("=", "_"))
        launches[tag], _ = card_against_cpu(
            25, tag, lambda dev, name, kw=kw, d=d: small_model(
                dev, f"{d}_{name}", **kw), its_noise=True)
        check(launches[tag].get((torch.float32, 2), 0) > 0,
              f"[25] {tag}: the fp32 D=2 SELL kernel launched")
    d = os.path.join(WORK, "opt_ell")
    counts, _ = card_against_cpu(
        25, "operator=ell float64", lambda dev, name: small_model(
            dev, f"{d}_{name}", "float64", **OPTION_ELL),
        n_steps=1, gate=1e-9)
    check(sum(counts.values()) == 0, "[25] ell: no SELL launch")
    return launches


def tiles_of(ns, f, name):
    """The exact tile inverses of the BC-masked F values ``f`` on the
    model's velocity nodes (the fallback branch's tiles), through the
    model's own plan, or one of 256-node tiles where the model runs
    another F preconditioner (3D-1Z: ``diag``)."""
    from navierstokes_tpu_torch.ops import p1ell
    plan = ns._bj_plan
    if plan is None:
        plan = p1ell.build_block_jacobi_plan(
            ns.ell.f, ns.ell.bu, ns.space.n_p2, max(1, 256 // ns.ell.bu),
            ns.device)
    mflat = ns.bc.mask[:, 0]
    d = ns._ops.f_diag(ns.ell, f)
    sigma = torch.sum(d * mflat) / torch.clamp(torch.sum(mflat), min=1.0)
    tiles = p1ell.block_jacobi_inverse(plan, f, mflat, sigma).contiguous()
    check(bool(torch.isfinite(tiles).all()), f"[24] {name}: finite tiles")
    return tiles


def phase_tile_apply_3d1(ns):
    """Phase 24 on 3D-1Z (right after phase 11): the kernel (d=3) against
    its plain version at the exact tile inverses of the model's F at its
    state, fp32 and bf16, timed as at the bench point."""
    f = ns.a0_cell + ns._ops.convection(ns.ell, ns._u)
    tiles = tiles_of(ns, f, "3D-1Z")
    r = _r(ns.space.n_p2, 3, torch.float32, 2403)
    out = [check_and_time_bj("3D-1Z", tiles, r),
           check_and_time_bj("3D-1Z", tiles.to(torch.bfloat16), r)]
    del tiles
    return out


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


def card_against_cpu(phase, tag, make, n_steps=5, gate=None,
                     its_noise=False):
    """CUDA against CPU in the models' dtype, ``n_steps`` steps, under
    phase 4's rule: 1e-4 of the force scale and of |u|, 1e-3 only where the
    gap is at most three times the gap between two CPU fp32 runs that
    differ only in their thread count; iteration totals within 1; no
    plain-version call on a CUDA tensor.  ``its_noise`` extends the same
    rule to the iteration totals: within 1, or within three times the two
    CPU runs' largest difference in them (phase 25's solves whose stopping
    step moves with the summation order).  A fixed ``gate`` (the float64
    runs of phase 18) replaces the fp32 limits, and no noise run is made.
    ``make(device, name)`` builds a set-up model.  Returns the card run's
    launches by (value dtype, D) and its StepMetrics."""
    from navierstokes_tpu_torch.kernels.sell_spmv import COUNTS
    n_threads = torch.get_num_threads()
    alt_threads = 1 if n_threads > 1 else 4
    gpu, cpu = make("cuda", "gpu"), make("cpu", "cpu")
    alt = make("cpu", "alt") if gate is None else None
    worst = dict(cd=0.0, cl=0.0, u=0.0, its=0, noise=0.0, its_noise=0)
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
                   its=abs(mg.iterations - mc.iterations), noise=0.0,
                   its_noise=0)
        noise = ""
        if alt is not None:
            torch.set_num_threads(alt_threads)
            ma = alt.solve_time_step()
            torch.set_num_threads(n_threads)
            gap["noise"] = max(abs(ma.cd - mc.cd) / scale,
                               abs(ma.cl - mc.cl) / scale,
                               _rel(alt._u, cpu._u))
            gap["its_noise"] = abs(ma.iterations - mc.iterations)
            noise = (f"; CPU {n_threads} vs {alt_threads} threads: "
                     f"{gap['noise']:.2e}, its {ma.iterations}")
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
    its_limit = 1
    if its_noise:
        its_limit = max(1, 3 * worst["its_noise"])
    noise = ("" if alt is None else f"; CPU-CPU noise {worst['noise']:.2e}, "
             f"iterations {worst['its_noise']}")
    log(f"[{phase}] {tag} worst: Cd {worst['cd']:.2e}, Cl {worst['cl']:.2e}, "
        f"u {worst['u']:.2e} (gate {gate:g}{noise}), iteration diff "
        f"{worst['its']} (limit {its_limit}); launches over {n_steps} steps by (dtype, D): "
        + ", ".join(f"{str(dt).replace('torch.', '')} D={D}: {n}"
                    for (dt, D), n in sorted(counts.items(), key=str)))
    check(worst["cd"] <= gate and worst["cl"] <= gate,
          f"[{phase}] {tag} Cd/Cl")
    check(worst["u"] <= gate, f"[{phase}] {tag} u")
    check(worst["its"] <= its_limit, f"[{phase}] {tag} iteration counts")
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
    from navierstokes_tpu_torch.kernels import (bj_apply, bj_gemm, bj_inverse,
                                                bj_tiles)
    from navierstokes_tpu_torch.kernels.sell_spmv import COUNTS
    into.update(COUNTS.by_pattern)
    into["plain"] += (COUNTS.plain_cuda_calls
                      + bj_apply.COUNTS.plain_cuda_calls
                      + bj_tiles.COUNTS.plain_cuda_calls
                      + bj_gemm.COUNTS.plain_cuda_calls
                      + bj_inverse.COUNTS.plain_cuda_calls)
    into["bj"] += bj_apply.COUNTS.launches
    for (k, _), v in {**bj_tiles.COUNTS.by_variant,
                      **bj_gemm.COUNTS.by_variant}.items():
        into[f"rebuild:{k}"] += v
    into["rebuild:inverse"] += bj_inverse.COUNTS.launches
    COUNTS.reset()
    bj_apply.COUNTS.reset()
    rebuild_reset()


def phase_naca_sweep(card):
    """``sweep-naca --angles 0 2 4 8`` through the CLI's main on the default
    device at the scenario's h, inside build/chip_smoke/naca (the sweep
    writes output_<angle>.csv into the working directory).  The CLI's
    build_solver is wrapped for the run only, to time each angle's mesh
    and setup and to count the setup's launches apart from the steps'."""
    from navierstokes_tpu_torch.config import SolverConfig
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
    _take_counts(collections.Counter())
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
    bj_launches = steps_c.pop("bj")
    setup_c.pop("bj")
    rebuild = {k.split(":")[1]: steps_c.pop(k) for k in list(steps_c)
               if isinstance(k, str) and k.startswith("rebuild:")}
    for k in [k for k in setup_c if isinstance(k, str)]:
        setup_c.pop(k)
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
        f"{plain_cuda}; per step by operator {per_step}; tile-apply "
        f"launches {bj_launches} ({bj_launches / n_steps:.2f} per step); "
        f"tile rebuild (csrc/bj_tiles.cu, csrc/bj_gemm.cu, "
        f"csrc/bj_inverse.cu) launches per step "
        f"{ {k: v / n_steps for k, v in rebuild.items()} }")
    check(ok, "[14] thin-airfoil criteria (monotone, slope 0.55-1.0 x "
          "2 pi, R^2 > 0.98, 0 < Cl(0) < 2 pi 2.5 deg)")
    check(f_launches >= n_steps, "[14] the F product launched every step")
    check(bj_launches >= n_steps, "[14] the tile apply launched every step")
    check(rebuild.get("tiles", 0) >= n_steps
          and rebuild.get("guard", 0) >= n_steps
          and rebuild.get("guard_max", 0) == rebuild.get("guard", 0),
          f"[14] the tile rebuild's kernels launched every step: {rebuild}")
    check(rebuild.get("inverse", 0) > 0
          and rebuild.get("inverse", 0) + rebuild.get("update_last", 0)
          >= rebuild["guard"],
          f"[14] each guarded step took a branch, the exact ones through "
          f"csrc/bj_inverse.cu: {rebuild}")
    check(plain_cuda == 0, "[14] no plain-version calls on CUDA tensors")
    eager = naca_eager_angle(build, d)
    return dict(launches=launches, setup_launches=setup_launches,
                per_step=per_step, peak_bytes=peak, runs=runs, final=final,
                eager=eager, bj_launches=bj_launches,
                bj_per_step=bj_launches / n_steps,
                rebuild_per_step={k: v / n_steps for k, v in rebuild.items()})


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
    as in phase 3; then (phase 24) the tile-apply kernel at the exact tile
    inverses of the model's static operator (the Newton-Schulz seed).
    Returns also the V-cycle parts of its Ap (phase 27) and phase 28's
    rebuild kernels at the model's tiles."""
    from navierstokes_tpu_torch.scenarios.registry import build_solver
    ns = build_solver("2d-naca", config=_config(os.path.join(
        WORK, "naca_kernel"), "float32"), device="cuda").setup()
    check(ns.space.n_dofs == NACA_DOFS[0],
          f"[14] 2d-naca model DoF count {ns.space.n_dofs}")
    uses = spmv_uses(ns, np.random.default_rng(5678))
    spmv = [check_and_time(use, mat, vals, x, "14")
            for use, mat, vals, x in uses if use in NACA_USES]
    tiles = tiles_of(ns, ns.a0_cell, "NACA")
    bj = check_and_time_bj("NACA", tiles, _r(ns.space.n_p2, 2,
                                              torch.float32, 2414))
    del tiles
    t28 = time.perf_counter()
    ns.solve_time_step(_eager=True)     # the state of the sweep's step 1
    inp = rebuild_inputs(ns)
    rebuild = phase_rebuild("NACA", inp, card_line())
    log(f"[28] NACA part {time.perf_counter() - t28:.1f} s")
    rebuild["products"] = phase_products("NACA", inp, card_line())
    from navierstokes_tpu_torch.kernels import bj_tiles
    rebuild["inverse"] = phase_inverse("NACA", bj_tiles.tiles(
        inp["plan"], inp["f"], inp["mask"], inp["sigma"]), card_line())
    return spmv, bj, vcycle_parts(ns, "ap"), rebuild


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
    from navierstokes_tpu_torch.kernels import bj_apply
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
    bj_apply.COUNTS.reset()
    rebuild_reset()
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
    bj, bj_plain = bj_snapshot()
    rebuild = {k: v / SHARD_STEPS for k, v in rebuild_counts().items()}
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
    check_bj_path(20, bj, bj_plain, SHARD_STEPS, torch.float32, 2)
    # the seed's exact inverses are built in the first step, one per shard
    branch = check_rebuild(20, f"{len(devices)} row shards", rebuild, ms,
                           parts=len(devices), seeds=len(devices))
    check(branch == "".join("E" if m.exact_inverse else "N"
                            for m in first["metrics"]),
          "[20] the guard's branch per step equals phase 5's")
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
                one_device_ms=first["ms"], bj=bj,
                bj_per_step=bj_per_step(bj, SHARD_STEPS),
                rebuild_per_step=rebuild)


# phase 26: the Krylov loops' kernels at the bench point's shapes
KRY_SOURCE = "navierstokes_tpu_torch/csrc/krylov_update.cu"
GS_SOURCE = "navierstokes_tpu_torch/csrc/gram_schmidt.cu"
# no Pallas kernel: XLA's fusion of the JAX loop bodies (BiCGStab's and
# CG's updates; FGMRES's masked Gram-Schmidt)
KRY_REPLACES = {stage: f"navierstokes_tpu/solvers/krylov.py:{line}"
                for stage, line in (("bicgstab_p", 207), ("bicgstab_s", 213),
                                    ("bicgstab_xr", 218), ("cg_xr", 261),
                                    ("cg_p", 266))}
GS_REPLACES = "navierstokes_tpu/solvers/krylov.py:97"
# BiCGStab's F system (2 x 450,518 velocity rows), CG's P1 Laplacian, the
# flat (u, p) vector of FGMRES at restart 64
KRY_N = {"bicgstab": 901_036, "cg": 113_378}
# CG's P1 size in 3D-1Z (3,393,382 DoF less 3 x 1,084,214 velocity nodes):
# above one cluster's register pass (131,072 fp32 elements), so the CG
# stages read their second pass again after the barrier
KRY_N_CG_3D1 = 140_740
GS_N, GS_M, GS_JS = EXPECTED_DOFS, 64, (0, 5, 13, 20, 38, 63)
# kernel against plain version: both sum each product in float64, in other
# orders; each element within one ulp of the plain value, or within
# GS_GATE of the scale (measured gaps in PERF.md section 6)
GS_GATE = {torch.float32: 2.0 ** -24, torch.float64: 1e-12}
FP64_OPS_PER_S = 34e12        # published H100 SXM fp64 rate, no tensor core
# vectors of n read plus written per stage with the flag up, and flops
# per element (the CG stages' dots and norm: a multiply and an add each)
KRY_VECTORS = {"bicgstab_p": (3, 1, 4), "bicgstab_s": (2, 2, 2),
               "bicgstab_xr": (5, 2, 6), "cg_xr": (4, 2, 8),
               "cg_p": (3, 1, 4)}
# the timed bursts' BiCGStab scalars: powers of two that keep repeated
# calls bounded (beta 1/2); the bit-for-bit checks draw theirs, and the CG
# stages' rz comes from their dots (krylov_update.example: alpha and beta
# below 1)
KRY_TAME = {"rho_new": 0.5, "rho": 1.0, "alpha": 1.0, "omega": 1.0,
            "denom": 2.0, "ts": 0.25, "tt": 1.0, "alpha_state": 1.0,
            "omega_state": 1.0}
# seeded draws per dtype whose dots and norm phase 26 compares with the
# plain version's (the bit-equal ones counted)
CG_DRAWS = 8
# a captured CG iteration's kernels besides its product and its
# preconditioner: cg_xr, cg_p, set_condition
CG_ITERATION_KERNELS = 3


def _plain_ms(fn, n=BURST, reps=5):
    """Median device time per call of ``n`` calls of ``fn`` launched
    eagerly (a plain version's many small launches outrun any spin, so
    the host's gaps are in the time), after one warm-up call."""
    fn()
    return _replay_ms(lambda: [fn() for _ in range(n)], n, reps)


def kernel_launches(fn):
    """(kernels one call of ``fn`` launches, other operations it
    enqueues), counted as the nodes that the call records into a CUDA
    graph when captured (the main path runs its calls captured), read
    with libcuda's ``cuGraphGetNodes`` from the graph in capture.
    (A ``torch.profiler`` trace on the card at times loses launches or
    holds none, so it cannot gate a count.)"""
    cu = ctypes.CDLL("libcuda.so.1")
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    kinds = []
    with torch.cuda.graph(g):
        fn()
        graph, status = ctypes.c_void_p(), ctypes.c_int()
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        rc = cu.cuStreamGetCaptureInfo_v2(stream, ctypes.byref(status),
                                          None, ctypes.byref(graph), None,
                                          None)
        check(rc == 0 and status.value == 1,
              f"cuStreamGetCaptureInfo ({rc}, status {status.value})")
        n = ctypes.c_size_t()
        check(cu.cuGraphGetNodes(graph, None, ctypes.byref(n)) == 0,
              "cuGraphGetNodes")
        nodes = (ctypes.c_void_p * n.value)()
        check(cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)) == 0,
              "cuGraphGetNodes")
        for node in nodes:
            kind = ctypes.c_int()
            check(cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                        ctypes.byref(kind)) == 0,
                  "cuGraphNodeGetType")
            kinds.append(kind.value)
    del g
    kernels = kinds.count(0)              # CU_GRAPH_NODE_TYPE_KERNEL
    return kernels, len(kinds) - kernels


def _gate_ratio(k, p, scale, dt):
    """max |k - p| / max(ulp(p), GS_GATE[dt] * scale) over the elements:
    the kernel passes at 1 or less."""
    from navierstokes_tpu_torch.kernels.krylov_update import ulp
    tol = torch.clamp(ulp(p), min=GS_GATE[dt] * scale)
    return float(((k - p).abs() / tol).max())


def _gs_basis(n, m, seed=26):
    """An orthonormal basis of m rows of n (QR on the card, float64) and a
    seeded vector with a part in its span."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, _ = torch.linalg.qr(torch.randn(n, m, generator=g, device="cuda",
                                       dtype=torch.float64))
    w = torch.randn(n, generator=g, device="cuda", dtype=torch.float64)
    w += 3.0 * q @ torch.randn(m, generator=g, device="cuda",
                               dtype=torch.float64)
    return q.T.contiguous(), w


def _whole_basis(V, w, j):
    """The Gram-Schmidt the port ran before csrc/gram_schmidt.cu: the JAX
    body's masked products over the whole basis (cuBLAS GEMVs)."""
    m = V.shape[0] - 1
    mask = (torch.arange(m + 1, device=V.device) <= j).to(V.dtype)
    h1 = (V @ w) * mask
    w = w - h1 @ V
    h2 = (V @ w) * mask
    w = w - h2 @ V
    return h1, h2, torch.linalg.norm(w)


def cg_iteration_launches(loop):
    """The kernels (and other nodes) that one iteration of ``loop`` (a
    ``CgLoop`` whose flag is down, so its state stays as it is) records
    into a captured graph, besides those of its product and of its
    preconditioner on the same vectors (``kernel_launches``; the body's
    kernels, the product's and the preconditioner's are counted apart).
    Call it after the counts of a run are read: the calls add to them."""
    check(not bool(loop.active), "cg_iteration_launches: the loop's flag "
          "is down")
    body = kernel_launches(loop._body)
    product = kernel_launches(lambda: loop.mv(loop.p))
    precond = kernel_launches(lambda: loop.pc(loop.r))
    return dict(body=body[0], product=product[0], preconditioner=precond[0],
                besides=body[0] - product[0] - precond[0],
                other_besides=body[1] - product[1] - precond[1])


def check_cg_iteration(phase, it):
    """A captured CG iteration launches CG_ITERATION_KERNELS kernels
    besides its product and its preconditioner (cg_xr, cg_p and the
    predicate: no cuBLAS dot, no norm reduction) and no other node."""
    log(f"[{phase}] one captured CG iteration: {it['body']} kernels, of "
        f"them {it['product']} the product's and {it['preconditioner']} the "
        f"preconditioner's: {it['besides']} besides (and "
        f"{it['other_besides']} other nodes)")
    check(it["besides"] == CG_ITERATION_KERNELS and it["other_besides"] == 0,
          f"[{phase}] a captured CG iteration launches "
          f"{CG_ITERATION_KERNELS} kernels besides its product and its "
          f"preconditioner (cg_xr, cg_p, set_condition; no dot or norm of "
          f"its own): {it}")


def _cg_dots_ms(stage, sets):
    """ms in L2-cold bursts of the launches that a CG stage took over
    besides the parent's stage: cg_xr's p @ Ap (cuBLAS, two kernels) and
    the predicate's torch.linalg.norm(r), cg_p's r @ z."""
    from navierstokes_tpu_torch.kernels import krylov_update as KU
    at = {name: KU.ARGS[stage].index(name) for name in KU.ARGS[stage]}
    if stage == "cg_xr":
        return dict(
            dot_ms=_burst_ms([functools.partial(torch.dot, st[at["p"]],
                                                st[at["ap"]])
                              for st in sets]),
            norm_ms=_burst_ms([functools.partial(torch.linalg.norm,
                                                 st[at["r"]])
                               for st in sets]))
    return dict(dot_ms=_burst_ms([functools.partial(torch.dot, st[at["r"]],
                                                    st[at["z"]])
                                  for st in sets]))


def phase_krylov_kernels(card, cg_iteration):
    """Phase 26: the fused update stages (csrc/krylov_update.cu) against
    their plain versions at the bench point's shapes, fp32 and fp64, the
    flag up and down, bit for bit (the CG stages, which take their own
    float64 dots in one cluster, under ``KU.cg_gate`` over CG_DRAWS seeded
    draws, the odd ones with products of both signs, the bit-equal ones
    counted; timed L2-warm too, beside the
    cuBLAS dots and the norm they took over, with the kernels a captured
    CG iteration of phase 5 launched besides its product and its
    preconditioner, ``cg_iteration``); the Gram-Schmidt kernels
    (csrc/gram_schmidt.cu) against theirs on the flat bench vector at
    restart 64 and j in GS_JS, each element within one ulp or GS_GATE of
    the scale, bit-identical on repeat, V and Z untouched with the flag
    down; each timed in bursts
    beside its bound (input sets cycled that exceed twice the L2), its
    plain version (launched eagerly, ``_plain_ms``), and for Gram-Schmidt
    one cuBLAS GEMV over the whole basis (the library) and the
    whole-basis sequence the port ran before; then each call's kernel
    launches at every j, counted in a captured call's graph
    (``kernel_launches``) and held to ``gram_schmidt.LAUNCHES``."""
    from navierstokes_tpu_torch.kernels import gram_schmidt as GS
    from navierstokes_tpu_torch.kernels import krylov_update as KU
    t_phase = time.perf_counter()
    out = {"stages": {}, "gs": {}}
    for stage in KU.STAGES:
        n = KRY_N[stage.split("_")[0]]
        reads, writes, flops = KRY_VECTORS[stage]
        is_cg = stage in KU.CG_DOTS
        rec = {}
        for dt in (torch.float32, torch.float64):
            max_err, equal_draws = 0.0, 0
            for active in (True, False):
                # drawn scalars: no product of a scalar and an element is
                # exact, so a contracted multiply-add would change bits
                for draw in range(CG_DRAWS if is_cg and active else 1):
                    kern = KU.example(stage, n, dt, "cuda",
                                      np.random.default_rng(1 + 100 * draw),
                                      active=active, signed=draw % 2 == 1)
                    before = [t.clone() for t in kern]
                    plain = [t.clone() for t in kern]
                    KU.update(stage, *kern)
                    KU.PLAIN[stage](*plain)
                    torch.cuda.synchronize()
                    if is_cg and active:
                        ok, equal, err = KU.cg_gate(stage, kern, plain,
                                                    before)
                        equal_draws += equal
                        max_err = max(max_err, err)
                        check(ok, f"[26] {stage} {dt} draw {draw}: kernel "
                              "against plain within KU.cg_gate (fp32: "
                              "dots and norm within one ulp, bit for bit "
                              "where equal; fp64 within "
                              f"{KU.DOT_GATE:g} of the sum of |a b|; the "
                              "vectors within what the dots' gap moves), "
                              f"max |kernel - plain| {err:.3e}")
                        continue
                    differ = [name for name, a, b in zip(KU.ARGS[stage],
                                                         kern, plain)
                              if not torch.equal(a, b)]
                    check(differ == [], f"[26] {stage} {dt} active={active}"
                          f": kernel against plain bit for bit (differ: "
                          f"{differ})")
                    if not active:
                        moved = [name for name, a, b in zip(KU.ARGS[stage],
                                                            kern, before)
                                 if not torch.equal(a, b)
                                 and name not in KU.SCRATCH.get(stage, ())]
                        check(moved == [], f"[26] {stage} {dt}: the flag "
                              f"down moves no state buffer (moved {moved})")
            # input sets that together exceed twice the L2, cycled in the
            # bursts: on the main path the products between two stages
            # (the 461 MB tile apply among them) leave the L2 cold
            nbytes = (reads + writes) * n * (4 if dt == torch.float32 else 8)
            # on views that start on a 16-byte boundary and on views one
            # element past one (the pressure part of a flat (u, p) vector):
            # the path each takes, from the launch counts
            paths, path_ms = {}, {}
            for offset in (0, 1):
                sets = [KU.example(stage, n, dt, "cuda",
                                   np.random.default_rng(2 + i),
                                   scalars=KRY_TAME, offset=offset)
                        for i in range(max(2, -(-2 * L2_BYTES // nbytes)))]
                KU.COUNTS.reset()
                KU.update(stage, *sets[0])
                (way,) = [w for (st, w) in KU.PATHS if st == stage]
                paths[offset] = way
                path_ms[way] = _burst_ms([functools.partial(KU.update, stage,
                                                            *st)
                                          for st in sets])
                if offset == 0:
                    ms = path_ms[way]
                    # L2-warm: one set over and over (CG's 1-3 MB stay in
                    # the L2 across a captured iteration)
                    warm_ms = _burst_ms([functools.partial(
                        KU.update, stage, *sets[0])])
                    plain_ms = _plain_ms(functools.partial(KU.PLAIN[stage],
                                                           *sets[0]))
                    dots_ms = (_cg_dots_ms(stage, sets) if is_cg else None)
                del sets
            check(paths == {0: "vector", 1: "peeled"},
                  f"[26] {stage} {dt}: aligned views take the vector path, "
                  f"views one element off the peeled path ({paths})")
            ms_3d1 = None
            if is_cg:
                # 3D-1Z's size: two passes, the gate and the L2-cold time
                n3 = KRY_N_CG_3D1
                kern = KU.example(stage, n3, dt, "cuda",
                                  np.random.default_rng(7))
                before = [t.clone() for t in kern]
                plain = [t.clone() for t in kern]
                KU.update(stage, *kern)
                KU.PLAIN[stage](*plain)
                ok, _, err = KU.cg_gate(stage, kern, plain, before)
                check(ok, f"[26] {stage} {dt} n={n3}: kernel against plain "
                      f"within KU.cg_gate, max |kernel - plain| "
                      f"{err:.3e}")
                n3_bytes = (reads + writes) * n3 * kern[0].element_size()
                sets = [KU.example(stage, n3, dt, "cuda",
                                   np.random.default_rng(20 + i))
                        for i in range(max(2, -(-2 * L2_BYTES // n3_bytes)))]
                ms_3d1 = _burst_ms([functools.partial(KU.update, stage, *st)
                                    for st in sets])
                del sets, kern, plain, before
            ops = flops * n
            peak = FP32_OPS_PER_S if dt == torch.float32 else FP64_OPS_PER_S
            bound = max(nbytes / HBM_BYTES_PER_S, ops / peak) * 1e3
            rec[str(dt).replace("torch.", "")] = dict(
                n=n, ms=ms, warm_ms=warm_ms, plain_ms=plain_ms,
                bound_ms=bound,
                bound_by=("bytes" if nbytes / HBM_BYTES_PER_S
                          >= ops / peak else "operations"),
                bound_bytes=nbytes, max_abs_err=max_err, library_ms=None,
                path_ms=path_ms, replaced_dots_ms=dots_ms,
                ms_3d1_size=ms_3d1,
                bit_equal_draws=(f"{equal_draws} of {CG_DRAWS}" if is_cg
                                 else None))
            key = str(dt).replace("torch.", "")
            if is_cg:
                log(f"[26] {stage} {key} n={n}: one cluster of "
                    f"{KU.cluster()} CTAs; dots and norm bit-equal to the "
                    f"plain version's in {equal_draws} of {CG_DRAWS} draws, "
                    f"max |kernel - plain| {max_err:.3e} (flag down: "
                    f"nothing moves); {ms:.4f} ms per launch in bursts "
                    f"L2-cold on aligned views (vector path), {warm_ms:.4f} "
                    f"L2-warm, {path_ms['peeled']:.4f} one element off "
                    f"(peeled path); bound {bound:.4f} ms ({nbytes} bytes, "
                    f"{100 * bound / ms:.1f}% cold, "
                    f"{100 * bound / warm_ms:.1f}% warm); the launches it "
                    f"replaces besides the parent's stage: {dots_ms}; "
                    f"plain {plain_ms:.4f} ms; at 3D-1Z's n = "
                    f"{KRY_N_CG_3D1} (two passes) {ms_3d1:.4f} ms L2-cold, "
                    f"within the gate, on {card}")
            else:
                log(f"[26] {stage} {key} n={n}: "
                    f"kernel = plain bit for bit (flag up and down); "
                    f"{ms:.4f} ms per launch in bursts on aligned views "
                    f"(vector path), {path_ms['peeled']:.4f} ms one element "
                    f"off (peeled path); bound {bound:.4f} ms ({nbytes} "
                    f"bytes, {100 * bound / ms:.1f}% on the vector path, "
                    f"{100 * bound / path_ms['peeled']:.1f}% peeled), plain "
                    f"{plain_ms:.4f} ms on {card}")
        if is_cg:
            rec["launches_per_captured_iteration"] = cg_iteration
            log(f"[26] {stage}: a captured CG iteration of the bench step "
                f"launches {cg_iteration['besides']} kernels besides its "
                f"product and its preconditioner (phase 5; gate "
                f"{CG_ITERATION_KERNELS})")
        out["stages"][stage] = rec
    # Gram-Schmidt on the flat vector
    q, w64 = _gs_basis(GS_N, GS_M)
    g = torch.Generator(device="cuda").manual_seed(27)
    z64 = torch.randn(GS_N, generator=g, device="cuda", dtype=torch.float64)
    def padded(B):
        """A copy of B in a padded basis (GmresLoop's layout; clone()
        of the padded view would be contiguous)."""
        out = GS.basis(B.shape[0], B.shape[1], B.dtype, B.device)
        out.copy_(B)
        return out

    for dt in (torch.float32, torch.float64):
        key = str(dt).replace("torch.", "")
        work = GS.workspace(GS_M, GS_N, dt, "cuda")
        Z = GS.basis(GS_M, GS_N, dt, "cuda").zero_()
        z, wv = z64.to(dt), w64.to(dt)
        # cuBLAS's y @ Z (the FGMRES x update) on the padded basis against
        # a contiguous copy of it: whether the leading dimension moves bits
        g = torch.Generator(device="cuda").manual_seed(28)
        Zr = torch.randn(GS_M, GS_N, generator=g, device="cuda", dtype=dt)
        y = torch.randn(GS_M, generator=g, device="cuda", dtype=dt)
        same_ld = torch.equal(y @ Zr, y @ padded(Zr))
        log(f"[26] cuBLAS y @ Z {key} on the padded basis (row stride "
            f"{Z.stride(0)}) {'equals' if same_ld else 'DIFFERS from'} the "
            "contiguous basis's bits")
        del Zr
        rec = []
        for j in GS_JS:
            V = GS.basis(GS_M + 1, GS_N, dt, "cuda").zero_()
            V[:j + 1] = q[:j + 1].to(dt)
            jt = torch.tensor(j, dtype=torch.int32, device="cuda")
            res = {}
            for tag, fn in (("kernel", GS.gram_schmidt),
                            ("again", GS.gram_schmidt),
                            ("plain", GS.gram_schmidt_plain)):
                st = dict(V=padded(V), h1=torch.zeros(GS_M + 1, dtype=dt,
                                                      device="cuda"),
                          h2=torch.zeros(GS_M + 1, dtype=dt, device="cuda"),
                          wnorm=torch.zeros((), dtype=dt, device="cuda"),
                          Z=padded(Z))
                args = (st["V"], wv, st["h1"], st["h2"], st["wnorm"], jt,
                        torch.tensor(True, device="cuda"))
                if tag == "plain":
                    fn(*args, z, st["Z"])
                else:
                    fn(*args, work, z, st["Z"])
                res[tag] = st
            down = dict(V=padded(V), Z=padded(Z))
            GS.gram_schmidt(down["V"], wv, res["again"]["h1"].clone(),
                            res["again"]["h2"].clone(),
                            res["again"]["wnorm"].clone(), jt,
                            torch.tensor(False, device="cuda"), work, z,
                            down["Z"])
            torch.cuda.synchronize()
            k, p = res["kernel"], res["plain"]
            check(all(torch.equal(k[x], res["again"][x]) for x in k),
                  f"[26] gram_schmidt {key} j={j}: bit-identical on repeat")
            check(torch.equal(down["V"], V) and torch.equal(down["Z"], Z),
                  f"[26] gram_schmidt {key} j={j}: the flag down moves "
                  "neither V nor Z")
            row = j + 1
            scale = float(p["h1"].abs().max())
            errs = {"h1": float((k["h1"] - p["h1"]).abs().max()) / scale,
                    "h2": float((k["h2"] - p["h2"]).abs().max()) / scale,
                    "wnorm": float((k["wnorm"] - p["wnorm"]).abs()
                                   / p["wnorm"]),
                    "V": float((k["V"][row] - p["V"][row]).abs().max()
                               / p["V"][row].abs().max())}
            abs_err = max(float((k[x] - p[x]).abs().max())
                          for x in ("h1", "h2", "wnorm", "V"))
            vmax = float(p["V"][row].abs().max())
            ratio = {"h1": _gate_ratio(k["h1"], p["h1"], scale, dt),
                     "h2": _gate_ratio(k["h2"], p["h2"], scale, dt),
                     "wnorm": _gate_ratio(k["wnorm"], p["wnorm"],
                                          float(p["wnorm"]), dt),
                     "V": _gate_ratio(k["V"][row], p["V"][row], vmax, dt)}
            others = [i for i in range(GS_M + 1) if i != row]
            check(max(ratio.values()) <= 1.0
                  and torch.equal(k["V"][others], p["V"][others])
                  and torch.equal(k["Z"], p["Z"])
                  and not k["h1"][j + 1:].any() and not k["h2"][j + 1:].any(),
                  f"[26] gram_schmidt {key} j={j}: kernel within one ulp "
                  f"or {GS_GATE[dt]:g} of the scale (max|h1| for h1, h2) "
                  f"of the plain version, element by element: {ratio} of "
                  f"that limit; other rows and Z equal, h zero beyond j")
            # the whole-basis sequence (fp32 sums) against the plain one,
            # under the same limit
            wb = _whole_basis(V, wv, j)
            wb_gap = float((wb[0] - p["h1"]).abs().max()) / scale
            wb_ratio = {"h1": _gate_ratio(wb[0], p["h1"], scale, dt),
                        "h2": _gate_ratio(wb[1], p["h2"], scale, dt),
                        "wnorm": _gate_ratio(wb[2], p["wnorm"],
                                             float(p["wnorm"]), dt)}
            s = V.element_size()
            # copies that together exceed twice the L2 where one call's
            # data does not, cycled in the bursts (the main path runs the
            # preconditioner and the product between two calls)
            on = torch.tensor(True, device="cuda")
            foot = (j + 5) * GS_N * s
            sets = [dict(V=padded(V), w=wv.clone(), z=z.clone(), Z=padded(Z),
                         h1=torch.zeros(GS_M + 1, dtype=dt, device="cuda"),
                         h2=torch.zeros(GS_M + 1, dtype=dt, device="cuda"),
                         wnorm=torch.zeros((), dtype=dt, device="cuda"))
                    for _ in range(max(1, -(-2 * L2_BYTES // foot)))]
            ms = _burst_ms([functools.partial(
                GS.gram_schmidt, c["V"], c["w"], c["h1"], c["h2"],
                c["wnorm"], jt, on, work, c["z"], c["Z"]) for c in sets])
            c = sets[0]
            plain_ms = _plain_ms(functools.partial(
                GS.gram_schmidt_plain, c["V"], c["w"], c["h1"], c["h2"],
                c["wnorm"], jt, on, c["z"], c["Z"]), n=5, reps=3)
            del sets, c
            lib_ms = _burst_ms([lambda: V @ wv])
            whole_ms = _burst_ms([lambda: _whole_basis(V, wv, j)], reps=5)
            # read once: rows 0..j, w, z; written once: V[j+1], Z[j]
            nbytes = (j + 5) * GS_N * s + 4 * (GS_M + 1) * s
            design = (3 * (j + 1) + 8) * GS_N * s
            ops = 8 * (j + 1) * GS_N
            bound = max(nbytes / HBM_BYTES_PER_S,
                        ops / FP64_OPS_PER_S) * 1e3
            rec.append(dict(j=j, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                            whole_basis_ms=whole_ms, bound_ms=bound,
                            bound_by=("bytes" if nbytes / HBM_BYTES_PER_S
                                      >= ops / FP64_OPS_PER_S
                                      else "operations"),
                            bound_bytes=nbytes, design_bytes=design,
                            cublas_ld_same=same_ld,
                            errors=errs, gate_ratio=ratio,
                            max_abs_err=abs_err, whole_basis_h1_gap=wb_gap,
                            whole_basis_gate_ratio=wb_ratio))
            log(f"[26] gram_schmidt {key} n={GS_N} m={GS_M} j={j}: kernel "
                f"against plain {errs} of the scale, {ratio} of the limit "
                f"(one ulp or {GS_GATE[dt]:g} of the scale); the "
                f"whole-basis sequence's h1 {wb_gap:.2e} from the plain, "
                f"{wb_ratio} of the limit; "
                f"{ms:.4f} ms per step in bursts, bound "
                f"{bound:.4f} ms ({nbytes} bytes, "
                f"{100 * bound / ms:.0f}%; this design moves {design} "
                f"bytes, {design / ms / 1e6:.0f} GB/s), plain "
                f"{plain_ms:.4f} ms, one cuBLAS V @ w over the whole basis "
                f"{lib_ms:.4f} ms, the whole-basis sequence {whole_ms:.4f} "
                f"ms, on {card}")
            del V, res, down
        out["gs"][key] = rec
        del work, Z
    # the kernels a call launches at each j, counted in a captured
    # call's graph
    on = torch.tensor(True, device="cuda")
    for dt in (torch.float32, torch.float64):
        key = str(dt).replace("torch.", "")
        work = GS.workspace(GS_M, GS_N, dt, "cuda")
        V = GS.basis(GS_M + 1, GS_N, dt, "cuda").zero_()
        V[:GS_M] = q.to(dt)
        st = dict(V=V, w=w64.to(dt), z=z64.to(dt),
                  Z=GS.basis(GS_M, GS_N, dt, "cuda").zero_(),
                  h1=torch.zeros(GS_M + 1, dtype=dt, device="cuda"),
                  h2=torch.zeros(GS_M + 1, dtype=dt, device="cuda"),
                  wnorm=torch.zeros((), dtype=dt, device="cuda"))
        for r in out["gs"][key]:
            jt = torch.tensor(r["j"], dtype=torch.int32, device="cuda")
            launches, other = kernel_launches(functools.partial(
                GS.gram_schmidt, st["V"], st["w"], st["h1"], st["h2"],
                st["wnorm"], jt, on, work, st["z"], st["Z"]))
            r["launches"] = launches
            log(f"[26] gram_schmidt {key} j={r['j']}: {launches} kernel "
                f"launches per call (and {other} other operations), "
                "counted in a captured call's graph")
            check(launches == GS.LAUNCHES and other == 0,
                  f"[26] gram_schmidt {key} j={r['j']}: {launches} "
                  f"kernels and {other} other operations per call "
                  f"captured, the module says {GS.LAUNCHES} kernels")
        del work, V, st
    torch.cuda.empty_cache()
    log(f"[26] phase {time.perf_counter() - t_phase:.1f} s")
    return out


# phase 27: the V-cycle's smoothing sweeps at the P1 operators of the bench
# point and 3D-1Z (the outlet-pinned Laplacians, n = 113,378 and 140,740)
# and of the NACA step (Ap of its monolithic cc)
VC_SOURCE = "navierstokes_tpu_torch/csrc/vcycle.cu"
# no Pallas kernel: XLA's fusion of the JAX smoother and V-cycle
# (make_vcycle_solver's pre-smoothing and residual, its post-smoothing
# and the next cycle's pre-smoothing, its last post-smoothing)
VC_REPLACES = {"pre": "navierstokes_tpu/solvers/schur.py:187",
               "mid": "navierstokes_tpu/solvers/schur.py:192",
               "post": "navierstokes_tpu/solvers/schur.py:192"}


def vcycle_parts(ns, which):
    """(P1Matrix, CoarsePlan, sc_inv, lambda_max, k, cycles) of a model's
    V-cycle on its P1 operator ``which``: ``"ap_dir"``, the outlet-pinned
    Laplacian of the projection Poisson solve (1 cycle), or ``"ap"``, Ap of
    the monolithic ``cc`` (``schur_vcycles`` cycles)."""
    cfg = ns.config
    return (getattr(ns, f"_{which}"), ns._coarse_plan,
            getattr(ns, f"_{which}_sc_inv"), getattr(ns, f"_{which}_lam"),
            cfg.schur_smooth_k, 1 if which == "ap_dir" else cfg.schur_vcycles)


def _vc_copies(op, ex):
    """Copies of the operator and of a sweep's inputs that together exceed
    twice the L2, so that a burst cycling through them reads each from
    HBM (the cold time; the main path's V-cycle finds its operator warm
    or cold as the tiles and the F solve left the L2)."""
    size = (op.vals.numel() * op.vals.element_size()
            + 4 * op.mat.cols.numel()
            + sum(v.numel() * v.element_size() for v in ex.values()
                  if torch.is_tensor(v)))
    out = []
    for _ in range(max(2, -(-2 * L2_BYTES // size))):
        m = dataclasses.replace(op.mat, cols=op.mat.cols.clone(),
                                slice_ptr=op.mat.slice_ptr.clone(),
                                rows=op.mat.rows.clone())
        out.append((dataclasses.replace(op, mat=m, vals=op.vals.clone()),
                    {k: v.clone() if torch.is_tensor(v) else v
                     for k, v in ex.items()}))
    return out


def _vc_bound(op, kind, k, agg):
    """(bytes, ms) of the least traffic of a sweep: each nonzero's value
    and column once, each n-vector it reads (r, sdinv, and z0 in mid and
    post) and writes (zc0 for k > 1, zc1 for k > 2, its outputs) once, y
    once; over 3.35 TB/s."""
    t = op.vals.element_size()
    reads = {"pre": 2, "mid": 3, "post": 3}[kind]
    writes = {"pre": 2, "mid": 3, "post": 1}[kind] + (k > 1) + (k > 2)
    nbytes = (reads + writes) * op.n * t + op.mat.nnz * (t + 4) \
        + (-(-op.n // agg) * t if kind != "pre" else 0)
    return nbytes, nbytes / HBM_BYTES_PER_S * 1e3


def _vc_parts64(parts):
    """A P1 operator's V-cycle parts in float64: the operator's values and
    diagonal, the coarse inverse and lambda_max cast."""
    op, plan, sc_inv, lam, k, n_cycles = parts
    return (dataclasses.replace(op, vals=op.vals.double(),
                                diag=op.diag.double()),
            plan, sc_inv.double(), lam.double(), k, n_cycles)


# the plan of rounds 0 (any number of slices a warp, the rows' state in
# device memory: operators of more than 4 x 32 slices a CTA) is held on the
# phase's operators as if the card had one SM for every this many slices
VC_FEW_SMS_SLICES = 300


def _vc_plans(op, name, dt):
    """{path: plan} of the sweeps on ``op``: the path ``vcycle.plan`` picks
    and each path forced; a path that cannot hold the operator (the shared
    path where the fullest CTA's slots exceed the card's shared memory)
    is logged and left out; and ``"rounds 0"``, the device path's plan as
    if the card had one SM for every VC_FEW_SMS_SLICES slices."""
    from navierstokes_tpu_torch.kernels import vcycle as VC
    default = VC.plan(op)
    plans = {}
    for path in VC.PATHS:
        try:
            plans[path] = VC.plan(op, path)
        except ValueError as e:
            log(f"[27] {name} {dt}: no {path} path: {e}")
    check(default.path in plans and plans[default.path].smem == default.smem,
          f"[27] {name} {dt}: the picked path is a forced path's plan")
    ptr = op.mat.slice_ptr.cpu().numpy().astype(np.int64)
    sms = max(1, (len(ptr) - 1) // VC_FEW_SMS_SLICES)
    card = VC.card_query(op)
    plans["rounds 0"] = VC.attach(op, VC.choose(
        ptr, op.vals.element_size(), lambda *a: dict(card(*a), sms=sms)))
    few = plans["rounds 0"]
    check(few.rounds == 0 and few.path == "device"
          and few.slices > VC.WARPS * VC.ROUNDS[-1],
          f"[27] {name} {dt}: on {sms} SMs the plan takes rounds 0 on the "
          f"device path ({few.slices} slices a CTA)")
    for path, p in plans.items():
        log(f"[27] {name} {dt} {path} plan{' (picked)' * (path == default.path)}: "
            f"{p.grid} CTAs ({p.per_sm} an SM) of 1,024 threads, "
            f"{p.rounds or 'any'} slice(s) a warp, fullest CTA {p.slices} "
            f"slices, "
            f"{p.smem} bytes of shared memory a CTA, at most "
            f"{p.neighbours} neighbours a CTA, {p.regs} registers "
            f"and {p.local} bytes of local memory a thread")
    return plans, default.path


def phase_vcycle(card, operators):
    """Phase 27: the V-cycle's sweeps (csrc/vcycle.cu) on each P1 operator
    of ``operators`` (name -> (P1Matrix, CoarsePlan, sc_inv, lambda_max, k,
    n_cycles) of a model's V-cycle), in fp32 and fp64: each sweep
    (``vcycle.SWEEPS``) on seeded inputs against its plain version bit for
    bit in every buffer, on repeat and on a right-hand side at an odd
    offset, on each path that holds the operator (shared and device
    memory) and on the plan of rounds 0 (``_vc_plans``); the whole fused
    V-cycle at 1 cycle and at the model's cycles against
    ``make_vcycle_solver``'s plain cycle bit for bit, on an aligned and an
    odd-offset right-hand side (on the plan of rounds 0, aligned); the
    kernel nodes of a
    captured V-cycle held to ``vcycle.launches(n, k)`` (4 at 1 cycle, 7 at
    2); times: each sweep in L2-cold bursts (copies beyond twice the L2)
    and warm ones beside its bound (bytes over 3.35 TB/s) and its plain
    version (bench fp32: both paths; elsewhere the picked one), the fused
    and the plain (stock) V-cycle per call."""
    from navierstokes_tpu_torch.kernels import vcycle as VC
    from navierstokes_tpu_torch.ops.p1ell import ell_matvec
    from navierstokes_tpu_torch.solvers import schur as TS
    t_phase = time.perf_counter()
    out = {}
    sets = []
    for name, parts in operators.items():
        sets += [(name, "float32", parts), (name, "float64",
                                            _vc_parts64(parts))]
    for name, dt, (op, plan, sc_inv, lam, k, n_model) in sets:
        rng = np.random.default_rng(27)
        ex = VC.example(op, rng, k=k, agg=plan.agg)
        plans, picked = _vc_plans(op, name, dt)
        rec = {"n": op.n, "nnz": op.mat.nnz, "k": k, "picked": picked,
               "plans": {p: {f: getattr(sp, f) for f in (
                   "grid", "rounds", "smem", "per_sm", "slices", "regs",
                   "local", "neighbours")} for p, sp in plans.items()},
               "sweeps": {}}
        flat = torch.as_tensor(rng.standard_normal(op.n + 1),
                               dtype=op.vals.dtype, device="cuda")
        timed = dt == "float32"
        for kind in VC.SWEEPS:
            want = VC.run_case(kind, op, ex, plain=True)
            want_odd = VC.run_case(kind, op, ex, plain=True, r=flat[1:])
            torch.cuda.synchronize()
            for path, sp in plans.items():
                VC.COUNTS.reset()
                got = VC.run_case(kind, op, ex, sp)
                again = VC.run_case(kind, op, ex, sp)
                odd = VC.run_case(kind, op, ex, sp, r=flat[1:])
                torch.cuda.synchronize()
                launched = getattr(VC.COUNTS, kind)
                equal = all(torch.equal(got[b], want[b])
                            and torch.equal(again[b], got[b])
                            and torch.equal(odd[b], want_odd[b])
                            for b in VC.BUFFERS)
                err = max(float((got[b] - want[b]).abs().max())
                          for b in VC.BUFFERS)
                check(equal and launched == 3
                      and bool((sp.flags == sp.flags[0]).all()),
                      f"[27] {name} {dt} {kind} ({path}): the sweep's "
                      f"buffers equal the plain version's bit for bit, on "
                      f"repeat and at an odd offset, one launch a call, "
                      f"every CTA's progress word equal (max gap "
                      f"{err:.3e}, {launched} launches)")
                r = dict(max_abs_err=err, bit_equal=equal, path=path,
                         smem=sp.smem)
                if timed and path in VC.PATHS and (path == picked
                                                   or name == "bench"):
                    nbytes, bound = _vc_bound(op, kind, k, plan.agg)
                    copies = _vc_copies(op, ex)
                    scratch = {b: ex[b].clone() for b in VC.BUFFERS}
                    r.update(
                        ms=_burst_ms([functools.partial(
                            VC.run_case, kind, o, e, sp, into=e)
                            for o, e in copies]),
                        warm_ms=_burst_ms([functools.partial(
                            VC.run_case, kind, op, ex, sp, into=scratch)]),
                        bound_bytes=nbytes, bound_ms=bound,
                        bound_by="bytes", library_ms=None)
                    if path == picked:
                        r["plain_ms"] = _plain_ms(functools.partial(
                            VC.run_case, kind, op, ex, plain=True,
                            into=scratch))
                    del copies
                    plain = ("" if "plain_ms" not in r
                             else f" plain {r['plain_ms']:.4f}")
                    log(f"[27] {name} {dt} {kind} ({path}, k = {k}): bit "
                        f"for bit; ms cold {r['ms']:.4f} warm "
                        f"{r['warm_ms']:.4f}{plain}; bound {bound:.4f} "
                        f"({nbytes} B, {100 * bound / r['ms']:.1f}% cold); "
                        f"{sp.smem} B of shared memory a CTA on {card}")
                rec["sweeps"][f"{kind} {path}"] = r
        # the whole V-cycle at 1 cycle and at the model's cycles
        rec["vcycle"] = {}
        for n_cycles in sorted({1, n_model}):
            plain = TS.make_vcycle_solver(
                lambda v: ell_matvec(op, v), op.diag, plan, sc_inv,
                n_cycles=n_cycles, smooth_k=k, lam_max=lam)
            fused = TS.make_vcycle_solver(
                lambda v: ell_matvec(op, v), op.diag, plan, sc_inv,
                n_cycles=n_cycles, smooth_k=k, lam_max=lam, op=op)
            check(isinstance(fused, TS.FusedVcycle)
                  and fused.sweep_plan.path == picked,
                  f"[27] {name}: make_vcycle_solver(op=) on the card is "
                  f"fused, on the picked path")
            for tag, r in (("aligned", flat[:op.n].clone()),
                           ("odd offset", flat[1:])):
                VC.COUNTS.reset()
                z = fused(r)
                torch.cuda.synchronize()
                n_sweeps = VC.COUNTS.pre + VC.COUNTS.mid + VC.COUNTS.post
                check(torch.equal(z, plain(r)) and torch.equal(z, fused(r))
                      and n_sweeps == VC.launches(n_cycles, k)[0],
                      f"[27] {name} {dt} V-cycle of {n_cycles} ({tag} r): "
                      f"fused equals plain bit for bit and on repeat, "
                      f"{n_sweeps} sweep launches")
            few = TS.FusedVcycle(op, op.diag, plan, sc_inv, lam, n_cycles, k)
            few.sweep_plan = plans["rounds 0"]
            r = flat[:op.n].clone()
            check(torch.equal(few(r), plain(r)),
                  f"[27] {name} {dt} V-cycle of {n_cycles} on the plan of "
                  f"rounds 0: fused equals plain bit for bit")
            del few
            r = flat[:op.n].clone()
            kernels, others = kernel_launches(lambda: fused(r))
            stock = kernel_launches(
                lambda: sc_inv @ fused.rc.view(plan.n_agg,
                                               plan.agg).sum(dim=1))
            sweeps, stated = VC.launches(n_cycles, k)
            check(kernels == sweeps + n_cycles * stock[0] == stated,
                  f"[27] {name} {dt}: a captured V-cycle of {n_cycles} "
                  f"launches {kernels} kernels, its {sweeps} sweeps and "
                  f"{n_cycles} x {stock[0]} of the coarse correction, "
                  f"{stated} stated")
            v = dict(kernels=kernels, other_nodes=others, sweeps=sweeps,
                     stated=stated, coarse_kernels=stock[0])
            if timed:
                v.update(ms=_burst_ms([lambda: fused(r)]),
                         stock_ms=_plain_ms(lambda: plain(r)))
            rec["vcycle"][n_cycles] = v
            times = ("" if not timed else
                     f"; ms per V-cycle fused {v['ms']:.4f}, plain (stock) "
                     f"{v['stock_ms']:.4f}")
            log(f"[27] {name} {dt} V-cycle ({n_cycles} cycle(s), k = {k}, "
                f"n = {op.n}): fused equals plain bit for bit (aligned and "
                f"odd-offset r); captured: {kernels} kernel nodes "
                f"({sweeps} sweeps, {n_cycles} x {stock[0]} of the "
                f"restriction's sum and coarse GEMV; {stated} stated) and "
                f"{others} other nodes{times} on {card}")
        out[f"{name} {dt}"] = rec
    VC.COUNTS.reset()
    log(f"[27] phase {time.perf_counter() - t_phase:.1f} s")
    return out


# phase 28: the block-Jacobi tile rebuild (csrc/bj_tiles.cu) at phase 5's
# end state (1,760 tiles of 256 x 256) and at the NACA step's (274)
BJT_SOURCE = "navierstokes_tpu_torch/csrc/bj_tiles.cu"
# no Pallas kernel: the JAX package lays the rebuild out by hand for the TPU
# and XLA fuses its elementwise work (block_jacobi_tiles; the guard's norm
# and the newton branch of block_jacobi_invert)
BJT_REPLACES = {"bj_tiles": "navierstokes_tpu/ops/p1ell.py:393"}
# rounds of the captured rebuild, the kernels' and the stock chain's
# replays alternating (kernels, stock, stock, kernels per round)
BJT_ROUNDS = 4
BJT_ITERS = 3                 # the model's bj_newton


def rebuild_inputs(ns):
    """The tile rebuild's inputs at the state of a model that has stepped:
    its plan, the step's F values (A0 + the convection of u), the mask,
    sigma and the static seed X0 (the model's ``_bj_seed``)."""
    f = ns.a0_cell + ns._ops.convection(ns.ell, ns._u)
    mflat = ns.bc.mask[:, 0]
    d = ns._ops.f_diag(ns.ell, f)
    sigma = torch.sum(d * mflat) / torch.clamp(torch.sum(mflat), min=1.0)
    return dict(plan=ns._bj_plan, f=f, mask=mflat, sigma=sigma,
                x0=ns._bj_seed())


def stock_guard(ax):
    """The guard's norm as the stock chain took it (torch's row sums)."""
    eye = torch.eye(ax.shape[-1], dtype=torch.float32, device=ax.device)
    return (eye[None] - ax).abs().sum(-1).max()


def stock_rebuild(inp, buf):
    """One Newton-Schulz rebuild as the port ran it before csrc/bj_tiles.cu
    (the stock PyTorch chain, marked as such): the tiles' chain, A X0, the
    guard by torch's sums, three updates 2.0 * x - x (A X), the result made
    row-major in the buffer's dtype and copied into it.  Returns the
    norm."""
    from navierstokes_tpu_torch.kernels import bj_tiles as BT
    a = BT.tiles_plain(inp["plan"], inp["f"], inp["mask"], inp["sigma"])
    x = inp["x0"].to(torch.float32)
    ax = torch.matmul(a, x)
    norm = stock_guard(ax)
    for i in range(BJT_ITERS):
        x = 2.0 * x - torch.matmul(x, ax)
        if i + 1 < BJT_ITERS:
            ax = torch.matmul(a, x)
    buf.copy_(x.to(buf.dtype).contiguous())
    return norm


def kernel_rebuild(inp, buf, partials=None):
    """The same rebuild through ops/p1ell (the tiles kernel of
    csrc/bj_tiles.cu, the products with the guard and the updates in their
    epilogues by csrc/bj_gemm.cu), the last update into ``buf``: segments
    (a) and (b) of the captured step.  Returns the norm."""
    from navierstokes_tpu_torch.ops import p1ell
    g = p1ell.block_jacobi_guard([(inp["plan"], inp["f"], inp["mask"],
                                   inp["sigma"], inp["x0"])], BJT_ITERS,
                                 buf.dtype, partials=partials)
    p1ell.block_jacobi_newton(g, BJT_ITERS, out=[buf])
    return g.norm


def _same_bits(a, b):
    """Equal dtype, shape and strides, NaN at the same places and the
    same bits everywhere else."""
    if a.dtype != b.dtype or a.shape != b.shape or a.stride() != b.stride():
        return False
    na, nb = torch.isnan(a), torch.isnan(b)
    ia, ib = (t.masked_fill(n, 0).contiguous().view(
        {2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])
        for t, n in ((a, na), (b, nb)))
    return torch.equal(na, nb) and torch.equal(ia, ib)


def _bjt_bound(nbytes, ops):
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / FP32_OPS_PER_S * 1e3
    return dict(bound_bytes=nbytes, bound_ops=ops,
                bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations")


def _bjt_time(rec, fn, plain):
    """ms per call of ``fn``: L2-cold (a 128 MB read before each call) and
    warm (back-to-back bursts), and its plain version's (launched
    eagerly)."""
    rec.update(ms=_time_ms(fn, cold=True, n=10),
               warm_ms=_burst_ms([fn], reps=5),
               plain_ms=_plain_ms(plain, n=5, reps=3))


def _captured_ms(fns, rounds=None):
    """Device ms of one replay of each graph of ``fns`` (name -> callable
    captured into a graph), by events, in ``rounds`` (default BJT_ROUNDS)
    alternating rounds (the order reversed every other round); medians
    over the rounds."""
    rounds = rounds or BJT_ROUNDS
    graphs = {}
    for name, fn in fns.items():
        s = torch.cuda.Stream()
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            fn()
        torch.cuda.current_stream().wait_stream(s)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            fn()
        graphs[name] = g
    times = {name: [] for name in fns}
    order = list(fns)
    for r in range(rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            g = graphs[name]
            g.replay()
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(3):
                g.replay()
            b.record()
            b.synchronize()
            times[name].append(a.elapsed_time(b) / 3)
    del graphs
    return {name: statistics.median(t) for name, t in times.items()}, times


def phase_rebuild(name, inp, card, timed=True, rounds=None):
    """Phase 28 at one model's rebuild inputs (``rebuild_inputs``): the tiles
    kernel of csrc/bj_tiles.cu against its plain version on the card, bit
    for bit (from fp32 and fp64 F values); the guard's norm and each
    Newton-Schulz update, the epilogues of csrc/bj_gemm.cu,
    against their plain versions bit for bit (A X0 and the norm; each
    update with its strides and the product after it; the last update in
    fp32, bf16 and fp64); the whole Newton-Schulz rebuild against the
    stock chain's (the same tile inverses; the guard's norm within its
    summation order's gap, the same branch); with ``timed``, the tiles
    kernel's ms per call L2-cold and warm beside its bound and its plain
    version, and the captured rebuild (segments (a) and (b)) against the
    stock chain captured, in alternating rounds.  Phase 30 times the
    GEMM's epilogues."""
    from navierstokes_tpu_torch.kernels import bj_gemm as BG
    from navierstokes_tpu_torch.kernels import bj_tiles as BT
    from navierstokes_tpu_torch.ops.p1ell import GUARD_LIMIT
    plan, f, mask, sigma = inp["plan"], inp["f"], inp["mask"], inp["sigma"]
    SB = plan.S * plan.bu
    n_tiles = plan.n_tiles
    N = n_tiles * SB * SB
    n_on, n_rows = plan.pos.numel(), n_tiles * SB
    out = {}
    # the tiles, from fp32 and fp64 F values
    a = BT.tiles(plan, f, mask, sigma)
    same = {"tiles float32": _same_bits(a, BT.tiles_plain(plan, f, mask,
                                                          sigma))}
    f64, m64, s64 = f.double(), mask.double(), sigma.double()
    same["tiles float64"] = _same_bits(BT.tiles(plan, f64, m64, s64),
                                       BT.tiles_plain(plan, f64, m64, s64))
    # the guard, at A X0
    x = inp["x0"].to(torch.float32)
    ax, norm = BG.guard(a, x)
    want_ax, want_norm = BG.guard_product_plain(a, x)
    same["guard A X0"] = _same_bits(ax, want_ax)
    same["guard"] = _same_bits(norm, want_norm)
    stock = stock_guard(ax)
    gap = abs(float(norm) - float(stock)) / max(abs(float(stock)), 1e-30)
    branch = bool(norm < GUARD_LIMIT)
    check(branch == bool(stock < GUARD_LIMIT),
          f"[28] {name}: the guard's branch equals the stock sums'")
    # the updates and the products between them, the last in each dtype
    layouts = []
    for i in range(BJT_ITERS):
        if i + 1 < BJT_ITERS:
            xk = BG.update(x, ax)
            same[f"update {i + 1}"] = _same_bits(
                xk, BG.update_product_plain(x, ax))
            layouts.append("column" if BT.layout(xk) else "row")
            x = xk
            axk = BG.product(a, x)
            same[f"product {i + 1}"] = _same_bits(axk,
                                                  BG.product_plain(a, x))
            ax = axk
        else:
            for dt in (torch.float32, torch.bfloat16, torch.float64):
                same[f"last update {str(dt).replace('torch.', '')}"] = \
                    _same_bits(BG.update(x, ax, out_dtype=dt),
                               BG.update_product_plain(x, ax, out_dtype=dt))
    # the whole rebuild against the stock chain
    buf_k = torch.empty((n_tiles, SB, SB), device=f.device)
    buf_s = torch.empty_like(buf_k)
    kernel_rebuild(inp, buf_k)
    stock_rebuild(inp, buf_s)
    same["rebuild (Newton-Schulz) against the stock chain"] = _same_bits(
        buf_k, buf_s)
    torch.cuda.synchronize()
    log(f"[28] {name}: {n_tiles} tiles of {SB} x {SB}, {n_on} on-tile "
        f"values; bit for bit against the plain versions: {same}; the "
        f"non-last updates' layout {layouts} (the seed's); guard norm "
        f"{float(norm)!r} (stock sums {float(stock)!r}, gap {gap:.2e} "
        f"relative), branch {'Newton-Schulz' if branch else 'exact'}")
    check(all(same.values()), f"[28] {name}: every kernel gives its plain "
          f"version's bits: {same}")
    check(gap <= 1e-6, f"[28] {name}: the guard's norm within 1e-6 of the "
          f"stock sums' ({gap:.2e})")
    out.update(n_tiles=n_tiles, sb=SB, n_on=n_on, same=same, norm=float(norm),
               stock_norm=float(stock), norm_gap=gap,
               newton=branch, max_abs_err=0.0)
    del ax, x, xk, axk, want_ax
    if not timed:
        return out
    fb = f.element_size()
    # tiles: the stack written once; the on-tile values, pos, src, the row
    # offsets and the mask read once; 4 operations a value
    rec = dict(use=name, **_bjt_bound(
        4 * N + n_on * (fb + 8) + 4 * (n_rows + 1) + plan.n_p2 * fb, 4 * N))
    _bjt_time(rec, lambda: BT.tiles(plan, f, mask, sigma),
              lambda: BT.tiles_plain(plan, f, mask, sigma))
    rec["library_ms"] = None
    log(f"[28] {name} bj_tiles: ms cold {rec['ms']:.4f}, warm "
        f"{rec['warm_ms']:.4f} ({rec['bound_bytes'] / rec['ms'] / 1e6:.0f} "
        f"GB/s cold), bound {rec['bound_ms']:.4f} ({rec['bound_by']}), "
        f"plain {rec['plain_ms']:.4f} on {card}")
    # the rebuild captured: the kernels against the stock chain
    parts = BG.guard_partials(n_tiles, SB, f.device)
    med, all_t = _captured_ms({
        "kernels": lambda: kernel_rebuild(inp, buf_k, [parts]),
        "stock chain": lambda: stock_rebuild(inp, buf_s)}, rounds)
    log(f"[28] {name}: one Newton-Schulz rebuild (segments (a) and (b)) "
        f"captured, ms per replay: kernels {med['kernels']:.4f}, the stock "
        f"chain {med['stock chain']:.4f} (marked as such; medians of "
        f"{len(all_t['kernels'])} alternating rounds {all_t}) on {card}")
    torch.cuda.synchronize()
    check(_same_bits(buf_k, buf_s), f"[28] {name}: the captured rebuilds "
          "agree bit for bit")
    out.update(kernels={"bj_tiles": rec}, rebuild_ms=med["kernels"],
               stock_rebuild_ms=med["stock chain"], rounds=all_t)
    del a, buf_k, buf_s
    return out


# phase 30: the Newton-Schulz products (csrc/bj_gemm.cu) at phase 5's end
# state (1,760 tiles of 256 x 256) and at the NACA step's (274)
BJG_SOURCE = "navierstokes_tpu_torch/csrc/bj_gemm.cu"
# no Pallas kernel: block_jacobi_invert's batched jnp.matmul (A X0 at :491,
# X (A X) at :498, A X at :501), with the guard and the update that XLA
# fuses around them
BJG_REPLACES = {"bj_gemm": "navierstokes_tpu/ops/p1ell.py:501",
                "bj_gemm_guard": "navierstokes_tpu/ops/p1ell.py:491",
                "bj_gemm_update": "navierstokes_tpu/ops/p1ell.py:498"}
# parts of a kernel name that mark a library GEMM in a profiler trace
LIBRARY_GEMM = ("gemm", "xmma", "cutlass", "kernel2", "splitk")


def _bjg_time(name, fn, plain, library, nbytes, ops):
    """One epilogue's record: ms per call L2-cold and warm, its bound, its
    plain version's ms (torch.matmul and the plain pass, eagerly) and
    ``library``'s (torch.matmul alone on the same operands, in bursts)."""
    rec = dict(use=name, **_bjt_bound(nbytes, ops))
    rec.update(ms=_time_ms(fn, cold=True, n=10),
               warm_ms=_burst_ms([fn], reps=3),
               plain_ms=_plain_ms(plain, n=3, reps=3),
               library_ms=_burst_ms([library], reps=3))
    return rec


def rebuild_kernel_names(inp, parts):
    """The device kernels of one eager Newton-Schulz rebuild through
    ops/p1ell, from a torch.profiler trace (empty where the profiler sees
    no device activity)."""
    from torch.profiler import ProfilerActivity, profile
    plan = inp["plan"]
    SB = plan.S * plan.bu
    buf = torch.empty((plan.n_tiles, SB, SB), device="cuda")
    kernel_rebuild(inp, buf, [parts])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        kernel_rebuild(inp, buf, [parts])
        torch.cuda.synchronize()
    names = set()
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0))
        if t > 0:
            names.add(e.key)
    return sorted(names)


def phase_products(name, inp, card):
    """Phase 30 at one model's rebuild inputs: each epilogue of
    csrc/bj_gemm.cu at the operands the step gives it (the guard at A and
    the seed X0, the update at X0 and A X0, the product at A and the first
    update, the last update into the tiles' dtype) against its plain
    version bit for bit; ms per call L2-cold and warm beside the bound,
    the plain version (torch.matmul and the plain pass) and torch.matmul
    alone (``library_ms``), a line where the bare product is the slower;
    each epilogue's CTAs per SM; one eager rebuild profiled: the GEMM's
    kernel and no library GEMM."""
    from navierstokes_tpu_torch.kernels import bj_gemm as BG
    from navierstokes_tpu_torch.kernels import bj_tiles as BT
    t0 = time.perf_counter()
    plan = inp["plan"]
    SB, n = plan.S * plan.bu, plan.n_tiles
    N, ops = n * SB * SB, 2 * n * SB ** 3
    a = BT.tiles(plan, inp["f"], inp["mask"], inp["sigma"])
    x0 = inp["x0"].to(torch.float32)
    parts = BG.guard_partials(n, SB, a.device)
    ax0, norm = BG.guard(a, x0, parts)
    x1 = BG.update(x0, ax0)
    ax1 = BG.product(a, x1)
    want_ax, want_norm = BG.guard_product_plain(a, x0)
    same = {"guard": _same_bits(ax0, want_ax)
            and _same_bits(norm, want_norm),
            "update": _same_bits(x1, BG.update_product_plain(x0, ax0)),
            "product": _same_bits(ax1, BG.product_plain(a, x1))}
    for dt in (torch.float32, torch.bfloat16):
        same[f"last update {str(dt).replace('torch.', '')}"] = _same_bits(
            BG.update(x1, ax1, out_dtype=dt),
            BG.update_product_plain(x1, ax1, out_dtype=dt))
    del want_ax
    lay = {k: "column" if BT.layout(t) else "row"
           for k, t in (("A", a), ("X0", x0), ("A X0", ax0), ("X", x1))}
    log(f"[30] {name}: {n} tiles of {SB} x {SB}, operands {lay}; each "
        f"epilogue bit for bit against its plain version: {same}")
    check(all(same.values()), f"[30] {name}: every epilogue gives its "
          f"plain version's bits: {same}")
    recs = {
        "bj_gemm": _bjg_time(name, lambda: BG.product(a, x1),
                             lambda: BG.product_plain(a, x1),
                             lambda: torch.matmul(a, x1), 12 * N, ops),
        "bj_gemm_guard": _bjg_time(name, lambda: BG.guard(a, x0, parts),
                                   lambda: BG.guard_product_plain(a, x0),
                                   lambda: torch.matmul(a, x0),
                                   12 * N + 8 * parts.numel(), ops),
        "bj_gemm_update": _bjg_time(name, lambda: BG.update(x0, ax0),
                                    lambda: BG.update_product_plain(x0, ax0),
                                    lambda: torch.matmul(x0, ax0), 12 * N,
                                    ops)}
    recs["bj_gemm_guard"]["kernels_per_call"] = 2
    u = recs["bj_gemm_update"]
    u["baddbmm_ms"] = _burst_ms([lambda: torch.baddbmm(
        x0, x0, ax0, beta=2.0, alpha=-1.0)], reps=3)
    u["last"] = {}
    for dt in (torch.float32, torch.bfloat16, torch.float64):
        buf = torch.empty((n, SB, SB), dtype=dt, device=a.device)
        u["last"][str(dt).replace("torch.", "")] = dict(
            ms=_burst_ms([lambda: BG.update(x1, ax1, out=buf)], reps=3),
            **_bjt_bound((8 + buf.element_size()) * N, ops))
        del buf
    occupancy = {e: BG.occupancy(SB, e) for e in BG.EPILOGUES}
    for k, r in recs.items():
        r["ctas_per_sm"] = occupancy[{"bj_gemm": "product",
                                      "bj_gemm_guard": "guard",
                                      "bj_gemm_update": "update"}[k]]
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
        extra = ""
        if k == "bj_gemm_update":
            extra = ("; torch.baddbmm (2 X - X (A X) in one call) "
                     f"{r['baddbmm_ms']:.4f}; last update ms " + ", ".join(
                         f"{d} {v['ms']:.4f}" for d, v in r["last"].items()))
        log(f"[30] {name} {k}: ms cold {r['ms']:.4f}, warm "
            f"{r['warm_ms']:.4f}, bound {r['bound_ms']:.4f} "
            f"({r['bound_by']}, {r['share_of_bound']:.0%} of it cold), plain "
            f"{r['plain_ms']:.4f}, torch.matmul {r['library_ms']:.4f}, "
            f"{r['ctas_per_sm']} CTAs an SM{extra} on {card}")
    p = recs["bj_gemm"]
    if p["warm_ms"] > p["library_ms"]:
        log(f"[30] {name}: the bare product ({p['warm_ms']:.4f} ms warm) is "
            f"slower than torch.matmul ({p['library_ms']:.4f} ms) at these "
            f"tiles")
    names = rebuild_kernel_names(inp, parts)
    library = [k for k in names if "bj_gemm_kernel" not in k
               and any(w in k.lower() for w in LIBRARY_GEMM)]
    log(f"[30] {name}: one eager Newton-Schulz rebuild's device kernels "
        f"(torch.profiler): {names}")
    if names:
        check(not library and any("bj_gemm_kernel" in k for k in names),
              f"[30] {name}: the rebuild runs csrc/bj_gemm.cu and no "
              f"library GEMM ({library})")
    else:
        log(f"[30] {name}: the profiler saw no device kernels; the launch "
            f"counts stand alone")
    seconds = time.perf_counter() - t0
    log(f"[30] {name} part {seconds:.1f} s")
    del a, x0, x1, ax0, ax1
    return dict(n_tiles=n, sb=SB, same=same, layouts=lay, kernels=recs,
                profiled_kernels=names, seconds=seconds)


# phase 29: the exact tile inverse (csrc/bj_inverse.cu) at phase 5's end
# state (1,760 tiles of 256 x 256, a state whose steps take the exact
# branch), at the NACA step's (274) and at the edges
BJI_SOURCE = "navierstokes_tpu_torch/csrc/bj_inverse.cu"
# no Pallas kernel: jnp.linalg.inv under block_jacobi_invert's lax.cond
# (XLA's batched LU)
BJI_REPLACES = "navierstokes_tpu/ops/p1ell.py:506"
BJI_BATCHES = (1, 7, 132, 1760)
BJI_SAMPLE = 64               # tiles inverted in float64 beside the gaps
BJI_ROUNDS = 4                # rounds of the captured segment b_exact


def _bji_seeded(sb, n, seed):
    """Seeded tiles, diagonally dominant like F's."""
    rng = np.random.default_rng(seed)
    return (np.eye(sb)[None] * (2.0 + rng.uniform(size=(n, sb, 1)))
            + rng.standard_normal((n, sb, sb)) / np.sqrt(sb))


def _bji_edges():
    """(label, fp32 tiles on the card): SB 64, 128 and 512 (and a one-tile
    batch of each), and at SB 256 a tile that needs row swaps (no
    diagonal dominance), one with a zero leading entry, one with a NaN,
    a singular one and one of 16 x 16 Hadamard blocks (rows permuted and
    signed: every column's candidates tie)."""
    out = []
    for sb, n in ((64, 37), (128, 19), (512, 5)):
        t = _bji_seeded(sb, n, sb)
        out += [(f"SB {sb}, {n} tiles", t), (f"SB {sb}, one tile", t[:1])]
    rng = np.random.default_rng(29)
    sb = 256
    swaps = rng.standard_normal((sb, sb))
    zero = _bji_seeded(sb, 1, 3)[0]
    zero[0, 0] = 0.0
    nan = _bji_seeded(sb, 1, 4)[0]
    nan[17, 200] = np.nan
    singular = _bji_seeded(sb, 1, 5)[0]
    singular[:, 100] = 0.0
    h = np.ones((1, 1))
    while h.shape[0] < 16:
        h = np.block([[h, h], [h, -h]])
    ties = (np.kron(np.eye(sb // 16), h)[rng.permutation(sb)]
            * rng.choice([-1.0, 1.0], (sb, 1)))
    out.append(("SB 256: swaps, zero leading entry, NaN, singular, ties",
                np.stack([swaps, zero, nan, singular, ties])))
    return [(lab, torch.as_tensor(t, dtype=torch.float32, device="cuda"))
            for lab, t in out]


def _bji_residual(a, x):
    """max over the tiles of the max row sum of |I - A X|, in float64."""
    eye = torch.eye(a.shape[-1], dtype=torch.float64, device=a.device)
    worst = 0.0
    for i in range(0, a.shape[0], 256):
        r = eye - torch.matmul(a[i:i + 256].double(), x[i:i + 256].double())
        worst = max(worst, float(r.abs().sum(-1).amax()))
    return worst


def phase_inverse(name, a, card, edges=False, rounds=None):
    """Phase 29 at one model's fp32 tiles ``a`` (the exact branch's
    input): csrc/bj_inverse.cu's kernel against its plain version bit for
    bit (fp32, bf16 and fp64 out, a strided slot of a larger buffer, with
    ``edges`` the edge stacks of ``_bji_edges``), batch independence,
    against cuSOLVER's inverse (the parent's route) and a float64 one of
    BJI_SAMPLE sampled tiles, ms per call L2-cold and warm beside its
    bound, the rounding rule's floor, the plain version's ms (once), the
    library's (cuSOLVER with the parent's two copies; the default
    torch.linalg.inv); the captured segment b_exact against the parent's
    chain captured, in ``rounds`` (default BJI_ROUNDS) alternating
    rounds."""
    from navierstokes_tpu_torch.kernels import bj_inverse as BI
    from navierstokes_tpu_torch.ops import p1ell
    t0 = time.perf_counter()
    n, sb = a.shape[0], a.shape[-1]
    BI.COUNTS.reset()
    x = BI.inverse(a)
    t_plain = time.perf_counter()
    plain = BI.inverse_plain(a)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t_plain
    same = {"float32": _same_bits(x, plain)}
    for dt in (torch.bfloat16, torch.float64):
        same[str(dt).replace("torch.", "")] = _same_bits(
            BI.inverse(a, out_dtype=dt), plain.to(dt))
    m = min(n, 132)
    big = torch.full((2, m, sb, sb + 16), 7.0, device=a.device)
    slot = big[1, :, :, :sb]
    BI.inverse(a[:m], out=slot)
    same["strided slot"] = (_same_bits(slot.contiguous(), plain[:m])
                            and bool((big[0] == 7).all())
                            and bool((big[1, :, :, sb:] == 7).all()))
    del big, slot
    if edges:
        for lab, t in _bji_edges():
            same[lab] = _same_bits(BI.inverse(t), BI.inverse_plain(t))
            if lab.startswith("SB 256"):
                k = BI.inverse(t)
                perm = BI.gauss_jordan_plain(t)[1]
                flags = dict(
                    swaps=bool((perm[0] != torch.arange(
                        sb, device=t.device)).any()),
                    zero_leading_moved=int(perm[1, 0]) != 0,
                    nan_all=bool(torch.isnan(k[2]).all()),
                    singular_non_finite=not bool(torch.isfinite(k[3]).all()),
                    ties_finite=bool(torch.isfinite(k[4]).all()),
                    others_finite=bool(torch.isfinite(k[[0, 1]]).all()))
                log(f"[29] edge tiles: {flags}")
                check(all(flags.values()), f"[29] the edge tiles: {flags}")
    batch = {b: _same_bits(BI.inverse(a[:b]), x[:b])
             for b in BJI_BATCHES if b <= n}
    # against cuSOLVER (the parent's route) and float64
    cus = p1ell._inv_capturable(a)
    gap = float((x - cus).abs().max() / cus.abs().max())
    res_k, res_c = _bji_residual(a, x), _bji_residual(a, cus)
    idx = torch.linspace(0, n - 1, min(n, BJI_SAMPLE),
                         device=a.device).long()
    x64 = torch.linalg.inv(a[idx].double())
    s64 = float(x64.abs().max())
    gap64 = {"kernel": float((x[idx].double() - x64).abs().max()) / s64,
             "cuSOLVER": float((cus[idx].double() - x64).abs().max()) / s64}
    res64 = _bji_residual(a[idx], x64)
    res_s = {"kernel": _bji_residual(a[idx], x[idx]),
             "cuSOLVER": _bji_residual(a[idx], cus[idx])}
    torch.cuda.synchronize()
    log(f"[29] {name}: {n} tiles of {sb} x {sb}; bit for bit against "
        f"inverse_plain: {same}; batch-independent (inverse(a[:b]) == "
        f"inverse(a)[:b]): {batch}; the kernel against cuSOLVER's inverse: "
        f"max gap {gap:.3e} of max|inv|; max tile residual |I - A X| "
        f"kernel {res_k:.3e}, cuSOLVER {res_c:.3e}; {len(idx)} sampled "
        f"tiles against a float64 inverse: gaps {gap64}, residuals {res_s} "
        f"(float64 {res64:.3e}); plain version {plain_s:.2f} s")
    check(all(same.values()), f"[29] {name}: the kernel gives "
          f"inverse_plain's bits: {same}")
    check(all(batch.values()), f"[29] {name}: batch-independent: {batch}")
    check(gap < 1e-4, f"[29] {name}: within 1e-4 of cuSOLVER's inverse "
          f"({gap:.3e})")
    check(res_k <= 2 * res_c, f"[29] {name}: residual {res_k:.3e} at most "
          f"2x cuSOLVER's {res_c:.3e}")
    del plain, x64
    # timings
    N = n * sb * sb
    out = torch.empty_like(a)
    rec = dict(use=name, n_tiles=n, sb=sb, same=same, batch=batch,
               cusolver_gap=gap, residual=res_k, cusolver_residual=res_c,
               f64_gaps=gap64, f64_residuals=res_s, f64_residual=res64,
               **_bjt_bound(8 * N, 2 * n * sb ** 3))
    rec["floor_ms"] = 2 * rec["bound_ops"] / FP32_OPS_PER_S * 1e3
    fn = lambda: BI.inverse(a, out=out)
    rec["ms"] = _time_ms(fn, cold=True, n=10)
    rec["warm_ms"] = _burst_ms([fn], reps=3)
    rec["plain_ms"] = _time_ms(lambda: BI.inverse_plain(a), cold=False, n=1)
    dt = torch.float32
    chain = lambda: out.copy_(p1ell._inv_capturable(a).to(dt).contiguous())
    rec["library_ms"] = _time_ms(chain, cold=True, n=5)
    rec["cusolver_ms"] = _time_ms(lambda: p1ell._inv_capturable(a),
                                  cold=True, n=5)
    rec["torch_inv_ms"] = _time_ms(lambda: torch.linalg.inv(a), cold=True,
                                   n=3)
    rec["clusters_in_flight"] = BI.max_clusters(sb)
    # the captured segment b_exact against the parent's chain
    g = p1ell.BjGuard(tiles=[a], xs=[], axs=[], norm=None, out_dtype=dt)
    buf_k, buf_p = torch.empty_like(a), torch.empty_like(a)
    exact0 = p1ell.BJ_INVERSIONS["exact"]
    med, all_t = _captured_ms({
        "kernel (segment b_exact)":
            lambda: p1ell.block_jacobi_exact(g, out=[buf_k]),
        "parent chain (cuSOLVER, .contiguous(), copy_)":
            lambda: buf_p.copy_(p1ell._inv_capturable(a).to(dt)
                                .contiguous())}, rounds or BJI_ROUNDS)
    p1ell.BJ_INVERSIONS["exact"] = exact0
    torch.cuda.synchronize()
    check(_same_bits(buf_k, x), f"[29] {name}: the captured segment gives "
          "the eager kernel's bits")
    rec.update(segment_ms=med, segment_rounds=all_t)
    waves = n / rec["clusters_in_flight"]
    log(f"[29] {name}: ms cold {rec['ms']:.4f}, warm {rec['warm_ms']:.4f}, "
        f"bound {rec['bound_ms']:.4f} ({rec['bound_by']}), the rounding "
        f"rule's floor {rec['floor_ms']:.4f} (every product and difference "
        f"its own instruction); plain {rec['plain_ms']:.2f}; library: "
        f"cuSOLVER with the parent's two copies {rec['library_ms']:.4f} "
        f"(cuSOLVER alone {rec['cusolver_ms']:.4f}), torch.linalg.inv "
        f"{rec['torch_inv_ms']:.4f}; clusters in flight "
        f"{rec['clusters_in_flight']} ({waves:.2f} waves of {sb // 64} CTAs "
        f"a tile); captured, ms per replay {med} (medians of "
        f"{len(all_t['kernel (segment b_exact)'])} alternating rounds "
        f"{all_t}) on {card}")
    check(rec["ms"] < rec["library_ms"], f"[29] {name}: the kernel "
          f"({rec['ms']:.4f} ms L2-cold) is faster than cuSOLVER with the "
          f"parent's two copies ({rec['library_ms']:.4f} ms)")
    if sb == 256:
        sms = torch.cuda.get_device_properties(a.device).multi_processor_count
        check(rec["clusters_in_flight"] * (sb // 64) > sms,
              f"[29] {name}: two CTAs an SM ({rec['clusters_in_flight']} "
              f"clusters of {sb // 64} CTAs on {sms} SMs)")
    log(f"[29] {name} part {time.perf_counter() - t0:.1f} s")
    del x, cus, out, buf_k, buf_p
    gc.collect()
    torch.cuda.empty_cache()
    return rec


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
    lap_div = laplacian_divergence(ns, bench)     # phase 25's yardstick
    variants = phase_kernel_vs_plain(ns, (torch.bfloat16, torch.float64),
                                     "6")
    sharded = phase_sharded(ns, bench, card)
    t28 = time.perf_counter()
    _load_state(ns, bench["end"])
    inp = rebuild_inputs(ns)
    rb_bench = phase_rebuild("bench", inp, card)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[28] bench part {time.perf_counter() - t28:.1f} s")
    gemm_bench = phase_products("bench", inp, card)
    gc.collect()
    torch.cuda.empty_cache()
    from navierstokes_tpu_torch.kernels import bj_tiles
    inv_bench = phase_inverse("bench", bj_tiles.tiles(
        inp["plan"], inp["f"], inp["mask"], inp["sigma"]), card, edges=True)
    del inp
    # phase 24's projection tiles, on the host until then
    proj_tiles = ns._graphs.tiles.cpu()
    # phase 27's bench operator: the outlet-pinned Laplacian and its
    # V-cycle parts
    lap_bench = vcycle_parts(ns, "ap_dir")
    del ns
    gc.collect()
    torch.cuda.empty_cache()
    small = phase_monolithic_small()
    mono = phase_monolithic_bench(card)
    mono_graphs = phase_monolithic_graphs(mono, card)
    bj_bench = phase_tile_apply_bench(proj_tiles, mono, {
        "projection captured (phase 5)": bench["bj_per_step"],
        "projection eager / captured (phase 21)": [
            r["bj"] for r in graphs["runs"]],
        "row shards (phase 20)": sharded["bj_per_step"],
        "monolithic captured (phase 8)": mono["bj_per_step"],
        "monolithic captured / eager (phase 22)": [
            r["bj"] for r in mono_graphs["runs"]]}, card)
    del mono["ns"], proj_tiles
    gc.collect()
    torch.cuda.empty_cache()
    t25 = time.perf_counter()
    options = phase_options_bench(bench, mono, lap_div, card)
    options_small = phase_options_small()
    log(f"[25] phase {time.perf_counter() - t25:.1f} s")
    kry = phase_krylov_kernels(card, bench["cg_iteration"])
    small3d = phase_small_3d()
    ns3, st3d1 = phase_3d1(card)
    uses3d = phase_kernel_3d(ns3)
    bj_3d1 = phase_tile_apply_3d1(ns3)
    lap_3d1 = vcycle_parts(ns3, "ap_dir")
    del ns3
    gc.collect()
    torch.cuda.empty_cache()
    phase_cli()
    phase_naca_small()
    naca = phase_naca_sweep(card)
    uses_naca, bj_naca, ap_naca, rb_naca = phase_kernel_naca()
    vc = phase_vcycle(card, {"bench": lap_bench, "3d1": lap_3d1,
                             "naca": ap_naca})
    del lap_bench, lap_3d1, ap_naca
    log(f"[24] tile-apply launches per step, NACA sweep (phase 14, "
        f"captured): {naca['bj_per_step']:.2f}")
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
             "sharded": sharded["per_step"],
             **{tag: o["per_step"] for tag, o in options.items()}}
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
             bench["launches"] + mono["launches"] + sharded["launches"]
             + sum(o["launches"] for o in options.values()),
             REPLACES),
            (torch.bfloat16, small["cc+inner_bf16"]["launches_bf16"],
             REPLACES_BF16),
            (torch.float64, small["cc+refine=2"]["launches_f64"], None)):
        uses = (fp32 if dt == torch.float32 else variants)[dt]
        kernels.append(entry(dt, uses, launches, replaces))
    kernels[0]["rebuild_ms"] = fp32["rebuild_ms"]
    kernels[0]["floor_ms"] = fp32["floor_ms"]
    kernels[0]["stokes"] = stokes
    kernels[0]["options"] = {tag: {k: v for k, v in o.items() if k != "bj"}
                             for tag, o in options.items()}
    kernels[0]["options_small_launches"] = {
        tag: {f"{str(dt).replace('torch.', '')} D={D}": n
              for (dt, D), n in c.items()}
        for tag, c in options_small.items()}
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
    # the while nodes' predicate kernel: launches on the same path
    nd = mono_graphs["nodes"]
    kernels.append({
        "name": "set_condition", "route": "cuda", "source": COND_SOURCE,
        "replaces": COND_REPLACES, "launches": mono["set_condition"],
        "max_abs_err": float(nd["max_abs_err"]),
        **{k: nd[k] for k in ("ms", "plain_ms", "bound_ms", "host_read_ms",
                              "while_iteration_ms", "plain_graph_ms",
                              "givens_sets_condition_ms")},
        "bound_by": "bytes", "library_ms": None,
        "launches_per_captured_step": mono["set_condition"] / mono["n_steps"],
        "launches_per_step_projection": bench["set_condition_per_step"],
        "whiles_per_step": {"projection": bench["whiles"],
                            "monolithic": mono["whiles"]},
        "capture": {k: v for k, v in mono["capture"].items()},
        "capture_projection": {k: bench[k] for k in (
            "capture_s", "capture_peak_bytes", "reserved_growth_bytes")}})
    kernels[0]["graphs"] = {k: graphs[k] for k in ("runs", "peak_bytes",
                                                   "capture_s",
                                                   "inverse_gap")}
    kernels[0]["monolithic_graphs"] = {
        "runs": mono_graphs["runs"], "peak_bytes": mono_graphs["peak_bytes"],
        **mono["capture"]}
    # the tile apply: launches on the main paths (phases 5, 8, 20; bf16 on
    # phase 7's inner_bf16 path; fp64 on phase 24's float64 steps), the
    # uses at the bench point (headline: the monolithic step's tiles),
    # 3D-1Z and NACA
    f32, bf16, f64 = torch.float32, torch.bfloat16, torch.float64
    bj_uses = {f32: bj_bench[f32] + [bj_3d1[0], bj_naca],
               bf16: bj_bench[bf16] + [bj_3d1[1]], f64: bj_bench[f64]}
    bj_launches = {
        f32: sum(p["bj"].get((f32, 2), 0)
                 for p in (bench, mono, sharded, *options.values())),
        bf16: small["cc+inner_bf16"]["bj"].get((bf16, 2), 0),
        f64: bj_bench["f64_launches"]}
    bj_paths = {"projection": bench["bj_per_step"],
                "monolithic": mono["bj_per_step"],
                "sharded": sharded["bj_per_step"],
                "naca": naca["bj_per_step"],
                **{tag: o["bj_per_step"] for tag, o in options.items()}}
    for dt, replaces in ((f32, BJ_REPLACES), (bf16, BJ_REPLACES_BF16),
                         (f64, None)):
        uses = bj_uses[dt]
        head = uses[1] if dt != f64 else uses[0]
        kernels.append({
            "name": BJ_VARIANTS[dt][0], "route": "cuda",
            "source": BJ_SOURCE, "replaces": replaces,
            "launches": bj_launches[dt],
            "max_abs_err": max(u["max_abs_err"] for u in uses),
            **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "bound_bytes", "library_ms")},
            "launches_per_step": bj_paths if dt == f32 else None,
            "uses": uses, "edges": bj_bench["edges"][BJ_VARIANTS[dt][0]]})
    # the Krylov loops' kernels: launches on the main paths (phases 5 and
    # 8, captured), per step on each captured path, phase 26's figures at
    # the bench shapes (fp32; fp64 beside)
    kry_paths = {"projection": bench["kry_per_step"],
                 "monolithic": mono["kry_per_step"],
                 **{tag: o["kry_per_step"] for tag, o in options.items()}}
    for stage, rec in kry["stages"].items():
        head = rec["float32"]
        kernels.append({
            "name": f"krylov_{stage}", "route": "cuda", "source": KRY_SOURCE,
            "replaces": KRY_REPLACES[stage],
            "launches": sum(round(p["kry_per_step"][stage] * p["n_steps"])
                            for p in (bench, mono)),
            **{k: head[k] for k in ("max_abs_err", "ms", "warm_ms",
                                    "plain_ms", "bound_ms", "bound_by",
                                    "bound_bytes", "library_ms", "n",
                                    "replaced_dots_ms", "bit_equal_draws")},
            "fp64": rec["float64"],
            "launches_per_captured_iteration": rec.get(
                "launches_per_captured_iteration"),
            "launches_per_step": {p: c[stage] for p, c in kry_paths.items()},
            "launches_per_step_by_path": {
                p: {k.split(":")[1]: v for k, v in c.items()
                    if k.startswith(stage + ":")}
                for p, c in kry_paths.items()}})
    gs = kry["gs"]
    mean = lambda key: statistics.mean(r[key] for r in gs["float32"])
    kernels.append({
        "name": "gram_schmidt", "route": "cuda", "source": GS_SOURCE,
        "replaces": GS_REPLACES,
        "launches": round(mono["kry_per_step"]["gram_schmidt"]
                          * mono["n_steps"]),
        "kernels_per_launch": gs["float32"][0]["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in gs["float32"]),
        "ms": mean("ms"), "plain_ms": mean("plain_ms"),
        "bound_ms": mean("bound_ms"),
        "bound_by": gs["float32"][-1]["bound_by"],
        "library_ms": mean("library_ms"),
        "whole_basis_ms": mean("whole_basis_ms"),
        "headline": f"means over j in {list(GS_JS)}, fp32",
        "uses": gs,
        "launches_per_step": {p: c["gram_schmidt"]
                              for p, c in kry_paths.items()}})
    # the V-cycle's sweeps: launches on the main paths (phases 5 and 8,
    # captured), per step on each captured path, phase 27's figures (the
    # bench Laplacian in fp32 on the picked path; the other paths, fp64,
    # 3D-1Z and NACA beside)
    head_set = vc["bench float32"]
    for kind in ("pre", "mid", "post"):
        head = head_set["sweeps"][f"{kind} {head_set['picked']}"]
        launched = sum(round(p["kry_per_step"][f"vcycle_{kind}"]
                             * p["n_steps"]) for p in (bench, mono))
        check(launched > 0, f"the {kind} sweep launched on the main paths "
              f"(phases 5 and 8: {launched})")
        kernels.append({
            "name": f"vcycle_{kind}", "route": "cuda", "source": VC_SOURCE,
            "replaces": VC_REPLACES[kind],
            "launches": launched,
            "max_abs_err": max(r["max_abs_err"] for rec in vc.values()
                               for lab, r in rec["sweeps"].items()
                               if lab.split()[0] == kind),
            **{k: head[k] for k in ("ms", "warm_ms", "plain_ms", "bound_ms",
                                    "bound_by", "bound_bytes", "library_ms",
                                    "path", "smem")},
            "headline": f"{kind} on the bench Laplacian, fp32, k = "
                        f"{head_set['k']}, {head_set['picked']} path",
            "calls": {key: {lab: r for lab, r in rec["sweeps"].items()
                            if lab.split()[0] == kind}
                      for key, rec in vc.items()},
            "plans": {key: rec["plans"] for key, rec in vc.items()},
            "vcycle": {key: rec["vcycle"] for key, rec in vc.items()},
            "launches_per_step": {p: c[f"vcycle_{kind}"]
                                  for p, c in kry_paths.items()}})
    # the tile rebuild: launches on the main paths (phases 5, 8, 20, 25;
    # per step also on phase 14's NACA sweep), phase 28's figures (phase
    # 5's end state, fp32; the NACA step's tiles beside)
    rb_paths = {"projection": bench["kry_per_step"],
                "monolithic": mono["kry_per_step"],
                "sharded": sharded["rebuild_per_step"],
                "naca": {f"rebuild:{k}": v
                         for k, v in naca["rebuild_per_step"].items()},
                **{tag: o["kry_per_step"] for tag, o in options.items()}}
    windows = ([(bench["kry_per_step"], bench["n_steps"]),
                (mono["kry_per_step"], mono["n_steps"]),
                (sharded["rebuild_per_step"], SHARD_STEPS)]
               + [(o["kry_per_step"], OPTION_STEPS)
                  for o in options.values()])

    def rebuild_of(c, kinds):
        return {k.split(":")[1]: v for k, v in c.items()
                if k.startswith("rebuild:")
                and k.split(":")[1].split()[0] in kinds}

    rb_recs = {"bj_tiles": (BJT_SOURCE, BJT_REPLACES["bj_tiles"],
                            ("tiles",), rb_bench["kernels"]["bj_tiles"],
                            rb_naca["kernels"]["bj_tiles"]),
               **{k: (BJG_SOURCE, BJG_REPLACES[k], kinds,
                      gemm_bench["kernels"][k],
                      rb_naca["products"]["kernels"][k])
                  for k, kinds in (("bj_gemm", ("product",)),
                                   ("bj_gemm_guard", ("guard",)),
                                   ("bj_gemm_update", ("update",
                                                       "update_last")))}}
    for name, (source, replaces, kinds, head, naca_rec) in rb_recs.items():
        launched = sum(round(v * n) for c, n in windows
                       for v in rebuild_of(c, kinds).values())
        check(launched > 0, f"{name} launched on the main paths (phases 5, "
              f"8, 20, 25: {launched})")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launched,
            "max_abs_err": 0.0,
            **{k: head[k] for k in ("ms", "warm_ms", "plain_ms", "bound_ms",
                                    "bound_by", "bound_bytes",
                                    "library_ms")},
            "headline": f"phase 5's end state, {rb_bench['n_tiles']} tiles "
                        f"of {rb_bench['sb']} x {rb_bench['sb']}, fp32, "
                        "ms L2-cold"
                        + ("" if name == "bj_tiles" else
                           "; library_ms: torch.matmul of the same "
                           "operands"),
            "uses": {"bench": head, "naca": naca_rec},
            "launches_per_step": {p: rebuild_of(c, kinds)
                                  for p, c in rb_paths.items()}})
        if name == "bj_tiles":
            tiles_entry = kernels[-1]
    tiles_entry["rebuild"] = {
        key: {k: rb[k] for k in ("n_tiles", "rebuild_ms",
                                 "stock_rebuild_ms", "rounds", "norm",
                                 "stock_norm", "norm_gap", "newton")}
        for key, rb in (("bench", rb_bench), ("naca", rb_naca))}
    tiles_entry["tile_inverses_per_step"] = {
        "projection (phase 5)": bench["branch"],
        "monolithic (phase 8)": mono["branch"],
        "monolithic (phase 22)": mono_graphs["branch"]}
    next(k for k in kernels if k["name"] == "bj_gemm")["profiled_kernels"] = {
        "bench": gemm_bench["profiled_kernels"],
        "naca": rb_naca["products"]["profiled_kernels"]}
    # the exact tile inverse: launches on the main paths' exact steps
    # (phases 5, 8, 20, 25; per step also on phase 14's NACA sweep), phase
    # 29's figures (phase 5's end state; the NACA step's tiles beside)
    launched = sum(round(v * n) for c, n in windows
                   for v in rebuild_of(c, ("inverse",)).values())
    check(launched > 0, f"bj_inverse launched on the main paths (phases 5, "
          f"8, 20, 25: {launched})")
    kernels.append({
        "name": "bj_inverse", "route": "cuda", "source": BJI_SOURCE,
        "replaces": BJI_REPLACES, "launches": launched, "max_abs_err": 0.0,
        **{k: inv_bench[k] for k in ("ms", "warm_ms", "plain_ms", "bound_ms",
                                     "bound_by", "bound_bytes", "bound_ops",
                                     "floor_ms", "library_ms", "cusolver_ms",
                                     "torch_inv_ms", "cusolver_gap",
                                     "residual", "cusolver_residual",
                                     "clusters_in_flight", "segment_ms")},
        "headline": f"phase 5's end state, {inv_bench['n_tiles']} tiles of "
                    f"{inv_bench['sb']} x {inv_bench['sb']}, fp32 out, ms "
                    "L2-cold; library_ms: cuSOLVER's inverse with the "
                    "parent's two copies",
        "uses": {"bench": inv_bench, "naca": rb_naca["inverse"]},
        "launches_per_step": {p: rebuild_of(c, ("inverse",))
                              for p, c in rb_paths.items()}})
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
