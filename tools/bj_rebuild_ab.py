"""The block-Jacobi tile rebuild on one card: the stock PyTorch chain the
port ran before csrc/bj_tiles.cu against the kernels, in one process.

    python3 tools/bj_rebuild_ab.py [--cases bench mono naca] [--rounds 8]
        [--steps 2] [--exact | --gemm PARENT_SOURCE] [--json PATH]

For each case it builds the model, steps it ``--steps`` times and takes
the rebuild's inputs at that state (``chip_smoke.rebuild_inputs``: the
plan, the F values A0 + C(u), the mask, sigma and the static seed X0):

* ``bench``: ``chip_smoke.py``'s projection bench point (Schaefer-Turek
  2D-2, 1,014,414 DoF, fp32, BDF2): 1,760 tiles of 256 x 256;
* ``mono``: the same mesh in monolithic ``cc`` (BDF1), phase 8's model;
* ``naca``: the ``sweep-naca`` step (2d-naca at h=0.02, 0 degrees,
  monolithic ``cc``): 274 tiles;
* ``random`` (``--exact`` only): 1,760 seeded tiles of 256 x 256, N(0, 1)
  / 16 + 4 I in fp32 (numpy's default_rng(1)), no model, with phase 29's
  edge stacks.

Then, at those inputs:

* each pass of the stock chain alone, ms per call (CUDA events around
  bursts of 3, median of 5): the tiles' new_zeros, scatter, the two mask
  products, the diagonal's product and the sum; A X0; the guard's I - A X,
  abs, row sums and max; an update's 2.0 * x, the product X (A X) and the
  difference; the last update's row-major copy and the copy into the
  captured step's buffer;
* ``chip_smoke.phase_rebuild`` (phase 28): every kernel against its plain
  version bit for bit, the Newton-Schulz rebuild against the stock
  chain's, the tiles kernel's ms L2-cold and warm beside its bound and its
  plain version; and one rebuild (segments (a) and (b)) captured, the
  kernels' graph against the stock chain's in ``--rounds`` alternating
  rounds;
* ``chip_smoke.phase_products`` (phase 30): each epilogue of the GEMM
  (csrc/bj_gemm.cu) against its plain version bit for bit, its ms
  L2-cold and warm beside its bound, its plain version and torch.matmul,
  the update beside ``torch.baddbmm``, and one eager rebuild's kernels
  from the profiler.

With ``--exact`` it measures the exact branch instead, at the same tiles
(the exact inverse's input): ``chip_smoke.phase_inverse`` (phase 29), the
kernel of csrc/bj_inverse.cu against its plain version bit for bit, the
output dtypes, batch independence, its gap and residual against cuSOLVER's
inverse, its ms L2-cold and warm beside its bound, the rounding rule's
floor, the plain version and the libraries (cuSOLVER with the parent's
two copies, torch.linalg.inv), and segment b_exact captured, the kernel's
graph against the parent's chain (cuSOLVER, ``.contiguous()``, ``copy_``)
captured, in ``--rounds`` alternating rounds.

With ``--gemm PARENT_SOURCE`` it measures the Newton-Schulz products
instead: the parent's chain (cuBLAS's product through ``torch.matmul``,
then the standalone pass of the parent's csrc/bj_tiles.cu that read the
product back: the guard's two kernels, the update) against the epilogues of
csrc/bj_gemm.cu that replaced them, at each case's inputs, with the
parent's operand layouts (its seed column-major) and the change's (the
seed row-major).  The copy on the card is no git repository, so take the
parent's source here first:

    git show cd1de2b:navierstokes_tpu_torch/csrc/bj_tiles.cu \
        > build/bj_tiles_parent.cu
    python3 tools/bj_rebuild_ab.py --gemm build/bj_tiles_parent.cu \
        [--cases bench mono naca] [--rounds 8]

It builds that file alone with nvcc and binds its ``nst_bj_guard`` and
``nst_bj_update``, then for each case: each pass of the parent alone (the
products, the guard's pass, the update's pass); the guard, the update,
the product and the last update of both, L2-cold and warm, in
``--rounds`` rounds of parent, change, change, parent; bits compared (the
GEMM sums as cuBLAS's batched kernel does, so they are equal); and one
Newton-Schulz rebuild (segments (a) and (b)) captured, the parent's chain
against the change's, in alternating rounds (about 1 min a case).

It prints the card's name and power limit first, and as its last line one
JSON object with every figure.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as CS  # noqa: E402


# calls of a pass in one Newton-Schulz rebuild of 3 updates (others: 1)
WEIGHTS = {"GEMM A X0": 3, "update: 2.0 * x": 3, "update: GEMM X (A X)": 3,
           "update: - X (A X)": 3}


def model(case):
    """The case's model, set up (not stepped)."""
    if case == "bench":
        return CS.bench_model("cuda").setup()
    if case == "mono":
        return CS.bench_model("cuda", scheme="monolithic",
                              preconditioner="cc").setup()
    from navierstokes_tpu_torch.scenarios.registry import build_solver
    return build_solver("2d-naca", config=CS._config(os.path.join(
        CS.WORK, "bj_rebuild_ab_naca"), "float32"), device="cuda").setup()


def pass_ms(fn, reps=5, n=3):
    """Median device ms of one call of ``fn`` over ``reps`` bursts of
    ``n`` calls, each burst between two CUDA events, after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def stock_passes(inp):
    """ms per call of each pass of the stock chain (see the module
    docstring), in the order the chain runs them."""
    import torch.nn.functional as Fn
    plan, f, mask, sigma = inp["plan"], inp["f"], inp["mask"], inp["sigma"]
    SB = plan.S * plan.bu
    n = plan.n_tiles * SB
    pos, src = plan.pos.long(), plan.src.long()
    t0 = f.new_zeros(n * SB)
    t0[pos] = f[src]
    t = t0.view(plan.n_tiles, SB, SB)
    m = Fn.pad(mask, (0, n - plan.n_p2)).reshape(plan.n_tiles, SB)
    tm = t * m[:, :, None]
    tmm = tm * m[:, None, :]
    eye = torch.eye(SB, dtype=t.dtype, device=t.device)
    d = (sigma * (1.0 - m))[:, :, None] * eye[None]
    a = (tmm + d).to(torch.float32)
    x = inp["x0"].to(torch.float32)
    ax = torch.matmul(a, x)
    e32 = torch.eye(SB, dtype=torch.float32, device=a.device)
    iax = e32[None] - ax
    ab = iax.abs()
    rows = ab.sum(-1)
    x2 = 2.0 * x
    p = torch.matmul(x, ax)
    y = x2 - p
    buf = torch.empty((plan.n_tiles, SB, SB), device=a.device)
    out = {
        "tiles: new_zeros": lambda: f.new_zeros(n * SB),
        "tiles: scatter t[pos] = f[src]": lambda: t0.__setitem__(pos,
                                                                 f[src]),
        "tiles: t * m_i": lambda: t * m[:, :, None],
        "tiles: * m_j": lambda: tm * m[:, None, :],
        "tiles: sigma (1 - m_i) * I": lambda: (sigma * (1.0 - m))[
            :, :, None] * eye[None],
        "tiles: + diagonal": lambda: tmm + d,
        "GEMM A X0": lambda: torch.matmul(a, x),
        "guard: I - A X0": lambda: e32[None] - ax,
        "guard: abs": lambda: iax.abs(),
        "guard: row sums": lambda: ab.sum(-1),
        "guard: max": lambda: rows.max(),
        "update: 2.0 * x": lambda: 2.0 * x,
        "update: GEMM X (A X)": lambda: torch.matmul(x, ax),
        "update: - X (A X)": lambda: x2 - p,
        "last: .contiguous() (row-major)": lambda: y.contiguous(),
        "last: copy_ into the step's buffer": lambda: buf.copy_(y),
    }
    res = {k: pass_ms(fn) for k, fn in out.items()}
    del t0, t, tm, tmm, d, a, ax, iax, ab, rows, x2, p, y, buf
    return res


class ParentPasses:
    """The parent's standalone guard and update passes (its
    csrc/bj_tiles.cu), built alone from ``source`` and bound by ctypes."""

    def __init__(self, source):
        from navierstokes_tpu_torch.kernels import build
        os.makedirs(CS.WORK, exist_ok=True)
        so = os.path.join(CS.WORK, "bj_tiles_parent.so")
        proc = subprocess.run([build._find_nvcc(), *build.NVCC_FLAGS,
                               "-shared", "-o", so, source],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
        lib = ctypes.CDLL(so)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.nst_bj_guard.argtypes = [p, p, p, i, i, i, p]
        lib.nst_bj_guard.restype = i
        lib.nst_bj_update.argtypes = [p, p, p] + [i] * 5 + [p]
        lib.nst_bj_update.restype = i
        self.lib = lib
        self.sms = torch.cuda.get_device_properties(0).multi_processor_count

    def _check(self, rc, what):
        if rc:
            raise RuntimeError(f"the parent's {what} failed ({rc})")

    def guard(self, ax):
        """The guard's norm of A X0 (two kernels, as the parent's
        bj_tiles.guard launched them)."""
        n, sb = ax.shape[0], ax.shape[-1]
        grid = max(1, min(-(-n * sb // 8), 8 * self.sms))
        partial = torch.empty(grid, device=ax.device)
        norm = torch.empty((), device=ax.device)
        self._check(self.lib.nst_bj_guard(
            ax.data_ptr(), partial.data_ptr(), norm.data_ptr(), sb, n, grid,
            torch.cuda.current_stream().cuda_stream), "guard")
        return norm

    def update(self, x, p, out=None):
        """2 x - p in x's layout, or row-major into ``out`` (the last)."""
        from navierstokes_tpu_torch.kernels.bj_gemm import OUT_KINDS
        from navierstokes_tpu_torch.kernels.bj_tiles import layout
        kind = 0 if out is None else OUT_KINDS[out.dtype]
        if out is None:
            out = torch.empty_strided(x.shape, x.stride(), device=x.device)
        self._check(self.lib.nst_bj_update(
            x.data_ptr(), p.data_ptr(), out.data_ptr(), x.shape[-1],
            x.shape[0], int(layout(x)), int(layout(p)), kind,
            torch.cuda.current_stream().cuda_stream), "update")
        return out


def _col(t):
    return t.transpose(1, 2).contiguous().transpose(1, 2)


def gemm_ab(case, inp, parent, rounds, card):
    """The parent's product + pass against each epilogue of csrc/bj_gemm.cu
    (see the module docstring)."""
    from navierstokes_tpu_torch.kernels import bj_gemm as BG
    from navierstokes_tpu_torch.kernels import bj_tiles as BT
    plan = inp["plan"]
    SB, n = plan.S * plan.bu, plan.n_tiles
    a = BT.tiles(plan, inp["f"], inp["mask"], inp["sigma"])
    x0 = inp["x0"].to(torch.float32)           # the change's seed
    x0c = _col(x0)                             # the parent's, column-major
    parts = BG.guard_partials(n, SB, a.device)
    ax0, _ = BG.guard(a, x0, parts)
    x1 = BG.update(x0, ax0)
    x1c = _col(x1)
    ax1 = BG.product(a, x1)
    buf_p = torch.empty((n, SB, SB), device=a.device)
    buf_c = torch.empty_like(buf_p)
    pairs = {
        "guard": (lambda: parent.guard(torch.matmul(a, x0c)),
                  lambda: BG.guard(a, x0, parts)),
        "update": (lambda: parent.update(x0c, torch.matmul(x0c, ax0)),
                   lambda: BG.update(x0, ax0)),
        "product": (lambda: torch.matmul(a, x1c),
                    lambda: BG.product(a, x1)),
        "last update": (lambda: parent.update(
            x1c, torch.matmul(x1c, ax1), out=buf_p),
            lambda: BG.update(x1, ax1, out=buf_c)),
    }
    same = {
        "guard": bool(parent.guard(torch.matmul(a, x0c))
                      == BG.guard(a, x0, parts)[1]),
        "update": bool(torch.equal(pairs["update"][0](),
                                   pairs["update"][1]())),
        "product": bool(torch.equal(pairs["product"][0](),
                                    pairs["product"][1]())),
    }
    pairs["last update"][0]()
    pairs["last update"][1]()
    same["last update"] = bool(torch.equal(buf_p, buf_c))
    alone = {"GEMM A X0 (parent's layouts)": lambda: torch.matmul(a, x0c),
             "GEMM X (A X) (parent's layouts)":
                 lambda: torch.matmul(x0c, ax0),
             "the parent's guard pass (2 kernels)":
                 lambda: parent.guard(ax0),
             "the parent's update pass": lambda: parent.update(x0c, ax0)}
    passes = {k: CS._time_ms(fn, cold=True, n=10) for k, fn in alone.items()}
    times = {k: {"parent": {"cold": [], "warm": []},
                 "change": {"cold": [], "warm": []}} for k in pairs}
    for r in range(rounds):
        for who in ("parent", "change", "change", "parent"):
            for k, fns in pairs.items():
                fn = fns[0] if who == "parent" else fns[1]
                times[k][who]["cold"].append(CS._time_ms(fn, cold=True, n=5))
                times[k][who]["warm"].append(CS._burst_ms([fn], reps=2))
    med = {k: {who: {w: statistics.median(v) for w, v in d.items()}
               for who, d in t.items()} for k, t in times.items()}

    def parent_chain():
        g = BT.tiles(plan, inp["f"], inp["mask"], inp["sigma"])
        x, ax = x0c, torch.matmul(g, x0c)
        parent.guard(ax)
        for i in range(CS.BJT_ITERS):
            p = torch.matmul(x, ax)
            if i + 1 < CS.BJT_ITERS:
                x = parent.update(x, p)
                ax = torch.matmul(g, x)
            else:
                parent.update(x, p, out=buf_p)

    graph_med, graph_all = CS._captured_ms({
        "parent": parent_chain,
        "change": lambda: CS.kernel_rebuild(inp, buf_c, [parts])}, rounds)
    torch.cuda.synchronize()
    same["captured rebuild"] = bool(torch.equal(buf_p, buf_c))
    for k, m in med.items():
        print(f"[{case}] {k}: parent (cuBLAS + pass) cold "
              f"{m['parent']['cold']:.4f} warm {m['parent']['warm']:.4f}; "
              f"change (csrc/bj_gemm.cu) cold {m['change']['cold']:.4f} "
              f"warm {m['change']['warm']:.4f} ms (medians of {rounds} "
              f"rounds) on {card}", flush=True)
    print(f"[{case}] {n} tiles of {SB}: the parent's passes alone, ms cold: "
          + "; ".join(f"{k} {v:.4f}" for k, v in passes.items())
          + f"; bits equal: {same}; one captured Newton-Schulz rebuild "
          f"(segments (a) and (b)): parent {graph_med['parent']:.4f}, change "
          f"{graph_med['change']:.4f} ms", flush=True)
    del a, x0, x0c, x1, x1c, ax0, ax1, buf_p, buf_c
    return dict(n_tiles=n, sb=SB, same=same, passes=passes, medians=med,
                rounds=times, captured_ms=graph_med, captured_rounds=graph_all)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", nargs="+", default=["bench", "mono", "naca"],
                    choices=["bench", "mono", "naca", "random"])
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--exact", action="store_true",
                    help="time the exact branch (phase 29) instead")
    ap.add_argument("--gemm", default=None, metavar="PARENT_SOURCE",
                    help="time the Newton-Schulz products against the "
                         "parent's chain (its csrc/bj_tiles.cu)")
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bj_rebuild_ab: needs a CUDA device", file=sys.stderr)
        return 2
    card = CS.card_line()
    print(f"card: {card}", flush=True)
    CS.phase_build()
    parent = ParentPasses(args.gemm) if args.gemm else None
    out = {"card": card, "cases": {}}
    for case in args.cases:
        if case == "random":
            if not args.exact:
                raise SystemExit("bj_rebuild_ab: --cases random needs "
                                 "--exact")
            rng = np.random.default_rng(1)
            tiles = torch.as_tensor(
                rng.standard_normal((1760, 256, 256)).astype(np.float32)
                / 16 + 4 * np.eye(256, dtype=np.float32), device="cuda")
            out["cases"][case] = CS.phase_inverse(case, tiles, card,
                                                  edges=True,
                                                  rounds=args.rounds)
            del tiles
            continue
        ns = model(case)
        for _ in range(args.steps):
            ns.solve_time_step()
        inp = CS.rebuild_inputs(ns)
        if parent is not None:
            out["cases"][case] = gemm_ab(case, inp, parent, args.rounds,
                                         card)
            del ns, inp
            torch.cuda.empty_cache()
            continue
        if args.exact:
            from navierstokes_tpu_torch.kernels import bj_tiles
            tiles = bj_tiles.tiles(inp["plan"], inp["f"], inp["mask"],
                                   inp["sigma"])
            out["cases"][case] = CS.phase_inverse(case, tiles, card,
                                                  rounds=args.rounds)
            del ns, inp, tiles
            torch.cuda.empty_cache()
            continue
        passes = stock_passes(inp)
        # a Newton-Schulz rebuild runs each pass once, but the update's
        # three passes three times and A X (as A X0) twice more
        total = sum(passes[k] * WEIGHTS.get(k, 1) for k in passes)
        elementwise = sum(passes[k] * WEIGHTS.get(k, 1) for k in passes
                          if "GEMM" not in k)
        print(f"[{case}] the stock chain's passes, ms per call on {card}: "
              + "; ".join(f"{k} {v:.4f}" for k, v in passes.items())
              + f"; a rebuild's passes weighted by their calls {total:.4f}"
              f", of which the passes but the GEMMs {elementwise:.4f}",
              flush=True)
        rb = CS.phase_rebuild(case, inp, card, rounds=args.rounds)
        rb["products"] = CS.phase_products(case, inp, card)
        out["cases"][case] = dict(passes=passes, passes_rebuild_ms=total,
                                  passes_elementwise_ms=elementwise, **rb)
        del ns, inp
        torch.cuda.empty_cache()
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(out, fh, indent=1, default=str)
    print(json.dumps(out, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
