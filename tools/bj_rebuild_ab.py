"""The block-Jacobi tile rebuild on one card: the stock PyTorch chain the
port ran before csrc/bj_tiles.cu against the kernels, in one process.

    python3 tools/bj_rebuild_ab.py [--cases bench mono naca] [--rounds 8]
        [--steps 2] [--exact] [--json PATH]

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
* ``chip_smoke.phase_rebuild``: every kernel against its plain version bit
  for bit, the Newton-Schulz rebuild against the stock chain's, each
  kernel's ms L2-cold and warm beside its bound and its plain version, the
  update beside ``torch.baddbmm``; and one rebuild (segments (a) and (b))
  captured, the kernels' graph against the stock chain's in ``--rounds``
  alternating rounds.

With ``--exact`` it measures the exact branch instead, at the same tiles
(the exact inverse's input): ``chip_smoke.phase_inverse`` (phase 29), the
kernel of csrc/bj_inverse.cu against its plain version bit for bit, the
output dtypes, batch independence, its gap and residual against cuSOLVER's
inverse, its ms L2-cold and warm beside its bound, the rounding rule's
floor, the plain version and the libraries (cuSOLVER with the parent's
two copies, torch.linalg.inv), and segment b_exact captured, the kernel's
graph against the parent's chain (cuSOLVER, ``.contiguous()``, ``copy_``)
captured, in ``--rounds`` alternating rounds.

It prints the card's name and power limit first, and as its last line one
JSON object with every figure.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", nargs="+", default=["bench", "mono", "naca"],
                    choices=["bench", "mono", "naca", "random"])
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--exact", action="store_true",
                    help="time the exact branch (phase 29) instead")
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bj_rebuild_ab: needs a CUDA device", file=sys.stderr)
        return 2
    card = CS.card_line()
    print(f"card: {card}", flush=True)
    CS.phase_build()
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
