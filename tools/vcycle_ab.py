"""The V-cycle's sweeps (csrc/vcycle.cu) against a parent revision's
per-stage chain on the card.

Builds the parent's ``navierstokes_tpu_torch/csrc/vcycle.cu`` (from the
tree given with ``--parent-tree``, a ``git archive`` of the parent
unpacked; its own ``csrc/sell_row.cuh`` on the include path) alone with
``kernels/build.NVCC_FLAGS`` into ``build/vcycle_ab/``.  The parent is
the form with one typed C entry per stage (``first``, ``first_last``,
``step``, ``step_last``, ``residual``), which this tool chains as the
parent's ``solvers/schur.FusedVcycle`` did: per cycle a pre-smoothing of
k stages, the residual into the zero-padded restriction buffer, the
restriction's sum and the coarse GEMV, a post-smoothing whose first stage
takes the prolongation.  Then, on the card, with the card's name and
power limit on every line, for each case's V-cycle (``--cases``: the
bench point's outlet-pinned P1 Laplacian, n = 113,378, and 3D-1Z's, n =
140,740, as the models build them; 1 cycle, and 2 with ``--cycles 1 2``;
fp32, k = 3):

* the parent's chain and the package's ``FusedVcycle`` against the plain
  cycle (``make_vcycle_solver`` without ``op``), bit for bit;
* ROUNDS rounds of alternating bursts (``chip_smoke._burst_ms``, the
  order reversed every other round: parent, change, change, parent), of
  each V-cycle launched eagerly and of a CUDA graph of GRAPH_CALLS
  V-cycles replayed (the main path runs its V-cycles captured): each
  one's median ms per V-cycle and its rounds;
* the kernels one V-cycle records into a graph
  (``chip_smoke.kernel_launches``).

Exits 1 if any check fails.  Imports no JAX.

    git archive HEAD~1 | tar -x -C build/parent
    python3 tools/vcycle_ab.py --parent-tree build/parent [--cases bench
        3d1] [--cycles 1 2] [--json PATH]
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import chip_smoke as CS  # noqa: E402
import torch_step_profile as TSP  # noqa: E402
from navierstokes_tpu_torch.kernels import build as KB  # noqa: E402
from navierstokes_tpu_torch.ops.p1ell import ell_matvec  # noqa: E402
from navierstokes_tpu_torch.solvers import schur as TS  # noqa: E402

OUT = os.path.join(ROOT, "build", "vcycle_ab")
ROUNDS = 8
GRAPH_CALLS = 20
SRC = os.path.join("navierstokes_tpu_torch", "csrc")


def build_parent(tree: str) -> ctypes.CDLL:
    """The parent's csrc/vcycle.cu compiled alone under OUT, with its
    entries' argument types (the parent's kernels/build.py's)."""
    src = os.path.join(tree, SRC, "vcycle.cu")
    with open(src, "rb") as f:
        text = f.read()
    with open(os.path.join(tree, SRC, "sell_row.cuh"), "rb") as f:
        header = f.read()
    flags = list(KB.NVCC_FLAGS)
    h = hashlib.sha256(text + header + " ".join(flags).encode()).hexdigest()
    os.makedirs(OUT, exist_ok=True)
    lib_path = os.path.join(OUT, f"parent_{h[:16]}.so")
    if not os.path.exists(lib_path):
        subprocess.run([KB._find_nvcc(), *flags, "-I",
                        os.path.join(tree, SRC), "-shared", "-o", lib_path,
                        src], check=True, capture_output=True)
    lib = ctypes.CDLL(lib_path)
    p, i = ctypes.c_void_p, ctypes.c_int
    sell = [p] * 4 + [i]
    for entry, args in (("first", [p] * 5 + [i] + [p] * 4),
                        ("first_last", [p] * 5 + [i, p]),
                        ("step", [p, i] + [p] * 5),
                        ("step_last", [p, i] + [p] * 6),
                        ("residual", [p] * 3)):
        fn = getattr(lib, f"nst_vcycle_{entry}_f32")
        fn.argtypes = sell + args + [p]
        fn.restype = i
    return lib


class ParentChain:
    """The parent's V-cycle: one launch of its library per stage, r0 and
    d in work vectors, z + P y written to z[1], on the same operator,
    coefficients and coarse inverse as ``fused`` (a ``FusedVcycle``)."""

    def __init__(self, lib, fused):
        self.lib, self.f = lib, fused
        new = lambda: torch.empty_like(fused.sdinv)
        self.r0, self.d = new(), new()
        self.zc, self.z = (new(), new()), (new(), new())
        self.rc = torch.zeros_like(fused.rc)
        self.rc_n = self.rc[:fused.op.n]
        op = fused.op
        self.sell = (op.vals.data_ptr(), op.mat.cols.data_ptr(),
                     op.mat.slice_ptr.data_ptr(), op.mat.rows.data_ptr(),
                     op.mat.slice_ptr.shape[0] - 1)

    def _call(self, entry, *args):
        ptr = lambda a: (a.data_ptr() if torch.is_tensor(a)
                         else None if a is None else a)
        rc = getattr(self.lib, f"nst_vcycle_{entry}_f32")(
            *self.sell, *map(ptr, args),
            torch.cuda.current_stream().cuda_stream)
        CS.check(rc == 0, f"parent {entry} launch ({rc})")

    def _smooth(self, r, z, y, out):
        f, k = self.f, self.f.k
        agg = f.plan.agg
        znew = self.z[1] if y is not None else None
        if k == 1:
            self._call("first_last", f.coef, f.sdinv, r, z, y, agg, out)
        else:
            self._call("first", f.coef, f.sdinv, r, z, y, agg,
                       None if z is None else self.r0, self.d, self.zc[0],
                       znew)
        r0 = r if z is None else self.r0
        base = znew if y is not None else z
        for s in range(k - 1):
            if s == k - 2:
                self._call("step_last", f.coef, s, f.sdinv, r0, self.d,
                           self.zc[s % 2], base, out)
            else:
                self._call("step", f.coef, s, f.sdinv, r0, self.d,
                           self.zc[s % 2], self.zc[1 - s % 2])
        return out

    def __call__(self, r):
        f, plan, z = self.f, self.f.plan, None
        for c in range(f.n_cycles):
            z1 = self._smooth(r, z, None, self.z[0])
            self._call("residual", r, z1, self.rc_n)
            y = f.sc_inv @ self.rc.view(plan.n_agg, plan.agg).sum(dim=1)
            out = (torch.empty_like(r) if c == f.n_cycles - 1
                   else self.z[1])
            z = self._smooth(r, z1, y, out)
        return z


def graph_of(fn, r, calls=GRAPH_CALLS):
    """A CUDA graph of ``calls`` calls of ``fn(r)`` (after one on a side
    stream), and a replay of it."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn(r)
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn(r)
    return g


def alternate(fns, rounds=ROUNDS):
    """{name: [ms per round]} of ``fns`` (name -> callable of one unit),
    in bursts, the order reversed every other round."""
    names = list(fns)
    out = {n: [] for n in names}
    for i in range(rounds):
        for n in (names if i % 2 == 0 else names[::-1]):
            out[n].append(CS._burst_ms([fns[n]], reps=5))
    return out


def case_parts(case):
    """(P1Matrix, CoarsePlan, sc_inv, lambda_max, k) of a case's
    outlet-pinned Laplacian, from the model the main path builds."""
    work = os.path.join(ROOT, "build", "vcycle_ab", case)
    ns = (TSP.bench_model("projection", work) if case == "bench"
          else TSP.model_3d1(work))
    return CS.vcycle_parts(ns, "ap_dir")[:5]


def run_case(lib, case, cycles, card):
    op, plan, sc_inv, lam, k = case_parts(case)
    r = torch.as_tensor(np.random.default_rng(20).standard_normal(op.n),
                        dtype=op.vals.dtype, device="cuda")
    out = {"n": op.n, "k": k}
    for n_cycles in cycles:
        fused = TS.FusedVcycle(op, op.diag, plan, sc_inv, lam, n_cycles, k)
        parent = ParentChain(lib, fused)
        plain = TS.make_vcycle_solver(lambda v: ell_matvec(op, v), op.diag,
                                      plan, sc_inv, n_cycles=n_cycles,
                                      smooth_k=k, lam_max=lam)
        want = plain(r)
        ok = torch.equal(fused(r), want) and torch.equal(parent(r), want)
        CS.check(ok, f"{case} {n_cycles} cycle(s): the parent's chain and "
                 f"the sweeps equal the plain cycle bit for bit")
        kernels = {"parent": CS.kernel_launches(lambda: parent(r))[0],
                   "change": CS.kernel_launches(lambda: fused(r))[0]}
        eager = alternate({"parent": lambda: parent(r),
                           "change": lambda: fused(r)})
        graphs = {"parent": graph_of(parent, r), "change": graph_of(fused, r)}
        captured = alternate({n: g.replay for n, g in graphs.items()})
        captured = {n: [t / GRAPH_CALLS for t in v]
                    for n, v in captured.items()}
        rec = {"kernels": kernels, "eager": eager, "captured": captured,
               "sweep_plan": {f: getattr(fused.sweep_plan, f) for f in (
                   "path", "grid", "rounds", "smem", "regs", "local")}}
        med = {m: {n: statistics.median(v) for n, v in rec[m].items()}
               for m in ("eager", "captured")}
        rec["median"] = med
        CS.log(f"[vcycle_ab] {case} (n = {op.n}, k = {k}) V-cycle of "
               f"{n_cycles}: bit for bit; kernels parent {kernels['parent']}"
               f", change {kernels['change']}; ms per V-cycle, median of "
               f"{ROUNDS} alternating rounds: eager parent "
               f"{med['eager']['parent']:.4f} change "
               f"{med['eager']['change']:.4f}; captured parent "
               f"{med['captured']['parent']:.4f} change "
               f"{med['captured']['change']:.4f}; rounds captured "
               f"{[round(t, 4) for t in captured['parent']]} / "
               f"{[round(t, 4) for t in captured['change']]}; plan "
               f"{rec['sweep_plan']} on {card}")
        out[n_cycles] = rec
        del graphs
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent-tree", required=True)
    ap.add_argument("--cases", nargs="+", default=["bench", "3d1"],
                    choices=["bench", "3d1"])
    ap.add_argument("--cycles", nargs="+", type=int, default=[1])
    ap.add_argument("--json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("vcycle_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = CS.card_line()
    lib = build_parent(args.parent_tree)
    res = {"card": card}
    for case in args.cases:
        res[case] = run_case(lib, case, args.cycles, card)
        torch.cuda.empty_cache()
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
