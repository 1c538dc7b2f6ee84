"""Probe of CUDA graph conditional *while* nodes through torch, on one GPU.

    python3 tools/conditional_probe.py

The captured step (models/step_graphs.py) runs each Krylov loop as one
while node whose body is one iteration ending in the loop's predicate,
and the preconditioner's inner BiCGStab as a while node nested in
FGMRES's body (kernels/conditional.py on csrc/graph_cond.cu).  This
script checks, on the card and torch at hand, what that design needs:

1. whether torch offers conditional nodes itself
   (``torch.cuda.CUDAGraph.get_currently_capturing_graph()``,
   ``begin_capture_to_while_loop_node``; printed, not required), and the
   port's own, which every check below uses;
2. a while node whose body ends in the predicate kernel runs n bodies
   for every trip count n from 0 to 64, as the host loop does;
3. a while node nested in another's body, entered afresh each outer
   iteration;
4. tensors allocated inside a body: right values after many iterations,
   and the graph pool's growth (one body's blocks, not one per
   iteration);
5. the Givens kernel (csrc/arnoldi_lsq.cu) setting its node's condition
   itself, nested under an outer while node, against its plain version;
6. no replay synchronises (``set_sync_debug_mode("error")``);
7. the device time per while iteration with a body of one add and a
   count ending in the predicate kernel, and the same launches replayed
   from a plain graph without a node.

Prints one line per check and, last, one JSON object with the numbers.
Exits non-zero if a check fails.
"""

import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "?"


def check(cond, what):
    print(("ok   " if cond else "FAIL ") + what, flush=True)
    if not cond:
        raise SystemExit(1)


WHILES = None


def capture(fn, pool=None):
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, pool=pool, stream=s), WHILES.routed():
        fn()
    torch.cuda.synchronize()
    return g


def timed(fn, n=20):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def tally():
    return torch.zeros(3, dtype=torch.int64, device="cuda")


def main():
    if not torch.cuda.is_available():
        print("conditional_probe: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    out = {"card": card, "torch": torch.__version__,
           "cuda": torch.version.cuda}
    dev = torch.device("cuda")

    # 1. the API
    api = (hasattr(torch.cuda.CUDAGraph, "get_currently_capturing_graph")
           and hasattr(torch._C._CUDAGraph,
                       "begin_capture_to_while_loop_node"))
    print(f"     torch's own while-node capture: {api}")
    out["torch_while_nodes"] = api
    sys.path.insert(0, ROOT)
    from navierstokes_tpu_torch.kernels import arnoldi_lsq as AL
    from navierstokes_tpu_torch.kernels.build import build_info
    from navierstokes_tpu_torch.kernels.conditional import (WhileNodes,
                                                            set_condition)
    global WHILES
    t0 = time.perf_counter()
    info = build_info()
    print(f"     kernel library built in {info['seconds']:.1f} s "
          f"({time.perf_counter() - t0:.1f} s with the load)")
    WHILES = WhileNodes(dev)
    check(hasattr(info["lib"], "nst_while_begin"),
          "1 the port's while nodes (csrc/graph_cond.cu) are built")
    f32 = dict(dtype=torch.float32, device=dev)
    half = torch.tensor(0.5, **f32)

    # 2. trip counts 0..64
    r, x = torch.zeros((), **f32), torch.zeros((), **f32)
    k = torch.zeros((), dtype=torch.int64, device=dev)
    act = torch.zeros((), dtype=torch.bool, device=dev)
    t2 = tally()

    def body(cond):
        x.add_(r)
        r.sub_(1.0)
        k.add_(1)
        return set_condition(act, r, half, k, 1000, cond=cond)

    g = capture(lambda: WHILES.loop(act, body, t2))
    ok = True
    for n in range(65):
        r.fill_(float(n))
        x.zero_()
        k.zero_()
        t2.zero_()
        set_condition(act, r, half, k, 1000)
        g.replay()
        ok &= (int(k), float(x), t2.tolist()) == (n, n * (n + 1) / 2,
                                                  [n + 1, n, 0])
    check(ok, "2 a while node runs n bodies for n = 0..64, tally n + 1 "
          "evaluations")

    # 3. nested
    ro, ri = torch.zeros((), **f32), torch.zeros((), **f32)
    ko = torch.zeros((), dtype=torch.int64, device=dev)
    ki = torch.zeros((), dtype=torch.int64, device=dev)
    tot = torch.zeros((), dtype=torch.int64, device=dev)
    ao = torch.zeros((), dtype=torch.bool, device=dev)
    ai = torch.zeros((), dtype=torch.bool, device=dev)
    to, ti = tally(), tally()

    def inner(cond):
        tot.add_(1)
        ri.sub_(1.0)
        ki.add_(1)
        return set_condition(ai, ri, half, ki, 1000, cond=cond)

    def outer(cond):
        ri.copy_(torch.remainder(ko, 5).to(torch.float32))
        ki.zero_()
        set_condition(ai, ri, half, ki, 1000)
        WHILES.loop(ai, inner, ti)
        ro.sub_(1.0)
        ko.add_(1)
        return set_condition(ao, ro, half, ko, 1000, cond=cond)

    g = capture(lambda: WHILES.loop(ao, outer, to))
    ok = True
    for n in (0, 1, 4, 11):
        for t in (ko, ki, tot, to, ti):
            t.zero_()
        ro.fill_(float(n))
        set_condition(ao, ro, half, ko, 1000)
        g.replay()
        want = sum(i % 5 for i in range(n))
        print(f"     outer trips {n}: outer bodies {int(ko)}, inner bodies "
              f"{int(tot)} (want {want}), inner tally {ti.tolist()}")
        ok &= (int(ko), int(tot), ti.tolist()) == (n, want,
                                                   [n + want, want, 0])
    check(ok, "3 a while node nested in another's body")

    # 4. allocations inside a body, and the pool's growth
    n_elem = 1 << 20                   # 4 MiB in fp32
    v = torch.randn(n_elem, device=dev)
    acc = torch.zeros(n_elem, device=dev)
    torch.cuda.synchronize()
    pool = torch.cuda.graph_pool_handle()
    r0 = torch.cuda.memory_reserved()
    iters = 64
    c4 = torch.zeros((), dtype=torch.int64, device=dev)
    a4 = torch.ones((), dtype=torch.bool, device=dev)
    big = torch.tensor(1e30, **f32)
    zero = torch.tensor(0.0, **f32)
    t4 = tally()

    def allocating(cond):
        c4.add_(1)
        t = v * c4.to(torch.float32)       # a new 4 MiB tensor per body
        u = t + 1.0
        acc.add_(u)
        return set_condition(a4, big, zero, c4, iters, cond=cond)

    t0 = time.perf_counter()
    g = capture(lambda: WHILES.loop(a4, allocating, t4), pool)
    cap_s = time.perf_counter() - t0
    reserved = torch.cuda.memory_reserved() - r0
    acc.zero_()
    c4.zero_()
    a4.fill_(True)
    g.replay()
    want = v * float(iters * (iters + 1) // 2) + float(iters)
    err = float((acc - want).abs().max() / want.abs().max())
    print(f"     {iters} iterations of a body allocating 2 x 4 MiB: pool "
          f"grew by {reserved / 2**20:.0f} MiB, capture {cap_s:.3f} s, rel "
          f"err {err:.1e}")
    out.update(alloc_iterations=iters, alloc_pool_mib=reserved / 2**20,
               alloc_capture_s=cap_s)
    check(err < 1e-4 and int(c4) == iters, "4 allocations inside a body")
    del g

    # 5. the Givens kernel setting its node's condition, nested
    m = 8
    H = torch.zeros((m + 1, m), device=dev)
    cs, sn = torch.zeros(m, device=dev), torch.zeros(m, device=dev)
    gv = torch.zeros(m + 1, device=dev)
    gv[0] = 1.0
    gen = torch.Generator(device="cpu").manual_seed(3)
    h = torch.randn(m + 1, generator=gen).to(dev)
    h2 = torch.randn(m + 1, generator=gen).to(dev)
    wn = torch.tensor(2.0, device=dev)
    j = torch.zeros((), dtype=torch.int32, device=dev)
    res = torch.tensor(1.0, device=dev)
    ga = torch.ones((), dtype=torch.bool, device=dev)
    tgt = torch.tensor(0.0, device=dev)
    jmax = torch.tensor(5, dtype=torch.int32, device=dev)
    state0 = [t.clone() for t in (H, cs, sn, gv, j, res, ga)]
    outer_flag = torch.ones((), dtype=torch.bool, device=dev)
    k5 = torch.zeros((), dtype=torch.int64, device=dev)
    A = torch.randn(256, 256, generator=gen).to(dev)
    B = torch.randn(256, 8, generator=gen).to(dev)
    C = torch.zeros(256, 8, device=dev)
    A @ B                   # cuBLAS's handle exists before the capture
    t5o, t5 = tally(), tally()

    def step(cond):
        C.add_(A @ B)
        return AL.lsq_update(H, cs, sn, gv, h, h2, wn, j, res, ga, tgt, jmax,
                             cond=cond)

    def once(cond):
        WHILES.loop(ga, step, t5)
        k5.add_(1)
        return set_condition(outer_flag, big, zero, k5, 1, cond=cond)

    gg = capture(lambda: WHILES.loop(outer_flag, once, t5o))
    for t, s in zip((H, cs, sn, gv, j, res, ga), state0):
        t.copy_(s)
    k5.zero_()
    gg.replay()
    got = [t.cpu() for t in (H, cs, sn, gv, j, res, ga)]
    cpu = [s.cpu() for s in state0]
    for _ in range(5):
        AL.lsq_update_plain(cpu[0], cpu[1], cpu[2], cpu[3], h.cpu(),
                            h2.cpu(), wn.cpu(), cpu[4], cpu[5], cpu[6],
                            tgt.cpu(), jmax.cpu())
    same = all(torch.equal(p, q) for p, q in zip(got, cpu))
    mm = float((C - 5 * (A @ B)).abs().max() / (A @ B).abs().max())
    print(f"     j after the replay {int(j)} (j_max 5), equal to the plain "
          f"version {same}; 5 products accumulated, rel err {mm:.1e}; "
          f"tallies outer {t5o.tolist()}, Givens node {t5.tolist()}")
    check(same and int(j) == 5 and mm < 1e-5
          and t5.tolist() == [6, 5, 0] and t5o.tolist() == [2, 1, 0],
          "5 the Givens kernel as a nested body's condition")

    # 6. no replay synchronises
    outer_flag.fill_(True)
    k5.zero_()
    torch.cuda.set_sync_debug_mode("error")
    try:
        gg.replay()
        g_sync_ok = True
    except RuntimeError as e:
        print(f"     {e}")
        g_sync_ok = False
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    check(g_sync_ok, "6 replay under set_sync_debug_mode('error')")

    # 7. device time per iteration
    iters = 400
    z = torch.zeros(1024, device=dev)
    c7 = torch.zeros((), dtype=torch.int64, device=dev)
    a7 = torch.ones((), dtype=torch.bool, device=dev)

    def add_pred(cond):
        z.add_(1.0)
        c7.add_(1)
        return set_condition(a7, big, zero, c7, iters, cond=cond)

    def plain_body():
        for _ in range(iters):
            add_pred(None)

    t7 = tally()

    def loop():
        c7.zero_()
        a7.fill_(True)
        g.replay()

    g = capture(lambda: WHILES.loop(a7, add_pred, t7))
    per = lambda ms: ms * 1e3 / iters
    pred_us = per(timed(loop))
    gp = capture(plain_body)
    plain_us = per(timed(lambda: (c7.zero_(), gp.replay())))
    print(f"     per while iteration (a body of one add and a count): "
          f"{pred_us:.2f} us; the same launches in a plain graph "
          f"{plain_us:.2f} us, on {card}")
    out.update(while_pred_us=pred_us,
               plain_body_us=plain_us, iterations=iters)
    check(int(c7) == iters, "7 the timed loops ran their iterations")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
