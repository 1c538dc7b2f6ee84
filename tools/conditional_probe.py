"""Probe of CUDA graph conditional nodes through torch, on one GPU.

    python3 tools/conditional_probe.py

The captured monolithic step (models/step_graphs.py) puts every FGMRES
iteration under a conditional *if* node and, inside it, every iteration
of the preconditioner's inner BiCGStab under a second one.  This script
checks, on the card and torch at hand, what that design needs:

1. whether torch offers if nodes itself
   (``torch.cuda.CUDAGraph.get_currently_capturing_graph()``,
   ``begin_capture_to_if_node(pred)``,
   ``end_capture_to_conditional_node()``; printed, not required), and
   the port's own (kernels/conditional.py on csrc/graph_cond.cu), which
   every check below uses;
2. two levels of if nodes nest: every combination of the two flags
   replays to the right counts;
3. a loop as a fixed unroll of if nodes whose flag the body itself
   lowers (``k += 1; active = k < n``) stops after n bodies for every n;
4. tensors allocated inside a body: right values at every replay, and
   the graph pool's size after capturing many such bodies (whether the
   allocator reuses a body's blocks in the next body);
5. the hand-written Givens kernel (csrc/arnoldi_lsq.cu) and a cuBLAS
   matrix product launched from a nested body;
6. no replay synchronises (``set_sync_debug_mode("error")``);
7. the cost on the device of an if node whose body is skipped, and of
   one whose body of 8 small kernels runs, against the 8 kernels in a
   plain graph, per node, from CUDA events.

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


IFS = None


def If(flag, fn):
    """``fn`` under an if node on ``flag`` in the capture in progress."""
    IFS.body(flag, fn)


def capture(fn, pool=None):
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, pool=pool, stream=s), IFS.routed():
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
           and hasattr(torch._C._CUDAGraph, "begin_capture_to_if_node")
           and hasattr(torch._C._CUDAGraph,
                       "end_capture_to_conditional_node"))
    print(f"     torch's own if-node capture: {api}")
    out["torch_if_nodes"] = api
    sys.path.insert(0, ROOT)
    from navierstokes_tpu_torch.kernels.build import build_info
    from navierstokes_tpu_torch.kernels.conditional import IfNodes
    global IFS
    t0 = time.perf_counter()
    info = build_info()
    print(f"     kernel library built in {info['seconds']:.1f} s "
          f"({time.perf_counter() - t0:.1f} s with the load)")
    IFS = IfNodes(dev)
    check(hasattr(info["lib"], "nst_if_begin"),
          "1 the port's if nodes (csrc/graph_cond.cu) are built")

    # 2. two nested levels
    a = torch.zeros((), dtype=torch.bool, device=dev)
    b = torch.zeros((), dtype=torch.bool, device=dev)
    x = torch.zeros((), dtype=torch.int32, device=dev)
    y = torch.zeros((), dtype=torch.int32, device=dev)

    def nested():
        def outer():
            x.add_(1)
            If(b, lambda: y.add_(1))
        If(a, outer)

    g = capture(nested)
    ok = True
    for fa in (True, False):
        for fb in (True, False):
            a.fill_(fa)
            b.fill_(fb)
            x.zero_()
            y.zero_()
            g.replay()
            got = (int(x), int(y))
            want = (int(fa), int(fa and fb))
            ok &= got == want
            print(f"     flags {fa, fb}: outer/inner bodies {got}")
    check(ok, "2 two levels of if nodes nest")

    # 3. an unrolled loop whose body lowers its own flag
    n_t = torch.zeros((), dtype=torch.int32, device=dev)
    k = torch.zeros((), dtype=torch.int32, device=dev)
    act = torch.zeros((), dtype=torch.bool, device=dev)
    outer_act = torch.zeros((), dtype=torch.bool, device=dev)
    inner_total = torch.zeros((), dtype=torch.int32, device=dev)
    kin = torch.zeros((), dtype=torch.int32, device=dev)
    act_in = torch.zeros((), dtype=torch.bool, device=dev)

    def inner():
        kin.add_(1)
        inner_total.add_(1)
        act_in.copy_(kin < 3)

    def outer():
        k.add_(1)
        act.copy_(k < n_t)
        # a nested loop of 4 with its own flag, started per body
        kin.zero_()
        act_in.copy_(kin < 3)
        for _ in range(4):
            If(act_in, inner)

    def loop():
        for _ in range(10):
            If(act, outer)

    g = capture(loop)
    ok = True
    for n in (0, 1, 3, 10, 12):
        n_t.fill_(n)
        k.zero_()
        inner_total.zero_()
        act.fill_(n > 0)
        g.replay()
        ok &= int(k) == min(n, 10) and int(inner_total) == 3 * min(n, 10)
        print(f"     n={n}: bodies {int(k)}, nested bodies "
              f"{int(inner_total)}")
    check(ok, "3 an unrolled loop of if nodes stops where its flag drops")

    # 4. allocations inside bodies, and the pool after many bodies
    n_elem = 1 << 20                   # 4 MiB in fp32
    v = torch.randn(n_elem, device=dev)
    acc = torch.zeros(n_elem, device=dev)
    flag = torch.ones((), dtype=torch.bool, device=dev)
    torch.cuda.synchronize()
    pool = torch.cuda.graph_pool_handle()
    r0 = torch.cuda.memory_reserved()
    bodies = 64

    def allocating():
        for i in range(bodies):
            def body(i=i):
                t = v * float(i + 1)          # a new 4 MiB tensor per body
                u = t + 1.0
                acc.add_(u)
            If(flag, body)

    t0 = time.perf_counter()
    g = capture(allocating, pool)
    cap_s = time.perf_counter() - t0
    reserved = torch.cuda.memory_reserved() - r0
    acc.zero_()
    g.replay()
    want = v * float(bodies * (bodies + 1) // 2) + float(bodies)
    err = float((acc - want).abs().max() / want.abs().max())
    flag.fill_(False)
    acc.zero_()
    g.replay()
    skipped_ok = int((acc != 0).sum()) == 0
    print(f"     {bodies} bodies each allocating 2 x 4 MiB: pool grew by "
          f"{reserved / 2**20:.0f} MiB, capture {cap_s:.3f} s, rel err "
          f"{err:.1e}")
    out.update(alloc_bodies=bodies, alloc_pool_mib=reserved / 2**20,
               alloc_capture_s=cap_s)
    check(err < 1e-4 and skipped_ok, "4 allocations inside bodies")
    del g

    # 5. the Givens kernel and a matrix product from a nested body
    from navierstokes_tpu_torch.kernels import arnoldi_lsq as AL
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
    A = torch.randn(256, 256, generator=gen).to(dev)
    B = torch.randn(256, 8, generator=gen).to(dev)
    C = torch.zeros(256, 8, device=dev)
    A @ B                   # cuBLAS's handle exists before the capture

    def step():
        AL.lsq_update(H, cs, sn, gv, h, h2, wn, j, res, ga, tgt, jmax)
        C.add_(A @ B)

    def givens():
        def body():
            for _ in range(m):
                If(ga, step)
        If(outer_flag, body)

    gg = capture(givens)
    for t, s in zip((H, cs, sn, gv, j, res, ga), state0):
        t.copy_(s)
    gg.replay()
    got = [t.cpu() for t in (H, cs, sn, gv, j, res, ga)]
    cpu = [s.cpu() for s in state0]
    for _ in range(m):
        AL.lsq_update_plain(cpu[0], cpu[1], cpu[2], cpu[3], h.cpu(),
                            h2.cpu(), wn.cpu(), cpu[4], cpu[5], cpu[6],
                            tgt.cpu(), jmax.cpu())
    same = all(torch.equal(p, q) for p, q in zip(got, cpu))
    mm = float((C - 5 * (A @ B)).abs().max() / (A @ B).abs().max())
    print(f"     j after the replay {int(j)} (j_max 5), equal to the plain "
          f"version {same}; 5 products accumulated, rel err {mm:.1e}")
    check(same and int(j) == 5 and mm < 1e-5,
          "5 the Givens kernel and a product in a nested body")

    # 6. no replay synchronises
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

    # 7. cost per node: skipped, run, and the same kernels without nodes
    nodes = 400
    z = torch.zeros(1024, device=dev)
    fl = torch.ones((), dtype=torch.bool, device=dev)

    def body():
        for _ in range(8):
            z.add_(1.0)

    def with_nodes():
        for _ in range(nodes):
            If(fl, body)

    def without_nodes():
        for _ in range(nodes):
            body()

    gn, gp = capture(with_nodes), capture(without_nodes)
    fl.fill_(False)
    skip_ms = timed(gn.replay)
    fl.fill_(True)
    run_ms = timed(gn.replay)
    plain_ms = timed(gp.replay)
    per = lambda ms: ms * 1e3 / nodes
    print(f"     per node: skipped {per(skip_ms):.2f} us, run (8 kernels) "
          f"{per(run_ms):.2f} us, the 8 kernels without a node "
          f"{per(plain_ms):.2f} us, on {card}")
    out.update(skipped_node_us=per(skip_ms), run_node_us=per(run_ms),
               plain_body_us=per(plain_ms), nodes=nodes)
    check(skip_ms < run_ms, "7 a skipped body costs less than a run one")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
