"""The one-device step as captured CUDA graphs, in both schemes.

The counterpart of the JAX model's compiled step (``_chunk_fn``: the step
under ``lax.scan``, its Krylov loops under ``lax.while_loop`` and the
tile guard under ``lax.cond``).  The step of ``NavierStokes`` on the bsr
operator, one device, is cut into segments where the host must read,
each captured once per model and replayed every step.  Each Krylov loop
is one CUDA graph conditional *while* node inside its segment, whose body
is one iteration ending in the loop's predicate (solvers/krylov.py
``GRAPH``, kernels/conditional.py): the body runs exactly as often as the
plain step iterates, and no body is skipped or masked.  Both schemes
share segments (a) and (b):

    (a)  t_new, the F rebuild A0 + C(u_adv), sigma and the diagonal
         scaling, and under ``f_precond="bj"`` the tiles, A X0 and the
         guard norm (the GEMM of kernels/bj_gemm.py with the guard in its
         epilogue, its partials allocated at the warm-up);
    (b)  the Newton-Schulz tile inverses (the GEMM's update and product
         epilogues), or (b') the exact ones: the guard, read once on the
         host after (a), picks one.

``ProjectionGraphs`` (``scheme="projection"``, plain version
``NavierStokes._step_projection``):

    (s)  the u* right-hand side, BiCGStab under a while node, u*, its
         divergence, CG (V-cycle inside) under a while node, the
         correction, the rotational update, the forces and the metrics
         row: no host read, so one graph.

``MonolithicGraphs`` (``scheme="monolithic"``, plain version
``NavierStokes._step_monolithic``):

    (c)  the RHS and the lift, the block preconditioner's per-step set-up
         (the Schur V-cycle's coarse inverse and lambda_max, the PCD
         convection), x0, FGMRES's set-up and its first cycle: one while
         node on the FGMRES flag whose body is one Arnoldi iteration, the
         preconditioner's inner BiCGStab a while node nested in it;
    (e)  after the host's cycle end (H, g, j and the flag in one
         transfer, the triangular solve by LAPACK, y written to its device
         buffer): x += y Z;
    (next) (e), then the set-up of the next restart cycle and its
         iterations under the while node, when another cycle follows;
    (r0, r, r_add) refinement: its float64 start, each pass's residual,
         correction set-up and first cycle under the while node (the
         correction replays (next) and (e) with its own target and budget
         in device scalars), and the correction added;
    (g)  the exact boundary values, the forces and the metrics row;
    (eg) (e) then (g): the end of a step without refinement.

A step without refinement whose FGMRES converges in one cycle replays
(a), (b), (c) and (eg), and reads the host twice.

Each step ends with u_prev <- u, u <- u_new, p (and phi) and t updated in
their static buffers.  The state (u, p, u_prev, phi, t), the tile
inverses and the metrics row live in static buffers allocated outside
the graphs; the model's ``_u`` and the others point at them after a run
(``run`` copies a state set from elsewhere in first).  The graphs share
one memory pool (the while nodes' pool, kernels/conditional.py, which
takes every allocation of a capture), where a capture may take the
blocks of an earlier capture's temporaries, never of its live outputs;
so a graph that replays out of capture order must not clobber a later
graph's outputs while they are still read.  Each graph rewrites its live
outputs at every replay before they are read, and the monolithic graphs
that replay inside refinement's corrections, (r), (e) and (next), are
captured after (r0), whose outputs the corrections read, and have no
live outputs of their own.  Tensors allocated inside while bodies live
on the body streams, whose freed blocks only later bodies on the same
stream take.  Every result equals the plain step's bit for bit: the same
functions run, on the same inputs, in the same order.
``set_sync_debug_mode("error")`` around each replay (``sync_check``)
shows that no replay synchronises; the host waits only at its reads: the
guard, and the ends of FGMRES's cycles.

A capture that fails raises, naming the segment; the model never falls
back to eager stepping, masked blocks or unrolled nodes behind the
caller's back.  A forcing callable must be pure torch to be captured.
Kernel launches are recorded per graph at capture and added to the
kernels' counts at each replay.  A while body's launches are added once
per run of the body: each node's condition kernels count its evaluations
on the device (``Mode.tally``), (a) zeroes the counts and (g) appends
them to the step's metrics row, which the host reads with the row
(``_StepInfo.settle``, kernels/launches.py).
"""

from __future__ import annotations

import collections
import contextlib
import gc
import time

import torch

from navierstokes_tpu_torch.kernels import bj_gemm
from navierstokes_tpu_torch.kernels.launches import record_launches
from navierstokes_tpu_torch.models.navier_stokes import (_ROW, _Span,
                                                         _StepInfo,
                                                         _Workspace)
from navierstokes_tpu_torch.ops.p1ell import (BJ_INVERSIONS, GUARD_LIMIT,
                                              block_jacobi_apply,
                                              block_jacobi_exact,
                                              block_jacobi_guard,
                                              block_jacobi_newton)
from navierstokes_tpu_torch.solvers import krylov

# segment -> what it does, for the error of a failed capture
SEGMENTS = {
    "a": "the F rebuild and the tile guard",
    "b": "the Newton-Schulz tile inverses",
    "b_exact": "the exact tile inverses",
}
_STATE = (("u", "_u"), ("p", "_p"), ("u_prev", "_u_prev"), ("phi", "_phi"),
          ("t", "_t"))


class _StepGraphs:
    """The captured step of one model (see the module docstring): the
    static state, capture, replay and the shared segments (a) and (b).
    ``capture_seconds``: the warm-up step and the captures;
    ``sync_check``: replay under ``set_sync_debug_mode("error")``;
    ``mode``: the loops' krylov ``Mode`` (GRAPH, its while nodes and their
    device counts).  ``_dry`` calls the segment functions where the graphs
    would replay, on any device, with the same static buffers and order,
    the loops under krylov ``DRY``: the CPU tests' rehearsal of the
    replay."""

    SEGMENTS = SEGMENTS

    def __init__(self, ns, *, _dry: bool = False):
        from navierstokes_tpu_torch.kernels.conditional import WhileNodes
        self.ns = ns
        cfg = ns.config
        self.device = ns.device
        self.dry = _dry
        self.sync_check = False
        self.bj = ns._bj_plan is not None
        self.guarded = self.bj and cfg.bj_newton > 0
        for name, attr in _STATE:
            setattr(self, name, getattr(ns, attr).clone())
        self.whiles = None
        if _dry:
            self.mode = krylov.Mode(krylov.DRY)
        else:
            self.whiles = WhileNodes(self.device)
            self.mode = krylov.Mode(krylov.GRAPH, self.whiles)
        tally = self.mode.tally
        # the metrics row, and (captured) the while nodes' counts after it
        self.row = torch.zeros(len(_ROW) + (0 if tally is None
                                            else tally.numel()),
                               dtype=torch.float64, device=self.device)
        self.tiles = None
        self.partials = None     # the guard's scratch (kernels/bj_gemm)
        self.graphs = {}
        self.replays = collections.Counter()
        self.ws = _Workspace()
        self._setup()
        if _dry:
            self.graphs = {name: (self._in_context(name, fn), None)
                           for name, fn in self._segments(self.ws).items()}
            self.capture_seconds = 0.0
            return
        t0 = time.perf_counter()
        if self.bj:
            ns._bj_seed()       # the static seed, outside every graph
        exact0 = BJ_INVERSIONS["exact"]
        self.stream = torch.cuda.Stream(self.device)
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            self._warm_up()
        torch.cuda.current_stream(self.device).wait_stream(self.stream)
        self.pool = torch.cuda.graph_pool_handle()
        seg = self._segments(self.ws)
        # no garbage collection inside a capture: a collected CUDA object
        # (another model's graphs, pools, events) would call the runtime
        # outside the stream and invalidate the capture
        gc.collect()
        enabled = gc.isenabled()
        gc.disable()
        try:
            for name in seg:
                self._capture(name, seg[name])
        finally:
            if enabled:
                gc.enable()
        BJ_INVERSIONS["exact"] = exact0
        torch.cuda.synchronize(self.device)
        self.capture_seconds = time.perf_counter() - t0

    def _setup(self):
        """The scheme's own state, before the segments exist."""

    @property
    def nodes(self) -> int:
        """The while nodes captured (every loop site of every segment)."""
        return len(self.mode.records)

    # ---- segments -----------------------------------------------------

    def _segments(self, ws) -> dict:
        """The segment functions over the workspace ``ws``, in order."""
        raise NotImplementedError

    def _tile_segments(self, ws, rebuild) -> dict:
        """Segments (a), (b) and (b'); ``rebuild(ws)`` is the scheme's
        F rebuild."""
        ns = self.ns
        iters = ns.config.bj_newton

        def a():
            if self.mode.tally is not None:
                self.mode.tally.zero_()     # the step's while-node counts
            rebuild(ws)
            if self.bj:
                ws.guard = block_jacobi_guard(
                    [(ns._bj_plan, ws.f_cell, ws.mflat, ws.sigma,
                      ns._bj_seed() if self.guarded else None)], iters,
                    ns._tiles_dtype(), partials=[partials()])

        def partials():
            if self.partials is None:       # the warm-up: allocate
                plan = ns._bj_plan
                self.partials = bj_gemm.guard_partials(
                    plan.n_tiles, plan.S * plan.bu, self.device)
            return self.partials

        def buffer():
            if self.tiles is None:          # the warm-up: allocate
                plan = ns._bj_plan
                SB = plan.S * plan.bu
                self.tiles = torch.empty((plan.n_tiles, SB, SB),
                                         dtype=ns._tiles_dtype(),
                                         device=self.device)
            return self.tiles

        def newton():
            # the last update writes the static buffer itself
            block_jacobi_newton(ws.guard, iters, out=[buffer()])

        def exact():
            block_jacobi_exact(ws.guard, out=[buffer()])

        seg = {"a": a}
        if self.guarded:
            seg["b"] = newton
        if self.bj:
            seg["b_exact"] = exact
        return seg

    def _pre_f(self, ws):
        """The F preconditioner on the static tile inverses."""
        if self.bj:
            return lambda r: block_jacobi_apply(self.ns._bj_plan, self.tiles,
                                                r)
        return lambda r: r * ws.dinv

    def _warm_up(self):
        """Every segment once, eagerly, on the capture stream (handles,
        workspaces and kernel modules exist before any capture), then the
        state put back as it was."""
        saved = [getattr(self, name).clone() for name, _ in _STATE]
        for fn in self._segments(_Workspace()).values():
            fn()
        for (name, _), v in zip(_STATE, saved):
            getattr(self, name).copy_(v)

    @contextlib.contextmanager
    def _context(self, name):
        """The context a segment runs in when it is captured or rehearsed
        (not in the warm-up): its loops under the mode (while nodes, or
        their rehearsal), the bodies' allocations routed to their pool."""
        self.mode.segment = name
        with krylov.iteration_mode(self.mode), (
                self.whiles.routed() if self.whiles is not None
                else contextlib.nullcontext()):
            yield

    def _in_context(self, name, fn):
        def run():
            with self._context(name):
                fn()
        return run

    def _capture(self, name, fn):
        graph = torch.cuda.CUDAGraph()
        try:
            with record_launches() as rec, torch.cuda.graph(
                    graph, pool=self.pool, stream=self.stream), \
                    self._context(name):
                fn()
        except Exception as e:
            hint = (" (a forcing callable must be pure torch on the "
                    "model's device to be captured)"
                    if self.ns.forcing is not None
                    and name in ("s", "c", "g") else "")
            raise RuntimeError(
                f"CUDA graph capture of the {self.ns.config.scheme} step "
                f"failed in segment ({name}), {self.SEGMENTS[name]}: "
                f"{e}{hint}") from e
        self.graphs[name] = (graph, rec)

    # ---- replay -------------------------------------------------------

    def _replay(self, name):
        graph, rec = self.graphs[name]
        self.replays[name] += 1
        if rec is None:                 # _dry
            graph()
            return
        if self.sync_check:
            torch.cuda.set_sync_debug_mode("error")
        try:
            graph.replay()
        finally:
            if self.sync_check:
                torch.cuda.set_sync_debug_mode(0)
        rec.replay()

    def _tiles_step(self):
        """Segments (a) and (b): (host reads, exact inverse, span)."""
        self._replay("a")
        reads, exact, span = 0, not self.guarded, None
        if self.guarded:
            reads += 1
            exact = not krylov._host(self.ws.guard.norm < GUARD_LIMIT)
        if self.bj:
            span = _Span([self.device])
            self._replay("b_exact" if exact else "b")
            span.stop()
            if exact:
                BJ_INVERSIONS["exact"] += 1
        return reads, exact, span

    def _info(self, span, exact, reads) -> _StepInfo:
        """The step's _StepInfo: rehearsed, the DRY mode's counts since
        the step began; captured, a ``settle`` of the counts the step
        appends to its row."""
        info = _StepInfo(span=span, exact_inverse=self.bj and exact,
                         flag_reads=reads)
        mode = self.mode
        if self.dry:
            entered, runs, tests = self._dry0
            info.loops = mode.entered - entered
            info.bodies = mode.runs - runs
            info.skipped = mode.tests - tests - info.bodies - info.loops
        else:
            replays = dict(self.replays)
            info.settle = lambda info, tail: self._settle(replays, info,
                                                          tail)
        return info

    def _settle(self, replays, info, tail):
        """The while nodes' counts of a step (``tail``: 3 per node, from
        its row) into ``info``, and each body's launches added once per
        run of the body.  A node at the top of a segment is entered once
        per replay of the segment, a nested one once per run of its
        parent's body."""
        mode = self.mode
        t = [[int(x) for x in tail[3 * i:3 * i + 3]]
             for i in range(len(mode.records))]
        for (_, runs, _), rec in zip(t, mode.records):
            rec.replay(runs)
        entered = [replays.get(seg, 0) if parent < 0 else t[parent][1]
                   for parent, seg in zip(mode.parents, mode.segments)]
        info.loops = sum(entered)
        info.bodies = sum(x[1] for x in t)
        info.masked = sum(x[2] for x in t)
        info.skipped = sum(x[0] for x in t) - info.bodies - info.loops
        info.settle = None

    def _begin_step(self):
        self.replays.clear()
        mode = self.mode
        self._dry0 = (mode.entered, mode.runs, mode.tests)

    def _adopt(self):
        """Copy a state set from elsewhere (an eager step, a restart) into
        the static buffers."""
        ns = self.ns
        if all(getattr(ns, attr) is getattr(self, name)
               for name, attr in _STATE):
            return
        vals = [getattr(ns, attr).clone() for _, attr in _STATE]
        for (name, _), v in zip(_STATE, vals):
            getattr(self, name).copy_(v)
        for name, attr in _STATE:
            setattr(ns, attr, getattr(self, name))

    def _advance(self, ws, u_new, p_new, row, phi=None):
        """u_prev <- u, u <- u_new, p, phi, t and the row (and, captured,
        the while nodes' counts after it), in place."""
        self.u_prev.copy_(self.u)
        self.u.copy_(u_new)
        self.p.copy_(p_new)
        if phi is not None:
            self.phi.copy_(phi)
        self.t.copy_(ws.t_new)
        self.row[:len(_ROW)].copy_(row)
        if self.mode.tally is not None:
            self.row[len(_ROW):].copy_(self.mode.tally.view(-1))

    def run(self, n: int):
        """``n`` steps from the graphs.  Returns (rows (n, len(_ROW) + the
        while nodes' counts) float64 on the device, [_StepInfo]) as
        ``NavierStokes._run_steps``; reads only the guard and
        (monolithic) the ends of FGMRES's cycles."""
        self._adopt()
        rows = torch.empty((n, self.row.numel()), dtype=torch.float64,
                           device=self.device)
        infos = []
        for i in range(n):
            self._begin_step()
            infos.append(self._step())
            rows[i].copy_(self.row)
        return rows, infos

    def __del__(self):
        whiles = getattr(self, "whiles", None)
        if whiles is not None:
            self.graphs.clear()
            whiles.close()


class ProjectionGraphs(_StepGraphs):
    """The captured projection step (see the module docstring)."""

    SEGMENTS = dict(
        SEGMENTS,
        s="the u* solve and the pressure Poisson, each under a while node, "
          "the correction, the pressure update, the forces and the metrics")

    def _segments(self, ws) -> dict:
        ns = self.ns

        def s():
            ns._proj_momentum(ws, self.u, self.p, self.u_prev, self.phi,
                              self._pre_f(ws)).run()
            ns._proj_poisson(ws, self.phi).run()
            u_new, p_new, phi, row = ns._proj_finish(ws, self.p)
            self._advance(ws, u_new, p_new, row, phi)

        seg = self._tile_segments(
            ws, lambda ws: ns._proj_rebuild(ws, self.u, self.u_prev, self.t))
        seg["s"] = s
        return seg

    def _step(self) -> _StepInfo:
        reads, exact, span = self._tiles_step()
        self._replay("s")
        return self._info(span, exact, reads)


class MonolithicGraphs(_StepGraphs):
    """The captured monolithic step (see the module docstring)."""

    SEGMENTS = dict(
        SEGMENTS,
        c="the RHS, the preconditioner's set-up, FGMRES's set-up and its "
          "first cycle under a while node",
        e="the cycle's update x += y Z",
        next="the cycle's update, the next restart cycle's set-up and its "
             "iterations under a while node",
        r0="refinement's float64 start",
        r="a refinement residual, its correction's set-up and first cycle "
          "under a while node",
        r_add="a refinement correction added",
        g="the boundary values, the forces and the metrics",
        eg="the cycle's update, the boundary values, the forces and the "
           "metrics")

    def _setup(self):
        cfg = self.ns.config
        self.refine = cfg.refine if self.ns._refines() else 0

    def _segments(self, ws) -> dict:
        ns = self.ns

        def c():
            ns._mono_system(ws, self.u, self.p, self.u_prev,
                            self._pre_f(ws)).iterate()

        def r():
            ns._mono_correction(ws)
            ws.gloop.iterate()

        def next_cycle():
            ws.gloop.update()
            ws.gloop.cycle()
            ws.gloop.iterate()

        def g():
            u_new, p_new, row = ns._mono_finish(ws)
            self._advance(ws, u_new, p_new, row)

        seg = self._tile_segments(
            ws, lambda ws: ns._mono_rebuild(ws, self.u, self.t))
        seg["c"] = c
        # (r), (e) and (next) replay inside the corrections, after (r0):
        # captured after it (see the module docstring on the pool)
        if self.refine:
            seg.update(
                r0=lambda: ns._mono_refine_start(ws, self.u), r=r,
                r_add=lambda: ws.refinement.add(ws.gloop.solution()),
                e=lambda: ws.gloop.update(), next=next_cycle, g=g)
        else:
            seg.update(next=next_cycle,
                       eg=lambda: (ws.gloop.update(), g()))
        return seg

    def _solve(self, loop, maxiter: int, last: str) -> int:
        """The rest of an FGMRES solve whose first cycle ran in (c) or
        (r): at each cycle's end the host's read and solve, then (next)
        while another cycle follows, else ``last`` ((e) or (eg)).
        Returns the host reads."""
        loop.begin(maxiter)
        reads = 0
        while True:
            done = loop.end_cycle()
            reads += 1
            if done:
                self._replay(last)
                return reads
            self._replay("next")

    def _step(self) -> _StepInfo:
        cfg, ws = self.ns.config, self.ws
        reads, exact, span = self._tiles_step()
        self._replay("c")
        if not self.refine:
            reads += self._solve(ws.gloop, cfg.outer_maxiter, "eg")
            return self._info(span, exact, reads)
        reads += self._solve(ws.gloop, cfg.outer_maxiter, "e")
        self._replay("r0")
        for _ in range(self.refine):
            self._replay("r")
            reads += self._solve(ws.gloop, cfg.refine_maxiter, "e")
            self._replay("r_add")
        self._replay("g")
        return self._info(span, exact, reads)
