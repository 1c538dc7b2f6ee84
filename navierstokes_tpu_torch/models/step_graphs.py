"""The one-device step as captured CUDA graphs, in both schemes.

The counterpart of the JAX model's compiled step (``_chunk_fn``: the step
under ``lax.scan``, its Krylov loops under ``lax.while_loop`` and the
tile guard under ``lax.cond``).  The step of ``NavierStokes`` on the bsr
operator, one device, is cut into the segments of its plain version, each
captured once per model and replayed every step.  Both schemes share
segments (a) and (b):

    (a)  t_new, the F rebuild A0 + C(u_adv), sigma and the diagonal
         scaling, and under ``f_precond="bj"`` the tiles, A X0 and the
         guard norm;
    (b)  the Newton-Schulz tile inverses, or (b') the exact ones: the
         guard, read once on the host after (a), picks one.

``ProjectionGraphs`` (``scheme="projection"``, plain version
``NavierStokes._step_projection``):

    (c)  the u* right-hand side and the BiCGStab set-up;
    (d)  one block of BICGSTAB_CHECK_EVERY masked BiCGStab iterations,
         replayed until the flag read after it is down;
    (e)  u*, its divergence and the CG set-up;
    (f)  one block of CG_CHECK_EVERY masked CG iterations (V-cycle
         inside), replayed like (d);
    (g)  the correction, the rotational update, the forces and the
         metrics row.

``MonolithicGraphs`` (``scheme="monolithic"``, plain version
``NavierStokes._step_monolithic``):

    (c)  the RHS and the lift, the block preconditioner's per-step set-up
         (the Schur V-cycle's coarse inverse and lambda_max, the PCD
         convection), x0 and FGMRES's set-up with its first cycle;
    (d)  one block of GMRES_GRAPH_CHECK_EVERY FGMRES iterations, each
         under a conditional if node on the FGMRES flag, and inside each
         the preconditioner, whose inner BiCGStab runs inner_maxiter_f
         iterations each under an if node on its own flag: no host read
         inside; the host reads the FGMRES flag after each replay;
    (e)  after the host's cycle end (H, g, j, the flag and the bodies'
         run counts in one transfer, the triangular solve by LAPACK, y
         written to its device buffer): x += y Z;
    (cycle) the set-up of a restart cycle, when another follows;
    (r0, r, r_add) refinement: its float64 start, each pass's residual
         and correction set-up on FGMRES's buffers (the correction
         replays (d), (e) and (cycle) with its own target and budget
         in device scalars), and the correction added;
    (g)  the exact boundary values, the forces and the metrics row.

Each ends with u_prev <- u, u <- u_new, p (and phi) and t updated in
their static buffers.  The state (u, p, u_prev, phi, t), the tile
inverses and the metrics row live in static buffers allocated outside
the graphs; the model's ``_u`` and the others point at them after a run
(``run`` copies a state set from elsewhere in first).  The graphs share
one memory pool, where a capture may take the blocks of an earlier
capture's temporaries, never of its live outputs; so a graph that
replays out of capture order must not clobber a later graph's outputs
while they are still read.  Each graph rewrites its live outputs at every
replay before they are read, and the monolithic graphs that replay inside
refinement's corrections, (d), (e) and (cycle), are captured after (r0),
whose outputs the corrections read, and have no live outputs of their
own.  Tensors allocated inside conditional bodies go to a pool of their
own (kernels/conditional.py).  Every result equals the plain step's bit for
bit: the same functions run, on the same inputs, in the same order.
``set_sync_debug_mode("error")`` around each replay (``sync_check``)
shows that no replay synchronises; the host waits only at its reads.

A capture that fails raises, naming the segment; the model never falls
back to eager stepping behind the caller's back.  A forcing callable
must be pure torch to be captured.  Kernel launches are recorded per
graph at capture and added to the kernels' counts at each replay; a
conditional body's launches are added once per run of the body, counted
on the device (kernels/launches.py).
"""

from __future__ import annotations

import contextlib
import gc
import time

import torch

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
    ``sync_check``: replay under ``set_sync_debug_mode("error")``.
    ``_dry`` calls the segment functions where the graphs would replay,
    on any device, with the same static buffers and order: the CPU
    tests' rehearsal of the replay."""

    SEGMENTS = SEGMENTS

    def __init__(self, ns, *, _dry: bool = False):
        self.ns = ns
        cfg = ns.config
        self.device = ns.device
        self.dry = _dry
        self.sync_check = False
        self.bj = ns._bj_plan is not None
        self.guarded = self.bj and cfg.bj_newton > 0
        for name, attr in _STATE:
            setattr(self, name, getattr(ns, attr).clone())
        self.row = torch.zeros(len(_ROW), dtype=torch.float64,
                               device=self.device)
        self.tiles = None
        self.graphs = {}
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
            rebuild(ws)
            if self.bj:
                ws.guard = block_jacobi_guard(
                    [(ns._bj_plan, ws.f_cell, ws.mflat, ws.sigma,
                      ns._bj_seed() if self.guarded else None)], iters)

        def tiles(inverses):
            out = ns._tiles_dtype(inverses[0])
            if self.tiles is None:          # the warm-up: allocate
                self.tiles = torch.empty_like(out)
            self.tiles.copy_(out)

        seg = {"a": a}
        if self.guarded:
            seg["b"] = lambda: tiles(block_jacobi_newton(ws.guard, iters))
        if self.bj:
            seg["b_exact"] = lambda: tiles(block_jacobi_exact(ws.guard))
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

    def _context(self, name):
        """The context a segment runs in when it is captured or rehearsed
        (not in the warm-up)."""
        return contextlib.nullcontext()

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
                    if self.ns.forcing is not None and name in ("c", "g")
                    else "")
            raise RuntimeError(
                f"CUDA graph capture of the {self.ns.config.scheme} step "
                f"failed in segment ({name}), {self.SEGMENTS[name]}: "
                f"{e}{hint}") from e
        self.graphs[name] = (graph, rec)

    # ---- replay -------------------------------------------------------

    def _replay(self, name):
        graph, rec = self.graphs[name]
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

    def _blocks(self, name, loop) -> int:
        """Replay a loop's block until the flag read after it is down;
        returns the blocks replayed."""
        n = 0
        while True:
            self._replay(name)
            n += 1
            if not krylov._host(loop.active):
                return n

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
        """u_prev <- u, u <- u_new, p, phi, t and the row, in place."""
        self.u_prev.copy_(self.u)
        self.u.copy_(u_new)
        self.p.copy_(p_new)
        if phi is not None:
            self.phi.copy_(phi)
        self.t.copy_(ws.t_new)
        self.row.copy_(row)

    def run(self, n: int):
        """``n`` steps from the graphs.  Returns (rows (n, len(_ROW))
        float64 on the device, [_StepInfo]) as ``NavierStokes._run_steps``;
        reads only the guard, the loops' flags and (monolithic) the ends
        of FGMRES's cycles."""
        self._adopt()
        rows = torch.empty((n, len(_ROW)), dtype=torch.float64,
                           device=self.device)
        infos = []
        for i in range(n):
            infos.append(self._step())
            rows[i].copy_(self.row)
        return rows, infos


class ProjectionGraphs(_StepGraphs):
    """The captured projection step (see the module docstring)."""

    SEGMENTS = dict(
        SEGMENTS,
        c="the u* right-hand side and the BiCGStab set-up",
        d="a block of BiCGStab iterations",
        e="the CG set-up of the pressure Poisson",
        f="a block of CG iterations",
        g="the correction, the pressure update, the forces and the metrics")

    def _setup(self):
        self.ce_f = krylov.BicgstabLoop.check_every
        self.ce_p = krylov.CgLoop.check_every

    def _segments(self, ws) -> dict:
        ns = self.ns

        def g():
            u_new, p_new, phi, row = ns._proj_finish(ws, self.p)
            self._advance(ws, u_new, p_new, row, phi)

        seg = self._tile_segments(
            ws, lambda ws: ns._proj_rebuild(ws, self.u, self.u_prev, self.t))
        seg.update(
            c=lambda: ns._proj_momentum(ws, self.u, self.p, self.u_prev,
                                        self.phi, self._pre_f(ws)),
            d=lambda: ws.floop.block(),
            e=lambda: ns._proj_poisson(ws, self.phi),
            f=lambda: ws.ploop.block(),
            g=g)
        return seg

    def _step(self) -> _StepInfo:
        ws = self.ws
        reads, exact, span = self._tiles_step()
        self._replay("c")
        fb = self._blocks("d", ws.floop)
        self._replay("e")
        pb = self._blocks("f", ws.ploop)
        self._replay("g")
        return _StepInfo(span=span, exact_inverse=self.bj and exact,
                         flag_reads=reads + fb + pb,
                         slots=fb * self.ce_f + pb * self.ce_p)


class MonolithicGraphs(_StepGraphs):
    """The captured monolithic step (see the module docstring).
    ``nodes_per_block``: the conditional bodies of segment (d)."""

    SEGMENTS = dict(
        SEGMENTS,
        c="the RHS, the preconditioner's set-up and FGMRES's set-up",
        d="a block of FGMRES iterations under conditional nodes",
        e="the cycle's update x += y Z",
        cycle="the set-up of a restart cycle",
        r0="refinement's float64 start",
        r="a refinement residual and its correction's set-up",
        r_add="a refinement correction added",
        g="the boundary values, the forces and the metrics")

    def _setup(self):
        from navierstokes_tpu_torch.kernels.conditional import IfNodes
        cfg = self.ns.config
        self.ce = krylov.GMRES_GRAPH_CHECK_EVERY
        self.refine = cfg.refine if self.ns._refines() else 0
        self.ifs = None
        if self.dry:
            self.mode = krylov.Mode(krylov.DRY)
        else:
            self.ifs = IfNodes(self.device)
            self.mode = krylov.Mode(krylov.GRAPH, self.ifs)
        self.nodes_per_block = 0

    def _context(self, name):
        """Each loop iteration under its node (the capture) or its look at
        the flag (the rehearsal); the bodies' allocations routed to their
        pool while (d) is captured."""
        stack = contextlib.ExitStack()
        stack.enter_context(krylov.iteration_mode(self.mode))
        if name == "d" and self.ifs is not None:
            stack.enter_context(self.ifs.routed())
        return stack

    def _capture(self, name, fn):
        super()._capture(name, fn)
        if name == "d":
            self.nodes_per_block = len(self.mode.records)

    def _segments(self, ws) -> dict:
        ns = self.ns

        def e():
            if self.mode.hits is not None:
                self.mode.hits.zero_()
            ws.gloop.update()

        def g():
            u_new, p_new, row = ns._mono_finish(ws)
            self._advance(ws, u_new, p_new, row)

        seg = self._tile_segments(
            ws, lambda ws: ns._mono_rebuild(ws, self.u, self.t))
        seg["c"] = lambda: ns._mono_system(ws, self.u, self.p, self.u_prev,
                                           self._pre_f(ws))
        # captured before (d), (e) and (cycle), which replay inside the
        # corrections, after (r0): see the module docstring on the pool
        if self.refine:
            seg.update(
                r0=lambda: ns._mono_refine_start(ws, self.u),
                r=lambda: ns._mono_correction(ws),
                r_add=lambda: ws.refinement.add(ws.gloop.solution()))
        seg.update(d=lambda: ws.gloop.block(self.ce), e=e,
                   cycle=lambda: ws.gloop.cycle(), g=g)
        return seg

    def _solve(self, loop, maxiter: int) -> int:
        """One FGMRES solve from its set-up: blocks (d) until the flag
        read after one is down, the cycle's end on the host, (e), and
        (cycle) while another follows.  Returns the host reads."""
        loop.begin(maxiter)
        mode, reads = self.mode, 0
        while True:
            nb = self._blocks("d", loop)
            extra = (mode.hits[:self.nodes_per_block]
                     if mode.hits is not None else None)
            done, hits = loop.end_cycle(extra)
            reads += nb + 1
            self._replay("e")
            if extra is not None:
                self.nodes += nb * self.nodes_per_block
                for k, rec in zip(hits, mode.records):
                    self.runs += int(k)
                    rec.replay(int(k))
            if done:
                return reads
            self._replay("cycle")

    def _step(self) -> _StepInfo:
        cfg, ws, mode = self.ns.config, self.ws, self.mode
        self.nodes = self.runs = 0
        nodes0, runs0 = mode.nodes, mode.runs       # DRY's own tally
        reads, exact, span = self._tiles_step()
        self._replay("c")
        reads += self._solve(ws.gloop, cfg.outer_maxiter)
        if self.refine:
            self._replay("r0")
            for _ in range(self.refine):
                self._replay("r")
                reads += self._solve(ws.gloop, cfg.refine_maxiter)
                self._replay("r_add")
        self._replay("g")
        nodes = self.nodes + mode.nodes - nodes0
        runs = self.runs + mode.runs - runs0
        return _StepInfo(span=span, exact_inverse=self.bj and exact,
                         flag_reads=reads, skipped=nodes - runs)

    def __del__(self):
        ifs = getattr(self, "ifs", None)
        if ifs is not None:
            self.graphs.clear()
            ifs.close()
