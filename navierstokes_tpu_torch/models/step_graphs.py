"""The one-device projection step as captured CUDA graphs.

The counterpart of the JAX model's compiled step (``_chunk_fn``: the step
under ``lax.scan``, its Krylov loops under ``lax.while_loop`` and the
tile guard under ``lax.cond``).  The step of ``NavierStokes`` on the bsr
operator, one device, ``scheme="projection"``, is cut into the segments
of its plain version (``NavierStokes._step_projection``), each captured
once per model and replayed every step:

    (a)  t_new, the BDF terms, the F rebuild A0 + C(u_adv), sigma, and
         under ``f_precond="bj"`` the tiles, A X0 and the guard norm;
    (b)  the Newton-Schulz tile inverses, or (b') the exact ones: the
         guard, read once on the host after (a), picks one;
    (c)  the u* right-hand side and the BiCGStab set-up;
    (d)  one block of BICGSTAB_CHECK_EVERY masked BiCGStab iterations,
         replayed until the flag read after it is down;
    (e)  u*, its divergence and the CG set-up;
    (f)  one block of CG_CHECK_EVERY masked CG iterations (V-cycle
         inside), replayed like (d);
    (g)  the correction, the rotational update, the forces and the
         metrics row; u_prev <- u, u <- u_new, p, phi and t updated in
         their static buffers.

The state (u, p, u_prev, phi, t), the tile inverses and the metrics row
live in static buffers allocated outside the graphs; the model's ``_u``
and the others point at them after a run (``run`` copies a state set
from elsewhere in first).  The graphs share one memory pool and replay
in the order of capture.  Every result equals the plain step's bit for
bit: the same functions run, on the same inputs, in the same order.
``set_sync_debug_mode("error")`` around each replay (``sync_check``)
shows that no replay synchronises; the host waits only at its reads.

A capture that fails raises, naming the segment; the model never falls
back to eager stepping behind the caller's back.  A forcing callable
must be pure torch to be captured.  SELL launches are recorded per graph
at capture and added to ``kernels.sell_spmv.COUNTS`` at each replay.
"""

from __future__ import annotations

import gc
import time

import torch

from navierstokes_tpu_torch.kernels.sell_spmv import record_launches
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
    "c": "the u* right-hand side and the BiCGStab set-up",
    "d": "a block of BiCGStab iterations",
    "e": "the CG set-up of the pressure Poisson",
    "f": "a block of CG iterations",
    "g": "the correction, the pressure update, the forces and the metrics",
}
_STATE = (("u", "_u"), ("p", "_p"), ("u_prev", "_u_prev"), ("phi", "_phi"),
          ("t", "_t"))


class StepGraphs:
    """The captured projection step of one model (see the module
    docstring).  ``capture_seconds``: the warm-up step and the captures;
    ``sync_check``: replay under ``set_sync_debug_mode("error")``.
    ``_dry`` calls the segment functions where the graphs would replay,
    on any device, with the same static buffers and order: the CPU
    tests' rehearsal of the replay."""

    def __init__(self, ns, *, _dry: bool = False):
        self.ns = ns
        cfg = ns.config
        self.device = ns.device
        self.sync_check = False
        self.bj = ns._bj_plan is not None
        self.guarded = self.bj and cfg.bj_newton > 0
        self.ce_f = krylov.BicgstabLoop.check_every
        self.ce_p = krylov.CgLoop.check_every
        for name, attr in _STATE:
            setattr(self, name, getattr(ns, attr).clone())
        self.row = torch.zeros(len(_ROW), dtype=torch.float64,
                               device=self.device)
        self.tiles = None
        self.graphs = {}
        self.ws = _Workspace()
        if _dry:
            self.graphs = {name: (fn, None) for name, fn
                           in self._segments(self.ws).items()}
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

    # ---- segments -----------------------------------------------------

    def _segments(self, ws) -> dict:
        """The segment functions over the workspace ``ws``, in order."""
        ns = self.ns
        iters = ns.config.bj_newton

        def a():
            ns._proj_rebuild(ws, self.u, self.u_prev, self.t)
            if self.bj:
                ws.guard = block_jacobi_guard(
                    [(ns._bj_plan, ws.f_cell, ws.mflat, ws.sigma,
                      ns._bj_seed() if self.guarded else None)], iters)

        def tiles(inverses):
            out = ns._tiles_dtype(inverses[0])
            if self.tiles is None:          # the warm-up: allocate
                self.tiles = torch.empty_like(out)
            self.tiles.copy_(out)

        def pre_f(r):
            if self.bj:
                return block_jacobi_apply(ns._bj_plan, self.tiles, r)
            return r * ws.dinv

        def g():
            u_new, p_new, phi, row = ns._proj_finish(ws, self.p)
            self.u_prev.copy_(self.u)
            self.u.copy_(u_new)
            self.p.copy_(p_new)
            self.phi.copy_(phi)
            self.t.copy_(ws.t_new)
            self.row.copy_(row)

        seg = {"a": a}
        if self.guarded:
            seg["b"] = lambda: tiles(block_jacobi_newton(ws.guard, iters))
        if self.bj:
            seg["b_exact"] = lambda: tiles(block_jacobi_exact(ws.guard))
        seg.update(
            c=lambda: ns._proj_momentum(ws, self.u, self.p, self.u_prev,
                                        pre_f),
            d=lambda: ws.floop.block(),
            e=lambda: ns._proj_poisson(ws, self.phi),
            f=lambda: ws.ploop.block(),
            g=g)
        return seg

    def _warm_up(self):
        """Every segment once, eagerly, on the capture stream (handles,
        workspaces and kernel modules exist before any capture), then the
        state put back as it was."""
        saved = [getattr(self, name).clone() for name, _ in _STATE]
        for fn in self._segments(_Workspace()).values():
            fn()
        for (name, _), v in zip(_STATE, saved):
            getattr(self, name).copy_(v)

    def _capture(self, name, fn):
        graph = torch.cuda.CUDAGraph()
        try:
            with record_launches() as rec, torch.cuda.graph(
                    graph, pool=self.pool, stream=self.stream):
                fn()
        except Exception as e:
            hint = (" (a forcing callable must be pure torch on the "
                    "model's device to be captured)"
                    if self.ns.forcing is not None and name in ("c", "g")
                    else "")
            raise RuntimeError(
                f"CUDA graph capture of the projection step failed in "
                f"segment ({name}), {SEGMENTS[name]}: {e}{hint}") from e
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

    def run(self, n: int):
        """``n`` steps from the graphs.  Returns (rows (n, len(_ROW))
        float64 on the device, [_StepInfo]) as ``NavierStokes._run_steps``;
        reads only the guard and the loops' flags."""
        self._adopt()
        ws = self.ws
        rows = torch.empty((n, len(_ROW)), dtype=torch.float64,
                           device=self.device)
        infos = []
        for i in range(n):
            self._replay("a")
            reads, exact, span = 0, not self.guarded, None
            if self.guarded:
                reads += 1
                exact = not krylov._host(ws.guard.norm < GUARD_LIMIT)
            if self.bj:
                span = _Span([self.device])
                self._replay("b_exact" if exact else "b")
                span.stop()
                if exact:
                    BJ_INVERSIONS["exact"] += 1
            self._replay("c")
            fb = self._blocks("d", ws.floop)
            self._replay("e")
            pb = self._blocks("f", ws.ploop)
            self._replay("g")
            rows[i].copy_(self.row)
            infos.append(_StepInfo(span=span, exact_inverse=self.bj and exact,
                                   flag_reads=reads + fb + pb,
                                   slots=fb * self.ce_f + pb * self.ce_p))
        return rows, infos
