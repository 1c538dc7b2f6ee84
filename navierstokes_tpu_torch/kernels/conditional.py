"""CUDA graph conditional *while* nodes during a torch stream capture, and
the loop predicate that drives them.

The counterpart of JAX's ``lax.while_loop``: the captured step puts each
Krylov loop under one while node whose body is one iteration
(solvers/krylov.py ``GRAPH``, models/step_graphs.py), the inner BiCGStab
of the preconditioner nested in FGMRES's body.  torch on the card's host
(2.11) has no API for conditional nodes, so they come from the port's
CUDA library (csrc/graph_cond.cu): ``nst_while_begin`` adds the node to
the graph the current stream is capturing, after the predicate kernel
``set_condition`` has set the node's condition from the loop's flag (a
loop whose flag is down runs no body), and begins capturing a body
stream into the node's body graph; ``nst_while_end`` ends it.  A body
ends in the loop's predicate, which sets the node's condition again.

``set_condition`` is the loop's predicate, JAX's ``cond_fun``: one launch
reads ||r|| against the target, the breakdown flag and the count against
the budget, writes the loop's flag ``active`` and, as a body's last
launch, sets the node's condition (``Condition``), so the body runs again
exactly while the loop iterates.  Its plain version (``set_condition_plain``,
CPU tensors) is the same predicate in torch operations; the plain loop
reads the flag on the host before each iteration (krylov ``HOST``).

``WhileNodes`` captures on one body stream per nesting depth, created
apart from torch's stream pool (a pooled stream may be the capturing one)
and shared by every instance on a device (so that cuBLAS keeps one
workspace per stream), and keeps a private memory pool of its own: while
``routed()`` is open, every allocation on the device goes to ``pool``,
the bodies' and the capturing stream's alike (torch takes the newest
route, so the pool of ``torch.cuda.graph`` stays empty; measured with
tools/torch_step_profile.py).  The allocator reuses a freed block only
on the stream that freed it: a body's blocks are reused by the next run
of the body and by later bodies on the same stream, which run after it
in the graph, and the capturing stream's as in torch's own graph pool.
So a body's tensors are read only inside one run of it, and state
crosses iterations only through buffers allocated outside the node.
The pool lives as long as the object; ``close`` releases it after the
graphs that use it are gone.

``COUNTS.set_condition`` counts the launches of csrc/graph_cond.cu's
kernel: the predicate of every loop iteration, eager or captured, and the
test before each while node each time the graph reaches it (through the
record of the graph or body that holds the launch, kernels/launches.py).
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses

import torch

from navierstokes_tpu_torch.kernels.launches import count, record_launches


@dataclasses.dataclass
class Counts:
    set_condition: int = 0   # set_condition launches

    def reset(self):
        self.set_condition = 0


COUNTS = Counts()


def _count():
    COUNTS.set_condition += 1


@dataclasses.dataclass(frozen=True)
class Condition:
    """The while node a body is being captured into: its conditional
    handle and its ``tally`` (3 int64 on the device: evaluations, those
    that let the body run, bodies run under a down flag)."""
    handle: int
    tally: torch.Tensor


def set_condition_plain(active, res, target, k, maxiter, stag=None):
    """The plain version of ``set_condition``: active <- (res > target)
    & ~stag & (k < maxiter) in torch operations."""
    up = (res > target) & (k < maxiter)
    if stag is not None:
        up = ~stag & up
    active.copy_(up)


def _check_scalar(name, t, dtypes, dev):
    if t.dtype not in dtypes or t.dim() != 0:
        raise ValueError(f"set_condition: {name} must be a 0-d "
                         f"{' or '.join(map(str, dtypes))} tensor (got "
                         f"{t.dtype} {tuple(t.shape)})")
    if t.device != dev:
        raise ValueError(f"set_condition: {name} on {t.device}, active on "
                         f"{dev}")


def set_condition(active, res, target, k, maxiter: int, stag=None,
                  cond: Condition | None = None) -> bool:
    """The loop predicate in one launch (see the module docstring):
    ``active`` <- (res > target) & ~stag & (k < maxiter) and, under a
    while node's body, ``cond``'s condition set from it.  CPU tensors take
    ``set_condition_plain``; CUDA tensors launch the kernel or raise.
    Returns whether it set a node's condition."""
    dev = active.device
    if dev.type == "cpu":
        set_condition_plain(active, res, target, k, maxiter, stag)
        return False
    _check_scalar("active", active, (torch.bool,), dev)
    _check_scalar("res", res, (torch.float32, torch.float64), dev)
    _check_scalar("target", target, (res.dtype,), dev)
    _check_scalar("k", k, (torch.int64,), dev)
    if stag is not None:
        _check_scalar("stag", stag, (torch.bool,), dev)
    from navierstokes_tpu_torch.kernels.build import library
    lib = library()
    suffix = "f64" if res.dtype == torch.float64 else "f32"
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = getattr(lib, f"nst_set_condition_{suffix}")(
            stream, 0 if cond is None else cond.handle, int(cond is not None),
            res.data_ptr(), target.data_ptr(),
            None if stag is None else stag.data_ptr(), k.data_ptr(),
            int(maxiter), active.data_ptr(),
            None if cond is None else cond.tally.data_ptr())
    _check(lib, "set_condition launch", rc)
    count(_count)
    return cond is not None


_STREAMS = {}          # device -> body streams, one per nesting depth
# nst_while_begin's steps, for the error of a failed one
_BEGIN_STEPS = ("an error left by an earlier call", "the capture's state",
                "the conditional handle", "set_condition's launch",
                "the capture's state", "the while node",
                "the capture's dependencies", "the body's capture")


class WhileNodes:
    """While nodes in the captures of one model's graphs on ``device``."""

    def __init__(self, device, depth: int = 4):
        self.device = torch.device(device)
        if self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        key = str(self.device)
        if key not in _STREAMS:
            _STREAMS[key] = [_body_stream(self.device) for _ in range(depth)]
        self.streams = _STREAMS[key]
        self.pool = torch.cuda.graph_pool_handle()
        self.depth = 0
        self._routes = 0

    @contextlib.contextmanager
    def routed(self):
        """Every allocation on the device goes to ``pool``, the
        capturing stream's too (open inside ``torch.cuda.graph``, after
        its own route, which the newer one overrides)."""
        index = self.device.index
        torch._C._cuda_beginAllocateToPool(index, self.pool)
        self._routes += 1
        try:
            yield self
        finally:
            torch._C._cuda_endAllocateToPool(index, self.pool)

    def loop(self, flag, body, tally):
        """Capture a while node on the 0-d bool CUDA tensor ``flag``:
        ``body(cond)`` is captured as the node's body graph; its last
        launch, the loop's predicate, sets the node's condition (``cond``)
        and it returns True, else the capture raises.  ``tally`` (3 int64
        on the device) counts the node's evaluations.  Returns the body's
        launch record (kernels/launches.py)."""
        from navierstokes_tpu_torch.kernels.build import library
        if (flag.dtype != torch.bool or flag.numel() != 1
                or flag.device != self.device):
            raise ValueError(f"a while node's flag must be one bool on "
                             f"{self.device} (got {flag.dtype} "
                             f"{tuple(flag.shape)} on {flag.device})")
        if self.depth == len(self.streams):
            raise RuntimeError(f"while nodes nested deeper than {self.depth}")
        lib = library()
        count(_count)               # the first test, in the parent's record
        parent = torch.cuda.current_stream(self.device)
        stream = self.streams[self.depth]
        step, handle = ctypes.c_int(0), ctypes.c_ulonglong(0)
        rc = lib.nst_while_begin(parent.cuda_stream, flag.data_ptr(),
                                 stream.cuda_stream, tally.data_ptr(),
                                 ctypes.byref(handle), ctypes.byref(step))
        _check(lib, f"nst_while_begin (step {step.value}, "
               f"{_BEGIN_STEPS[step.value]})", rc)
        self.depth += 1
        try:
            with torch.cuda.stream(stream), record_launches() as rec:
                closed = body(Condition(handle.value, tally))
        finally:
            self.depth -= 1
            rc = lib.nst_while_end(stream.cuda_stream)
        _check(lib, "nst_while_end", rc)
        if not closed:
            raise RuntimeError("a while body's last launch must set its "
                               "node's condition (the loop's predicate "
                               "given the body's cond)")
        return rec

    def close(self):
        """Release the body pool (its blocks are freed once no graph holds
        them and the cache is emptied)."""
        for _ in range(self._routes):
            torch._C._cuda_releasePool(self.device.index, self.pool)
        self._routes = 0


def _body_stream(device):
    """A CUDA stream created for bodies alone (torch's ``Stream()`` takes
    one from a small pool, which may be the capturing stream itself)."""
    from navierstokes_tpu_torch.kernels.build import library
    lib = library()
    ptr = ctypes.c_void_p()
    with torch.cuda.device(device):
        _check(lib, "nst_stream_create", lib.nst_stream_create(
            ctypes.byref(ptr)))
    return torch.cuda.ExternalStream(ptr.value, device=device)


def _check(lib, entry, rc):
    if rc != 0:
        raise RuntimeError(f"{entry} failed ({rc}): "
                           f"{lib.nst_cuda_error_string(rc).decode()}")
