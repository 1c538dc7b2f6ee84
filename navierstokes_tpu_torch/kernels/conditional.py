"""CUDA graph conditional *if* nodes during a torch stream capture.

The captured monolithic step puts each FGMRES iteration, and inside it
each inner BiCGStab iteration, under an if node on its loop's device flag
(solvers/krylov.py ``GRAPH``, models/step_graphs.py).  torch on the card's
host (2.11) has no API for conditional nodes, so they come from the port's
CUDA library (csrc/graph_cond.cu): ``nst_if_begin`` adds the node to the
graph the current stream is capturing, after a one-thread kernel that sets
the node's condition from the flag, and begins capturing a body stream
into the node's body graph; ``nst_if_end`` ends it.

``IfNodes`` captures on one body stream per nesting depth, created apart
from torch's stream pool (a pooled stream may be the capturing one) and
shared by every instance on a device (so that cuBLAS keeps one workspace
per stream), and keeps a private memory pool of its own for the tensors
allocated inside bodies: torch routes the capturing stream's allocations
to the graph's pool and allows one route per pool, so while ``routed()``
is open every other stream's allocations (the bodies') go to ``pool``.
A body's blocks are reused by the next body on the same stream, which
runs after it in the graph.  The pool lives as long as the object;
``close`` releases it after the graphs that use it are gone.
A body's tensors are read only inside it: a tensor a skipped body would
have written holds stale values, so state crosses bodies only through
buffers allocated outside them.

``COUNTS.set_condition`` counts the launches of csrc/graph_cond.cu's
kernel, one per node each time the graph reaches it (through the record
of the graph or body that holds the node, kernels/launches.py).
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses

import torch

from navierstokes_tpu_torch.kernels.launches import count


@dataclasses.dataclass
class Counts:
    set_condition: int = 0   # set_condition launches (one per node reached)

    def reset(self):
        self.set_condition = 0


COUNTS = Counts()


def _count():
    COUNTS.set_condition += 1


_STREAMS = {}          # device -> body streams, one per nesting depth
# nst_if_begin's steps, for the error of a failed one
_BEGIN_STEPS = ("an error left by an earlier call", "the capture's state",
                "the conditional handle", "set_condition's launch",
                "the capture's state", "the if node",
                "the capture's dependencies", "the body's capture")


class IfNodes:
    """If nodes in the captures of one model's graphs on ``device``."""

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
        """Allocations of every stream but the capturing one go to
        ``pool`` (open inside ``torch.cuda.graph``, after its own
        route)."""
        index = self.device.index
        torch._C._cuda_beginAllocateToPool(index, self.pool)
        self._routes += 1
        try:
            yield self
        finally:
            torch._C._cuda_endAllocateToPool(index, self.pool)

    def body(self, flag, fn):
        """Capture ``fn`` under an if node on the 0-d bool CUDA tensor
        ``flag`` (read when the graph reaches the node)."""
        from navierstokes_tpu_torch.kernels.build import library
        if (flag.dtype != torch.bool or flag.numel() != 1
                or flag.device != self.device):
            raise ValueError(f"an if node's flag must be one bool on "
                             f"{self.device} (got {flag.dtype} "
                             f"{tuple(flag.shape)} on {flag.device})")
        if self.depth == len(self.streams):
            raise RuntimeError(f"if nodes nested deeper than {self.depth}")
        lib = library()
        count(_count)               # in the record of the node's parent
        parent = torch.cuda.current_stream(self.device)
        stream = self.streams[self.depth]
        step = ctypes.c_int(0)
        rc = lib.nst_if_begin(parent.cuda_stream, flag.data_ptr(),
                              stream.cuda_stream, ctypes.byref(step))
        _check(lib, f"nst_if_begin (step {step.value}, "
               f"{_BEGIN_STEPS[step.value]})", rc)
        self.depth += 1
        try:
            with torch.cuda.stream(stream):
                fn()
        finally:
            self.depth -= 1
            rc = lib.nst_if_end(stream.cuda_stream)
        _check(lib, "nst_if_end", rc)

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
