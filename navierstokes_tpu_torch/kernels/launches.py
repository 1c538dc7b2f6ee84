"""Launch counts of the hand-written kernels under CUDA graph capture.

Each kernel wrapper adds one to its own counts (``kernels/sell_spmv.py``
``COUNTS``, ``kernels/arnoldi_lsq.py`` ``COUNTS``) where it launches its
kernel, through ``count``.  While a graph is being captured
(``record_launches``) a call launches nothing yet: ``count`` puts the
addition into the capture's ``LaunchRecord``, and whoever replays the
graph adds the record once per replay (models/step_graphs.py).  A body
under a conditional node has a record of its own, added once for each
time the body ran.
"""

from __future__ import annotations

import contextlib
import dataclasses


@dataclasses.dataclass
class LaunchRecord:
    """The launches a captured graph (or conditional body) makes: one
    (adder, arguments) per launch."""
    launches: list = dataclasses.field(default_factory=list)

    def replay(self, times: int = 1):
        """Add ``times`` replays' launches to the kernels' counts."""
        for _ in range(times):
            for adder, args in self.launches:
                adder(*args)


_RECORDING: list = []      # the records of the captures in progress


@contextlib.contextmanager
def record_launches():
    """Inside: launches go into the yielded LaunchRecord, not the kernels'
    counts (a graph or a conditional body being captured)."""
    rec = LaunchRecord()
    _RECORDING.append(rec)
    try:
        yield rec
    finally:
        _RECORDING.pop()


def count(adder, *args):
    """One launch: ``adder(*args)`` now, or into the innermost record of a
    capture in progress."""
    if _RECORDING:
        _RECORDING[-1].launches.append((adder, args))
    else:
        adder(*args)
