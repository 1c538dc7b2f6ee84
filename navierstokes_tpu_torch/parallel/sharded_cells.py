"""The generic element ("cells") operator split by cells over several
devices.

Port of ``navierstokes_tpu/parallel/sharded_ops.py`` (``shard_problem``,
``ShardedOps``), the JAX package's multi-device path for every
Taylor-Hood pair other than P2/P1 and for ``operator="cells"``: the cell
arrays and their scatter plans sharded on a 1-D device axis, the DoF
vectors replicated, and one ``psum`` per operator product.  The port does
it in one process:

* ``ShardedCells`` cuts the cells into ``n`` contiguous blocks of
  ceil(n_cells / n) cells, JAX's ``reshape(d, -1)`` split.  JAX pads the
  cell set to a multiple of ``n`` with zero cells; the port leaves the
  last block short instead (and drops a block that gets no cell), so no
  shard carries padding.  Each shard holds its own ``CellArrays`` slice
  (``cell_p2``, ``cell_p1``, ``detj``, ``jinv``, ``mass``, ``stiff``,
  ``grad``) on its device, the curved cells that fall in its block (their
  ids made local), ``T_hat`` and its own segment plans from its cells into
  the global ``n_p2`` and ``n_p1`` nodes (JAX's per-shard stable argsort);
* ``ShardedCellOps`` has the interface of ``ops/operators.CellOps``
  (``convection``, ``apply_blocks``, ``f_diag``, ``mass_apply``,
  ``schur_diag``): every product copies its input vector to each shard's
  device, runs the local gather, einsum and plan sum there, and the home
  device adds the shards' partial node sums in shard order 0..n-1 (JAX's
  ``psum``, in a fixed order with no atomics).  Per-cell values (the F
  matrices of a step, A0) are ``ShardVals``, one tensor per shard.

The curved-cell convection fix, which JAX applies outside its sharded
region on replicated data indexed by global cell id, runs inside each
shard on the shard's own curved cells.  The vectors, the Krylov solvers
and the preconditioners' vectors stay on the home device, as JAX keeps
them replicated.

One shard equals ``CellOps`` bit for bit.  More shards are not bit for
bit with one device: the sum over a node's cells is taken per shard and
then across shards, and on the card a shard's einsum over its own cells
may round differently from the whole-cell einsum (cuBLAS picks its
kernel by the batch, ``parallel/sharded_bsr.py``).  JAX's sharded path
differs from its one-device path in the same way
(tests/test_sharding.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from navierstokes_tpu_torch.ops.assembly import (CellArrays,
                                                 curved_conv_inputs)
from navierstokes_tpu_torch.ops.operators import (SegmentPlan, apply_blocks,
                                                  convection_matrices,
                                                  f_diag, mass_apply,
                                                  schur_diag, segment_plan)
from navierstokes_tpu_torch.parallel.sharded_bsr import (ShardVals,
                                                         operator_bytes)


def cell_blocks(n_cells: int, n: int) -> np.ndarray:
    """(n + 1,) int64 bounds of ``n`` contiguous blocks of
    ceil(n_cells / n) cells, the last one short (JAX's padded
    ``reshape(n, -1)`` without the padding); blocks past the end are
    empty."""
    if n < 1:
        raise ValueError(f"cell_blocks: {n} shards")
    per = -(-n_cells // n)
    return np.minimum(np.arange(n + 1, dtype=np.int64) * per, n_cells)


@dataclasses.dataclass
class CellShard:
    device: torch.device
    cells: tuple             # global cells [c0, c1)
    arrays: CellArrays       # the block's rows; curved ids local
    t_hat: torch.Tensor      # the reference convection tensor
    scat_v: SegmentPlan      # (cell, velocity node) entries -> n_p2 nodes
    scat_p: SegmentPlan      # (cell, pressure node) entries -> n_p1 nodes


class ShardedCells:
    """The cell arrays of ``host`` (ops/assembly.cell_arrays_numpy of
    ``space``) split into contiguous blocks over ``devices``, in the
    compute ``dtype``, with the vectors on ``home``."""

    def __init__(self, space, host: CellArrays, t_hat: np.ndarray, dtype,
                 home, devices):
        self.home = torch.device(home)
        self.n_cells = int(np.asarray(host.cell_p2).shape[0])
        bounds = cell_blocks(self.n_cells, len(devices))
        ci, cn, cphi, cdphys = curved_conv_inputs(space)
        self.shards = []
        for k, dev in enumerate(devices):
            c0, c1 = (int(b) for b in bounds[k:k + 2])
            if c1 == c0:
                continue
            f = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
            i = lambda a: torch.as_tensor(np.asarray(a, np.int64),
                                          device=dev)
            curved = {}
            if ci is not None:
                sel = (ci >= c0) & (ci < c1)
                if sel.any():
                    curved = dict(curv_ids=i(ci[sel] - c0),
                                  curv_nodes=i(cn[sel]), curv_phi=f(cphi),
                                  curv_dphys=f(cdphys[sel]))
            rows = slice(c0, c1)
            cp2 = np.asarray(host.cell_p2)[rows]
            cp1 = np.asarray(host.cell_p1)[rows]
            arrays = CellArrays(
                cell_p2=i(cp2), cell_p1=i(cp1), detj=f(host.detj[rows]),
                jinv=f(host.jinv[rows]), mass=f(host.mass[rows]),
                stiff=f(host.stiff[rows]), grad=f(host.grad[rows]),
                **curved)
            self.shards.append(CellShard(
                device=torch.device(dev), cells=(c0, c1), arrays=arrays,
                t_hat=f(t_hat), scat_v=segment_plan(cp2, space.n_p2, dev),
                scat_p=segment_plan(cp1, space.n_p1, dev)))

    def static(self, ct_dt: float, nu: float) -> ShardVals:
        """A0 = ct_dt M + nu K per shard."""
        return ShardVals(ct_dt * s.arrays.mass + nu * s.arrays.stiff
                         for s in self.shards)

    def put(self, x: torch.Tensor) -> list[torch.Tensor]:
        """``x`` (on the home device) on each shard's device, copied once
        per device."""
        there = {}
        for s in self.shards:
            if s.device not in there:
                there[s.device] = x.to(s.device)
        return [there[s.device] for s in self.shards]

    def reduce(self, parts) -> torch.Tensor:
        """The shards' partial node sums added on the home device in shard
        order (JAX's psum in a fixed order)."""
        out = None
        for y in parts:
            y = y.to(self.home)
            out = y if out is None else out + y
        return out

    def unshard(self, vals: ShardVals) -> torch.Tensor:
        """Per-cell values in global cell order on the home device."""
        return torch.cat([v.to(self.home) for v in vals.parts])

    def shard_bytes(self) -> list[int]:
        """Bytes each shard holds on its device: its cell arrays, curved
        data, T_hat and plans."""
        return [operator_bytes(s) for s in self.shards]


class ShardedCellOps:
    """``ops/operators.CellOps`` over a ShardedCells: per-cell values are
    ShardVals, vectors live on the home device."""

    def convection(self, sc: ShardedCells, u):
        return ShardVals(convection_matrices(s.arrays, s.t_hat, x)
                         for s, x in zip(sc.shards, sc.put(u)))

    def apply_blocks(self, sc: ShardedCells, f_cell: ShardVals, xu, xp,
                     with_f=True, with_g=True, with_gt=True):
        ys = [apply_blocks(s.arrays, f, s.scat_v, s.scat_p, a, b,
                           with_f=with_f, with_g=with_g, with_gt=with_gt)
              for s, f, a, b in zip(sc.shards, f_cell.parts, sc.put(xu),
                                    sc.put(xp))]
        return sc.reduce(y for y, _ in ys), sc.reduce(y for _, y in ys)

    def f_diag(self, sc: ShardedCells, f_cell: ShardVals):
        return sc.reduce(f_diag(s.arrays, f, s.scat_v)
                         for s, f in zip(sc.shards, f_cell.parts))

    def mass_apply(self, sc: ShardedCells, u):
        return sc.reduce(mass_apply(s.arrays, s.scat_v, x)
                         for s, x in zip(sc.shards, sc.put(u)))

    def schur_diag(self, sc: ShardedCells, node_weights):
        return sc.reduce(schur_diag(s.arrays, w, s.scat_p)
                         for s, w in zip(sc.shards, sc.put(node_weights)))
