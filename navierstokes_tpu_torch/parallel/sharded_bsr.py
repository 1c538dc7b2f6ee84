"""The bsr operator split by rows over several devices.

Port of the JAX model's ``_apply_gspmd_sharding``
(navierstokes_tpu/models/navier_stokes.py:413-460), which puts the bsr
operator's block rows and the per-cell convection inputs on a 1-D device
mesh and leaves the DoF vectors replicated.  The port does it in one
process:

* ``ShardedBsr`` cuts the one-device build (``ops/bsr.build_bsr``) into
  one ``BsrData`` piece per shard (``parallel/sharding.row_partition``):
  F, A0 and the mass on the shard's velocity rows, G on their DoF rows, B
  and the PCD pattern on the shard's pressure rows (columns stay
  global), each re-laid by ``ops/sell.build_sell``; and segment plans
  from the element entries of those rows into the shard's own slots,
  cut from the global plans;
* ``ShardedBsrOps`` is ``ops/bsr.BsrOps`` over those pieces: every product
  copies x from the home device to each shard's device, launches the SELL
  kernel there and concatenates the row blocks on the home device; the
  per-step element matrices (the convection and the PCD pressure
  convection) are computed once on the home device for all cells, as on
  one device, and each shard's plan reduces the entries of its rows into
  its slots;
* the block-Jacobi tiles are built, inverted and applied per shard
  (``block_jacobi_*``; row ranges fall on tile multiples), with the
  exact-inverse guard decided over all shards at once.

The vectors, the Krylov solvers and the pressure side (Ap, the pinned P1
Laplacian, the V-cycles, the coarse inverses, the lumped masses and the
Schur coarse plan) stay on the home device, as JAX leaves them
replicated.  A row keeps its nonzeros in ascending column order in its
slots, and the kernel and its plain version sum a lane's slots in slot
order from zero, so a shard's rows are bit for bit the unsharded rows;
the convection plans keep every slot's entries in the global order.
The element matrices stay whole on the home device because cuBLAS picks
its fp32 GEMM kernel by the row count: a shard's own (cells x 12) by
(12 x 36) product rounds differently from the one-device product of all
cells (measured on an H100 at 100-700 cells); for the same reason no
shard takes a single tile (``row_partition``).
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from navierstokes_tpu_torch.kernels.sell_spmv import sell_spmv
from navierstokes_tpu_torch.ops.bsr import (BsrData, BsrOps, apply_b,
                                            apply_f, apply_pp,
                                            float64_tables,
                                            pressure_convection_elements,
                                            schur_diag)
from navierstokes_tpu_torch.ops.operators import (SegmentPlan,
                                                  convection_matrices,
                                                  segment_plan)
from navierstokes_tpu_torch.ops.p1ell import (block_jacobi_apply as _bj_apply,
                                              block_jacobi_inverse as _bj_inv,
                                              block_jacobi_invert_parts,
                                              build_block_jacobi_plan)
from navierstokes_tpu_torch.ops.sell import SellMatrix, build_sell
from navierstokes_tpu_torch.parallel.sharding import row_partition


class ShardVals:
    """Compact values held per shard (F values, the mass, the PCD
    convection, tile stacks): one tensor per shard, on its device."""

    def __init__(self, parts):
        self.parts = list(parts)

    def __add__(self, other: "ShardVals") -> "ShardVals":
        return ShardVals(a + b for a, b in zip(self.parts, other.parts))

    def to(self, dtype) -> "ShardVals":
        return ShardVals(p.to(dtype) for p in self.parts)

    def double(self) -> "ShardVals":
        return self.to(torch.float64)


@dataclasses.dataclass
class Shard:
    device: torch.device
    rows: tuple              # velocity nodes [r0, r1)
    prows: tuple             # pressure nodes [q0, q1)
    bsr: BsrData             # the rows' operators (global columns); no
    #                          element inputs (``ShardedBsr.cells``)
    f_nz: tuple              # the global F nonzeros held, [a, b)


@dataclasses.dataclass
class ElementInputs:
    """The element inputs of the per-step convection (ops/operators.
    convection_matrices) and PCD pressure convection (ops/bsr.
    pressure_convection_elements), all cells, on the home device."""
    cell_p2: torch.Tensor
    detj: torch.Tensor
    jinv: torch.Tensor
    t_hat: torch.Tensor
    tp_hat: torch.Tensor
    curv_ids: object = None
    curv_nodes: object = None
    curv_phi: object = None
    curv_dphys: object = None


def _plan_targets(plan: SegmentPlan, n_flat: int) -> np.ndarray:
    """The segment each flat entry of ``plan`` sums into."""
    tgt = np.full(n_flat, -1, np.int64)
    if plan.order is not None:
        tgt[plan.order.cpu().numpy()] = np.repeat(
            np.arange(plan.num_segments), plan.lengths.cpu().numpy())
    for src, dst in plan.passes:
        tgt[src.cpu().numpy()] = dst.cpu().numpy()
    return tgt


def _entry_nz(plan: SegmentPlan, mat: SellMatrix, n_flat: int):
    """The nonzero of ``mat`` each element entry of ``plan`` sums into."""
    slot_nz = np.full(mat.n_slots, -1, np.int64)
    slot_nz[mat.nz_slot] = np.arange(mat.nnz)
    return slot_nz[_plan_targets(plan, n_flat)]


def _sub_plan(plan: SegmentPlan, entry_nz, mat: SellMatrix, sub: SellMatrix,
              row0: int, row1: int, cells, n_e: int, device):
    """The plan of a shard's slots: of the element entries of ``cells``
    (n_e per cell, flat index c * n_e + e in the one-device element
    array), those whose nonzero lies in rows [row0, row1) of ``mat``, into
    the slots of the shard's pattern ``sub``, with the global plan's
    method.  The entries keep their global order, so every slot sums the
    same entries in the same order as the global plan."""
    e = (cells[:, None] * n_e + np.arange(n_e)).reshape(-1)
    nz = entry_nz[e]
    keep = (mat.nz_row[nz] >= row0) & (mat.nz_row[nz] < row1)
    nz0 = np.searchsorted(mat.nz_row, row0)
    return segment_plan(sub.nz_slot[nz[keep] - nz0], sub.n_slots, device,
                        passes=bool(plan.passes), pos=e[keep])


def _rows(mat: SellMatrix, row0: int, row1: int, device, name: str):
    """(rows [row0, row1) of ``mat`` as a pattern on ``device``, the range
    of ``mat``'s nonzeros they hold)."""
    a, b = np.searchsorted(mat.nz_row, [row0, row1])
    sub = build_sell(mat.nz_row[a:b] - row0, mat.nz_col[a:b], row1 - row0,
                     mat.n_cols, device, name)
    return sub, (int(a), int(b))


def _nz_values(mat: SellMatrix, vals: torch.Tensor) -> np.ndarray:
    """The per-nonzero values of ``vals`` (float64 copies of its dtype's
    values, so re-laying them is exact)."""
    return vals.cpu()[torch.as_tensor(mat.nz_slot)].double().numpy()


def operator_bytes(obj) -> int:
    """Bytes of the tensors a BsrData (a piece or the one-device build)
    holds: patterns, plans, values."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, SegmentPlan):
        return sum(operator_bytes(t) for pair in obj.passes for t in pair) + \
            operator_bytes(obj.order) + operator_bytes(obj.lengths)
    if isinstance(obj, SellMatrix):
        return operator_bytes(obj.cols) + operator_bytes(obj.slice_ptr) + \
            operator_bytes(obj.rows)
    if dataclasses.is_dataclass(obj):
        return sum(operator_bytes(getattr(obj, f.name))
                   for f in dataclasses.fields(obj))
    return 0


class ShardedBsr:
    """The operators of ``full`` (an ``ops/bsr.build_bsr`` build, best made
    on the CPU; ``cell_p1`` the space's cell -> P1 node map) split by rows
    over ``devices``, with the vectors on ``home``.  ``tile`` is the
    block-Jacobi tile in nodes (S * bu): shard bounds fall on its
    multiples.  Shards that get no rows (fewer than two tiles per
    device) are left out.  Carries the one-device build's host record and sizes
    (``host``, ``bu``, ``bp``, ``n_p2``, ``n_p1``, ``n_vb``, ``n_pb``)
    for the pressure side's setup."""

    def __init__(self, full: BsrData, cell_p1, home, devices, tile: int):
        self.home = torch.device(home)
        vel, pres = row_partition(full.n_p2, full.n_p1, len(devices), tile)
        for name in ("host", "bu", "bp", "n_p2", "n_p1", "n_vb", "n_pb"):
            setattr(self, name, getattr(full, name))
        self.dim = full.g.n_rows // full.n_p2
        self._f_slot = full.f.nz_slot            # for ``unshard``
        self._f_slots = full.f.n_slots
        cp2 = full.cell_p2.cpu().numpy()
        cp1 = np.asarray(cell_p1, np.int64)
        nc, nv = cp2.shape
        npp = cp1.shape[1]
        f_enz = _entry_nz(full.conv_plan, full.f, nc * nv * nv)
        p_enz = _entry_nz(full.pp_plan, full.pp, nc * npp * npp)
        g_nz = _nz_values(full.g, full.g_vals)
        b_nz = _nz_values(full.b, full.b_vals)
        d_key = full.f.nz_row * full.n_p2 + full.f.nz_col
        diag_nz = np.searchsorted(
            d_key, np.arange(full.n_p2, dtype=np.int64) * (full.n_p2 + 1))
        dtype = full.g_vals.dtype
        on_home = lambda t: None if t is None else t.to(self.home)
        self.cells = ElementInputs(**{
            f.name: on_home(getattr(full, f.name))
            for f in dataclasses.fields(ElementInputs)})
        self.shards = []
        for k, dev in enumerate(devices):
            r0, r1 = (int(v) for v in vel[k:k + 2])
            q0, q1 = (int(v) for v in pres[k:k + 2])
            if r1 == r0:
                continue
            if q1 == q0:
                raise ValueError(f"shard {k} holds velocity nodes "
                                 f"[{r0}, {r1}) but no pressure node")
            cells = np.nonzero(((cp2 >= r0) & (cp2 < r1)).any(axis=1)
                               | ((cp1 >= q0) & (cp1 < q1)).any(axis=1))[0]
            f, f_nz = _rows(full.f, r0, r1, dev, "F")
            g, g_rng = _rows(full.g, r0 * self.dim, r1 * self.dim, dev, "G")
            b, b_rng = _rows(full.b, q0, q1, dev, "B")
            pp, _ = _rows(full.pp, q0, q1, dev, "PP")
            piece = BsrData(
                cell_p2=None, detj=None, jinv=None, t_hat=None, f=f,
                conv_plan=_sub_plan(full.conv_plan, f_enz, full.f, f, r0, r1,
                                    cells, nv * nv, dev),
                diag_slot=torch.as_tensor(
                    f.nz_slot[diag_nz[r0:r1] - f_nz[0]], device=dev),
                m_vals=(None if full.m_vals is None else
                        f.values(self.host.m_nz[f_nz[0]:f_nz[1]], dtype)),
                g=g, g_vals=g.values(g_nz[g_rng[0]:g_rng[1]], dtype),
                b=b, b_vals=b.values(b_nz[b_rng[0]:b_rng[1]], dtype),
                n_p2=full.n_p2, n_p1=full.n_p1, bu=full.bu, bp=full.bp,
                n_vb=full.n_vb, n_pb=full.n_pb, host=None, pp=pp,
                pp_plan=_sub_plan(full.pp_plan, p_enz, full.pp, pp, q0, q1,
                                  cells, npp * npp, dev))
            self.shards.append(Shard(device=dev, rows=(r0, r1),
                                     prows=(q0, q1), bsr=piece, f_nz=f_nz))

    # ---- values -------------------------------------------------------

    def f_values(self, nz_values, dtype) -> ShardVals:
        """Per-shard compact values of per-nonzero F-pattern values (the
        one-device ``f.values``)."""
        return ShardVals(s.bsr.f.values(nz_values[s.f_nz[0]:s.f_nz[1]],
                                        dtype) for s in self.shards)

    def unshard(self, vals: ShardVals) -> torch.Tensor:
        """F-pattern values in the one-device compact layout, on the home
        device (the same values, moved)."""
        out = vals.parts[0].new_zeros(self._f_slots, device=self.home)
        for s, v in zip(self.shards, vals.parts):
            a, b = s.f_nz
            out[torch.as_tensor(self._f_slot[a:b], device=self.home)] = \
                v[torch.as_tensor(s.bsr.f.nz_slot, device=v.device)].to(
                    self.home)
        return out

    def with_pieces(self, fn) -> "ShardedBsr":
        """A copy with every piece replaced by ``fn(piece)``."""
        out = copy.copy(self)
        out.shards = [dataclasses.replace(s, bsr=fn(s.bsr))
                      for s in self.shards]
        return out

    def shard_bytes(self) -> list[int]:
        """Bytes each shard's piece holds on its device (the element
        inputs, ``cells``, stay on the home device)."""
        return [operator_bytes(s.bsr) for s in self.shards]

    # ---- moving vectors ----------------------------------------------

    def put(self, x: torch.Tensor) -> list[torch.Tensor]:
        """``x`` (on the home device) on each shard's device, copied once
        per device."""
        there = {}
        for s in self.shards:
            if s.device not in there:
                there[s.device] = x.to(s.device)
        return [there[s.device] for s in self.shards]

    def gather(self, ys) -> torch.Tensor:
        """The shards' row blocks, concatenated on the home device."""
        return torch.cat([y.to(self.home) for y in ys])


class ShardedBsrOps(BsrOps):
    """``ops/bsr.BsrOps`` over a ShardedBsr: F-pattern values are
    ShardVals, vectors live on the home device."""

    def convection(self, sb: ShardedBsr, u):
        c = convection_matrices(sb.cells, sb.cells.t_hat, u).reshape(-1)
        return ShardVals(s.bsr.conv_plan(x)
                         for s, x in zip(sb.shards, sb.put(c)))

    def apply_f(self, sb: ShardedBsr, f_vals: ShardVals, xu):
        return sb.gather(apply_f(s.bsr, v, x) for s, v, x in
                         zip(sb.shards, f_vals.parts, sb.put(xu)))

    def apply_bt(self, sb: ShardedBsr, p):
        return sb.gather(
            sell_spmv(s.bsr.g, s.bsr.g_vals, x.contiguous()).view(-1, sb.dim)
            for s, x in zip(sb.shards, sb.put(p)))

    def apply_b(self, sb: ShardedBsr, xu):
        return sb.gather(apply_b(s.bsr, x)
                         for s, x in zip(sb.shards, sb.put(xu)))

    def mass_apply(self, sb: ShardedBsr, u):
        return self.apply_f(sb, ShardVals(s.bsr.m_vals for s in sb.shards),
                            u)

    def f_diag(self, sb: ShardedBsr, f_vals: ShardVals):
        return sb.gather(v[s.bsr.diag_slot]
                         for s, v in zip(sb.shards, f_vals.parts))

    def schur_diag(self, sb: ShardedBsr, node_weights):
        return sb.gather(schur_diag(s.bsr, w) for s, w in
                         zip(sb.shards, sb.put(node_weights)))

    def pressure_convection(self, sb: ShardedBsr, u):
        e = pressure_convection_elements(sb.cells, u).reshape(-1)
        return ShardVals(s.bsr.pp_plan(x)
                         for s, x in zip(sb.shards, sb.put(e)))

    def apply_pp(self, sb: ShardedBsr, pp_vals: ShardVals, xp):
        return sb.gather(apply_pp(s.bsr, v, x) for s, v, x in
                         zip(sb.shards, pp_vals.parts, sb.put(xp)))

    def float64_tables(self, sb: ShardedBsr) -> ShardedBsr:
        return sb.with_pieces(float64_tables)


# ---------------------------------------------------------------------------
# block-Jacobi tiles per shard
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ShardedTilePlan:
    """One ops/p1ell.BlockJacobiPlan per shard, over its own rows."""
    plans: list
    sb: ShardedBsr


def block_jacobi_plan(sb: ShardedBsr, S: int) -> ShardedTilePlan:
    return ShardedTilePlan(plans=[
        build_block_jacobi_plan(s.bsr.f, sb.bu, s.rows[1] - s.rows[0], S,
                                s.device, col0=s.rows[0])
        for s in sb.shards], sb=sb)


def _parts(plan: ShardedTilePlan, f_vals: ShardVals, mask_flat, sigma):
    return [(p, v, mask_flat[s.rows[0]:s.rows[1]].to(s.device),
             sigma.to(s.device))
            for p, v, s in zip(plan.plans, f_vals.parts, plan.sb.shards)]


def block_jacobi_inverse(plan: ShardedTilePlan, f_vals: ShardVals,
                         mask_flat, sigma) -> ShardVals:
    """Exact tile inverses per shard (the Newton seed)."""
    return ShardVals(_bj_inv(*part)
                     for part in _parts(plan, f_vals, mask_flat, sigma))


def block_jacobi_invert(plan: ShardedTilePlan, f_vals: ShardVals, mask_flat,
                        sigma, x0: ShardVals | None = None,
                        iters: int = 3, out_dtype=None) -> ShardVals:
    """ops/p1ell.block_jacobi_invert per shard, the guard over all."""
    parts = _parts(plan, f_vals, mask_flat, sigma)
    x0s = [None] * len(parts) if x0 is None else x0.parts
    return ShardVals(block_jacobi_invert_parts(
        [part + (x,) for part, x in zip(parts, x0s)], iters, out_dtype))


def block_jacobi_apply(plan: ShardedTilePlan, inv_tiles: ShardVals, r):
    """blockdiag(F_t)^-1 r for r (n_p2, d) on the home device."""
    sb = plan.sb
    return sb.gather(
        _bj_apply(p, t, r[s.rows[0]:s.rows[1]].to(s.device))
        for p, t, s in zip(plan.plans, inv_tiles.parts, sb.shards))
