"""Sliced ELLPACK (SELL-C-sigma) sparsity patterns of the port's operators.

Every sparse operator of the step (F and the mass, G, B, the P1
Laplacian, Ap and the PCD pressure convection) keeps only its nonzeros,
in the layout the Hopper kernel reads (``kernels/sell_spmv.py``):

* rows are sorted by their nonzero count, longest first, inside windows
  of ``SIGMA`` consecutive rows (the Hilbert node order makes a window a
  compact spatial patch, so the column gather stays local);
* consecutive runs of ``C`` = 32 sorted rows form a slice, one warp on
  the card, one row per lane; a slice is padded only to its own longest
  row (its width w);
* inside a slice, slot j of lane l sits at

      ptr + (j // 4) * 128 + l * 4 + j % 4     for j < 4 * (w // 4)
      ptr + (w // 4) * 128 + (j % 4) * 32 + l  for the w % 4 last slots,

  so a lane reads its slots four at a time as one 16-byte load (fp32
  values, int32 columns) and a warp's load covers 512 neighbouring bytes;
* ``rows`` maps each lane back to its output row (-1 for the lanes that
  pad the last slice); padding slots hold value 0 and a column of their
  own row, so they gather nothing new.

A row's nonzeros sit in its slots in ascending column order.  Values live
apart from the pattern (a flat (n_slots,) tensor), so static operators
(mass, G, B, Ap, the Laplacian) and per-step ones (F, the pressure
convection) share one product.  The JAX package's blocked ELL, shaped for
the TPU's 128-lane minor axis, stores 16x16 node blocks of which about 5%
are nonzero at the bench point; this layout stores 1.02 slots per nonzero
there (F: 5,283,264 slots for 5,158,502 nonzeros).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

C = 32          # rows per slice: one warp, one row per lane
G = 4           # slots per 16-byte group of a lane
SIGMA = 1024    # rows per sorting window


@dataclasses.dataclass
class SellMatrix:
    """A SELL-C-sigma pattern on the device, with the host record of where
    each nonzero went."""
    cols: torch.Tensor       # (n_slots,) int32 column of each slot
    slice_ptr: torch.Tensor  # (n_slices + 1,) int32 first slot of a slice
    rows: torch.Tensor       # (n_slices * C,) int32 output row of a lane
    n_rows: int
    n_cols: int
    name: str                # the operator, for the launch counts
    # host: the nonzeros in (row, col) order and the slot of each
    nz_row: np.ndarray       # (nnz,) int64
    nz_col: np.ndarray       # (nnz,) int64
    nz_slot: np.ndarray      # (nnz,) int64

    @property
    def n_slots(self) -> int:
        return int(self.cols.shape[0])

    @property
    def nnz(self) -> int:
        return len(self.nz_row)

    def values(self, nz_values, dtype, device=None) -> torch.Tensor:
        """(n_slots,) tensor of the per-nonzero values ``nz_values`` (in
        this pattern's (row, col) order), zero in padding slots."""
        out = np.zeros(self.n_slots)
        out[self.nz_slot] = np.asarray(nz_values, np.float64)
        return torch.as_tensor(out, dtype=dtype,
                               device=self.cols.device if device is None
                               else device)

    def plain_order(self):
        """(order, lengths) of the plain product: every lane's slots in
        slot order, lane after lane, and each lane's slot count (its
        slice's width).  Built once, on the pattern's device."""
        if not hasattr(self, "_plain"):
            order, lane_w = _lane_slots(
                self.slice_ptr.cpu().numpy().astype(np.int64))
            dev = self.cols.device
            self._plain = (torch.as_tensor(order, device=dev),
                           torch.as_tensor(lane_w, device=dev))
        return self._plain


def _slot_in_slice(width, j, lane):
    """Offset of slot j of ``lane`` inside a slice of ``width`` slots."""
    n_grp = width // G
    return np.where(j < n_grp * G,
                    (j // G) * (C * G) + lane * G + j % G,
                    n_grp * (C * G) + (j - n_grp * G) * C + lane)


def _lane_slots(ptr):
    """Every lane's slots in slot order (lane-major) and each lane's
    width, for a slice pointer ``ptr`` (n_slices + 1,)."""
    width = (ptr[1:] - ptr[:-1]) // C
    lane_w = np.repeat(width, C)
    lane = np.arange(len(lane_w))
    rep = lambda a: np.repeat(a, lane_w)
    j = np.arange(int(lane_w.sum())) - rep(np.cumsum(lane_w) - lane_w)
    order = rep(ptr[:-1][lane // C]) + _slot_in_slice(rep(lane_w), j,
                                                      rep(lane % C))
    return order, lane_w


def build_sell(nz_row, nz_col, n_rows: int, n_cols: int, device,
               name: str = "", sigma: int = SIGMA) -> SellMatrix:
    """SELL-C-sigma pattern ``name`` of the nonzeros (nz_row, nz_col):
    unique pairs in (row, col) lexicographic order (``unique_pairs``)."""
    nz_row = np.asarray(nz_row, np.int64)
    nz_col = np.asarray(nz_col, np.int64)
    counts = np.bincount(nz_row, minlength=n_rows)
    # lane order: longest rows first inside each sigma-row window (stable)
    lane_row = np.lexsort((-counts, np.arange(n_rows) // sigma))
    n_lanes = -(-n_rows // C) * C
    lane_cnt = np.zeros(n_lanes, np.int64)
    lane_cnt[:n_rows] = counts[lane_row]
    width = lane_cnt.reshape(-1, C).max(axis=1)
    ptr = np.zeros(len(width) + 1, np.int64)
    np.cumsum(width * C, out=ptr[1:])
    if ptr[-1] >= 2 ** 31:
        raise ValueError(f"SELL pattern of {ptr[-1]} slots exceeds int32")
    lane_of_row = np.empty(n_rows, np.int64)
    lane_of_row[lane_row] = np.arange(n_rows)
    row_start = np.zeros(n_rows + 1, np.int64)
    np.cumsum(counts, out=row_start[1:])
    j = np.arange(len(nz_row)) - row_start[nz_row]
    lane = lane_of_row[nz_row]
    slot = ptr[lane // C] + _slot_in_slice(width[lane // C], j, lane % C)
    # padding slots: their lane's first column (0 for an empty lane)
    lane_col = np.zeros(n_lanes, np.int64)
    has = counts[lane_row] > 0
    lane_col[:n_rows][has] = nz_col[row_start[lane_row[has]]]
    order, lane_w = _lane_slots(ptr)
    cols = np.empty(int(ptr[-1]), np.int64)
    cols[order] = np.repeat(lane_col, lane_w)
    cols[slot] = nz_col
    rows = np.full(n_lanes, -1, np.int64)
    rows[:n_rows] = lane_row
    i32 = lambda a: torch.as_tensor(a.astype(np.int32), device=device)
    return SellMatrix(cols=i32(cols), slice_ptr=i32(ptr), rows=i32(rows),
                      n_rows=int(n_rows), n_cols=int(n_cols), name=name,
                      nz_row=nz_row,
                      nz_col=nz_col, nz_slot=slot)


def unique_pairs(row, col, n_cols: int):
    """The unique (row, col) pairs of a COO list in (row, col) order, and
    the index of each input entry's pair."""
    key = np.asarray(row, np.int64) * np.int64(n_cols) + np.asarray(
        col, np.int64)
    uk, inv = np.unique(key, return_inverse=True)
    return uk // n_cols, uk % n_cols, inv.reshape(-1)


def sell_from_coo(row, col, vals, n_rows: int, n_cols: int, device,
                  name: str = ""):
    """(pattern, per-nonzero float64 values) of a COO list, duplicates
    summed in input order (``np.bincount``, a fixed order)."""
    nz_row, nz_col, inv = unique_pairs(row, col, n_cols)
    nz_vals = np.bincount(inv, weights=np.asarray(vals, np.float64),
                          minlength=len(nz_row))
    return build_sell(nz_row, nz_col, n_rows, n_cols, device,
                      name), nz_vals
