"""Carry state and operator values from the JAX package into the port.

Everything crosses as numpy arrays, so this module imports no jax:
callers pass ``np.asarray(...)`` of the JAX arrays.  The JAX package keeps
its operators in blocked ELLs; ``coo_from_blocked_ell`` lists their
entries and ``sell_values_from_coo`` places them in the slots of one of
the port's compact patterns (ops/sell.py).  Checkpoints need no
conversion: both packages read and write the ``state-ns-<step>.npz``
schema (utils/checkpoint.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from navierstokes_tpu_torch.ops.sell import SellMatrix


@dataclasses.dataclass
class State:
    """Time-stepping state of either scheme."""
    u: torch.Tensor          # (n_p2, dim)
    p: torch.Tensor          # (n_p1,)
    u_prev: torch.Tensor     # (n_p2, dim) velocity at the previous step
    phi: torch.Tensor        # (n_p1,) last pressure increment (projection;
    #                          under proj_p_extrap the whole change
    #                          p^n - p^{n-1}; the monolithic step passes
    #                          it through)
    time: float


def state_from_jax_numpy(u, p, u_prev, phi, t, device, dtype) -> State:
    kw = dict(dtype=dtype, device=device)
    return State(u=torch.as_tensor(np.array(u), **kw),
                 p=torch.as_tensor(np.array(p), **kw),
                 u_prev=torch.as_tensor(np.array(u_prev), **kw),
                 phi=torch.as_tensor(np.array(phi), **kw), time=float(t))


def blocked_ell_phys_rows(n_ext: int, n_phys: int, ovf_rows=None,
                          spill=None) -> np.ndarray:
    """Physical row of each of the ``n_ext`` rows of a JAX blocked ELL:
    rows below ``n_phys`` are their own; a virtual overflow row maps to its
    ``ovf_rows`` entry (the F table) or to the row whose ``spill`` entry
    names it (the split G and B tables)."""
    phys = np.arange(n_ext)
    if ovf_rows is not None:
        phys[n_phys:] = np.asarray(ovf_rows, np.int64)[:n_ext - n_phys]
    if spill is not None:
        spill = np.asarray(spill, np.int64)
        r, k = np.nonzero(spill < n_ext)
        phys[spill[r, k]] = r
    return phys


def coo_from_blocked_ell(vals, cols, phys_rows=None):
    """(row, col, value) of every stored entry of a JAX blocked-ELL value
    array ``vals`` (n_ext, R, K*cb) with block columns ``cols`` (n_ext, K):
    entry (v, i, c) sits at row phys_rows[v]*R + i and column
    cols[v, c // cb]*cb + c % cb.  ``phys_rows`` maps virtual overflow rows
    to their physical row (default: the identity).  Padding entries come
    out with value 0."""
    vals = np.asarray(vals, np.float64)
    cols = np.asarray(cols, np.int64)
    n_ext, R, cw = vals.shape
    cb = cw // cols.shape[1]
    phys = (np.arange(n_ext) if phys_rows is None
            else np.asarray(phys_rows, np.int64))
    v, i, c = np.meshgrid(np.arange(n_ext), np.arange(R), np.arange(cw),
                          indexing="ij")
    return (phys[v] * R + i).ravel(), (cols[v, c // cb] * cb
                                       + c % cb).ravel(), vals.ravel()


def sell_values_from_coo(mat: SellMatrix, row, col, val, dtype,
                         device=None) -> torch.Tensor:
    """Compact values of ``mat`` from a COO list (duplicates summed).  An
    entry outside the pattern must be 0 (the padding of a blocked ELL)."""
    row, col = np.asarray(row, np.int64), np.asarray(col, np.int64)
    val = np.asarray(val, np.float64)
    nz_key = mat.nz_row * mat.n_cols + mat.nz_col
    key = row * mat.n_cols + col
    pos = np.minimum(np.searchsorted(nz_key, key), len(nz_key) - 1)
    inside = nz_key[pos] == key
    if np.any(val[~inside] != 0):
        raise ValueError(f"{int(np.count_nonzero(val[~inside]))} nonzero "
                         "entries outside the compact pattern")
    nz = np.bincount(pos[inside], weights=val[inside],
                     minlength=len(nz_key))
    return mat.values(nz, dtype, device)
