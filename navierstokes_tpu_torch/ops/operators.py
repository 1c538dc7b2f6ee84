"""Per-cell element operators and the presorted segment sum.

Port of ``navierstokes_tpu/ops/operators.py``:

* ``convection_matrices`` / ``curved_convection_fix``: c_ab = int phi_a
  ((u_old . grad) phi_b), the reference's T1 form
  (src/NavierStokes.cpp:204-208), as a contraction of the reference tensor
  T_hat with per-cell J^-1 u values; snapped (curved) cells get the
  quadratic-geometry quadrature version;
* ``SegmentPlan`` (JAX's ``Scatter``): a fixed-order segment sum;
* the generic element ("cells") operator, for any Taylor-Hood degree
  pair: gather the DoF values of each cell, contract them with the
  per-cell element matrices (batched einsums) and sum back into the nodes
  through segment plans (``apply_blocks``, ``f_diag``, ``schur_diag``,
  ``mass_apply``, ``lumped_mass``).  ``cells`` is an
  ops/assembly.CellArrays of tensors (``build_cell_arrays``);
* ``CellOps``: those products as the NavierStokes model's operator
  interface (``operator="cells"``), and ``EllCellOps`` for
  ``operator="ell"``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


# Plans whose targets have at most this many entries take the gather-add
# passes, the others torch.segment_reduce on the CPU and length buckets on
# the card.  At the bench point on an H100
# (tools/segment_plan_timing.py): the convection plan (at most 9 entries
# per F slot) 0.35 ms in passes against 6.20 ms, the PCD plan 0.18 against
# 0.85 ms; the Schur coarse plan, whose largest target collects the
# padding pairs of all G block rows (378,517 entries), 2.09 ms against
# 14.9 s in passes.
MAX_PASSES = 32


@dataclasses.dataclass
class SegmentPlan:
    """Presorted segment sum (n_flat,) -> (num_segments,), the JAX
    ``Scatter``: a fixed order with no atomics.

    Where every target has few entries (the element-to-operator plans: at
    most ~12 cells share a node pair) the sum runs as one pass per rank:
    pass k gathers every target's k-th entry and adds it in place, each
    target at most once per pass (``passes``: sequential sums in input
    order from zero, the same bits on the CPU and the card).  Plans with
    longer targets (the Schur coarse pairs) take, on the CPU,
    ``torch.segment_reduce`` (``order``/``lengths``), which sums in input
    order; on the card, whose segment_reduce reads the lengths on the host
    (no CUDA graph can capture it), length buckets: the targets whose
    entry count rounds up to the same power of two form one (targets,
    2^k) gather of their entries in input order, padded with a zero, and
    one row sum (``buckets``), a fixed order, bit-identical on repeat."""
    num_segments: int
    passes: tuple = ()       # ((src, dst), ...) int64, one pair per rank
    order: torch.Tensor | None = None     # stable argsort of the ids
    lengths: torch.Tensor | None = None   # entries per target
    # ((entries (targets, 2^k) int64, targets (targets,) int64), ...); the
    # entry -1 is the zero appended to the values
    buckets: tuple = ()

    def __call__(self, flat_values: torch.Tensor) -> torch.Tensor:
        """(n_flat, ...) -> (num_segments, ...)."""
        if self.order is not None:
            return torch.segment_reduce(flat_values[self.order], "sum",
                                        lengths=self.lengths, axis=0)
        if self.buckets:
            vals = torch.cat([flat_values, flat_values.new_zeros(
                (1,) + flat_values.shape[1:])])
            out = flat_values.new_zeros((self.num_segments,)
                                        + flat_values.shape[1:])
            for entries, targets in self.buckets:
                out[targets] = vals[entries].sum(dim=1)
            return out
        out = flat_values.new_zeros((self.num_segments,)
                                    + flat_values.shape[1:])
        for k, (src, dst) in enumerate(self.passes):
            if k == 0:
                out[dst] = flat_values[src]
            else:
                out[dst] += flat_values[src]
        return out


def segment_plan(ids, num_segments: int, device, passes=None,
                 pos=None, buckets=None) -> SegmentPlan:
    """The plan summing entry i into segment ``ids[i]``.  ``passes``
    forces the method (True: gather-add passes, False: segment_reduce, or
    length buckets where ``buckets`` is true, by default on the card;
    None: passes where no target has more than MAX_PASSES entries).
    ``pos`` places entry i at ``pos[i]`` of the flat values (default: i),
    for a plan over a subset of another plan's entries."""
    flat = np.asarray(ids, np.int64).reshape(-1)
    order = np.argsort(flat, kind="stable")
    lengths = np.bincount(flat, minlength=num_segments)
    t = lambda a: torch.as_tensor(a, device=device)
    pos = np.arange(len(flat)) if pos is None else np.asarray(pos, np.int64)
    if passes is None:
        passes = lengths.max(initial=0) <= MAX_PASSES
    if buckets is None:
        buckets = torch.device(device).type == "cuda"
    if not passes and not buckets:
        return SegmentPlan(num_segments=int(num_segments), order=t(pos[order]),
                           lengths=t(lengths))
    start = np.zeros(num_segments + 1, np.int64)
    np.cumsum(lengths, out=start[1:])
    if not passes:
        live = np.flatnonzero(lengths)
        width = 1 << np.ceil(np.log2(lengths[live])).astype(np.int64)
        by_width = []
        for w in np.unique(width):
            targets = live[width == w]
            k = np.arange(w)
            rows = np.minimum(start[targets][:, None] + k, len(flat) - 1)
            # entry -1 is the zero appended to the values
            entries = np.where(k < lengths[targets][:, None],
                               pos[order[rows]], -1)
            by_width.append((t(entries), t(targets)))
        return SegmentPlan(num_segments=int(num_segments),
                           buckets=tuple(by_width))
    seg = flat[order]
    rank = np.arange(len(flat)) - start[seg]
    # pass k: the entries of rank k, in input order
    by_rank = np.argsort(rank, kind="stable")
    groups = (np.split(by_rank, np.cumsum(np.bincount(rank))[:-1])
              if len(rank) else [])
    return SegmentPlan(num_segments=int(num_segments),
                       passes=tuple((t(pos[order[g]]), t(seg[g]))
                                    for g in groups))


def convection_matrices(cells, t_hat: torch.Tensor,
                        u: torch.Tensor) -> torch.Tensor:
    """(nc, n_v, n_v) convection element matrices.  ``cells`` carries
    cell_p2, jinv, detj and the curv_* fields (ops/bsr.BsrData or
    ops/assembly.CellArrays)."""
    nv = cells.cell_p2.shape[1]
    u_c = u[cells.cell_p2]                                # (nc, n_v, dim)
    w = torch.einsum("cxd,ced->cxe", cells.jinv, u_c)     # (nc, dim, n_v)
    w = w * cells.detj[:, None, None]
    dim = w.shape[1]
    tm = t_hat.permute(2, 3, 0, 1).reshape(dim * nv, nv * nv)
    c = w.reshape(-1, dim * nv) @ tm
    return curved_convection_fix(cells, c.reshape(-1, nv, nv), u)


def curved_convection_fix(cells, c_elem: torch.Tensor,
                          u: torch.Tensor) -> torch.Tensor:
    """Replace the curved cells' element matrices with
    c_ab = sum_q (w detJ)_q phi_a(q) u_d(q) (dphi_b/dx_d)(q); no-op on
    meshes without snapped boundaries."""
    ids = cells.curv_ids
    if ids is None:
        return c_elem
    u_k = u[cells.curv_nodes]                                  # (k, n_v, dim)
    u_q = torch.einsum("qe,ked->kqd", cells.curv_phi, u_k)
    c_k = torch.einsum("qa,kqd,kqbd->kab", cells.curv_phi, u_q,
                       cells.curv_dphys)
    c_elem = c_elem.clone()
    c_elem[ids] = c_k.to(c_elem.dtype)
    return c_elem


def apply_blocks(cells, f_cell: torch.Tensor, scat_v: SegmentPlan,
                 scat_p: SegmentPlan, xu: torch.Tensor, xp: torch.Tensor,
                 with_f=True, with_g=True, with_gt=True):
    """The monolithic block operator, each term optional:
    yu = F xu + G xp (momentum rows), yp = G^T xu (continuity rows);
    xu (n_p2, dim), xp (n_p1,) -> (yu, yp) of the same shapes."""
    nc, dim = cells.cell_p2.shape[0], cells.jinv.shape[1]
    yu_c = None
    if with_f or with_gt:
        xu_c = xu[cells.cell_p2]                          # (nc, n_v, dim)
    if with_f:
        yu_c = torch.einsum("cab,cbd->cad", f_cell, xu_c)
    if with_g:
        g_term = torch.einsum("cadj,cj->cad", cells.grad, xp[cells.cell_p1])
        yu_c = g_term if yu_c is None else yu_c + g_term
    yu = (scat_v(yu_c.reshape(-1, dim)) if yu_c is not None
          else torch.zeros_like(xu))
    if with_gt:
        yp_c = torch.einsum("cbdj,cbd->cj", cells.grad, xu_c)
        yp = scat_p(yp_c.reshape(nc * yp_c.shape[1]))
    else:
        yp = torch.zeros_like(xp)
    return yu, yp


def f_diag(cells, f_cell: torch.Tensor, scat_v_diag: SegmentPlan):
    """Diagonal of the velocity block F, one value per node: (n_p2,)
    (aSIMPLE's D = diag(F), src/NavierStokes.cpp:948-953)."""
    return scat_v_diag(torch.diagonal(f_cell, dim1=1, dim2=2).reshape(-1))


def schur_diag(cells, node_weights: torch.Tensor,
               scat_p_diag: SegmentPlan) -> torch.Tensor:
    """diag_S[j] = sum_{c,a,d} grad[c,a,d,j]^2 w[node(c,a)], the Jacobi
    scale of the inner Schur solves (the reference's ILU(S),
    src/NavierStokes.cpp:959).  Like the JAX cells path this sums squares
    of per-cell contributions, so for nodes shared by several cells it
    leaves out the cross-cell products of the assembled diag(B W B^T)
    (ops/bsr.schur_diag is exact): preconditioner quality only."""
    w_c = node_weights.reshape(-1)[cells.cell_p2]          # (nc, n_v)
    contrib = torch.einsum("cadj,cadj,ca->cj", cells.grad, cells.grad, w_c)
    return scat_p_diag(contrib.reshape(-1))


def mass_apply(cells, scat_v: SegmentPlan, u: torch.Tensor) -> torch.Tensor:
    """Consistent mass matrix times velocity: (n_p2, dim)."""
    r = torch.einsum("cab,cbd->cad", cells.mass, u[cells.cell_p2])
    return scat_v(r.reshape(-1, u.shape[1]))


def lumped_mass(cells, mlump_hat: torch.Tensor,
                scat_v_diag: SegmentPlan) -> torch.Tensor:
    """Abs-lumped mass per velocity node, sum_{q,j} |phi_j phi_i| JxW
    (src/NavierStokes.cpp:232-236): (n_p2,)."""
    return scat_v_diag((cells.detj[:, None] * mlump_hat[None, :]).reshape(-1))


class CellOps:
    """Operator interface of the NavierStokes model over CellArrays (the
    JAX ``SingleDeviceOps``), with the call shape of ops/bsr.BsrOps: the
    element operator summed into the velocity and pressure nodes by the
    plans ``scat_v`` (cell_p2) and ``scat_p`` (cell_p1)."""

    def __init__(self, space, t_hat: torch.Tensor, device):
        self.scat_v = segment_plan(space.cell_p2, space.n_p2, device)
        self.scat_p = segment_plan(space.cell_p1, space.n_p1, device)
        self.t_hat = t_hat

    def convection(self, cells, u):
        return convection_matrices(cells, self.t_hat, u)

    def apply_blocks(self, cells, f_cell, xu, xp, with_f=True, with_g=True,
                     with_gt=True):
        return apply_blocks(cells, f_cell, self.scat_v, self.scat_p, xu, xp,
                            with_f=with_f, with_g=with_g, with_gt=with_gt)

    def f_diag(self, cells, f_cell):
        return f_diag(cells, f_cell, self.scat_v)

    def mass_apply(self, cells, u):
        return mass_apply(cells, self.scat_v, u)

    def schur_diag(self, cells, node_weights):
        return schur_diag(cells, node_weights, self.scat_p)


class EllCellOps(CellOps):
    """CellOps under ``operator="ell"``, the JAX package's node-graph
    operator (its ops/ell.py): the same products, and for the Jacobi scale
    of the inner Schur solves the assembled diag(B W B^T) that JAX's graph
    gives, sum_{n,d} B[j,n,d]^2 w[n], where the cells path sums squares of
    the per-cell terms (``schur_diag``).  B's assembled entries are the
    per-cell terms summed per (velocity node, pressure node) pair."""

    def __init__(self, space, t_hat: torch.Tensor, device):
        super().__init__(space, t_hat, device)
        n_p1 = space.n_p1
        cp2 = np.asarray(space.cell_p2, np.int64)
        cp1 = np.asarray(space.cell_p1, np.int64)
        key = cp2[:, :, None] * n_p1 + cp1[:, None, :]     # (nc, n_v, n_p)
        pairs, pair_of = np.unique(key.reshape(-1), return_inverse=True)
        self.scat_pair = segment_plan(pair_of, len(pairs), device)
        self.pair_node = torch.as_tensor(pairs // n_p1, device=device)
        self.scat_pair_p = segment_plan(pairs % n_p1, n_p1, device)

    def schur_diag(self, cells, node_weights):
        dim = cells.grad.shape[2]
        b = self.scat_pair(cells.grad.permute(0, 1, 3, 2).reshape(-1, dim))
        return self.scat_pair_p((b * b).sum(dim=1)
                                * node_weights[self.pair_node])
