"""Two-level aggregation V-cycle for pressure operators.

Port of ``navierstokes_tpu/solvers/schur.py``.  Aggregates are contiguous
runs of ``agg`` pressure nodes (compact patches, because the node
numbering follows a space-filling curve), so restriction is a reshape +
sum; Chebyshev polynomials smooth the upper spectrum of D^-1 S.  The
coarse matrix of an assembled operator (the P1 Laplacian, Ap) is inverted
once at setup; the Schur complement S = B W B^T of aSIMPLE/aYosida gets
its Galerkin coarse matrix assembled every step from G block pairs
(``coarse_matrix``, on G's static block sums over the pressure nodes) and
inverted in fp32 (``coarse_inverse``).

On the card the V-cycle of an assembled operator runs the sweeps of
``kernels/vcycle.py`` (``FusedVcycle``: every smoothing stage between two
coarse corrections in one persistent launch, each stage one SELL product
carrying its Chebyshev update, the coefficients computed once, the same
bits as ``make_vcycle_solver``'s plain cycle); on the CPU, and for a bare
operator callable, the plain cycle below runs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as Fn

from navierstokes_tpu_torch.kernels import vcycle as VC
from navierstokes_tpu_torch.ops.operators import SegmentPlan, segment_plan
from navierstokes_tpu_torch.ops.p1ell import _inv_capturable


@dataclasses.dataclass
class CoarsePlan:
    n_agg: int
    agg: int      # pressure nodes per aggregate
    n_p1: int
    # (n_vb*KG*KG,) G block pairs -> n_agg*n_agg coarse slots, or None
    pair_plan: SegmentPlan | None = None
    # (n_vb, KG, dim, bu) G summed over each block's pressure nodes
    g_agg: torch.Tensor | None = None


def build_coarse_plan(n_p1: int, bp: int, agg_blocks: int, g_cols=None,
                      g_agg=None, dtype=None, device=None) -> CoarsePlan:
    """``agg_blocks`` pressure blocks (of ``bp`` nodes) per aggregate.
    ``g_cols``, the whole-row host G block table (n_vb, KG), and ``g_agg``,
    G's host block sums (ops/bsr.BsrHost), add what ``coarse_matrix``
    needs: the G-pair slot plan and the block sums in ``dtype``."""
    n_pb = -(-n_p1 // bp)
    n_agg = -(-n_pb // agg_blocks)
    pair = agg = None
    if g_cols is not None:
        a_cols = np.asarray(g_cols, np.int64) // agg_blocks
        slots = (a_cols[:, :, None] * n_agg + a_cols[:, None, :]).reshape(-1)
        pair = segment_plan(slots, n_agg * n_agg, device)
        agg = torch.as_tensor(g_agg, dtype=dtype, device=device)
    return CoarsePlan(n_agg=n_agg, agg=agg_blocks * bp, n_p1=n_p1,
                      pair_plan=pair, g_agg=agg)


def coarse_matrix(bsr, plan: CoarsePlan, dinv_masked):
    """S_c[a, b] = sum_u (B^T R)[u, a] dinv[u] (B^T R)[u, b], assembled from
    whole-row G block pairs; ``dinv_masked`` (n_p2,) the node weights.
    Aggregates hold whole pressure blocks, so G enters only through its
    block sums w[n,k,d,a] = sum_b g[n,k,d,a,b] (``plan.g_agg``)."""
    w = plan.g_agg                                        # (n_vb, KG, dim, bu)
    n_vb = w.shape[0]
    d_blk = Fn.pad(dinv_masked, (0, n_vb * bsr.bu - bsr.n_p2)).reshape(
        n_vb, bsr.bu)
    vals = torch.einsum("nkda,na,nlda->nkl", w, d_blk, w)
    return plan.pair_plan(vals.reshape(-1)).reshape(plan.n_agg, plan.n_agg)


def coarse_inverse(s_c, reg: float = 1e-8):
    """Dense inverse with a tiny diagonal shift (aggregates touching only
    Dirichlet-masked velocity nodes could otherwise be singular), taken in
    float32 whatever the dtype of ``s_c``, as the JAX package does; on the
    card by a backend a CUDA graph can capture (``_inv_capturable``: the
    monolithic step's segment (c) takes it every step)."""
    n = s_c.shape[0]
    scale = s_c.diagonal().abs().mean() + 1e-30
    a = s_c + (reg * scale) * torch.eye(n, dtype=s_c.dtype,
                                        device=s_c.device)
    return _inv_capturable(a.to(torch.float32)).to(s_c.dtype)


def restrict(plan: CoarsePlan, r):
    pad = plan.n_agg * plan.agg - plan.n_p1
    return Fn.pad(r, (0, pad)).reshape(plan.n_agg, plan.agg).sum(dim=1)


def prolong(plan: CoarsePlan, y):
    return torch.repeat_interleave(y, plan.agg)[:plan.n_p1]


def estimate_lam_max(apply_s, sdinv, n: int, dtype, iters: int = 8):
    """Power-iteration estimate of lambda_max(D^-1 S), x1.05 safety, from
    the deterministic start sin(12.9898 i + 0.5) + 0.01 (no RNG)."""
    v = torch.sin(torch.arange(n, dtype=dtype, device=sdinv.device)
                  * 12.9898 + 0.5) + 0.01
    for _ in range(iters):
        w = sdinv * apply_s(v)
        v = w / torch.clamp(torch.linalg.norm(w), min=1e-30)
    return torch.linalg.norm(sdinv * apply_s(v)) * 1.05


def chebyshev(apply_s, sdinv, lam_max, r, k: int, ratio: float = 6.0):
    """k Chebyshev smoothing iterations for S z = r (z0 = 0) on the upper
    spectrum [lam_max/ratio, lam_max] of D^-1 S."""
    lmin = lam_max / ratio
    theta = 0.5 * (lam_max + lmin)
    delta = 0.5 * (lam_max - lmin)
    sigma = theta / delta
    rho = 1.0 / sigma
    d = (sdinv * r) / theta
    z = d
    for _ in range(k - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        resid = r - apply_s(z)
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * (sdinv * resid)
        z = z + d
        rho = rho_new
    return z


def make_vcycle_solver(apply_s, diag_s, plan: CoarsePlan, sc_inv,
                       n_cycles: int = 2, smooth_k: int = 3, lam_max=None,
                       op=None):
    """Fixed-iteration two-level V-cycles approximating S^-1 (Chebyshev
    pre/post-smoothing + dense coarse correction): a fixed linear
    operator, usable as a CG preconditioner.  ``op``: the assembled
    operator (``ops/p1ell.P1Matrix``) that ``apply_s`` applies; on a CUDA
    device the V-cycle is then ``FusedVcycle`` (the same bits)."""
    if op is not None and op.vals.is_cuda:
        return FusedVcycle(op, diag_s, plan, sc_inv, lam_max, n_cycles,
                           smooth_k)
    sdinv = torch.where(diag_s != 0, 1.0 / diag_s, torch.ones_like(diag_s))

    def vcycle(z, r):
        z = z + chebyshev(apply_s, sdinv, lam_max, r - apply_s(z), smooth_k)
        rc = r - apply_s(z)
        z = z + prolong(plan, sc_inv @ restrict(plan, rc))
        z = z + chebyshev(apply_s, sdinv, lam_max, r - apply_s(z), smooth_k)
        return z

    def solve(r):
        z = torch.zeros_like(r)
        for _ in range(n_cycles):
            z = vcycle(z, r)
        return z

    return solve


class FusedVcycle:
    """``make_vcycle_solver``'s V-cycles on an assembled operator ``op``
    (``ops/p1ell.P1Matrix``) as the sweeps of ``kernels/vcycle.py``: a
    ``pre`` sweep (the first cycle's pre-smoothing at z = 0 and the
    residual into the zero-padded restriction buffer), then per cycle the
    restriction's sum and the coarse GEMV (torch) and a ``mid`` sweep (the
    post-smoothing, whose first stage takes the prolongation in its
    gather, and the next cycle's pre-smoothing and residual), the last
    cycle's a ``post`` sweep (its post-smoothing alone).  So a solve
    launches ``kernels/vcycle.launches(n_cycles, k)`` kernels.

    The coefficients (``vcycle.coefficients``), the work vectors and, on
    the card, the sweeps' plan (``vcycle.plan``, on the path it picks;
    ``sweep_plan``) are made once, here: a solver serves every call, eager
    or captured, and each call returns a new tensor.  Every sweep gives
    the plain cycle's bits, so a solve equals ``make_vcycle_solver``'s
    without ``op``; on the CPU the sweeps run their plain versions.

    Buffers: ``zc`` the smoothers' ping-pong pair, ``z[0]`` the
    pre-smoothed z (the residual's and the prolongation's input),
    ``z[1]`` a cycle's result before the last, ``rc`` the residual."""

    def __init__(self, op, diag_s, plan: CoarsePlan, sc_inv, lam_max,
                 n_cycles: int = 2, smooth_k: int = 3):
        if smooth_k < 1 or n_cycles < 1:
            raise ValueError(f"FusedVcycle: n_cycles {n_cycles} and "
                             f"smooth_k {smooth_k} must be at least 1")
        if op.n != plan.n_p1:
            raise ValueError(f"FusedVcycle: {op.n} rows against the plan's "
                             f"{plan.n_p1}")
        self.op, self.plan, self.sc_inv = op, plan, sc_inv
        self.n_cycles, self.k = n_cycles, smooth_k
        self.sdinv = torch.where(diag_s != 0, 1.0 / diag_s,
                                 torch.ones_like(diag_s))
        self.coef = VC.coefficients(lam_max, smooth_k)
        self.sweep_plan = VC.plan(op) if op.vals.is_cuda else None
        n = plan.n_p1
        new = lambda: torch.empty_like(self.sdinv)
        self.zc = (new(), new())
        self.z = (new(), new())
        # rc in the first n rows, zeros after: the restriction's pad
        self.rc = torch.zeros(plan.n_agg * plan.agg, dtype=self.sdinv.dtype,
                              device=self.sdinv.device)
        self.rc_n = self.rc[:n]

    def __call__(self, r):
        r = r.contiguous()
        plan = self.plan
        args = (self.op, self.sweep_plan, self.coef, self.sdinv, r)
        bufs = dict(k=self.k, zc0=self.zc[0], zc1=self.zc[1], z0=self.z[0])
        VC.sweep("pre", *args, rc=self.rc_n, **bufs)
        for c in range(self.n_cycles):
            y = self.sc_inv @ self.rc.view(plan.n_agg, plan.agg).sum(dim=1)
            if c < self.n_cycles - 1:
                VC.sweep("mid", *args, y=y, agg=plan.agg, z1=self.z[1],
                         rc=self.rc_n, **bufs)
            else:
                out = torch.empty_like(r)
                VC.sweep("post", *args, y=y, agg=plan.agg, out=out, **bufs)
        return out
