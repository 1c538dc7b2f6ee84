"""Reference-element tables for Taylor-Hood pairs on simplices.

The port's copy of ``navierstokes_tpu/fem/reference_elements.py``:
Lagrange shape functions evaluated into small static numpy tables
(deal.II's ``FE_SimplexP`` / ``FESystem``, src/NavierStokes.cpp:31-57),
which ops/assembly.py contracts against per-cell geometric factors.
Degrees 1 and 2 keep their closed barycentric forms; any other degree
uses the equispaced lattice basis (``lattice_multi_indices``, Silvester
products), as the reference constructor's arbitrary degrees do
(src/NavierStokes.hpp:173-178).  3D stops at degree 3.

Conventions (the same as the JAX package's, so DoF numbering and
checkpoints agree): triangle vertices V0=(0,0), V1=(1,0), V2=(0,1);
barycentric l0=1-x-y, l1=x, l2=y; edges EDGES_2D = [(0,1), (0,2), (1,2)];
P2 nodes = 3 vertices + 3 midpoints.  Tetrahedron vertices V0..V3 =
origin + unit axes; l0=1-x-y-z, l1=x, l2=y, l3=z; edges EDGES_3D =
[(0,1),(0,2),(0,3),(1,2),(1,3),(2,3)]; P2 nodes = 4 vertices + 6
midpoints.  Facets are identified by sorted
vertex tuples; the outward normal is fixed against the owning cell's
centroid (fem/spaces.py), so local facet orientation never matters.
"""

from __future__ import annotations

import math

import numpy as np

from navierstokes_tpu_torch.fem.quadrature import gauss_simplex

EDGES_1D = ((0, 1),)
EDGES_2D = ((0, 1), (0, 2), (1, 2))
EDGES_3D = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))

# Facets as local vertex index tuples (orientation-free).
FACETS_2D = ((0, 1), (1, 2), (2, 0))
FACETS_3D = ((1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2))


def _bary(dim: int, pts: np.ndarray) -> np.ndarray:
    """Barycentric coordinates (n, dim+1) of reference-cell points (n, dim)."""
    pts = np.atleast_2d(pts)
    lam0 = 1.0 - pts.sum(axis=1)
    return np.concatenate([lam0[:, None], pts], axis=1)


def _grad_bary(dim: int) -> np.ndarray:
    """Constant gradients of barycentric coords: (dim+1, dim)."""
    g = np.zeros((dim + 1, dim))
    g[0, :] = -1.0
    g[1:, :] = np.eye(dim)
    return g


def edges_of(dim: int):
    if dim == 1:
        return EDGES_1D
    return EDGES_2D if dim == 2 else EDGES_3D


def facets_of(dim: int):
    if dim not in (2, 3):
        raise ValueError(f"unsupported dim {dim}")
    return FACETS_2D if dim == 2 else FACETS_3D


def lattice_multi_indices(dim: int, degree: int) -> np.ndarray:
    """Barycentric multi-indices alpha (|alpha| = degree) of the
    equispaced Lagrange lattice nodes on the dim-simplex, in the canonical
    entity order the DoF numbering follows:

      1. vertices (alpha = degree * e_i), in vertex order 0..dim
      2. edge-interior nodes, per edge of ``edges_of(dim)``, walking each
         edge (a, b) from a to b (alpha_a descending)
      3. facet-interior nodes (3D, degree 3), per facet of
         ``facets_of(dim)``, lexicographic in the facet's own lattice
      4. cell-interior nodes, lexicographic

    At degrees 1 and 2 this is the vertices-then-midpoints order of the
    P2/P1 pair.  Returns (n_basis, dim+1) int."""
    k = degree
    nv = dim + 1
    out = []
    for i in range(nv):                                # 1. vertices
        a = np.zeros(nv, np.int64)
        a[i] = k
        out.append(a)
    if k >= 2:                                         # 2. edges
        for (ea, eb) in edges_of(dim):
            for r in range(1, k):
                a = np.zeros(nv, np.int64)
                a[ea], a[eb] = k - r, r
                out.append(a)
    if dim == 3 and k >= 3:                            # 3. facets (3D)
        for facet in facets_of(dim):
            f = sorted(facet)
            for i in range(1, k):
                for j in range(1, k - i):
                    rem = k - i - j
                    if rem < 1:
                        continue
                    a = np.zeros(nv, np.int64)
                    a[f[0]], a[f[1]], a[f[2]] = rem, i, j
                    out.append(a)
    if (dim == 2 and k >= 3) or (dim == 3 and k >= 4):  # 4. interior
        rng = range(1, k)
        if dim == 2:
            for i in rng:
                for j in rng:
                    if k - i - j >= 1:
                        out.append(np.array([k - i - j, i, j]))
        else:
            for i in rng:
                for j in rng:
                    for m in rng:
                        if k - i - j - m >= 1:
                            out.append(np.array([k - i - j - m, i, j, m]))
    return np.stack(out)


def n_basis(dim: int, degree: int) -> int:
    return math.comb(dim + degree, dim)


def _silvester(lam: np.ndarray, m: int, k: int):
    """Silvester polynomial P_m(k, lam) = prod_{r<m} (k lam - r)/(m - r)
    and its derivative in lam: the one-coordinate factor of the
    equispaced simplex Lagrange basis.  lam: (n,) barycentric values."""
    if m == 0:
        return np.ones_like(lam), np.zeros_like(lam)
    val = np.ones_like(lam)
    dval = np.zeros_like(lam)
    for r in range(m):
        f = (k * lam - r) / (m - r)
        dval = dval * f + val * (k / (m - r))
        val = val * f
    return val, dval


def shape_values(dim: int, degree: int, pts: np.ndarray) -> np.ndarray:
    """(n_pts, n_basis) Lagrange shape values at reference points, in the
    order of ``lattice_multi_indices``.  Degrees 1 and 2: the closed
    barycentric forms; higher degrees: N_alpha = prod_i P_{alpha_i}(k,
    lam_i)."""
    lam = _bary(dim, pts)  # (n, dim+1)
    if degree == 1:
        return lam
    if degree == 2:
        vertex = lam * (2.0 * lam - 1.0)
        edge = np.stack([4.0 * lam[:, a] * lam[:, b]
                         for a, b in edges_of(dim)], axis=1)
        return np.concatenate([vertex, edge], axis=1)
    cols = []
    for alpha in lattice_multi_indices(dim, degree):
        v = np.ones(lam.shape[0])
        for i, m in enumerate(alpha):
            v = v * _silvester(lam[:, i], int(m), degree)[0]
        cols.append(v)
    return np.stack(cols, axis=1)


def shape_grads(dim: int, degree: int, pts: np.ndarray) -> np.ndarray:
    """(n_pts, n_basis, dim) reference-space gradients at reference points."""
    lam = _bary(dim, pts)            # (n, dim+1)
    g = _grad_bary(dim)              # (dim+1, dim)
    if degree == 1:
        return np.broadcast_to(g, (lam.shape[0],) + g.shape).copy()
    if degree == 2:
        vertex = (4.0 * lam - 1.0)[:, :, None] * g[None, :, :]
        edge = np.stack(
            [4.0 * (lam[:, a, None] * g[None, b] + lam[:, b, None] * g[None, a])
             for a, b in edges_of(dim)],
            axis=1)
        return np.concatenate([vertex, edge], axis=1)
    n = lam.shape[0]
    rows = []
    for alpha in lattice_multi_indices(dim, degree):
        vals, dvals = zip(*(_silvester(lam[:, i], int(m), degree)
                            for i, m in enumerate(alpha)))
        grad = np.zeros((n, dim))
        for i in range(dim + 1):
            prod_others = np.ones(n)
            for j in range(dim + 1):
                if j != i:
                    prod_others = prod_others * vals[j]
            grad += (dvals[i] * prod_others)[:, None] * g[i][None, :]
        rows.append(grad)
    return np.stack(rows, axis=1)


def node_ref_coords(dim: int, degree: int) -> np.ndarray:
    """Reference coordinates of the degree-k lattice nodes, in the order of
    ``lattice_multi_indices``."""
    alphas = lattice_multi_indices(dim, degree).astype(np.float64) / degree
    verts = np.concatenate([np.zeros((1, dim)), np.eye(dim)], axis=0)
    return alphas @ verts


class ReferenceSimplex:
    """Bundled quadrature + shape tables for a Taylor-Hood pair on the
    reference triangle or tetrahedron.

    ``n_points_1d`` defaults to degree_velocity + 1, deal.II's
    ``QGaussSimplex(fe->degree + 1)`` (src/NavierStokes.cpp:50-56): for
    P2/P1, 3 points, exact for total degree 5, which covers the trilinear
    convection integrand (P2 * grad P2 * P2).
    """

    def __init__(self, dim: int, degree_velocity: int = 2,
                 degree_pressure: int = 1, n_points_1d: int | None = None):
        if dim not in (2, 3):
            raise ValueError(f"unsupported dim {dim}")
        if degree_velocity < 1 or degree_pressure < 1:
            raise ValueError("degrees must be >= 1")
        if dim == 3 and degree_velocity > 3:
            # past cubic, 3D needs an orientation rule for the several
            # facet-interior nodes two cells share (as in the JAX package)
            raise NotImplementedError("3D velocity degree > 3 not supported")
        self.dim = dim
        self.degree_velocity = kv = degree_velocity
        self.degree_pressure = kp = degree_pressure
        n1d = n_points_1d or (kv + 1)

        # Cell quadrature
        self.qp, self.qw = gauss_simplex(dim, n1d)
        self.n_q = self.qp.shape[0]
        self.phi_v = shape_values(dim, kv, self.qp)       # (n_q, n_v)
        self.dphi_v = shape_grads(dim, kv, self.qp)       # (n_q, n_v, dim)
        self.phi_p = shape_values(dim, kp, self.qp)       # (n_q, n_p)
        self.dphi_p = shape_grads(dim, kp, self.qp)
        self.n_v = self.phi_v.shape[1]                    # P2: 6 / 10
        self.n_p = self.phi_p.shape[1]                    # P1: 3 / 4

        # Facet quadrature on the (dim-1) reference simplex.
        self.fqp, self.fqw = gauss_simplex(dim - 1, n1d)
        self.n_fq = self.fqp.shape[0]
        # Barycentric weights of facet quad points w.r.t. facet vertices.
        self.fq_bary = _bary(dim - 1, self.fqp)           # (n_fq, dim)
        self.edges = edges_of(dim)
        self.facets = facets_of(dim)
        # reference coordinates of the velocity and pressure lattice nodes
        self.p2_nodes = node_ref_coords(dim, kv)
        self.p_nodes = node_ref_coords(dim, kp)

        # Precomputed reference tensors for assembly (all tiny, float64):
        w = self.qw
        # mass:      M[a,b]        = sum_q w phi_a phi_b
        self.M_hat = np.einsum("q,qa,qb->ab", w, self.phi_v, self.phi_v)
        # stiffness: K[x,y,a,b]    = sum_q w d_x phi_a d_y phi_b
        self.K_hat = np.einsum("q,qax,qby->xyab", w, self.dphi_v, self.dphi_v)
        # pressure:  G[a,x,j]      = sum_q w d_x phi_a psi_j
        self.G_hat = np.einsum("q,qax,qj->axj", w, self.dphi_v, self.phi_p)
        # convection T[a,b,x,e]    = sum_q w phi_a d_x phi_b phi_e
        self.T_hat = np.einsum("q,qa,qbx,qe->abxe", w, self.phi_v,
                               self.dphi_v, self.phi_v)
        # pressure-space convection: Tp[i,j,x,e] = sum_q w psi_i d_x psi_j phi_e
        # (the PCD preconditioner's pressure convection operator)
        self.Tp_hat = np.einsum("q,qi,qjx,qe->ijxe", w, self.phi_p,
                                self.dphi_p, self.phi_v)
        # lumped-mass accumulator with the reference's per-quad-point abs
        # (src/NavierStokes.cpp:232-236): L[a] = sum_q w |phi_a| sum_b |phi_b|
        self.Mlump_hat = np.einsum("q,qa,q->a", w, np.abs(self.phi_v),
                                   np.abs(self.phi_v).sum(axis=1))

        # Facet shape tables: values/grads of cell basis at facet quad points,
        # per local facet: (n_facets, n_fq, n_basis[, dim]).
        verts = np.concatenate([np.zeros((1, dim)), np.eye(dim)], axis=0)
        fv, fg, fp = [], [], []
        for facet in self.facets:
            fverts = verts[list(facet)]                   # (dim, dim)
            cell_pts = self.fq_bary @ fverts              # (n_fq, dim)
            fv.append(shape_values(dim, kv, cell_pts))
            fg.append(shape_grads(dim, kv, cell_pts))
            fp.append(shape_values(dim, kp, cell_pts))
        self.facet_phi_v = np.stack(fv)                   # (n_f, n_fq, n_v)
        self.facet_dphi_v = np.stack(fg)                  # (n_f, n_fq, n_v, dim)
        self.facet_phi_p = np.stack(fp)                   # (n_f, n_fq, n_p)
