"""Reference-element tables for the P2/P1 Taylor-Hood pair on simplices.

The port's copy of ``navierstokes_tpu/fem/reference_elements.py``,
restricted to what the P2/P1 solver reads: explicit barycentric shape
functions of degrees 1 and 2 evaluated into small static numpy tables
(deal.II's ``FE_SimplexP`` / ``FESystem``, src/NavierStokes.cpp:31-57),
which ops/assembly.py contracts against per-cell geometric factors.

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


def shape_values(dim: int, degree: int, pts: np.ndarray) -> np.ndarray:
    """(n_pts, n_basis) Lagrange shape values (degree 1 or 2) at
    reference points, vertices first, then edge midpoints."""
    lam = _bary(dim, pts)  # (n, dim+1)
    if degree == 1:
        return lam
    if degree != 2:
        raise ValueError(f"degree {degree}: the port has P1 and P2 only")
    vertex = lam * (2.0 * lam - 1.0)
    edge = np.stack([4.0 * lam[:, a] * lam[:, b] for a, b in edges_of(dim)],
                    axis=1)
    return np.concatenate([vertex, edge], axis=1)


def shape_grads(dim: int, degree: int, pts: np.ndarray) -> np.ndarray:
    """(n_pts, n_basis, dim) reference-space gradients at reference points."""
    lam = _bary(dim, pts)            # (n, dim+1)
    g = _grad_bary(dim)              # (dim+1, dim)
    if degree == 1:
        return np.broadcast_to(g, (lam.shape[0],) + g.shape).copy()
    if degree != 2:
        raise ValueError(f"degree {degree}: the port has P1 and P2 only")
    vertex = (4.0 * lam - 1.0)[:, :, None] * g[None, :, :]
    edge = np.stack(
        [4.0 * (lam[:, a, None] * g[None, b] + lam[:, b, None] * g[None, a])
         for a, b in edges_of(dim)],
        axis=1)
    return np.concatenate([vertex, edge], axis=1)


class ReferenceSimplex:
    """Bundled quadrature + shape tables for the P2/P1 Taylor-Hood pair on
    the reference triangle or tetrahedron.

    ``n_points_1d`` = 3 matches deal.II ``QGaussSimplex(fe->degree + 1)``
    (src/NavierStokes.cpp:50-56): exact for total degree 5, which covers
    the trilinear convection integrand (P2 * grad P2 * P2).
    """

    def __init__(self, dim: int = 2, n_points_1d: int = 3):
        if dim not in (2, 3):
            raise ValueError(f"unsupported dim {dim}")
        self.dim = dim
        self.degree_velocity, self.degree_pressure = 2, 1

        # Cell quadrature
        self.qp, self.qw = gauss_simplex(dim, n_points_1d)
        self.n_q = self.qp.shape[0]
        self.phi_v = shape_values(dim, 2, self.qp)        # (n_q, n_v)
        self.dphi_v = shape_grads(dim, 2, self.qp)        # (n_q, n_v, dim)
        self.phi_p = shape_values(dim, 1, self.qp)        # (n_q, n_p)
        self.dphi_p = shape_grads(dim, 1, self.qp)
        self.n_v = self.phi_v.shape[1]                    # 6 (2D) / 10 (3D)
        self.n_p = self.phi_p.shape[1]                    # 3 (2D) / 4 (3D)

        # Facet quadrature on the (dim-1) reference simplex.
        self.fqp, self.fqw = gauss_simplex(dim - 1, n_points_1d)
        self.n_fq = self.fqp.shape[0]
        # Barycentric weights of facet quad points w.r.t. facet vertices.
        self.fq_bary = _bary(dim - 1, self.fqp)           # (n_fq, dim)
        self.edges = edges_of(dim)
        self.facets = facets_of(dim)

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
            fv.append(shape_values(dim, 2, cell_pts))
            fg.append(shape_grads(dim, 2, cell_pts))
            fp.append(shape_values(dim, 1, cell_pts))
        self.facet_phi_v = np.stack(fv)                   # (n_f, n_fq, n_v)
        self.facet_dphi_v = np.stack(fg)                  # (n_f, n_fq, n_v, dim)
        self.facet_phi_p = np.stack(fp)                   # (n_f, n_fq, n_p)
