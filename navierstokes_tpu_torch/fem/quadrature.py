"""Gauss quadrature on the reference simplex (conical-product construction).

The port's copy of ``navierstokes_tpu/fem/quadrature.py`` (cells are
triangles or tetrahedra, facets segments or triangles).  The reference
uses deal.II ``QGaussSimplex<dim>(degree + 1)``
(src/NavierStokes.cpp:50-56), a conical-product Gauss rule with
``n = fe_degree + 1`` points per direction, exact for polynomials of
degree ``2n - 1`` on the simplex, built here from 1D
Gauss-Legendre/Gauss-Jacobi rules (scipy).

Reference simplex conventions:
  * 1D: the segment [0, 1]                        (measure 1)
  * 2D: triangle (0,0), (1,0), (0,1)              (measure 1/2)
  * 3D: tetrahedron (0,0,0),(1,0,0),(0,1,0),(0,0,1)  (measure 1/6)

Weights sum to the reference measure, so physical integrals use
``sum_q w_q f(x_q) * |det J|`` with the affine map Jacobian J.
"""

from __future__ import annotations

import functools

import numpy as np
from scipy.special import roots_jacobi, roots_legendre


def _gauss01(n: int):
    """Gauss-Legendre on [0,1]: integrates degree 2n-1 exactly."""
    x, w = roots_legendre(n)
    return (x + 1.0) / 2.0, w / 2.0


def _gauss_jacobi01(n: int, alpha: int):
    """Gauss-Jacobi on [0,1] with weight (1-x)^alpha.

    roots_jacobi(n, a, b) targets weight (1-t)^a (1+t)^b on [-1,1]; with
    t = 2x-1, (1-t)^a = (2(1-x))^a and dt = 2dx, so divide weights by
    2^(a+1).
    """
    t, w = roots_jacobi(n, alpha, 0.0)
    x = (t + 1.0) / 2.0
    w = w / (2.0 ** (alpha + 1))
    return x, w


@functools.lru_cache(maxsize=None)
def gauss_simplex(dim: int, n_points_1d: int):
    """Conical-product Gauss rule on the reference simplex.

    Returns ``(points, weights)`` as float64 numpy arrays with shapes
    ``(n_q, dim)`` and ``(n_q,)``.  Exact for polynomials of total degree
    ``2 * n_points_1d - 1``.
    """
    n = n_points_1d
    if dim == 1:
        x, w = _gauss01(n)
        return x[:, None].copy(), w.copy()

    if dim == 2:
        # int_T f = int_0^1 (1-x) int_0^1 f(x, (1-x) s) ds dx
        xx, wx = _gauss_jacobi01(n, 1)
        ss, ws = _gauss01(n)
        pts, wts = [], []
        for xi, wxi in zip(xx, wx):
            for si, wsi in zip(ss, ws):
                pts.append((xi, (1.0 - xi) * si))
                wts.append(wxi * wsi)
        return np.array(pts), np.array(wts)

    if dim == 3:
        # int_T f = int_0^1 (1-x)^2 int_0^1 (1-s) int_0^1
        #           f(x, (1-x) s, (1-x)(1-s) r) dr ds dx
        xx, wx = _gauss_jacobi01(n, 2)
        ss, ws = _gauss_jacobi01(n, 1)
        rr, wr = _gauss01(n)
        pts, wts = [], []
        for xi, wxi in zip(xx, wx):
            for si, wsi in zip(ss, ws):
                for ri, wri in zip(rr, wr):
                    y = (1.0 - xi) * si
                    z = (1.0 - xi) * (1.0 - si) * ri
                    pts.append((xi, y, z))
                    wts.append(wxi * wsi * wri)
        return np.array(pts), np.array(wts)

    raise ValueError(f"unsupported dim {dim}")
