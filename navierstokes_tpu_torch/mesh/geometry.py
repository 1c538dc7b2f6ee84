"""Host-side mesh container (flat numpy arrays).

The port's copy of ``navierstokes_tpu/mesh/geometry.py`` for triangle
and tetrahedron meshes: one canonical, globally indexed flat
representation on the host (deal.II's Triangulation,
src/NavierStokes.cpp:7-27), with the Hilbert
vertex ordering that keeps every contiguous node range a compact spatial
patch.  The numbering is the JAX package's, so the two packages read each
other's checkpoints.

Boundary-tag convention (identical to every reference .geo file,
mesh/domain2D.geo:39-44, mesh/domain3D.geo:104-109):
  0 = bottom/lateral walls, 1 = outlet, 2 = top walls, 3 = inlet, 4 = obstacle.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from navierstokes_tpu_torch.fem.reference_elements import facets_of

TAG_WALL_BOTTOM = 0
TAG_OUTLET = 1
TAG_WALL_TOP = 2
TAG_INLET = 3
TAG_OBSTACLE = 4


def _part1by1(x):
    x &= 0x00000000FFFFFFFF
    x = (x | (x << 16)) & 0x0000FFFF0000FFFF
    x = (x | (x << 8)) & 0x00FF00FF00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F0F0F0F0F
    x = (x | (x << 2)) & 0x3333333333333333
    x = (x | (x << 1)) & 0x5555555555555555
    return x


def _part1by2(x):
    x &= 0x1FFFFF
    x = (x | (x << 32)) & 0x1F00000000FFFF
    x = (x | (x << 16)) & 0x1F0000FF0000FF
    x = (x | (x << 8)) & 0x100F00F00F00F00F
    x = (x | (x << 4)) & 0x10C30C30C30C30C3
    x = (x | (x << 2)) & 0x1249249249249249
    return x


def hilbert_order(points: np.ndarray, bits: int = 16) -> np.ndarray:
    """Permutation sorting 2D or 3D points along a Hilbert curve (Skilling's
    transpose algorithm, vectorized): consecutive ids are always spatial
    neighbours, which keeps the sparse operators' column gathers local."""
    pts = np.asarray(points, dtype=np.float64)
    lo = pts.min(axis=0)
    span = np.maximum(pts.max(axis=0) - lo, 1e-300)
    n = pts.shape[1]
    if n not in (2, 3):
        raise ValueError(f"hilbert_order: {n}D points")
    X = ((pts - lo) / span * ((1 << bits) - 1)).astype(np.uint64)
    M = np.uint64(1) << np.uint64(bits - 1)
    # AxesToTranspose (Skilling 2004)
    Q = M
    while Q > np.uint64(1):
        P = Q - np.uint64(1)
        for i in range(n):
            mask = (X[:, i] & Q) != 0
            X[mask, 0] ^= P
            nm = ~mask
            t = (X[nm, 0] ^ X[nm, i]) & P
            X[nm, 0] ^= t
            X[nm, i] ^= t
        Q >>= np.uint64(1)
    for i in range(1, n):
        X[:, i] ^= X[:, i - 1]
    t = np.zeros(len(X), dtype=np.uint64)
    Q = M
    while Q > np.uint64(1):
        mask = (X[:, n - 1] & Q) != 0
        t[mask] ^= Q - np.uint64(1)
        Q >>= np.uint64(1)
    for i in range(n):
        X[:, i] ^= t
    # interleave transposed coordinate bits into one sort key (X[0] highest)
    if n == 2:
        key = (_part1by1(X[:, 0]) << np.uint64(1)) | _part1by1(X[:, 1])
    else:
        key = ((_part1by2(X[:, 0]) << np.uint64(2))
               | (_part1by2(X[:, 1]) << np.uint64(1)) | _part1by2(X[:, 2]))
    return np.argsort(key, kind="stable")


@dataclasses.dataclass
class Mesh:
    dim: int
    points: np.ndarray          # (n_points, dim) float64
    cells: np.ndarray           # (n_cells, dim+1) int32, vertex indices
    boundary_faces: np.ndarray  # (n_bfaces, dim) int32, vertex indices
    boundary_tags: np.ndarray   # (n_bfaces,) int32
    # Analytic boundary projectors: {tag: fn((n, dim) pts) -> (n, dim)},
    # set by the generators for curved obstacles (the circle); consumed by
    # TaylorHoodSpace.snap_boundaries to place P2 midside nodes on the
    # exact surface.  Coordinate-based, so reorder_spatial never
    # invalidates them.
    snap_projectors: dict | None = None

    @property
    def n_points(self) -> int:
        return self.points.shape[0]

    @property
    def n_cells(self) -> int:
        return self.cells.shape[0]

    @property
    def n_boundary_faces(self) -> int:
        return self.boundary_faces.shape[0]

    def __post_init__(self):
        self.points = np.ascontiguousarray(self.points, dtype=np.float64)
        self.cells = np.ascontiguousarray(self.cells, dtype=np.int32)
        self.boundary_faces = np.ascontiguousarray(self.boundary_faces,
                                                   dtype=np.int32)
        self.boundary_tags = np.ascontiguousarray(self.boundary_tags,
                                                  dtype=np.int32)

    # -- geometry ----------------------------------------------------------

    def cell_volumes(self) -> np.ndarray:
        """Signed simplex volumes (positive after orientation fix)."""
        p = self.points[self.cells]                        # (nc, dim+1, dim)
        edges = p[:, 1:, :] - p[:, :1, :]                  # (nc, dim, dim)
        return np.linalg.det(edges) / (2.0 if self.dim == 2 else 6.0)

    def ensure_positive_orientation(self) -> "Mesh":
        """Flip cells with negative volume (swap last two vertices)."""
        vol = self.cell_volumes()
        neg = vol < 0
        if neg.any():
            cells = self.cells.copy()
            cells[neg, -2], cells[neg, -1] = (self.cells[neg, -1],
                                              self.cells[neg, -2])
            self.cells = cells
        return self

    # -- topology ----------------------------------------------------------

    def compute_boundary_faces(self):
        """Find facets adjacent to exactly one cell.

        Returns (faces (n, dim) int32, cell_ids (n,) int32, local_facet (n,)).
        """
        facets = np.array(facets_of(self.dim), dtype=np.int64)
        nf = facets.shape[0]
        # all facets of all cells: (n_cells * nf, dim)
        all_faces = self.cells[:, facets.reshape(-1)].reshape(
            self.n_cells, nf, self.dim).reshape(-1, self.dim)
        cell_ids = np.repeat(np.arange(self.n_cells, dtype=np.int64), nf)
        local_ids = np.tile(np.arange(nf, dtype=np.int64), self.n_cells)

        key = np.sort(all_faces, axis=1)
        order = np.lexsort(key.T[::-1])
        key_sorted = key[order]
        # boundary facets appear exactly once
        same_prev = np.zeros(len(key_sorted), dtype=bool)
        same_prev[1:] = (key_sorted[1:] == key_sorted[:-1]).all(axis=1)
        same_next = np.zeros(len(key_sorted), dtype=bool)
        same_next[:-1] = same_prev[1:]
        unique = ~(same_prev | same_next)
        idx = order[unique]
        return (all_faces[idx].astype(np.int32), cell_ids[idx].astype(np.int32),
                local_ids[idx].astype(np.int32))

    def match_boundary_faces(self):
        """Map each tagged boundary face to its (cell, local_facet).

        Returns (cell_ids, local_facets) aligned with ``self.boundary_faces``.
        """
        faces, cells_of, locals_of = self.compute_boundary_faces()

        def keys(f):
            s = np.sort(f.astype(np.int64), axis=1)
            k = np.zeros(len(s), dtype=np.int64)
            for d in range(s.shape[1]):
                k = k * (self.n_points + 1) + s[:, d]
            return k

        have = keys(faces)
        want = keys(self.boundary_faces)
        order = np.argsort(have)
        pos = np.searchsorted(have, want, sorter=order)
        if (pos >= len(have)).any() or (have[order[np.clip(pos, 0, len(have) - 1)]]
                                        != want).any():
            raise ValueError("some tagged boundary faces are not mesh boundary "
                             "facets")
        sel = order[pos]
        return cells_of[sel], locals_of[sel]

    def validate(self):
        assert self.points.ndim == 2 and self.points.shape[1] == self.dim
        assert self.cells.shape[1] == self.dim + 1
        assert self.cells.min() >= 0 and self.cells.max() < self.n_points
        vols = self.cell_volumes()
        assert (vols > 0).all(), f"{(vols <= 0).sum()} non-positive cells"
        # every tagged face must be a true boundary facet
        self.match_boundary_faces()
        return self

    def reorder_spatial(self) -> "Mesh":
        """Hilbert-curve reordering of the vertices (in place); cells and
        boundary faces are permuted consistently."""
        perm = hilbert_order(self.points)
        inv = np.empty(self.n_points, dtype=np.int64)
        inv[perm] = np.arange(self.n_points)
        self.points = np.ascontiguousarray(self.points[perm])
        self.cells = inv[self.cells.astype(np.int64)].astype(np.int32)
        if self.n_boundary_faces:
            self.boundary_faces = inv[
                self.boundary_faces.astype(np.int64)].astype(np.int32)
        return self

    def summary(self) -> str:
        return (f"Mesh(dim={self.dim}, points={self.n_points}, "
                f"cells={self.n_cells}, boundary_faces={self.n_boundary_faces}, "
                f"tags={sorted(set(self.boundary_tags.tolist()))})")
