"""Taylor-Hood function space on a triangle or tetrahedron mesh
(production pair P2/P1; any degree pair, as the reference constructor
allows, src/NavierStokes.hpp:173-178).

The port's copy of ``navierstokes_tpu/fem/spaces.py`` (deal.II's
FESystem/DoFHandler, src/NavierStokes.cpp:31-92).  The DoF layout is
canonical and global, and the same as the JAX package's.  For P2/P1:

  * pressure DoFs  = mesh vertices, index = vertex id          (n_p1,)
  * velocity nodes = vertices then unique edges, Hilbert-ordered by
    coordinates (``rcm``)                                      (n_p2,)
  * velocity DoF arrays are stored node-major as (n_p2, dim)

and for any other degree the entity-major generalisation of
``_lagrange_numbering``, so checkpoints and tables agree between the two
packages.  The names ``n_p2`` / ``cell_p2`` / ``p2_coords`` (velocity)
and ``n_p1`` / ``cell_p1`` (pressure) are kept for every degree.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from navierstokes_tpu_torch.fem.quadrature import gauss_simplex
from navierstokes_tpu_torch.fem.reference_elements import (
    ReferenceSimplex, edges_of, facets_of, lattice_multi_indices, n_basis,
    node_ref_coords, shape_grads, shape_values)
from navierstokes_tpu_torch.mesh.geometry import Mesh, hilbert_order


def _encode_pairs(a: np.ndarray, b: np.ndarray, n: int) -> np.ndarray:
    lo = np.minimum(a, b).astype(np.int64)
    hi = np.maximum(a, b).astype(np.int64)
    return lo * np.int64(n) + hi


def _lagrange_numbering(mesh: Mesh, k: int, cells: np.ndarray,
                        cell_edges: np.ndarray, edge_verts: np.ndarray):
    """Global numbering of the degree-k Lagrange lattice on a simplex
    mesh, entity-major:

      [0, n_points)                 vertices (= vertex id)
      n_points + e*(k-1) + s        edge e, slot s: the node at fraction
                                    (s+1)/k from the LOWER vertex id toward
                                    the higher, so the cells sharing an
                                    edge agree whatever their orientation
      + face f (3D, k == 3)         one interior node per unique face
      + cell-interior nodes         per cell (2D k >= 3)

    The per-cell column order is ``lattice_multi_indices``'.  At k = 2 it
    is the P2 layout (vertices, then unique edges).  Returns (n_nodes,
    cell_nodes (nc, n_basis) int32, coords, edge_node_block (n_edges,
    k-1), face_key_sorted or None, face_node or None)."""
    dim = mesh.dim
    if dim == 3 and k > 3:
        raise NotImplementedError("3D degree > 3 not supported")
    npnt = mesh.n_points
    nc = mesh.n_cells
    n_edges = edge_verts.shape[0]
    nb = n_basis(dim, k)

    cell_nodes = np.empty((nc, nb), np.int64)
    cell_nodes[:, :dim + 1] = cells
    col = dim + 1
    if k >= 2:
        for le, (a, b) in enumerate(edges_of(dim)):
            e = cell_edges[:, le].astype(np.int64)
            a_is_lo = cells[:, a] < cells[:, b]
            for r in range(1, k):
                s = np.where(a_is_lo, r - 1, k - r - 1)
                cell_nodes[:, col] = npnt + e * (k - 1) + s
                col += 1
    n_en = n_edges * (k - 1)
    base_f = npnt + n_en
    n_faces = 0
    face_key_sorted = face_node = None
    if dim == 3 and k >= 3:
        fverts = cells[:, np.array(facets_of(3))]          # (nc, 4, 3)
        fs = np.sort(fverts, axis=2).astype(np.int64)
        key = (fs[..., 0] * npnt + fs[..., 1]) * npnt + fs[..., 2]
        face_key_sorted, invf = np.unique(key.ravel(), return_inverse=True)
        n_faces = len(face_key_sorted)
        cell_nodes[:, col:col + 4] = base_f + invf.reshape(nc, 4)
        col += 4
        face_node = base_f + np.arange(n_faces, dtype=np.int64)
    base_i = base_f + n_faces
    n_int = nb - col
    if n_int:
        cell_nodes[:, col:] = (base_i
                               + np.arange(nc, dtype=np.int64)[:, None]
                               * n_int + np.arange(n_int))
    n_nodes = base_i + nc * n_int

    # coordinates: lattice positions inside each cell (shared nodes get the
    # same value from every cell that writes them)
    alphas = lattice_multi_indices(dim, k).astype(np.float64) / k
    xn = np.einsum("la,cad->cld", alphas, mesh.points[cells])
    coords = np.zeros((n_nodes, dim))
    coords[cell_nodes.reshape(-1)] = xn.reshape(-1, dim)

    edge_node_block = (npnt + np.arange(n_en, dtype=np.int64)
                       .reshape(n_edges, k - 1)) if k >= 2 else \
        np.zeros((n_edges, 0), np.int64)
    return (n_nodes, cell_nodes.astype(np.int32), coords, edge_node_block,
            face_key_sorted, face_node)


@dataclasses.dataclass
class FaceData:
    """Boundary-face quadrature data for one tag (deal.II FEFaceValues
    loops, src/NavierStokes.cpp:870-906, as flat arrays)."""
    cells: np.ndarray          # (n_f,) adjacent cell ids
    local_facets: np.ndarray   # (n_f,) local facet index in the cell
    normals: np.ndarray        # (n_f, n_fq, dim) outward unit normals per
    #                            quad point (constant on straight faces)
    jxw: np.ndarray            # (n_f, n_fq) quadrature weights x |detJ_face|
    qp_phys: np.ndarray        # (n_f, n_fq, dim) physical quad points
    # Cell-basis tables evaluated at this face's quad points:
    phi_v: np.ndarray          # (n_f, n_fq, n_v)
    dphi_v_ref: np.ndarray     # (n_f, n_fq, n_v, dim) reference grads
    phi_p: np.ndarray          # (n_f, n_fq, n_p)
    # Per-quad-point inverse Jacobians of the owning cell for faces of a
    # snapped (curved) tag: (n_f, n_fq, dim, dim), else None.
    jinv_q: np.ndarray | None = None

    @property
    def n_faces(self):
        return len(self.cells)


@dataclasses.dataclass
class CurvedData:
    """Quadratic-geometry quadrature data for the curved (boundary-snapped)
    cells: the superparametric replacement for the affine factors of
    ops/assembly.geometric_factors on those cells (the P2 midside nodes
    on the tagged boundary are projected onto the analytic curve and the
    touched cells integrate with the quadratic map)."""
    ids: np.ndarray        # (k,) curved cell ids (sorted)
    qp: np.ndarray         # (n_q, dim) quadrature points (higher-order rule)
    qw: np.ndarray         # (n_q,)
    phi_v: np.ndarray      # (n_q, n_v) P2 values
    dphi_v: np.ndarray     # (n_q, n_v, dim) P2 reference gradients
    phi_p: np.ndarray      # (n_q, n_p) P1 values
    detj_q: np.ndarray     # (k, n_q)
    jinv_q: np.ndarray     # (k, n_q, dim, dim)  jinv[x, d] = dxi_x/dx_d


class TaylorHoodSpace:
    """Velocity degree ``degree_velocity`` / pressure degree
    ``degree_pressure`` on a simplex mesh.  ``rcm=True`` (the default)
    Hilbert-orders the velocity nodes by coordinates (``_reorder_p2``),
    which keeps the sparse operators' column gathers local; the order is
    a function of the mesh alone."""

    def __init__(self, mesh: Mesh, degree_velocity: int = 2,
                 degree_pressure: int = 1, rcm: bool = True):
        mesh.ensure_positive_orientation()
        self.mesh = mesh
        self.dim = mesh.dim
        kv, kp = degree_velocity, degree_pressure
        self.rs = ReferenceSimplex(self.dim, kv, kp)
        self.degree_velocity, self.degree_pressure = kv, kp

        # ---- unique edges & P2 numbering (edge keys ascending) ----------
        edges = np.array(edges_of(self.dim), dtype=np.int64)
        cells = mesh.cells.astype(np.int64)
        ca = cells[:, edges[:, 0]]                      # (nc, n_edges_local)
        cb = cells[:, edges[:, 1]]
        keys = _encode_pairs(ca, cb, mesh.n_points).ravel()
        uniq, inverse = np.unique(keys, return_inverse=True)
        self.n_edges = len(uniq)
        cell_edges = inverse.reshape((mesh.n_cells, edges.shape[0]))
        ea = (uniq // np.int64(mesh.n_points)).astype(np.int64)
        eb = (uniq % np.int64(mesh.n_points)).astype(np.int64)
        self._edge_key_sorted = uniq
        self._edge_verts = np.stack([ea, eb], axis=1)   # (n_edges, 2)
        self._face_key_sorted = self._face_node = None
        self._vertex_node = np.arange(mesh.n_points, dtype=np.int64)

        if kv == 2:
            self.n_p2 = mesh.n_points + self.n_edges
            # cell -> P2 node map, local order = vertices then edges
            self.cell_p2 = np.concatenate(
                [cells, mesh.n_points + cell_edges], axis=1).astype(np.int32)
            mids = 0.5 * (mesh.points[ea] + mesh.points[eb])
            # P2 node coordinates (vertices + edge midpoints): boundary-value
            # interpolation (src/NavierStokes.cpp:296-324) and VTU output
            self.p2_coords = np.concatenate([mesh.points, mids], axis=0)
            self._edge_node_block = (
                mesh.n_points
                + np.arange(self.n_edges, dtype=np.int64)[:, None])
        else:
            (self.n_p2, self.cell_p2, self.p2_coords, self._edge_node_block,
             self._face_key_sorted, self._face_node) = _lagrange_numbering(
                 mesh, kv, cells, cell_edges, self._edge_verts)
        if kp == 1:
            self.n_p1 = mesh.n_points
            self.cell_p1 = mesh.cells.astype(np.int32)
        else:
            # a pressure lattice of its own (the P2 pressure of P3/P2)
            self.n_p1, self.cell_p1 = _lagrange_numbering(
                mesh, kp, cells, cell_edges, self._edge_verts)[:2]
        if rcm:
            self._reorder_p2()

        # boundary face -> (cell, local facet)
        self._bf_cells, self._bf_locals = mesh.match_boundary_faces()

        # curved-boundary (snapped) state
        self._snapped_nodes = np.zeros(0, dtype=np.int64)
        self._snapped_tags: set[int] = set()
        self._curved_cache: CurvedData | None = None

    def _reorder_p2(self):
        """Hilbert-order the P2 nodes by their coordinates: vertices and
        edge midpoints interleave along the curve that orders the mesh
        vertices, so contiguous P2 ids are compact patches aligned with
        the P1 numbering."""
        perm = hilbert_order(self.p2_coords).astype(np.int64)
        inv = np.empty(self.n_p2, dtype=np.int64)
        inv[perm] = np.arange(self.n_p2)
        self.cell_p2 = inv[self.cell_p2.astype(np.int64)].astype(np.int32)
        self.p2_coords = np.ascontiguousarray(self.p2_coords[perm])
        self._vertex_node = inv[self._vertex_node]
        self._edge_node_block = inv[self._edge_node_block]
        if self._face_node is not None:
            self._face_node = inv[self._face_node]

    # ---- curved (superparametric) boundary geometry ----------------------

    def snap_boundaries(self, projectors: dict) -> list[int]:
        """Snap the P2 midside nodes on tagged boundary facets onto analytic
        curves or surfaces: ``projectors[tag]((m, dim) pts) -> (m, dim)``.
        Vertices stay put; the touched cells then integrate with the
        quadratic map (``curved_data``) and ``face_data`` of a snapped tag
        returns per-point normals/JxW.  Returns the tags that had faces to
        snap.  P2 velocity only: other degrees keep straight cells."""
        if self.degree_velocity != 2:
            raise NotImplementedError(
                "curved boundary snapping moves the P2 midside geometry "
                "nodes; other velocity degrees use straight cells")
        snapped = []
        new_nodes = []
        for tag, proj in projectors.items():
            sel = self.mesh.boundary_tags == tag
            faces = np.asarray(self.mesh.boundary_faces[sel], np.int64)
            if len(faces) == 0:
                continue
            en = []
            d = faces.shape[1]
            for i in range(d):
                for j in range(i + 1, d):
                    en.append(self._edge_node_block[
                        self.edge_id(faces[:, i], faces[:, j]), 0])
            en = np.unique(np.concatenate(en))
            self.p2_coords[en] = np.asarray(proj(self.p2_coords[en]))
            new_nodes.append(en)
            self._snapped_tags.add(tag)
            snapped.append(tag)
        if new_nodes:
            self._snapped_nodes = np.unique(
                np.concatenate([self._snapped_nodes] + new_nodes))
            self._curved_cache = None
            type(self).face_data.cache_clear()
        return snapped

    def curved_data(self) -> CurvedData | None:
        """Quadratic-map quadrature factors for the cells touched by
        ``snap_boundaries`` (None when nothing is snapped), on a
        one-order-higher conical Gauss rule than the affine cells."""
        if len(self._snapped_nodes) == 0:
            return None
        if self._curved_cache is not None:
            return self._curved_cache
        dim = self.dim
        mask = np.zeros(self.n_p2, dtype=bool)
        mask[self._snapped_nodes] = True
        ids = np.flatnonzero(
            mask[self.cell_p2.astype(np.int64)].any(axis=1)).astype(np.int64)
        qp, qw = gauss_simplex(dim, 4)
        phi_v = shape_values(dim, 2, qp)
        dphi_v = shape_grads(dim, 2, qp)
        phi_p = shape_values(dim, 1, qp)
        X = self.p2_coords[self.cell_p2[ids].astype(np.int64)]  # (k,n_v,dim)
        # J[k,q,d,x] = dx_d/dxi_x of the quadratic map x(xi) = sum X phi2
        J = np.einsum("kad,qax->kqdx", X, dphi_v)
        detj_q = np.linalg.det(J)
        if (detj_q <= 0).any():
            bad = int((detj_q.min(axis=1) <= 0).sum())
            raise ValueError(
                f"boundary snapping produced {bad} curved cells with a "
                "non-positive Jacobian — mesh too coarse for the surface "
                "curvature (h_near vs R)")
        jinv_q = np.linalg.inv(J)        # [k,q,x,d] = dxi_x/dx_d
        self._curved_cache = CurvedData(
            ids=ids, qp=qp, qw=qw, phi_v=phi_v, dphi_v=dphi_v, phi_p=phi_p,
            detj_q=detj_q, jinv_q=jinv_q)
        return self._curved_cache

    def pressure_at_p2_nodes(self, p: np.ndarray) -> np.ndarray:
        """Prolong the pressure to all velocity nodes (exact: the pressure
        space lies in the velocity space); VTU output.  P2/P1: vertices
        keep their value, midpoints take the edge mean; other pairs
        evaluate the pressure basis at the velocity lattice per cell."""
        p = np.asarray(p)
        out = np.zeros(self.n_p2, dtype=p.dtype)
        if (self.degree_velocity, self.degree_pressure) == (2, 1):
            out[self._vertex_node] = p
            out[self._edge_node_block[:, 0]] = 0.5 * (
                p[self._edge_verts[:, 0]] + p[self._edge_verts[:, 1]])
            return out
        Np = shape_values(self.dim, self.degree_pressure,
                          node_ref_coords(self.dim, self.degree_velocity))
        out[self.cell_p2.astype(np.int64).reshape(-1)] = np.einsum(
            "lj,cj->cl", Np, p[self.cell_p1.astype(np.int64)]).reshape(-1)
        return out

    # ---- DoF queries -----------------------------------------------------

    @property
    def n_velocity_dofs(self):
        return self.n_p2 * self.dim

    @property
    def n_pressure_dofs(self):
        return self.n_p1

    @property
    def n_dofs(self):
        return self.n_velocity_dofs + self.n_pressure_dofs

    def edge_id(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        key = _encode_pairs(np.asarray(a, np.int64), np.asarray(b, np.int64),
                            self.mesh.n_points)
        idx = np.searchsorted(self._edge_key_sorted, key)
        if (idx >= self.n_edges).any() or \
                (self._edge_key_sorted[np.clip(idx, 0, self.n_edges - 1)]
                 != key).any():
            raise KeyError("edge not in mesh")
        return idx

    def p2_nodes_on_faces(self, faces: np.ndarray) -> np.ndarray:
        """Unique velocity-node ids on the given facets: their vertices,
        every facet-edge lattice node and (3D, degree 3) the facet's
        interior node."""
        if len(faces) == 0:
            return np.zeros((0,), np.int64)
        faces = np.asarray(faces, np.int64)
        nodes = [self._vertex_node[faces.ravel()]]
        d = faces.shape[1]
        for i in range(d):
            for j in range(i + 1, d):
                eid = self.edge_id(faces[:, i], faces[:, j])
                nodes.append(self._edge_node_block[eid].ravel())
        if self._face_node is not None and d == 3:
            npnt = self.mesh.n_points
            fs = np.sort(faces, axis=1)
            key = (fs[:, 0] * npnt + fs[:, 1]) * npnt + fs[:, 2]
            nodes.append(self._face_node[np.searchsorted(
                self._face_key_sorted, key)])
        return np.unique(np.concatenate(nodes))

    def p2_nodes_on_tag(self, tag: int) -> np.ndarray:
        sel = self.mesh.boundary_tags == tag
        return self.p2_nodes_on_faces(self.mesh.boundary_faces[sel])

    # ---- face quadrature data ---------------------------------------------

    @functools.lru_cache(maxsize=None)
    def face_data(self, tag: int) -> FaceData:
        mesh, rs, dim = self.mesh, self.rs, self.dim
        sel = np.flatnonzero(mesh.boundary_tags == tag)
        cells_of = self._bf_cells[sel].astype(np.int64)
        locals_of = self._bf_locals[sel].astype(np.int64)
        facets = np.array(facets_of(dim), dtype=np.int64)

        n_f = len(sel)
        verts = mesh.cells[cells_of][np.arange(n_f)[:, None],
                                     facets[locals_of]]   # (n_f, dim)
        fpts = mesh.points[verts]                          # (n_f, dim, dim)

        # physical quad points: barycentric combo of facet vertices (in the
        # canonical local facet order used by rs.facet_phi_* tables)
        qp_phys = np.einsum("qk,fkd->fqd", rs.fq_bary, fpts)

        if dim == 2:
            t = fpts[:, 1] - fpts[:, 0]
            detj = np.linalg.norm(t, axis=1)
            nrm = np.stack([t[:, 1], -t[:, 0]], axis=1) / detj[:, None]
        else:
            cr = np.cross(fpts[:, 1] - fpts[:, 0], fpts[:, 2] - fpts[:, 0])
            detj = np.linalg.norm(cr, axis=1)      # twice the facet area
            nrm = cr / detj[:, None]

        # orient outward: away from the owning cell's centroid
        cell_cent = mesh.points[mesh.cells[cells_of]].mean(axis=1)
        face_cent = fpts.mean(axis=1)
        flip = np.einsum("fd,fd->f", nrm, face_cent - cell_cent) < 0
        nrm[flip] *= -1.0

        jxw = rs.fqw[None, :] * detj[:, None]
        nrm_q = np.broadcast_to(nrm[:, None, :],
                                (n_f, rs.n_fq, dim)).copy()
        jinv_q = None

        if tag in self._snapped_tags and n_f:
            # Curved facet map (tag snapped onto an analytic curve):
            # quadratic geometry from the facet's P2 nodes — per-point
            # normals, JxW, physical points, and the owning cell's per-point
            # inverse Jacobian for physical gradients (force integrals,
            # ops/assembly.build_face_arrays).
            fdim = dim - 1
            vn = self._vertex_node[verts]                  # (n_f, dim)
            en = [self._edge_node_block[
                      self.edge_id(verts[:, i], verts[:, j]), 0]
                  for i, j in edges_of(fdim)]
            fnodes = np.concatenate([vn, np.stack(en, axis=1)], axis=1)
            FX = self.p2_coords[fnodes]                    # (n_f, n_geo, dim)
            N = shape_values(fdim, 2, rs.fqp)              # (n_fq, n_geo)
            dN = shape_grads(fdim, 2, rs.fqp)              # (n_fq,n_geo,fdim)
            qp_phys = np.einsum("qa,fad->fqd", N, FX)
            T = np.einsum("fad,qax->fqdx", FX, dN)         # tangent vectors
            if dim == 2:
                tq = T[..., 0]
                detj_q = np.linalg.norm(tq, axis=-1)
                nrm_q = (np.stack([tq[..., 1], -tq[..., 0]], axis=-1)
                         / detj_q[..., None])
            else:
                cr = np.cross(T[..., 0], T[..., 1])
                detj_q = np.linalg.norm(cr, axis=-1)
                nrm_q = cr / detj_q[..., None]
            flip = np.einsum("fd,fd->f", nrm_q.mean(axis=1),
                             face_cent - cell_cent) < 0
            nrm_q[flip] *= -1.0
            jxw = rs.fqw[None, :] * detj_q
            # owning cell's quadratic map evaluated at the facet points
            Xc = self.p2_coords[self.cell_p2[cells_of].astype(np.int64)]
            dphi_c = rs.facet_dphi_v[locals_of]    # (n_f, n_fq, n_v, dim)
            Jc = np.einsum("fad,fqax->fqdx", Xc, dphi_c)
            jinv_q = np.linalg.inv(Jc)

        return FaceData(
            cells=cells_of.astype(np.int32),
            local_facets=locals_of.astype(np.int32),
            normals=nrm_q,
            jxw=jxw,
            qp_phys=qp_phys,
            phi_v=rs.facet_phi_v[locals_of],
            dphi_v_ref=rs.facet_dphi_v[locals_of],
            phi_p=rs.facet_phi_p[locals_of],
            jinv_q=jinv_q,
        )
