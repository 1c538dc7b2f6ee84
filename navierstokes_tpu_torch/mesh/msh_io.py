"""gmsh ``.msh`` reader and writers — ASCII and binary, formats 2.2 and
4.1.

The port's copy of ``navierstokes_tpu/mesh/msh_io.py``.  The writers
export a mesh for gmsh users: ``write_msh`` (2.2 ASCII) and
``write_msh_binary`` (2.2 or 4.1 binary, as ``gmsh -bin`` writes).

Replaces deal.II ``GridIn::read_msh`` (reference: src/NavierStokes.cpp:11-17),
which ingests whatever gmsh writes, including ``gmsh -bin`` binary output.
Only simplices are ingested: lines/triangles in 2D, triangles/tets in 3D.
Physical tags on codim-1 elements become boundary-face tags; the physical
volume/surface tag of the domain itself (10 in every reference .geo,
e.g. mesh/domain2D.geo:44) is ignored, exactly like the reference solver
ignores it.
"""

from __future__ import annotations

import struct

import numpy as np

from navierstokes_tpu_torch.mesh.geometry import Mesh

# gmsh element type -> (n_nodes, dim)
_ELEM_TYPES = {1: (2, 1), 2: (3, 2), 4: (4, 3), 15: (1, 0)}


def read_msh(path: str, dim: int | None = None) -> Mesh:
    with open(path, "rb") as f:
        raw = f.read()
    head = raw[:256].split(b"\n", 2)
    if not head[0].strip().startswith(b"$MeshFormat"):
        raise ValueError(f"{path}: not a gmsh msh file")
    fmt = head[1].split()
    version, file_type = float(fmt[0]), int(fmt[1])
    if file_type == 1:
        nodes, node_ids, elems = (_parse_v4_bin(raw) if version >= 4.0
                                  else _parse_v2_bin(raw))
        return _assemble_mesh(path, nodes, node_ids, elems, dim)
    lines = raw.decode().splitlines()

    sections: dict[str, list[str]] = {}
    i = 0
    while i < len(lines):
        line = lines[i].strip()
        if line.startswith("$") and not line.startswith("$End"):
            name = line[1:]
            j = i + 1
            body = []
            end = f"$End{name}"
            while j < len(lines) and lines[j].strip() != end:
                body.append(lines[j])
                j += 1
            sections[name] = body
            i = j + 1
        else:
            i += 1

    if "MeshFormat" not in sections:
        raise ValueError(f"{path}: not a gmsh msh file")
    version = float(sections["MeshFormat"][0].split()[0])

    if version >= 4.0:
        nodes, node_ids, elems = _parse_v4(sections)
    else:
        nodes, node_ids, elems = _parse_v2(sections)
    return _assemble_mesh(path, nodes, node_ids, elems, dim)


def _assemble_mesh(path, nodes, node_ids, elems, dim):
    # Renumber node ids to contiguous 0-based.
    id_map = {int(g): k for k, g in enumerate(node_ids)}
    remap = np.vectorize(id_map.__getitem__)

    # Infer dimension: highest-dim simplices present.
    dims_present = {d for (_, d, _, _) in elems if d > 0}
    mesh_dim = dim or max(dims_present)

    cells, bfaces, btags = [], [], []
    for etype, edim, phys, conn in elems:
        if edim == mesh_dim and etype in (2, 4):
            cells.append((remap(conn), ))
        elif edim == mesh_dim - 1 and etype in (1, 2):
            bfaces.append(remap(conn))
            btags.append(np.full(len(conn), phys, dtype=np.int32))

    if not cells:
        raise ValueError(f"{path}: no {mesh_dim}-D simplex cells found")
    cells_arr = np.concatenate([c[0] for c in cells], axis=0)
    if bfaces:
        bfaces_arr = np.concatenate(bfaces, axis=0)
        btags_arr = np.concatenate(btags, axis=0)
    else:
        bfaces_arr = np.zeros((0, mesh_dim), dtype=np.int32)
        btags_arr = np.zeros((0,), dtype=np.int32)

    pts = nodes[:, :mesh_dim]
    mesh = Mesh(mesh_dim, pts, cells_arr.astype(np.int32),
                bfaces_arr.astype(np.int32), btags_arr)
    return mesh.ensure_positive_orientation()


def _parse_v2(sections):
    node_lines = sections["Nodes"]
    n_nodes = int(node_lines[0])
    ids = np.empty(n_nodes, dtype=np.int64)
    coords = np.empty((n_nodes, 3))
    for k in range(n_nodes):
        parts = node_lines[1 + k].split()
        ids[k] = int(parts[0])
        coords[k] = [float(x) for x in parts[1:4]]

    elem_lines = sections["Elements"]
    n_elems = int(elem_lines[0])
    elems = []  # (etype, dim, phys, conn (n, n_nodes))
    groups: dict[tuple, list] = {}
    for k in range(n_elems):
        parts = elem_lines[1 + k].split()
        etype = int(parts[1])
        if etype not in _ELEM_TYPES:
            continue
        n_tags = int(parts[2])
        phys = int(parts[3]) if n_tags >= 1 else 0
        nn, edim = _ELEM_TYPES[etype]
        conn = [int(x) for x in parts[3 + n_tags: 3 + n_tags + nn]]
        groups.setdefault((etype, edim, phys), []).append(conn)
    for (etype, edim, phys), conns in groups.items():
        elems.append((etype, edim, phys, np.array(conns, dtype=np.int64)))
    return coords, ids, elems


def _parse_v4(sections):
    # Entities: map (dim, entity_tag) -> physical tag (first one).
    ent_phys: dict[tuple, int] = {}
    if "Entities" in sections:
        body = sections["Entities"]
        counts = [int(x) for x in body[0].split()]  # points, curves, surf, vol
        row = 1
        for edim, cnt in enumerate(counts):
            for _ in range(cnt):
                parts = body[row].split()
                row += 1
                tag = int(parts[0])
                # points: tag x y z numPhys ...; others: tag 6*bbox numPhys ...
                off = 4 if edim == 0 else 7
                n_phys = int(parts[off])
                if n_phys > 0:
                    ent_phys[(edim, tag)] = int(parts[off + 1])

    node_body = sections["Nodes"]
    header = [int(x) for x in node_body[0].split()]
    n_blocks, n_nodes = header[0], header[1]
    ids = np.empty(n_nodes, dtype=np.int64)
    coords = np.empty((n_nodes, 3))
    row, out = 1, 0
    for _ in range(n_blocks):
        _edim, _etag, _param, n_in_block = [int(x) for x in node_body[row].split()]
        row += 1
        for k in range(n_in_block):
            ids[out + k] = int(node_body[row + k])
        row += n_in_block
        for k in range(n_in_block):
            coords[out + k] = [float(x) for x in node_body[row + k].split()[:3]]
        row += n_in_block
        out += n_in_block

    elem_body = sections["Elements"]
    header = [int(x) for x in elem_body[0].split()]
    n_blocks = header[0]
    row = 1
    elems = []
    for _ in range(n_blocks):
        edim, etag, etype, n_in_block = [int(x) for x in elem_body[row].split()]
        row += 1
        if etype in _ELEM_TYPES:
            nn, _ = _ELEM_TYPES[etype]
            conn = np.empty((n_in_block, nn), dtype=np.int64)
            for k in range(n_in_block):
                parts = elem_body[row + k].split()
                conn[k] = [int(x) for x in parts[1:1 + nn]]
            phys = ent_phys.get((edim, etag), 0)
            elems.append((etype, edim, phys, conn))
        row += n_in_block
    return coords, ids, elems


class _Cur:
    """Byte cursor over a binary msh payload."""

    def __init__(self, raw: bytes):
        self.raw = raw
        self.pos = 0

    def seek_after(self, marker: bytes):
        i = self.raw.find(marker, self.pos)
        if i < 0:
            raise ValueError(f"missing {marker.decode()} section")
        self.pos = i + len(marker)
        # consume the rest of the marker line (newline)
        j = self.raw.find(b"\n", self.pos)
        self.pos = j + 1

    def line(self) -> str:
        j = self.raw.find(b"\n", self.pos)
        s = self.raw[self.pos:j].decode()
        self.pos = j + 1
        return s

    def skip_ws(self):
        while self.pos < len(self.raw) and self.raw[self.pos:self.pos + 1] in (b"\n", b"\r", b" "):
            self.pos += 1

    def ints(self, n, size=4):
        fmt = "i" if size == 4 else "q"
        out = struct.unpack_from(f"<{n}{fmt}", self.raw, self.pos)
        self.pos += n * size
        return out

    def doubles(self, n):
        out = struct.unpack_from(f"<{n}d", self.raw, self.pos)
        self.pos += n * 8
        return out

    def array(self, n, dtype):
        a = np.frombuffer(self.raw, dtype=dtype, count=n, offset=self.pos)
        self.pos += n * a.itemsize
        return a


def _parse_v2_bin(raw: bytes):
    """gmsh 2.2 binary: ascii section headers, little-endian payloads."""
    c = _Cur(raw)
    c.seek_after(b"$Nodes")
    n_nodes = int(c.line())
    rec = np.dtype([("id", "<i4"), ("xyz", "<f8", (3,))])
    nodes = c.array(n_nodes, rec)
    ids = nodes["id"].astype(np.int64)
    coords = nodes["xyz"].astype(np.float64)

    c.seek_after(b"$Elements")
    n_elems = int(c.line())
    groups: dict[tuple, list] = {}
    read = 0
    while read < n_elems:
        etype, n_follow, n_tags = c.ints(3)
        nn_dim = _ELEM_TYPES.get(etype)
        nn = nn_dim[0] if nn_dim else {3: 4, 5: 8, 6: 6, 7: 5,
                                       8: 3, 9: 6, 11: 10}.get(etype)
        if nn is None:
            raise ValueError(f"unsupported binary element type {etype}")
        rec = np.frombuffer(c.raw, dtype="<i4",
                            count=n_follow * (1 + n_tags + nn),
                            offset=c.pos).reshape(n_follow, -1)
        c.pos += rec.size * 4
        read += n_follow
        if nn_dim is None:
            continue
        conn = rec[:, 1 + n_tags:].astype(np.int64)
        if n_tags >= 1:
            # one block can mix physical tags; split per tag
            for phys in np.unique(rec[:, 1]):
                sel = rec[:, 1] == phys
                groups.setdefault((etype, nn_dim[1], int(phys)),
                                  []).append(conn[sel])
        else:
            groups.setdefault((etype, nn_dim[1], 0), []).append(conn)
    elems = [(etype, edim, phys, np.concatenate(conns))
             for (etype, edim, phys), conns in groups.items()]
    return coords, ids, elems


def _parse_v4_bin(raw: bytes):
    """gmsh 4.1 binary (size_t = 8 bytes, little-endian)."""
    c = _Cur(raw)
    ent_phys: dict[tuple, int] = {}
    if b"$Entities" in raw:
        c.seek_after(b"$Entities")
        np_, nc_, ns_, nv_ = c.ints(4, size=8)
        for edim, cnt in enumerate((np_, nc_, ns_, nv_)):
            for _ in range(cnt):
                (tag,) = c.ints(1)
                c.doubles(3 if edim == 0 else 6)
                (n_phys,) = c.ints(1, size=8)
                phys = c.ints(n_phys)
                if n_phys:
                    ent_phys[(edim, tag)] = phys[0]
                if edim > 0:
                    (n_bnd,) = c.ints(1, size=8)
                    c.ints(n_bnd)

    c.seek_after(b"$Nodes")
    n_blocks, n_nodes, _mn, _mx = c.ints(4, size=8)
    ids = np.empty(n_nodes, np.int64)
    coords = np.empty((n_nodes, 3))
    out = 0
    for _ in range(n_blocks):
        _edim, _etag, param = c.ints(3)
        (n_in,) = c.ints(1, size=8)
        ids[out:out + n_in] = c.array(n_in, "<i8")
        xyz = c.array(n_in * (3 + (3 if param else 0)), "<f8")
        coords[out:out + n_in] = xyz.reshape(n_in, -1)[:, :3]
        out += n_in

    c.seek_after(b"$Elements")
    n_blocks, _n_elems, _mn, _mx = c.ints(4, size=8)
    elems = []
    for _ in range(n_blocks):
        edim, etag, etype = c.ints(3)
        (n_in,) = c.ints(1, size=8)
        nn_dim = _ELEM_TYPES.get(etype)
        if nn_dim is None:
            raise ValueError(f"unsupported binary element type {etype}")
        nn = nn_dim[0]
        rec = c.array(n_in * (1 + nn), "<i8").reshape(n_in, 1 + nn)
        conn = rec[:, 1:].astype(np.int64)
        elems.append((etype, edim, ent_phys.get((edim, etag), 0), conn))
    return coords, ids, elems


def write_msh_binary(mesh: Mesh, path: str, version: str = "4.1"):
    """Write binary msh (2.2 or 4.1), matching what ``gmsh -bin`` emits —
    and exercising the binary read path without needing gmsh installed."""
    dim = mesh.dim
    cell_type = 2 if dim == 2 else 4
    face_type = 1 if dim == 2 else 2
    with open(path, "wb") as f:
        if version == "2.2":
            f.write(b"$MeshFormat\n2.2 1 8\n")
            f.write(struct.pack("<i", 1))
            f.write(b"\n$EndMeshFormat\n")
            f.write(b"$Nodes\n" + str(mesh.n_points).encode() + b"\n")
            rec = np.zeros(mesh.n_points,
                           np.dtype([("id", "<i4"), ("xyz", "<f8", (3,))]))
            rec["id"] = np.arange(1, mesh.n_points + 1)
            rec["xyz"][:, :dim] = mesh.points
            f.write(rec.tobytes())
            f.write(b"\n$EndNodes\n")
            n_elems = mesh.n_cells + mesh.n_boundary_faces
            f.write(b"$Elements\n" + str(n_elems).encode() + b"\n")
            eid = 1
            for tag in np.unique(mesh.boundary_tags):
                sel = mesh.boundary_tags == tag
                faces = mesh.boundary_faces[sel]
                f.write(struct.pack("<3i", face_type, len(faces), 2))
                rec = np.empty((len(faces), 3 + dim), "<i4")
                rec[:, 0] = np.arange(eid, eid + len(faces))
                rec[:, 1] = rec[:, 2] = tag
                rec[:, 3:] = faces + 1
                f.write(rec.tobytes())
                eid += len(faces)
            f.write(struct.pack("<3i", cell_type, mesh.n_cells, 2))
            rec = np.empty((mesh.n_cells, 3 + dim + 1), "<i4")
            rec[:, 0] = np.arange(eid, eid + mesh.n_cells)
            rec[:, 1] = rec[:, 2] = 10
            rec[:, 3:] = mesh.cells + 1
            f.write(rec.tobytes())
            f.write(b"\n$EndElements\n")
            return

        # ---- 4.1 binary ----
        f.write(b"$MeshFormat\n4.1 1 8\n")
        f.write(struct.pack("<i", 1))
        f.write(b"\n$EndMeshFormat\n")
        tags = list(np.unique(mesh.boundary_tags))
        # entities: one codim-1 entity per boundary tag + one domain entity
        f.write(b"$Entities\n")
        cnt = [0, 0, 0, 0]
        cnt[dim - 1] = len(tags)
        cnt[dim] = 1
        f.write(struct.pack("<4q", *cnt))
        for t in tags:                      # boundary entities, phys = tag
            f.write(struct.pack("<i", int(t)))
            f.write(struct.pack("<6d", *([0.0] * 6)))
            f.write(struct.pack("<q", 1))
            f.write(struct.pack("<i", int(t)))
            f.write(struct.pack("<q", 0))
        f.write(struct.pack("<i", 1))       # domain entity, phys = 10
        f.write(struct.pack("<6d", *([0.0] * 6)))
        f.write(struct.pack("<q", 1))
        f.write(struct.pack("<i", 10))
        f.write(struct.pack("<q", 0))
        f.write(b"\n$EndEntities\n")

        f.write(b"$Nodes\n")
        f.write(struct.pack("<4q", 1, mesh.n_points, 1, mesh.n_points))
        f.write(struct.pack("<3i", dim, 1, 0))
        f.write(struct.pack("<q", mesh.n_points))
        f.write(np.arange(1, mesh.n_points + 1, dtype="<i8").tobytes())
        xyz = np.zeros((mesh.n_points, 3))
        xyz[:, :dim] = mesh.points
        f.write(xyz.astype("<f8").tobytes())
        f.write(b"\n$EndNodes\n")

        f.write(b"$Elements\n")
        n_elems = mesh.n_cells + mesh.n_boundary_faces
        f.write(struct.pack("<4q", len(tags) + 1, n_elems, 1, n_elems))
        eid = 1
        for t in tags:
            sel = mesh.boundary_tags == t
            faces = mesh.boundary_faces[sel]
            f.write(struct.pack("<3i", dim - 1, int(t), face_type))
            f.write(struct.pack("<q", len(faces)))
            rec = np.empty((len(faces), 1 + dim), "<i8")
            rec[:, 0] = np.arange(eid, eid + len(faces))
            rec[:, 1:] = faces + 1
            f.write(rec.tobytes())
            eid += len(faces)
        f.write(struct.pack("<3i", dim, 1, cell_type))
        f.write(struct.pack("<q", mesh.n_cells))
        rec = np.empty((mesh.n_cells, 1 + dim + 1), "<i8")
        rec[:, 0] = np.arange(eid, eid + mesh.n_cells)
        rec[:, 1:] = mesh.cells + 1
        f.write(rec.tobytes())
        f.write(b"\n$EndElements\n")


def write_msh(mesh: Mesh, path: str):
    """Write msh 2.2 ASCII (readable by gmsh, deal.II and ourselves)."""
    dim = mesh.dim
    cell_type = 2 if dim == 2 else 4
    face_type = 1 if dim == 2 else 2
    with open(path, "w") as f:
        f.write("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n")
        f.write(f"$Nodes\n{mesh.n_points}\n")
        for i, p in enumerate(mesh.points):
            xyz = list(p) + [0.0] * (3 - dim)
            f.write(f"{i + 1} {xyz[0]:.16g} {xyz[1]:.16g} {xyz[2]:.16g}\n")
        f.write("$EndNodes\n")
        n_elems = mesh.n_cells + mesh.n_boundary_faces
        f.write(f"$Elements\n{n_elems}\n")
        eid = 1
        for face, tag in zip(mesh.boundary_faces, mesh.boundary_tags):
            conn = " ".join(str(v + 1) for v in face)
            f.write(f"{eid} {face_type} 2 {tag} {tag} {conn}\n")
            eid += 1
        for cell in mesh.cells:
            conn = " ".join(str(v + 1) for v in cell)
            f.write(f"{eid} {cell_type} 2 10 10 {conn}\n")
            eid += 1
        f.write("$EndElements\n")
