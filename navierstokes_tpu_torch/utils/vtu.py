"""VTU/PVTU field output.

The port's copy of ``navierstokes_tpu/utils/vtu.py``.

Replaces deal.II ``DataOut::write_vtu_with_pvtu_record`` (reference:
src/NavierStokes.cpp:400-436): velocity as a vector field, pressure as a
scalar, plus a per-cell ``partitioning`` field showing the device
assignment (the reference writes the MPI subdomain id, cpp:424-427).

We write quadratic simplex cells (VTK_QUADRATIC_TRIANGLE=22 /
VTK_QUADRATIC_TETRA=24) so the P2 velocity is exported losslessly —
one step beyond the reference, which linearizes patches.  Binary
appended-data encoding keeps files compact.
"""

from __future__ import annotations

import base64
import os

import numpy as np

_VTK_QUAD_TRI = 22
_VTK_QUAD_TET = 24

# VTK quadratic simplex edge-node order differs from ours:
# our local P2 order is vertices then edges (0,1),(0,2),(1,2) [2D] /
# (0,1),(0,2),(0,3),(1,2),(1,3),(2,3) [3D]; VTK wants edges
# (0,1),(1,2),(2,0) [tri] / (0,1),(1,2),(2,0),(0,3),(1,3),(2,3) [tet].
_VTK_EDGE_PERM_2D = [0, 1, 2, 3, 5, 4]           # local node permutation
_VTK_EDGE_PERM_3D = [0, 1, 2, 3, 4, 7, 5, 6, 8, 9]


def _b64(arr: np.ndarray) -> str:
    raw = arr.tobytes()
    header = np.array([len(raw)], dtype=np.uint32).tobytes()
    return base64.b64encode(header + raw).decode()


def write_vtu_pvtu(directory: str, basename: str, time_step: int,
                   p2_coords: np.ndarray, cell_p2: np.ndarray,
                   u: np.ndarray, p_p2: np.ndarray,
                   partitioning: np.ndarray | None = None) -> str:
    """Write ``<basename>_<step>.vtu`` + a matching ``.pvtu`` record.

    p2_coords: (n_p2, dim); cell_p2: (nc, 6|10) in our local order;
    u: (n_p2, dim); p_p2: (n_p2,) pressure already prolonged to P2 nodes
    (TaylorHoodSpace.pressure_at_p2_nodes).
    """
    os.makedirs(directory, exist_ok=True)
    n_p2, dim = p2_coords.shape
    nc, nv = cell_p2.shape

    pts3 = np.zeros((n_p2, 3), dtype=np.float32)
    pts3[:, :dim] = p2_coords
    u3 = np.zeros((n_p2, 3), dtype=np.float32)
    u3[:, :dim] = u
    p_full = np.asarray(p_p2, dtype=np.float32)

    perm = _VTK_EDGE_PERM_2D if dim == 2 else _VTK_EDGE_PERM_3D
    conn = cell_p2[:, perm].astype(np.int32)
    offsets = (np.arange(1, nc + 1, dtype=np.int32) * nv)
    types = np.full(nc, _VTK_QUAD_TRI if dim == 2 else _VTK_QUAD_TET,
                    dtype=np.uint8)
    part = (partitioning if partitioning is not None
            else np.zeros(nc)).astype(np.float32)

    name = f"{basename}_{time_step:06d}"
    vtu_path = os.path.join(directory, name + ".vtu")
    enc = "binary"
    with open(vtu_path, "w") as f:
        f.write('<?xml version="1.0"?>\n')
        f.write('<VTKFile type="UnstructuredGrid" version="0.1" '
                'byte_order="LittleEndian">\n<UnstructuredGrid>\n')
        f.write(f'<Piece NumberOfPoints="{n_p2}" NumberOfCells="{nc}">\n')
        f.write('<Points>\n<DataArray type="Float32" NumberOfComponents="3" '
                f'format="{enc}">{_b64(pts3)}</DataArray>\n</Points>\n')
        f.write('<Cells>\n')
        f.write(f'<DataArray type="Int32" Name="connectivity" format="{enc}">'
                f'{_b64(conn)}</DataArray>\n')
        f.write(f'<DataArray type="Int32" Name="offsets" format="{enc}">'
                f'{_b64(offsets)}</DataArray>\n')
        f.write(f'<DataArray type="UInt8" Name="types" format="{enc}">'
                f'{_b64(types)}</DataArray>\n</Cells>\n')
        f.write('<PointData Vectors="velocity" Scalars="pressure">\n')
        f.write('<DataArray type="Float32" Name="velocity" '
                f'NumberOfComponents="3" format="{enc}">{_b64(u3)}'
                '</DataArray>\n')
        f.write(f'<DataArray type="Float32" Name="pressure" format="{enc}">'
                f'{_b64(p_full)}</DataArray>\n</PointData>\n')
        f.write('<CellData Scalars="partitioning">\n')
        f.write(f'<DataArray type="Float32" Name="partitioning" '
                f'format="{enc}">{_b64(part)}</DataArray>\n</CellData>\n')
        f.write('</Piece>\n</UnstructuredGrid>\n</VTKFile>\n')

    pvtu_path = os.path.join(directory, name + ".pvtu")
    with open(pvtu_path, "w") as f:
        f.write('<?xml version="1.0"?>\n')
        f.write('<VTKFile type="PUnstructuredGrid" version="0.1" '
                'byte_order="LittleEndian">\n<PUnstructuredGrid '
                'GhostLevel="0">\n')
        f.write('<PPoints><PDataArray type="Float32" NumberOfComponents="3"/>'
                '</PPoints>\n')
        f.write('<PPointData Vectors="velocity" Scalars="pressure">\n'
                '<PDataArray type="Float32" Name="velocity" '
                'NumberOfComponents="3"/>\n'
                '<PDataArray type="Float32" Name="pressure"/>\n'
                '</PPointData>\n')
        f.write('<PCellData Scalars="partitioning">'
                '<PDataArray type="Float32" Name="partitioning"/>'
                '</PCellData>\n')
        f.write(f'<Piece Source="{name}.vtu"/>\n')
        f.write('</PUnstructuredGrid>\n</VTKFile>\n')
    return vtu_path
