"""Simplex meshes: the container, the reference-geometry generators and
the gmsh reader."""

from navierstokes_tpu_torch.mesh.generators import (  # noqa: F401
    box_3d, channel_with_cylinder_2d, duct_with_box_obstacle_3d,
    duct_with_cylinder_3d)
from navierstokes_tpu_torch.mesh.geometry import Mesh  # noqa: F401
from navierstokes_tpu_torch.mesh.msh_io import read_msh  # noqa: F401
