"""Simplex meshes: the container, the reference-geometry generators and
gmsh input and output."""

from navierstokes_tpu_torch.mesh.generators import (  # noqa: F401
    box_3d, channel_with_cylinder_2d, duct_with_box_obstacle_3d,
    duct_with_cylinder_3d, naca_channel_2d, rectangle_2d)
from navierstokes_tpu_torch.mesh.geometry import Mesh  # noqa: F401
from navierstokes_tpu_torch.mesh.msh_io import (  # noqa: F401
    read_msh, write_msh, write_msh_binary)
