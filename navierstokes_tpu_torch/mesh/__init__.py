"""Triangle meshes: the container, the cylinder-channel generator and the
gmsh reader."""

from navierstokes_tpu_torch.mesh.generators import (  # noqa: F401
    channel_with_cylinder_2d)
from navierstokes_tpu_torch.mesh.geometry import Mesh  # noqa: F401
from navierstokes_tpu_torch.mesh.msh_io import read_msh  # noqa: F401
