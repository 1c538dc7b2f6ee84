"""Dirichlet boundary conditions via projection masking.

Port of ``navierstokes_tpu/ops/boundary.py``.  With P the projector that
zeroes constrained velocity nodes and g the lifted boundary values,

    A_bc x = P A P x + sigma (I - P) x,    b_bc = P (b - A g) + sigma g.

Precedence parity (src/NavierStokes.cpp:303-318): the inlet first, then
the walls (which get the inlet function) and the obstacle (zero).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from navierstokes_tpu_torch.config import InletConfig
from navierstokes_tpu_torch.fem.spaces import TaylorHoodSpace
from navierstokes_tpu_torch.mesh.geometry import (TAG_INLET, TAG_OBSTACLE,
                                                  TAG_WALL_BOTTOM,
                                                  TAG_WALL_TOP)


@dataclasses.dataclass
class DirichletBC:
    """Static Dirichlet data; per-step values are base_values * factor(t)."""
    mask: torch.Tensor         # (n_p2, 1): 1.0 free node, 0.0 constrained
    base_values: torch.Tensor  # (n_p2, dim): lifted g at factor 1
    host_mask: np.ndarray      # numpy copy of mask, for setup consumers

    def lift(self, factor):
        return self.base_values * factor

    def project_u(self, u):
        return u * self.mask


def build_dirichlet(space: TaylorHoodSpace, inlet: InletConfig, dtype,
                    device) -> DirichletBC:
    n_p2, dim = space.n_p2, space.dim
    values = np.zeros((n_p2, dim))
    constrained = np.zeros(n_p2, dtype=bool)

    def apply(tag, vals_fn):
        nodes = space.p2_nodes_on_tag(tag)
        if len(nodes) == 0:
            return
        constrained[nodes] = True
        values[nodes] = 0.0
        v = np.asarray(vals_fn(space.p2_coords[nodes]))
        if v.ndim == 2:
            values[nodes, :] = v
        else:
            values[nodes, 0] = v

    present = set(space.mesh.boundary_tags.tolist())

    # the time modulation (pulsation, ramp) is the per-step factor; the
    # base profile is its modulation-free evaluation
    def base_profile(pts):
        saved = inlet.pulsating, inlet.ramp
        try:
            inlet.pulsating = False
            inlet.ramp = 0.0
            return inlet.evaluate(pts, t=0.0)
        finally:
            inlet.pulsating, inlet.ramp = saved

    if TAG_INLET in present:
        apply(TAG_INLET, base_profile)
    for tag in (TAG_WALL_BOTTOM, TAG_WALL_TOP):
        if tag in present:
            apply(tag, base_profile)
    if TAG_OBSTACLE in present:
        apply(TAG_OBSTACLE, lambda pts: np.zeros(len(pts)))

    mask = (~constrained).astype(np.float64)[:, None]
    return DirichletBC(
        mask=torch.as_tensor(mask, dtype=dtype, device=device),
        base_values=torch.as_tensor(values, dtype=dtype, device=device),
        host_mask=mask)
