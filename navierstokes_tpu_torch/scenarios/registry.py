"""Scenario registry: the reference's per-scenario main programs as
named configurations.

The port's copy of ``navierstokes_tpu/scenarios/registry.py``: the same
nine scenarios with the same parameters and citations of the reference
programs they mirror (src/main.cpp, tests/{2D,3D}/test_*/src/*.cpp).
Meshes come from the port's generators or a user-supplied .msh file.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from navierstokes_tpu_torch.config import InletConfig, SolverConfig
import math

import numpy as np

from navierstokes_tpu_torch.mesh import (channel_with_cylinder_2d,
                                         duct_with_box_obstacle_3d,
                                         duct_with_cylinder_3d,
                                         naca_channel_2d)
from navierstokes_tpu_torch.mesh.airfoil import naca4_polyline


@dataclasses.dataclass
class Scenario:
    name: str
    description: str
    dim: int
    mesh_fn: Callable          # (h, **mesh_kwargs) -> Mesh
    inlet: InletConfig
    deltat: float
    t_final: float
    output_step: int
    re: Optional[float] = None  # None -> keep nu = 1e-3 default
    default_h: float = 0.05


def _cyl2d(h):
    return channel_with_cylinder_2d(h=h)


def _duct3d_box(h, **kw):
    return duct_with_box_obstacle_3d(h=h, **kw)


def _duct3d_cyl(h, **kw):
    return duct_with_cylinder_3d(h=h, **kw)


def _naca(h, code="2408", chord=0.4, angle_deg=0.0):
    """The NACA ``code`` section scaled to ``chord`` and rotated by
    -``angle_deg`` (the reference's convention, mesh/test.py:33-41)."""
    a = math.radians(angle_deg)
    c, s = math.cos(-a), math.sin(-a)
    rot = np.array([[c, -s], [s, c]])
    return naca_channel_2d((naca4_polyline(code) * chord) @ rot.T, h=h)


SCENARIOS = {
    # src/main.cpp: parabolic 1.5-peak inlet (main.cpp:23), dt=0.01, T=0.2,
    # step=2 (main.cpp:64), nu default 1e-3; get_mean_vel = 4*10/9
    # (main.cpp:13, 45 — the U_m=10 constant is vestigial but feeds Cd/Cl
    # normalization, so it is mirrored via mean_override).
    "main-2d": Scenario(
        "main-2d", "primary 2D cylinder-channel app (src/main.cpp)",
        2, _cyl2d,
        InletConfig(kind="parabolic", u_m=1.5, height=0.41,
                    mean_override=4.0 * 10.0 / 9.0),
        deltat=0.01, t_final=0.2, output_step=2, default_h=0.03),

    # tests/2D/test_01: Schaefer-Turek 2D-1 steady, Re=20
    # (test_01.cpp:15, 24, 57-58)
    "2d-test1": Scenario(
        "2d-test1", "ST 2D-1 steady cylinder, Re=20 (tests/2D/test_01)",
        2, _cyl2d, InletConfig(kind="parabolic", u_m=0.3, height=0.41),
        deltat=0.01, t_final=2.0, output_step=10, re=20, default_h=0.03),

    # tests/2D/test_02: 2D-2 vortex shedding, Re=100 (test_02.cpp:15, 57-58)
    "2d-test2": Scenario(
        "2d-test2", "ST 2D-2 unsteady cylinder, Re=100 (tests/2D/test_02)",
        2, _cyl2d, InletConfig(kind="parabolic", u_m=1.5, height=0.41),
        deltat=0.02, t_final=0.5, output_step=2, re=100, default_h=0.03),

    # tests/2D/test_03: pulsating inlet sin(pi t/8) (test_03.cpp:24-26, 59-60)
    "2d-test3": Scenario(
        "2d-test3", "2D pulsating inlet, Re=100 (tests/2D/test_03)",
        2, _cyl2d,
        InletConfig(kind="parabolic", u_m=1.5, height=0.41, pulsating=True,
                    period=8.0),
        deltat=0.01, t_final=8.0, output_step=10, re=100, default_h=0.03),

    # tests/2D/test_naca: NACA 2408 chord 0.4, uniform inlet U=1
    # (test_naca/src/test_03.cpp:15, 24, 57; run_test.sh:8)
    "2d-naca": Scenario(
        "2d-naca", "NACA 2408 airfoil channel (tests/2D/test_naca)",
        2, _naca, InletConfig(kind="uniform", u_m=1.0),
        deltat=0.01, t_final=1.0, output_step=2, default_h=0.02),

    # tests/3D/test_01: square-column duct, Re=20 (test_01.cpp:15, 24, 57-58)
    "3d-test1": Scenario(
        "3d-test1", "3D duct + square column, Re=20 (tests/3D/test_01)",
        3, _duct3d_box,
        InletConfig(kind="biparabolic", u_m=0.45, height=0.41),
        deltat=0.01, t_final=2.0, output_step=10, re=20, default_h=0.04),

    # tests/3D/test_02: Re=100 (test_02.cpp:15, 57-58)
    "3d-test2": Scenario(
        "3d-test2", "3D duct + square column, Re=100 (tests/3D/test_02)",
        3, _duct3d_box,
        InletConfig(kind="biparabolic", u_m=2.25, height=0.41),
        deltat=0.01, t_final=2.0, output_step=10, re=100, default_h=0.04),

    # tests/3D/test_03: pulsating (test_03.cpp:24-25, 59-60)
    "3d-test3": Scenario(
        "3d-test3", "3D pulsating inlet, Re=100 (tests/3D/test_03)",
        3, _duct3d_box,
        InletConfig(kind="biparabolic", u_m=2.25, height=0.41,
                    pulsating=True, period=8.0),
        deltat=0.01, t_final=8.0, output_step=10, re=100, default_h=0.04),

    # mesh/domain3D2.geo variant: circular cylinder duct
    "3d-cylinder": Scenario(
        "3d-cylinder", "3D duct + circular cylinder (mesh/domain3D2.geo)",
        3, _duct3d_cyl,
        InletConfig(kind="biparabolic", u_m=0.45, height=0.41),
        deltat=0.01, t_final=2.0, output_step=10, re=20, default_h=0.04),
}


def get_scenario(name: str) -> Scenario:
    if name not in SCENARIOS:
        raise KeyError(f"unknown scenario {name!r}; available: "
                       f"{sorted(SCENARIOS)}")
    return SCENARIOS[name]


def build_solver(name: str, h: float | None = None,
                 config: SolverConfig | None = None, mesh=None,
                 mesh_kwargs: dict | None = None, device="cuda",
                 **overrides):
    """A configured NavierStokes solver for a named scenario, on
    ``device`` (the card unless the caller asks for "cpu").

    ``overrides``: deltat / t_final / output_step / re (what the
    reference sets in each scenario's source, here at run time).
    ``mesh`` replaces the scenario's generator; ``mesh_kwargs`` go to the
    generator (e.g. ``h_near`` of the 3D duct)."""
    from navierstokes_tpu_torch.models.navier_stokes import NavierStokes

    sc = get_scenario(name)
    cfg = config or SolverConfig()
    if mesh is None:
        mesh = sc.mesh_fn(h or sc.default_h, **(mesh_kwargs or {}))
    ns = NavierStokes(mesh, 2, 1, deltat=overrides.get("deltat", sc.deltat),
                      T=overrides.get("t_final", sc.t_final),
                      step=overrides.get("output_step", sc.output_step),
                      inlet=sc.inlet, config=cfg, device=device)
    re = overrides.get("re", sc.re)
    if re is not None:
        ns.set_re_number(re)
    return ns
