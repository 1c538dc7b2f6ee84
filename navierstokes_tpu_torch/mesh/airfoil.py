"""NACA airfoil loading and placement.

The port's copy of ``navierstokes_tpu/mesh/airfoil.py``: the reference's
mesh generator (mesh/test.py:6-42) loads a ``<name>\\n x y ...`` polyline
``.dat`` file, centres it (x - 0.5), scales it to a chord and rotates it
by an angle of attack.  The transformed polyline feeds
``generators.naca_channel_2d`` directly, and ``write_geo`` writes the
reference's ``.geo`` (mesh/test.py:76-150) for users who have gmsh.

The reference's rotate(angle) applies the rotation matrix of ``-angle``
(mesh/test.py:33-41), so a positive angle of attack pitches the nose up
against the incoming flow; the same convention holds here.
"""

from __future__ import annotations

import math

import numpy as np


class NacaAirfoil:
    def __init__(self, name: str, points: np.ndarray):
        self.name = name
        self.points = np.asarray(points, dtype=float).copy()
        self.chord = 1.0
        self.angle = 0.0

    @classmethod
    def from_dat(cls, path: str) -> "NacaAirfoil":
        with open(path) as f:
            lines = [ln.strip() for ln in f if ln.strip()]
        pts = np.array([[float(v) for v in ln.split()[:2]]
                        for ln in lines[1:]])
        pts[:, 0] -= 0.5                 # centred like mesh/test.py:19
        return cls(lines[0], pts)

    def resize(self, chord: float) -> "NacaAirfoil":
        self.points *= chord / self.chord
        self.chord = chord
        return self

    def rotate(self, angle_rad: float) -> "NacaAirfoil":
        """Rotate by -angle (reference convention, mesh/test.py:33-41)."""
        self.angle -= angle_rad
        c, s = math.cos(-angle_rad), math.sin(-angle_rad)
        x, y = self.points[:, 0].copy(), self.points[:, 1].copy()
        self.points[:, 0] = c * x - s * y
        self.points[:, 1] = s * x + c * y
        return self

    def write_geo(self, path: str, lx=2.2, ly=1.0, dx=0.4, dy=0.5, h=0.015):
        """Write the gmsh .geo the reference generator writes
        (mesh/test.py:76-150)."""
        buf = [f"// Domain size\nLx = {lx:10.4f};\nLy = {ly:10.4f};",
               "\n// Coordinates of the center of the airfoil",
               f"Dx = {dx:10.4f};\nDy = {dy:10.4f};",
               f"\nh = {h:10.4f};", "\n// Points",
               "Point(0) = {0, 0, 0, h};",
               "Point(1) = {Lx, 0, 0, h};",
               "Point(2) = {Lx, Ly, 0, h};",
               "Point(3) = {0, Ly, 0, h};", ""]
        n = len(self.points)
        for i, (x, y) in enumerate(self.points):
            buf.append(f"Point({i + 4}) = {{Dx {x:+.5f}, Dy {y:+.5f}, 0, h}};")
        buf += ["\n// Lines", "Line(0) = {0, 1};", "Line(1) = {1, 2};",
                "Line(2) = {2, 3};", "Line(3) = {3, 0};", ""]
        for i in range(n):
            buf.append(f"Line({i + 4}) = {{{i + 4}, {(i + 1) % n + 4}}};")
        loop = ", ".join(str(i + 4) for i in range(n))
        buf += ["\n// Loops", "Line Loop(1) = {0, 1, 2, 3};",
                f"Line Loop(2) = {{{loop}}};",
                "\n// Surfaces", "Plane Surface(0) = {1, 2};",
                "\n// Physical entities",
                "Physical Line(0) = {0};", "Physical Line(1) = {1};",
                "Physical Line(2) = {2};", "Physical Line(3) = {3};",
                f"Physical Line(4) = {{{loop}}};",
                "Physical Surface(10) = {0};", "\nMesh 2;"]
        with open(path, "w") as f:
            f.write("\n".join(buf) + "\n")


def naca4_polyline(code: str = "2408", n: int = 40) -> np.ndarray:
    """A NACA 4-digit section as a closed polyline, from the standard
    4-digit formulas (closed trailing edge, cosine spacing), centred at
    x - 0.5 like the reference loader (mesh/test.py:19).  The reference
    ships the sampled NACA 2408 and 2412 (mesh/naca.dat, naca2412.dat).
    Points run from the trailing edge over the upper surface to the
    leading edge and back, the winding of the .dat files."""
    m = int(code[0]) / 100.0
    p = int(code[1]) / 10.0
    t = int(code[2:4]) / 100.0

    beta = np.linspace(0.0, np.pi, n)
    x = 0.5 * (1.0 + np.cos(beta))  # cosine spacing, TE -> LE
    yt = 5.0 * t * (0.2969 * np.sqrt(x) - 0.1260 * x - 0.3516 * x ** 2
                    + 0.2843 * x ** 3 - 0.1036 * x ** 4)
    if m > 0 and p > 0:
        yc = np.where(x < p, m / p ** 2 * (2 * p * x - x ** 2),
                      m / (1 - p) ** 2 * ((1 - 2 * p) + 2 * p * x - x ** 2))
        dyc = np.where(x < p, 2 * m / p ** 2 * (p - x),
                       2 * m / (1 - p) ** 2 * (p - x))
    else:
        yc = np.zeros_like(x)
        dyc = np.zeros_like(x)
    th = np.arctan(dyc)
    xu, yu = x - yt * np.sin(th), yc + yt * np.cos(th)
    xl, yl = x + yt * np.sin(th), yc - yt * np.cos(th)
    # closed loop: upper TE->LE, lower LE->TE (skip duplicated LE/TE points)
    pts = np.concatenate([np.stack([xu, yu], axis=1),
                          np.stack([xl, yl], axis=1)[::-1][1:-1]], axis=0)
    pts[:, 0] -= 0.5
    return pts


def load_airfoil(path: str, chord: float, angle_deg: float) -> np.ndarray:
    """The reference CLI (mesh/test.py:155-168): load, scale to ``chord``,
    rotate by ``angle_deg``; the polyline relative to the airfoil centre."""
    a = NacaAirfoil.from_dat(path)
    a.resize(chord)
    a.rotate(angle_deg * math.pi / 180.0)
    return a.points
