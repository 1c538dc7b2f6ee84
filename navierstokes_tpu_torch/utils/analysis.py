"""Force-coefficient analysis of the ``forces_vs_time.csv`` files.

The port's copy of ``navierstokes_tpu/utils/analysis.py`` (the reference's
analysis/plot_coefficients.ipynb as a library): load the csv (the columns
of src/NavierStokes.cpp:447), trim warm-up rows, report the windowed mean
of Cd or Cl, plot it, the Strouhal number of a shedding trace, and
Richardson extrapolation of a convergent sequence.  The csv is read with
numpy (no pandas); matplotlib is imported only by ``plot_coefficient``.
"""

from __future__ import annotations

import numpy as np


def load_forces(csv_path: str, skip_rows: int = 0) -> np.ndarray:
    """The csv's rows from ``skip_rows`` on, as a numpy structured array
    whose fields are the header's columns (``rows["Cd"]``)."""
    rows = np.atleast_1d(np.genfromtxt(csv_path, delimiter=",", names=True))
    return rows[skip_rows:]


def mean_coefficient(csv_path: str, name: str = "Cd",
                     skip_rows: int = 10) -> float:
    return float(load_forces(csv_path, skip_rows)[name].mean())


def plot_coefficient(csv_path: str, name: str = "Cd", skip_rows: int = 10,
                     out_png: str | None = None, title: str | None = None):
    """Plot ``name`` against time into ``out_png``; returns its mean."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = load_forces(csv_path, skip_rows)
    fig, ax = plt.subplots(figsize=(8, 4))
    ax.plot(rows["time"], rows[name], lw=1.2)
    ax.set_xlabel("time [s]")
    ax.set_ylabel(name)
    ax.set_title(title or f"{name} over time")
    ax.grid(alpha=0.3)
    fig.tight_layout()
    if out_png:
        fig.savefig(out_png, dpi=130)
    plt.close(fig)
    return float(rows[name].mean())


def strouhal(csv_path: str, name: str = "Cl", skip_fraction: float = 0.5,
             ref_length: float = 0.1, u_mean: float = 1.0) -> float:
    """Shedding frequency from the dominant FFT peak of the lift trace:
    St = f * L / U."""
    rows = load_forces(csv_path)
    rows = rows[int(len(rows) * skip_fraction):]
    t = rows["time"]
    y = rows[name] - rows[name].mean()
    if len(t) < 8:
        return float("nan")
    dt = float(np.median(np.diff(t)))
    freqs = np.fft.rfftfreq(len(y), dt)
    amp = np.abs(np.fft.rfft(y))
    f_peak = float(freqs[1:][np.argmax(amp[1:])])
    return f_peak * ref_length / u_mean


def richardson(values, ratios=None):
    """Richardson-style extrapolation of a convergent sequence of
    functionals f_1, ..., f_n (coarse -> fine).

    Fits the last three values to f_k = f_inf - C r^k (geometric
    increments) and returns (f_inf, r), r = (f_n - f_{n-1}) /
    (f_{n-1} - f_{n-2}).  With ``ratios`` (the per-level refinement
    factors s, len n-1) it also returns the observed order
    p = -log(r) / log(s) as a third element.  Outside the geometric
    regime every element is nan, the same count either way (the JAX
    package returns a 2-tuple there even when ``ratios`` is given)."""
    v = np.asarray(values, dtype=float)
    if len(v) < 3:
        raise ValueError("need at least 3 levels")
    n_out = 2 if ratios is None else 3
    d1, d2 = v[-2] - v[-3], v[-1] - v[-2]
    if d1 == 0.0 or np.sign(d1) != np.sign(d2) or abs(d2) >= abs(d1):
        return (float("nan"),) * n_out      # not in the geometric regime
    r = d2 / d1
    f_inf = v[-1] + d2 * r / (1.0 - r)
    if ratios is not None:
        s = float(ratios[-1])
        return float(f_inf), float(r), float(-np.log(r) / np.log(s))
    return float(f_inf), float(r)
