"""The port's force analysis (utils/analysis.py, numpy only) against the
JAX package's (pandas) on the committed csvs: the Schaefer-Turek 2D-2
traces and the NACA sweep.  Loaded columns, windowed means and Strouhal
numbers agree to 1e-12 relative; ``richardson`` equals JAX's in the
geometric regime and, with ``ratios`` given outside it, returns three nans
where JAX returns two.
"""

import glob
import math
import os

import numpy as np
import pytest

from navierstokes_tpu.utils import analysis as JA
from navierstokes_tpu_torch.utils import analysis as TA

ART = os.path.join(os.path.dirname(__file__), "..", "artifacts")
CSVS = sorted(glob.glob(os.path.join(ART, "st_2d2_*.csv"))
              + glob.glob(os.path.join(ART, "naca_sweep", "*.csv")))
TOL = 1e-12


def test_committed_csvs_found():
    assert len(CSVS) >= 12, CSVS


@pytest.mark.parametrize("path", CSVS, ids=os.path.basename)
def test_analysis_equals_jax(path):
    rows, df = TA.load_forces(path, 3), JA.load_forces(path, 3)
    assert list(rows.dtype.names) == list(df.columns)
    for col in df.columns:
        np.testing.assert_allclose(rows[col], df[col].to_numpy(), rtol=TOL,
                                   atol=0, err_msg=col)
    for name in ("Cd", "Cl"):
        assert TA.mean_coefficient(path, name) == pytest.approx(
            JA.mean_coefficient(path, name), rel=TOL)
    st_t = TA.strouhal(path, u_mean=1.0)
    st_j = JA.strouhal(path, u_mean=1.0)
    assert st_t == pytest.approx(st_j, rel=TOL) or (math.isnan(st_t)
                                                    and math.isnan(st_j))


def test_plot_coefficient_writes_png(tmp_path):
    pytest.importorskip("matplotlib")
    path = os.path.join(ART, "naca_sweep", "output_8.csv")
    png = tmp_path / "cl.png"
    mean = TA.plot_coefficient(path, "Cl", out_png=str(png))
    assert png.stat().st_size > 0
    assert mean == pytest.approx(JA.mean_coefficient(path, "Cl"), rel=TOL)


@pytest.mark.parametrize("values,ratios", [
    ([7.10, 7.35, 7.41], None), ([7.10, 7.35, 7.41], [2.0, 2.0]),
    ([1.0, 1.5, 1.75, 1.875], [2.0, 2.0, 2.0])])
def test_richardson_equals_jax_in_the_geometric_regime(values, ratios):
    assert TA.richardson(values, ratios) == pytest.approx(
        JA.richardson(values, ratios), rel=TOL)


@pytest.mark.parametrize("values", [[1.0, 2.0, 1.5], [1.0, 1.0, 1.2],
                                    [1.0, 1.1, 1.3]])
def test_richardson_outside_the_regime_keeps_its_arity(values):
    """The JAX fault (ADVICE.md): with ``ratios`` it returns a 2-tuple
    outside the geometric regime; the port returns (nan, nan, nan)."""
    j = JA.richardson(values, [2.0, 2.0])
    t = TA.richardson(values, [2.0, 2.0])
    assert len(j) == 2 and len(t) == 3
    assert all(math.isnan(x) for x in t)
    t2 = TA.richardson(values)
    assert len(t2) == 2 and all(math.isnan(x) for x in t2)
    with pytest.raises(ValueError):
        TA.richardson(values[:2])
