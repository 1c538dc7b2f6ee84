"""Caps over the port's committed validation and campaign traces
(``artifacts/torch_*.csv``), each run on an NVIDIA H100 in fp32 by
``python -m navierstokes_tpu_torch.scenarios.validate`` or
``python -m navierstokes_tpu_torch.scenarios.campaign``.

The caps are those the JAX repo's traces are held to
(tests/test_artifacts.py) or the bands named below: the port runs fp32 on
another chip and vortex shedding is chaotic, so the port is held to the
JAX traces at band level only, not step by step.  Every trace is
committed, so a missing file fails.  Each test also checks that time is
monotone, that the tail is finite and that the row count equals the
run's steps.
"""

import os

import numpy as np
import pytest

ART = os.path.join(os.path.dirname(__file__), "..", "artifacts")
# The campaign (run (d)): name -> (steps, dt) and the CASES bands of
# tests/test_artifacts.py, (cd_lo, cd_hi, cl_absmax, pulsating), in the
# scenario's own (reference) normalisation.  A pulsating inlet normalises
# by the instantaneous mean velocity, so its Cd/Cl statistics mask
# |sin(pi t/8)| < 0.2; the raw Drag/Lift are checked unmasked.
CAMPAIGN = {
    "2d-test3": ((800, 0.01), (0.0, 50.0, 60.0, True)),
    "3d-test2": ((200, 0.01), (0.5, 15.0, 10.0, False)),
    "3d-test3": ((800, 0.01), (0.0, 50.0, 60.0, True)),
    "3d-cylinder": ((200, 0.01), (0.5, 30.0, 10.0, False)),
}


def _trace(name, n_rows, dt, columns=("Drag", "Lift", "Cd", "Cl")):
    d = np.genfromtxt(os.path.join(ART, name), delimiter=",", names=True)
    assert len(d) == n_rows, (name, len(d))
    t = d["time"]
    assert np.all(np.diff(t) > 0), "time not monotone"
    # the run reached its final time n dt; the step's time accumulates in
    # fp32 (the JAX traces' too), 6 steps short of 8.0 after 25,600 steps
    assert abs(t[-1] - n_rows * dt) <= 1e-3 * n_rows * dt, t[-1]
    tail = d[int(0.6 * len(d)):]
    for col in columns:
        assert np.isfinite(tail[col]).all(), f"{col} has non-finite entries"
    return d


@pytest.mark.parametrize("name,n_rows,dt,cd_cap,cl_cap", [
    ("torch_st_2d2_projection_bdf2_h015_dt00125.csv", 6400, 0.00125, 3.25,
     1.03),
    ("torch_st_2d2_projection_bdf2_h015_dt00003125.csv", 25600, 0.0003125,
     3.24, 1.01)])
def test_2d2_projection_bdf2_h015(name, n_rows, dt, cd_cap, cl_cap):
    """Run (a), north-star condition 2, and the dt=0.0003125 leg (e): the
    caps of tests/test_artifacts.py for the JAX traces at the same h and
    dt, 3.20 <= Cd_max <= cd_cap and 0.95 <= Cl_max <= cl_cap over
    t > 0.6 T, and St in 0.295-0.305 by its rule (the mean period between
    upward zero crossings of Cl that lead to a real shedding peak)."""
    d = _trace(name, n_rows, dt)
    t = d["time"]
    m = t > 0.6 * t[-1]
    cd_max = float(d["Cd"][m].max())
    cl_max = float(d["Cl"][m].max())
    assert 3.20 <= cd_max <= cd_cap, cd_max
    assert 0.95 <= cl_max <= cl_cap, cl_max
    st = _strouhal_crossings(d["Cl"][m], t[m])
    assert 0.295 <= st <= 0.305, st


def _strouhal_crossings(y, tt):
    """St from the mean period between upward zero crossings of Cl that
    lead to a real shedding peak (tests/test_artifacts.py's rule)."""
    s = np.where((y[:-1] < 0) & (y[1:] >= 0))[0]
    assert len(s) >= 3, "too few shedding periods in the tail"
    peak = 0.5 * float(y.max())
    real = [i for i in range(len(s) - 1)
            if float(y[s[i]:s[i + 1]].max()) >= peak]
    valid = [s[i] for i in real] + [s[real[-1] + 1]]
    return 0.1 / (float(np.diff(tt[valid]).mean()) * (2.0 * 1.5 / 3.0))


# ``validate bench`` (scripts/validate_bench.py's configuration) on the
# 1,014,414-DoF bench mesh to T=8: run (f) at the script's dt, runs (g) of
# the dt study, and run (h), ``validate 2d2 --projection --h 0.0037
# --hnear 0.00185 --wake-levels 0`` (the bench mesh's generator and
# resolution with the cylinder snapped); name -> (steps, dt)
BENCH = {
    "torch_st_bench_projection_bdf2_dt00125_T8.csv": (6400, 0.00125),
    "torch_st_bench_projection_bdf2_dt0000625_T8.csv": (12800, 0.000625),
    "torch_st_bench_projection_bdf2_dt00003125_T8.csv": (25600, 0.0003125),
    "torch_st_2d2_projection_bdf2_h0037_curved_dt00125_T8.csv":
        (6400, 0.00125)}


def _bench(name):
    """The trace and its statistics window, t > 0.75 T (the script's)."""
    d = _trace(name, *BENCH[name])
    return d, d["time"] > 0.75 * 8.0


@pytest.mark.parametrize("name", sorted(BENCH))
def test_bench_resolution_traces(name):
    """Runs (f)-(h): every trace complete, finite and monotone in time,
    St over t > 0.75 T in 0.295-0.305 by the zero-crossing rule."""
    d, m = _bench(name)
    st = _strouhal_crossings(d["Cl"][m], d["time"][m])
    assert 0.295 <= st <= 0.305, st


# Run (i): the dt study's fourth step, dt=0.00015625 (CFL about 0.26),
# 51,200 steps; only its statistics window t > 0.75 T is committed (the
# whole trace is 7.9 MB): rows from t=6.00005 to the run's end.
BENCH_TAIL = "torch_st_bench_projection_bdf2_dt000015625_T8_tail.csv"


def test_bench_dt000015625_statistics_window():
    """Run (i)'s window: 12,807 rows of dt=0.00015625 from t > 6 to
    t = 8 (fp32 time), finite, monotone, St in 0.295-0.305 by the
    zero-crossing rule; its Cd_max 3.2418 and Cl_max 1.0355 are the
    figures the run printed."""
    d = np.genfromtxt(os.path.join(ART, BENCH_TAIL), delimiter=",",
                      names=True)
    t = d["time"]
    assert len(d) == 12807 and np.all(np.diff(t) > 0)
    assert 6.0 < t[0] < 6.0 + 2 * 0.00015625 and abs(t[-1] - 8.0) < 8e-3
    assert np.all(d["deltat"] == 0.00015625)
    for col in ("Drag", "Lift", "Cd", "Cl"):
        assert np.isfinite(d[col]).all(), col
    assert round(float(d["Cd"].max()), 4) == 3.2418
    assert round(float(d["Cl"].max()), 4) == 1.0355
    st = _strouhal_crossings(d["Cl"], t)
    assert 0.295 <= st <= 0.305, st


@pytest.mark.xfail(strict=True, reason=(
    "run (f) misses the caps fixed before it: Cd_max 3.2523 > 3.25 and "
    "Cl_max 1.0659 > 1.03 over t > 0.75 T (St 0.3001 in band). Cause not "
    "found. The polygonal cylinder is ruled out: the same resolution "
    "snapped gives 3.2544 / 1.0665 (run (h)). The time step is not: the "
    "dt study gives Cl_max 1.0667 at dt 0.000625 (CFL 1.03), 1.0804 at "
    "0.0003125 (CFL 0.52) and 1.0355 at 0.00015625 (CFL 0.26; Cd_max "
    "3.2418), runs (g) and (i), rising and then falling as JAX's h=0.015 "
    "projection family does (VALIDATION.md:286-340, 0.9965 at CFL "
    "0.29), and still 0.0055 above the cap at CFL 0.26. Would settle it: "
    "dt 0.000078125 on the bench mesh (CFL about 0.13), or a few float64 "
    "steps of the bench mesh in the port against JAX"))
def test_bench_projection_bdf2_dt00125_T8_caps():
    """Run (f) against the caps that tests/test_artifacts.py holds the JAX
    traces at this dt to, fixed before the run: 3.20 <= Cd_max <= 3.25 and
    0.95 <= Cl_max <= 1.03 over t > 0.75 T.  The trace misses them
    (PERF.md, PR 11): expected to fail until its cause is found and
    repaired."""
    d, m = _bench("torch_st_bench_projection_bdf2_dt00125_T8.csv")
    cd_max, cl_max = float(d["Cd"][m].max()), float(d["Cl"][m].max())
    assert 3.20 <= cd_max <= 3.25, cd_max
    assert 0.95 <= cl_max <= 1.03, cl_max


def _settled(d):
    """validate_st.py's 2D-1 figure: the mean of the last 10% of the rows."""
    tail = d[int(len(d) * 0.9):]
    return float(tail["Cd"].mean()), float(tail["Cl"].mean())


def test_2d1_monolithic_refine2_h010_T6():
    """Run (b), the script's 2D-1 with the cylinder's P2 nodes snapped
    (its default), fp32 with two float64-residual refinement passes: the
    settled Cd and Cl inside the published intervals the script prints,
    5.57-5.59 and 0.0104-0.0110, which the unrefined fp32 Cl (0.0036)
    misses.  The JAX TPU run of this configuration
    (st_2d1_curved_fp32_refine2_h010_T6.csv) settles at 5.5765 /
    0.01046."""
    d = _trace("torch_st_2d1_monolithic_refine2_h010_T6.csv", 600, 0.01)
    cd, cl = _settled(d)
    assert 5.57 <= cd <= 5.59, cd
    assert 0.0104 <= cl <= 0.0110, cl


def test_3d1_projection_diag_h023_T3():
    """Run (c), 3D-1Z at 3,393,382 DoF: the tail mean (last 40%) of Cd
    within 1% of the JAX TPU run's 7.4223
    (st_3d1_projection_34M_h023.csv), 7.35-7.50, and |tail mean Cl| <=
    0.03 (the TPU's -0.0154): at T=3 the flow is still short of the
    published 7.5-7.7 on both chips."""
    d = _trace("torch_st_3d1_projection_diag_h023_T3.csv", 300, 0.01)
    tail = d[int(len(d) * 0.6):]
    cd, cl = float(tail["Cd"].mean()), float(tail["Cl"].mean())
    assert 7.35 <= cd <= 7.50, cd
    assert abs(cl) <= 0.03, cl


def test_2d1_monolithic_refine2_polygonal_h010_T6():
    """Run (b) with ``--no-curved``, the polygonal cylinder of the JAX TPU
    run st_2d1_tpu_fp32_refine2_h010_T6.csv (settled Cd 5.5625, Cl
    0.0117): the settled Cd inside 5.55-5.58.  Its Cl follows the JAX
    float64 CPU run of the same mesh (st_2d1_monolithic_f64_h010.csv, T=4)
    and not the TPU's, whose fp32 Cl sits 0.0015 above both: the mean
    over steps 361-400 within 5% of the float64 run's, a band that the
    TPU's (+20%) and the unrefined fp32 Cl (0.0036) both miss."""
    d = _trace("torch_st_2d1_monolithic_refine2_polygonal_h010_T6.csv", 600,
               0.01)
    cd, _ = _settled(d)
    assert 5.55 <= cd <= 5.58, cd
    ref = np.genfromtxt(os.path.join(ART, "st_2d1_monolithic_f64_h010.csv"),
                        delimiter=",", names=True)
    window = slice(360, 400)
    cl, cl_ref = d["Cl"][window].mean(), ref["Cl"][window].mean()
    assert abs(cl - cl_ref) <= 0.05 * abs(cl_ref), (cl, cl_ref)


@pytest.mark.parametrize("name", sorted(CAMPAIGN))
def test_scenario_trace(name):
    """Run (d): the campaign's traces in the bands the JAX campaign's are
    held to."""
    (n_rows, dt), (lo, hi, clmax, pulsating) = CAMPAIGN[name]
    d = _trace(f"torch_scenario_{name}.csv", n_rows, dt, ("Drag", "Lift"))
    tail = d[int(0.6 * len(d)):]
    assert float(np.max(np.abs(tail["Drag"]))) < 1e3
    if pulsating:
        tail = tail[np.abs(np.sin(np.pi * tail["time"] / 8.0)) >= 0.2]
    for col in ("Cd", "Cl"):
        assert np.isfinite(tail[col]).all(), f"{col} has non-finite entries"
    cd_mean = float(np.mean(tail["Cd"]))
    assert lo <= cd_mean <= hi, f"tail mean Cd {cd_mean} outside [{lo},{hi}]"
    assert float(np.max(np.abs(tail["Cl"]))) <= clmax
