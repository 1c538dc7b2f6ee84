"""Scenario campaign of the port.

    python -m navierstokes_tpu_torch.scenarios.campaign [name ...]
        [--device cpu] [--artifacts DIR] [--work DIR]

The port's copy of the JAX repo's ``scripts/run_scenarios.py``: runs the
scenario drivers end to end, archives each forces csv as
``<artifacts>/torch_scenario_<name>.csv`` and prints a tail summary (mean
and max of Cd and Cl over the last 40%) per run.  Each run is a
subprocess of the port's production CLI (``python -m
navierstokes_tpu_torch run <name> ...``), the entry point a user runs,
bounded by a wall-clock timeout.  A run that fails is recorded with its
exit code and not archived; the campaign then exits non-zero.

Default campaign: 2d-test3 (the full T=8 pulsation period), 3d-test2,
3d-test3 (the full period) and 3d-cylinder, all in the projection scheme,
at the registry's default h.  ``--device`` (default ``cuda``) goes to the
CLI; each run works in ``<work>/<name>``.  The last line is one JSON
object of the summaries.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# name -> (extra CLI args, timeout_s), as in run_scenarios.py
CAMPAIGN = {
    "2d-test3": (["--T", "8.0", "--scheme", "projection"], 5400),
    "3d-test2": (["--scheme", "projection"], 5400),
    "3d-test3": (["--T", "8.0", "--scheme", "projection"], 10800),
    "3d-cylinder": (["--scheme", "projection"], 5400),
}


def tail_stats(csv_path, pulsating=False):
    """Tail summary of a forces csv (the last 40% of its rows); a pulsating
    inlet's rows where |sin(pi t/8)| < 0.2 are masked, since its Cd/Cl
    normalise by the instantaneous mean velocity, which passes through 0
    there by construction."""
    d = np.genfromtxt(csv_path, delimiter=",", names=True)
    n = len(d)
    tail = d[int(0.6 * n):]
    if pulsating:
        tail = tail[np.abs(np.sin(np.pi * tail["time"] / 8.0)) >= 0.2]
    return dict(
        rows=n,
        t_last=round(float(d["time"][-1]), 4),
        cd_tail_mean=round(float(np.mean(tail["Cd"])), 4),
        cd_tail_max=round(float(np.max(tail["Cd"])), 4),
        cl_tail_mean=round(float(np.mean(tail["Cl"])), 5),
        cl_tail_absmax=round(float(np.max(np.abs(tail["Cl"]))), 5),
        finite=bool(np.isfinite(tail["Cd"]).all()
                    and np.isfinite(tail["Cl"]).all()),
    )


def run_command(name, workdir, device="cuda"):
    """The CLI command of one campaign run (argv list) and its timeout."""
    extra, tmo = CAMPAIGN.get(name, ([], 5400))
    cmd = [sys.executable, "-u", "-m", "navierstokes_tpu_torch", "run", name,
           "--output-dir", os.path.join(workdir, "out"),
           "--cache-dir", os.path.join(workdir, "cache"),
           "--csv", os.path.join(workdir, "forces.csv"),
           "--device", device] + extra
    return cmd, tmo


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m navierstokes_tpu_torch.scenarios.campaign",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("names", nargs="*", help="scenarios (default: all four)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--artifacts", default=os.path.join(ROOT, "artifacts"))
    ap.add_argument("--work", default=os.path.join("build", "campaign"))
    args = ap.parse_args(argv)
    names = args.names or list(CAMPAIGN)
    os.makedirs(args.artifacts, exist_ok=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    summary = {}
    for name in names:
        workdir = os.path.abspath(os.path.join(args.work, name))
        shutil.rmtree(workdir, ignore_errors=True)
        os.makedirs(workdir, exist_ok=True)
        cmd, tmo = run_command(name, workdir, args.device)
        print(f"=== {name}: {' '.join(cmd[3:])}", flush=True)
        t0 = time.perf_counter()
        try:
            r = subprocess.run(cmd, cwd=workdir, timeout=tmo, env=env,
                               stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
            rc, output = r.returncode, r.stdout
        except subprocess.TimeoutExpired as e:
            rc = 124
            output = e.stdout if isinstance(e.stdout, str) else ""
        wall = time.perf_counter() - t0
        with open(os.path.join(workdir, "run.log"), "w") as f:
            f.write(output or "")
        print("\n".join((output or "").strip().splitlines()[-6:]),
              flush=True)
        if rc != 0:
            summary[name] = dict(rc=rc)
            print(f"{name}: FAILED rc={rc}", flush=True)
            continue
        dst = os.path.join(args.artifacts, f"torch_scenario_{name}.csv")
        shutil.copyfile(os.path.join(workdir, "forces.csv"), dst)
        summary[name] = dict(rc=0, seconds=round(wall, 1),
                             **tail_stats(dst, "test3" in name))
        print(f"{name}: {summary[name]}", flush=True)
    print(json.dumps(summary), flush=True)
    return 0 if all(s["rc"] == 0 for s in summary.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
