"""Checkpoint export/import (device-count independent by construction).

The port's copy of ``navierstokes_tpu/utils/checkpoint.py``: the same
``state-ns-<step>.npz`` schema and ordering stamp, so each package
restarts from the other's checkpoints.

The reference engineers 300 lines of raw-MPI machinery
(compute_ordered_dofs_indices + export_data/import_data,
src/NavierStokes.cpp:501-805) so binary checkpoints written at one MPI rank
count restart at another.  Here the DoF ordering is canonical and global
(fem/spaces.py), so a checkpoint is just the solution arrays + step
metadata; any device mesh restores it by resharding on load.

File pattern parity: ``<cache_dir>/state-ns-<step>.npz`` (the reference
writes ``../cache/state-ns-<step>.dat``, cpp:560-567).
"""

from __future__ import annotations

import os

import numpy as np

# Canonical DoF-ordering version stamped into every checkpoint.  Bump when
# the spatial reordering changes (it permutes every DoF vector silently):
#   1 = Morton/Z-order (rounds <= 2 pre-Hilbert)
#   2 = Hilbert curve (mesh/geometry.hilbert_order)
ORDERING_VERSION = 2


def checkpoint_path(cache_dir: str, time_step: int) -> str:
    return os.path.join(cache_dir, f"state-ns-{time_step}.npz")


def export_state(cache_dir: str, time_step: int, u, p, time: float,
                 extra: dict | None = None) -> str:
    """Write the full solution state.  u: (n_p2, dim), p: (n_p1,)."""
    os.makedirs(cache_dir, exist_ok=True)
    path = checkpoint_path(cache_dir, time_step)
    tmp = path + ".tmp"
    payload = dict(u=np.asarray(u), p=np.asarray(p),
                   time=np.float64(time), time_step=np.int64(time_step),
                   ordering_version=np.int64(ORDERING_VERSION))
    if extra:
        payload.update({k: np.asarray(v) for k, v in extra.items()})
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)  # atomic commit
    return path


def import_state(cache_dir: str, time_step: int):
    """Read a checkpoint; returns (u, p, time)."""
    path = checkpoint_path(cache_dir, time_step)
    with np.load(path) as z:
        ver = int(z["ordering_version"]) if "ordering_version" in z.files \
            else 1
        if ver != ORDERING_VERSION:
            raise ValueError(
                f"checkpoint {path} was written with DoF-ordering version "
                f"{ver}, but this build uses version {ORDERING_VERSION} "
                "(Hilbert) — restoring would silently permute the solution. "
                "Re-export the state from the build that wrote it.")
        return z["u"], z["p"], float(z["time"])
