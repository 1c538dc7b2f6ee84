"""Devices and row ranges of a sharded run.

Port of ``navierstokes_tpu/parallel/sharding.py``.  The JAX package has
two multi-device paths over a 1-D device mesh, both with the DoF vectors
replicated: the bsr operator sharded by block rows (GSPMD,
``models/navier_stokes.py`` ``_apply_gspmd_sharding``), and the generic
element ("cells") operator sharded by cells under ``shard_map``, one
``psum`` per product (``parallel/sharded_ops.py``; every Taylor-Hood pair
but P2/P1).  The port does both in one process, one shard per device of
``shard_devices``, the vectors on the model's home device: the bsr
operators' rows split into contiguous ranges (``parallel/sharded_bsr.py``)
and the cells into contiguous blocks whose node sums the home device adds
in shard order (``parallel/sharded_cells.py``).  The reference's
counterpart is its MPI domain decomposition over mesh cells
(src/NavierStokes.cpp:19-23).
"""

from __future__ import annotations

import numpy as np
import torch


def shard_devices(home, n: int, devices=None) -> list[torch.device]:
    """The torch device of each of the ``n`` shards.

    An explicit ``devices`` list is taken as it is (it may repeat a
    device, e.g. two shards on ``cuda:0``).  Otherwise a CUDA home gives
    ``cuda:0 .. cuda:n-1`` and raises if fewer cards are visible; a CPU
    home puts every shard on the CPU (the port's counterpart of JAX's
    virtual host devices)."""
    home = torch.device(home)
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        if len(devs) != n:
            raise ValueError(f"shard_devices: {len(devs)} devices given for "
                             f"{n} shards")
        for d in devs:
            if d.type != home.type:
                raise ValueError(f"shard_devices: shard device {d} on a "
                                 f"{home.type} home")
            if d.type == "cuda" and (d.index or 0) >= \
                    torch.cuda.device_count():
                raise RuntimeError(f"shard_devices: {d} is not visible "
                                   f"({torch.cuda.device_count()} cards)")
        return devs
    if home.type == "cpu":
        return [home] * n
    if home.type != "cuda":
        raise ValueError(f"shard_devices: unsupported home device {home}")
    visible = torch.cuda.device_count()
    if visible < n:
        raise RuntimeError(
            f"shard_devices: {n} shards need {n} CUDA devices, {visible} "
            "visible (pass shard_devices=[...] to place several shards on "
            "one card)")
    return [torch.device("cuda", i) for i in range(n)]


def cell_partitioning(n_cells: int, n_devices: int = 0) -> np.ndarray:
    """Device id per cell, in contiguous blocks (cells from the generators
    and from gmsh are spatially coherent in index order): the VTU's
    ``partitioning`` field.  ``n_devices`` 0 means one device here (JAX:
    all visible devices)."""
    n = max(1, n_devices)
    return np.minimum((np.arange(n_cells) * n) // max(n_cells, 1),
                      n - 1).astype(np.float64)


def row_partition(n_p2: int, n_p1: int, n: int, tile: int):
    """Contiguous row ranges of ``n`` shards: (vel, pres), each (n + 1,)
    int64 bounds, shard k owning velocity nodes [vel[k], vel[k+1]) and
    pressure nodes [pres[k], pres[k+1]).

    The velocity bounds fall on multiples of ``tile`` (the block-Jacobi
    tile, S * bu nodes), so every tile lies in one shard and is built
    from that shard's F rows alone.  The ceil(n_p2 / tile) tiles are dealt
    out as evenly as they go, the first shards taking one more, and no
    shard takes a single tile: on the card a batch of one tile takes
    another cuBLAS / cuSOLVER path than a batch of several, whose last
    bits differ (measured on an H100), so with fewer than 2 n tiles the
    last shards get none.  The Hilbert node order makes each range a
    spatial patch.  The pressure bounds follow the velocity bounds in
    proportion, so a shard's pressure rows cover the same patch."""
    if n < 1:
        raise ValueError(f"row_partition: {n} shards")
    n_tiles = -(-n_p2 // tile)
    used = max(1, min(n, n_tiles // 2))
    per = np.zeros(n, np.int64)
    per[:used] = n_tiles // used
    per[:n_tiles % used] += 1
    vel = np.minimum(np.concatenate([[0], np.cumsum(per)]) * tile, n_p2)
    pres = (vel * n_p1) // max(n_p2, 1)
    return vel.astype(np.int64), pres.astype(np.int64)
