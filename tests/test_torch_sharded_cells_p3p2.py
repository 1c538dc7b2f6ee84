"""P3/P2 on cell shards: the cases of tests/test_torch_sharded_cells_model.py
on the h=0.15 channel (4,916 DoF), in a file of their own so that each
file stays near a minute."""

import torch

from navierstokes_tpu.mesh import channel_with_cylinder_2d
from navierstokes_tpu_torch.models.navier_stokes import NavierStokes as TNS
from test_torch_cells import make, rel
from test_torch_sharded_cells_model import run_against_jax_and_one_device

torch.set_num_threads(2)


def test_p3p2_2_shards_match_jax_and_one_device(tmp_path):
    run_against_jax_and_one_device(tmp_path, 3, 2, 2, (0.15, 0.06))


def test_sharded_cells_inner_bf16_fp32(tmp_path):
    """fp32 with ``inner_bf16`` on 2 shards (each shard's F rounded to
    bf16): within 1e-3 of u of the one-device float64 run over 2 steps,
    every solve converged."""
    mesh = channel_with_cylinder_2d(h=0.15, h_near=0.06)
    ref = make(TNS, mesh, str(tmp_path / "r"), 3, 2, device="cpu")
    ns = make(TNS, mesh, str(tmp_path / "b"), 3, 2, device="cpu",
              dtype="float32", inner_bf16=True, n_devices=2)
    for _ in range(2):
        mr, mb = ref.solve_time_step(), ns.solve_time_step()
        assert mr.converged and mb.converged
        assert rel(ns._u.numpy(), ref._u.numpy()) < 1e-3


