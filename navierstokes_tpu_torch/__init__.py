"""navierstokes_tpu_torch — the PyTorch/CUDA port of navierstokes_tpu.

A second package beside the JAX reference ``navierstokes_tpu``: the same
Taylor-Hood P2/P1 solver, written as plain PyTorch tensor code with the
hot sparse matrix-vector product as a hand-written CUDA kernel for Hopper
in fp32, bf16-values and fp64 variants (``csrc/sell_spmv.cu``, bound
through ``kernels/``).  It keeps its own copies of the host modules it
needs (``config``, ``mesh``, ``fem``, ``utils``) and imports neither jax
nor the JAX package.

The port covers P2/P1 on triangles (2D) and tetrahedra (3D) on the BSR
operator in both time schemes (monolithic FGMRES with its five block
preconditioners, and projection), with the block-Jacobi or the diagonal F
preconditioner, row sharding of that operator over several devices in
one process (``parallel/``), any Taylor-Hood pair on the generic element
operator, and the scenario registry with its CLI (``python -m
navierstokes_tpu_torch list|run``).  It takes every option value of the
JAX package's ``SolverConfig``; ``models/navier_stokes.py``
``check_config`` raises ``ValueError`` on any other.
"""

import torch

from navierstokes_tpu_torch.config import InletConfig, SolverConfig  # noqa: F401

# fp32 products in full fp32: the Newton-Schulz tile inverse
# (ops/p1ell.block_jacobi_invert) and the coarse solve lose accuracy in TF32
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def __getattr__(name):
    if name == "NavierStokes":
        from navierstokes_tpu_torch.models.navier_stokes import NavierStokes
        return NavierStokes
    raise AttributeError(name)
