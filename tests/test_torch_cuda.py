"""Tests of the port that need an NVIDIA GPU, plus its host shims: the
fp32, bf16-values and fp64 SpMV kernels against their plain versions, the
wrapper's refusals, and model steps (projection; monolithic with bf16 and
refinement) that launch the kernels.

This file imports no jax, so that it also runs where only the port's
dependencies are installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest`` because tests/conftest.py configures jax).  The CUDA
cases carry the ``cuda`` marker and skip where there is no card.
Fixture: the h=0.12 cylinder channel of tests/test_pallas_matvec.py.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from navierstokes_tpu_torch.kernels import bsr_spmv as K
from navierstokes_tpu_torch.ops import assembly as TA
from navierstokes_tpu_torch.ops import bsr as TB
from navierstokes_tpu_torch.ops import p1ell as TP
from navierstokes_tpu.config import InletConfig, SolverConfig
from navierstokes_tpu.fem.spaces import TaylorHoodSpace
from navierstokes_tpu.mesh import channel_with_cylinder_2d

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
BENCH_KW = dict(row_multiple=128, f_kmax=-1, gb_kmax=-1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def space():
    return TaylorHoodSpace(channel_with_cylinder_2d(h=0.12))


def _uses(space, dev):
    """(name, args) of the five blocked-ELL SpMV uses of the step."""
    cells = TA.cell_arrays_numpy(space)
    b = TB.build_bsr(space, cells, torch.float32, dev, **BENCH_KW)
    ap = TP.assemble_p1_stiffness(space, cells, torch.float32, dev)
    rng = np.random.default_rng(4)
    x = lambda n, d: torch.as_tensor(rng.standard_normal((n, d)),
                                     dtype=torch.float32, device=dev)
    nu = b.n_vb * b.bu
    n_ext, dim, bu, cw = b.g_blk.shape
    f = b.m_blk * 3.0 + torch.as_tensor(
        rng.standard_normal(b.m_blk.shape), dtype=torch.float32, device=dev)
    return [
        ("F", (f, b.f_cols, x(nu, 2), b.bu, b.f_spill, b.n_vb)),
        ("mass", (b.m_blk, b.f_cols, x(nu, 2), b.bu, b.f_spill, b.n_vb)),
        ("laplacian", (ap.vals, ap.cols, x(ap.cols.shape[0] * ap.b, 1),
                       ap.b)),
        ("B", (b.b_blk, b.b_cols, x(nu * dim, 1), b.bu * dim, b.b_spill,
               b.n_pb)),
        ("GT", (b.g_blk.view(n_ext, dim * bu, cw), b.g_cols,
                x(b.n_pb * b.bp, 1), b.bp, b.g_spill, b.n_vb)),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("use", ["F", "mass", "laplacian", "B", "GT"])
def test_kernel_matches_plain_on_cuda(cuda, space, use):
    """fp32 kernel against the plain version on the card: only the
    summation order differs, so 1e-5 of the result's max; repeated
    launches are bit-identical (fixed-order reduction, no atomics)."""
    args = dict(_uses(space, cuda))[use]
    K.COUNTS.reset()
    y_k = K.bsr_spmv(*args)
    y_k2 = K.bsr_spmv(*args)
    y_p = K.bsr_spmv_plain(*args)
    torch.cuda.synchronize()
    assert K.COUNTS.launches == 2
    err = ((y_k - y_p).abs().max() / y_p.abs().max()).item()
    assert err <= 1e-5
    assert torch.equal(y_k, y_k2)


@pytest.mark.cuda
@pytest.mark.parametrize("use", ["F", "mass", "laplacian", "B", "GT"])
@pytest.mark.parametrize("variant", ["bf16", "f64"])
def test_variants_match_plain_on_cuda(cuda, space, use, variant):
    """The bf16-values and fp64 kernels against the plain version on the
    card.  bf16: both round x and each product to bf16 identically, so
    only the fp32 summation order differs (1e-5 of the result's max).
    fp64: only the float64 summation order differs (1e-12)."""
    vals, cols, x, cb, *fold = dict(_uses(space, cuda))[use]
    if variant == "bf16":
        vals, tol, field = vals.to(torch.bfloat16), 1e-5, "launches_bf16"
    else:
        vals, x, tol, field = vals.double(), x.double(), 1e-12, "launches_f64"
    K.COUNTS.reset()
    y_k = K.bsr_spmv(vals, cols, x, cb, *fold)
    y_k2 = K.bsr_spmv(vals, cols, x, cb, *fold)
    y_p = K.bsr_spmv_plain(vals, cols, x, cb, *fold)
    torch.cuda.synchronize()
    assert getattr(K.COUNTS, field) == 2 and K.COUNTS.launches == 0
    assert y_k.dtype == y_p.dtype == x.dtype
    err = ((y_k - y_p).abs().max() / y_p.abs().max()).item()
    assert err <= tol
    assert torch.equal(y_k, y_k2)


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda, space):
    vals, cols, x, cb, spill, n_phys = dict(_uses(space, cuda))["F"]
    with pytest.raises(TypeError, match="no other variant"):
        K.bsr_spmv(vals.to(torch.float16), cols, x, cb, spill, n_phys)
    with pytest.raises(TypeError, match="x must be torch.float32"):
        K.bsr_spmv(vals.to(torch.bfloat16), cols, x.double(), cb, spill,
                   n_phys)
    with pytest.raises(TypeError):
        K.bsr_spmv(vals, cols.long(), x, cb, spill, n_phys)
    with pytest.raises(ValueError, match="contiguous"):
        K.bsr_spmv(vals, cols, x.t().contiguous().t(), cb, spill, n_phys)
    with pytest.raises(ValueError, match="vals on"):
        K.bsr_spmv(vals, cols, x.cpu(), cb, spill, n_phys)


@pytest.mark.cuda
def test_model_steps_on_cuda_launch_the_kernel(cuda, tmp_path):
    from navierstokes_tpu_torch.models.navier_stokes import NavierStokes
    cfg = SolverConfig(dtype="float32", scheme="projection",
                       output_dir=str(tmp_path / "out"),
                       cache_dir=str(tmp_path / "cache"),
                       csv_path=str(tmp_path / "forces.csv"))
    ns = NavierStokes(channel_with_cylinder_2d(h=0.12), 2, 1, deltat=0.01,
                      T=0.02, step=2, device="cuda", config=cfg,
                      inlet=InletConfig(kind="parabolic", u_m=0.3,
                                        height=0.41))
    ns.set_re_number(20)
    ns.setup()
    K.COUNTS.reset()
    ns.solve()
    assert K.COUNTS.launches > 0
    assert K.COUNTS.plain_cuda_calls == 0
    assert ns._u.is_cuda and bool(torch.isfinite(ns._u).all())
    assert np.isfinite([ns.cd, ns.cl]).all()


@pytest.mark.cuda
def test_monolithic_steps_on_cuda_launch_the_variants(cuda, tmp_path):
    """fp32 monolithic steps with bf16 inner F values and refinement run
    through all three kernel variants and no plain version."""
    from navierstokes_tpu_torch.models.navier_stokes import NavierStokes
    cfg = SolverConfig(dtype="float32", scheme="monolithic", inner_bf16=True,
                       refine=1, output_dir=str(tmp_path / "out"),
                       cache_dir=str(tmp_path / "cache"),
                       csv_path=str(tmp_path / "forces.csv"))
    ns = NavierStokes(channel_with_cylinder_2d(h=0.12), 2, 1, deltat=0.01,
                      T=0.02, step=2, device="cuda", config=cfg,
                      inlet=InletConfig(kind="parabolic", u_m=0.3,
                                        height=0.41))
    ns.set_re_number(20)
    ns.setup()
    K.COUNTS.reset()
    ns.solve()
    assert K.COUNTS.launches > 0
    assert K.COUNTS.launches_bf16 > 0 and K.COUNTS.launches_f64 > 0
    assert K.COUNTS.plain_cuda_calls == 0
    assert ns._u.is_cuda and bool(torch.isfinite(ns._u).all())
    assert np.isfinite([ns.cd, ns.cl]).all()


def test_mesh_without_matplotlib_is_identical(tmp_path):
    """Where matplotlib is absent, the port's stand-in for
    ``matplotlib.path.Path`` lets the mesh generators run, and they make
    the same mesh."""
    code = (
        "import importlib.util, sys\n"
        "import numpy as np\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] == 'matplotlib':\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "find = importlib.util.find_spec\n"
        "importlib.util.find_spec = lambda n, *a: (\n"
        "    None if n.split('.')[0] == 'matplotlib' else find(n, *a))\n"
        "import navierstokes_tpu_torch\n"
        "from navierstokes_tpu.mesh import channel_with_cylinder_2d\n"
        "m = channel_with_cylinder_2d(h=0.1, h_near=0.04)\n"
        "assert sys.modules['matplotlib.path'].Path.__module__ == "
        "'navierstokes_tpu_torch._host_compat'\n"
        f"np.savez({str(tmp_path / 'm.npz')!r}, p=m.points, c=m.cells)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    ref = channel_with_cylinder_2d(h=0.1, h_near=0.04)
    with np.load(tmp_path / "m.npz") as z:
        np.testing.assert_array_equal(z["p"], ref.points)
        np.testing.assert_array_equal(z["c"], ref.cells)
