"""Tests of the port that need an NVIDIA GPU, plus its host shims: the
fp32, bf16-values and fp64 SELL SpMV kernels against their plain versions
in every use of the step, in 2D and (D=3) in 3D, bit-identical repeats,
the wrapper's refusals, model steps (projection; monolithic with bf16 and
refinement; 3D; the NACA scenario; the outlet pressure and a forcing
term) that launch the kernels, the outlet-pressure and forcing RHS and
``StokesSolver`` on the card against the CPU, and the port's own mesh
generator where matplotlib is absent.

This file imports no jax and nothing of the JAX package at module level,
so that it also runs where only the port's dependencies are installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest`` because tests/conftest.py configures jax).  The CUDA
cases carry the ``cuda`` marker and skip where there is no card.
Also the cells operator on cell shards of one card against one device,
a change of ``config.scheme`` after setup, captured against eager, the
solver options ``proj_poisson="schur"``, ``proj_p_extrap`` and
``f_solver="richardson"`` captured against eager (a change of them after
capture raises), and
the block-Jacobi tile-apply kernel (fp32, bf16 and fp64 tiles) against
its plain version, batch invariant, at the edges of its ring and
persistent grid, refusing what it does not take, and
launched by captured, eager, float64 and row-sharded steps; the while
nodes of csrc/graph_cond.cu against the host loop (seeded trip counts,
nested, no synchronising replay) and their predicate kernel against its
plain version; the V-cycle's smoothing sweeps (csrc/vcycle.cu) against
their plain versions bit for bit on both operator paths, the fused
V-cycle against the plain one (also captured), and the steps that run
it; the Newton-Schulz GEMM's epilogues (csrc/bj_gemm.cu) against their
plain versions bit for bit, zero signs, NaN and batch independence
included.
Fixtures: the h=0.12 cylinder channel of tests/test_pallas_matvec.py;
in 3D the h=0.15 square-column duct of tests/test_torch_3d.py.
"""

import dataclasses
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from navierstokes_tpu_torch.config import InletConfig, SolverConfig
from navierstokes_tpu_torch.fem.spaces import TaylorHoodSpace
from navierstokes_tpu_torch.kernels import sell_spmv as K
from navierstokes_tpu_torch.kernels import vcycle as VC
from navierstokes_tpu_torch.mesh.generators import channel_with_cylinder_2d
from navierstokes_tpu_torch.ops import assembly as TA
from navierstokes_tpu_torch.ops import bsr as TB
from navierstokes_tpu_torch.ops import p1ell as TP

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
USES = ["F", "mass", "laplacian", "Ap", "B", "GT", "PCD"]
# value dtype -> (x dtype, kernel-vs-plain limit of max|y|, COUNTS field):
# only the summation order differs (bf16: both round x and each product
# to bf16 identically, then sum in fp32)
VARIANTS = {"f32": (torch.float32, torch.float32, 1e-5, "launches"),
            "bf16": (torch.bfloat16, torch.float32, 1e-5, "launches_bf16"),
            "f64": (torch.float64, torch.float64, 1e-12, "launches_f64")}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def space():
    return TaylorHoodSpace(channel_with_cylinder_2d(h=0.12))


def _uses(space, dev):
    """use -> (pattern, fp32 values, fp32 x) of the SpMV uses of the step:
    F (with convection) and the mass (D=2), the P1 Laplacian, Ap, B, Gᵀ
    and the PCD pressure convection (D=1)."""
    cells = TA.cell_arrays_numpy(space)
    b = TB.build_bsr(space, cells, torch.float32, dev)
    lap = TP.assemble_p1_stiffness(space, cells, torch.float32, dev)
    rng = np.random.default_rng(4)
    ap = TP.assemble_ap(space, cells, rng.uniform(0.5, 2.0, space.n_p2),
                        torch.float32, dev)
    x = lambda *shape: torch.as_tensor(rng.standard_normal(shape),
                                       dtype=torch.float32, device=dev)
    u = 0.3 * x(space.n_p2, 2)
    f = 3.0 * b.m_vals + TB.convection_blk(b, u)
    return {
        "F": (b.f, f, x(space.n_p2, 2)),
        "mass": (b.f, b.m_vals, x(space.n_p2, 2)),
        "laplacian": (lap.mat, lap.vals, x(space.n_p1)),
        "Ap": (ap.mat, ap.vals, x(space.n_p1)),
        "B": (b.b, b.b_vals, x(space.n_p2 * 2)),
        "GT": (b.g, b.g_vals, x(space.n_p1)),
        "PCD": (b.pp, TB.pressure_convection_blk(b, u), x(space.n_p1)),
    }


@pytest.fixture(scope="module")
def space3d():
    from navierstokes_tpu_torch.mesh.generators import \
        duct_with_box_obstacle_3d
    return TaylorHoodSpace(duct_with_box_obstacle_3d(h=0.15))


def _uses_3d(space, dev):
    """use -> (pattern, fp32 values, fp32 x) of the 3D step's D=3 products,
    F (with convection) and the mass, and of B, whose x is the flat 3D
    velocity."""
    b = TB.build_bsr(space, TA.cell_arrays_numpy(space), torch.float32, dev)
    rng = np.random.default_rng(5)
    x = lambda *shape: torch.as_tensor(rng.standard_normal(shape),
                                       dtype=torch.float32, device=dev)
    f = 3.0 * b.m_vals + TB.convection_blk(b, 0.3 * x(space.n_p2, 3))
    return {"F": (b.f, f, x(space.n_p2, 3)),
            "mass": (b.f, b.m_vals, x(space.n_p2, 3)),
            "B": (b.b, b.b_vals, x(space.n_p2 * 3))}


def _variant(space, dev, use, variant):
    vdt, xdt, tol, field = VARIANTS[variant]
    mat, vals, x = _uses(space, dev)[use]
    return mat, vals.to(vdt), x.to(xdt), tol, field


@pytest.mark.cuda
@pytest.mark.parametrize("use", USES)
def test_kernel_matches_plain_on_cuda(cuda, space, use):
    """fp32 kernel against the plain version on the card: only the
    summation order differs, so 1e-5 of the result's max."""
    mat, vals, x, tol, _ = _variant(space, cuda, use, "f32")
    K.COUNTS.reset()
    y_k = K.sell_spmv(mat, vals, x)
    y_p = K.sell_spmv_plain(mat, vals, x)
    torch.cuda.synchronize()
    assert K.COUNTS.launches == 1 and K.COUNTS.plain_cuda_calls == 1
    assert y_k.shape == y_p.shape and y_k.dtype == y_p.dtype
    err = ((y_k - y_p).abs().max() / y_p.abs().max()).item()
    assert err <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("use", USES)
@pytest.mark.parametrize("variant", ["bf16", "f64"])
def test_variants_match_plain_on_cuda(cuda, space, use, variant):
    """The bf16-values and fp64 kernels against the plain version on the
    card (fp32 sums of bf16-rounded products: 1e-5; fp64: 1e-12)."""
    mat, vals, x, tol, field = _variant(space, cuda, use, variant)
    K.COUNTS.reset()
    y_k = K.sell_spmv(mat, vals, x)
    y_p = K.sell_spmv_plain(mat, vals, x)
    torch.cuda.synchronize()
    assert getattr(K.COUNTS, field) == 1 and K.COUNTS.launches == 0
    assert y_k.dtype == y_p.dtype == x.dtype
    err = ((y_k - y_p).abs().max() / y_p.abs().max()).item()
    assert err <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("use", USES)
@pytest.mark.parametrize("variant", ["f32", "bf16", "f64"])
def test_repeat_is_bit_identical_on_cuda(cuda, space, use, variant):
    """One thread per row sums its slots in a fixed order (no atomics, no
    shuffles), so repeated launches give the same bits."""
    mat, vals, x, _, field = _variant(space, cuda, use, variant)
    K.COUNTS.reset()
    ys = [K.sell_spmv(mat, vals, x) for _ in range(3)]
    torch.cuda.synchronize()
    assert getattr(K.COUNTS, field) == 3
    assert K.COUNTS.by_pattern == {(mat.name, vals.dtype): 3}
    assert torch.equal(ys[0], ys[1]) and torch.equal(ys[0], ys[2])


@pytest.mark.cuda
@pytest.mark.parametrize("use", ["F", "mass", "B"])
@pytest.mark.parametrize("variant", ["f32", "bf16", "f64"])
def test_3d_products_match_plain_on_cuda(cuda, space3d, use, variant):
    """The 3D products against the plain version on the card, with the
    2D limits (only the summation order differs); F and the mass launch the
    D=3 instantiation, B the D=1 one, and repeats are bit-identical."""
    vdt, xdt, tol, field = VARIANTS[variant]
    mat, vals, x = _uses_3d(space3d, cuda)[use]
    vals, x = vals.to(vdt), x.to(xdt)
    K.COUNTS.reset()
    ys = [K.sell_spmv(mat, vals, x) for _ in range(2)]
    y_p = K.sell_spmv_plain(mat, vals, x)
    torch.cuda.synchronize()
    D = 1 if x.dim() == 1 else x.shape[1]
    assert K.COUNTS.by_variant == {(vdt, D): 2}
    assert getattr(K.COUNTS, field) == 2
    assert ys[0].shape == y_p.shape and ys[0].dtype == y_p.dtype == xdt
    assert torch.equal(ys[0], ys[1])
    err = ((ys[0] - y_p).abs().max() / y_p.abs().max()).item()
    assert err <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["f32", "f64"])
def test_3d_x_needs_only_its_element_alignment(cuda, space3d, variant):
    """A D=3 row of x is read as three scalars, so x starting one element
    past a 16-byte boundary (any row start) is taken."""
    vdt, xdt, _, _ = VARIANTS[variant]
    mat, vals, x = _uses_3d(space3d, cuda)["F"]
    vals, x = vals.to(vdt), x.to(xdt)
    buf = torch.empty(x.numel() + 1, dtype=xdt, device=cuda)
    x_off = buf[1:].view(x.shape)
    x_off.copy_(x)
    assert x_off.data_ptr() % 16 != 0
    y_k = K.sell_spmv(mat, vals, x_off)
    torch.cuda.synchronize()
    assert torch.equal(y_k, K.sell_spmv(mat, vals, x))


@pytest.mark.cuda
@pytest.mark.parametrize("scheme,options", [
    ("projection", dict(f_precond="diag")),
    ("projection", dict(f_precond="bj", inner_bf16=True)),
    ("monolithic", dict(inner_bf16=True, refine=1, mass_format="blocked"))])
def test_3d_steps_on_cuda_launch_d3(cuda, tmp_path, space3d, scheme,
                                    options):
    """fp32 3D steps launch the D=3 instantiation of each variant the
    configuration reads (fp32 always, bf16 under inner_bf16, fp64 under
    refinement, which 3D runs with the blocked mass, as the JAX model
    does) and no plain version."""
    from navierstokes_tpu_torch.mesh.generators import \
        duct_with_box_obstacle_3d
    from navierstokes_tpu_torch.models.navier_stokes import NavierStokes
    cfg = SolverConfig(dtype="float32", scheme=scheme,
                       output_dir=str(tmp_path / "out"),
                       cache_dir=str(tmp_path / "cache"),
                       csv_path=str(tmp_path / "forces.csv"), **options)
    ns = NavierStokes(duct_with_box_obstacle_3d(h=0.15), 2, 1, deltat=0.01,
                      T=0.02, step=2, device="cuda", config=cfg,
                      inlet=InletConfig(kind="biparabolic", u_m=0.45,
                                        height=0.41))
    ns.set_re_number(20)
    ns.setup()
    K.COUNTS.reset()
    ns.solve()
    want = {torch.float32} | ({torch.bfloat16} if cfg.inner_bf16 else set()) \
        | ({torch.float64} if cfg.refine else set())
    for dt in want:
        assert K.COUNTS.by_variant.get((dt, 3), 0) > 0, dt
    assert K.COUNTS.plain_cuda_calls == 0
    assert ns._u.shape == (ns.space.n_p2, 3)
    assert bool(torch.isfinite(ns._u).all()) and np.isfinite([ns.cd,
                                                              ns.cl]).all()


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda, space):
    mat, vals, x = _uses(space, cuda)["F"]
    with pytest.raises(TypeError, match="no other variant"):
        K.sell_spmv(mat, vals.to(torch.float16), x)
    with pytest.raises(TypeError, match="x must be torch.float32"):
        K.sell_spmv(mat, vals.to(torch.bfloat16), x.double())
    with pytest.raises(TypeError, match="cols must be torch.int32"):
        K.sell_spmv(dataclasses.replace(mat, cols=mat.cols.long()), vals, x)
    with pytest.raises(ValueError, match="contiguous"):
        K.sell_spmv(mat, vals, x.t().contiguous().t())
    with pytest.raises(ValueError, match="vals on"):
        K.sell_spmv(mat, vals, x.cpu())
    with pytest.raises(ValueError, match="16-byte aligned"):
        K.sell_spmv(mat, vals[1:1 + mat.n_slots - 1], x)
    with pytest.raises(ValueError, match="inconsistent shapes"):
        K.sell_spmv(mat, vals, x[:-1])


@pytest.mark.cuda
@pytest.mark.parametrize("use", ["laplacian", "GT", "F"])
def test_x_needs_only_its_element_alignment(cuda, space, use):
    """x is gathered one element (D=1) or one node pair (D=2) at a time, so
    a view that starts one such unit past a 16-byte boundary (the pressure
    part of a monolithic Krylov vector when n_p2 is odd) is taken."""
    mat, vals, x = _uses(space, cuda)[use]
    unit = x.shape[1] if x.dim() == 2 else 1
    buf = torch.empty(x.numel() + unit, dtype=x.dtype, device=cuda)
    x_off = buf[unit:].view(x.shape)
    x_off.copy_(x)
    assert x_off.data_ptr() % 16 != 0
    y_k = K.sell_spmv(mat, vals, x_off)
    torch.cuda.synchronize()
    assert torch.equal(y_k, K.sell_spmv_plain(mat, vals, x))


@pytest.mark.cuda
@pytest.mark.parametrize("preconditioner", ["cc", "pcd"])
def test_monolithic_steps_with_odd_velocity_node_count(cuda, tmp_path,
                                                       preconditioner):
    """With an odd n_p2 the pressure part of every FGMRES vector starts 8
    bytes past a 16-byte boundary; G p, B u and the PCD product take it."""
    from navierstokes_tpu_torch.models.navier_stokes import NavierStokes
    cfg = SolverConfig(dtype="float32", scheme="monolithic",
                       preconditioner=preconditioner,
                       output_dir=str(tmp_path / "out"),
                       cache_dir=str(tmp_path / "cache"),
                       csv_path=str(tmp_path / "forces.csv"))
    # 25 points on the cylinder: an odd boundary count, so odd n_p2
    ns = NavierStokes(channel_with_cylinder_2d(h=0.15, h_near=0.0126), 2, 1,
                      deltat=0.01, T=0.02, step=2, device="cuda", config=cfg,
                      inlet=InletConfig(kind="parabolic", u_m=0.3,
                                        height=0.41))
    ns.set_re_number(20)
    ns.setup()
    assert ns.space.n_p2 % 2 == 1
    K.COUNTS.reset()
    ns.solve()
    assert K.COUNTS.launches > 0 and K.COUNTS.plain_cuda_calls == 0
    assert bool(torch.isfinite(ns._u).all()) and np.isfinite([ns.cd,
                                                              ns.cl]).all()


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
    """The port's own mesh generators run where matplotlib is absent (its
    ray-casting point-in-polygon stands in for ``matplotlib.path.Path``)
    and make the JAX package's meshes for the test fixtures."""
    pytest.importorskip("matplotlib")
    fixtures = {"h012": dict(h=0.12), "h01": dict(h=0.1, h_near=0.04)}
    code = (
        "import importlib.util, sys\n"
        "import numpy as np\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] == 'matplotlib':\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "from navierstokes_tpu_torch.mesh.generators import "
        "channel_with_cylinder_2d\n"
        f"for tag, kw in {fixtures!r}.items():\n"
        "    m = channel_with_cylinder_2d(**kw)\n"
        f"    np.savez({str(tmp_path)!r} + '/' + tag + '.npz', p=m.points, "
        "c=m.cells, f=m.boundary_faces, t=m.boundary_tags)\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in "
        "('matplotlib', 'navierstokes_tpu')]\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    from navierstokes_tpu.mesh import channel_with_cylinder_2d as jax_mesh
    for tag, kw in fixtures.items():
        ref = jax_mesh(**kw)
        with np.load(tmp_path / f"{tag}.npz") as z:
            np.testing.assert_array_equal(z["p"], ref.points)
            np.testing.assert_array_equal(z["c"], ref.cells)
            np.testing.assert_array_equal(z["f"], ref.boundary_faces)
            np.testing.assert_array_equal(z["t"], ref.boundary_tags)


def _channel_model(device, tmp_path, **cfg_fields):
    from navierstokes_tpu_torch.models.navier_stokes import NavierStokes
    forcing = cfg_fields.pop("forcing", None)
    cfg = SolverConfig(dtype="float32", output_dir=str(tmp_path / "out"),
                       cache_dir=str(tmp_path / "cache"),
                       csv_path=str(tmp_path / "forces.csv"), **cfg_fields)
    ns = NavierStokes(channel_with_cylinder_2d(h=0.12), 2, 1, deltat=0.01,
                      T=0.02, step=2, device=device, config=cfg,
                      inlet=InletConfig(kind="parabolic", u_m=0.3,
                                        height=0.41), forcing=forcing)
    ns.set_re_number(20)
    return ns.setup()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("fields", [
    dict(scheme="projection"), dict(scheme="monolithic"),
    dict(scheme="monolithic", preconditioner="asimple"),
    dict(scheme="monolithic", refine=2, inner_bf16=True)])
def test_row_shards_on_one_card_equal_one_device(cuda, tmp_path, fields, n):
    """``n_devices`` row shards, all on cuda:0, step bit for bit like the
    unsharded model on the card (fp32, the curved cylinder), and launch
    the kernels per shard."""
    from navierstokes_tpu_torch.kernels import bj_apply as BJ
    from navierstokes_tpu_torch.models.navier_stokes import NavierStokes
    runs = []
    for k, devs in ((1, None), (n, ["cuda:0"] * n)):
        cfg = SolverConfig(dtype="float32", n_devices=k,
                           output_dir=str(tmp_path / f"out{k}"),
                           cache_dir=str(tmp_path / f"cache{k}"),
                           csv_path=str(tmp_path / f"forces{k}.csv"),
                           **fields)
        ns = NavierStokes(channel_with_cylinder_2d(h=0.12), 2, 1,
                          deltat=0.01, T=0.03, step=3, device="cuda",
                          config=cfg, shard_devices=devs,
                          inlet=InletConfig(kind="parabolic", u_m=0.3,
                                            height=0.41))
        ns.set_re_number(20)
        ns.setup()
        K.COUNTS.reset()
        BJ.COUNTS.reset()
        ms = [ns.solve_time_step() for _ in range(3)]
        assert K.COUNTS.launches > 0 and K.COUNTS.plain_cuda_calls == 0
        # every shard's tiles through the tile-apply kernel
        assert BJ.COUNTS.launches > 0 and BJ.COUNTS.plain_cuda_calls == 0
        runs.append((ns, [(m.iterations, m.cd, m.cl) for m in ms]))
    (one, m1), (sh, mn) = runs
    # the h=0.12 channel has 4 tiles: no shard takes a single one
    assert len(sh.ell.shards) == 2 and mn == m1
    assert torch.equal(sh._u, one._u) and torch.equal(sh._p, one._p)


def _torch_forcing(x, t):
    return torch.stack([torch.ones_like(x[:, 0]), 0.5 * x[:, 0]], dim=1)


@pytest.mark.cuda
def test_naca_steps_on_cuda_launch_the_kernel(cuda, tmp_path):
    """Two monolithic cc steps of the 2d-naca scenario (h=0.1, 8 degrees)
    on the card run through the fp32 kernel and no plain version."""
    from navierstokes_tpu_torch.scenarios.registry import build_solver
    cfg = SolverConfig(dtype="float32", output_dir=str(tmp_path / "out"),
                       cache_dir=str(tmp_path / "cache"),
                       csv_path=str(tmp_path / "forces.csv"))
    ns = build_solver("2d-naca", h=0.1, config=cfg,
                      mesh_kwargs=dict(angle_deg=8.0), device="cuda",
                      t_final=0.02, output_step=2).setup()
    K.COUNTS.reset()
    ns.solve()
    assert K.COUNTS.launches > 0 and K.COUNTS.plain_cuda_calls == 0
    assert bool(torch.isfinite(ns._u).all()) and np.isfinite([ns.cd,
                                                              ns.cl]).all()


@pytest.mark.cuda
def test_neumann_and_forcing_rhs_on_cuda_equal_cpu(cuda):
    """The outlet-pressure RHS and the forcing integral, float64, on the
    card equal the CPU's (fixed-order segment sums on both)."""
    from navierstokes_tpu_torch.ops.forces import neumann_rhs
    from navierstokes_tpu_torch.ops.operators import segment_plan
    sp = TaylorHoodSpace(channel_with_cylinder_2d(h=0.12))
    out = {}
    for dev in ("cpu", "cuda"):
        faces = TA.build_face_arrays(sp, 1, torch.float64, dev)
        plan = segment_plan(faces.vel_nodes.cpu().numpy(), sp.n_p2, dev)
        data = TA.build_forcing_data(sp, torch.float64, dev)
        t = torch.tensor(0.3, dtype=torch.float64, device=dev)
        out[dev] = (neumann_rhs(faces, 0.7, plan),
                    TA.forcing_integral(data, _torch_forcing, t))
    for a, b in zip(out["cuda"], out["cpu"]):
        assert a.is_cuda
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0,
                                   atol=1e-12 * float(b.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["projection", "monolithic"])
@pytest.mark.parametrize("term", ["p_out", "forcing"])
def test_rhs_term_steps_on_cuda_launch_the_kernel(cuda, tmp_path, scheme,
                                                  term):
    fields = (dict(p_out=0.7) if term == "p_out"
              else dict(forcing=_torch_forcing))
    ns = _channel_model("cuda", tmp_path, scheme=scheme, **fields)
    K.COUNTS.reset()
    ns.solve()
    assert K.COUNTS.launches > 0 and K.COUNTS.plain_cuda_calls == 0
    assert bool(torch.isfinite(ns._u).all()) and np.isfinite([ns.cd,
                                                              ns.cl]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("kv,kp", [(2, 1), (3, 2)])
def test_stokes_solver_on_cuda_equals_cpu(cuda, kv, kp):
    """StokesSolver in float64 on the card: the cells operator's solution
    equals the CPU's to 1e-9.  The card's batched products sum in another
    order, so at a tolerance of 1e-12 the FGMRES count may differ by one."""
    from navierstokes_tpu_torch.mesh.generators import rectangle_2d
    from navierstokes_tpu_torch.models.stokes import StokesSolver
    res = {}
    for dev in ("cpu", "cuda"):
        solver = StokesSolver(rectangle_2d(1.0, 1.0, 4, 4), nu=1.0,
                              config=SolverConfig(dtype="float64"),
                              degree_velocity=kv, degree_pressure=kp,
                              device=dev)
        sp = solver.space
        nodes = np.unique(np.concatenate([sp.p2_nodes_on_tag(t)
                                          for t in (0, 1, 2, 3)]))
        x = sp.p2_coords[nodes]
        res[dev] = solver.solve(nodes, np.stack([x[:, 1], -x[:, 0]], 1),
                                rhs_u=np.ones((sp.n_p2, 2)), tol=1e-12)
    (uc, pc, rc), (ug, pg, rg) = res["cpu"], res["cuda"]
    assert abs(int(rg.iterations) - int(rc.iterations)) <= 1
    assert bool(rg.converged)
    for a, b in ((ug, uc), (pg, pc)):
        assert np.abs(a - b).max() <= 1e-9 * np.abs(b).max()


def _small_model(tmp, forcing=None, scheme="projection", **fields):
    from navierstokes_tpu_torch.models.navier_stokes import NavierStokes
    cfg = SolverConfig(dtype="float32", scheme=scheme,
                       output_dir=str(tmp / "out"),
                       cache_dir=str(tmp / "cache"),
                       csv_path=str(tmp / "forces.csv"))
    for k, v in fields.items():
        setattr(cfg, k, v)
    ns = NavierStokes(channel_with_cylinder_2d(h=0.12), 2, 1, deltat=0.01,
                      T=0.05, step=5, device="cuda", config=cfg,
                      inlet=InletConfig(kind="parabolic", u_m=0.3,
                                        height=0.41), forcing=forcing)
    ns.set_re_number(20)
    return ns.setup()


def _forcing(x, t):
    return torch.stack([0.2 * torch.sin(3.0 * x[:, 1]) * (1.0 + t),
                        0.1 * torch.cos(2.0 * x[:, 0])], dim=1)


@pytest.mark.cuda
@pytest.mark.parametrize("case,fields", [
    ("bj", {}), ("jacobi", dict(f_precond="jacobi")),
    ("bdf1", dict(proj_bdf2=False)), ("exact tiles", dict(bj_newton=0)),
    ("bj_bf16", dict(bj_bf16=True)), ("forcing", dict(forcing=_forcing)),
    ("schur", dict(proj_poisson="schur")),
    ("p_extrap", dict(proj_p_extrap=0.5))])
def test_captured_steps_equal_eager_on_cuda(cuda, tmp_path, case, fields):
    """5 projection steps replayed from the captured CUDA graphs equal 5
    plain (eager) steps bit for bit, with the same counts; no replay
    synchronises (set_sync_debug_mode("error") around each); the captured
    step reads the host only for the tile guard, and its two while loops
    run one body per iteration, none masked or skipped."""
    fields = dict(fields)
    forcing = fields.pop("forcing", None)
    eager = _small_model(tmp_path / "eager", forcing, **fields)
    graphs = _small_model(tmp_path / "graphs", forcing, **fields)
    graphs.capture_graphs().sync_check = True
    me = [eager.solve_time_step(_eager=True) for _ in range(5)]
    K.COUNTS.reset()
    mg = [graphs.solve_time_step() for _ in range(5)]
    assert K.COUNTS.launches > 0 and K.COUNTS.plain_cuda_calls == 0
    assert torch.equal(eager._u, graphs._u)
    assert torch.equal(eager._p, graphs._p)
    assert torch.equal(eager._phi, graphs._phi)
    guard = int(graphs._bj_plan is not None and graphs.config.bj_newton > 0)
    for a, b in zip(me, mg):
        assert (a.cd, a.cl, a.f_iterations, a.p_iterations, a.converged) \
            == (b.cd, b.cl, b.f_iterations, b.p_iterations, b.converged)
        assert b.flag_reads == guard
        assert (b.loops_entered, b.bodies_run) == (
            2, b.f_iterations + b.p_iterations)
        assert b.masked_iterations == b.skipped_bodies == 0


@pytest.mark.cuda
@pytest.mark.parametrize("case,fields", [
    ("cc", {}), ("cc+refine=2", dict(refine=2, refine_tol=1e-3)),
    ("asimple restart=8", dict(preconditioner="asimple", outer_restart=8)),
    ("ayosida", dict(preconditioner="ayosida")),
    ("pcd", dict(preconditioner="pcd")),
    ("identity", dict(preconditioner="identity", outer_maxiter=60)),
    ("cc+inner_bf16", dict(inner_bf16=True)),
    ("cc diag", dict(f_precond="diag")),
    ("cc richardson", dict(f_solver="richardson")),
    ("asimple jacobi richardson", dict(preconditioner="asimple",
                                       f_precond="jacobi",
                                       f_solver="richardson"))])
def test_captured_monolithic_steps_equal_eager_on_cuda(cuda, tmp_path, case,
                                                       fields):
    """5 monolithic steps replayed from the captured CUDA graphs (each
    FGMRES cycle a while node, the inner BiCGStab a while node nested in
    its body) equal 5 plain steps bit for bit, with the same counts and the
    same SELL and Givens launches; no replay synchronises; the captured
    step reads the host less often, and runs no body masked and skips
    none."""
    from navierstokes_tpu_torch.kernels import arnoldi_lsq as AL
    eager = _small_model(tmp_path / "eager", scheme="monolithic",
                              **fields)
    graphs = _small_model(tmp_path / "graphs", scheme="monolithic",
                               **fields)
    graphs.capture_graphs().sync_check = True
    counts = {}
    for name, ns, kw in (("eager", eager, dict(_eager=True)),
                         ("graphs", graphs, {})):
        K.COUNTS.reset()
        AL.COUNTS.reset()
        ms = [ns.solve_time_step(**kw) for _ in range(5)]
        counts[name] = (ms, dict(K.COUNTS.by_variant), AL.COUNTS.update,
                        K.COUNTS.plain_cuda_calls)
    (me, se, ge, pe), (mg, sg, gg, pg) = counts["eager"], counts["graphs"]
    assert pe == pg == 0 and gg > 0
    assert (se, ge) == (sg, gg)
    assert torch.equal(eager._u, graphs._u)
    assert torch.equal(eager._p, graphs._p)
    for a, b in zip(me, mg):
        assert (a.cd, a.cl, a.iterations, a.residual, a.converged) \
            == (b.cd, b.cl, b.iterations, b.residual, b.converged)
        assert b.flag_reads < a.flag_reads
        assert b.masked_iterations == b.skipped_bodies == 0
        assert b.bodies_run >= b.iterations > 0


@pytest.mark.cuda
@pytest.mark.parametrize("scheme,field,value", [
    ("projection", "proj_poisson", "schur"),
    ("projection", "proj_schur_pin_ratio", 0.5),
    ("projection", "proj_p_extrap", 0.5),
    ("monolithic", "f_solver", "richardson")])
def test_option_change_after_capture_raises_on_cuda(cuda, tmp_path, scheme,
                                                    field, value):
    """Each option the captured graphs or setup read joins _SETUP_FIELDS:
    changed after a captured step, the next step raises naming it."""
    ns = _small_model(tmp_path, scheme=scheme)
    ns.capture_graphs()
    ns.solve_time_step()
    setattr(ns.config, field, value)
    with pytest.raises(ValueError, match=f"SolverConfig.{field} changed"):
        ns.solve_time_step()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_givens_kernel_matches_plain_on_cuda(cuda, dtype):
    """The Givens update on the card, its bound j_max read from the
    device, equals its plain version bit for bit over a 40-column cycle
    (restart 64; the column the sum of two passes' coefficients)."""
    from navierstokes_tpu_torch.kernels import arnoldi_lsq as AL
    m, out = 64, {}
    for dev in ("cpu", "cuda"):
        kw = dict(dtype=dtype, device=dev)
        H = torch.zeros((m + 1, m), **kw)
        cs, sn = torch.zeros(m, **kw), torch.zeros(m, **kw)
        g = torch.zeros(m + 1, **kw)
        g[0] = 3.0
        j = torch.zeros((), dtype=torch.int32, device=dev)
        res = torch.full((), 3.0, **kw)
        act = torch.ones((), dtype=torch.bool, device=dev)
        target = torch.full((), 1e-12, **kw)
        j_max = torch.tensor(m, dtype=torch.int32, device=dev)
        rng = np.random.default_rng(7)
        for _ in range(40):
            col, col2 = rng.standard_normal(m + 1), rng.standard_normal(m + 1)
            h1 = torch.as_tensor(col, **kw)
            h2 = torch.as_tensor(1e-3 * col2, **kw)
            # a dominant new entry keeps |g[j+1]| from decaying to target
            w = torch.as_tensor(10.0 * np.abs(col).max() + 1.0, **kw)
            AL.lsq_update(H, cs, sn, g, h1, h2, w, j, res, act, target,
                          j_max)
        out[dev] = [t.cpu() for t in (H, cs, sn, g, j, res, act)]
    assert int(out["cuda"][4]) == 40
    names = ("H", "cs", "sn", "g", "j", "res", "active")
    differ = [n for n, a, b in zip(names, out["cuda"], out["cpu"])
              if not torch.equal(a, b)]
    assert differ == []


def _capture_whiles(fn):
    """A graph of ``fn(whiles)``, captured with the port's while nodes
    (kernels/conditional.WhileNodes)."""
    from navierstokes_tpu_torch.kernels.conditional import WhileNodes
    whiles = WhileNodes("cuda")
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream), whiles.routed():
        fn(whiles)
    torch.cuda.synchronize()
    return graph, whiles


def _replay_unsynced(graph):
    torch.cuda.set_sync_debug_mode("error")
    try:
        graph.replay()
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.cuda
def test_while_node_equals_host_loop_on_cuda(cuda):
    """A while node whose body (x += r, r -= 1, k += 1) ends in the
    predicate kernel (r > 0.5, k < 1000) runs exactly as the host loop
    that reads the flag before each iteration, for seeded trip counts 0 to
    64, in one captured graph replayed under set_sync_debug_mode("error");
    its tally counts n + 1 evaluations, n bodies and none masked."""
    from navierstokes_tpu_torch.kernels.conditional import set_condition
    f32 = dict(dtype=torch.float32, device=cuda)
    r, x = torch.zeros((), **f32), torch.zeros((), **f32)
    half = torch.tensor(0.5, **f32)
    k = torch.zeros((), dtype=torch.int64, device=cuda)
    active = torch.zeros((), dtype=torch.bool, device=cuda)
    tally = torch.zeros(3, dtype=torch.int64, device=cuda)

    def body(cond):
        x.add_(r)
        r.sub_(1.0)
        k.add_(1)
        return set_condition(active, r, half, k, 1000, cond=cond)

    def start(n):
        r.fill_(float(n))
        x.zero_()
        k.zero_()
        tally.zero_()
        set_condition(active, r, half, k, 1000)

    graph, whiles = _capture_whiles(lambda w: w.loop(active, body, tally))
    trips = [0, 1, 64] + list(np.random.default_rng(14).integers(0, 65, 8))
    for n in map(int, trips):
        start(n)
        _replay_unsynced(graph)
        got = (int(k), float(x), tally.tolist())
        start(n)
        while bool(active):
            body(None)
        assert got == (int(k), float(x), [n + 1, n, 0]), n
        assert int(k) == n and float(x) == n * (n + 1) / 2
    del graph
    whiles.close()


@pytest.mark.cuda
def test_while_body_that_sets_no_condition_raises_on_cuda(cuda):
    """A while body whose last launch does not set its node's condition
    (the predicate launched without the body's ``cond``) is refused when
    it is captured: the node would run on the condition of its first
    test for ever."""
    from navierstokes_tpu_torch.kernels.conditional import set_condition
    f32 = dict(dtype=torch.float32, device=cuda)
    r, half = torch.tensor(3.0, **f32), torch.tensor(0.5, **f32)
    k = torch.zeros((), dtype=torch.int64, device=cuda)
    active = torch.ones((), dtype=torch.bool, device=cuda)
    tally = torch.zeros(3, dtype=torch.int64, device=cuda)

    def body(cond):
        r.sub_(1.0)
        k.add_(1)
        return set_condition(active, r, half, k, 1000)

    with pytest.raises(RuntimeError, match="must set its node's condition"):
        _capture_whiles(lambda w: w.loop(active, body, tally))


@pytest.mark.cuda
def test_nested_while_nodes_on_cuda(cuda):
    """A while node nested in another's body, the inner loop entered
    afresh in each outer iteration with i % 4 trips: outer and inner
    bodies run as the host loops run them, for outer trip counts 0 to 9;
    the inner node's tally counts one evaluation per entry and per body."""
    from navierstokes_tpu_torch.kernels.conditional import set_condition
    f32 = dict(dtype=torch.float32, device=cuda)
    i64 = dict(dtype=torch.int64, device=cuda)
    half = torch.tensor(0.5, **f32)
    ro, ri = torch.zeros((), **f32), torch.zeros((), **f32)
    ko, ki, total = (torch.zeros((), **i64) for _ in range(3))
    ao = torch.zeros((), dtype=torch.bool, device=cuda)
    ai = torch.zeros((), dtype=torch.bool, device=cuda)
    t_out = torch.zeros(3, **i64)
    t_in = torch.zeros(3, **i64)
    state = (ro, ri, ko, ki, total, t_out, t_in)

    def inner(cond):
        total.add_(1)
        ri.sub_(1.0)
        ki.add_(1)
        return set_condition(ai, ri, half, ki, 1000, cond=cond)

    def outer(w):
        def body(cond):
            ri.copy_(torch.remainder(ko, 4).to(torch.float32))
            ki.zero_()
            set_condition(ai, ri, half, ki, 1000)
            if w is None:
                while bool(ai):
                    inner(None)
            else:
                w.loop(ai, inner, t_in)
            ro.sub_(1.0)
            ko.add_(1)
            return set_condition(ao, ro, half, ko, 1000, cond=cond)
        return body

    graph, whiles = _capture_whiles(lambda w: w.loop(ao, outer(w), t_out))
    for n in range(10):
        for t in state:
            t.zero_()
        ro.fill_(float(n))
        set_condition(ao, ro, half, ko, 1000)
        _replay_unsynced(graph)
        got = [t.tolist() for t in state[2:]]
        for t in state:
            t.zero_()
        ro.fill_(float(n))
        set_condition(ao, ro, half, ko, 1000)
        while bool(ao):
            outer(None)(None)
        inner_trips = sum(i % 4 for i in range(n))
        assert got[:3] == [n, int(ki), inner_trips] == [
            int(ko), int(ki), int(total)], n
        assert got[3] == [n + 1, n, 0] and got[4] == [n + inner_trips,
                                                      inner_trips, 0], n
    del graph
    whiles.close()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_set_condition_matches_plain_on_cuda(cuda, dtype):
    """The predicate kernel (one launch: ||r|| > target, no breakdown,
    k < maxiter) writes the flag of its plain version (torch operations)
    bit for bit on 256 seeded scalar sets, a quarter of them ties
    (res == target, k == maxiter) and a quarter with the breakdown flag
    up, with and without a breakdown flag."""
    from navierstokes_tpu_torch.kernels import conditional as C
    rng = np.random.default_rng(14)
    n, maxiter = 256, 3
    res = rng.standard_normal(n)
    target = np.where(rng.random(n) < 0.25, res, rng.standard_normal(n))
    k = rng.integers(0, maxiter + 2, n)
    stag = rng.random(n) < 0.25
    C.COUNTS.reset()
    for i in range(n):
        for with_stag in (True, False):
            out = {}
            for dev in ("cpu", "cuda"):
                t = lambda v: torch.tensor(v, dtype=dtype, device=dev)
                active = torch.tensor(not stag[i], device=dev)
                C.set_condition(
                    active, t(res[i]), t(target[i]),
                    torch.tensor(int(k[i]), device=dev), maxiter,
                    torch.tensor(bool(stag[i]), device=dev)
                    if with_stag else None)
                out[dev] = bool(active)
            assert out["cuda"] == out["cpu"], (i, with_stag)
    assert C.COUNTS.set_condition == 2 * n       # the CUDA launches only


def _cells_model(tmp, kv, kp, n=1, **fields):
    """The h=0.12 channel on the cells operator, float64, monolithic, the
    inner solves at 1e-10 (tests/test_torch_cells.py says why), on the
    card; ``n`` cell shards of cuda:0."""
    from navierstokes_tpu_torch.models.navier_stokes import NavierStokes
    cfg = SolverConfig(dtype="float64", scheme="monolithic",
                       operator="cells", n_devices=n, inner_tol=1e-10,
                       inner_maxiter_f=1000, inner_maxiter_s=1000,
                       output_dir=str(tmp / "out"),
                       cache_dir=str(tmp / "cache"),
                       csv_path=str(tmp / "forces.csv"), **fields)
    ns = NavierStokes(channel_with_cylinder_2d(h=0.12), kv, kp, deltat=0.01,
                      T=0.05, step=5, device="cuda", config=cfg,
                      shard_devices=["cuda:0"] * n if n > 1 else None,
                      inlet=InletConfig(kind="parabolic", u_m=0.3,
                                        height=0.41))
    ns.set_re_number(20)
    return ns.setup()


@pytest.mark.cuda
@pytest.mark.parametrize("kv,kp", [(2, 1), (3, 2)])
def test_cell_shards_on_one_card_match_one_device(cuda, tmp_path, kv, kp):
    """Cell shards of cuda:0 (parallel/sharded_cells.py) against the
    one-device cells model on the card, float64: every product on one
    shard equals ``CellOps`` bit for bit and on two agrees within 1e-12 of
    max|y| (a shard's einsum may round differently from the whole-cell
    one; chip_smoke.cell_products_on_card, phase 23's check); 2 steps on
    two shards with equal FGMRES counts, u and p within 1e-9; no SELL
    launch."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    one = _cells_model(tmp_path / "one", kv, kp)
    assert smoke.cell_products_on_card(one) <= 1e-12
    sh = _cells_model(tmp_path / "sh", kv, kp, n=2)
    assert sh._cell_sharded and len(sh.cells.shards) == 2
    K.COUNTS.reset()
    for _ in range(2):
        m1, m2 = one.solve_time_step(), sh.solve_time_step()
        assert m1.converged and m2.converged
        assert m1.iterations == m2.iterations
        for a, b in ((sh._u, one._u), (sh._p, one._p)):
            assert (a - b).abs().max() <= 1e-9 * b.abs().max()
    assert K.COUNTS.launches == 0 and K.COUNTS.plain_cuda_calls == 0


@pytest.mark.cuda
@pytest.mark.parametrize("start,to", [("projection", "monolithic"),
                                      ("monolithic", "projection")])
def test_captured_scheme_flip_equals_eager_flip(cuda, tmp_path, start, to):
    """``config.scheme`` changed after 2 steps, as bench.py's monolithic
    window changes it: the captured model drops its graphs and captures
    the new scheme's, and its next 2 steps equal the eager model's bit for
    bit."""
    from navierstokes_tpu_torch.models import step_graphs
    cap = _small_model(tmp_path / "cap", scheme=start)
    eag = _small_model(tmp_path / "eager", scheme=start)
    for k in range(4):
        if k == 2:
            old = cap._graphs
            cap.config.scheme = eag.config.scheme = to
        a, b = cap.solve_time_step(), eag.solve_time_step(_eager=True)
        assert (a.cd, a.cl, a.iterations, a.converged) == \
            (b.cd, b.cl, b.iterations, b.converged)
    cls = (step_graphs.MonolithicGraphs if to == "monolithic"
           else step_graphs.ProjectionGraphs)
    assert isinstance(cap._graphs, cls) and cap._graphs is not old
    assert torch.equal(cap._u, eag._u) and torch.equal(cap._p, eag._p)


# the block-Jacobi tile apply (kernels/bj_apply.py, csrc/bj_apply.cu):
# tiles dtype -> kernel-vs-plain limit over max|y| (fp32: both sum the
# exact products in float64 and round once, so they agree but where a sum
# lies within 1e-16 of an fp32 tie; fp64: only the summation order
# differs; bf16: both round a fp32 sum to bf16, so a sum near a rounding
# boundary may land one bf16 ulp apart)
BJ_LIMITS = {torch.float32: 1e-5, torch.float64: 1e-12}


def _bj_inputs(dev, dtype, d, n_tiles=5, sb=256, tail=77, seed=12):
    """Seeded tiles (n_tiles, sb, sb) and r (n_p2, d) with a tail tile of
    ``tail`` rows (the tiles scaled like an inverse near the identity)."""
    from navierstokes_tpu_torch.kernels import bj_apply as BJ
    rng = np.random.default_rng(seed)
    n_p2 = (n_tiles - 1) * sb + tail
    tiles = (np.eye(sb)[None] + 0.05 * rng.standard_normal(
        (n_tiles, sb, sb)))
    rdt = BJ.VARIANTS[dtype][1]
    r = torch.as_tensor(rng.standard_normal((n_p2, d)), dtype=rdt,
                        device=dev)
    return torch.as_tensor(tiles, dtype=torch.float32).to(
        device=dev, dtype=dtype), r


def _bf16_ulp(y):
    """One bf16 ulp of max|y| (8 significant bits)."""
    m = float(y.abs().max())
    return 2.0 ** (np.floor(np.log2(m)) - 7)


@pytest.mark.cuda
@pytest.mark.parametrize("sb", [128, 256, 512])
@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_bj_apply_kernel_matches_plain_on_cuda(cuda, dtype, d, sb):
    """The tile-apply kernel against its plain version (batched matmuls)
    on the card, with a tail tile of 77 live rows; a repeat is
    bit-identical; one launch counted, no plain call."""
    from navierstokes_tpu_torch.kernels import bj_apply as BJ
    tiles, r = _bj_inputs(cuda, dtype, d, sb=sb)
    BJ.COUNTS.reset()
    y = BJ.bj_apply(tiles, r)
    y2 = BJ.bj_apply(tiles, r)
    assert BJ.COUNTS.launches == 2 and BJ.COUNTS.plain_cuda_calls == 0
    assert BJ.COUNTS.by_variant == {(dtype, d): 2}
    yp = BJ.block_jacobi_apply_plain(tiles, r)
    torch.cuda.synchronize()
    assert y.shape == yp.shape == r.shape and y.dtype == r.dtype
    assert torch.equal(y, y2)
    if dtype == torch.bfloat16:
        # the kernel's outputs are bf16 values
        assert torch.equal(y, y.to(torch.bfloat16).float())
        assert float((y - yp).abs().max()) <= _bf16_ulp(yp)
    else:
        assert float((y - yp).abs().max()) <= (BJ_LIMITS[dtype]
                                               * float(yp.abs().max()))
    if dtype == torch.float32:
        # the correctly rounded products: no tie within reach on this seed
        assert torch.equal(y, yp)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_bj_apply_is_batch_invariant_on_cuda(cuda, dtype):
    """A tile's rows come out the same bit for bit alone, inside the
    batch, and at another place in another batch (the tail tile too), so
    row shards equal one device."""
    from navierstokes_tpu_torch.kernels import bj_apply as BJ
    tiles, r = _bj_inputs(cuda, dtype, 2, n_tiles=6, tail=100)
    sb = tiles.shape[1]
    y = BJ.bj_apply(tiles, r)
    for t in (0, 3, 5):
        rows = slice(t * sb, min((t + 1) * sb, r.shape[0]))
        alone = BJ.bj_apply(tiles[t:t + 1].contiguous(),
                            r[rows].contiguous())
        assert torch.equal(alone, y[rows])
    # tiles 2..5 as a batch of their own
    tail = BJ.bj_apply(tiles[2:].contiguous(), r[2 * sb:].contiguous())
    assert torch.equal(tail, y[2 * sb:])


def _bj_edge_inputs(dev, dtype, case):
    """Tiles and r of one edge of the kernel's ring and grid (see
    test_bj_apply_ring_and_grid_edges_on_cuda)."""
    from navierstokes_tpu_torch.kernels import bj_apply as BJ
    if case == "one tile":
        return _bj_inputs(dev, dtype, 2, n_tiles=1, tail=256)
    if case == "items not a multiple of the grid":
        # sized from the fp64 ring's grid (the register stream of fp32 and
        # bf16 tiles runs one CTA per 64 rows)
        g = BJ.ring(dev.index or 0, 256, 2)
        resident = g["ctas_per_sm"] * g["sms"]
        n_tiles = resident * g["rows_per_item"] // 256 + 2
        tail = 77
        while -(-((n_tiles - 1) * 256 + tail) // g["rows_per_item"]) \
                % resident == 0:
            tail += g["rows_per_item"]
        return _bj_inputs(dev, dtype, 2, n_tiles=n_tiles, tail=tail)
    if case == "one-row tail tile":
        return _bj_inputs(dev, dtype, 2, n_tiles=5, tail=1)
    if case in ("SB 128", "SB 512"):
        return _bj_inputs(dev, dtype, 2, sb=int(case[3:]))
    if case == "d=3":
        return _bj_inputs(dev, dtype, 3, n_tiles=7, tail=200)
    raise ValueError(case)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    "one tile", "items not a multiple of the grid", "one-row tail tile",
    "SB 128", "SB 512", "d=3", "tiles[t:] slice"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_bj_apply_ring_and_grid_edges_on_cuda(cuda, dtype, case):
    """The edges of the persistent grid and the ring (fewer items than
    CTAs, a count of items the grid does not divide, a tail tile of one
    row, SB 128 and 512, d=3, a slice ``tiles[t:]`` of a batch): the kernel
    against its plain version, a repeat bit for bit, and each of the first,
    a middle and the last tile alone equal to the batch's rows."""
    from navierstokes_tpu_torch.kernels import bj_apply as BJ
    if case == "tiles[t:] slice":
        tiles, r = _bj_inputs(cuda, dtype, 2, n_tiles=6, tail=100)
        sb = tiles.shape[1]
        y = BJ.bj_apply(tiles, r)
        for t in (1, 4, 5):
            assert torch.equal(BJ.bj_apply(tiles[t:], r[t * sb:]),
                               y[t * sb:])
        return
    tiles, r = _bj_edge_inputs(cuda, dtype, case)
    cfg = BJ.launch_config(tiles, r)
    if case == "one tile" and dtype == torch.float64:
        assert cfg["n_items"] < cfg["ctas_per_sm"] * cfg["sms"]
        assert cfg["grid"] == cfg["n_items"]
    if case == "items not a multiple of the grid" and dtype == torch.float64:
        assert cfg["n_items"] > cfg["grid"] and cfg["n_long"] > 0
    y = BJ.bj_apply(tiles, r)
    y2 = BJ.bj_apply(tiles, r)
    yp = BJ.block_jacobi_apply_plain(tiles, r)
    torch.cuda.synchronize()
    assert torch.equal(y, y2)
    if dtype == torch.bfloat16:
        assert float((y - yp).abs().max()) <= _bf16_ulp(yp)
    else:
        assert float((y - yp).abs().max()) <= (BJ_LIMITS[dtype]
                                               * float(yp.abs().max()))
    n_tiles, sb = tiles.shape[0], tiles.shape[1]
    for t in sorted({0, n_tiles // 2, n_tiles - 1}):
        rows = slice(t * sb, min((t + 1) * sb, r.shape[0]))
        assert torch.equal(BJ.bj_apply(tiles[t:t + 1], r[rows]), y[rows])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_bj_apply_reuses_stages_safely_with_tiles_in_l2(cuda, dtype):
    """Tiles that fit in the L2 and were just read there, many items per
    CTA (every stage of the ring reused many times): each bulk copy lands
    within a few hundred cycles, so a stage given back before the warp's
    reads of it landed would be overwritten under them.  Every launch
    equals the first bit for bit, and the first is within the limit of the
    plain version."""
    from navierstokes_tpu_torch.kernels import bj_apply as BJ
    # about 40 MB of tiles, within the 50 MB L2
    n_tiles = (40 << 20) // (256 * 256 * torch.finfo(dtype).bits // 8)
    tiles, r = _bj_inputs(cuda, dtype, 2, n_tiles=n_tiles, tail=130)
    cfg = BJ.launch_config(tiles, r)
    if dtype == torch.float64:
        assert cfg["n_items"] > cfg["stages"] * cfg["grid"]
    ys = []
    for _ in range(12):
        tiles.sum()                      # the tiles into the L2
        ys.append(BJ.bj_apply(tiles, r))
    yp = BJ.block_jacobi_apply_plain(tiles, r)
    torch.cuda.synchronize()
    for y in ys[1:]:
        assert torch.equal(y, ys[0])
    if dtype == torch.bfloat16:
        assert float((ys[0] - yp).abs().max()) <= _bf16_ulp(yp)
    else:
        assert float((ys[0] - yp).abs().max()) <= (BJ_LIMITS[dtype]
                                                   * float(yp.abs().max()))


# the fp64 ring's first launch in a fresh process at the bench point's
# tiles, the last 40 MB of them just read into the L2
_BJ_FIRST_LAUNCH = """
import torch
from navierstokes_tpu_torch.kernels import bj_apply as BJ
g = torch.Generator(device="cuda").manual_seed(15)
tiles = 0.05 * torch.randn((1760, 256, 256), generator=g, device="cuda",
                           dtype=torch.float64)
tiles.diagonal(dim1=1, dim2=2).add_(1.0)
r = torch.randn((450_518, 2), generator=g, device="cuda", dtype=torch.float64)
ys = []
for _ in range(4):
    tiles[-80:].sum()
    ys.append(BJ.bj_apply(tiles, r))
yp = BJ.block_jacobi_apply_plain(tiles, r)
torch.cuda.synchronize()
bad = [k for k, y in enumerate(ys) if not torch.equal(y, ys[-1])]
assert not bad, f"launches {bad} differ from the last in " + str(
    [int((ys[k] != ys[-1]).any(dim=1).sum()) for k in bad]) + " rows"
assert float((ys[0] - yp).abs().max()) <= 1e-12 * float(yp.abs().max())
"""


@pytest.mark.cuda
def test_bj_apply_f64_first_launch_with_the_tiles_end_in_l2(cuda):
    """The fp64 ring's first launch in a fresh process, at the bench
    point's tiles with their last 40 MB just read into the L2, then three
    more: the last CTAs' bulk copies hit the L2 and land within a few
    hundred cycles.  Before a proxy fence preceded each release of a stage,
    they overwrote rows that some lanes had not read yet, in every first
    launch (a few of the last CTAs' rows, seen on an H100).  Every launch
    equals the last bit for bit and the plain version within 1e-12 of
    max|y|."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, "-c", _BJ_FIRST_LAUNCH], check=True,
                   cwd=ROOT, env=env, timeout=600)


@pytest.mark.cuda
def test_bj_apply_refuses_what_the_kernel_does_not_take(cuda):
    from navierstokes_tpu_torch.kernels import bj_apply as BJ
    tiles, r = _bj_inputs(cuda, torch.float32, 2)
    with pytest.raises(TypeError, match="no other variant"):
        BJ.bj_apply(tiles.half(), r)
    with pytest.raises(TypeError, match="r must be torch.float32"):
        BJ.bj_apply(tiles.to(torch.bfloat16), r.double())
    with pytest.raises(TypeError, match="r must be torch.float64"):
        BJ.bj_apply(tiles.double(), r)
    with pytest.raises(ValueError, match="tiles on"):
        BJ.bj_apply(tiles, r.cpu())
    with pytest.raises(ValueError, match="no instantiation"):
        BJ.bj_apply(tiles[:, :192, :192].contiguous(), r[:900])
    with pytest.raises(ValueError, match="SB, SB"):
        BJ.bj_apply(tiles[:, :, :128].contiguous(), r)
    with pytest.raises(ValueError, match=r"\(n_p2, 2\) or \(n_p2, 3\)"):
        BJ.bj_apply(tiles, r[:, :1].contiguous())
    with pytest.raises(ValueError, match="rows of r"):
        BJ.bj_apply(tiles, r[:4 * 256])
    with pytest.raises(ValueError, match="contiguous"):
        BJ.bj_apply(tiles, r.t().contiguous().t())
    with pytest.raises(ValueError, match="contiguous"):
        BJ.bj_apply(tiles.transpose(1, 2), r)
    buf = torch.empty(tiles.numel() + 1, device=cuda)
    off = buf[1:].view(tiles.shape)
    off.copy_(tiles)
    with pytest.raises(ValueError, match="16-byte aligned"):
        BJ.bj_apply(off, r)
    # 8 bytes off: short of the fp32 stream's 16-byte loads and of the fp64
    # ring's bulk copies, which also copy r
    for dt in (torch.float32, torch.float64):
        t = tiles.to(dt)
        step = 8 // t.element_size()
        buf = torch.empty(t.numel() + step, device=cuda, dtype=dt)
        off = buf[step:].view(t.shape)
        off.copy_(t)
        with pytest.raises(ValueError, match="tiles must be 16-byte aligned"):
            BJ.bj_apply(off, r.to(BJ.VARIANTS[dt][1]))
    rr = r.double()
    rbuf = torch.empty(rr.numel() + 1, device=cuda, dtype=rr.dtype)
    roff = rbuf[1:].view(rr.shape)
    roff.copy_(rr)
    with pytest.raises(ValueError, match="r must be 16-byte aligned"):
        BJ.bj_apply(tiles.double(), roff)


@pytest.mark.cuda
@pytest.mark.parametrize("fields", [
    dict(scheme="projection"), dict(scheme="projection", bj_newton=0),
    dict(scheme="monolithic"), dict(scheme="monolithic", inner_bf16=True),
    dict(scheme="monolithic", refine=2, refine_tol=1e-3)])
def test_captured_and_eager_steps_launch_bj_apply(cuda, tmp_path, fields):
    """Captured and eager steps of the small fixture (both branches of the
    tile rebuild: Newton-Schulz and, with ``bj_newton=0``, the exact
    inverse) apply every tile through the kernel, in the tiles' dtype,
    with the same launches per step, and never through the plain
    version."""
    from navierstokes_tpu_torch.kernels import bj_apply as BJ
    eager = _small_model(tmp_path / "eager", **fields)
    graphs = _small_model(tmp_path / "graphs", **fields)
    graphs.capture_graphs()
    want = torch.bfloat16 if fields.get("inner_bf16") else torch.float32
    counts = []
    for ns, kw in ((eager, dict(_eager=True)), (graphs, {})):
        BJ.COUNTS.reset()
        for _ in range(3):
            ns.solve_time_step(**kw)
        assert BJ.COUNTS.plain_cuda_calls == 0
        counts.append(dict(BJ.COUNTS.by_variant))
    assert counts[0] == counts[1]
    assert set(counts[0]) == {(want, 2)} and counts[0][(want, 2)] > 0
    assert torch.equal(eager._u, graphs._u)


@pytest.mark.cuda
def test_float64_steps_on_cuda_launch_bj_apply_f64(cuda, tmp_path):
    """A float64 model on the card applies its float64 tiles through the
    kernel's fp64 variant and steps within 1e-9 of the CPU."""
    from navierstokes_tpu_torch.kernels import bj_apply as BJ
    from navierstokes_tpu_torch.models.navier_stokes import NavierStokes
    runs = {}
    for dev in ("cpu", "cuda"):
        cfg = SolverConfig(dtype="float64", scheme="projection",
                           proj_tol=1e-10, output_dir=str(tmp_path / dev),
                           cache_dir=str(tmp_path / dev / "cache"),
                           csv_path=str(tmp_path / dev / "forces.csv"))
        ns = NavierStokes(channel_with_cylinder_2d(h=0.12), 2, 1,
                          deltat=0.01, T=0.02, step=2, device=dev,
                          config=cfg, inlet=InletConfig(
                              kind="parabolic", u_m=0.3, height=0.41))
        ns.set_re_number(20)
        ns.setup()
        BJ.COUNTS.reset()
        for _ in range(2):
            ns.solve_time_step(_eager=True)
        runs[dev] = (ns, dict(BJ.COUNTS.by_variant),
                     BJ.COUNTS.plain_cuda_calls)
    (cpu, c_cpu, _), (gpu, c_gpu, plain) = runs["cpu"], runs["cuda"]
    assert c_cpu == {} and plain == 0
    assert set(c_gpu) == {(torch.float64, 2)}
    assert (gpu._u.cpu() - cpu._u).abs().max() <= 1e-9 * cpu._u.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", [1, 1000, 70_001])
@pytest.mark.parametrize("active", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("stage", ["bicgstab_p", "bicgstab_s",
                                   "bicgstab_xr", "cg_xr", "cg_p"])
def test_krylov_update_kernels_match_plain_on_cuda(cuda, stage, dtype,
                                                   active, n, offset):
    """Each fused update stage (csrc/krylov_update.cu) equals its plain
    version on the card bit for bit, and the plain version on the CPU, in
    every buffer (the CG stages, whose float64 sums run in other orders,
    under ``_cg_gate``); with the flag down no state buffer moves."""
    from navierstokes_tpu_torch.kernels import krylov_update as KU
    kern = KU.example(stage, n, dtype, "cuda", np.random.default_rng(5),
                      active=active, offset=offset)
    plain = [t.clone() for t in kern]
    host = [t.cpu() for t in kern]
    before = [t.clone() for t in kern]
    KU.COUNTS.reset()
    KU.update(stage, *kern)
    KU.PLAIN[stage](*plain)
    KU.update(stage, *host)
    torch.cuda.synchronize()
    assert getattr(KU.COUNTS, stage) == 1
    if stage in KU.CG_DOTS:
        for ref in (plain, [t.cuda() for t in host]):
            _cg_gate(stage, kern, ref, before)
    else:
        for i, (a, b, c) in enumerate(zip(kern, plain, host)):
            assert torch.equal(a, b) and torch.equal(a.cpu(), c), (stage, i)
    if not active:
        for name, a, b in zip(KU.ARGS[stage], kern, before):
            assert name in KU.SCRATCH.get(stage, ()) or torch.equal(a, b), \
                (stage, name)


def _cg_gate(stage, kern, ref, before):
    """A CG stage on the card (``kern``) against its plain version
    (``ref``) from the same inputs (``before``) under
    ``krylov_update.cg_gate``; returns whether the dots and the norm were
    equal."""
    from navierstokes_tpu_torch.kernels import krylov_update as KU
    ok, equal, err = KU.cg_gate(stage, kern, ref, before)
    assert ok, (stage, err)
    return equal


def _views(stage, n, dtype, offsets, rng, active, signed=False):
    """A stage's tensors (``KU.example``) with its vectors re-viewed
    ``offsets[i]`` elements into storages of their own, in ARGS order."""
    from navierstokes_tpu_torch.kernels import krylov_update as KU
    args = KU.example(stage, n, dtype, "cuda", rng, active=active,
                      signed=signed)
    vec = iter(offsets)
    out = []
    for name, t in zip(KU.ARGS[stage], args):
        if name in KU.VECTORS:
            off = next(vec)
            buf = torch.empty(n + off, dtype=dtype, device="cuda")
            buf[off:] = t
            t = buf[off:]
        out.append(t)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 3, 1_003, 70_001])
@pytest.mark.parametrize("active", [True, False])
@pytest.mark.parametrize("dtype,layout", [
    (torch.float32, "vector"), (torch.float32, "peeled1"),
    (torch.float32, "peeled2"), (torch.float32, "peeled3"),
    (torch.float32, "scalar"), (torch.float64, "vector"),
    (torch.float64, "peeled1"), (torch.float64, "scalar")],
    ids=lambda v: str(v).replace("torch.", ""))
@pytest.mark.parametrize("stage", ["bicgstab_p", "bicgstab_s",
                                   "bicgstab_xr"])
def test_krylov_update_paths_match_plain_on_cuda(cuda, stage, dtype, active,
                                                 layout, n):
    """Each BiCGStab stage on the vector path (every vector 16-byte
    aligned), the peeled path (all 1, 2 or 3 elements off a boundary:
    a scalar head, fp64 only one) and the scalar path (vectors at
    different offsets), n not a multiple of the vector width (and
    shorter than the head): bit for bit with the plain version on the
    card and on the CPU, the flag up and down; the launch counted on the
    path ``KU.path`` picks from the addresses."""
    from navierstokes_tpu_torch.kernels import krylov_update as KU
    k = sum(name in KU.VECTORS for name in KU.ARGS[stage])
    if layout == "vector":
        offsets = [0] * k
    elif layout == "scalar":
        offsets = [0] + [1] * (k - 1)
    else:
        offsets = [int(layout[-1])] * k
    kern = _views(stage, n, dtype, offsets, np.random.default_rng(11),
                  active)
    plain = [t.clone() for t in kern]
    host = [t.cpu() for t in kern]
    before = [t.clone() for t in kern]
    way = KU.path([t.data_ptr() for name, t in zip(KU.ARGS[stage], kern)
                   if name in KU.VECTORS])
    assert way == layout.rstrip("123")
    KU.COUNTS.reset()
    KU.update(stage, *kern)
    KU.PLAIN[stage](*plain)
    KU.update(stage, *host)
    torch.cuda.synchronize()
    assert KU.PATHS == {(stage, way): 1}
    assert getattr(KU.COUNTS, stage) == 1
    for name, a, b, c in zip(KU.ARGS[stage], kern, plain, host):
        assert torch.equal(a, b) and torch.equal(a.cpu(), c), (stage, name)
    if not active:
        for name, a, b in zip(KU.ARGS[stage], kern, before):
            assert name in KU.SCRATCH.get(stage, ()) or torch.equal(a, b), \
                (stage, name)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [113_378, 1_001, 300_001])
@pytest.mark.parametrize("active", [True, False])
@pytest.mark.parametrize("layout", ["vector", "off1", "off2", "scalar"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("stage", ["cg_xr", "cg_p"])
def test_cg_stages_match_plain_on_cuda(cuda, stage, dtype, layout, active,
                                       n):
    """Each CG stage (one cluster, its own dot; csrc/krylov_update.cu)
    against its plain version on the card under ``_cg_gate``, at the bench
    point's P1 size, an odd n and n above one cluster's register pass
    (131,072 fp32 elements on the vector path), on aligned views, views 1
    and 2 elements off a 16-byte boundary (float64's 2 land on one) and
    views at mixed offsets; at odd n the dot's products of both signs; the
    launch counted on the path that ``KU.path`` picks; bit-identical on
    repeat; with the flag down nothing moves.
    Prints whether the dots and the norm were bit-equal (chip_smoke.py
    phase 26 counts such cases over its draws)."""
    from navierstokes_tpu_torch.kernels import krylov_update as KU
    k = sum(name in KU.VECTORS for name in KU.ARGS[stage])
    offsets = {"vector": [0] * k, "off1": [1] * k, "off2": [2] * k,
               "scalar": [0] + [1] * (k - 1)}[layout]
    kern = _views(stage, n, dtype, offsets, np.random.default_rng(n),
                  active, signed=n % 2 == 1)
    again = _views(stage, n, dtype, offsets, np.random.default_rng(n),
                   active, signed=n % 2 == 1)
    plain = [t.clone() for t in kern]
    before = [t.clone() for t in kern]
    way = KU.path([t.data_ptr() for name, t in zip(KU.ARGS[stage], kern)
                   if name in KU.VECTORS])
    KU.COUNTS.reset()
    KU.update(stage, *kern)
    KU.update(stage, *again)
    KU.PLAIN[stage](*plain)
    torch.cuda.synchronize()
    assert KU.PATHS == {(stage, way): 2}
    assert all(torch.equal(a, b) for a, b in zip(kern, again))
    if active:
        equal = _cg_gate(stage, kern, plain, before)
        print(f"{stage} {dtype} {layout} n={n}: dots and norm "
              f"{'bit-equal' if equal else 'apart, within the gate'}")
    else:
        for name, a, b in zip(KU.ARGS[stage], kern, before):
            assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_captured_cg_loop_equals_eager_on_cuda(cuda, dtype):
    """A ``CgLoop`` under one while node (GRAPH) equals the same loop run
    eagerly with a host read before each iteration (HOST) bit for bit in
    every state buffer, on an SPD tridiagonal system of 113,378 unknowns
    with the Jacobi preconditioner; one iteration launches cg_xr and cg_p
    once each."""
    from navierstokes_tpu_torch.kernels import krylov_update as KU
    from navierstokes_tpu_torch.kernels.conditional import WhileNodes
    from navierstokes_tpu_torch.solvers import krylov as TK
    n = 113_378
    rng = np.random.default_rng(31)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=cuda)
    d = t(rng.uniform(2.0, 4.0, n))
    off = t(-rng.uniform(0.0, 0.9, n - 1))
    b = t(rng.standard_normal(n))
    pad = torch.nn.functional.pad

    def mv(v):
        return d * v + pad(off * v[:-1], (1, 0)) + pad(off * v[1:], (0, 1))

    kw = dict(tol=1e-5 if dtype == torch.float32 else 1e-10, maxiter=300,
              precond=lambda v: v / d)
    names = ("x", "r", "p", "rz", "pap", "rnorm", "k", "active")
    eager = TK.CgLoop(mv, b, **kw)
    KU.COUNTS.reset()
    with TK.iteration_mode(TK.Mode(TK.HOST)):
        eager.run()
    torch.cuda.synchronize()
    its = int(eager.k)
    assert 10 < its < 300 and not bool(eager.active)
    assert KU.COUNTS.cg_xr == KU.COUNTS.cg_p == its
    loop = TK.CgLoop(mv, b, **kw)
    whiles = WhileNodes("cuda")
    mode = TK.Mode(TK.GRAPH, whiles)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream), whiles.routed(), \
            TK.iteration_mode(mode):
        loop.run()
    graph.replay()
    torch.cuda.synchronize()
    for name in names:
        assert torch.equal(getattr(loop, name), getattr(eager, name)), name
    assert mode.tally[0].tolist() == [its + 1, its, 0]
    del graph
    whiles.close()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gram_schmidt_padded_basis_every_j_on_cuda(cuda, dtype):
    """The Gram-Schmidt kernels on the padded basis (``GS.basis``) at
    every j from 0 to 63 of a restart-64 basis (the ring's slots wrap at
    every multiple of its depth, 8 rows in fp32 and 4 in fp64, and the
    first pass's dots re-stage rows past it), n = 20,001 (a last tile
    of 33 elements, rows 4 bytes past a whole vector in fp32): h1, h2,
    ||w||, the new row within one ulp or 2^-24 (fp32; 1e-13 fp64) of the
    scale of the plain version, Z's row equal, bit-identical on repeat,
    each call counted once; w given 1 element off a 16-byte boundary
    (copied element by element) gives the same bits."""
    from navierstokes_tpu_torch.kernels import gram_schmidt as GS
    rel = 2.0 ** -24 if dtype == torch.float32 else 1e-13
    m, n = 64, 20_001
    work = GS.workspace(m, n, dtype, "cuda")
    flag = torch.tensor(True, device="cuda")
    names = ("V", "w", "h1", "h2", "wnorm")
    for j in range(m):
        kern = _gs_state(m, n, j, dtype, 40 + j, "cuda")
        again = _gs_clone(kern)
        shifted = torch.empty(n + 1, dtype=dtype, device="cuda")[1:]
        shifted.copy_(kern["w"])
        again["w"] = shifted
        plain = {k: v.clone() for k, v in kern.items()}
        jt = torch.tensor(j, dtype=torch.int32, device="cuda")
        GS.COUNTS.reset()
        for st in (kern, again):
            GS.gram_schmidt(*(st[k] for k in names), jt, flag, work,
                            st["z"], st["Z"])
        GS.gram_schmidt_plain(*(plain[k] for k in names), jt, flag,
                              plain["z"], plain["Z"])
        torch.cuda.synchronize()
        assert GS.COUNTS.calls == 2
        for k in kern:
            assert torch.equal(again[k], kern[k]), (j, k)
        h1 = float(plain["h1"].abs().max())
        for k in ("h1", "h2"):
            assert _within(kern[k], plain[k], h1, rel), (j, k)
            assert not kern[k][j + 1:].any(), (j, k)
        assert _within(kern["wnorm"], plain["wnorm"], float(plain["wnorm"]),
                       rel), j
        assert _within(kern["V"][j + 1], plain["V"][j + 1],
                       float(plain["V"][j + 1].abs().max()), rel), j
        assert torch.equal(kern["Z"], plain["Z"]), j


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gram_schmidt_launches_per_call_on_cuda(cuda, dtype):
    """A call's kernel launches counted in a captured call's graph
    (chip_smoke.kernel_launches, phase 26's count): ``GS.LAUNCHES``, the
    three passes and the write, and nothing else, at j = 0, 5, 13, 20
    and 38."""
    from navierstokes_tpu_torch.kernels import gram_schmidt as GS
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    m, n = 64, 70_001
    work = GS.workspace(m, n, dtype, "cuda")
    flag = torch.tensor(True, device="cuda")
    for j in (0, 5, 13, 20, 38):
        st = _gs_state(m, n, j, dtype, 60 + j, "cuda")
        jt = torch.tensor(j, dtype=torch.int32, device="cuda")
        launches, other = smoke.kernel_launches(lambda: GS.gram_schmidt(
            st["V"], st["w"], st["h1"], st["h2"], st["wnorm"], jt, flag,
            work, st["z"], st["Z"]))
        assert (launches, other) == (GS.LAUNCHES, 0) == (4, 0), j


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gram_schmidt_restarts_in_any_order_on_cuda(cuda, dtype):
    """Bases of 13, 65 and 401 rows set up and launched in turn, then 13
    again (a GMRES at restart 12 after a NavierStokes model at 64): each
    call within the gate of the plain version (no basis lowers the
    passes' shared-memory limit below another's); a basis past
    ``setup``'s ``max_rows`` raises before any launch."""
    from navierstokes_tpu_torch.kernels import gram_schmidt as GS
    rel = 2.0 ** -24 if dtype == torch.float32 else 1e-13
    n = 3_001
    flag = torch.tensor(True, device="cuda")
    names = ("V", "w", "h1", "h2", "wnorm")
    for m in (12, 64, 400, 12):
        j = min(m - 1, 9)
        work = GS.workspace(m, n, dtype, "cuda")
        kern = _gs_state(m, n, j, dtype, 70 + m, "cuda")
        plain = {k: v.clone() for k, v in kern.items()}
        jt = torch.tensor(j, dtype=torch.int32, device="cuda")
        GS.gram_schmidt(*(kern[k] for k in names), jt, flag, work,
                        kern["z"], kern["Z"])
        GS.gram_schmidt_plain(*(plain[k] for k in names), jt, flag,
                              plain["z"], plain["Z"])
        torch.cuda.synchronize()
        h1 = float(plain["h1"].abs().max())
        for k in ("h1", "h2"):
            assert _within(kern[k], plain[k], h1, rel), (m, k)
        assert _within(kern["V"][j + 1], plain["V"][j + 1],
                       float(plain["V"][j + 1].abs().max()), rel), m
        assert torch.equal(kern["Z"], plain["Z"]), m
    rows = GS.setup("cuda", dtype)["max_rows"]
    big = GS.basis(rows + 1, 64, dtype, "cuda").zero_()
    st = _gs_state(1, 64, 0, dtype, 5, "cuda")
    GS.COUNTS.reset()
    with pytest.raises(ValueError, match="rows at most"):
        GS.gram_schmidt(big, st["w"], torch.zeros(rows + 1, dtype=dtype,
                                                  device="cuda"),
                        torch.zeros(rows + 1, dtype=dtype, device="cuda"),
                        st["wnorm"], torch.tensor(0, dtype=torch.int32,
                                                  device="cuda"),
                        flag, GS.workspace(rows, 64, dtype, "cuda"))
    assert GS.COUNTS.calls == 0


@pytest.mark.cuda
def test_gram_schmidt_refuses_an_unaligned_basis_on_cuda(cuda):
    """A contiguous basis whose rows fall off 16-byte boundaries, or a
    padded one viewed from its second element, raises before any launch
    (no copy, no other path)."""
    from navierstokes_tpu_torch.kernels import gram_schmidt as GS
    m, n = 12, 301
    st = _gs_state(m, n, 3, torch.float32, 3, "cuda")
    work = GS.workspace(m, n, torch.float32, "cuda")
    jt = torch.tensor(3, dtype=torch.int32, device="cuda")
    flag = torch.tensor(True, device="cuda")
    GS.COUNTS.reset()
    bad = {"V": st["V"].contiguous(),
           "V+1": GS.basis(m + 1, n + 1, torch.float32, "cuda")[:, 1:]}
    for tag, V in bad.items():
        with pytest.raises(ValueError, match="16-byte|row stride"):
            GS.gram_schmidt(V, st["w"], st["h1"], st["h2"], st["wnorm"],
                            jt, flag, work, st["z"], st["Z"])
    with pytest.raises(ValueError, match="16-byte|row stride"):
        GS.gram_schmidt(st["V"], st["w"], st["h1"], st["h2"], st["wnorm"],
                        jt, flag, work, st["z"], st["Z"].contiguous())
    assert GS.COUNTS.calls == 0


def _within(k, p, scale, rel):
    """Each element of k within one ulp of p, or within ``rel`` of the
    scale (the elements the second pass leaves far below it)."""
    ulp = torch.nextafter(p.abs(), torch.full_like(p, float("inf"))) - p.abs()
    return bool(((k - p).abs() <= torch.clamp(ulp, min=rel * scale)).all())


def _gs_state(m, n, j, dtype, seed, device):
    """V and Z in the padded bases that GmresLoop allocates
    (kernels/gram_schmidt.basis), the rest contiguous."""
    from navierstokes_tpu_torch.kernels import gram_schmidt as GS
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, j + 1)))
    V = np.zeros((m + 1, n))
    V[:j + 1] = q.T
    w = rng.standard_normal(n) + 3.0 * q @ rng.standard_normal(j + 1)
    z = rng.standard_normal(n)
    Z = rng.standard_normal((m, n))
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)

    def padded(a):
        b = GS.basis(a.shape[0], n, dtype, device)
        b.copy_(t(a))
        return b
    return dict(V=padded(V), w=t(w), z=t(z), Z=padded(Z),
                h1=torch.full((m + 1,), 7.0, dtype=dtype, device=device),
                h2=torch.full((m + 1,), 7.0, dtype=dtype, device=device),
                wnorm=torch.zeros((), dtype=dtype, device=device))


def _gs_clone(st):
    """A copy of a Gram-Schmidt state, V and Z in padded bases of their
    own (``clone`` of the padded views would make them contiguous)."""
    from navierstokes_tpu_torch.kernels import gram_schmidt as GS
    out = {k: v.clone() for k, v in st.items() if k not in ("V", "Z")}
    for k in ("V", "Z"):
        out[k] = GS.basis(st[k].shape[0], st[k].shape[1], st[k].dtype,
                          st[k].device)
        out[k].copy_(st[k])
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("active", [True, False])
@pytest.mark.parametrize("dtype,m,n,j", [
    (torch.float32, 12, 301, 0), (torch.float32, 12, 301, 1),
    (torch.float32, 12, 301, 11), (torch.float32, 12, 301, 12),
    (torch.float32, 64, 70_001, 13), (torch.float32, 64, 3_000, 15),
    (torch.float32, 120, 5_000, 110),
    (torch.float64, 12, 301, 11), (torch.float64, 64, 70_001, 38),
    (torch.float64, 64, 3_000, 31), (torch.float64, 64, 20_000, 60)],
    ids=lambda v: str(v).replace("torch.", ""))
def test_gram_schmidt_kernel_matches_plain_on_cuda(cuda, dtype, m, n, j,
                                                   active):
    """The Gram-Schmidt kernels (csrc/gram_schmidt.cu; one partial block
    of staged rows at j < 15, several and a partial last one at j = 38,
    60 and 110, exactly one at j = 15) against the plain version
    on the card: each element of h1 and h2 within one ulp, or within 2^-24
    (fp32; 1e-13 fp64) of max|h1|, ||w|| and the new row within one ulp or
    the same of their max (both sum products in float64, in other orders;
    fp32 sums would miss it, PERF.md section 6), Z's row equal, rows
    beyond j of h zero,
    every other row of V and Z untouched, bit-identical on repeat; with
    the flag down V and Z unchanged."""
    from navierstokes_tpu_torch.kernels import gram_schmidt as GS
    rel = 2.0 ** -24 if dtype == torch.float32 else 1e-13
    kern = _gs_state(m, n, min(j, m - 1), dtype, 3, "cuda")
    again = _gs_clone(kern)
    plain = {k: v.clone() for k, v in kern.items()}
    jt = torch.tensor(j, dtype=torch.int32, device="cuda")
    flag = torch.tensor(active, device="cuda")
    work = GS.workspace(m, n, dtype, "cuda")
    names = ("V", "w", "h1", "h2", "wnorm")
    GS.COUNTS.reset()
    for st in (kern, again):
        GS.gram_schmidt(*(st[k] for k in names), jt, flag, work, st["z"],
                        st["Z"])
    GS.gram_schmidt_plain(*(plain[k] for k in names), jt, flag,
                          plain["z"], plain["Z"])
    torch.cuda.synchronize()
    assert GS.COUNTS.calls == 2
    assert all(torch.equal(again[k], kern[k]) for k in kern)
    h1 = float(plain["h1"].abs().max())
    for k in ("h1", "h2"):
        assert _within(kern[k], plain[k], h1, rel), k
        assert not kern[k][j + 1:].any(), k
    assert _within(kern["wnorm"], plain["wnorm"], float(plain["wnorm"]), rel)
    row = min(j + 1, m)
    assert _within(kern["V"][row], plain["V"][row],
                   float(plain["V"][row].abs().max()), rel)
    others = [i for i in range(m + 1) if i != row]
    assert torch.equal(kern["V"][others], plain["V"][others])
    assert torch.equal(kern["Z"], plain["Z"])
    assert torch.equal(kern["w"], plain["w"])
    if not active:
        ref = _gs_state(m, n, min(j, m - 1), dtype, 3, "cuda")
        assert torch.equal(kern["V"], ref["V"])
        assert torch.equal(kern["Z"], ref["Z"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("solver", ["bicgstab", "cg", "gmres", "fgmres"])
def test_krylov_solves_launch_the_loop_kernels_on_cuda(cuda, solver, dtype):
    """Whole solves on the card go through the fused updates and the
    Gram-Schmidt kernels and agree with the CPU's: the same count within
    one iteration, x within 1e-4 (fp32) or 1e-10 (fp64) of max|x|."""
    from navierstokes_tpu_torch.kernels import gram_schmidt as GS
    from navierstokes_tpu_torch.kernels import krylov_update as KU
    from navierstokes_tpu_torch.solvers import krylov as TK
    rng = np.random.default_rng(8)
    n = 3000
    if solver == "cg":
        d = rng.uniform(1.0, 50.0, n)
        off = 0.3 * rng.uniform(0.0, 1.0, n - 1)
        a = np.diag(d) + np.diag(off, 1) + np.diag(off, -1)
    else:
        a = (np.diag(rng.uniform(1.0, 6.0, n))
             + np.diag(rng.uniform(-1.0, 1.0, n - 1), 1)
             + np.diag(rng.uniform(-1.0, 1.0, n - 1), -1))
    b = rng.standard_normal(n)
    kw = dict(tol=1e-5 if dtype == torch.float32 else 1e-10, maxiter=400)
    if solver in ("gmres", "fgmres"):
        kw.update(restart=16)
    out = {}
    for dev in ("cpu", "cuda"):
        A = torch.as_tensor(a, dtype=dtype, device=dev).to_sparse_csr()
        D = torch.as_tensor(1.0 / np.diag(a), dtype=dtype, device=dev)
        KU.COUNTS.reset()
        GS.COUNTS.reset()
        res = getattr(TK, solver)(lambda v: A @ v,
                                  torch.as_tensor(b, dtype=dtype,
                                                  device=dev),
                                  precond=lambda v: v * D, **kw)
        out[dev] = (res, dataclasses.asdict(KU.COUNTS), GS.COUNTS.calls)
    (cpu, c_cpu, g_cpu), (gpu, c_gpu, g_gpu) = out["cpu"], out["cuda"]
    assert cpu.converged and gpu.converged
    assert abs(cpu.iterations - gpu.iterations) <= 1
    assert sum(c_cpu.values()) == 0 and g_cpu == 0
    if solver in ("gmres", "fgmres"):
        assert g_gpu >= gpu.iterations
    else:
        stages = [s for s in c_gpu if s.startswith(solver)]
        assert all(c_gpu[s] > 0 for s in stages) and stages
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    x = cpu.x.abs().max()
    assert (gpu.x.cpu() - cpu.x).abs().max() <= tol * x


def _vcycle_parts(space, dev, dtype, pinned=True, agg_blocks=4):
    """(P1Matrix, CoarsePlan, sc_inv, lambda_max) of the fixture's P1
    Laplacian (pinned at the outlet, as the projection step builds it, or
    not), made as ``NavierStokes._coarse_statics`` makes them."""
    from navierstokes_tpu_torch.mesh.geometry import TAG_OUTLET
    from navierstokes_tpu_torch.solvers import schur as TS
    mesh = space.mesh
    pin = (np.unique(mesh.boundary_faces[mesh.boundary_tags == TAG_OUTLET])
           if pinned else None)
    op = TP.assemble_p1_stiffness(space, None, dtype, dev,
                                  dirichlet_nodes=pin)
    plan = TS.build_coarse_plan(space.n_p1, op.b, agg_blocks)
    sc = TP.coarse_from_ell(op, agg_blocks)
    scale = np.abs(np.diag(sc)).mean() + 1e-30
    sc_inv = torch.as_tensor(
        np.linalg.inv(sc + 1e-8 * scale * np.eye(sc.shape[0])), dtype=dtype,
        device=dev)
    sdinv = torch.where(op.diag != 0, 1.0 / op.diag, torch.ones_like(op.diag))
    lam = TS.estimate_lam_max(lambda v: TP.ell_matvec(op, v), sdinv,
                              space.n_p1, dtype)
    return op, plan, sc_inv, lam


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["shared", "device"])
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("kind", ["pre", "mid", "post"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_vcycle_sweeps_match_plain_on_cuda(cuda, space, dtype, kind, k,
                                           path):
    """Each sweep (csrc/vcycle.cu) writes its plain version's bits into
    every buffer and touches no other, on the operator in shared memory
    and in device memory, on repeat and on a right-hand side at an odd
    offset; one launch a call, none of the plain stages; every CTA's
    progress word at the barriers the launches passed."""
    op = _vcycle_parts(space, cuda, dtype)[0]
    sp = VC.plan(op, path)
    assert sp.path == path and (sp.smem > 0) == (path == "shared")
    ex = VC.example(op, np.random.default_rng(27), k=k, agg=16)
    flat = torch.as_tensor(np.random.default_rng(28).standard_normal(
        op.n + 1), dtype=dtype, device=cuda)
    for r in (None, flat[1:]):
        VC.COUNTS.reset()
        got = VC.run_case(kind, op, ex, sp, r=r)
        again = VC.run_case(kind, op, ex, sp, r=r)
        torch.cuda.synchronize()
        assert getattr(VC.COUNTS, kind) == 2
        assert VC.COUNTS.plain_cuda_calls == 0
        want = VC.run_case(kind, op, ex, plain=True, r=r)
        for name in VC.BUFFERS:
            assert torch.equal(got[name], want[name]), name
            assert torch.equal(again[name], got[name]), name
    barriers = {"pre": k, "mid": 2 * k, "post": k - 1}[kind]
    assert bool((sp.flags == 4 * barriers).all())
    VC.COUNTS.reset()


@pytest.fixture(scope="module")
def space_fine():
    """The cylinder channel at h=0.025: 2,707 P1 rows, 85 slices."""
    return TaylorHoodSpace(channel_with_cylinder_2d(h=0.025))


@pytest.fixture(scope="module")
def space_finer():
    """The cylinder channel at h=0.011: 13,231 P1 rows, 414 slices."""
    return TaylorHoodSpace(channel_with_cylinder_2d(h=0.011))


def _few_sms_plan(op, path, sms):
    """``vcycle.plan`` as if the card had ``sms`` SMs: a small operator's
    warps then take several slices each (rounds 0 past four)."""
    card = VC.card_query(op)
    query = lambda *a: dict(card(*a), sms=sms)
    return VC.attach(op, VC.choose(op.mat.slice_ptr.cpu().numpy().astype(
        np.int64), op.vals.element_size(), query, path))


@pytest.mark.cuda
@pytest.mark.parametrize("sms,rounds", [(1, 4), (2, 2), (3, 1)])
@pytest.mark.parametrize("kind", ["pre", "mid", "post"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_vcycle_sweeps_on_few_ctas_match_plain_on_cuda(cuda, space_fine,
                                                       dtype, kind, sms,
                                                       rounds):
    """On a grid spread over ``sms`` SMs, so that a warp takes ``rounds``
    slices (the kernels for operators of more slices than the card has
    warps), each sweep writes its plain version's bits on both paths."""
    op = _vcycle_parts(space_fine, cuda, dtype)[0]
    ex = VC.example(op, np.random.default_rng(33), k=3, agg=16)
    want = VC.run_case(kind, op, ex, plain=True)
    for path in ("shared", "device"):
        sp = _few_sms_plan(op, path, sms)
        assert (sp.grid, sp.rounds, sp.path) == (sms, rounds, path)
        got = VC.run_case(kind, op, ex, sp)
        again = VC.run_case(kind, op, ex, sp)
        torch.cuda.synchronize()
        for name in VC.BUFFERS:
            assert torch.equal(got[name], want[name]), (path, name)
            assert torch.equal(again[name], got[name]), (path, name)
    VC.COUNTS.reset()


@pytest.mark.cuda
@pytest.mark.parametrize("sms", [1, 3])
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("kind", ["pre", "mid", "post"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_vcycle_sweeps_past_the_register_rounds_match_plain_on_cuda(
        cuda, space_finer, dtype, kind, k, sms):
    """Where a CTA holds more than 4 x 32 slices (414 slices on one or
    three CTAs), the plan takes rounds 0: each warp runs its slices one
    after another with r0 and d in the plan's state vector, and each sweep
    writes its plain version's bits in every buffer, on repeat and at an
    odd offset; the whole V-cycle on that plan equals the plain cycle."""
    from navierstokes_tpu_torch.solvers import schur as TS
    op, plan, sc_inv, lam = _vcycle_parts(space_finer, cuda, dtype)
    sp = _few_sms_plan(op, None, sms)
    assert (sp.grid, sp.rounds, sp.path) == (sms, 0, "device")
    assert sp.slices > 4 * 32 and sp.state.shape == (2 * op.n,)
    ex = VC.example(op, np.random.default_rng(34), k=k, agg=16)
    flat = torch.as_tensor(np.random.default_rng(35).standard_normal(
        op.n + 1), dtype=dtype, device=cuda)
    for r in (None, flat[1:]):
        VC.COUNTS.reset()
        got = VC.run_case(kind, op, ex, sp, r=r)
        again = VC.run_case(kind, op, ex, sp, r=r)
        torch.cuda.synchronize()
        assert getattr(VC.COUNTS, kind) == 2
        want = VC.run_case(kind, op, ex, plain=True, r=r)
        for name in VC.BUFFERS:
            assert torch.equal(got[name], want[name]), name
            assert torch.equal(again[name], got[name]), name
    if kind == "mid":
        fused = TS.FusedVcycle(op, op.diag, plan, sc_inv, lam, 2, k)
        fused.sweep_plan = sp
        plain = TS.make_vcycle_solver(lambda v: TP.ell_matvec(op, v),
                                      op.diag, plan, sc_inv, n_cycles=2,
                                      smooth_k=k, lam_max=lam)
        r = flat[:op.n].clone()
        assert torch.equal(fused(r), plain(r))
    VC.COUNTS.reset()


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["shared", "device"])
@pytest.mark.parametrize("n_cycles,k", [(1, 3), (2, 3), (2, 2), (1, 1)])
@pytest.mark.parametrize("pinned", [True, False], ids=["pinned", "unpinned"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fused_vcycle_equals_plain_on_cuda(cuda, space, dtype, pinned,
                                           n_cycles, k, path):
    """The fused V-cycle (solvers/schur.FusedVcycle) equals the plain
    cycle on the card bit for bit, on either operator path, on a
    right-hand side that is a view at an odd offset too, with
    ``launches(n_cycles, k)[0]`` sweep launches a solve and no plain
    stage."""
    from navierstokes_tpu_torch.solvers import schur as TS
    op, plan, sc_inv, lam = _vcycle_parts(space, cuda, dtype, pinned)
    plain = TS.make_vcycle_solver(lambda v: TP.ell_matvec(op, v), op.diag,
                                  plan, sc_inv, n_cycles=n_cycles,
                                  smooth_k=k, lam_max=lam)
    built = TS.make_vcycle_solver(lambda v: TP.ell_matvec(op, v), op.diag,
                                  plan, sc_inv, n_cycles=n_cycles,
                                  smooth_k=k, lam_max=lam, op=op)
    assert isinstance(built, TS.FusedVcycle)
    fused = TS.FusedVcycle(op, op.diag, plan, sc_inv, lam, n_cycles, k)
    fused.sweep_plan = VC.plan(op, path)
    assert fused.sweep_plan.path == path
    rng = np.random.default_rng(28)
    flat = torch.as_tensor(rng.standard_normal(op.n + 3), dtype=dtype,
                           device=cuda)
    for r in (flat[:op.n].clone(), flat[3:]):
        VC.COUNTS.reset()
        got = fused(r)
        torch.cuda.synchronize()
        assert (VC.COUNTS.pre, VC.COUNTS.mid, VC.COUNTS.post) == (
            1, n_cycles - 1, 1)
        assert VC.COUNTS.pre + VC.COUNTS.mid + VC.COUNTS.post \
            == VC.launches(n_cycles, k)[0]
        assert VC.COUNTS.plain_cuda_calls == 0
        want = plain(r)
        assert torch.equal(got, want)
        assert torch.equal(built(r), want)


@pytest.mark.cuda
@pytest.mark.parametrize("n_cycles", [1, 2])
def test_fused_vcycle_captured_equals_eager_on_cuda(cuda, space, n_cycles):
    """One fused V-cycle captured in a CUDA graph (its sweeps under
    programmatic dependent launch, their barriers replayed) and
    replayed on new right-hand sides equals the eager call bit for bit;
    the record adds each sweep launch once per replay."""
    from navierstokes_tpu_torch.kernels.launches import record_launches
    from navierstokes_tpu_torch.solvers import schur as TS
    op, plan, sc_inv, lam = _vcycle_parts(space, cuda, torch.float32)
    fused = TS.FusedVcycle(op, op.diag, plan, sc_inv, lam, n_cycles, 3)
    rng = np.random.default_rng(29)
    r = torch.as_tensor(rng.standard_normal(op.n), dtype=torch.float32,
                        device=cuda)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fused(r)
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with record_launches() as rec, torch.cuda.graph(g):
        out = fused(r)
    assert len(rec.launches) == VC.launches(n_cycles, 3)[0]
    for seed in (30, 31):
        r.copy_(torch.as_tensor(np.random.default_rng(seed).standard_normal(
            op.n), dtype=torch.float32))
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, fused(r.clone()))
    VC.COUNTS.reset()
    rec.replay(3)
    assert (VC.COUNTS.pre, VC.COUNTS.mid, VC.COUNTS.post) == (
        3, 3 * (n_cycles - 1), 3)


@pytest.mark.cuda
def test_vcycle_refuses_what_the_kernel_does_not_take(cuda, space):
    op = _vcycle_parts(space, cuda, torch.float32)[0]
    sp = VC.plan(op)
    ex = VC.example(op, np.random.default_rng(32), agg=16)
    bad = dataclasses.replace(op, vals=op.vals.to(torch.bfloat16))
    with pytest.raises(TypeError):
        VC.run_case("pre", bad, ex, sp)
    with pytest.raises(TypeError):
        VC.plan(bad)
    with pytest.raises(TypeError):
        VC.run_case("pre", op, dict(ex, r=ex["r"].double()), sp)
    with pytest.raises(ValueError):
        VC.run_case("mid", op, dict(ex, y=ex["y"].cpu()), sp)
    with pytest.raises(ValueError):
        VC.run_case("post", op, dict(ex, y=ex["y"][:2]), sp)
    with pytest.raises(ValueError, match="plan"):
        VC.run_case("pre", op, ex, None)
    b = {name: ex[name].clone() for name in VC.BUFFERS}
    with pytest.raises(ValueError, match="shares memory"):
        VC.run_case("pre", op, ex, sp, into=b, r=b["z0"])


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["projection", "monolithic"])
def test_steps_run_the_fused_vcycle_on_cuda(cuda, tmp_path, scheme):
    """The projection step's Poisson CG and the monolithic ``cc`` Ap solve
    run the fused V-cycle, captured and eager, with the same launches:
    per projection step one V-cycle (a pre and a post sweep) per CG
    iteration and one for CG's set-up; per monolithic V-cycle a pre, a
    post and schur_vcycles - 1 mid sweeps."""
    runs = []
    for mode in ("eager", "captured"):
        ns = _small_model(tmp_path / mode, scheme=scheme)
        if mode == "captured":
            ns.capture_graphs()         # its warm-up step runs eagerly
        VC.COUNTS.reset()
        ms = [ns.solve_time_step(_eager=mode == "eager") for _ in range(3)]
        torch.cuda.synchronize()
        runs.append((dataclasses.asdict(VC.COUNTS), ms, ns._u.clone()))
    (c_e, ms_e, u_e), (c_g, ms_g, u_g) = runs
    assert c_e == c_g and c_e["plain_cuda_calls"] == 0
    assert torch.equal(u_e, u_g)
    assert c_e["pre"] == c_e["post"] > 0
    if scheme == "projection":
        assert c_e["pre"] == sum(m.p_iterations + 1 for m in ms_e)
        assert c_e["mid"] == 0
    else:
        assert c_e["mid"] == (ns.config.schur_vcycles - 1) * c_e["pre"]


# the block-Jacobi tile rebuild (kernels/bj_tiles.py, csrc/bj_tiles.cu):
# every kernel gives its plain version's bits


def _same_bits(a, b):
    """Equal dtype, shape and strides, NaN at the same places, the same
    bits everywhere else (a NaN's payload is not compared)."""
    if a.dtype != b.dtype or a.shape != b.shape or a.stride() != b.stride():
        return False
    na, nb = torch.isnan(a), torch.isnan(b)
    ia, ib = (t.masked_fill(n, 0).contiguous().view(
        {2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])
        for t, n in ((a, na), (b, nb)))
    return torch.equal(na, nb) and torch.equal(ia, ib)


def _bjt_plan(dev, sb, n_tiles=3, seed=4):
    """A plan over a seeded F pattern of n_p2 nodes with a tail tile: the
    diagonal and couplings inside and across tiles, slots shuffled; the
    F values with -0 and NaN among the tiles' values, a mask with about
    15% of the rows constrained."""
    import types
    rng = np.random.default_rng(seed)
    n_p2 = (n_tiles - 1) * sb + sb // 2 + 3
    k = int(0.08 * n_p2 * sb)
    r = rng.integers(0, n_p2, k)
    c = np.clip(r + rng.integers(-sb, sb, k), 0, n_p2 - 1)
    pairs = sorted({(i, i) for i in range(n_p2)} | set(zip(r.tolist(),
                                                           c.tolist())))
    rows, cols = map(np.array, zip(*pairs))
    slots = rng.permutation(len(rows))
    f = types.SimpleNamespace(nz_row=rows, nz_col=cols, nz_slot=slots)
    plan = TP.build_block_jacobi_plan(f, 1, n_p2, sb, dev)
    v = rng.standard_normal(len(rows))
    on = plan.src.cpu().numpy()
    v[rng.choice(on, 40, replace=False)] = -0.0
    v[rng.choice(on, 6, replace=False)] = np.nan
    mask = (rng.uniform(size=n_p2) > 0.15).astype(np.float64)
    return plan, v, mask


@pytest.mark.cuda
@pytest.mark.parametrize("sb", [64, 128, 256, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bj_tiles_kernel_matches_plain_on_cuda(cuda, dtype, sb):
    """The tiles kernel equals its plain version (the stock chain) bit for
    bit, NaN and masked -0 included, in fp32 and fp64 F values; one
    launch counted, no plain call; a repeat is bit-identical."""
    from navierstokes_tpu_torch.kernels import bj_tiles as BT
    plan, v, mask = _bjt_plan(cuda, sb)
    vals = torch.as_tensor(v, dtype=dtype, device=cuda)
    m = torch.as_tensor(mask, dtype=dtype, device=cuda)
    sigma = torch.tensor(3.25, dtype=dtype, device=cuda)
    BT.COUNTS.reset()
    t = BT.tiles(plan, vals, m, sigma)
    t2 = BT.tiles(plan, vals, m, sigma)
    assert BT.COUNTS.by_variant == {("tiles", dtype): 2}
    assert BT.COUNTS.plain_cuda_calls == 0
    want = BT.tiles_plain(plan, vals, m, sigma)
    torch.cuda.synchronize()
    assert _same_bits(t, want) and _same_bits(t, t2)
    assert bool(torch.isnan(t).any())


def _bjg_stacks(sb, n, seed, dev, a_col=False, b_col=True):
    """Seeded operand stacks as the rebuild gives them: A near a scaled
    identity plus N(0, 1) / sqrt(SB), B an approximate inverse (fp32), each
    in the layout asked (True: column-major tiles)."""
    rng = np.random.default_rng(seed)
    a = (np.eye(sb)[None] * (4.0 + rng.uniform(size=(n, sb, 1)))
         + rng.standard_normal((n, sb, sb)) / np.sqrt(sb))
    b = np.linalg.inv(a) + 1e-3 * rng.standard_normal((n, sb, sb))

    def put(v, col):
        t = torch.as_tensor(v, dtype=torch.float32, device=dev)
        return t.transpose(1, 2).contiguous().transpose(1, 2) if col else t

    return put(a, a_col), put(b, b_col)


@pytest.mark.cuda
@pytest.mark.parametrize("sb", [64, 128, 256, 512])
@pytest.mark.parametrize("n", [1, 7])
@pytest.mark.parametrize("a_col", [False, True])
@pytest.mark.parametrize("b_col", [False, True])
def test_bj_gemm_epilogues_match_plain_on_cuda(cuda, sb, n, a_col, b_col):
    """Every epilogue of csrc/bj_gemm.cu equals its plain version
    (torch.matmul, then bj_tiles.guard_plain / update_plain) bit for bit,
    for both layouts of both operands: the product; A X0 and the guard's
    norm; the update in X's layout; the last update in fp32, bf16 and fp64,
    allocated and into a slot of a larger buffer (strided tiles and rows).
    The plain version runs on a batch of 7 tiles: at one tile cuBLAS takes
    a split-K kernel whose sums differ from its own batched kernel's, which
    the rebuild's stacks get (and the GEMM gives at every batch).  One
    launch a call counted by epilogue, no plain call from the wrappers."""
    from navierstokes_tpu_torch.kernels import bj_gemm as BG
    from navierstokes_tpu_torch.kernels import bj_tiles as BT
    a7, b7 = _bjg_stacks(sb, 7, sb + 2 * a_col + b_col, cuda, a_col, b_col)
    a, b = a7[:n], b7[:n]
    BG.COUNTS.reset()
    BT.COUNTS.reset()
    c = BG.product(a, b)
    ax, norm = BG.guard(a, b)
    y = BG.update(a, b)
    lasts = {dt: BG.update(a, b, out_dtype=dt)
             for dt in (torch.float32, torch.bfloat16, torch.float64)}
    slots = {}
    for dt in lasts:
        big = torch.full((n, sb + 4, sb + 8), 7.0, dtype=dt, device=cuda)
        slot = big[:, 2:2 + sb, :sb]
        assert BG.update(a, b, out=slot) is slot
        slots[dt] = big
    assert BG.COUNTS.by_variant == {
        ("product", torch.float32): 1, ("guard", torch.float32): 1,
        ("update", torch.float32): 1, ("update_last", torch.float32): 2,
        ("update_last", torch.bfloat16): 2, ("update_last", torch.float64): 2}
    assert BG.COUNTS.plain_cuda_calls == 0
    assert BT.COUNTS.by_variant == {("guard_max", torch.float32): 1}
    want_ax = BG.product_plain(a7, b7)[:n]
    assert _same_bits(c, want_ax) and _same_bits(ax, want_ax)
    assert norm.shape == () and _same_bits(norm, BT.guard_plain(want_ax))
    assert _same_bits(y, BG.update_product_plain(a7, b7)[:n])
    assert BT.layout(y) is a_col
    p7 = torch.matmul(a7, b7)
    for dt, got in lasts.items():
        want = BT.update_plain(a, p7[:n], out_dtype=dt)
        assert _same_bits(got, want)
        big = slots[dt]
        assert _same_bits(big[:, 2:2 + sb, :sb].contiguous(), want)
        rest = big.clone()
        rest[:, 2:2 + sb, :sb] = 7.0
        assert bool((rest == 7.0).all())
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 132, 1760])
def test_bj_gemm_batch_independent_on_cuda(cuda, n):
    """At the bench tiles (256) a tile's product does not depend on the
    batch: the first tile alone equals the batch's first, in every
    epilogue; from 7 tiles on (cuBLAS's batched kernel) each epilogue
    equals its plain version bit for bit."""
    from navierstokes_tpu_torch.kernels import bj_gemm as BG
    a, x = _bjg_stacks(256, n, n, cuda)
    c = BG.product(a, x)
    ax, norm = BG.guard(a, x)
    y = BG.update(x, ax)
    if n >= 7:
        assert _same_bits(c, BG.product_plain(a, x))
        assert _same_bits(norm, BG.guard_product_plain(a, x)[1])
        assert _same_bits(y, BG.update_product_plain(x, ax))
    assert _same_bits(BG.product(a[:1], x[:1]), c[:1])
    assert _same_bits(BG.guard(a[:1], x[:1])[0], ax[:1])
    assert _same_bits(BG.update(x[:1], ax[:1]), y[:1])
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("sb", [64, 256])
def test_bj_gemm_zero_sums_on_cuda(cuda, sb):
    """Sums whose products are all zeros, -0 among them (a zero row of A
    against a negative X, a -0 column of X), and sums whose every product
    underflows below the smallest denormal on the negative side (a row of
    1e-30 against a column of -1e-30) come out +0, as cuBLAS's do: the
    GEMM adds a +0 to every sum at the end.  Every epilogue keeps its
    plain version's bits, the sign of zero included."""
    from navierstokes_tpu_torch.kernels import bj_gemm as BG
    a, x = _bjg_stacks(sb, 7, 5 * sb, cuda, False, False)
    a[:, 3, :] = 0.0
    a[:, 9, : sb // 2] = -0.0
    x[:, :, 5] = -x[:, :, 5].abs()
    x[:, :, 11] = -0.0
    a[:, 13, :] = 1e-30
    x[:, :, 7] = -1e-30
    c = BG.product(a, x)
    want = BG.product_plain(a, x)
    torch.cuda.synchronize()
    assert _same_bits(c, want)
    assert float(c[0, 13, 7]) == 0.0
    assert not bool(torch.signbit(c[:, 3, 5]).any())
    assert not bool(torch.signbit(c[:, 13, 7]).any())
    assert _same_bits(BG.update(x, c), BG.update_product_plain(x, c))
    assert _same_bits(BG.guard(a, x)[0], want)


@pytest.mark.cuda
@pytest.mark.parametrize("sb", [64, 128, 256, 512])
def test_bj_gemm_guard_propagates_nan_on_cuda(cuda, sb):
    """A NaN in one tile of A makes the guard's norm NaN, as its plain
    version's, whichever CTA holds it; the partials given are reused, one
    a CTA of the kernel's grid (the wrapper's mirror of its tiling)."""
    from navierstokes_tpu_torch.kernels import bj_gemm as BG
    from navierstokes_tpu_torch.kernels.build import library
    assert BG.ctas(7, sb) == library().nst_bj_gemm_ctas(sb, 7)
    a, x = _bjg_stacks(sb, 7, 3 * sb, cuda)
    parts = BG.guard_partials(7, sb, cuda)
    clean = BG.guard(a, x, parts)[1]
    a[3, sb - 1, 2] = float("nan")
    ax, norm = BG.guard(a, x, parts)
    want_ax, want = BG.guard_product_plain(a, x)
    torch.cuda.synchronize()
    assert not bool(torch.isnan(clean)) and bool(torch.isnan(norm))
    assert _same_bits(norm, want) and _same_bits(ax, want_ax)


@pytest.mark.cuda
def test_bj_rebuild_captured_equals_eager_on_cuda(cuda):
    """The rebuild (tiles, A X0 and the guard, 3 Newton-Schulz updates with
    the products between them, the last into a static buffer) captured in
    a CUDA graph equals the eager calls bit for bit, and a replay adds the
    graph's recorded launches to the counts."""
    from navierstokes_tpu_torch.kernels import bj_gemm as BG
    from navierstokes_tpu_torch.kernels import bj_tiles as BT
    from navierstokes_tpu_torch.kernels.launches import record_launches
    sb = 256
    plan, v, mask = _bjt_plan(cuda, sb, seed=9)
    v = np.nan_to_num(v)
    vals = torch.as_tensor(v, dtype=torch.float32, device=cuda)
    m = torch.as_tensor(mask, dtype=torch.float32, device=cuda)
    sigma = torch.tensor(3.25, device=cuda)
    a0 = TP.block_jacobi_tiles(plan, vals, m, sigma)
    x0 = torch.linalg.inv(a0)          # column-major, as the model's seed
    vals = vals * 1.001
    buf = torch.empty((plan.n_tiles, sb, sb), device=cuda)

    def rebuild(out):
        g = TP.block_jacobi_guard([(plan, vals, m, sigma, x0)], 3)
        TP.block_jacobi_newton(g, 3, out=[out])
        return g.norm

    eager = torch.empty_like(buf)
    norm_e = rebuild(eager)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        rebuild(buf)
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with record_launches() as rec, torch.cuda.graph(graph):
        norm_g = rebuild(buf)
    buf.zero_()
    BT.COUNTS.reset()
    BG.COUNTS.reset()
    graph.replay()
    rec.replay()
    torch.cuda.synchronize()
    assert float(norm_e) < TP.GUARD_LIMIT
    assert _same_bits(norm_g, norm_e) and _same_bits(buf, eager)
    assert BT.COUNTS.by_variant == {("tiles", torch.float32): 1,
                                    ("guard_max", torch.float32): 1}
    assert BG.COUNTS.by_variant == {
        ("guard", torch.float32): 1, ("update", torch.float32): 2,
        ("product", torch.float32): 2, ("update_last", torch.float32): 1}
    assert BT.COUNTS.plain_cuda_calls == BG.COUNTS.plain_cuda_calls == 0


@pytest.mark.cuda
def test_bj_rebuild_kernels_refuse_what_they_do_not_take(cuda):
    from navierstokes_tpu_torch.kernels import bj_gemm as BG
    from navierstokes_tpu_torch.kernels import bj_tiles as BT
    plan, v, mask = _bjt_plan(cuda, 64)
    vals = torch.as_tensor(v, dtype=torch.float32, device=cuda)
    with pytest.raises(TypeError, match="mask"):
        BT.tiles(plan, vals, torch.as_tensor(mask, device=cuda), 1.0)
    ax = torch.zeros(2, 64, 64, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        BG.guard(ax.double(), ax.double())
    big = torch.zeros(2, 96, 96, device=cuda)
    with pytest.raises(ValueError, match="no instantiation"):
        BG.product(big, big)
    wide = torch.zeros(2, 64, 128, device=cuda)[:, :, :64]
    with pytest.raises(ValueError, match="row- or column-major"):
        BG.update(wide, wide)
    with pytest.raises(ValueError, match="row-major"):
        BG.update(ax, ax, out=torch.empty_like(ax).transpose(1, 2))
    with pytest.raises(ValueError, match="operands on"):
        BG.product(ax, ax.cpu())
    with pytest.raises(ValueError, match="partials"):
        BG.guard(ax, ax, torch.empty(1, device=cuda))
    with pytest.raises(ValueError, match="partials"):
        BT.guard_max(torch.empty(0, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("fields", [
    dict(scheme="projection"), dict(scheme="projection", bj_newton=0),
    dict(scheme="projection", bj_bf16=True),
    dict(scheme="monolithic"), dict(scheme="monolithic", inner_bf16=True)])
def test_steps_rebuild_tiles_through_the_kernels_on_cuda(cuda, tmp_path,
                                                         fields):
    """Captured and eager steps rebuild their tiles through the kernels
    with the same launches per step: one tiles launch, and with a seed the
    GEMM's guard epilogue and its max and, on each Newton-Schulz step,
    bj_newton - 1 updates and as many products and one last update in the
    tiles' dtype; no plain call; equal bits and the same branch per
    step."""
    from navierstokes_tpu_torch.kernels import bj_gemm as BG
    from navierstokes_tpu_torch.kernels import bj_tiles as BT
    runs = []
    for mode in ("eager", "captured"):
        ns = _small_model(tmp_path / mode, **fields)
        if mode == "captured":
            ns.capture_graphs()
        ns._bj_seed()       # the static seed (one more tiles launch), once
        BT.COUNTS.reset()
        BG.COUNTS.reset()
        ms = [ns.solve_time_step(_eager=mode == "eager") for _ in range(3)]
        torch.cuda.synchronize()
        runs.append(({**BT.COUNTS.by_variant, **BG.COUNTS.by_variant},
                     BT.COUNTS.plain_cuda_calls + BG.COUNTS.plain_cuda_calls,
                     [m.exact_inverse for m in ms], ns._u.clone()))
    (c_e, pl_e, ex_e, u_e), (c_g, pl_g, ex_g, u_g) = runs
    assert c_e == c_g and pl_e == pl_g == 0 and ex_e == ex_g
    assert torch.equal(u_e, u_g)
    iters = 0 if fields.get("bj_newton") == 0 else 3
    newton = sum(not e for e in ex_e)
    want_dt = (torch.bfloat16 if fields.get("bj_bf16")
               or fields.get("inner_bf16") else torch.float32)
    want = {("tiles", torch.float32): 3}
    if iters:
        want.update({("guard", torch.float32): 3,
                     ("guard_max", torch.float32): 3})
    if newton:
        want.update({("update", torch.float32): (iters - 1) * newton,
                     ("product", torch.float32): (iters - 1) * newton,
                     ("update_last", want_dt): newton})
    assert c_e == want


# the block-Jacobi exact tile inverse (kernels/bj_inverse.py,
# csrc/bj_inverse.cu): the kernel gives its plain version's bits


def _bji_tiles(sb, n, seed, dev):
    rng = np.random.default_rng(seed)
    t = (np.eye(sb)[None] * (2.0 + rng.uniform(size=(n, sb, 1)))
         + rng.standard_normal((n, sb, sb)) / np.sqrt(sb))
    return torch.as_tensor(t, dtype=torch.float32, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("sb", [64, 128, 256, 512])
def test_bj_inverse_kernel_matches_plain_on_cuda(cuda, sb):
    """The kernel equals inverse_plain bit for bit (a NaN tile among
    them) in fp32, bf16 and fp64, allocated and into a slot of a larger
    buffer; a one-tile batch equals the batch's first tile; one launch per
    call counted by output dtype, no plain call."""
    from navierstokes_tpu_torch.kernels import bj_inverse as BI
    a = _bji_tiles(sb, 9, sb, cuda)
    a[4, 3, 7] = float("nan")
    BI.COUNTS.reset()
    x = BI.inverse(a)
    want = BI.inverse_plain(a)
    assert _same_bits(x, want) and bool(torch.isnan(x[4]).all())
    for dt in (torch.bfloat16, torch.float64):
        assert _same_bits(BI.inverse(a, out_dtype=dt), want.to(dt))
        big = torch.full((9, sb, sb + 8), 7.0, dtype=dt, device=cuda)
        slot = big[:, :, :sb]
        assert BI.inverse(a, out=slot) is slot
        assert _same_bits(slot.contiguous(), want.to(dt))
        assert bool((big[:, :, sb:] == 7).all())
    assert _same_bits(BI.inverse(a[:1]), x[:1])
    torch.cuda.synchronize()
    assert BI.COUNTS.by_dtype == {torch.float32: 2, torch.bfloat16: 2,
                                  torch.float64: 2}
    assert BI.COUNTS.plain_cuda_calls == 1


@pytest.mark.cuda
def test_bj_inverse_edge_tiles_on_cuda(cuda):
    """Tiles that need row swaps, a zero leading entry, a singular tile and
    tied pivots (Hadamard blocks) give the plain version's bits; the
    singular tile comes out non-finite, the others finite."""
    from navierstokes_tpu_torch.kernels import bj_inverse as BI
    rng = np.random.default_rng(22)
    sb = 256
    swaps = rng.standard_normal((sb, sb))
    zero = np.eye(sb) * 3.0 + rng.standard_normal((sb, sb)) / 16
    zero[0, 0] = 0.0
    singular = np.eye(sb) * 3.0 + rng.standard_normal((sb, sb)) / 16
    singular[:, 50] = 0.0
    h = np.ones((1, 1))
    while h.shape[0] < 16:
        h = np.block([[h, h], [h, -h]])
    ties = np.kron(np.eye(sb // 16), h)[rng.permutation(sb)]
    a = torch.as_tensor(np.stack([swaps, zero, singular, ties]),
                        dtype=torch.float32, device=cuda)
    x = BI.inverse(a)
    assert _same_bits(x, BI.inverse_plain(a))
    assert not bool(torch.isfinite(x[2]).all())
    assert bool(torch.isfinite(x[[0, 1, 3]]).all())
    eye = torch.eye(sb, dtype=torch.float64, device=cuda)
    assert float((eye - a[3].double() @ x[3].double()).abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("sb", [128, 256, 512])
def test_bj_inverse_look_ahead_pivots_on_cuda(cuda, sb):
    """Tiles with no diagonal dominance (N(0, 1) entries): panels' first
    columns pivot on rows other than their own, rows whose columns of that
    panel the look-ahead has just updated; the kernel gives the plain
    version's bits, in a batch of 7 and for one tile alone."""
    from navierstokes_tpu_torch.kernels import bj_inverse as BI
    rng = np.random.default_rng(sb + 23)
    a = torch.as_tensor(rng.standard_normal((7, sb, sb)),
                        dtype=torch.float32, device=cuda)
    x = BI.inverse(a)
    want, perm = BI.gauss_jordan_plain(a)
    assert _same_bits(x, want)
    firsts = torch.arange(16, sb, 16, device=cuda)
    assert bool((perm[:, firsts] != firsts).any(dim=1).all())
    assert _same_bits(BI.inverse(a[3:4]), x[3:4])


@pytest.mark.cuda
def test_bj_inverse_refuses_what_it_does_not_take(cuda):
    from navierstokes_tpu_torch.kernels import bj_inverse as BI
    with pytest.raises(ValueError, match="no instantiation"):
        BI.inverse(torch.zeros(2, 96, 96, device=cuda))
    with pytest.raises(TypeError, match="float32"):
        BI.inverse(torch.zeros(2, 64, 64, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        BI.inverse(torch.zeros(2, 64, 64, device=cuda).transpose(1, 2))
    with pytest.raises(ValueError, match="out"):
        BI.inverse(torch.zeros(2, 64, 64, device=cuda),
                   out=torch.empty(2, 64, 64))


@pytest.mark.cuda
def test_bj_exact_segment_captured_equals_eager_on_cuda(cuda):
    """ops/p1ell.block_jacobi_exact into a static buffer (segment b_exact
    of the captured step) captured in a CUDA graph equals the eager call
    bit for bit, in fp32 and bf16 tiles, and a replay adds its one
    launch."""
    from navierstokes_tpu_torch.kernels import bj_inverse as BI
    from navierstokes_tpu_torch.kernels.launches import record_launches
    a = _bji_tiles(256, 6, 3, cuda)
    for dt in (torch.float32, torch.bfloat16):
        g = TP.BjGuard(tiles=[a], xs=[], axs=[], norm=None, out_dtype=dt)
        eager = TP.block_jacobi_exact(g)[0]
        buf = torch.empty(a.shape, dtype=dt, device=cuda)
        s = torch.cuda.Stream()
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            TP.block_jacobi_exact(g, out=[buf])
        torch.cuda.current_stream().wait_stream(s)
        graph = torch.cuda.CUDAGraph()
        with record_launches() as rec, torch.cuda.graph(graph):
            TP.block_jacobi_exact(g, out=[buf])
        buf.zero_()
        BI.COUNTS.reset()
        graph.replay()
        rec.replay()
        torch.cuda.synchronize()
        assert _same_bits(buf, eager)
        assert BI.COUNTS.by_dtype == {dt: 1}
        assert BI.COUNTS.plain_cuda_calls == 0


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["projection", "monolithic"])
def test_exact_steps_invert_through_the_kernel_on_cuda(cuda, tmp_path,
                                                      scheme):
    """With bj_newton=0 every step takes the exact branch: captured and
    eager steps of the small fixture launch the inverse kernel once a step
    and give the same bits."""
    from navierstokes_tpu_torch.kernels import bj_inverse as BI
    runs = []
    for mode in ("eager", "captured"):
        ns = _small_model(tmp_path / mode, scheme=scheme, bj_newton=0)
        if mode == "captured":
            ns.capture_graphs()
        BI.COUNTS.reset()
        ms = [ns.solve_time_step(_eager=mode == "eager") for _ in range(3)]
        torch.cuda.synchronize()
        assert all(m.exact_inverse for m in ms)
        runs.append((dict(BI.COUNTS.by_dtype), BI.COUNTS.plain_cuda_calls,
                     [(m.iterations, m.cd, m.cl) for m in ms],
                     ns._u.clone(), ns._p.clone()))
    (c_e, pl_e, m_e, u_e, p_e), (c_g, pl_g, m_g, u_g, p_g) = runs
    assert c_e == c_g == {torch.float32: 3} and pl_e == pl_g == 0
    assert m_e == m_g and torch.equal(u_e, u_g) and torch.equal(p_e, p_g)


@pytest.mark.cuda
def test_row_shards_equal_one_device_on_exact_steps_on_cuda(cuda, tmp_path):
    """Two row shards on cuda:0 with bj_newton=0 (every step exact) step
    bit for bit like one device: each shard's tiles inverted by its own
    launch of the kernel, which a tile's batch does not move."""
    from navierstokes_tpu_torch.kernels import bj_inverse as BI
    from navierstokes_tpu_torch.models.navier_stokes import NavierStokes
    runs = []
    for k, devs in ((1, None), (2, ["cuda:0"] * 2)):
        cfg = SolverConfig(dtype="float32", n_devices=k, bj_newton=0,
                           output_dir=str(tmp_path / f"out{k}"),
                           cache_dir=str(tmp_path / f"cache{k}"),
                           csv_path=str(tmp_path / f"forces{k}.csv"))
        ns = NavierStokes(channel_with_cylinder_2d(h=0.12), 2, 1,
                          deltat=0.01, T=0.03, step=3, device="cuda",
                          config=cfg, shard_devices=devs,
                          inlet=InletConfig(kind="parabolic", u_m=0.3,
                                            height=0.41))
        ns.set_re_number(20)
        ns.setup()
        BI.COUNTS.reset()
        ms = [ns.solve_time_step(_eager=True) for _ in range(3)]
        torch.cuda.synchronize()
        assert BI.COUNTS.launches == 3 * k
        assert BI.COUNTS.plain_cuda_calls == 0
        runs.append((ns, [(m.iterations, m.cd, m.cl) for m in ms]))
    (one, m1), (sh, m2) = runs
    assert m1 == m2
    assert torch.equal(sh._u, one._u) and torch.equal(sh._p, one._p)
