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
and a change of ``config.scheme`` after setup, captured against eager.
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
    the kernel per shard."""
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
        ms = [ns.solve_time_step() for _ in range(3)]
        assert K.COUNTS.launches > 0 and K.COUNTS.plain_cuda_calls == 0
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
    ("bj_bf16", dict(bj_bf16=True)), ("forcing", dict(forcing=_forcing))])
def test_captured_steps_equal_eager_on_cuda(cuda, tmp_path, case, fields):
    """5 projection steps replayed from the captured CUDA graphs equal 5
    plain (eager) steps bit for bit, with the same counts; no replay
    synchronises (set_sync_debug_mode("error") around each)."""
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
    for a, b in zip(me, mg):
        assert (a.cd, a.cl, a.f_iterations, a.p_iterations, a.converged) \
            == (b.cd, b.cl, b.f_iterations, b.p_iterations, b.converged)


@pytest.mark.cuda
@pytest.mark.parametrize("case,fields", [
    ("cc", {}), ("cc+refine=2", dict(refine=2, refine_tol=1e-3)),
    ("asimple restart=8", dict(preconditioner="asimple", outer_restart=8)),
    ("ayosida", dict(preconditioner="ayosida")),
    ("pcd", dict(preconditioner="pcd")),
    ("identity", dict(preconditioner="identity", outer_maxiter=60)),
    ("cc+inner_bf16", dict(inner_bf16=True)),
    ("cc diag", dict(f_precond="diag"))])
def test_captured_monolithic_steps_equal_eager_on_cuda(cuda, tmp_path, case,
                                                       fields):
    """5 monolithic steps replayed from the captured CUDA graphs (FGMRES and
    inner BiCGStab iterations under conditional nodes) equal 5 plain steps
    bit for bit, with the same counts and the same SELL and Givens
    launches; no replay synchronises; the captured step reads the host
    less often."""
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
