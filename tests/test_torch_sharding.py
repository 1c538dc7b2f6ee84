"""Row sharding of the port's bsr operator (``navierstokes_tpu_torch/
parallel/``) against one device and against the JAX package's GSPMD run.

On the CPU every shard lies on the CPU, the port's counterpart of JAX's
virtual host devices.  The cylinder channel of tests/test_sharding.py
(h=0.1, h_near=0.04: 1,498 velocity nodes, 6 block-Jacobi tiles of 256;
no shard takes a single tile, so 8 shards run as 3 of 2 tiles each),
float64 unless a case says fp32:

* ``cell_partitioning`` equals JAX's; ``row_partition`` covers every row
  once, on tile multiples;
* every sharded product (F, the mass, G, B, the PCD convection, diag F,
  the Schur diagonal, the block-Jacobi tiles) and the convection slot
  values equal the unsharded ones bit for bit (``torch.equal``) for 2, 3
  and 8 shards;
* 3 steps of projection (``bj``) and of monolithic ``cc``, ``asimple``
  and fp32 ``cc`` + ``refine=2`` on 2 and 8 shards, and of projection
  ``diag``, ``pcd`` with ``jacobi`` and ``ayosida`` on 3, equal the
  one-device run bit for bit in u, p and every csv column but the
  wall-clock ones;
* 8 shards against JAX's ``n_devices=8`` bsr run (GSPMD on the
  conftest's 8 virtual devices) within tests/test_sharding.py's
  tolerances (u 2e-4, p 2e-3); a checkpoint written on 3 shards restarts
  on one device bit for bit; the CLI's ``--n-devices 2`` writes the csv
  of ``--n-devices 1``.  The cells operator's shards are held in
  tests/test_torch_sharded_cells*.py.

No op broke bit equality on the CPU, so no case carries a tolerance in
place of ``torch.equal``.
"""

import functools
import os

import numpy as np
import pytest
import torch

from navierstokes_tpu_torch.config import InletConfig, SolverConfig
from navierstokes_tpu_torch.mesh.generators import channel_with_cylinder_2d
from navierstokes_tpu_torch.models.navier_stokes import NavierStokes as TNS
from navierstokes_tpu_torch.ops.bsr import BsrOps
from navierstokes_tpu_torch.ops.p1ell import (block_jacobi_apply,
                                              block_jacobi_inverse,
                                              block_jacobi_invert,
                                              build_block_jacobi_plan)
from navierstokes_tpu_torch.parallel import sharded_bsr as SB
from navierstokes_tpu_torch.parallel.sharding import (cell_partitioning,
                                                      row_partition,
                                                      shard_devices)
from navierstokes_tpu_torch.scenarios import cli as tcli

torch.set_num_threads(2)
WALL_CLOCK = ("time_prec_init", "time_sol")
TILE = 256


@functools.lru_cache(maxsize=1)
def mesh():
    return channel_with_cylinder_2d(h=0.1, h_near=0.04)


def make(tmp, n, T=0.03, step=3, **kw):
    """The fixture model on ``n`` row shards, set up, float64 unless
    ``kw`` says else."""
    kw.setdefault("dtype", "float64")
    cfg = SolverConfig(n_devices=n, output_dir=os.path.join(tmp, "out"),
                       cache_dir=os.path.join(tmp, "cache"),
                       csv_path=os.path.join(tmp, "forces.csv"), **kw)
    ns = TNS(mesh(), 2, 1, deltat=0.01, T=T, step=step,
             inlet=InletConfig(kind="parabolic", u_m=0.3, height=0.41),
             config=cfg, device="cpu")
    ns.set_re_number(20)
    return ns.setup()


def csv_rows(path):
    rows = np.genfromtxt(path, delimiter=",", names=True)
    return {c: rows[c] for c in rows.dtype.names if c not in WALL_CLOCK}


def assert_same_csv(a, b):
    ra, rb = csv_rows(a), csv_rows(b)
    assert list(ra) == list(rb) and len(ra["time"]) > 0
    for col in ra:
        np.testing.assert_array_equal(ra[col], rb[col], err_msg=col)


@pytest.mark.parametrize("n_cells,n", [(100, 8), (684, 3), (7, 8),
                                       (1000, 2), (5, 1)])
def test_cell_partitioning_equals_jax(n_cells, n):
    from navierstokes_tpu.parallel.sharding import cell_partitioning as jcp
    part = cell_partitioning(n_cells, n)
    np.testing.assert_array_equal(part, jcp(n_cells, n))
    assert part.dtype == np.float64
    # n_devices=0 is one device in the port (all visible devices in JAX)
    assert not cell_partitioning(n_cells, 0).any()


@pytest.mark.parametrize("n_p2,n_p1,n", [(1498, 407, 8), (1498, 407, 3),
                                         (450518, 112826, 2), (300, 80, 4),
                                         (256 * 7, 500, 7)])
def test_row_partition_covers_rows_on_tiles(n_p2, n_p1, n):
    vel, pres = row_partition(n_p2, n_p1, n, TILE)
    for b, total in ((vel, n_p2), (pres, n_p1)):
        assert len(b) == n + 1 and b[0] == 0 and b[-1] == total
        assert (np.diff(b) >= 0).all()
        rows = np.concatenate([np.arange(b[k], b[k + 1]) for k in range(n)])
        np.testing.assert_array_equal(rows, np.arange(total))
    assert all(v % TILE == 0 or v == n_p2 for v in vel)
    tiles = np.diff(-(-vel // TILE))
    used = tiles[tiles > 0]
    assert used.min() >= 2 and used.max() - used.min() <= 1
    assert (np.diff(tiles) <= 0).all()
    assert len(used) == min(n, (-(-n_p2 // TILE)) // 2)
    # a shard without velocity rows has no pressure rows either
    assert ((np.diff(vel) > 0) | (np.diff(pres) == 0)).all()


def test_shard_devices():
    cpu = torch.device("cpu")
    assert shard_devices("cpu", 3) == [cpu] * 3
    assert shard_devices("cpu", 2, ["cpu", "cpu"]) == [cpu] * 2
    with pytest.raises(ValueError, match="2 devices given for 3"):
        shard_devices("cpu", 3, ["cpu", "cpu"])
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match="2 shards need 2 CUDA"):
            shard_devices("cuda", 2)


@pytest.fixture(scope="module")
def module_tmp(tmp_path_factory):
    return str(tmp_path_factory.mktemp("sharding"))


@pytest.fixture(scope="module")
def one_device_model(module_tmp):
    return make(os.path.join(module_tmp, "products"), 1,
                scheme="projection")


@pytest.mark.parametrize("n", [2, 3, 8])
def test_sharded_products_equal_unsharded(one_device_model, n):
    ns = one_device_model
    full = ns.ell
    sb = SB.ShardedBsr(full, ns.space.cell_p1, "cpu", ["cpu"] * n, TILE)
    assert len(sb.shards) == min(n, 3)
    assert full.curv_ids is not None       # the curved fix runs
    ops, sops = BsrOps(), SB.ShardedBsrOps()
    rng = np.random.default_rng(n)
    t = lambda *shape: torch.as_tensor(rng.standard_normal(shape))
    u, xu, xp = t(full.n_p2, 2), t(full.n_p2, 2), t(full.n_p1)
    nz = rng.standard_normal(full.f.nnz)
    conv1, convn = ops.convection(full, u), sops.convection(sb, u)
    assert torch.equal(sb.unshard(convn), conv1)
    f1 = full.f.values(nz, torch.float64) + conv1
    fn = sb.f_values(nz, torch.float64) + convn
    assert torch.equal(sb.unshard(fn), f1)
    pairs = [
        (ops.apply_f(full, f1, xu), sops.apply_f(sb, fn, xu)),
        (ops.mass_apply(full, xu), sops.mass_apply(sb, xu)),
        (ops.apply_bt(full, xp), sops.apply_bt(sb, xp)),
        (ops.apply_b(full, xu), sops.apply_b(sb, xu)),
        (ops.f_diag(full, f1), sops.f_diag(sb, fn)),
        (ops.schur_diag(full, xu[:, 0].abs()),
         sops.schur_diag(sb, xu[:, 0].abs())),
        (ops.apply_pp(full, ops.pressure_convection(full, u), xp),
         sops.apply_pp(sb, sops.pressure_convection(sb, u), xp)),
        *zip(ops.apply_blocks(full, f1, xu, xp),
             sops.apply_blocks(sb, fn, xu, xp)),
    ]
    for k, (a, b) in enumerate(pairs):
        assert a.shape == b.shape and torch.equal(a, b), k
    # the block-Jacobi tiles: seed, Newton-Schulz step, apply
    mflat = torch.as_tensor((rng.random(full.n_p2) > 0.1).astype(float))
    sigma = torch.tensor(2.5, dtype=torch.float64)
    a0 = full.f.values(nz, torch.float64)
    plan1 = build_block_jacobi_plan(full.f, full.bu, full.n_p2, 16, "cpu")
    plann = SB.block_jacobi_plan(sb, 16)
    x1 = block_jacobi_inverse(plan1, a0, mflat, sigma)
    xn = SB.block_jacobi_inverse(plann, sb.f_values(nz, torch.float64),
                                 mflat, sigma)
    assert torch.equal(torch.cat(xn.parts), x1)
    inv1 = block_jacobi_invert(plan1, a0 * 1.01, mflat, sigma, x0=x1)
    invn = SB.block_jacobi_invert(
        plann, sb.f_values(nz * 1.01, torch.float64), mflat, sigma, x0=xn)
    assert torch.equal(torch.cat(invn.parts), inv1)
    assert torch.equal(SB.block_jacobi_apply(plann, invn, xu),
                       block_jacobi_apply(plan1, inv1, xu))


STEP_CASES = {
    "projection-bj": dict(scheme="projection"),
    "cc": dict(scheme="monolithic"),
    "asimple": dict(scheme="monolithic", preconditioner="asimple"),
    "cc-refine2-fp32": dict(scheme="monolithic", refine=2, dtype="float32"),
    "projection-diag": dict(scheme="projection", f_precond="diag"),
    "pcd-jacobi": dict(scheme="monolithic", preconditioner="pcd",
                       f_precond="jacobi"),
    "ayosida": dict(scheme="monolithic", preconditioner="ayosida"),
}
# the first four cases on 2 and 8 shards, the other options on 3
STEP_RUNS = [(case, n) for case in list(STEP_CASES)[:4] for n in (2, 8)] \
    + [(case, 3) for case in list(STEP_CASES)[4:]]
_ONE_DEVICE = {}


def one_device_run(case, tmp_root):
    """(u, p, csv path) of the one-device run of ``case``, made once."""
    if case not in _ONE_DEVICE:
        tmp = os.path.join(tmp_root, f"one-{case}")
        ns = make(tmp, 1, **STEP_CASES[case]).solve()
        _ONE_DEVICE[case] = (ns._u, ns._p, ns.config.csv_path)
    return _ONE_DEVICE[case]


@pytest.mark.parametrize("case,n", STEP_RUNS)
def test_sharded_steps_equal_one_device(module_tmp, tmp_path, case, n):
    u1, p1, csv1 = one_device_run(case, module_tmp)
    ns = make(str(tmp_path), n, **STEP_CASES[case]).solve()
    assert isinstance(ns.ell, SB.ShardedBsr)
    assert len(ns.ell.shards) == min(n, 3)
    assert torch.equal(ns._u, u1) and torch.equal(ns._p, p1)
    assert_same_csv(ns.config.csv_path, csv1)


def test_assemble_returns_the_one_device_layout(tmp_path):
    one = make(str(tmp_path / "1"), 1, scheme="monolithic")
    three = make(str(tmp_path / "3"), 3, scheme="monolithic")
    for ns in (one, three):
        ns.solve_time_step()
    assert torch.equal(three.assemble(0.01), one.assemble(0.01))


@pytest.mark.parametrize("scheme", ["monolithic", "projection"])
def test_eight_shards_match_jax_gspmd(tmp_path, scheme):
    """tests/test_sharding.py's run (T=0.02, 2 steps, cc or projection)
    with JAX on 8 virtual devices and the port on 8 row shards, held at
    that file's tolerances."""
    import jax
    from navierstokes_tpu.config import InletConfig as JInlet
    from navierstokes_tpu.config import SolverConfig as JConfig
    from navierstokes_tpu.models.navier_stokes import NavierStokes as JNS
    from navierstokes_tpu.mesh import channel_with_cylinder_2d as jmesh
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) JAX devices")
    jax.config.update("jax_enable_x64", True)
    tmp = str(tmp_path)
    jcfg = JConfig(dtype="float64", n_devices=8, operator="bsr",
                   scheme=scheme, output_dir=f"{tmp}/jout",
                   cache_dir=f"{tmp}/jcache", csv_path=f"{tmp}/j.csv")
    jns = JNS(jmesh(h=0.1, h_near=0.04), 2, 1, deltat=0.01, T=0.02, step=2,
              inlet=JInlet(kind="parabolic", u_m=0.3, height=0.41),
              config=jcfg)
    jns.set_re_number(20)
    jns.setup()
    jns.solve()
    assert jns.shard_mesh is not None and jns.shard_mesh.devices.size == 8
    tns = make(str(tmp_path / "t"), 8, T=0.02, step=2, scheme=scheme)
    tns.solve()
    np.testing.assert_allclose(tns._u.numpy(), np.asarray(jns._u), atol=2e-4)
    np.testing.assert_allclose(tns._p.numpy(), np.asarray(jns._p), atol=2e-3)


def test_checkpoint_on_three_shards_restarts_on_one(tmp_path):
    whole = make(str(tmp_path / "whole"), 1, T=0.04, step=2).solve()
    part = make(str(tmp_path / "part"), 3, T=0.04, step=2)
    part.config.t_final = 0.02
    part.solve()
    vtu = tmp_path / "part" / "out" / "output-stokes_000002.vtu"
    assert vtu.exists()
    rest = make(str(tmp_path / "rest"), 1, T=0.04, step=2)
    rest.config.cache_dir = part.config.cache_dir
    rest.solve(time_step=2, csv_path=str(tmp_path / "part" / "rest.csv"))
    assert torch.equal(rest._u, whole._u) and torch.equal(rest._p, whole._p)
    assert rest.time == whole.time
    tail = {c: v[2:] for c, v in csv_rows(whole.config.csv_path).items()}
    rows = csv_rows(str(tmp_path / "part" / "rest.csv"))
    assert rows.keys() == tail.keys()
    for col, v in rows.items():
        np.testing.assert_array_equal(v, tail[col], err_msg=col)


def test_cli_n_devices_two_writes_the_one_device_csv(tmp_path):
    csvs = []
    for n in (1, 2):
        tmp = str(tmp_path / str(n))
        csvs.append(os.path.join(tmp, "forces.csv"))
        assert tcli.main(["run", "2d-test1", "--h", "0.1", "--T", "0.03",
                          "--output-step", "3", "--dtype", "float64",
                          "--device", "cpu", "--n-devices", str(n),
                          "--output-dir", os.path.join(tmp, "out"),
                          "--cache-dir", os.path.join(tmp, "cache"),
                          "--csv", csvs[-1]]) == 0
    assert_same_csv(csvs[1], csvs[0])
