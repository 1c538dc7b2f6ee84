"""The cells operator split by cells over devices
(``navierstokes_tpu_torch/parallel/sharded_cells.py``) against the port's
one-device ``CellOps`` and against the JAX package's shard_map path
(``navierstokes_tpu/parallel/sharded_ops.py``) on the conftest's 8
virtual CPU devices, in float64 on the CPU, where every shard lies on the
CPU.

* Per operator, on tests/test_sharding.py's channel (h=0.1, h_near=0.04,
  P2/P1 with the cylinder snapped, so the curved convection fix runs in
  the shards that hold curved cells): ``convection``, ``apply_blocks``
  with each with_f/with_g/with_gt combination, ``f_diag``, ``mass_apply``
  and ``schur_diag`` on numpy-seeded inputs, on 1, 3 and 8 shards: one
  shard equals ``CellOps`` bit for bit, more shards agree within 1e-12
  relative (a node's sum is taken per shard and then across shards), and
  8 shards agree with JAX's ``ShardedOps`` within 1e-12 relative.
* The model's steps: tests/test_torch_sharded_cells_model.py.
* The CLI: ``run 2d-test1 --operator cells --n-devices 2`` writes the JAX
  CLI's csv at ``--n-devices 2`` to 1e-9 of each column's largest value.
* Cell blocks (JAX's split without its padding), bytes per shard, the
  capture refusal and the device rules.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokes_tpu.mesh import channel_with_cylinder_2d
from navierstokes_tpu.models.navier_stokes import NavierStokes as JaxNS
from navierstokes_tpu.scenarios import cli as jcli
from navierstokes_tpu_torch.config import SolverConfig
from navierstokes_tpu_torch.models.navier_stokes import NavierStokes as TNS
from navierstokes_tpu_torch.ops.operators import CellOps
from navierstokes_tpu_torch.parallel.sharded_bsr import (ShardVals,
                                                         operator_bytes)
from navierstokes_tpu_torch.parallel.sharded_cells import (ShardedCellOps,
                                                           ShardedCells,
                                                           cell_blocks)
from navierstokes_tpu_torch.scenarios import cli as tcli
from test_torch_cells import make, rel
from test_torch_cells_3d_cli import _tight

torch.set_num_threads(2)
OP_TOL = 1e-12
WALL_CLOCK = ("time_prec_init", "time_sol")
COMBOS = [(f, g, gt) for f in (True, False) for g in (True, False)
          for gt in (True, False)]


@pytest.fixture(scope="module")
def mesh():
    return channel_with_cylinder_2d(h=0.1, h_near=0.04)


@pytest.fixture(scope="module")
def one(mesh, tmp_path_factory):
    """The port's one-device P2/P1 cells model and its CellOps."""
    ns = make(TNS, mesh, str(tmp_path_factory.mktemp("one")),
              operator="cells", device="cpu")
    assert isinstance(ns._ops, CellOps) and not ns._cell_sharded
    return ns


@pytest.fixture(scope="module")
def jax8(mesh, tmp_path_factory):
    """JAX's P2/P1 cells model on 8 virtual devices (shard_map)."""
    ns = make(JaxNS, mesh, str(tmp_path_factory.mktemp("jax8")),
              operator="cells", n_devices=8)
    assert ns.shard_mesh.devices.size == 8
    return ns


def shards_of(ns, n):
    """The model's cells on ``n`` CPU shards."""
    return ShardedCells(ns.space, ns._cells_host, ns.space.rs.T_hat,
                        ns.dtype, "cpu", ["cpu"] * n)


def inputs(ns, seed):
    rng = np.random.default_rng(seed)
    sp = ns.space
    nc, nv = np.asarray(sp.cell_p2).shape
    return dict(u=rng.standard_normal((sp.n_p2, sp.dim)),
                xp=rng.standard_normal(sp.n_p1),
                f=rng.standard_normal((nc, nv, nv)),
                w=rng.random(sp.n_p2))


def split(sc, f):
    return ShardVals(torch.as_tensor(f[s.cells[0]:s.cells[1]])
                     for s in sc.shards)


def jax_cells(f, n_pad):
    return jnp.asarray(np.concatenate(
        [f, np.zeros((n_pad - len(f),) + f.shape[1:])]))


def assert_close(a, b, n):
    a, b = torch.as_tensor(np.asarray(a)), torch.as_tensor(np.asarray(b))
    if n == 1:
        assert torch.equal(a, b)
    else:
        assert rel(a.numpy(), b.numpy()) < OP_TOL


def results(ops, op, f, x):
    """Every product of ``ops`` over ``op`` on the inputs ``x``, the
    per-cell F values ``f``."""
    t = {k: torch.as_tensor(v) for k, v in x.items() if k != "f"}
    out = {"convection": ops.convection(op, t["u"]),
           "f_diag": ops.f_diag(op, f),
           "mass_apply": ops.mass_apply(op, t["u"]),
           "schur_diag": ops.schur_diag(op, t["w"])}
    for c in COMBOS:
        out[c] = ops.apply_blocks(op, f, t["u"], t["xp"], *c)
    return out


@pytest.mark.parametrize("n", [1, 3, 8])
def test_sharded_ops_equal_cellops(one, n):
    sc = shards_of(one, n)
    assert len(sc.shards) == n
    assert sum(s.arrays.curv_ids is not None for s in sc.shards) >= 1
    x = inputs(one, 11)
    ref = results(one._ops, one.cells, torch.as_tensor(x["f"]), x)
    got = results(ShardedCellOps(), sc, split(sc, x["f"]), x)
    assert_close(sc.unshard(got.pop("convection")), ref.pop("convection"),
                 n)
    for key, r in ref.items():
        g = got[key]
        if isinstance(r, tuple):
            for a, b in zip(g, r):
                assert_close(a, b, n)
        else:
            assert_close(g, r, n)


def test_sharded_ops_match_jax_shardedops(one, jax8):
    """8 shards of the port against JAX's ShardedOps on 8 devices (JAX
    pads 684 cells to 688; the port's last block holds 82 cells)."""
    sc = shards_of(one, 8)
    x = inputs(one, 12)
    got = results(ShardedCellOps(), sc, split(sc, x["f"]), x)
    params = jax8._params()
    nc = x["f"].shape[0]
    n_pad = int(params.cells.cell_p2.shape[0])
    assert n_pad == 688 and sc.shards[-1].cells == (602, 684)
    jo, fj = jax8._ops, jax_cells(x["f"], n_pad)
    u, xp, w = (jnp.asarray(x[k]) for k in ("u", "xp", "w"))
    conv = np.asarray(jo.convection(params, u))[:nc]
    assert rel(sc.unshard(got["convection"]).numpy(), conv) < OP_TOL
    for key, want in (("f_diag", jo.f_diag(params, fj)),
                      ("mass_apply", jo.mass_apply(params, u)),
                      ("schur_diag", jo.schur_diag(params, w))):
        assert rel(got[key].numpy(), np.asarray(want)) < OP_TOL, key
    for c in COMBOS:
        yu, yp = jo.apply_blocks(params, fj, u, xp, *c)
        assert rel(got[c][0].numpy(), np.asarray(yu)) < OP_TOL, c
        assert rel(got[c][1].numpy(), np.asarray(yp)) < OP_TOL, c


@pytest.mark.parametrize("n_cells,n", [(684, 8), (684, 3), (10, 8), (5, 1),
                                       (16, 4)])
def test_cell_blocks_are_jaxs_split_without_padding(n_cells, n):
    """Shard k holds the real cells of row k of JAX's padded
    ``reshape(n, -1)`` (parallel/sharded_ops.py:45-47, 71-82)."""
    b = cell_blocks(n_cells, n)
    n_pad = -(-n_cells // n) * n
    rows = np.arange(n_pad).reshape(n, -1)
    for k in range(n):
        real = rows[k][rows[k] < n_cells]
        np.testing.assert_array_equal(np.arange(b[k], b[k + 1]), real)


def test_shard_bytes_split_the_cells(one):
    """Each of 8 shards holds about 1/8 of the one-device cell arrays,
    plans and T_hat (the shards with curved cells a little more)."""
    sc = shards_of(one, 8)
    whole = (operator_bytes(one.cells) + operator_bytes(one._ops.scat_v)
             + operator_bytes(one._ops.scat_p))
    parts = sc.shard_bytes()
    t_hat = operator_bytes(sc.shards[0].t_hat)
    # the shards' sum is the whole but for T_hat (and the curved cells'
    # reference table), which each shard holds
    assert sum(parts) - 8 * t_hat == pytest.approx(whole, rel=0.01)
    assert max(parts) <= 1.25 * sum(parts) / 8


def test_cli_cells_n_devices_two_writes_the_jax_csv(tmp_path, monkeypatch):
    """Both CLIs at ``--n-devices 2`` with the inner solves at 1e-10 (a
    SolverConfig subclass, as tests/test_torch_cells_3d_cli.py does)."""
    import jax
    jax.config.update("jax_enable_x64", True)
    monkeypatch.setattr(jcli, "_enable_cache", lambda: None)
    monkeypatch.setattr(jcli, "SolverConfig", _tight(jcli.SolverConfig))
    monkeypatch.setattr(tcli, "SolverConfig", _tight(tcli.SolverConfig))

    def args(tag):
        d = str(tmp_path / tag)
        return ["run", "2d-test1", "--h", "0.1", "--operator", "cells",
                "--n-devices", "2", "--T", "0.03", "--output-step", "3",
                "--dtype", "float64", "--output-dir", os.path.join(d, "out"),
                "--cache-dir", os.path.join(d, "cache"), "--csv",
                os.path.join(d, "f.csv")]

    assert jcli.main(args("j")) == 0
    assert tcli.main(args("t") + ["--device", "cpu"]) == 0
    j = np.genfromtxt(tmp_path / "j" / "f.csv", delimiter=",", names=True)
    t = np.genfromtxt(tmp_path / "t" / "f.csv", delimiter=",", names=True)
    assert t.dtype.names == j.dtype.names and len(t) == len(j) == 3
    for col in j.dtype.names:
        if col in WALL_CLOCK:
            continue
        scale = max(np.abs(j[col]).max(), 1e-300)
        np.testing.assert_allclose(t[col], j[col], rtol=0, atol=1e-9 * scale,
                                   err_msg=col)
    assert os.path.exists(tmp_path / "t" / "out" / "output-stokes_000003.vtu")


def test_sharded_cells_capture_and_device_rules(mesh, tmp_path):
    ns = make(TNS, mesh, str(tmp_path / "c"), operator="cells",
              n_devices=3, device="cpu")
    with pytest.raises(ValueError, match="cell shards step eagerly"):
        ns.capture_graphs()
    bad = TNS(mesh, 2, 1, config=SolverConfig(
        operator="cells", n_devices=2, dtype="float64",
        output_dir=str(tmp_path / "o"), cache_dir=str(tmp_path / "k"),
        csv_path=str(tmp_path / "f.csv")), device="cpu",
        shard_devices=["cuda:0", "cuda:0"])
    with pytest.raises(ValueError, match="shard device cuda:0 on a cpu"):
        bad.setup()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make(TNS, mesh, str(tmp_path / "g"), operator="cells",
                 n_devices=2, device="cuda")
