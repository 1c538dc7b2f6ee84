"""The block-Jacobi tile apply of the port (``kernels/bj_apply.py``; its
CUDA kernel csrc/bj_apply.cu runs only on the card, see
tests/test_torch_cuda.py) against the JAX package's
``navierstokes_tpu/ops/p1ell.py`` ``block_jacobi_apply``, on the CPU:

* the plain version on seeded tiles (SB = 16 and 32, d = 2 and 3, a tail
  tile): float64 within 1e-12 of max|y|, fp32 within 1e-6, bf16 tiles
  within one bf16 ulp of max|y| (both libraries round a fp32 sum to bf16,
  in their own order);
* the same at the fp32 tiles of a real ``block_jacobi_invert`` on the
  h=0.12 cylinder channel, in both branches (Newton-Schulz from the seed,
  and the exact inverse);
* the wrapper on CPU tensors: it takes the plain version, counts no
  launch and imports nothing of JAX;
* what the model's steps hand the apply (both schemes, the bf16 options,
  the exact branch, row shards): what the kernel takes on the card;
* the persistent grid's split of the work items (``partition``): every
  block of rows goes to exactly one CTA, in order.
"""

import os
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from navierstokes_tpu.fem.spaces import TaylorHoodSpace
from navierstokes_tpu.mesh import channel_with_cylinder_2d
from navierstokes_tpu.ops import assembly as JA
from navierstokes_tpu.ops import bsr as JB
from navierstokes_tpu.ops import p1ell as JP
from navierstokes_tpu_torch.config import InletConfig, SolverConfig
from navierstokes_tpu_torch.kernels import bj_apply as BJ
from navierstokes_tpu_torch.mesh import generators as TG
from navierstokes_tpu_torch.ops import assembly as TA
from navierstokes_tpu_torch.ops import bsr as TB
from navierstokes_tpu_torch.ops import p1ell as TP

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tiles dtype -> limit over max|y| (bf16: one bf16 ulp, _bf16_ulp)
LIMITS = {torch.float64: 1e-12, torch.float32: 1e-6}
JAX_DTYPES = {torch.float64: jnp.float64, torch.float32: jnp.float32,
              torch.bfloat16: jnp.bfloat16}


def _bf16_ulp(y):
    """One bf16 ulp of max|y| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.abs(y).max())) - 7)


def _against_jax(tiles, r, plan, jplan):
    """The port's apply (the plain version, through ops/p1ell) and JAX's
    on the same numpy tiles (n_tiles, SB, SB) float64 and r (n_p2, d),
    cast to each dtype; asserts the stated limit for each."""
    for dt, jdt in JAX_DTYPES.items():
        rdt = torch.float64 if dt == torch.float64 else torch.float32
        t_tiles = torch.as_tensor(tiles).to(dt)
        t_r = torch.as_tensor(r).to(rdt)
        y = TP.block_jacobi_apply(plan, t_tiles, t_r)
        j_tiles = jnp.asarray(tiles).astype(jdt)
        if jplan.n_tiles > plan.n_tiles:     # JAX's padding tiles
            pad = jplan.n_tiles - plan.n_tiles
            j_tiles = jnp.pad(j_tiles, ((0, pad), (0, 0), (0, 0)))
        yj = np.asarray(JP.block_jacobi_apply(
            jplan, j_tiles, jnp.asarray(t_r.numpy())), np.float64)
        assert y.dtype == rdt and tuple(y.shape) == r.shape
        gap = np.abs(y.double().numpy() - yj).max()
        if dt == torch.bfloat16:
            assert gap <= _bf16_ulp(yj), (dt, gap)
        else:
            assert gap <= LIMITS[dt] * np.abs(yj).max(), (dt, gap)


@pytest.mark.parametrize("sb", [16, 32])
@pytest.mark.parametrize("d", [2, 3])
def test_plain_matches_jax_on_seeded_tiles(sb, d):
    rng = np.random.default_rng(100 * sb + d)
    n_tiles = 5
    n_p2 = (n_tiles - 1) * sb + sb // 2 + 3          # a tail tile
    tiles = np.eye(sb)[None] + 0.1 * rng.standard_normal((n_tiles, sb, sb))
    r = rng.standard_normal((n_p2, d))
    plan = TP.BlockJacobiPlan(pos=None, src=None, n_tiles=n_tiles, S=sb,
                              bu=1, n_p2=n_p2)
    jplan = types.SimpleNamespace(n_tiles=n_tiles, S=sb, bu=1, n_p2=n_p2)
    _against_jax(tiles, r, plan, jplan)


@pytest.fixture(scope="module")
def channel():
    """The h=0.12 cylinder channel: the port's F pattern and tile plan
    (S = 2 node blocks of 16, SB = 32) and JAX's plan of the same tiles."""
    mesh = channel_with_cylinder_2d(h=0.12)
    mesh.reorder_spatial()
    sp = TaylorHoodSpace(mesh)
    assert sp.snap_boundaries(mesh.snap_projectors)
    tb = TB.build_bsr(sp, TA.cell_arrays_numpy(sp), torch.float32, "cpu")
    jb = JB.build_bsr(sp, JA.cell_arrays_numpy(sp), dtype=jnp.float32)
    S = 2
    plan = TP.build_block_jacobi_plan(tb.f, tb.bu, sp.n_p2, S, "cpu")
    jplan = JP.build_block_jacobi_plan(jb, S=S, layout="blocked")
    assert sp.n_p2 % (S * tb.bu) and jplan.n_p2 == sp.n_p2
    return sp, tb, plan, jplan


@pytest.mark.parametrize("branch", ["newton", "exact"])
@pytest.mark.parametrize("d", [2, 3])
def test_plain_matches_jax_at_real_tiles(channel, branch, d):
    """The tiles of ``block_jacobi_invert`` on a masked F near the seed's
    (Newton-Schulz) or with no seed (the exact inverse), fp32."""
    sp, tb, plan, jplan = channel
    rng = np.random.default_rng(7)
    k_vals = tb.f.values(tb.host.k_nz, torch.float32)
    f0 = 400.0 * tb.m_vals + 1e-3 * k_vals
    f1 = f0 * (1.0 + 0.02 * torch.as_tensor(
        rng.standard_normal(f0.shape), dtype=torch.float32))
    mask = torch.as_tensor(rng.uniform(size=sp.n_p2) > 0.1,
                           dtype=torch.float32)
    sigma = 7.5
    x0 = (TP.block_jacobi_inverse(plan, f0, mask, sigma)
          if branch == "newton" else None)
    exact = TP.BJ_INVERSIONS["exact"]
    tiles = TP.block_jacobi_invert(plan, f1, mask, sigma, x0=x0, iters=3)
    assert (TP.BJ_INVERSIONS["exact"] > exact) == (branch == "exact")
    assert tiles.dtype == torch.float32 and tiles.is_contiguous()
    r = rng.standard_normal((sp.n_p2, d))
    _against_jax(tiles.double().numpy(), r, plan, jplan)


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    calls = []
    plain = BJ.block_jacobi_apply_plain

    def spy(tiles, r):
        calls.append((tiles.dtype, r.dtype))
        return plain(tiles, r)

    monkeypatch.setattr(BJ, "block_jacobi_apply_plain", spy)
    rng = np.random.default_rng(3)
    tiles = torch.as_tensor(rng.standard_normal((3, 16, 16)))
    r = torch.as_tensor(rng.standard_normal((40, 2)))
    BJ.COUNTS.reset()
    y = BJ.bj_apply(tiles, r)
    assert calls == [(torch.float64, torch.float64)]
    assert BJ.COUNTS.launches == 0 and BJ.COUNTS.plain_cuda_calls == 0
    assert BJ.COUNTS.by_variant == {}
    assert torch.equal(y, plain(tiles, r))


def test_wrapper_imports_no_jax():
    """The wrapper and ops/p1ell on CPU tensors in a fresh interpreter: the
    plain version, no launch, and no jax or navierstokes_tpu module."""
    code = (
        "import sys, torch\n"
        "from navierstokes_tpu_torch.kernels import bj_apply as BJ\n"
        "from navierstokes_tpu_torch.ops import p1ell as TP\n"
        "t = torch.eye(32).repeat(2, 1, 1); r = torch.ones(50, 3)\n"
        "plan = TP.BlockJacobiPlan(None, None, 2, 2, 16, 50)\n"
        "assert torch.equal(TP.block_jacobi_apply(plan, t, r), r)\n"
        "assert BJ.COUNTS.launches == 0\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'navierstokes_tpu')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=ROOT, timeout=300)


def test_apply_refuses_tiles_of_another_plan():
    plan = TP.BlockJacobiPlan(None, None, 2, 2, 16, 50)
    with pytest.raises(ValueError, match="for a plan of 2 tiles"):
        TP.block_jacobi_apply(plan, torch.zeros(3, 32, 32),
                              torch.zeros(50, 2))
    with pytest.raises(ValueError, match="for a plan of 2 tiles"):
        TP.block_jacobi_apply(plan, torch.zeros(2, 32, 32),
                              torch.zeros(64, 2))


@pytest.mark.parametrize("fields", [
    dict(scheme="projection"), dict(scheme="projection", bj_newton=0),
    dict(scheme="projection", bj_bf16=True), dict(scheme="monolithic"),
    dict(scheme="monolithic", inner_bf16=True),
    dict(scheme="monolithic", refine=2, refine_tol=1e-3),
    dict(scheme="projection", n_devices=2),
    dict(scheme="monolithic", n_devices=2)])
def test_steps_hand_the_apply_what_the_kernel_takes(tmp_path, monkeypatch,
                                                    fields):
    """Every tile apply of two fp32 steps of the small fixture (through
    ops/p1ell on CPU tensors) gets contiguous row-major r and tiles, a tile
    dtype and r dtype pair, tile size and d that csrc/bj_apply.cu has an
    instantiation for, as on the card, where the wrapper refuses anything
    else."""
    seen = []
    plain = BJ.block_jacobi_apply_plain

    def spy(tiles, r):
        seen.append((tiles.dtype, r.dtype, tiles.shape[1], r.shape[1],
                     tiles.is_contiguous(), r.is_contiguous(),
                     tiles.data_ptr() % BJ.ALIGN, r.data_ptr() % BJ.ALIGN))
        return plain(tiles, r)

    monkeypatch.setattr(BJ, "block_jacobi_apply_plain", spy)
    from navierstokes_tpu_torch.models.navier_stokes import NavierStokes
    cfg = SolverConfig(dtype="float32", output_dir=str(tmp_path / "out"),
                       cache_dir=str(tmp_path / "cache"),
                       csv_path=str(tmp_path / "forces.csv"), **fields)
    ns = NavierStokes(TG.channel_with_cylinder_2d(h=0.12), 2, 1, deltat=0.01,
                      T=0.02, step=2, device="cpu", config=cfg,
                      inlet=InletConfig(kind="parabolic", u_m=0.3,
                                        height=0.41))
    ns.set_re_number(20)
    ns.setup()
    for _ in range(2):
        assert ns.solve_time_step().converged
    bf16 = fields.get("bj_bf16") or fields.get("inner_bf16")
    want = torch.bfloat16 if bf16 else torch.float32
    assert seen and {s[0] for s in seen} == {want}
    for tdt, rdt, sb, d, t_contig, r_contig, t_off, r_off in seen:
        assert rdt == BJ.VARIANTS[tdt][1]
        assert sb in BJ.TILE_SIZES and d == 2
        assert t_contig and r_contig
        # the kernel's bulk copies take 16-byte aligned tiles and r
        assert t_off == 0 and r_off == 0


@settings(max_examples=300, deadline=None)
@given(n_tiles=st.integers(1, 5000), sb=st.sampled_from(BJ.TILE_SIZES),
       rows=st.sampled_from([8, 16, 32, 64]), resident=st.integers(1, 264),
       tail=st.integers(1, 512))
def test_partition_deals_every_row_block_to_one_cta_in_order(
        n_tiles, sb, rows, resident, tail):
    """The kernel's work items, blocks of ``rows`` rows (the ring's rows
    per item, which divide SB: 8 to 64 in csrc/bj_apply.cu), of a batch of
    ``n_tiles`` tiles with a tail tile of ``tail`` live rows: the CTAs'
    ranges cover them once, in order, each CTA at least one item, the
    shares differing by at most one, on at most ``resident`` CTAs."""
    n_p2 = (n_tiles - 1) * sb + min(tail, sb)
    part = BJ.partition(n_p2, rows, resident)
    # every (tile, row block) with a live row is an item
    assert part.n_items == ((n_tiles - 1) * (sb // rows)
                            + -(-min(tail, sb) // rows))
    assert part.grid == min(resident, part.n_items)
    # [begin, end) of each CTA, as csrc/bj_apply.cu's ring_kernel derives it
    begins = [b * part.per_cta + min(b, part.n_long)
              for b in range(part.grid)]
    ranges = [(begin, begin + part.per_cta + (b < part.n_long))
              for b, begin in enumerate(begins)]
    assert ranges[0][0] == 0 and ranges[-1][1] == part.n_items
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    sizes = [end - begin for begin, end in ranges]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
