"""Row shards against one device, op by op, on the small fixtures.

    python3 tools/shard_bits.py [--device cuda|cpu]

For the h=0.1 cylinder channel on 3 shards and the h=0.12 one on 2 (fp32,
monolithic ``cc``, all shards on one device), prints for each operation
whether the sharded result equals the one-device result bit for bit and
the largest difference: the convection slots, the PCD pressure
convection, diag F, the Schur diagonal, the block-Jacobi seed, a
Newton-Schulz step and the tile apply, then 3 steps (FGMRES counts, u,
p).  It also prints the two library behaviours that shaped
``parallel/sharded_bsr.py`` (element matrices whole on the home device;
no shard with a single tile): the element convection GEMM on the first
k cells against the same rows of the product over all cells, and
``torch.linalg.inv`` / ``torch.matmul`` on a batch of b tiles against
the same tiles in the whole batch.
"""

import argparse
import dataclasses
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from navierstokes_tpu_torch.config import (InletConfig,  # noqa: E402
                                           SolverConfig)
from navierstokes_tpu_torch.mesh.generators import (  # noqa: E402
    channel_with_cylinder_2d)
from navierstokes_tpu_torch.models.navier_stokes import (  # noqa: E402
    NavierStokes)
from navierstokes_tpu_torch.ops import p1ell as P  # noqa: E402
from navierstokes_tpu_torch.ops.bsr import BsrOps  # noqa: E402
from navierstokes_tpu_torch.ops.operators import (  # noqa: E402
    convection_matrices)
from navierstokes_tpu_torch.parallel import sharded_bsr as SB  # noqa: E402

WORK = os.path.join(ROOT, "build", "shard_bits")


def model(dev, n, h, h_near):
    cfg = SolverConfig(dtype="float32", n_devices=n, scheme="monolithic",
                       output_dir=os.path.join(WORK, "out"),
                       cache_dir=os.path.join(WORK, "cache"),
                       csv_path=os.path.join(WORK, "forces.csv"))
    mesh = (channel_with_cylinder_2d(h=h, h_near=h_near) if h_near
            else channel_with_cylinder_2d(h=h))
    ns = NavierStokes(mesh, 2, 1, deltat=0.01, T=0.03, step=3, device=dev,
                      config=cfg, inlet=InletConfig(kind="parabolic",
                                                    u_m=0.3, height=0.41),
                      shard_devices=None if n == 1 else [dev] * n)
    ns.set_re_number(20)
    return ns.setup()


def same(a, b):
    a, b = a.to(b.device), b
    return (bool(torch.equal(a, b)),
            float((a.double() - b.double()).abs().max()))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args().device
    for h, h_near, n in ((0.1, 0.04, 3), (0.12, None, 2)):
        one, sh = model(dev, 1, h, h_near), model(dev, n, h, h_near)
        ops, sops = BsrOps(), SB.ShardedBsrOps()
        g = torch.Generator(device=dev).manual_seed(1)
        u = torch.randn(one.space.n_p2, 2, device=dev, generator=g)
        xp = torch.randn(one.space.n_p1, device=dev, generator=g)
        r = torch.randn(one.space.n_p2, 2, device=dev, generator=g)
        print(f"== h={h}: {one.space.n_dofs} DoF, shards "
              f"{[s.rows for s in sh.ell.shards]}")
        c1, cn = ops.convection(one.ell, u), sops.convection(sh.ell, u)
        f1, fn = one.a0_cell + c1, sh.a0_cell + cn
        mflat = one.bc.mask[:, 0]
        sigma = torch.tensor(3.0, device=dev)
        x1 = P.block_jacobi_inverse(one._bj_plan, one.a0_cell, mflat, sigma)
        xn = SB.block_jacobi_inverse(sh._bj_plan, sh.a0_cell, mflat, sigma)
        i1 = P.block_jacobi_invert(one._bj_plan, f1, mflat, sigma, x0=x1)
        i_n = SB.block_jacobi_invert(sh._bj_plan, fn, mflat, sigma, x0=xn)
        w = u[:, 0].abs()
        rows = {
            "convection slots": (sh.ell.unshard(cn), c1),
            "pressure convection": (
                sops.apply_pp(sh.ell, sops.pressure_convection(sh.ell, u),
                              xp),
                ops.apply_pp(one.ell, ops.pressure_convection(one.ell, u),
                             xp)),
            "diag F": (sops.f_diag(sh.ell, fn), ops.f_diag(one.ell, f1)),
            "Schur diagonal": (sops.schur_diag(sh.ell, w),
                               ops.schur_diag(one.ell, w)),
            "block-Jacobi seed": (torch.cat(xn.parts), x1),
            "Newton-Schulz": (torch.cat(i_n.parts), i1),
            "tile apply": (SB.block_jacobi_apply(sh._bj_plan, i_n, r),
                           P.block_jacobi_apply(one._bj_plan, i1, r)),
        }
        for name, (a, b) in rows.items():
            print(f"  {name}: equal, max diff {same(a, b)}")
        for k in range(3):
            m1, mn = one.solve_time_step(), sh.solve_time_step()
            print(f"  step {k + 1}: FGMRES {mn.iterations} / {m1.iterations}"
                  f", u {same(sh._u, one._u)}, p {same(sh._p, one._p)}")
        # the library behaviours
        e = dataclasses.replace(one.ell, curv_ids=None)
        m_all = convection_matrices(e, e.t_hat, u)
        for k in (100, m_all.shape[0] // 3, m_all.shape[0] // 2):
            sub = dataclasses.replace(e, cell_p2=e.cell_p2[:k],
                                      jinv=e.jinv[:k], detj=e.detj[:k])
            part = convection_matrices(sub, sub.t_hat, u)
            print(f"  element GEMM on the first {k} of {m_all.shape[0]} "
                  f"cells: {same(part, m_all[:k])}")
        a = P.block_jacobi_tiles(one._bj_plan, one.a0_cell, mflat, sigma)
        inv_all, mm_all = torch.linalg.inv(a), torch.matmul(a, x1)
        for b in (1, 2, 3):
            inv = same(torch.linalg.inv(a[:b]), inv_all[:b])
            mm = same(torch.matmul(a[:b], x1[:b]), mm_all[:b])
            print(f"  batch of {b} of {a.shape[0]} tiles: linalg.inv {inv}, "
                  f"matmul {mm}")


if __name__ == "__main__":
    main()
