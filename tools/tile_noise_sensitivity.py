"""The fp32 block-Jacobi noise behind the port's projection parity limits.

    JAX_PLATFORMS=cpu python tools/tile_noise_sensitivity.py

On the CPU, in float64, on the ``tests/test_torch_model.py`` fixture (the
h=0.1, h_near=0.04 cylinder channel, Re=20, dt=0.01, 3 projection steps)
for BDF1 and BDF2 it prints:

1. the port against the JAX model, per step: the relative difference of
   u and p and of Cd relative to the force scale max(|Cd|, |Cl|);
2. the two packages' fp32 tile inverses of the same step's F, exact and
   after 3 Newton-Schulz steps: their relative difference, delta;
3. the port against itself with every tile inverse multiplied by
   (1 +- delta), random signs from a seed: how far that noise alone moves
   u, p and Cd within 3 steps.

``tests/test_torch_model.py`` derives its limits from 3.
"""

import os
import sys
import tempfile

import jax
import numpy as np
import torch

jax.config.update("jax_enable_x64", True)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax.numpy as jnp  # noqa: E402

import navierstokes_tpu.ops.bsr as JB  # noqa: E402
import navierstokes_tpu.ops.p1ell as JP  # noqa: E402
import navierstokes_tpu_torch.models.navier_stokes as TM  # noqa: E402
import navierstokes_tpu_torch.ops.bsr as TB  # noqa: E402
import navierstokes_tpu_torch.ops.p1ell as TP  # noqa: E402
from navierstokes_tpu.config import InletConfig, SolverConfig  # noqa: E402
from navierstokes_tpu.mesh import channel_with_cylinder_2d  # noqa: E402
from navierstokes_tpu.models.navier_stokes import NavierStokes as JaxNS  # noqa: E402,E501

STEPS = 3
torch.set_num_threads(2)
MESH = channel_with_cylinder_2d(h=0.1, h_near=0.04)
TMP = tempfile.mkdtemp()


def make(cls, tag, bdf2, **kw):
    d = os.path.join(TMP, tag)
    cfg = SolverConfig(dtype="float64", output_dir=os.path.join(d, "out"),
                       cache_dir=os.path.join(d, "cache"),
                       csv_path=os.path.join(d, "forces.csv"),
                       scheme="projection", proj_bdf2=bdf2)
    ns = cls(MESH, 2, 1, deltat=0.01, T=0.01 * STEPS, step=STEPS,
             inlet=InletConfig(kind="parabolic", u_m=0.3, height=0.41),
             config=cfg, **kw)
    ns.set_re_number(20)
    return ns.setup()


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def gaps(ma, a, mb, b):
    scale = max(abs(float(mb.cd)), abs(float(mb.cl)))
    return (rel(a._u, b._u), rel(a._p, b._p),
            abs(float(ma.cd) - float(mb.cd)) / scale)


def tile_inverse_gap(j, t, iters):
    """Both packages' fp32 tile inverses of the F at the state they share."""
    u = (np.asarray(j._u) if hasattr(j, "_u")          # set by step 1
         else np.zeros((t.space.n_p2, 2)))
    f_j = j.a0_cell + JB.convection_blk(j.ell, jnp.asarray(u))
    f_t = t.a0_cell + TB.convection_blk(t.ell, torch.as_tensor(u))
    m_j, m_t = j.bc.mask[:, 0], t.bc.mask[:, 0]
    d_j, d_t = JB.f_diag(j.ell, f_j), TB.f_diag(t.ell, f_t)
    s_j, s_t = (d_j * m_j).sum() / m_j.sum(), (d_t * m_t).sum() / m_t.sum()
    x_j = np.asarray(JP.block_jacobi_invert(
        j._bj_plan, f_j, m_j, s_j, x0=j._bj_seed() if iters else None,
        iters=iters))
    x_t = TP.block_jacobi_invert(
        t._bj_plan, f_t, m_t, s_t, x0=t._bj_seed() if iters else None,
        iters=iters).numpy()
    return rel(x_t, x_j[:len(x_t)])     # JAX adds padding tiles


def main():
    for bdf2 in (False, True):
        name = "bdf2" if bdf2 else "bdf1"
        j, t = make(JaxNS, "j" + name, bdf2), make(TM.NavierStokes,
                                                   "t" + name, bdf2,
                                                   device="cpu")
        delta = 0.0
        for k in range(STEPS):
            d0, d3 = tile_inverse_gap(j, t, 0), tile_inverse_gap(j, t, 3)
            delta = max(delta, d0, d3)
            jm, tm = j.solve_time_step(), t.solve_time_step()
            du, dp, dcd = gaps(tm, t, jm, j)
            print(f"{name} step {k + 1}: port vs JAX u {du:.3e} p {dp:.3e} "
                  f"Cd {dcd:.3e}; fp32 tile inverses differ by {d0:.3e} "
                  f"(exact), {d3:.3e} (Newton-Schulz)", flush=True)
        orig = TM.block_jacobi_invert
        rng = np.random.default_rng(0)

        def noisy(*a, **k):
            x = orig(*a, **k)
            sign = torch.as_tensor(rng.choice([-1.0, 1.0], size=x.shape),
                                   dtype=x.dtype)
            return x * (1 + delta * sign)

        a, b = (make(TM.NavierStokes, f"{c}{name}", bdf2, device="cpu")
                for c in "ab")
        for k in range(STEPS):
            TM.block_jacobi_invert = orig
            ma = a.solve_time_step()
            TM.block_jacobi_invert = noisy
            mb = b.solve_time_step()
            TM.block_jacobi_invert = orig
            du, dp, dcd = gaps(mb, b, ma, a)
            print(f"{name} step {k + 1}: port with tile inverses x (1 +- "
                  f"{delta:.2e}) vs port u {du:.3e} p {dp:.3e} Cd {dcd:.3e}",
                  flush=True)


if __name__ == "__main__":
    main()
