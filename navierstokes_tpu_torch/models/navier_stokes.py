"""Incompressible Navier-Stokes solver in PyTorch.

Port of ``navierstokes_tpu/models/navier_stokes.py`` on triangles (2D)
and tetrahedra (3D), on one of two operators:

* ``operator="bsr"`` (P2/P1; its operators kept in a compact layout for
  the SELL SpMV) with the block-Jacobi tile or the diagonal F
  preconditioner (``f_precond``), in both time schemes:

  - ``scheme="monolithic"`` (the reference's scheme, cpp:344-397): the
    saddle-point system per step by FGMRES with the ``cc``, ``pcd``,
    ``asimple``, ``ayosida`` or ``identity`` block preconditioner, its
    inner F solves by BiCGStab, GMRES or Richardson sweeps
    (``f_solver``), optional float64-residual refinement (``refine``) and
    bf16 inner F values (``inner_bf16`` / ``bj_bf16``);
  - ``scheme="projection"`` (BDF1 or BDF2) with the consistent P1
    Laplacian Poisson solve or the exact projection on the compatible
    B W B^T (``proj_poisson``), and the explicit pressure extrapolated
    (``proj_p_extrap``);

  The JAX package's layouts of the same operators, ``mass_format`` (its
  node-graph mass) and ``bj_tiles`` (how it gathers the tiles), are
  accepted: the port's mass sits in the F slots and its tiles come from
  the compact F values, the same values in one layout;

* ``operator="cells"``, the generic element operator (ops/operators.py:
  per-cell element matrices, batched einsums and fixed-order segment
  sums) for any Taylor-Hood pair the space takes.  Every pair other than
  P2/P1 switches to it in ``setup`` (with a printed line and
  ``config.operator`` set), as in the JAX model.  It runs the monolithic
  scheme only; ``setup`` refuses ``scheme="projection"`` on it
  (ValueError; JAX asserts at the first step).  As in JAX, the F
  preconditioner is the diagonal scaling whatever ``f_precond`` says,
  ``cc`` and ``pcd`` fall back to aSIMPLE, aSIMPLE and aYosida solve
  their Schur systems by Jacobi-BiCGStab (no V-cycle), ``refine`` does
  nothing and ``inner_bf16`` rounds the F values of the inner solves to
  bf16 (kept in the compute dtype).  Curved-boundary snapping is P2
  geometry: P3 and higher keep straight cells.  ``operator="ell"`` (the
  JAX package's node-graph operator) runs on it too, with the same
  fallbacks (JAX's every ``operator == "bsr"`` test is false under
  ``ell``); its inner Schur solves take the assembled diag(B W B^T) of
  JAX's graph (ops/operators.EllCellOps).

Both schemes take the outlet pressure ``p_out`` (the Neumann RHS,
src/NavierStokes.cpp:257-278) and an optional forcing term ``forcing``
(cpp:240-243): a torch callable ``f(x, t) -> (m, dim)`` of the physical
quadrature points ``x`` (m, dim) and the step's time ``t`` (a 0-d tensor),
on the model's device and dtype, evaluated every step.

The public surface follows the reference's class
(src/NavierStokes.hpp:173-189, src/postprocess.cpp): ``set_re_number``,
``setup``, ``assemble``, ``solve_time_step``, ``solve(time_step=N)`` with
restart, ``output``, ``export_data`` / ``import_data``,
``compute_forces``, ``post_process``, ``measured_cfl`` and ``.cd`` /
``.cl``.

``SolverConfig.n_devices`` > 1 splits the operator over several devices
in one process (``parallel/``, ``shard_devices``), the vectors staying on
``device``: the bsr operator by rows (parallel/sharded_bsr.py; the run
equals the one-device run bit for bit), the cells operator by contiguous
blocks of cells (parallel/sharded_cells.py, the JAX package's shard_map
cells path; the shards' node sums are added in shard order, so the run
agrees with one device to round-off, as JAX's does).  A value that no
option of the JAX package takes raises ``ValueError`` naming the option
(``check_config``).  Tensors live on the explicit ``device``; the
compute dtype is ``SolverConfig.dtype``.  One step is plain tensor code
plus, on ``bsr``, the SELL SpMV kernel on compact operator values
(``ops/sell.py``), with its Krylov loops on the device
(solvers/krylov.py).  On the card the one-device bsr step, in either
scheme, replays captured CUDA graphs (models/step_graphs.py;
``_step_projection`` and ``_step_monolithic`` are their plain versions);
the row shards, the cell shards and the cells operator step eagerly
(``_capture_refusal``).  ``solve`` runs chunks of steps to the next
output boundary and reads their metrics once per chunk, as the JAX
model's ``lax.scan`` chunks.

``config.scheme`` may change after ``setup()``, in either direction, as
in the JAX model: the next ``solve_time_step``/``solve`` builds what the
new scheme needs and setup did not (the Cahouet-Chabard operator Ap with
its coarse data, the Schur coarse G pairs under ``asimple``/``ayosida``,
refinement's float64 tables), keeps A0 as setup built it (JAX's flipped
step takes ``params.a0_cell`` as it is: a projection BDF2 setup leaves
c_t = 3/2 in the monolithic step's A0) and drops the captured graphs.
Monolithic to projection on the cells operator raises ValueError, as
setup does.  Differences from JAX:

* a change of any other field that setup reads (``_SETUP_FIELDS``:
  ``dtype``, ``operator``, ``n_devices``, ``preconditioner``,
  ``f_precond``, ``refine``, ``inner_bf16``, ...) raises ValueError
  naming the field at the next step; call ``setup()`` again;
* projection to monolithic under ``asimple``/``ayosida``: the port builds
  the whole-row Schur coarse G pairs, as a monolithic setup does; JAX's
  flipped step takes its Schur coarse matrix from the projection setup's
  split G table (``bsr_gb_kmax`` "auto" is -1 under projection), which
  leaves the spilled blocks out.  On the tests' h=0.1 channel that costs
  JAX 2 FGMRES iterations (19 against 17 under ``asimple``) and moves u
  by 1.4e-5; with ``bsr_gb_kmax=0`` the two agree to 8e-11.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time as _walltime

import numpy as np
import torch

from navierstokes_tpu_torch.config import InletConfig, SolverConfig
from navierstokes_tpu_torch.fem.spaces import TaylorHoodSpace
from navierstokes_tpu_torch.mesh.geometry import (Mesh, TAG_OBSTACLE,
                                                  TAG_OUTLET, TAG_WALL_BOTTOM,
                                                  TAG_WALL_TOP)
from navierstokes_tpu_torch.mesh.msh_io import read_msh
from navierstokes_tpu_torch.utils.checkpoint import (checkpoint_path,
                                                     export_state,
                                                     import_state)
from navierstokes_tpu_torch.utils.csv_logger import ForcesCsv
from navierstokes_tpu_torch.utils.vtu import write_vtu_pvtu
from navierstokes_tpu_torch.ops.assembly import (build_cell_arrays,
                                                 build_face_arrays,
                                                 build_forcing_data,
                                                 cell_arrays_numpy,
                                                 forcing_integral,
                                                 geometric_factors)
from navierstokes_tpu_torch.ops.boundary import build_dirichlet
from navierstokes_tpu_torch.ops.bsr import BsrOps, build_bsr
from navierstokes_tpu_torch.ops.forces import (drag_lift, force_coefficients,
                                               neumann_rhs)
from navierstokes_tpu_torch.ops.operators import (CellOps, EllCellOps,
                                                  segment_plan)
from navierstokes_tpu_torch.ops.p1ell import (BJ_INVERSIONS, assemble_ap,
                                              assemble_p1_stiffness,
                                              block_jacobi_apply,
                                              block_jacobi_inverse,
                                              block_jacobi_invert,
                                              build_block_jacobi_plan,
                                              coarse_from_ell, ell_matvec)
from navierstokes_tpu_torch.solvers.krylov import (HOST, MASKED,
                                                   BicgstabLoop, CgLoop,
                                                   GmresLoop, Mode,
                                                   iteration_mode)
from navierstokes_tpu_torch.solvers.preconditioners import (
    InnerSolve, make_asimple, make_ayosida, make_cahouet_chabard,
    make_identity, make_pcd)
from navierstokes_tpu_torch.parallel import sharded_bsr
from navierstokes_tpu_torch.parallel.sharded_cells import (ShardedCellOps,
                                                           ShardedCells)
from navierstokes_tpu_torch.parallel.sharding import (cell_partitioning,
                                                      shard_devices)
from navierstokes_tpu_torch.solvers.refine import Refinement, rhs_f64
from navierstokes_tpu_torch.solvers.schur import (build_coarse_plan,
                                                  coarse_inverse,
                                                  coarse_matrix,
                                                  estimate_lam_max,
                                                  make_vcycle_solver)

_DTYPES = {"float32": torch.float32, "float64": torch.float64}
# The SolverConfig fields that setup() reads (and those the captured
# graphs bake in: inner_bf16, proj_p_extrap, f_solver): a change after
# setup raises at the next step (``_sync_config``).  ``scheme`` may change
# (the module docstring).
_SETUP_FIELDS = ("dtype", "operator", "n_devices", "preconditioner",
                 "f_precond", "refine", "inner_bf16", "mass_format",
                 "bsr_block", "schur_agg_blocks", "bj_tile_blocks",
                 "curved_boundary", "p_out", "deltat", "proj_bdf2",
                 "proj_poisson", "proj_schur_pin_ratio", "proj_p_extrap",
                 "f_solver")


@dataclasses.dataclass
class StepMetrics:
    """Per-step scalars (host values)."""
    time: float
    iterations: int          # JAX's StepMetrics.iterations: outer FGMRES
    #                          (monolithic) or BiCGStab + CG (projection)
    residual: float          # final residual norm (monolithic: the true
    #                          residual after refinement; projection: the
    #                          larger of the two solves')
    converged: bool          # every solve of the step reached its tolerance
    drag: float
    lift: float
    cd: float
    cl: float
    prec_seconds: float      # block-Jacobi tile rebuild of the step
    f_iterations: int = 0    # projection: BiCGStab iterations of u*
    p_iterations: int = 0    # projection: CG iterations of the Poisson
    flag_reads: int = 0      # host reads of the step: the tile guard, the
    #                          loops' flags (eager: one per Krylov block
    #                          of a row-sharded projection step, else one
    #                          per iteration; captured: none) and the ends
    #                          of FGMRES's cycles
    masked_iterations: int = 0   # iterations run masked after a solve
    #                              stopped, inside its last block (a
    #                              row-sharded projection step), or bodies
    #                              a while node ran under a down flag
    #                              (captured, counted on the device)
    skipped_bodies: int = 0  # captured: evaluations of the while nodes'
    #                          conditions that neither ran a body nor
    #                          ended a loop (0 under while semantics)
    loops_entered: int = 0   # captured: while loops entered
    bodies_run: int = 0      # captured: while bodies run (iterations)
    exact_inverse: bool = False  # the tile rebuild took the exact inverse


# the fields of a step's metrics row on the device (float64), in order
_ROW = ("time", "iterations", "residual", "converged", "drag", "lift", "cd",
        "cl", "f_iterations", "p_iterations")


@dataclasses.dataclass
class _StepInfo:
    """What the host knows of a step without reading its row: the span of
    its tile rebuild, whether that took the exact inverse, the flags it
    read, the iteration slots of its blocks (BiCGStab + CG, masked
    blocks) and, captured, its while loops: the loops entered, the bodies
    run, the bodies run under a down flag and the skipped evaluations.
    ``settle``, when set, takes the values the step appended to its row
    and fills those (``_read_rows``)."""
    span: object = None
    exact_inverse: bool = False
    flag_reads: int = 0
    slots: int = 0
    loops: int = 0
    bodies: int = 0
    masked: int = 0
    skipped: int = 0
    settle: object = None


class _Workspace:
    """The tensors one step hands from segment to segment."""


class _Span:
    """The device time of a stretch of work: a pair of CUDA events on each
    device's current stream, read after the step's rows, so timing waits
    for nothing; the host clock on the CPU."""

    def __init__(self, devices):
        self._cuda = [d for d in devices if d.type == "cuda"]
        self._ev = []
        for d in self._cuda:
            a = torch.cuda.Event(enable_timing=True)
            a.record(torch.cuda.current_stream(d))
            self._ev.append((d, a, torch.cuda.Event(enable_timing=True)))
        self._t = [_walltime.perf_counter()]

    def stop(self):
        for d, _, b in self._ev:
            b.record(torch.cuda.current_stream(d))
        self._t.append(_walltime.perf_counter())
        return self

    def seconds(self) -> float:
        if not self._ev:
            return self._t[1] - self._t[0]
        out = 0.0
        for _, a, b in self._ev:
            b.synchronize()
            out = max(out, a.elapsed_time(b) / 1e3)
        return out


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


# the values each option takes in the JAX package; anything else raises
_CHOICES = {
    "scheme": ("projection", "monolithic"),
    "operator": ("bsr", "ell", "cells"),
    "preconditioner": ("cc", "pcd", "asimple", "ayosida", "identity"),
    "proj_poisson": ("laplacian", "schur"),
    "f_precond": ("bj", "jacobi", "diag"),
    "f_solver": ("bicgstab", "gmres", "richardson"),
    "bj_tiles": ("auto", "blocked", "rows", "scatter"),
    "mass_format": ("auto", "blocked", "node"),
    "dtype": tuple(_DTYPES),
}


def check_config(cfg: SolverConfig):
    """Raise ValueError, naming the option, for a value that is none of
    the JAX package's (``_CHOICES``): the JAX model would take it for one
    of its branches without a word.  Every value the JAX model runs is
    accepted."""
    for name, choices in _CHOICES.items():
        value = getattr(cfg, name)
        if value not in choices:
            raise ValueError(f"SolverConfig.{name}={value!r}: use one of "
                             f"{list(choices)}")


def _plus(b, term):
    """b + term; b itself when the term is absent (None)."""
    return b if term is None else b + term


class NavierStokes:
    """Constructor mirrors the reference's (mesh, degree_velocity,
    degree_pressure, deltat, T, step); ``device`` ("cpu", "cuda", ...) is
    required.  ``forcing``: the ForcingTerm hook
    (src/NavierStokes.hpp:56-65), a torch ``f(x (m, dim), t 0-d) ->
    (m, dim)``, or None (the reference's zero forcing).
    ``shard_devices``: the devices of the ``SolverConfig.n_devices``
    shards, row shards on bsr and cell shards on cells
    (parallel/sharding.shard_devices; default ``cuda:0 ..`` on a CUDA
    ``device``, the CPU on a CPU one); ``device`` is the home of the
    vectors."""

    def __init__(self, mesh, degree_velocity: int = 2,
                 degree_pressure: int = 1, deltat: float = 0.01,
                 T: float = 1.0, step: int = 10,
                 inlet: InletConfig | None = None,
                 config: SolverConfig | None = None, *, device,
                 forcing=None, shard_devices=None):
        self.config = config or SolverConfig()
        self.config.deltat = deltat
        self.config.t_final = T
        self.config.output_step = step
        self.inlet = inlet or InletConfig()
        check_config(self.config)
        self.forcing = forcing
        self.device = _resolve_device(device)
        self._shard_devices = shard_devices
        self.degree_velocity = degree_velocity
        self.degree_pressure = degree_pressure
        self._mesh_source = mesh
        self.nu = self.config.nu
        self.mesh: Mesh | None = None
        self.space: TaylorHoodSpace | None = None
        self.time = 0.0
        self.drag = self.lift = self.cd = self.cl = 0.0
        self._is_setup = False
        self._graphs = None

    # ------------------------------------------------------------------
    # setup & physics parameters
    # ------------------------------------------------------------------

    def set_re_number(self, Re: float):
        """nu = U_mean * ref_length / Re (src/NavierStokes.cpp:332-341)."""
        U = self.inlet.steady_mean_velocity()
        self.nu = (U * self.config.ref_length) / Re
        print(f"Reynolds number set to {Re} with nu = {self.nu}")
        if self._is_setup:
            self._build_static()

    def setup(self):
        cfg = self.config
        check_config(cfg)
        self.dtype = _DTYPES[cfg.dtype]
        dev = self.device
        src = self._mesh_source
        if isinstance(src, (str, os.PathLike)):
            self.mesh = read_msh(str(src))
        elif isinstance(src, Mesh):
            self.mesh = src
        else:
            # any object with the Mesh fields (e.g. the JAX package's mesh)
            self.mesh = Mesh(src.dim, src.points, src.cells,
                             src.boundary_faces, src.boundary_tags,
                             getattr(src, "snap_projectors", None))
        self.mesh.reorder_spatial()
        self.space = TaylorHoodSpace(self.mesh, self.degree_velocity,
                                     self.degree_pressure)
        sp = self.space
        self.dim = sp.dim
        print(sp.mesh.summary())
        print(f"DoFs: velocity {sp.n_velocity_dofs} + pressure "
              f"{sp.n_pressure_dofs} = {sp.n_dofs}")
        proj = getattr(self.mesh, "snap_projectors", None)
        if (cfg.curved_boundary and proj
                and self.degree_velocity == 2):  # snapping is P2 geometry
            snapped = sp.snap_boundaries(proj)
            if snapped:
                print(f"curved boundary: tags {snapped} snapped "
                      f"({len(sp.curved_data().ids)} superparametric cells)")
        if (cfg.operator == "bsr"
                and (self.degree_velocity, self.degree_pressure) != (2, 1)):
            print(f"operator 'bsr' is P2/P1-optimized; degrees "
                  f"({self.degree_velocity},{self.degree_pressure}) use "
                  "the generic 'cells' operator")
            cfg.operator = "cells"
        self._operator = cfg.operator
        # bsr row shards and cells shards (parallel/), each its own flag
        self._sharded = cfg.operator == "bsr" and cfg.n_devices > 1
        self._cell_sharded = cfg.operator != "bsr" and cfg.n_devices > 1
        if self._cell_sharded:
            self._operator = "cells"    # as JAX shards ell: by cells
        elif cfg.operator == "ell":
            print("operator 'ell' (the node-graph operator) runs on the "
                  "generic 'cells' operator: the same products, with the "
                  "assembled Schur diagonal")
        if self._operator != "bsr" and cfg.scheme == "projection":
            raise ValueError("scheme='projection' requires operator='bsr'")

        cells_host = cell_arrays_numpy(sp)
        self._cells_host = cells_host
        self.bc = build_dirichlet(sp, self.inlet, self.dtype, dev)

        # abs-lumped mass per node (reference cpp:232-236)
        rows = np.einsum("c,a->ca", cells_host.detj, sp.rs.Mlump_hat)
        cd = sp.curved_data()
        if cd is not None:
            wdet = cd.qw[None, :] * cd.detj_q
            absrow = np.abs(cd.phi_v) * np.abs(cd.phi_v).sum(
                axis=1, keepdims=True)
            rows[cd.ids] = np.einsum("kq,qa->ka", wdet, absrow)
        lm = np.zeros(sp.n_p2)
        np.add.at(lm, np.asarray(sp.cell_p2).reshape(-1), rows.reshape(-1))
        self._lumped_host = lm

        if self._cell_sharded:
            # the cells split into blocks over the shard devices (the JAX
            # model's shard_map cells path)
            self.cells = ShardedCells(
                sp, cells_host, sp.rs.T_hat, self.dtype, dev,
                shard_devices(dev, cfg.n_devices, self._shard_devices))
            self._op = self.cells
            self._ops = ShardedCellOps()
            self._bj_plan = self._ell64 = None
        elif self._operator != "bsr":
            # the element operator: no compact patterns, tiles, coarse
            # plan or pressure statics (the JAX model's cells and ell
            # branches)
            self.cells = build_cell_arrays(sp, self.dtype, dev,
                                           host=cells_host)
            self._op = self.cells
            ops = EllCellOps if self._operator == "ell" else CellOps
            self._ops = ops(sp, torch.as_tensor(
                sp.rs.T_hat, dtype=self.dtype, device=dev), dev)
            self._bj_plan = self._ell64 = None
        else:
            self._build_bsr(cells_host)

        tags = set(self.mesh.boundary_tags.tolist())
        self.faces_obst = (build_face_arrays(sp, TAG_OBSTACLE, self.dtype,
                                             dev)
                           if TAG_OBSTACLE in tags else None)
        # the constant Neumann RHS of p_out (cpp:257-278); None when zero
        self.rhs_neumann = None
        if TAG_OUTLET in tags and cfg.p_out != 0.0:
            faces_out = build_face_arrays(sp, TAG_OUTLET, self.dtype, dev)
            self.rhs_neumann = neumann_rhs(
                faces_out, cfg.p_out,
                segment_plan(faces_out.vel_nodes.cpu().numpy(), sp.n_p2,
                             dev))
        # quadrature data of the per-step forcing integral (cpp:240-243)
        self._forcing_data = (build_forcing_data(sp, self.dtype, dev)
                              if self.forcing is not None else None)
        self._build_static()
        self._is_setup = True
        self._scheme = cfg.scheme
        self._setup_values = {f: getattr(cfg, f) for f in _SETUP_FIELDS}

        # equilateral-equivalent cell size
        vols = np.abs(self.mesh.cell_volumes())
        h_c = (vols * (2.0 if self.dim == 2 else 6.0)) ** (1.0 / self.dim)
        self._cfl_dt_over_h = torch.as_tensor(cfg.deltat / h_c,
                                              dtype=self.dtype, device=dev)
        self._cell_p2 = torch.as_tensor(np.asarray(sp.cell_p2, np.int64),
                                        device=dev)
        if cfg.scheme == "projection" and cfg.proj_bdf2:
            cfl = self._static_cfl_estimate(h_c)
            if cfl > 2.0:
                print(f"WARNING: estimated advective CFL ~{cfl:.1f} > 2 "
                      f"(dt={cfg.deltat}); the BDF2 projection is unstable "
                      "in this regime — reduce deltat or set "
                      "proj_bdf2=False")
        return self

    def _static_cfl_estimate(self, h_c: np.ndarray) -> float:
        """Pre-run CFL screen: inlet peak speed capped by a laminar
        boundary-layer profile near no-slip walls (the measured CFL from
        the live field is authoritative)."""
        from scipy.spatial import cKDTree
        mesh = self.mesh
        u_peak = max(abs(self.inlet.u_m), 1e-30)
        u_cell = np.full(h_c.shape, u_peak)
        noslip = np.isin(mesh.boundary_tags,
                         (TAG_WALL_BOTTOM, TAG_WALL_TOP, TAG_OBSTACLE))
        if noslip.any():
            wall_pts = mesh.points[np.unique(
                mesh.boundary_faces[noslip].ravel())]
            cent = mesh.points[mesh.cells].mean(axis=1)
            d = cKDTree(wall_pts).query(cent, k=1)[0]
            u_mean = max(self.inlet.steady_mean_velocity(), 1e-30)
            re = max(u_mean * self.config.ref_length / self.nu, 1.0)
            delta = max(self.config.ref_length / np.sqrt(re), 1e-12)
            u_cell = u_peak * np.minimum(1.0, d / delta)
        return float(np.max(u_cell * self.config.deltat / h_c))

    def measured_cfl(self, u=None) -> float:
        """max over cells of (max nodal speed) * dt / h_cell."""
        u = self._u if u is None else u
        speed = torch.sqrt((u * u).sum(dim=-1))
        return float((speed[self._cell_p2].max(dim=1).values
                      * self._cfl_dt_over_h).max())

    def _build_bsr(self, cells_host):
        """The compact operators, the pressure-side statics and what the
        scheme needs (``_build_scheme_statics``) (``operator="bsr"``).
        With ``n_devices`` > 1 the operators are built on the CPU and split
        by rows over the shard devices (parallel/sharded_bsr.py); the rest
        stays on the home device."""
        cfg, sp, dev = self.config, self.space, self.device
        blk = cfg.bsr_block or None
        if self._sharded:
            full = build_bsr(sp, cells_host, self.dtype, "cpu", bu=blk,
                             bp=blk)
            self.ell = sharded_bsr.ShardedBsr(
                full, sp.cell_p1, dev,
                shard_devices(dev, cfg.n_devices, self._shard_devices),
                self._bj_tile_blocks(full.bu) * full.bu)
            self._ops = sharded_bsr.ShardedBsrOps()
        else:
            self.ell = build_bsr(sp, cells_host, self.dtype, dev, bu=blk,
                                 bp=blk)
            self._ops = BsrOps()
        self._op = self.ell
        self._agg_blocks = cfg.schur_agg_blocks or max(1, 64 // self.ell.bp)
        self._coarse_plan = self._ap = self._ell64 = None
        self._build_cc_statics()
        self._build_scheme_statics()

    def _build_scheme_statics(self):
        """What ``config.scheme`` needs on bsr and is not built yet: the
        Schur coarse plan (with the G block pairs under monolithic
        ``asimple``/``ayosida``), refinement's float64 tables and the
        Cahouet-Chabard operator Ap = B diag(mask/M_lumped) B^T with its
        coarse inverse and lambda_max (monolithic).  Run by setup and by
        the first step after a change of scheme (``_sync_config``)."""
        cfg, sp = self.config, self.space
        mono = cfg.scheme == "monolithic"
        schur_coarse = mono and cfg.preconditioner in ("asimple", "ayosida")
        plan = self._coarse_plan
        if plan is None or (schur_coarse and plan.pair_plan is None):
            h = self.ell.host
            self._coarse_plan = build_coarse_plan(
                sp.n_p1, self.ell.bp, self._agg_blocks,
                g_cols=h.g_cols_full if schur_coarse else None,
                g_agg=h.g_agg if schur_coarse else None, dtype=self.dtype,
                device=self.device)
        # refinement's float64 copies of the static values: fp32 runs, and
        # only where the JAX model refines, i.e. where it keeps a blocked
        # mass ("blocked", or "auto" in 2D; "auto" is its node mass in 3D)
        blocked = cfg.mass_format == "blocked" or (
            cfg.mass_format == "auto" and self.dim == 2)
        refines = (mono and cfg.refine > 0 and self.dtype == torch.float32
                   and blocked)
        if refines and self._ell64 is None:
            self._ell64 = self._ops.float64_tables(self.ell)
        if mono and self._ap is None:
            mask_flat = self.bc.host_mask[:, 0]
            self._ap = assemble_ap(sp, self._cells_host,
                                   mask_flat / self._lumped_host, self.dtype,
                                   self.device, b=self.ell.bp)
            self._ap_sc_inv, self._ap_lam = self._coarse_statics(self._ap)

    def _bj_tile_blocks(self, bu: int) -> int:
        """S, the node blocks per block-Jacobi tile."""
        return self.config.bj_tile_blocks or max(1, 256 // bu)

    def _devices(self):
        """The home device and every shard device."""
        devs = [self.device]
        shards = (self.ell.shards if self._sharded else
                  self.cells.shards if self._cell_sharded else [])
        devs += [s.device for s in shards if s.device not in devs]
        return devs

    def _coarse_statics(self, op):
        """(dense coarse inverse, lambda_max) of an assembled P1 operator
        for its V-cycle."""
        sc = coarse_from_ell(op, self._agg_blocks)
        scale = np.abs(np.diag(sc)).mean() + 1e-30
        sc_inv = torch.as_tensor(
            np.linalg.inv(sc + 1e-8 * scale * np.eye(sc.shape[0])),
            dtype=self.dtype, device=self.device)
        sdinv = torch.where(op.diag != 0, 1.0 / op.diag,
                            torch.ones_like(op.diag))
        lam = estimate_lam_max(lambda v: ell_matvec(op, v), sdinv,
                               self.space.n_p1, self.dtype)
        return sc_inv, lam

    def _p1_vcycle(self, which: str, n_cycles: int):
        """The V-cycle solver of the assembled P1 operator ``which``
        (``"ap_dir"``: the outlet-pinned Laplacian of the projection
        Poisson solve; ``"ap"``: Ap of ``cc``/``pcd``) at ``n_cycles`` and
        ``config.schur_smooth_k``, made once for each operator, cycle count
        and k (``_build_cc_statics`` drops them): on the card its
        coefficients and work vectors are static (solvers/schur.py
        ``FusedVcycle``), so a call runs no scalar work and allocates only
        its output, and the first call, which makes it, comes in the
        graphs' eager warm-up, outside any capture."""
        k = self.config.schur_smooth_k
        solve = self._vcycles.get((which, n_cycles, k))
        if solve is None:
            op = getattr(self, f"_{which}")
            solve = make_vcycle_solver(
                lambda v: ell_matvec(op, v), op.diag, self._coarse_plan,
                getattr(self, f"_{which}_sc_inv"), n_cycles=n_cycles,
                smooth_k=k, lam_max=getattr(self, f"_{which}_lam"), op=op)
            self._vcycles[which, n_cycles, k] = solve
        return solve

    def _build_cc_statics(self):
        """Static pressure-side data of either scheme: the masked
        velocity-correction weights, the block-Jacobi plan, the
        outlet-pinned P1 Laplacian with its coarse inverse and lambda_max,
        the pin set of ``proj_poisson="schur"`` and the lumped pressure
        mass (Ap, monolithic only, is built by
        ``_build_scheme_statics``).  The block-Jacobi plan exists under
        f_precond="bj" only."""
        sp, dev, dt_ = self.space, self.device, self.dtype
        cfg = self.config
        mask_flat = self.bc.host_mask[:, 0]
        self._ap_w = torch.as_tensor(mask_flat / self._lumped_host,
                                     dtype=dt_, device=dev)
        S = self._bj_tile_blocks(self.ell.bu)
        self._bj_plan = None
        if cfg.f_precond == "bj" and self._sharded:
            self._bj_plan = sharded_bsr.block_jacobi_plan(self.ell, S)
        elif cfg.f_precond == "bj":
            self._bj_plan = build_block_jacobi_plan(
                self.ell.f, self.ell.bu, sp.n_p2, S=S, device=dev)
        out_sel = self.mesh.boundary_tags == TAG_OUTLET
        out_nodes = (np.unique(self.mesh.boundary_faces[out_sel])
                     if np.any(out_sel) else None)
        self._ap_dir_pinned = out_nodes is not None
        pin = np.ones(sp.n_p1)
        if self._ap_dir_pinned:
            pin[out_nodes] = 0.0
        self._ap_dir_pin = torch.as_tensor(pin, dtype=dt_, device=dev)
        self._ap_schur_pin = None
        if cfg.proj_poisson == "schur":
            # the exact projection's pin set (JAX's _build_cc_statics): phi
            # = 0 at the outlet and where the masked diag(B W B^T) keeps
            # less than proj_schur_pin_ratio of its unmasked weight (nodes
            # whose velocity stencil is mostly Dirichlet: exact zero
            # divergence there grows a boundary pressure mode)
            d_m = self._ops.schur_diag(self.ell, self._ap_w)
            d_r = self._ops.schur_diag(self.ell, torch.as_tensor(
                1.0 / self._lumped_host, dtype=dt_, device=dev))
            crippled = (d_m < cfg.proj_schur_pin_ratio * d_r).cpu().numpy()
            self._ap_schur_pin = torch.as_tensor(pin * ~crippled, dtype=dt_,
                                                 device=dev)
        self._ap_dir = assemble_p1_stiffness(sp, self._cells_host, dt_, dev,
                                             b=self.ell.bp,
                                             dirichlet_nodes=out_nodes)
        self._vcycles = {}          # _p1_vcycle's solvers of these operators
        self._ap_dir_sc_inv, self._ap_dir_lam = self._coarse_statics(
            self._ap_dir)
        # lumped P1 mass: detJ * reference measure / (dim + 1) per vertex
        detj, _ = geometric_factors(sp)
        coeff = (0.5 / 3.0) if self.dim == 2 else (1.0 / 6.0 / 4.0)
        mp_rows = np.repeat((detj * coeff)[:, None], sp.cell_p1.shape[1],
                            axis=1)
        cd = sp.curved_data()
        if cd is not None:
            wdet = cd.qw[None, :] * cd.detj_q
            mp_rows[cd.ids] = np.einsum("kq,qj->kj", wdet, cd.phi_p)
        mp = np.zeros(sp.n_p1)
        np.add.at(mp, np.asarray(sp.cell_p1).reshape(-1), mp_rows.reshape(-1))
        self._mp_lumped = torch.as_tensor(mp, dtype=dt_, device=dev)

    def _build_static(self):
        """A0 = c_t M/dt + nu K (c_t = 3/2 for the BDF2 projection): the
        compact F values combined on the host (bsr) or the per-cell
        matrices (cells); the dt / lumped-mass vector of aYosida; the
        Newton seed follows A0 (``_bj_seed``)."""
        cfg = self.config
        ct = 1.5 if cfg.scheme == "projection" and cfg.proj_bdf2 else 1.0
        if self._cell_sharded:
            self.a0_cell = self.cells.static(ct / cfg.deltat, self.nu)
        elif self._operator != "bsr":
            self.a0_cell = ((ct / cfg.deltat) * self.cells.mass
                            + self.nu * self.cells.stiff)
        else:
            h = self.ell.host
            values = (self.ell.f_values if self._sharded
                      else self.ell.f.values)
            self.a0_cell = values(
                (ct / cfg.deltat) * h.m_nz + self.nu * h.k_nz, self.dtype)
        self.dt_mlump_inv = torch.as_tensor(
            (cfg.deltat / self._lumped_host)[:, None], dtype=self.dtype,
            device=self.device)
        self._nu_t = torch.tensor(self.nu, dtype=self.dtype,
                                  device=self.device)
        self._u_mean0 = torch.tensor(self.inlet.steady_mean_velocity(),
                                     dtype=self.dtype, device=self.device)
        self._bj_x0 = None
        self._graphs = None      # captured against the old A0

    def _bj_seed(self):
        """Exact tile inverses of the BC-masked static operator A0: the
        Newton-Schulz seed of the per-step inversion (computed once)."""
        if self.config.bj_newton <= 0 or self._bj_plan is None:
            return None
        if self._bj_x0 is None:
            mflat = self.bc.mask[:, 0]
            d = self._ops.f_diag(self.ell, self.a0_cell)
            sigma0 = (torch.sum(d * mflat)
                      / torch.clamp(torch.sum(mflat), min=1.0))
            inverse = (sharded_bsr.block_jacobi_inverse if self._sharded
                       else block_jacobi_inverse)
            self._bj_x0 = inverse(self._bj_plan, self.a0_cell, mflat, sigma0)
        return self._bj_x0

    def _time_factor(self, t):
        one = torch.ones((), dtype=self.dtype, device=self.device)
        f = (torch.sin(math.pi * t / self.inlet.period)
             if self.inlet.pulsating else one)
        r = self.inlet.ramp
        if r:
            f = f * torch.where(t >= r, one,
                                0.5 - 0.5 * torch.cos(math.pi * t / r))
        return f.to(self.dtype)

    # ------------------------------------------------------------------
    # one time step
    # ------------------------------------------------------------------

    def _bf16_inner(self) -> bool:
        """``inner_bf16`` applies in fp32 runs only, as in the JAX model."""
        return bool(self.config.inner_bf16) and self.dtype == torch.float32

    def _f_precond(self, f_cell, mflat, sigma, dinv):
        """The F preconditioner of the step, the span of its rebuild
        (time_prec_init) and whether the rebuild took the exact inverse.
        "bj": the per-step block-Jacobi tile inverses, in bf16 under
        ``inner_bf16`` / ``bj_bf16`` (fp32 runs), timed by ``_Span``;
        the Newton-Schulz guard is read once, before the branch.
        Otherwise ("jacobi", "diag", as in the JAX model) the diagonal
        scaling ``dinv``, nothing to rebuild (no span)."""
        if self._bj_plan is None:
            return (lambda r: r * dinv), None, False
        cfg = self.config
        invert, apply = ((sharded_bsr.block_jacobi_invert,
                          sharded_bsr.block_jacobi_apply) if self._sharded
                         else (block_jacobi_invert, block_jacobi_apply))
        exact0 = BJ_INVERSIONS["exact"]
        span = _Span(self._devices())
        inv_tiles = invert(self._bj_plan, f_cell, mflat, sigma,
                           x0=self._bj_seed(), iters=cfg.bj_newton,
                           out_dtype=self._tiles_dtype())
        span.stop()
        return ((lambda r: apply(self._bj_plan, inv_tiles, r)), span,
                BJ_INVERSIONS["exact"] > exact0)

    def _tiles_dtype(self):
        """The tile inverses' dtype: bf16 under ``inner_bf16`` /
        ``bj_bf16`` (fp32 runs), else the model's; the last Newton-Schulz
        update writes it (the exact inverse casts to it)."""
        cfg = self.config
        if self.dtype == torch.float32 and (cfg.inner_bf16 or cfg.bj_bf16):
            return torch.bfloat16
        return self.dtype

    def _forcing_term(self, t_new):
        """The forcing integral at ``t_new``; None without forcing."""
        if self._forcing_data is None:
            return None
        return forcing_integral(self._forcing_data, self.forcing, t_new)

    def _forces(self, u_new, p_new, factor):
        """(drag, lift, Cd, Cl) on the obstacle (cpp:831-929), 0-d tensors
        on the model's device."""
        if self.faces_obst is None:
            zero = torch.zeros((), dtype=self.dtype, device=self.device)
            return zero, zero, zero, zero
        cfg = self.config
        drag, lift = drag_lift(self.faces_obst, u_new, p_new, self._nu_t,
                               formula=cfg.force_formula)
        u_mean0 = self._u_mean0
        u_norm = u_mean0 * factor if self.inlet.pulsating else u_mean0
        cd, cl = force_coefficients(drag, lift, u_norm, cfg.ref_length,
                                    self.dim, cfg.span_3d)
        return drag, lift, cd, cl

    def _metrics_row(self, t_new, iterations, residual, converged, forces,
                     f_iterations=0, p_iterations=0):
        """The step's metrics as one float64 row on the device (``_ROW``):
        read with the other rows of its chunk (``_read_rows``)."""
        vals = (t_new, iterations, residual, converged, *forces,
                f_iterations, p_iterations)
        f64 = dict(dtype=torch.float64, device=self.device)
        return torch.stack([v.to(torch.float64) if isinstance(v, torch.Tensor)
                            else torch.full((), v, **f64) for v in vals])

    def _step_projection(self, u, p, t_prev, u_prev, phi_prev):
        """Rotational incremental pressure-correction step (Guermond,
        Minev & Shen 2006); BDF2 with C(2u^n - u^{n-1}) and
        dt_eff = 2 dt / 3 under ``proj_bdf2``:

            (c_t M/dt + nu K + C(u_adv)) u* = M u_t - G p*   [+ BCs]
            Lp phi = B u* / dt_eff     (consistent P1 Laplacian)
            u^{n+1} = u* - dt_eff W G phi   (W = diag(mask / M_lumped))
            p^{n+1} = p* + phi + nu Mp^-1 (B u*)   [rotational]

        p* = p^n, or p^n + theta phi_prev under ``proj_p_extrap`` = theta
        (phi then carries the whole pressure change p^{n+1} - p^n, and the
        CG starts from zero).  ``proj_poisson="schur"`` takes for Lp the
        compatible S = B W B^T, pinned at the outlet and at the nodes of
        ``_ap_schur_pin``: the projection is then exact to the CG
        tolerance at the other nodes (JAX's ``_step_projection``).

        The plain (eager) version of the captured step
        (models/step_graphs.py): the same segments in the same order, with
        the tile guard read as it comes and each Krylov iteration run after
        a host read of its flag (krylov ``HOST``), where the graphs put the
        loop under a while node; row shards, which step eagerly by rule,
        run masked blocks (krylov ``MASKED``: the same bits).  Returns
        (u_new, p_new, t_new, phi, metrics row, _StepInfo)."""
        ws = _Workspace()
        with iteration_mode(Mode(MASKED if self._sharded else HOST)):
            self._proj_rebuild(ws, u, u_prev, t_prev)
            pre_f, span, exact = self._f_precond(ws.f_cell, ws.mflat,
                                                 ws.sigma, ws.dinv)
            floop = self._proj_momentum(ws, u, p, u_prev, phi_prev, pre_f)
            floop.run()
            ploop = self._proj_poisson(ws, phi_prev)
            ploop.run()
            u_new, p_new, phi, row = self._proj_finish(ws, p)
        info = _StepInfo(span=span, exact_inverse=exact,
                         flag_reads=floop.reads + ploop.reads
                         + (self._bj_plan is not None
                            and self.config.bj_newton > 0),
                         slots=(floop.blocks * floop.check_every
                                + ploop.blocks * ploop.check_every))
        return u_new, p_new, ws.t_new, phi, row, info

    def _proj_rebuild(self, ws, u, u_prev, t_prev):
        """Segment (a) of the projection step: t_new, the BDF terms, the F
        values A0 + C(u_adv), sigma and the diagonal scaling."""
        cfg = self.config
        ops, ell, mask = self._ops, self.ell, self.bc.mask
        dt = cfg.deltat
        ws.t_new = t_prev + dt
        if cfg.proj_bdf2:
            ws.alpha = 1.5
            u_adv = 2.0 * u - u_prev
            ws.u_t = (4.0 * u - u_prev) / (2.0 * dt)
        else:
            ws.alpha = 1.0
            u_adv = u
            ws.u_t = u / dt
        ws.f_cell = self.a0_cell + ops.convection(ell, u_adv)
        d = ops.f_diag(ell, ws.f_cell)
        ws.mflat = mask[:, 0]
        ws.sigma = (torch.sum(d * ws.mflat)
                    / torch.clamp(torch.sum(ws.mflat), min=1.0))
        ws.dinv = (1.0 / (d * ws.mflat + ws.sigma * (1.0 - ws.mflat)))[:, None]
        ws.zero_p = torch.zeros(self.space.n_p1, dtype=self.dtype,
                                device=self.device)
        # bf16 F values inside the u* solve (vectors and sums stay fp32)
        ws.f_inner = (ws.f_cell.to(torch.bfloat16) if self._bf16_inner()
                      else ws.f_cell)

    def _proj_momentum(self, ws, u, p, u_prev, phi_prev, pre_f):
        """Segment (c): the explicit pressure p*, the u* right-hand side
        and the BiCGStab set-up (the loop, not yet run)."""
        cfg = self.config
        ops, ell, bc = self._ops, self.ell, self.bc
        mask, sigma, zero_p = bc.mask, ws.sigma, ws.zero_p
        f_inner = ws.f_inner

        def apply_F(xu):
            xum = xu * mask
            yu, _ = ops.apply_blocks(ell, f_inner, xum, zero_p,
                                     with_g=False, with_gt=False)
            return (yu * mask + sigma * (xu - xum)).to(self.dtype)

        theta = cfg.proj_p_extrap
        ws.p_ref = p + theta * phi_prev if theta != 0.0 else p
        ws.factor = self._time_factor(ws.t_new)
        ws.g = bc.lift(ws.factor)
        # the JAX model's order: M u + Neumann - B^T p* + forcing
        b_u = _plus(_plus(ops.mass_apply(ell, ws.u_t), self.rhs_neumann)
                    - self._apply_bt_raw(ws, ws.p_ref),
                    self._forcing_term(ws.t_new))
        fg, _ = ops.apply_blocks(ell, ws.f_cell, ws.g, zero_p, with_g=False,
                                 with_gt=False)
        b_u = (b_u - fg) * mask + sigma * ws.g
        ws.tol = self._proj_tol()
        u_guess = 2.0 * u - u_prev
        ws.floop = BicgstabLoop(apply_F, b_u, x0=u_guess * mask + ws.g,
                                tol=ws.tol, maxiter=cfg.proj_f_maxiter,
                                precond=pre_f)
        return ws.floop

    def _proj_tol(self):
        tol = self.config.proj_tol
        return max(tol, 3.0e-6) if self.dtype == torch.float32 else tol

    def _apply_bt_raw(self, ws, xp):
        yu, _ = self._ops.apply_blocks(self.ell, ws.f_cell,
                                       torch.zeros_like(ws.u_t), xp,
                                       with_f=False, with_gt=False)
        return yu

    def _proj_poisson(self, ws, phi_prev):
        """Segment (e): u*, its divergence and the CG set-up of the
        pressure Poisson Lp phi = B u* / dt_eff, or S phi = B u* / dt_eff
        under ``proj_poisson="schur"`` (the loop, not yet run)."""
        cfg = self.config
        ws.u_star = ws.floop.x.reshape(ws.u_t.shape) * self.bc.mask + ws.g
        pinned = self._ap_dir_pinned
        ap_op = self._ap_dir
        apply_ap = lambda v: ell_matvec(ap_op, v)
        solve_ap = self._p1_vcycle("ap_dir", 1)
        if not pinned:
            # closed domain: keep the preconditioner output mean-free
            _solve0 = solve_ap
            solve_ap = lambda r: (lambda z: z - torch.mean(z))(_solve0(r))
        _, ws.div_star = self._ops.apply_blocks(
            self.ell, ws.f_cell, ws.u_star, ws.zero_p, with_f=False,
            with_g=False)
        dt_eff = cfg.deltat / ws.alpha
        rhs_p = ws.div_star / dt_eff
        ws.pin_phi = self._ap_dir_pin
        apply_p = apply_ap
        if cfg.proj_poisson == "schur":
            # S = B W B^T with W the masked weights of the correction, the
            # Laplacian V-cycle as its preconditioner
            ws.pin_phi = pin_phi = self._ap_schur_pin
            w_col = self._ap_w[:, None]

            def apply_p(xp):
                xm = xp * pin_phi
                _, y = self._ops.apply_blocks(
                    self.ell, ws.f_cell, w_col * self._apply_bt_raw(ws, xm),
                    ws.zero_p, with_f=False, with_g=False)
                return y * pin_phi + (xp - xm)

            rhs_p = rhs_p * pin_phi
        elif pinned:
            rhs_p = rhs_p * self._ap_dir_pin
        else:
            rhs_p = rhs_p - torch.mean(rhs_p)
        # under proj_p_extrap phi is the change of the increments: from 0
        x0 = None if cfg.proj_p_extrap != 0.0 else phi_prev
        ws.ploop = CgLoop(apply_p, rhs_p, x0=x0, tol=ws.tol,
                          maxiter=cfg.proj_p_maxiter, precond=solve_ap)
        return ws.ploop

    def _proj_finish(self, ws, p):
        """Segment (g): the correction, the rotational pressure update, the
        forces and the metrics row.  Returns (u_new, p_new, phi, row)."""
        cfg = self.config
        floop, ploop = ws.floop, ws.ploop
        x_p = ploop.x
        phi = (x_p * ws.pin_phi
               if self._ap_dir_pinned or cfg.proj_poisson == "schur"
               else x_p - torch.mean(x_p))
        dt_eff = cfg.deltat / ws.alpha
        u_new = ws.u_star - dt_eff * (self._ap_w[:, None]
                                      * self._apply_bt_raw(ws, phi))
        u_new = u_new * self.bc.mask + ws.g
        p_new = ws.p_ref + phi
        if cfg.proj_rotational:
            p_new = p_new + self._nu_t * (ws.div_star / self._mp_lumped)
        if cfg.proj_p_extrap != 0.0:
            # the whole change, rotational term included: the next step's
            # p* = p + theta (p^n - p^{n-1})
            phi = p_new - p
        res_f, res_p = floop.residual(), ploop.residual()
        converged = (res_f <= floop.target) & (res_p <= ploop.target)
        row = self._metrics_row(
            ws.t_new, floop.k + ploop.k, torch.maximum(res_f, res_p),
            converged, self._forces(u_new, p_new, ws.factor),
            floop.k, ploop.k)
        return u_new, p_new, phi, row

    def _step_monolithic(self, u, p, t_prev, u_prev, phi_prev):
        """One semi-implicit step of the reference's saddle-point system
        (cpp:344-397) with the Dirichlet rows masked:

            [ M/dt + nu K + C(u^n)   G ] [u^{n+1}]   [ M u^n / dt ]
            [ B                      0 ] [p^{n+1}] = [ 0          ]

        solved by FGMRES from (2u^n - u^{n-1}, p^n) with the configured
        block preconditioner, then ``refine`` passes of float64-residual
        refinement (fp32 runs, bsr; the cells operator's fallbacks are in
        the module docstring).  ``phi_prev`` passes through unchanged.

        The plain (eager) version of the captured step
        (models/step_graphs.py): the same segments in the same order, each
        Krylov iteration run after a host read of its flag (krylov
        ``HOST``), where the graphs put each loop under a while node.
        Returns (u_new, p_new, t_new, phi_prev, metrics row, _StepInfo)."""
        cfg = self.config
        ws = _Workspace()
        with iteration_mode(Mode(HOST)) as mode:
            self._mono_rebuild(ws, u, t_prev)
            pre_f, span, exact = self._f_precond(ws.f_cell, ws.mflat,
                                                 ws.sigma, ws.dinv)
            self._mono_system(ws, u, p, u_prev, pre_f).run()
            if self._refines():
                self._mono_refine_start(ws, u)
                for _ in range(cfg.refine):
                    self._mono_correction(ws)
                    ws.gloop.begin(cfg.refine_maxiter)
                    ws.gloop.run()
                    ws.refinement.add(ws.gloop.solution())
            u_new, p_new, row = self._mono_finish(ws)
        guard = self._bj_plan is not None and cfg.bj_newton > 0
        info = _StepInfo(span=span, exact_inverse=exact,
                         flag_reads=mode.reads + guard)
        return u_new, p_new, ws.t_new, phi_prev, row, info

    def _refines(self) -> bool:
        """Whether the monolithic step refines (``refine`` passes on the
        float64 tables)."""
        return self._ell64 is not None and self.config.refine > 0

    def _mono_rebuild(self, ws, u, t_prev):
        """Segment (a) of the monolithic step: t_new, the F values
        A0 + C(u), sigma, the diagonal scaling and the inner solves' F
        values."""
        ops, op, mask = self._ops, self._op, self.bc.mask
        ws.t_new = t_prev + self.config.deltat
        ws.f_cell = self.a0_cell + ops.convection(op, u)
        d = ops.f_diag(op, ws.f_cell)
        ws.mflat = mask[:, 0]
        ws.sigma = (torch.sum(d * ws.mflat)
                    / torch.clamp(torch.sum(ws.mflat), min=1.0))
        ws.dinv = (1.0 / (d * ws.mflat + ws.sigma * (1.0 - ws.mflat)))[:, None]
        ws.zero_p = torch.zeros(self.space.n_p1, dtype=self.dtype,
                                device=self.device)
        # bf16 F values for the preconditioner's inner solves; the cells
        # operator's einsums take one dtype, so there the rounded values
        # stay fp32, as JAX's bf16-by-fp32 einsum promotes them
        ws.f_inner = ws.f_cell
        if self._bf16_inner():
            ws.f_inner = ws.f_cell.to(torch.bfloat16)
            if self._operator != "bsr":
                ws.f_inner = ws.f_inner.to(self.dtype)

    def _mono_system(self, ws, u, p, u_prev, pre_f):
        """Segment (c): the RHS with the lift, the block preconditioner's
        per-step set-up and FGMRES's set-up, its first cycle included
        (the loop, not yet run)."""
        cfg = self.config
        ops, op, bc = self._ops, self._op, self.bc
        mask, dt = bc.mask, cfg.deltat
        f_cell, f_inner, sigma = ws.f_cell, ws.f_inner, ws.sigma
        zero_p = ws.zero_p

        def apply_A(x):
            xu, xp = x
            xum = xu * mask
            yu, yp = ops.apply_blocks(op, f_cell, xum, xp)
            return yu * mask + sigma * (xu - xum), yp

        def apply_F(xu):
            xum = xu * mask
            yu, _ = ops.apply_blocks(op, f_inner, xum, zero_p,
                                     with_g=False, with_gt=False)
            return (yu * mask + sigma * (xu - xum)).to(self.dtype)

        def apply_Bt(xp):
            yu, _ = ops.apply_blocks(op, f_cell, u, xp, with_f=False,
                                     with_gt=False)
            return yu * mask

        def apply_B(xu):
            _, yp = ops.apply_blocks(op, f_cell, xu * mask, zero_p,
                                     with_f=False, with_g=False)
            return yp

        # ---- RHS (cpp:240-278): M u^n / dt + Neumann + forcing, lifted ----
        ws.factor = self._time_factor(ws.t_new)
        ws.g = g = bc.lift(ws.factor)
        ws.f_extra = self._forcing_term(ws.t_new)
        b_u = _plus(_plus(ops.mass_apply(op, u) / dt, self.rhs_neumann),
                    ws.f_extra)
        ag_u, ag_p = ops.apply_blocks(op, f_cell, g, zero_p)
        b_u = (b_u - ag_u) * mask + sigma * g
        b_p = -ag_p

        M = self._block_preconditioner(ws, u, pre_f, apply_F, apply_B,
                                       apply_Bt)

        # ---- outer FGMRES, warm-started by extrapolation ----
        tol = cfg.outer_tol
        if self.dtype == torch.float32:
            tol = max(tol, 3.0e-6)      # the fp32 attainable-residual floor
        x0 = ((2.0 * u - u_prev) * mask + g, p)
        ws.gloop = GmresLoop(apply_A, (b_u, b_p), x0, tol=tol,
                             restart=cfg.outer_restart,
                             maxiter=cfg.outer_maxiter, precond=M,
                             flexible=True)
        return ws.gloop

    def _block_preconditioner(self, ws, u, pre_f, apply_F, apply_B,
                              apply_Bt):
        """The step's block preconditioner M, with its per-step set-up:
        the Schur V-cycle's coarse inverse and lambda_max (aSIMPLE,
        aYosida) or the PCD convection.  The inner F solves are
        ``f_solver``'s: BiCGStab or GMRES to ``inner_tol``, or
        ``inner_maxiter_f`` preconditioned Richardson sweeps."""
        cfg, ops, op = self.config, self._ops, self._op
        dinv, mflat = ws.dinv, ws.mflat
        # the F solves take the step's apply_F and F preconditioner
        # whatever the block preconditioner hands them, as the JAX model's
        # inner_f
        if cfg.f_solver == "richardson":
            def inner_f(op, rhs, pre=None):
                x = pre_f(rhs)
                for _ in range(cfg.inner_maxiter_f - 1):
                    x = x + pre_f(rhs - apply_F(x))
                return x
        else:
            _inner_f = InnerSolve(cfg.inner_tol, cfg.inner_maxiter_f,
                                  method=cfg.f_solver)
            inner_f = lambda op, rhs, pre=None: _inner_f(op, rhs, pre_f)
        inner_s = InnerSolve(cfg.inner_tol, cfg.inner_maxiter_s)
        vcycles = dict(n_cycles=cfg.schur_vcycles,
                       smooth_k=cfg.schur_smooth_k)

        def vcycle_s(node_weights, diag_s):
            """Two-level V-cycle on S = B diag(w) B^T: per-step coarse
            matrix (inverted in fp32) and lambda_max estimate.  None on
            the cells operator (Jacobi-BiCGStab instead), as in JAX."""
            if self._operator != "bsr":
                return None
            sc_inv = coarse_inverse(coarse_matrix(self.ell, self._coarse_plan,
                                                  node_weights))

            def apply_s(v):
                return apply_B(apply_Bt(v) * node_weights[:, None])

            sdinv = torch.where(diag_s != 0, 1.0 / diag_s,
                                torch.ones_like(diag_s))
            lam = estimate_lam_max(apply_s, sdinv, self.space.n_p1,
                                   self.dtype)
            return make_vcycle_solver(apply_s, diag_s, self._coarse_plan,
                                      sc_inv, lam_max=lam, **vcycles)

        pc = cfg.preconditioner
        if pc in ("cc", "pcd") and self._operator != "bsr":
            pc = "asimple"      # the JAX model's fallback off the bsr path
        if pc in ("cc", "pcd"):
            apply_ap = lambda v: ell_matvec(self._ap, v)
            solve_ap = self._p1_vcycle("ap", cfg.schur_vcycles)
            if pc == "pcd":
                np_flat = ops.pressure_convection(self.ell, u)
                return make_pcd(apply_F, apply_Bt, solve_ap, apply_ap,
                                lambda v: ops.apply_pp(self.ell, np_flat, v),
                                self._mp_lumped, dinv, cfg.deltat,
                                self._nu_t, inner_f)
            return make_cahouet_chabard(apply_F, apply_Bt, solve_ap,
                                        self._mp_lumped, dinv, cfg.deltat,
                                        self._nu_t, inner_f)
        if pc in ("asimple", "ayosida"):
            w = (dinv if pc == "asimple" else self.dt_mlump_inv)[:, 0] * mflat
            diag_s = ops.schur_diag(op, w)
            if pc == "asimple":
                return make_asimple(apply_F, apply_B, apply_Bt, dinv, diag_s,
                                    cfg.alpha, inner_f, inner_s,
                                    solve_s=vcycle_s(w, diag_s))
            return make_ayosida(apply_F, apply_B, apply_Bt, dinv,
                                self.dt_mlump_inv, diag_s, inner_f, inner_s,
                                solve_s=vcycle_s(w, diag_s))
        return make_identity()

    def _mono_refine_start(self, ws, u):
        """Refinement's start: the outer solve's outcome kept, the float64
        casts and RHS, and the float64 iterate from the outer solution."""
        ops, mask = self._ops, self.bc.mask
        ws.outer = ws.gloop.outcome()
        ws.f64 = ws.f_cell.double()
        m64, s64 = mask.double(), ws.sigma.double()
        b64 = rhs_f64(ops, self._ell64, ws.f64, m64, s64, u, ws.g,
                      self.config.deltat, self.rhs_neumann, ws.f_extra)
        ws.refinement = Refinement(ops, self._ell64, ws.f64, m64, s64, b64,
                                   ws.gloop.solution())

    def _mono_correction(self, ws):
        """A refinement pass's correction solve set up on FGMRES's buffers
        (its right-hand side the float64 residual, rounded; x0 = 0)."""
        cfg = self.config
        ws.gloop.start(ws.refinement.residual(), tol=cfg.refine_tol,
                       maxiter=cfg.refine_maxiter)

    def _mono_finish(self, ws):
        """Segment (g): the solution (refined or not) with exact boundary
        values, the forces and the metrics row.  Returns (u_new, p_new,
        row)."""
        if self._refines():
            iterations, _, converged = ws.outer
            (u_new, p_new), residual = ws.refinement.result()
        else:
            iterations, residual, converged = ws.gloop.outcome()
            u_new, p_new = ws.gloop.solution()
        u_new = u_new * self.bc.mask + ws.g       # exact boundary values
        row = self._metrics_row(ws.t_new, iterations, residual, converged,
                                self._forces(u_new, p_new, ws.factor))
        return u_new, p_new, row

    # ------------------------------------------------------------------
    # reference-parity public API
    # ------------------------------------------------------------------

    def _capture_refusal(self):
        """Why this model steps eagerly, or None when its step runs from
        captured CUDA graphs: one device, the bsr operator, on the card,
        either scheme, every preconditioner, with or without
        ``inner_bf16`` and ``refine``."""
        if self._cell_sharded:
            return "cell shards step eagerly: their step is not captured"
        if self._operator != "bsr":
            return (f"the {self._operator} operator steps eagerly: its step "
                    "is not captured")
        if self._sharded:
            return "row shards step eagerly: their step is not captured"
        if (self.config.scheme == "monolithic"
                and self.config.f_solver == "gmres"):
            return ("f_solver='gmres' steps eagerly: the inner GMRES solves "
                    "its triangular system on the host at every cycle")
        if self.device.type != "cuda":
            return "CUDA graphs capture the step on the card only"
        return None

    def _captures(self) -> bool:
        """Whether the step runs from captured CUDA graphs
        (``_capture_refusal``)."""
        return self._capture_refusal() is None

    def capture_graphs(self):
        """The step's CUDA graphs (models/step_graphs.py), captured now if
        they are not yet (otherwise at the first captured step).  Raises
        ValueError, with the reason, on a model that steps eagerly."""
        self._sync_config()
        reason = self._capture_refusal()
        if reason is not None:
            raise ValueError(reason)
        if self._graphs is None:
            from navierstokes_tpu_torch.models import step_graphs
            if not hasattr(self, "_u"):
                self._init_state(0)
            cls = (step_graphs.MonolithicGraphs
                   if self.config.scheme == "monolithic"
                   else step_graphs.ProjectionGraphs)
            self._graphs = cls(self)
        return self._graphs

    def _sync_config(self):
        """Hold the config to what setup built: a changed scheme gets what
        it needs built (``_build_scheme_statics``; A0 is kept, as the JAX
        model keeps it) and the captured graphs dropped; a changed field of
        ``_SETUP_FIELDS`` raises ValueError."""
        cfg = self.config
        check_config(cfg)
        for name, value in self._setup_values.items():
            if getattr(cfg, name) != value:
                raise ValueError(
                    f"SolverConfig.{name} changed from {value!r} to "
                    f"{getattr(cfg, name)!r} after setup(): call setup() "
                    "again")
        if cfg.scheme == self._scheme:
            return
        if self._operator != "bsr" and cfg.scheme == "projection":
            raise ValueError("scheme='projection' requires operator='bsr'")
        if self._operator == "bsr":
            self._build_scheme_statics()
        self._scheme = cfg.scheme
        self._graphs = None

    def _run_steps(self, n: int, eager: bool = False):
        """Advance ``n`` steps with no metric read: from the captured
        graphs (``_captures``, unless ``eager``) or the plain step.
        Returns (rows (n, len(_ROW)) float64 on the device, [_StepInfo])."""
        self._sync_config()
        if self._captures() and not eager:
            return self.capture_graphs().run(n)
        step = (self._step_monolithic if self.config.scheme == "monolithic"
                else self._step_projection)
        rows, infos = [], []
        for _ in range(n):
            u_new, p_new, t_new, phi, row, info = step(
                self._u, self._p, self._t, self._u_prev, self._phi)
            self._u_prev, self._u, self._p, self._phi = (self._u, u_new,
                                                         p_new, phi)
            self._t = t_new
            rows.append(row)
            infos.append(info)
        return torch.stack(rows), infos

    def _read_rows(self, rows, infos) -> list:
        """The StepMetrics of a run of steps: its rows in one transfer,
        the rebuild spans (read after it), the captured steps' while-loop
        counts (appended to their rows, ``_StepInfo.settle``), and the
        model's time and forces set from the last step."""
        out = []
        for v, info in zip(rows.cpu().tolist(), infos):
            if info.settle is not None:
                info.settle(info, v[len(_ROW):])
            m = dict(zip(_ROW, v))
            f_its, p_its = int(m["f_iterations"]), int(m["p_iterations"])
            out.append(StepMetrics(
                time=m["time"], iterations=int(m["iterations"]),
                residual=m["residual"], converged=bool(m["converged"]),
                drag=m["drag"], lift=m["lift"], cd=m["cd"], cl=m["cl"],
                prec_seconds=(info.span.seconds() if info.span is not None
                              else 0.0),
                f_iterations=f_its, p_iterations=p_its,
                flag_reads=info.flag_reads,
                masked_iterations=(info.slots - f_its - p_its
                                   if info.slots else info.masked),
                skipped_bodies=info.skipped, loops_entered=info.loops,
                bodies_run=info.bodies, exact_inverse=info.exact_inverse))
        last = out[-1]
        self.time = last.time
        self.drag, self.lift, self.cd, self.cl = (last.drag, last.lift,
                                                  last.cd, last.cl)
        return out

    def assemble(self, time: float):
        """The operator F = A0 + C(u) at the current state, as its compact
        F values (bsr) or its per-cell matrices (nc, n_v, n_v) (cells)
        (the reference's assemble, cpp:133-330).  Callable any
        time after setup() (state lazily zero-initialised); ``time`` is
        recorded, so a following solve_time_step() takes the inlet factor
        at ``time + dt`` as the reference's loop does."""
        if not hasattr(self, "_u"):
            self._init_state(0)
        self.time = float(time)
        self._t = torch.tensor(self.time, dtype=self.dtype,
                               device=self.device)
        f_vals = self.a0_cell + self._ops.convection(self._op, self._u)
        if self._sharded:
            return self.ell.unshard(f_vals)
        return self.cells.unshard(f_vals) if self._cell_sharded else f_vals

    def solve_time_step(self, *, _eager: bool = False) -> StepMetrics:
        """Advance exactly one step (cpp:344-397); usable straight after
        setup() (state lazily zero-initialized).  On the card the
        one-device bsr step replays its captured CUDA graphs
        (models/step_graphs.py), as the JAX model's ``solve_time_step``
        runs its compiled one-step chunk; ``_eager`` takes the plain step
        instead (the comparisons of chip_smoke.py and the tests)."""
        if not hasattr(self, "_u"):
            self._init_state(0)
        return self._read_rows(*self._run_steps(1, _eager))[0]

    def _init_state(self, time_step: int = 0):
        sp = self.space
        kw = dict(dtype=self.dtype, device=self.device)
        if time_step == 0:
            self.time = 0.0
            self._u = torch.zeros((sp.n_p2, self.dim), **kw)
            self._p = torch.zeros(sp.n_p1, **kw)
            self._u_prev = torch.zeros((sp.n_p2, self.dim), **kw)
            self._phi = torch.zeros(sp.n_p1, **kw)
        else:
            u, p, t = import_state(self.config.cache_dir, time_step)
            self.time = t
            # u_prev + phi restore the extrapolation/warm-start history,
            # so a restart reproduces the continuous run
            with np.load(checkpoint_path(self.config.cache_dir,
                                         time_step)) as z:
                up = z["u_prev"] if "u_prev" in z.files else np.array(u)
                phi = (z["phi"] if "phi" in z.files
                       else np.zeros_like(np.asarray(p)))
            self._u = torch.as_tensor(np.array(u), **kw)
            self._p = torch.as_tensor(np.array(p), **kw)
            self._u_prev = torch.as_tensor(np.array(up), **kw)
            self._phi = torch.as_tensor(np.array(phi), **kw)
            print(f"Continuing execution from time step {time_step}")
        self._t = torch.tensor(self.time, **kw)

    def load_state(self, state):
        """Adopt ``state`` (a convert.State, e.g. from
        ``convert.state_from_jax_numpy``) as the current state."""
        kw = dict(dtype=self.dtype, device=self.device)
        self._u, self._p = state.u.to(**kw), state.p.to(**kw)
        self._u_prev, self._phi = state.u_prev.to(**kw), state.phi.to(**kw)
        self.time = float(state.time)
        self._t = torch.tensor(self.time, **kw)

    def solve(self, time_step: int = 0, csv_path: str | None = None,
              on_step=None, *, _eager: bool = False):
        """Time loop (cpp:439-499): ICs or restart, then chunks of steps
        that end at the output boundaries (every ``output_step``) or at the
        end, as the JAX model's ``lax.scan`` chunks: no metric is read
        inside a chunk.  After each chunk: its rows read at once, a csv
        row and a printed line per step (time_prec_init the step's tile
        rebuild, time_sol the chunk's wall time per step minus it), the
        measured CFL once, and VTU + checkpoint at a boundary.
        ``on_step(ts, metrics, wall_seconds)``, if given, is called for each
        step of a chunk with the chunk's wall time per step (the
        validation driver's record).  ``_eager`` as in
        ``solve_time_step``."""
        if not self._is_setup:
            raise RuntimeError("call setup() first")
        cfg = self.config
        self._init_state(time_step)
        self.export_data(time_step)
        dt = cfg.deltat
        n_total = int(np.floor(cfg.t_final / dt + 0.5)) - time_step
        out_every = cfg.output_step
        ts, end = time_step, time_step + n_total
        with ForcesCsv(csv_path or cfg.csv_path) as csv:
            while ts < end:
                k = end - ts
                if out_every:
                    k = min(k, out_every - ts % out_every)
                t0 = _walltime.perf_counter()
                ms = self._read_rows(*self._run_steps(k, _eager))
                per_step = (_walltime.perf_counter() - t0) / k
                cfl = self.measured_cfl()
                for i, m in enumerate(ms):
                    # reference csv schema (cpp:383-390)
                    csv.row(m.time, dt, m.iterations, m.prec_seconds,
                            max(per_step - m.prec_seconds, 0.0), m.drag,
                            m.lift, m.cd, m.cl)
                    its = (f"{m.iterations} FGMRES its"
                           if cfg.scheme == "monolithic" else
                           f"{m.f_iterations}+{m.p_iterations} "
                           "BiCGStab+CG its")
                    cfl_part = f"CFL {cfl:.2f}, " if i == k - 1 else ""
                    print(f"n = {ts + i + 1:4d}, t = {m.time:.4f}: {its} "
                          f"(res {m.residual:.1e}), Cd = {m.cd:.5f}, "
                          f"Cl = {m.cl:.5f} ({cfl_part}"
                          f"{per_step * 1e3:.1f} ms/step)")
                    if on_step is not None:
                        on_step(ts + i + 1, m, per_step)
                ts += k
                if out_every and ts % out_every == 0:
                    self.output(ts)
                    self.export_data(ts)
        return self

    # ---- I/O parity ---------------------------------------------------

    def output(self, time_step: int):
        """VTU/PVTU dump (cpp:400-436)."""
        sp = self.space
        p_p2 = sp.pressure_at_p2_nodes(self._p.cpu().numpy())
        write_vtu_pvtu(self.config.output_dir, "output-stokes", time_step,
                       sp.p2_coords, np.asarray(sp.cell_p2),
                       self._u.cpu().numpy(), p_p2,
                       cell_partitioning(self.mesh.n_cells,
                                         self.config.n_devices))

    def export_data(self, time_step: int):
        export_state(self.config.cache_dir, time_step, self._u.cpu().numpy(),
                     self._p.cpu().numpy(), self.time,
                     extra=dict(u_prev=self._u_prev.cpu().numpy(),
                                phi=self._phi.cpu().numpy()))

    def import_data(self, time_step: int):
        self._init_state(time_step)

    def compute_forces(self, time: float | None = None):
        """Drag, lift, Cd and Cl of the current state (cpp:831-929); a
        pulsating inlet normalises by its instantaneous mean at ``time``
        (default: the state's time), as the step does.  Returns (Cd, Cl)."""
        t = torch.tensor(self.time if time is None else time,
                         dtype=self.dtype, device=self.device)
        forces = self._forces(self._u, self._p, self._time_factor(t))
        self.drag, self.lift, self.cd, self.cl = map(float, forces)
        return self.cd, self.cl

    def post_process(self, initial_time_step: int, final_time_step: int,
                     step: int):
        """Replay checkpoints without solving: import, forces, VTU for
        every ``step``-th time step from ``initial_time_step`` to
        ``final_time_step`` (cpp:808-828, src/postprocess.cpp).  Returns
        [(time_step, time, Cd, Cl), ...]."""
        results = []
        for ts in range(initial_time_step, final_time_step + 1, step):
            self._init_state(ts)
            cd, cl = self.compute_forces(self.time)
            self.output(ts)
            results.append((ts, self.time, cd, cl))
            print(f"post-process ts={ts}: Cd={cd:.5f} Cl={cl:.5f}")
        return results
