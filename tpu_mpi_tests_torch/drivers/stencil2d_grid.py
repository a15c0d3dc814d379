"""2-D process-grid stencil driver on a px×py grid (≅
``tpu_mpi_tests/drivers/stencil2d_grid.py``).

The domain is decomposed over ``--mesh PX,PY`` (one rank a block,
row-major) and ghosted along BOTH axes; per iteration: a halo exchange
on each axis (the column ring, then the row ring), both-axis 5-point
derivatives and the residual summed over the whole grid
(``comm/halo.step2d_fn``). Reported lines::

    GRID TEST px:<px> py:<py>; <seconds>, err_dx=<e>, err_dy=<e>
    ITER  ... (per-iteration mean/min/max past warmup)

Verification is the reference's: z = x³ + y² with analytic dz/dx = 3x²,
dz/dy = 2y; physical ghosts are filled analytically on grid-edge blocks,
interior ghosts start zero (at world=1 every band is physical, so the
exchanges move nothing), the error norms are taken on the fields rank 0
assembles, and the residual must be finite.

``--kernel hand`` runs the per-shard pipeline through the hand CUDA
kernel (≅ ``--kernel pallas``: both derivatives and the residual from
one read; it takes any width, so there is no fallback to the torch
tier; over ranks its strided axis-1 bands go through the pack and
unpack kernels); ``--kernel torch`` runs torch ops. The card is the
default device (NCCL between ranks); ``--device cpu`` runs the kernels'
plain torch versions (gloo). Start one process per rank (torchrun,
tpumt_run). ``--profile-dir DIR`` writes a ``torch.profiler`` trace of
the timed steps a rank (``gpu/trace_summary.py`` sums its device time).
``--overlap 2`` with ``--kernel torch`` runs the host-scheduled pipeline
(``comm/halo.py``'s overlap engine: per iteration the both-axis exchange
in flight on a comm stream while the core derivatives compute, the seam
completing the frame and the residual) and prints an ``OVERLAP
stencil2d_grid`` line; with ``--kernel hand`` a NOTE says the fused
serial step runs.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tpu_mpi_tests_torch.arrays.domain import Domain1D
from tpu_mpi_tests_torch.comm import collectives as C
from tpu_mpi_tests_torch.comm import halo as H
from tpu_mpi_tests_torch.comm.mesh import bootstrap, make_grid, topology
from tpu_mpi_tests_torch.convert import grid_join
from tpu_mpi_tests_torch.drivers import _common
from tpu_mpi_tests_torch.instrument.timers import PhaseTimer, block
from tpu_mpi_tests_torch.instrument.trace import ProfilerGate
from tpu_mpi_tests_torch.kernels.stencil import N_BND, analytic_pairs


def _init_block(dx, dy, rx: int, ry: int, px: int, py: int, fn, dtype):
    """Ghosted (rx, ry) block: interior analytic, physical ghost bands on
    mesh-edge shards, interior ghosts zero (a copy of the JAX driver's,
    on numpy)."""
    x = dx.ghosted_coords(rx, np.float64)
    y = dy.ghosted_coords(ry, np.float64)
    full = fn(x[:, None], y[None, :]).astype(dtype)
    out = np.zeros((dx.n_ghosted, dy.n_ghosted), dtype=dtype)
    nb = dx.n_bnd
    ix = slice(nb, nb + dx.n_local)
    iy = slice(nb, nb + dy.n_local)
    out[ix, iy] = full[ix, iy]
    if rx == 0:
        out[:nb, :] = full[:nb, :]
    if rx == px - 1:
        out[-nb:, :] = full[-nb:, :]
    if ry == 0:
        out[:, :nb] = full[:, :nb]
    if ry == py - 1:
        out[:, -nb:] = full[:, -nb:]
    return out


def _rms_error(blocks, px, py, want_fn) -> float:
    """The rms error of the assembled field (rank 0: ``blocks``) against
    ``want_fn()``, as the JAX driver takes it; 0.0 on the other ranks."""
    if blocks is None:
        return 0.0
    got = grid_join(blocks, px, py).astype(np.float64)
    del blocks
    return float(np.sqrt(np.mean((got - want_fn()) ** 2)))


def run(args) -> int:
    device = bootstrap(args.device)
    topo = topology(device)
    n_dev = topo.global_device_count
    grid_spec = _common.parse_grid_mesh(args.mesh, n_dev)
    if grid_spec is None:
        return 2
    px, py = grid_spec
    grid = make_grid(px, py)

    with _common.make_reporter(args, rank=topo.process_index,
                               size=n_dev) as rep:
        rep.banner(
            f"stencil2d_grid: mesh={px}x{py} nx_local={args.nx_local} "
            f"ny_local={args.ny_local} n_iter={args.n_iter} dtype={args.dtype}"
        )
        dx = Domain1D(n_global=px * args.nx_local, n_shards=px)
        dy = Domain1D(n_global=py * args.ny_local, n_shards=py)
        zf, _ = analytic_pairs()["2d_dim0"]
        # this rank's f64 host block, cast on the device (correctly
        # rounded, as numpy's astype rounds)
        zs = torch.from_numpy(
            _init_block(dx, dy, grid.rx, grid.ry, px, py, zf, np.float64)
        ).to(device=device, dtype=_common.torch_dtype(args))
        step = H.step2d_fn(N_BND, float(dx.scale), float(dy.scale),
                           kernel=args.kernel, grid=grid)
        gate = ProfilerGate(args.profile_dir)

        depth = 1
        if args.overlap != "0":
            explicit = None if args.overlap == "auto" else int(args.overlap)
            depth = H.resolve_overlap_depth(explicit)
            rep.banner(f"OVERLAP stencil2d_grid depth resolved -> {depth}")

        timer = PhaseTimer(skip_first=args.n_warmup)
        out = None
        runner = None
        if depth >= 2 and args.kernel == "torch":
            # the host-scheduled pipeline: per iteration the both-axis
            # exchange in flight while the core derivatives (cells
            # touching no ghost) compute; the seam completes the frame
            # rows and columns and the residual. The err gates below
            # verify the assembled fields.
            ex_fn, core_fn, seam_fn = H.grid_overlap_fns(
                N_BND, float(dx.scale), float(dy.scale), grid)
            nbytes = (H.halo_payload_bytes(zs, 0, px, N_BND, False)
                      + H.halo_payload_bytes(zs, 1, py, N_BND, False))
            runner = H.OverlapRunner(
                "halo_exchange2d", depth=depth, nbytes=nbytes, world=n_dev,
                timer=timer, phase="overlap_interior")
            # the warmups run through a throwaway runner (the step phase
            # still brackets them; skip_first keeps its accounting), so
            # the overlap record covers only the measured iterations
            warm = H.OverlapRunner("halo_exchange2d", depth=depth,
                                   nbytes=nbytes, world=n_dev)
            for i in range(args.n_warmup + args.n_iter):
                if i == args.n_warmup:
                    gate.start()
                r = warm if i < args.n_warmup else runner
                with timer.phase("step"):
                    ex, cores = r.step(ex_fn, core_fn, zs)
                    out = block(seam_fn(ex, *cores))
            runner.annotate(timer)
        else:
            if depth >= 2:
                rep.line("NOTE --overlap needs --kernel torch; running "
                         "the fused serial step")
                depth = 1
            for i in range(args.n_warmup + args.n_iter):
                if i == args.n_warmup:  # the timed steps' trace
                    gate.start()
                out = timer.timed("step", step, zs)
        gate.stop()
        dz_dx, dz_dy, residual = out
        seconds = timer.seconds["step"]
        if args.overlap != "0":
            it_per_s = (args.n_iter / seconds if seconds > 0
                        else float("inf"))
            ov_rec = (
                runner.record("stencil2d_grid", dtype=args.dtype,
                              it_per_s=it_per_s)
                if runner is not None else
                {"kind": "overlap", "op": "stencil2d_grid",
                 "depth": depth, "steps": args.n_iter,
                 "overlap_frac": 0.0, "comm_s": 0.0,
                 "compute_s": seconds, "world": n_dev,
                 "dtype": args.dtype, "it_per_s": it_per_s}
            )
            rep.line(
                f"OVERLAP stencil2d_grid depth={depth} "
                f"{it_per_s:0.1f} it/s "
                f"overlap_frac={ov_rec['overlap_frac']:0.3f}",
                ov_rec,
            )

        # err gates vs analytic derivatives over the global interior, on
        # the fields rank 0 assembles
        xs = np.arange(dx.n_global) * dx.delta
        ys = np.arange(dy.n_global) * dy.delta
        err_dx = _rms_error(C.gather_blocks(dz_dx), px, py,
                            lambda: 3.0 * xs[:, None] ** 2 + 0.0 * ys[None, :])
        err_dy = _rms_error(C.gather_blocks(dz_dy), px, py,
                            lambda: 0.0 * xs[:, None] + 2.0 * ys[None, :])
        err_dx, err_dy = (float(e) for e in C.replicate(
            np.array([err_dx, err_dy]), "cpu"))
        res = float(residual)
        rep.line(
            f"GRID TEST px:{px} py:{py}; {seconds:f}, "
            f"err_dx={err_dx:e}, err_dy={err_dy:e}",
            {"kind": "grid_test", "px": px, "py": py, "seconds": seconds,
             "err_dx": err_dx, "err_dy": err_dy,
             "residual": res, "kernel": args.kernel},
        )
        rep.iter_line(0, "device", 0, "step", timer.mean("step"),
                      timer.mins.get("step", 0.0), timer.maxs.get("step", 0.0))

        if not np.isfinite(res):
            rep.line(f"RESIDUAL FAIL: {res}")
            return 1
        tol = args.tol if args.tol is not None else _default_tol(args, dx, dy)
        if max(err_dx, err_dy) > tol:
            rep.line(
                f"ERR_NORM FAIL grid: dx={err_dx:.8g} dy={err_dy:.8g} > "
                f"tol {tol:.8g}"
            )
            return 1
        return 0


def _default_tol(args, dx, dy) -> float:
    """The JAX driver's dtype-dependent gate, unchanged."""
    if args.dtype == "float64":
        return 1e-5
    eps = 7.8e-3 if args.dtype == "bfloat16" else 1.2e-7
    zmax = dx.length**3 + dy.length**2
    return 8 * eps * zmax * max(dx.scale, dy.scale)


def main(argv=None) -> int:
    p = _common.base_parser(__doc__)
    p.add_argument("--mesh", default=None,
                   help="process grid as 'PX,PY', one rank a block "
                   "(default: auto-factor the world size)")
    p.add_argument("--nx-local", type=int, default=64,
                   help="per-shard interior rows")
    p.add_argument("--ny-local", type=int, default=64,
                   help="per-shard interior cols")
    p.add_argument("--n-iter", type=int, default=100)
    p.add_argument("--n-warmup", type=int, default=5)
    p.add_argument("--tol", type=float, default=None)
    p.add_argument(
        "--kernel", choices=("torch", "hand"), default="torch",
        help="per-shard pipeline tier: torch ops (≅ the XLA tier) or the "
        "hand CUDA kernel (≅ --kernel pallas; one window read for both "
        "derivatives + residual)",
    )
    p.add_argument(
        "--overlap",
        default="0",
        choices=["0", "1", "2", "auto"],
        help="halo pipeline depth: 0 = off (default), 1 = the serialized "
        "schedule, 2 = host-scheduled pipeline with the both-axis exchange "
        "in flight on a comm stream under the core derivatives (--kernel "
        "torch; with hand a NOTE, and the fused serial step runs), auto = "
        "the prior depth (the schedule cache is not ported)",
    )
    args = p.parse_args(argv)
    for name in ("nx_local", "ny_local", "n_iter"):
        if getattr(args, name) < 1:
            p.error(f"--{name.replace('_', '-')} must be positive")
    if min(args.nx_local, args.ny_local) < 5:
        p.error("--nx-local/--ny-local must be >= 5 (stencil width)")
    return run(args)


if __name__ == "__main__":
    sys.exit(main())
