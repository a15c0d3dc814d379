"""Heat-equation mini-app on a px×py process grid (≅
``tpu_mpi_tests/drivers/heat2d.py``).

∂z/∂t = ν∇²z on a periodic [0,2π)² domain, explicit Euler, 5-point
Laplacian, chained on the device (``comm/halo.heat_step2d_fn``): per
outer body a periodic exchange on both axes of the grid
(``--mesh PX,PY``, one rank a block, row-major; the column ring along
axis 0, then the row ring along axis 1), then ``--halo-steps`` updates
over equally deep ghosts. Each rank builds its own block; the gate
gathers the interiors to rank 0 and checks the assembled field. Verification is
roundoff-exact: sin(kx·x)·sin(ky·y) is an eigenvector of the discrete
periodic update, so after T steps the field must equal g^T·z0 with
g = 1 − cx(2−2cos kxΔx) − cy(2−2cos kyΔy). Reported::

    HEAT mesh:<px>x<py> n:<nx>x<ny>; steps=<T> <steps/s> steps/s
    HEAT ERR rel=<e> (gate <tol>)

plus an ``ITER`` line timing the both-axis exchange alone (its axis-1
ghost bands are narrow strided column bands).

``--kernel hand`` runs the update through the hand CUDA kernel (≅
``--kernel pallas``; it takes any width, so there is no fallback to the
torch tier; over ranks its strided axis-1 bands go through the pack and
unpack kernels); ``--kernel torch`` runs the XLA body as torch ops. The
card is the default device (NCCL between ranks); ``--device cpu`` runs
the kernels' plain torch versions (gloo). Start one process per rank
(torchrun, tpumt_run). ``--profile-dir DIR`` writes a ``torch.profiler``
trace of the timed bodies a rank (``gpu/trace_summary.py`` sums its
device time). ``--overlap 2`` (with ``--kernel torch --halo-steps 1``)
runs the host-scheduled pipeline (``comm/halo.py``'s overlap engine:
per Euler step the both-axis exchange in flight on a comm stream while
the core computes, the seam patched after) and prints an ``OVERLAP
heat2d`` line; ``--overlap 1`` keeps the chained loop. Not ported yet:
``--kernel auto`` and the tune flags (queue 1 item 17).
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from tpu_mpi_tests_torch.comm import collectives as C
from tpu_mpi_tests_torch.comm import halo as H
from tpu_mpi_tests_torch.comm.mesh import bootstrap, make_grid, topology
from tpu_mpi_tests_torch.convert import grid_join
from tpu_mpi_tests_torch.drivers import _common
from tpu_mpi_tests_torch.instrument.timers import PhaseTimer, block
from tpu_mpi_tests_torch.instrument.trace import ProfilerGate

EXCHANGE_TIMING_ITERS = 10  # untimed first + timed both-axis exchanges


def _eigen_field(args, xs, ys):
    """sin(kx·x)·sin(ky·y) on the host in float64 at the points ``xs`` ×
    ``ys``, as the JAX driver builds z0."""
    return np.sin(args.kx * xs)[:, None] * np.sin(args.ky * ys)[None, :]


def _init_block(args, grid, dx, dy):
    """This rank's ghosted block on the host in float64 (interior = its
    window of sin(kx x)·sin(ky y), ghosts zero: the first exchange fills
    them), as the JAX driver lays each block out."""
    nb, nxl, nyl = args.halo_steps, args.nx_local, args.ny_local
    zg = np.zeros((nxl + 2 * nb, nyl + 2 * nb), dtype=np.float64)
    xs = np.arange(grid.rx * nxl, (grid.rx + 1) * nxl,
                   dtype=np.float64) * dx
    ys = np.arange(grid.ry * nyl, (grid.ry + 1) * nyl,
                   dtype=np.float64) * dy
    zg[nb:nb + nxl, nb:nb + nyl] = _eigen_field(args, xs, ys)
    return zg


def coefficients(nx: int, ny: int, nu: float, dt=None):
    """``(dt, cx, cy)`` on the periodic [0,2π)² grid of nx × ny points:
    ``dt`` defaults to 80% of the explicit-Euler stability limit
    cx + cy <= 1/2; ``c = ν·dt/Δ²`` per axis."""
    dx, dy = 2.0 * math.pi / nx, 2.0 * math.pi / ny
    if dt is None:
        dt = 0.4 / (nu * (1.0 / dx**2 + 1.0 / dy**2))
    return dt, nu * dt / dx**2, nu * dt / dy**2


def _time_exchange(zs, nb, grid, kernel, rep) -> None:
    """Time the both-axis periodic exchange alone. It is idempotent (its
    sources are interior bands it never writes), so the field is left as
    the run left it."""
    timer = PhaseTimer(skip_first=1)
    for _ in range(EXCHANGE_TIMING_ITERS):
        timer.timed("exchange", H.exchange2d, zs, nb, True, grid, kernel)
    rep.iter_line(0, "device", 0, "exchange", timer.mean("exchange"),
                  timer.mins.get("exchange", 0.0),
                  timer.maxs.get("exchange", 0.0))


def run(args) -> int:
    device = bootstrap(args.device)
    topo = topology(device)
    n_dev = topo.global_device_count
    grid_spec = _common.parse_grid_mesh(args.mesh, n_dev)
    if grid_spec is None:
        return 2
    px, py = grid_spec
    grid = make_grid(px, py)

    nx, ny = px * args.nx_local, py * args.ny_local
    dx, dy = 2.0 * math.pi / nx, 2.0 * math.pi / ny
    dt, cx, cy = coefficients(nx, ny, args.nu, args.dt)

    with _common.make_reporter(args, rank=topo.process_index,
                               size=n_dev) as rep:
        rep.banner(
            f"heat2d: mesh={px}x{py} n={nx}x{ny} nu={args.nu} dt={dt:.3e} "
            f"steps={args.n_steps} dtype={args.dtype}"
        )
        nb = args.halo_steps
        zs = torch.from_numpy(_init_block(args, grid, dx, dy)).to(
            device=device, dtype=_common.torch_dtype(args))
        step = H.heat_step2d_fn(nb, float(cx), float(cy),
                                steps=args.halo_steps, kernel=args.kernel,
                                grid=grid)

        depth = 1
        if args.overlap != "0":
            explicit = None if args.overlap == "auto" else int(args.overlap)
            depth = H.resolve_overlap_depth(explicit)
            rep.banner(f"OVERLAP heat2d depth resolved -> {depth}")

        outer_total = args.n_steps // args.halo_steps
        runner = None
        if depth >= 2:
            # the host-scheduled pipeline: per Euler step the both-axis
            # exchange in flight while the core (cells touching no fresh
            # ghost) computes; the seam patches the 1-wide frame from the
            # arrivals. The eigen gate below verifies it end to end.
            fns = H.heat_overlap_fns(float(cx), float(cy), grid)
            nbytes = (H.halo_payload_bytes(zs, 0, px, nb, True)
                      + H.halo_payload_bytes(zs, 1, py, nb, True))
            timer = PhaseTimer()
            # warm through a throwaway runner, so the record's seconds
            # cover only the timed steps
            zs = block(H.overlap_steps(
                H.OverlapRunner("halo_exchange2d", depth=depth,
                                nbytes=nbytes, world=n_dev), fns, zs, 1))
            runner = H.OverlapRunner(
                "halo_exchange2d", depth=depth, nbytes=nbytes, world=n_dev,
                timer=timer, phase="overlap_interior")
            with ProfilerGate(args.profile_dir):
                t0 = time.perf_counter()
                zs = block(H.overlap_steps(runner, fns, zs, outer_total - 1))
                seconds = time.perf_counter() - t0
            runner.annotate(timer)
            rep.time_lines(timer, stats=True)
        else:
            # warm (builds the kernel): 1 outer body = halo_steps
            # timesteps, counted in the gate
            zs = block(step(zs, 1))
            with ProfilerGate(args.profile_dir):  # the timed bodies' trace
                t0 = time.perf_counter()
                zs = block(step(zs, outer_total - 1))
                seconds = time.perf_counter() - t0
        timed_steps = (outer_total - 1) * args.halo_steps
        steps_per_s = timed_steps / seconds if seconds > 0 else float("inf")
        if args.overlap != "0":
            ov_rec = (
                runner.record("heat2d", dtype=args.dtype,
                              steps_per_s=steps_per_s)
                if runner is not None else
                {"kind": "overlap", "op": "heat2d", "depth": depth,
                 "steps": outer_total - 1, "overlap_frac": 0.0,
                 "comm_s": 0.0, "compute_s": seconds, "world": n_dev,
                 "dtype": args.dtype, "steps_per_s": steps_per_s}
            )
            rep.line(
                f"OVERLAP heat2d depth={depth} "
                f"overlap_frac={ov_rec['overlap_frac']:0.3f}",
                ov_rec,
            )
        rep.line(
            f"HEAT mesh:{px}x{py} n:{nx}x{ny}; steps={args.n_steps} "
            f"{steps_per_s:0.1f} steps/s",
            {"kind": "heat", "px": px, "py": py, "nx": nx, "ny": ny,
             "steps": args.n_steps, "steps_per_s": steps_per_s,
             "nu": args.nu, "dt": dt, "kernel": args.kernel,
             "overlap": depth},
        )
        _time_exchange(zs, nb, grid, args.kernel, rep)

        # eigenvalue gate on the assembled field: field == g^T · z0 to
        # roundoff (rank 0 gathers the interiors, the others get rel)
        g = (
            1.0
            - cx * (2.0 - 2.0 * math.cos(args.kx * dx))
            - cy * (2.0 - 2.0 * math.cos(args.ky * dy))
        )
        blocks = C.gather_blocks(zs[nb:nb + args.nx_local,
                                    nb:nb + args.ny_local])
        rel = 0.0
        if blocks is not None:
            got = grid_join(blocks, px, py).astype(np.float64)
            del blocks
            want = (g**args.n_steps) * _eigen_field(
                args, np.arange(nx, dtype=np.float64) * dx,
                np.arange(ny, dtype=np.float64) * dy)
            denom = float(np.sqrt(np.mean(want**2)))
            with np.errstate(over="ignore"):  # unstable dt overflows by
                # design; the gate reports it as inf > tol, not a warning
                rel = (float(np.sqrt(np.mean((got - want) ** 2)))
                       / max(denom, 1e-300))
            del got, want
        rel = float(C.replicate(np.array([rel]), "cpu")[0])
        tol = args.tol if args.tol is not None else _default_tol(args)
        rep.line(
            f"HEAT ERR rel={rel:e} (gate {tol:e})",
            {"kind": "heat_err", "rel": rel, "tol": tol, "g": g},
        )
        if not np.isfinite(rel) or rel > tol:
            rep.line(f"HEAT FAIL rel={rel:.8g} > tol {tol:.8g}")
            return 1
        return 0


def _default_tol(args) -> float:
    """The JAX driver's gate, unchanged: per-step relative roundoff
    growth ~eps, capped at 0.5 so the gate never goes vacuous."""
    eps = {"float64": 2.3e-16, "float32": 1.2e-7, "bfloat16": 7.8e-3}[
        args.dtype
    ]
    return min(0.5, 50.0 * eps * max(args.n_steps, 1) ** 0.5 + 10.0 * eps)


def main(argv=None) -> int:
    p = _common.base_parser(__doc__)
    p.add_argument("--mesh", default=None,
                   help="process grid as 'PX,PY', one rank a block "
                   "(default: auto-factor the world size)")
    p.add_argument("--nx-local", type=int, default=64)
    p.add_argument("--ny-local", type=int, default=64)
    p.add_argument("--n-steps", type=int, default=200)
    p.add_argument("--nu", type=float, default=0.1,
                   help="diffusivity")
    p.add_argument("--dt", type=float, default=None,
                   help="time step (default: 80%% of the explicit limit)")
    p.add_argument("--kx", type=int, default=1)
    p.add_argument("--ky", type=int, default=1)
    p.add_argument("--tol", type=float, default=None)
    p.add_argument(
        "--halo-steps", type=int, default=1,
        help="temporal blocking: fuse this many Euler steps per dual-axis "
        "exchange over equally-deep ghosts (1/k the exchanges; "
        "interior-identical, gated by the same eigen check)",
    )
    p.add_argument(
        "--kernel", choices=("torch", "hand"), default="torch",
        help="update-body tier: the XLA slice formulation as torch ops, "
        "or the hand CUDA kernel (≅ --kernel pallas; same recurrence "
        "update for update, one launch per k steps)",
    )
    p.add_argument(
        "--overlap",
        default="0",
        choices=["0", "1", "2", "auto"],
        help="halo pipeline depth: 0 = off (default, the chained loop), "
        "1 = resolve the knob but keep the chained loop (the serialized "
        "schedule), 2 = host-scheduled pipeline with the both-axis "
        "exchange in flight on a comm stream under the core compute, "
        "auto = the prior depth (the schedule cache is not ported); "
        "requires --kernel torch and --halo-steps 1",
    )
    args = p.parse_args(argv)
    if args.overlap != "0" and (
        args.kernel != "torch" or args.halo_steps != 1
    ):
        p.error("--overlap requires --kernel torch and --halo-steps 1 "
                "(the interior/boundary split is the per-step torch body)")
    for name in ("nx_local", "ny_local", "n_steps", "kx", "ky",
                 "halo_steps"):
        if getattr(args, name) < 1:
            p.error(f"--{name.replace('_', '-')} must be positive")
    if args.n_steps % args.halo_steps:
        p.error("--n-steps must be a multiple of --halo-steps")
    if min(args.nx_local, args.ny_local) < 2 * args.halo_steps + 1:
        p.error("--nx-local/--ny-local must exceed 2x the fused halo depth")
    return run(args)


if __name__ == "__main__":
    sys.exit(main())
