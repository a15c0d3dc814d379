"""Heat-equation mini-app on the 1×1 process grid (≅
``tpu_mpi_tests/drivers/heat2d.py``).

∂z/∂t = ν∇²z on a periodic [0,2π)² domain, explicit Euler, 5-point
Laplacian, chained on the device (``comm/halo.heat_step2d_fn``): per
outer body a periodic self-ring exchange on both axes, then
``--halo-steps`` updates over equally deep ghosts. Verification is
roundoff-exact: sin(kx·x)·sin(ky·y) is an eigenvector of the discrete
periodic update, so after T steps the field must equal g^T·z0 with
g = 1 − cx(2−2cos kxΔx) − cy(2−2cos kyΔy). Reported::

    HEAT mesh:<px>x<py> n:<nx>x<ny>; steps=<T> <steps/s> steps/s
    HEAT ERR rel=<e> (gate <tol>)

plus an ``ITER`` line timing the both-axis exchange alone (its axis-1
ghost bands are narrow strided column bands).

``--kernel hand`` runs the update through the hand CUDA kernel (≅
``--kernel pallas``; it takes any width, so there is no fallback to the
torch tier); ``--kernel torch`` runs the XLA body as torch ops. The card
is the default device; ``--device cpu`` runs the kernel's plain torch
version. Only the 1×1 grid runs (multi-rank is ROADMAP queue 1 item 2).
Not ported yet: ``--overlap`` (queue 1 item 13), ``--kernel auto`` and
the tune flags (queue 1 item 17).
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from tpu_mpi_tests_torch.comm import collectives as C
from tpu_mpi_tests_torch.comm import halo as H
from tpu_mpi_tests_torch.comm.mesh import bootstrap, check_grid, topology
from tpu_mpi_tests_torch.drivers import _common
from tpu_mpi_tests_torch.instrument.timers import PhaseTimer, block

EXCHANGE_TIMING_ITERS = 10  # untimed first + timed both-axis exchanges


def _init_field(args, nx, ny, dx, dy):
    """The ghosted field of the 1×1 grid on the host in float64
    (interior = sin(kx x)·sin(ky y), ghosts zero: the first exchange
    fills them) and the interior z0, as the JAX driver lays them out."""
    nb = args.halo_steps
    zg = np.zeros((nx + 2 * nb, ny + 2 * nb), dtype=np.float64)
    xs = np.arange(nx, dtype=np.float64) * dx
    ys = np.arange(ny, dtype=np.float64) * dy
    z0 = np.sin(args.kx * xs)[:, None] * np.sin(args.ky * ys)[None, :]
    zg[nb:nb + nx, nb:nb + ny] = z0
    return zg, z0


def coefficients(nx: int, ny: int, nu: float, dt=None):
    """``(dt, cx, cy)`` on the periodic [0,2π)² grid of nx × ny points:
    ``dt`` defaults to 80% of the explicit-Euler stability limit
    cx + cy <= 1/2; ``c = ν·dt/Δ²`` per axis."""
    dx, dy = 2.0 * math.pi / nx, 2.0 * math.pi / ny
    if dt is None:
        dt = 0.4 / (nu * (1.0 / dx**2 + 1.0 / dy**2))
    return dt, nu * dt / dx**2, nu * dt / dy**2


def _time_exchange(zs, nb, rep) -> None:
    """Time the both-axis periodic exchange alone. It is idempotent (its
    sources are interior bands it never writes), so the field is left as
    the run left it."""
    timer = PhaseTimer(skip_first=1)
    for _ in range(EXCHANGE_TIMING_ITERS):
        timer.timed("exchange", H.exchange2d, zs, nb, True)
    rep.iter_line(0, "device", 0, "exchange", timer.mean("exchange"),
                  timer.mins.get("exchange", 0.0),
                  timer.maxs.get("exchange", 0.0))


def run(args) -> int:
    device = bootstrap(args.device)
    topo = topology(device)
    n_dev = topo.global_device_count
    check_grid(args.mesh)
    grid = _common.parse_grid_mesh(args.mesh, n_dev)
    if grid is None:
        return 2
    px, py = grid

    nx, ny = px * args.nx_local, py * args.ny_local
    dx, dy = 2.0 * math.pi / nx, 2.0 * math.pi / ny
    dt, cx, cy = coefficients(nx, ny, args.nu, args.dt)

    with _common.make_reporter(args, rank=0, size=n_dev) as rep:
        rep.banner(
            f"heat2d: mesh={px}x{py} n={nx}x{ny} nu={args.nu} dt={dt:.3e} "
            f"steps={args.n_steps} dtype={args.dtype}"
        )
        nb = args.halo_steps
        zg_host, z0 = _init_field(args, nx, ny, dx, dy)
        zs = torch.from_numpy(zg_host).to(device=device,
                                          dtype=_common.torch_dtype(args))
        del zg_host
        step = H.heat_step2d_fn(nb, float(cx), float(cy),
                                steps=args.halo_steps, kernel=args.kernel)

        outer_total = args.n_steps // args.halo_steps
        # warm (builds the kernel): 1 outer body = halo_steps timesteps,
        # counted in the gate
        zs = block(step(zs, 1))
        t0 = time.perf_counter()
        zs = block(step(zs, outer_total - 1))
        seconds = time.perf_counter() - t0
        timed_steps = (outer_total - 1) * args.halo_steps
        steps_per_s = timed_steps / seconds if seconds > 0 else float("inf")
        rep.line(
            f"HEAT mesh:{px}x{py} n:{nx}x{ny}; steps={args.n_steps} "
            f"{steps_per_s:0.1f} steps/s",
            {"kind": "heat", "px": px, "py": py, "nx": nx, "ny": ny,
             "steps": args.n_steps, "steps_per_s": steps_per_s,
             "nu": args.nu, "dt": dt, "kernel": args.kernel,
             "overlap": 1},
        )
        _time_exchange(zs, nb, rep)

        # eigenvalue gate: field == g^T · z0 to roundoff
        g = (
            1.0
            - cx * (2.0 - 2.0 * math.cos(args.kx * dx))
            - cy * (2.0 - 2.0 * math.cos(args.ky * dy))
        )
        want = (g**args.n_steps) * z0
        del z0
        got = C.host_value(zs[nb:nb + nx, nb:nb + ny]).astype(np.float64)
        denom = float(np.sqrt(np.mean(want**2)))
        with np.errstate(over="ignore"):  # unstable dt overflows by design;
            # the gate reports it as inf > tol, not as a warning
            rel = (float(np.sqrt(np.mean((got - want) ** 2)))
                   / max(denom, 1e-300))
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
                   help="process grid as 'PX,PY' (default: auto-factor; "
                   "only 1,1 runs)")
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
    args = p.parse_args(argv)
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
