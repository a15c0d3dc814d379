"""2-D process-grid stencil driver on the 1×1 grid (≅
``tpu_mpi_tests/drivers/stencil2d_grid.py``).

The domain is ghosted along BOTH axes; per iteration: a halo exchange on
each axis, both-axis 5-point derivatives and the global residual
(``comm/halo.step2d_fn``). Reported lines::

    GRID TEST px:<px> py:<py>; <seconds>, err_dx=<e>, err_dy=<e>
    ITER  ... (per-iteration mean/min/max past warmup)

Verification is the reference's: z = x³ + y² with analytic dz/dx = 3x²,
dz/dy = 2y; physical ghosts are filled analytically on grid-edge shards
(at world=1 every band is physical, so the exchanges move nothing), and
the residual must be finite.

``--kernel hand`` runs the per-shard pipeline through the hand CUDA
kernel (≅ ``--kernel pallas``: both derivatives and the residual from
one read; it takes any width, so there is no fallback to the torch
tier); ``--kernel torch`` runs torch ops. The card is the default
device; ``--device cpu`` runs the kernel's plain torch version. Only the
1×1 grid runs (multi-rank is ROADMAP queue 1 item 2); ``--overlap`` is
not ported yet (queue 1 item 13).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tpu_mpi_tests_torch.arrays.domain import Domain1D
from tpu_mpi_tests_torch.comm import collectives as C
from tpu_mpi_tests_torch.comm import halo as H
from tpu_mpi_tests_torch.comm.mesh import (
    bootstrap,
    check_grid,
    check_single_rank,
    topology,
)

PROG = "stencil2d_grid"
from tpu_mpi_tests_torch.drivers import _common
from tpu_mpi_tests_torch.instrument.timers import PhaseTimer
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


def run(args) -> int:
    device = bootstrap(args.device)
    topo = topology(device)
    n_dev = topo.global_device_count
    check_grid(args.mesh)
    check_single_rank(PROG)
    grid = _common.parse_grid_mesh(args.mesh, n_dev)
    if grid is None:
        return 2
    px, py = grid

    with _common.make_reporter(args, rank=0, size=n_dev) as rep:
        rep.banner(
            f"stencil2d_grid: mesh={px}x{py} nx_local={args.nx_local} "
            f"ny_local={args.ny_local} n_iter={args.n_iter} dtype={args.dtype}"
        )
        dx = Domain1D(n_global=px * args.nx_local, n_shards=px)
        dy = Domain1D(n_global=py * args.ny_local, n_shards=py)
        zf, _ = analytic_pairs()["2d_dim0"]
        # the f64 host block, cast on the device (correctly rounded, as
        # numpy's astype rounds)
        zs = torch.from_numpy(
            _init_block(dx, dy, 0, 0, px, py, zf, np.float64)
        ).to(device=device, dtype=_common.torch_dtype(args))
        step = H.step2d_fn(N_BND, float(dx.scale), float(dy.scale),
                           kernel=args.kernel)

        timer = PhaseTimer(skip_first=args.n_warmup)
        out = None
        for _ in range(args.n_warmup + args.n_iter):
            out = timer.timed("step", step, zs)
        dz_dx, dz_dy, residual = out
        seconds = timer.seconds["step"]

        # err gates vs analytic derivatives over the global interior
        xs = np.arange(dx.n_global) * dx.delta
        ys = np.arange(dy.n_global) * dy.delta
        got_dx = C.host_value(dz_dx).astype(np.float64)
        want = (3.0 * xs[:, None] ** 2) + 0.0 * ys[None, :]
        err_dx = float(np.sqrt(np.mean((got_dx - want) ** 2)))
        del got_dx, want
        got_dy = C.host_value(dz_dy).astype(np.float64)
        want = 0.0 * xs[:, None] + 2.0 * ys[None, :]
        err_dy = float(np.sqrt(np.mean((got_dy - want) ** 2)))
        del got_dy, want
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
                   help="process grid as 'PX,PY' (default: auto-factor; "
                   "only 1,1 runs)")
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
    args = p.parse_args(argv)
    for name in ("nx_local", "ny_local", "n_iter"):
        if getattr(args, name) < 1:
            p.error(f"--{name.replace('_', '-')} must be positive")
    if min(args.nx_local, args.ny_local) < 5:
        p.error("--nx-local/--ny-local must be >= 5 (stencil width)")
    return run(args)


if __name__ == "__main__":
    sys.exit(main())
