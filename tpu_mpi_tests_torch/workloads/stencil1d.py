"""1-D 5-point stencil with halo exchange at world=1 — as a workload spec
(≅ ``tpu_mpi_tests/workloads/stencil1d.py``, itself ≅
``mpi_stencil_gt.cc``).

y = x³ over n_global points (default 32Mi, ``--n-global-mi`` in Mi units
like the reference argv) on the one rank, ghost width 2; one timed halo
exchange; the stencil derivative; the per-rank ``err_norm`` against the
analytic 3x², exact to rounding for a cubic. Output lines preserved::

    <rank>/<size> exchange time <s>
    <rank>/<size> [<device>] err_norm = <v>

At world=1 the non-periodic exchange moves nothing (the one shard keeps
its physical ghosts), as in the JAX package's single-device runs; the
three ported stagings (``direct``, ``device``, ``host``) all take that
path. No hand kernel lies under this driver, in the JAX package or here:
the derivative is the torch-op stencil (the XLA tier's counterpart).

Not ported yet, each raising with the ROADMAP item that brings it:
``--staging pallas`` (the hand RDMA ring, queue 2 item 2), ``--staging
auto`` and ``--tune`` (the tune cache, queue 1 item 17), ``--overlap``
other than 0 (the overlap engine, queue 1 item 13). The serve-mode
``halo`` handler waits for ``serve/`` (queue 1 item 19).
"""

from __future__ import annotations

import sys
import time

import numpy as np

from tpu_mpi_tests_torch.utils import TpuMtError
from tpu_mpi_tests_torch.workloads import register_spec
from tpu_mpi_tests_torch.workloads.spec import RunContext, WorkloadSpec


class Stencil1dSpec(WorkloadSpec):
    name = "stencil1d"
    title = __doc__

    def add_args(self, p) -> None:
        p.add_argument(
            "--n-global-mi",
            type=int,
            default=None,
            help="global size in Mi elements (reference argv unit; "
            "default 32)",
        )
        p.add_argument(
            "--n-global",
            type=int,
            default=32 * 1024 * 1024,
            help="global size in elements (exact; overridden by "
            "--n-global-mi)",
        )
        p.add_argument(
            "--staging",
            default="direct",
            choices=["direct", "device", "host", "pallas", "auto"],
            help="halo staging mode (≅ reference stage_host/device "
            "variants); 'pallas' (the hand RDMA ring) and 'auto' (the "
            "tuned winner) are not ported and raise",
        )
        p.add_argument(
            "--tol",
            type=float,
            default=None,
            help="err_norm gate (default: dtype-dependent)",
        )
        p.add_argument(
            "--overlap",
            default="0",
            choices=["0", "1", "2", "auto"],
            help="the double-buffered halo pipeline after the gate: only "
            "0 (off) is ported; any other value raises",
        )
        p.add_argument(
            "--overlap-iters",
            type=int,
            default=32,
            help="pipeline steps for --overlap (default 32)",
        )
        p.add_argument(
            "--tune",
            action="store_true",
            help="the measured autotuner: not ported; raises",
        )

    def check_args(self, p, args) -> None:
        if args.overlap_iters < 1:
            p.error("--overlap-iters must be positive")
        if args.n_global_mi is not None:
            args.n_global = args.n_global_mi * 1024 * 1024
        if args.n_global < 1:
            p.error(f"global size must be positive, got {args.n_global}")
        if args.tune or args.staging == "auto":
            raise TpuMtError(
                "--tune / --staging auto (the halo staging sweep and the "
                "schedule cache) are not ported yet: ROADMAP queue 1 item "
                "17"
            )
        if args.overlap != "0":
            raise TpuMtError(
                f"--overlap {args.overlap} (the double-buffered halo "
                f"pipeline) is not ported yet: ROADMAP queue 1 item 13"
            )

    def build(self, ctx: RunContext):
        from tpu_mpi_tests_torch.arrays.domain import Domain1D
        from tpu_mpi_tests_torch.comm import collectives as C
        from tpu_mpi_tests_torch.comm import halo as H
        from tpu_mpi_tests_torch.instrument.timers import block
        from tpu_mpi_tests_torch.kernels.stencil import analytic_pairs

        args = ctx.args
        world = ctx.topo.global_device_count
        dtype = ctx.dtype()
        # raises for 'pallas', naming ROADMAP queue 2 item 2
        staging = H.Staging.parse(args.staging)
        d = Domain1D(n_global=args.n_global, n_shards=world, n_bnd=2)
        f, df = analytic_pairs()["1d"]

        ctx.rep.banner(
            f"stencil1d: n_global={args.n_global} world={world} "
            f"n_local={d.n_local} dtype={args.dtype} "
            f"staging={args.staging}"
        )
        # the shard is computed on its device (a multi-GB host→device
        # init transfer is the wrong tool at 32Mi+ scale)
        zg = block(C.device_init(
            lambda r: d.init_shard_torch(f, r, dtype, ctx.device)))
        return {"zg": zg, "staging": staging, "d": d, "df": df,
                "dtype": dtype}

    def step(self, ctx: RunContext, state):
        from tpu_mpi_tests_torch.comm import halo as H
        from tpu_mpi_tests_torch.instrument.timers import block

        world = ctx.topo.global_device_count
        zg, staging, d = state["zg"], state["staging"], state["d"]
        # untimed warmup, then one timed exchange (mpi_stencil_gt.cc:
        # 200-205); the exchange is idempotent
        zg = block(H.halo_exchange(zg, 0, d.n_bnd, False, staging))
        t0 = time.perf_counter()
        zg = block(H.halo_exchange(zg, 0, d.n_bnd, False, staging))
        seconds = time.perf_counter() - t0
        for r in range(world):
            ctx.rep.line(
                f"{r}/{world} exchange time {seconds:0.8f}",
                {"kind": "exchange1d", "rank": r, "seconds": seconds},
            )
        state["deriv"] = block(H.stencil_fn(0, d.scale)(zg))
        state["zg"] = zg
        return state

    def verify(self, ctx: RunContext, state) -> int:
        from tpu_mpi_tests_torch.comm import collectives as C

        args = ctx.args
        world = ctx.topo.global_device_count
        d, df, dtype = state["d"], state["df"], state["dtype"]
        n_global = args.n_global
        # per-rank err norms against the analytic derivative, computed on
        # the device (the field never moves to the host)
        actual = C.device_init(
            lambda r: d.interior_shard_torch(df, r, dtype, ctx.device))
        per_rank_err = C.per_rank_err_norms(state["deriv"], actual)
        kind = ctx.topo.device_kinds[0]
        for r in range(world):
            ctx.rep.line(
                f"{r}/{world} [{kind}] err_norm = {per_rank_err[r]:.8f}",
                {"kind": "err_norm", "rank": r,
                 "err": float(per_rank_err[r])},
            )

        if args.tol is not None:
            tol = args.tol
        elif args.dtype == "float64":
            # rounding error grows with scale·√n like the f32 case
            # (coordinate ulps amplified by 1/delta); a broken halo
            # exceeds this by >10⁴
            eps64 = 2.2e-16
            tol = max(
                128 * eps64 * d.length**3 * d.scale * np.sqrt(n_global),
                1e-6,
            )
        else:
            # f32/bf16: cancellation error ≈ eps·max|y|·scale per point;
            # a broken halo exceeds this by >10³
            eps = (7.8e-3 if args.dtype == "bfloat16"
                   else float(np.finfo(np.float32).eps))
            tol = 8 * eps * d.length**3 * d.scale * np.sqrt(n_global)
        if per_rank_err.max() > tol:
            ctx.rep.line(
                f"ERR_NORM FAIL: max {per_rank_err.max():.8g} > tol "
                f"{tol:.8g}"
            )
            return 1
        return 0


SPEC = register_spec(Stencil1dSpec())


def main(argv=None) -> int:
    from tpu_mpi_tests_torch.workloads.runner import make_main

    return make_main(SPEC)(argv)


if __name__ == "__main__":
    sys.exit(main())
