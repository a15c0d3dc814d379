"""1-D 5-point stencil with halo exchange — as a workload spec (≅
``tpu_mpi_tests/workloads/stencil1d.py``, itself ≅ ``mpi_stencil_gt.cc``),
one process per rank.

y = x³ over n_global points (default 32Mi, ``--n-global-mi`` in Mi units
like the reference argv) split over the ranks, ghost width 2; one timed
halo exchange; the stencil derivative; the per-rank ``err_norm`` against
the analytic 3x², exact to rounding for a cubic. Output lines preserved,
each rank printing its own::

    <rank>/<size> exchange time <s>
    <rank>/<size> [<device>] err_norm = <v>

At world=1 the non-periodic exchange moves nothing (the one shard keeps
its physical ghosts), as in the JAX package's single-device runs.
``--staging`` takes ``direct``, ``device``, ``host`` and ``pallas`` (the
hand RDMA ring, ``hand.ring_halo``, the shard running as an (n, 1)
column; at world=1 it launches and moves nothing). The derivative is the
torch-op stencil (the XLA tier's counterpart), as in the JAX package.

``--staging auto`` resolves the ``halo/staging`` knob through the
schedule cache (the tuned winner for this dtype, extent and ring size,
else DIRECT); with ``--tune`` a cache miss first sweeps the staging
candidates on this buffer, each priced by a chained feedback loop of
exchanges (``tune.sweep.feedback_rate``), and the run prints ``TUNE
halo/staging resolved -> <mode>``.

``--overlap {1,2,auto}`` then runs the double-buffered halo pipeline
for ``--overlap-iters`` steps on a copy of the verified field
(``comm/halo.py``'s overlap engine; ``auto`` resolves the
``halo/overlap`` knob, and with ``--tune`` a miss sweeps the depths
first, each priced on a short pipeline run); depth 2 is held bit for bit
against a depth-1 rerun and prints ``OVERLAP FAIL`` and exits 1 on a
difference. The serve-mode ``halo`` handler
(:meth:`Stencil1dSpec.serve_factory`) runs chained exchanges through a
``DispatchWindow`` whose depth is the ``coll/dispatch_depth`` knob.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from tpu_mpi_tests_torch.workloads import register_spec
from tpu_mpi_tests_torch.workloads.spec import RunContext, WorkloadSpec


class Stencil1dSpec(WorkloadSpec):
    name = "stencil1d"
    title = __doc__

    @property
    def serve_name(self) -> str:
        return "halo"

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
            "variants; 'pallas' is the hand RDMA ring; 'auto' = the "
            "schedule cache's winner for this configuration, else direct "
            "— with --tune a cache miss runs the measured sweep first)",
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
            help="run the double-buffered halo pipeline after the gate: "
            "0 = off (default), 1 = the serialized schedule, 2 = exchange "
            "in flight under the interior compute, auto = the schedule "
            "cache's depth, else the prior (1; with --tune a cache miss "
            "sweeps the depths first); depth>=2 is verified bit for bit "
            "against depth 1",
        )
        p.add_argument(
            "--overlap-iters",
            type=int,
            default=32,
            help="pipeline steps for --overlap (default 32)",
        )

    def check_args(self, p, args) -> None:
        if args.overlap_iters < 1:
            p.error("--overlap-iters must be positive")
        if args.n_global_mi is not None:
            args.n_global = args.n_global_mi * 1024 * 1024
        if args.n_global < 1:
            p.error(f"global size must be positive, got {args.n_global}")

    def build(self, ctx: RunContext):
        from tpu_mpi_tests_torch.arrays.domain import Domain1D
        from tpu_mpi_tests_torch.comm import collectives as C
        from tpu_mpi_tests_torch.comm import halo as H
        from tpu_mpi_tests_torch.instrument.timers import block
        from tpu_mpi_tests_torch.kernels.stencil import analytic_pairs

        args = ctx.args
        world = ctx.topo.global_device_count
        dtype = ctx.dtype()
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
        if staging is H.Staging.AUTO:
            if args.tune:
                _tune_staging(zg, world)
            staging = H.resolve_staging("auto", zg, 0, world)
            ctx.rep.banner(f"TUNE halo/staging resolved -> {staging.value}")
        zg = block(H.staging_buffer(zg, staging))
        return {"zg": zg, "staging": staging, "d": d, "df": df,
                "dtype": dtype}

    def step(self, ctx: RunContext, state):
        from tpu_mpi_tests_torch.comm import halo as H
        from tpu_mpi_tests_torch.instrument.timers import block

        world, rank = ctx.topo.global_device_count, ctx.topo.process_index
        zg, staging, d = state["zg"], state["staging"], state["d"]
        # untimed warmup, then one timed exchange (mpi_stencil_gt.cc:
        # 200-205); the exchange is idempotent
        zg = block(H.halo_exchange(zg, 0, d.n_bnd, False, staging))
        t0 = time.perf_counter()
        zg = block(H.halo_exchange(zg, 0, d.n_bnd, False, staging))
        seconds = time.perf_counter() - t0
        ctx.rep.line(
            f"{rank}/{world} exchange time {seconds:0.8f}",
            {"kind": "exchange1d", "rank": rank, "seconds": seconds},
        )
        deriv_fn = H.stencil_fn(0, d.scale)
        # the derivative's first call (telemetry runs only): the field
        # read, the derivative written, 5 multiply-adds a point
        from tpu_mpi_tests_torch.instrument import costs

        costs.compile_probe(deriv_fn, lambda: (zg,), label="stencil1d_deriv",
                            flops=10 * zg.numel(),
                            bytes_accessed=2 * zg.numel() * zg.element_size(),
                            dtype=ctx.args.dtype, n=ctx.args.n_global,
                            world=world)
        state["deriv"] = block(deriv_fn(zg))
        state["zg"] = zg
        return state

    def verify(self, ctx: RunContext, state) -> int:
        from tpu_mpi_tests_torch.comm import collectives as C

        args = ctx.args
        world, rank = ctx.topo.global_device_count, ctx.topo.process_index
        d, df, dtype = state["d"], state["df"], state["dtype"]
        n_global = args.n_global
        # per-rank err norms against the analytic derivative, computed on
        # the device (the field never moves to the host)
        actual = C.device_init(
            lambda r: d.interior_shard_torch(df, r, dtype, ctx.device))
        per_rank_err = C.per_rank_err_norms(state["deriv"], actual)
        kind = ctx.topo.device_kinds[0]
        ctx.rep.line(
            f"{rank}/{world} [{kind}] err_norm = {per_rank_err[rank]:.8f}",
            {"kind": "err_norm", "rank": rank,
             "err": float(per_rank_err[rank])},
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
        if args.overlap != "0":
            return _run_overlap(args, ctx.rep, world, state["zg"], d)
        return 0

    def serve_factory(self, device, shape, dtype):
        """Serve-mode handler (≅ JAX ``stencil1d.py:250``): ``step_fn(n)``
        performs ``n`` halo exchanges on a persistent ghosted shard (the
        exchange is idempotent — ghosts are rewritten with identical
        values — so chained requests are the driver's timed step). Each
        exchange goes through :func:`~tpu_mpi_tests_torch.comm.halo.
        halo_exchange`, so with telemetry on every request also lands its
        own span.

        The staging is ``AUTO``, resolved once when the handler is built
        (the cache's ``halo/staging`` winner for this dtype, extent and
        world, else the DIRECT prior): the buffer depends on it. Where it
        is ``pallas`` (one ``hand.ring_halo`` launch an exchange) the
        field lives in the ring's peer memory (``halo.staging_buffer``)
        and, as in the JAX package, ignores the window; DIRECT and
        DEVICE_STAGED exchange with torch ops (``kernel="torch"``, the
        JAX XLA pack's counterpart). The exchanges are posted through a
        :class:`~tpu_mpi_tests_torch.comm.collectives.DispatchWindow`
        whose depth resolves from the schedule cache
        (``coll/dispatch_depth``, prior 1): at depth 1 every exchange
        waits, at depth ≥ 2 up to that many run before the window waits
        once. A failed batch rebuilds the field before the error
        propagates (the JAX handler's rule: its exchange donates)."""
        import torch

        from tpu_mpi_tests_torch.arrays.domain import Domain1D
        from tpu_mpi_tests_torch.comm import collectives as C
        from tpu_mpi_tests_torch.comm import dist
        from tpu_mpi_tests_torch.comm import halo as H
        from tpu_mpi_tests_torch.drivers import _common
        from tpu_mpi_tests_torch.instrument.timers import block
        from tpu_mpi_tests_torch.kernels.stencil import analytic_pairs

        if len(shape) != 1:
            raise ValueError(f"halo wants a 1-d shape, got {shape}")
        (n,) = shape
        world = dist.world().size
        d = Domain1D(n_global=n, n_shards=world, n_bnd=2)
        f, _ = analytic_pairs()["1d"]
        dt = _common.TORCH_DTYPES[dtype]
        device = torch.device(device)
        depth = C.resolve_dispatch_depth(dtype=dtype, n=n, world=world)

        def field():
            return C.device_init(
                lambda r: d.init_shard_torch(f, r, dt, device))

        # the knob's context needs the block's dtype and extent only
        staging = H.resolve_staging(
            H.Staging.AUTO,
            torch.empty(d.n_ghosted, dtype=dt, device="meta"), 0, world)

        def init():
            return block(H.staging_buffer(field(), staging))

        state = {"z": init()}

        def step(k: int):
            try:
                z = state["z"]
                with C.DispatchWindow(depth) as win:
                    for _ in range(k):
                        z = H.halo_exchange(
                            z, 0, d.n_bnd, False, staging,
                            window=win if depth > 1 else None)
                state["z"] = block(z)
            except Exception:
                state["z"] = init()
                raise

        step(1)  # warm before traffic opens
        step.state = state
        step.staging = staging
        step.depth = depth
        step.field = field
        return step


def _tune_staging(zg, world: int) -> None:
    """The ``halo/staging`` sweep on this buffer (≅ JAX
    ``stencil1d.py:112-135``): each candidate prices a chained feedback
    loop of exchanges on a copy (``feedback_rate``; CUDA events on the
    card), the pallas candidate on a copy in the ring's peer memory; a
    candidate that cannot run is declined with its reason. The winner is
    stored (rank 0 decides and writes) and resolved by the caller."""
    from tpu_mpi_tests_torch.comm import halo as H
    from tpu_mpi_tests_torch.tune.sweep import ensure_tuned, feedback_rate

    def measure(cand):
        staging = H.Staging.parse(cand)
        if staging is H.Staging.PALLAS_RDMA and H.rdma_refusal():
            raise ValueError(f"pallas cannot run here "
                             f"({H.rdma_refusal()})")
        z = H.staging_buffer(zg.clone(), staging)
        sec, z = feedback_rate(
            lambda t: H.halo_exchange(t, 0, 2, False, staging), z)
        del z
        return sec

    ensure_tuned("halo/staging", measure, device_fallback=False,
                 **H._staging_context(zg, 0, world))


def _run_overlap(args, rep, world, zg, d) -> int:
    """The ``--overlap`` mode (≅ the JAX ``_run_overlap``): the 1-D
    Jacobi pipeline (``halo.overlap_jacobi_fns``) for ``--overlap-iters``
    steps on a copy of the verified field. Depth ≥ 2 is held bit for bit
    against a depth-1 rerun — the seam's gate — and the measured
    ``overlap_frac`` goes on the phase's ``time`` record and the
    ``kind: "overlap"`` record."""
    import torch

    from tpu_mpi_tests_torch.comm import halo as H
    from tpu_mpi_tests_torch.comm.topology import mesh_link_meta
    from tpu_mpi_tests_torch.instrument.timers import PhaseTimer, block

    eps = 1e-6
    n_iters = args.overlap_iters
    explicit = None if args.overlap == "auto" else int(args.overlap)
    fns = H.overlap_jacobi_fns(0, 2, float(d.scale), eps)
    nbytes = H.halo_payload_bytes(zg, 0, world, 2, False)

    def pipeline(depth: int, n: int, timer=None):
        runner = H.OverlapRunner(
            "halo_exchange", depth=depth, nbytes=nbytes, axis_name="shard",
            world=world, timer=timer, phase="overlap_interior",
            **mesh_link_meta())
        z = H.overlap_steps(runner, fns, zg.clone(), n)
        return block(z), runner

    ctx = {"dtype": args.dtype, "n": args.n_global, "world": world}
    if explicit is None and args.tune:
        from tpu_mpi_tests_torch.tune.sweep import ensure_tuned

        def measure(cand):
            # warm outside the window, then a short pipeline run
            pipeline(int(cand), 1)
            t0 = time.perf_counter()
            pipeline(int(cand), max(4, n_iters // 4))
            return time.perf_counter() - t0

        ensure_tuned("halo/overlap", measure, device_fallback=False, **ctx)
    depth = H.resolve_overlap_depth(explicit, **ctx)
    rep.banner(f"OVERLAP halo depth resolved -> {depth}")

    pipeline(depth, 1)  # warm
    timer = PhaseTimer()
    t0 = time.perf_counter()
    z, runner = pipeline(depth, n_iters, timer=timer)
    seconds = time.perf_counter() - t0
    it_per_s = n_iters / seconds if seconds > 0 else float("inf")

    rc = 0
    if depth > 1:
        # the seam's gate: the pipelined schedule equals the serialized
        # one bit for bit (the same functions, reordered)
        z_ref, _ = pipeline(1, n_iters)
        if not torch.equal(z, z_ref):
            rep.line(
                f"OVERLAP FAIL depth={depth}: pipelined result diverges "
                f"from the depth-1 schedule (seam defect)"
            )
            rc = 1
        del z_ref
    del z

    runner.annotate(timer)
    rep.time_lines(timer, stats=True)
    rep.line(
        f"OVERLAP halo depth={depth} iters={n_iters} "
        f"{it_per_s:0.1f} it/s overlap_frac={runner.overlap_frac:0.3f}",
        runner.record(
            "halo", iters=n_iters, it_per_s=it_per_s, dtype=args.dtype,
            n=args.n_global,
        ),
    )
    return rc


SPEC = register_spec(Stencil1dSpec())


def main(argv=None) -> int:
    from tpu_mpi_tests_torch.workloads.runner import make_main

    return make_main(SPEC)(argv)


if __name__ == "__main__":
    sys.exit(main())
