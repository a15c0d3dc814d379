"""Flagship DAXPY benchmark: weak-scaled, phase-timed, with the allgather
(≅ ``tpu_mpi_tests/drivers/mpi_daxpy_nvtx.py``), one process per rank.

≅ ``mpi_daxpy_nvtx.cc``. Semantics preserved:

* weak scaling by node count: ``nall = n_per_node * nodes``, ``n = nall /
  world_size`` (``:121-132``); the nodes are the world's hosts
  (``Topology.hosts``, the analogue of the reference's
  ``MPI_Comm_split_type``, ``:72-82``): a JAX process drives every chip
  of its host, a port process is one rank, so one host of w ranks has
  the ``nall`` of one JAX process over w devices;
* per-rank init ``x[i] = (i+1)/n``, ``y = -x``, ``a = 2`` → ``y = x``,
  local SUM ``(n+1)/2`` (``:207-217``), on the host (``--init host``, the
  reference) or on the card (``--init device``);
* managed vs pinned-host+explicit-copy allocation twins — ``--space``
  instead of the ``-DMANAGED`` twin binaries; MANAGED is emulated (a
  pinned host tensor moved to the card on first use, so the move lands
  in the kernel phase as UVM page faults do);
* ``MPI_Allgather(MPI_IN_PLACE)`` of x + a regular allgather of y
  (``:282-291``), global checksum ALLSUM (``:293-310``), phase times
  total/kernel/barrier/gather printed as ``TIME <phase> : <s>``
  (``:333-340``), a trace range of the reference's NVTX name around every
  phase, profiler capture via ``--profile-dir``.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from tpu_mpi_tests_torch.drivers import _common


def run(args) -> int:
    import tpu_mpi_tests_torch.kernels.daxpy as kd
    from tpu_mpi_tests_torch.arrays.spaces import (
        Space,
        ensure_device,
        meminfo,
        place,
    )
    from tpu_mpi_tests_torch.comm import collectives as C
    from tpu_mpi_tests_torch.comm.mesh import (
        bootstrap,
        device_report,
        topology,
    )
    from tpu_mpi_tests_torch.instrument.timers import PhaseTimer, block
    from tpu_mpi_tests_torch.instrument.trace import ProfilerGate, trace_range
    from tpu_mpi_tests_torch.utils import check_divisible

    dtype = _common.torch_dtype(args)
    device = bootstrap(args.device)
    topo = topology(device)
    world = topo.global_device_count
    managed = args.space == "managed"

    # weak scaling by node (host) count, mpi_daxpy_nvtx.cc:121-132
    nodes = topo.hosts
    nall = args.n_per_node * nodes
    n = check_divisible(nall, world, "nall over ranks")

    rep = _common.make_reporter(args, rank=topo.process_index, size=world)
    with rep:
        rep.banner(
            f"{nodes} nodes, {world} ranks, {n} elements each, total {nall}"
        )
        mb_per_core = os.environ.get("MEMORY_PER_CORE")
        rep.banner(
            f"MEMORY_PER_CORE={mb_per_core}"
            if mb_per_core
            else "MEMORY_PER_CORE is not set"
        )
        rep.banner(device_report(device, verbose=args.verbose))

        timer = PhaseTimer()
        gate = ProfilerGate(args.profile_dir)
        gate.start()

        if args.warmup:
            # run every op of the timed phases once, untimed, on dummies of
            # the real shapes (first launches load kernels and grow the
            # allocator's pool); the real, possibly managed, tensors are
            # untouched so their timed first-use move is kept
            with trace_range("compileWarmup"):
                wx = torch.zeros(n, dtype=dtype, device=device)
                wy = torch.zeros(n, dtype=dtype, device=device)
                block(kd.daxpy(args.a, wx, wy))
                block(C.all_gather_inplace(torch.zeros(
                    world * n, dtype=dtype, device=device)),
                    C.all_gather(wy))
                del wx, wy

        with timer.phase("total"):
            # ── allocateArrays / initializeArrays (+ copyInput if unmanaged)
            if args.init == "device":
                # on-card init: the (i+1)/n pattern computed in place
                with trace_range("initializeArrays"), timer.phase("init"):
                    d_x, d_y = block(kd.init_xy_scaled(n, dtype, device))
                h_x = h_y = None
            else:
                with trace_range("initializeArrays"), timer.phase("init"):
                    # per-rank pattern (i+1)/n tiled across ranks (:207-217)
                    lx, ly = kd.init_xy_scaled_np(n, _common.numpy_dtype(args))
                    h_x = _common.host_tensor(np.tile(lx, world), dtype)
                    h_y = _common.host_tensor(np.tile(ly, world), dtype)
            if args.init == "device":
                pass
            elif managed:
                # managed ≈ host-resident, moved on first device use
                with trace_range("allocateArrays"), timer.phase("alloc"):
                    d_x = place(C.shard_1d(h_x, "cpu"), Space.MANAGED,
                                device)
                    d_y = place(C.shard_1d(h_y, "cpu"), Space.MANAGED,
                                device)
            else:
                with trace_range("copyInput"), timer.phase("copyInput"):
                    d_x = block(C.shard_1d(h_x, device))
                    d_y = block(C.shard_1d(h_y, device))
            if args.verbose:
                rep.line(f"MEMINFO d_x: {meminfo(d_x)}")
                rep.line(f"MEMINFO d_y: {meminfo(d_y)}")

            # ── kernel (:242-249) ──
            with trace_range("daxpy"), timer.phase("kernel"):
                # managed tensors move to the card here, so the move is
                # charged to kernel time like UVM page faults
                d_x = ensure_device(d_x, device)
                d_y = ensure_device(d_y, device)
                d_y = block(kd.daxpy(args.a, d_x, d_y))

            # ── localSum (+ copyOutput if unmanaged) (:251-268) ──
            with trace_range("localSum"), timer.phase("localSum"):
                local_sums = C.per_rank_sums(d_y).astype(np.float64)
            for r in range(world):
                rep.sum_line(local_sums[r], rank=r)

            # ── copyPrepAllxInplace (:270-272): own slice into the gather buf
            with trace_range("copyPrepAllxInplace"), timer.phase("copyPrep"):
                d_allx = torch.empty(world * n, dtype=d_x.dtype,
                                     device=device)
                d_allx[topo.process_index * n:
                       (topo.process_index + 1) * n].copy_(d_x)
                block(d_allx)

            # ── optional barrier (:274-280) ──
            if args.barrier:
                with trace_range("mpiBarrier"), timer.phase("barrier"):
                    C.barrier(device)

            # ── allgather x (IN_PLACE) + y (:282-291) ──
            with trace_range("mpiAllGather"), timer.phase("gather"):
                with trace_range("x"):
                    g_allx = C.all_gather_inplace(d_allx)
                with trace_range("y"):
                    g_ally = C.all_gather(d_y)
                block(g_allx, g_ally)

            # ── allSum global checksum (:293-310) ──
            # device reductions accumulate at the run's precision: f64 runs
            # are gated with tol 0 below, which an f32 sum of 48Mi elements
            # cannot meet
            acc_dtype = (torch.float64 if args.dtype == "float64"
                         else torch.float32)
            with trace_range("allSum"), timer.phase("allSum"):
                if args.init == "device":
                    # device reduction (the gathered array stays on the card)
                    all_sum = float(torch.sum(g_ally.to(acc_dtype)))
                else:
                    all_sum = float(
                        C.host_value(g_ally).astype(np.float64).sum()
                    )
            rep.sum_line(all_sum, label="ALLSUM")

        gate.stop()
        for phase in ("total", "kernel", "barrier", "gather"):
            if timer.counts[phase]:
                rep.time_line(phase, timer.seconds[phase],
                              *timer.wall_span(phase))

        # verification: y = x elementwise → ALLSUM = world*(n+1)/2; the
        # gathered x must equal the original global x (in-place parity)
        expected_all = world * (n + 1) / 2
        if args.dtype == "float64":
            # host np.float64 sums reproduce the reference's exact
            # checksums; device f64 reductions may differ by order
            tol = 0 if args.init == "host" else 1e-12 * abs(expected_all)
        else:
            tol = max(1e-5 * abs(expected_all), 1.0)
        ok = abs(all_sum - expected_all) <= tol
        if h_x is not None:
            if not np.array_equal(C.host_value(g_allx), C.host_value(h_x)):
                rep.line("GATHER PARITY FAIL: gathered x != filled buffer")
                ok = False
        else:
            # device-init path: in-place-gather parity via the x checksum
            # (x sums to (n+1)/2 per rank, like y)
            gx_sum = float(torch.sum(g_allx.to(acc_dtype)))
            if abs(gx_sum - expected_all) > tol:
                rep.line(
                    f"GATHER PARITY FAIL: x sum {gx_sum} != {expected_all}"
                )
                ok = False
        if not ok:
            rep.line(f"CHECKSUM FAIL: ALLSUM {all_sum} != {expected_all}")
            return 1
        return 0


def main(argv=None) -> int:
    p = _common.base_parser(__doc__)
    p.add_argument(
        "--n-per-node",
        type=int,
        default=48 * 1024 * 1024,
        help="elements per node for weak scaling (reference: 48Mi doubles)",
    )
    p.add_argument("--a", type=float, default=2.0)
    p.add_argument(
        "--space",
        default="device",
        choices=["device", "managed"],
        help="allocation mode (≅ the -DMANAGED twin binaries; managed is "
        "emulated: host-resident, moved on first device use)",
    )
    p.add_argument(
        "--barrier",
        action="store_true",
        help="time an explicit barrier before the gather (≅ -DBARRIER)",
    )
    p.add_argument(
        "--init",
        default="host",
        choices=["host", "device"],
        help="host init + copy (reference phase semantics, the default) or "
        "on-card init + device reductions",
    )
    p.add_argument(
        "--no-warmup",
        dest="warmup",
        action="store_false",
        help="charge first-launch costs to the timed phases (default: run "
        "every op once untimed first)",
    )
    args = p.parse_args(argv)
    if args.n_per_node < 1:
        p.error(f"--n-per-node must be positive, got {args.n_per_node}")
    return _common.run_guarded(run, args)


if __name__ == "__main__":
    sys.exit(main())
