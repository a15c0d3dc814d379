"""Collective micro-benchmark sweep: per-collective bandwidth vs message
size, one process per rank (≅ ``tpu_mpi_tests/drivers/collbench.py``).

The reference is an MPI collective/neighbour-exchange suite (Allgather
``mpi_daxpy_nvtx.cc:282-291``, in-place Allreduce
``mpi_stencil2d_gt.cc:609-648``, Isend/Irecv ``mpi_stencil_gt.cc:83-122``)
at a few fixed sizes; this driver sweeps every collective over a geometric
ladder of message sizes, each measured as a chained loop
(``instrument.timers.chain_rate``: two run lengths differenced, CUDA
events on the card).

Output per (collective, size), the JAX driver's line::

    COLL <name> bytes=<per-shard-bytes> <us> us/iter  busbw=<GB/s>  n=<iters>

``busbw`` follows the nccl-tests ring accounting (:func:`_busbw_bytes`;
0 at world=1, where nothing moves). The library tier runs over
``torch.distributed`` (``all_gather_into_tensor``, ``all_reduce``,
``reduce_scatter_tensor``, ``Ring.shift``, ``all_to_all_single``; at
world=1 each is its degenerate copy or identity). The hand tiers run
through the port's CUDA kernels (their plain versions on the CPU):
``allgather_rdma`` / ``allreduce_rdma`` the ring all-gather and ring
reduce-scatter + all-gather (``--rdma-credits``), ``allgather_oneshot``
/ ``allreduce_oneshot`` the one-shot kernel. Where the ring's chunking
refuses a size (``allreduce_rdma``: elements % world), the row is
``COLL-SKIP``.

Not ported yet, each raising: ``--collectives auto`` and ``--tune`` (the
variant and dispatch-depth knobs, ROADMAP queue 1 item 17, ``tune/``),
the telemetry compile probe (item 18) and the serve-mode ``allreduce``
workload (item 19).
"""

from __future__ import annotations

import sys

import torch

from tpu_mpi_tests_torch.drivers import _common

COLLECTIVES = (
    "allgather", "allreduce", "reducescatter", "ppermute", "alltoall"
)
#: the hand ring twins (opt-in, as in the JAX driver)
COLLECTIVES_RDMA = ("allgather_rdma", "allreduce_rdma")
#: the one-shot in-kernel tier
COLLECTIVES_ONESHOT = ("allgather_oneshot", "allreduce_oneshot")

# the JAX driver's parse pattern, character for character (a test holds
# the two strings equal)
COLL_LINE_RE = (
    r"COLL (\w+) bytes=(\d+) ([\d.e+-]+|nan) us/iter  "
    r"busbw=([\d.e+-]+|nan) GB/s  n=(\d+)(?: credits=(\d+))?"
)

#: where each left-out feature is queued
NOT_PORTED = {
    "auto": "--collectives auto (the per-size variant knob) is ROADMAP "
            "queue 1 item 17 (tune/), not ported",
    "tune": "--tune (the variant and dispatch-depth sweeps) is ROADMAP "
            "queue 1 item 17 (tune/), not ported",
    "telemetry": "--telemetry (span telemetry and the per-row compile "
                 "probe) is ROADMAP queue 1 item 18, not ported",
    "serve": "the serve-mode allreduce workload is ROADMAP queue 1 item "
             "19 (serve/), not ported",
}


def _loop_fn(name: str, world: int, rank: int, rdma_credits: int = 1):
    """``run(x, n)``: ``n`` chained iterations of collective ``name`` on
    this rank's 1-D shard ``x``, each the JAX driver's ``_loop_fn`` body
    (:102-161), so every iteration depends on the one before."""
    import torch.distributed as tdist

    from tpu_mpi_tests_torch.comm import collectives as C
    from tpu_mpi_tests_torch.comm.mesh import make_mesh

    def consume_neighbor(gathered, x):
        # read the neighbour's slice, as the JAX body does (there, reading
        # one's own slice lets XLA cancel the gather)
        n = x.shape[0]
        nbr = (rank + 1) % world
        return gathered[nbr * n:(nbr + 1) * n] * 0.999 + 1e-7

    if name == "allgather":
        def body(x):
            return consume_neighbor(C.all_gather(x), x)
    elif name == "allreduce":
        def body(x):
            return C.allreduce_sum(x[None].clone())[0] * (1.0 / world)
    elif name == "reducescatter":
        def body(x):
            rs = C.reduce_scatter_sum(x[None])[0]
            # re-expand so the chain stays shape-stable
            return rs.repeat(world) * (1.0 / world)
    elif name == "ppermute":
        ring = make_mesh()

        def body(x):
            return ring.shift(x) if world > 1 else x.clone()
    elif name == "allgather_rdma":
        def body(x):
            return consume_neighbor(C.all_gather_rdma(x), x)
    elif name == "allreduce_rdma":
        def body(x):
            return C.allreduce_rdma(x[None], credits=rdma_credits)[0] \
                * (1.0 / world)
    elif name == "allgather_oneshot":
        def body(x):
            return consume_neighbor(C.all_gather_oneshot(x), x)
    elif name == "allreduce_oneshot":
        def body(x):
            return C.allreduce_oneshot(x[None])[0] * (1.0 / world)
    elif name == "alltoall":
        def body(x):
            y = x.reshape(world, x.shape[0] // world)
            if world > 1:
                out = torch.empty_like(y)
                tdist.all_to_all_single(out, y, group=C._group_for(y))
                y = out
            return y.reshape(x.shape) * 0.999 + 1e-7
    else:
        raise ValueError(f"unknown collective {name!r}")

    def run(x, n_iter):
        for _ in range(n_iter):
            x = body(x)
        return x

    return run


def _busbw_bytes(name: str, shard_bytes: int, world: int) -> float:
    # tiers are accounted with the base collective's formula (nccl-tests
    # algorithm-normalized convention)
    name = name.removesuffix("_rdma").removesuffix("_oneshot")
    if world < 2:
        return 0.0
    if name == "allgather":
        return (world - 1) * shard_bytes  # (w-1)/w of gathered = (w-1)*shard
    if name == "allreduce":
        return 2 * (world - 1) / world * shard_bytes
    if name == "reducescatter":
        return (world - 1) / world * shard_bytes
    if name == "ppermute":
        return float(shard_bytes)
    return (world - 1) / world * shard_bytes  # alltoall


def run(args) -> int:
    from tpu_mpi_tests_torch.comm import collectives as C
    from tpu_mpi_tests_torch.comm.mesh import bootstrap, topology
    from tpu_mpi_tests_torch.instrument.timers import chain_rate
    from tpu_mpi_tests_torch.utils import TpuMtError, check_divisible

    for flag in ("tune", "telemetry"):
        if getattr(args, flag):
            raise TpuMtError(NOT_PORTED[flag])
    device = bootstrap(args.device)
    topo = topology(device)
    world = topo.global_device_count
    rank = topo.process_index

    rep = _common.make_reporter(args, rank=rank, size=world)
    with rep:
        rep.banner(
            f"collbench: world={world} sizes_kib={args.sizes_kib} "
            f"collectives={args.collectives} n_iter={args.n_iter} "
            f"rdma_credits={args.rdma_credits}"
        )
        names = _common.parse_choice_list(
            args.collectives,
            COLLECTIVES + COLLECTIVES_RDMA + COLLECTIVES_ONESHOT
            + ("auto",),
            "collective",
        )
        if names is None:
            return 2
        if "auto" in names:
            raise TpuMtError(NOT_PORTED["auto"])

        dtype = _common.torch_dtype(args)
        itemsize = torch.empty((), dtype=dtype).element_size()
        for name in names:
            for kib in (int(s) for s in args.sizes_kib.split(",")):
                shard_bytes = kib * 1024
                n = shard_bytes // itemsize
                if name in ("alltoall", "reducescatter"):
                    # both split the shard w ways
                    check_divisible(n, world, f"{name} elements per shard")
                why = (C.allreduce_rdma_refusal(n)
                       if name == "allreduce_rdma" else None)
                if why is not None:
                    rep.line(f"COLL-SKIP {name} bytes={shard_bytes} ({why})")
                    continue
                run_fn = _loop_fn(name, world, rank,
                                  rdma_credits=args.rdma_credits)
                x = torch.ones(n, dtype=dtype, device=device)
                # scale the chain length inversely with payload so small
                # messages accumulate enough time to clear timer noise;
                # the count is reported per row (the JAX rule, :396-399)
                n_eff = min(
                    max(args.n_iter, 100_000),
                    max(args.n_iter, args.n_iter * (1 << 20)
                        // max(shard_bytes, 1)),
                )
                sec, x = chain_rate(
                    run_fn, x, n_short=n_eff // 10 or 1, n_long=n_eff
                )
                moved = _busbw_bytes(name, shard_bytes, world)
                busbw = moved / sec / 1e9
                cred_txt = (f" credits={args.rdma_credits}"
                            if name == "allreduce_rdma" else "")
                cred_rec = ({"rdma_credits": args.rdma_credits}
                            if name == "allreduce_rdma" else {})
                rep.line(
                    f"COLL {name} bytes={shard_bytes} {sec * 1e6:0.2f} us/iter"
                    f"  busbw={busbw:0.4g} GB/s  n={n_eff}{cred_txt}",
                    {"kind": "coll", "collective": name, "dtype": args.dtype,
                     "shard_bytes": shard_bytes, "us_per_iter": sec * 1e6,
                     "busbw_gbps": busbw, "world": world, "n_iter": n_eff,
                     **cred_rec},
                )
                del x
        return 0


def serve_step_factory(*_args, **_kwargs):
    """The JAX driver registers its chained small allreduce as the
    serve-mode ``allreduce`` workload (:486-526); the port has no serve
    mode yet."""
    from tpu_mpi_tests_torch.utils import TpuMtError

    raise TpuMtError(NOT_PORTED["serve"])


def main(argv=None) -> int:
    p = _common.base_parser(__doc__)
    p.add_argument(
        "--collectives",
        default=",".join(COLLECTIVES),
        help="comma list of collectives to sweep; beyond the default "
        f"library tier, {'/'.join(COLLECTIVES_RDMA)} select the hand ring "
        "kernels (sizes the ring's chunking refuses are reported as "
        f"COLL-SKIP) and {'/'.join(COLLECTIVES_ONESHOT)} the one-shot "
        "kernel; 'auto' (the tuned variant) is not ported and raises",
    )
    p.add_argument(
        "--rdma-credits", type=int, default=1, choices=(1, 2),
        help="receiver-credit depth of the allreduce_rdma ring's "
        "reduce-scatter: 2 lets two payloads be in flight",
    )
    p.add_argument(
        "--sizes-kib",
        default="4,64,1024,16384",
        help="comma list of per-shard payload sizes in KiB",
    )
    p.add_argument(
        "--n-iter", type=int, default=500,
        help="chained iterations per measurement at 1 MiB payloads; "
        "smaller payloads scale the count up inversely (capped at 100k); "
        "the actual count is reported per row as n=",
    )
    p.add_argument(
        "--tune", action="store_true",
        help="sweep the collective variants (not ported: ROADMAP queue 1 "
        "item 17; raises)",
    )
    p.add_argument(
        "--telemetry", action="store_true",
        help="span telemetry and the compile probe (not ported: ROADMAP "
        "queue 1 item 18; raises)",
    )
    args = p.parse_args(argv)
    if args.n_iter < 10:
        p.error("--n-iter must be >= 10")
    return run(args)


if __name__ == "__main__":
    sys.exit(main())
