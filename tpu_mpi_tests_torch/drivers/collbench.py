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

``--collectives auto`` runs the collectives with hand twins (allgather,
allreduce) with each size's variant resolved through the schedule cache
(``coll_variant/<base>``: the library tier ``torch``, ``rdma``,
``oneshot``; prior ``torch``); with ``--tune`` a miss prices the three
on the device at that size first. A candidate that cannot run here is
declined with its reason and never wins (:func:`variant_refusal`). Over
several processes rank 0 sweeps and every rank runs the broadcast
winner. ``auto`` rows carry ``auto: true``. Under ``--telemetry`` each
row's first call is probed (``instrument/costs.py``, ``coll_<name>``).
``--tune`` also prices the ``coll/dispatch_depth`` knob on a miss
(:func:`_tune_dispatch_depth`), whose reader is the serve ``halo``
handler. The chained small allreduce is the serve-mode ``allreduce``
workload (:func:`serve_step_factory`).
"""

from __future__ import annotations

import sys

import torch

from tpu_mpi_tests_torch.drivers import _common
from tpu_mpi_tests_torch.tune import priors as _priors
from tpu_mpi_tests_torch.tune.registry import declare_space

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

#: the variants of a collective with hand twins
COLL_VARIANTS = (_priors.COLL_VARIANT, "rdma", "oneshot")

#: the variant knobs (≅ JAX ``COLL_VARIANT_SPACES``), declared where the
#: variant choice lives: the library tier, the ring kernels, the
#: one-shot kernel
COLL_VARIANT_SPACES = {
    base: declare_space(
        f"coll_variant/{base}", COLL_VARIANTS,
        describe="library collective vs the hand ring kernels vs the "
                 "one-shot kernel")
    for base in ("allgather", "allreduce")
}

def effective_name(base: str, variant: str) -> str:
    """The collective a variant of ``base`` runs (``allgather`` +
    ``rdma`` → ``allgather_rdma``; the library tier is ``base``)."""
    return base if variant == _priors.COLL_VARIANT else f"{base}_{variant}"


def variant_refusal(name: str, n: int, world: int) -> "str | None":
    """Why collective ``name`` cannot run on ``n`` elements a shard in
    this world, or None: the ring reduce-scatter's chunking (n % world),
    a world the hand RDMA tiers cannot map (more than one host, or ranks
    sharing a card: ``halo.rdma_refusal``), more ranks than the signal
    pad serves (``peer.check_collective_world``)."""
    from tpu_mpi_tests_torch.comm import collectives as C
    from tpu_mpi_tests_torch.comm.halo import rdma_refusal
    from tpu_mpi_tests_torch.comm.peer import PeerError, \
        check_collective_world

    if name not in COLLECTIVES_RDMA + COLLECTIVES_ONESHOT:
        return None
    why = rdma_refusal()
    if why is not None:
        return why
    try:
        check_collective_world(world, name)
    except PeerError as e:
        return str(e)
    if name == "allreduce_rdma":
        return C.allreduce_rdma_refusal(n)
    return None


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


#: chain pairs a sweep's measurement prices in a world of several ranks
SWEEP_REPEATS_OVER_RANKS = 3


def _measure_chain(name, args, world, rank, n, dtype, device) -> float:
    """Seconds an iteration of collective ``name``'s chained loop, at a
    tenth of the row's chain (a sweep's measurement; ``decode``'s
    variant sweep measures with it too). Over ranks the pair of chains
    is priced :data:`SWEEP_REPEATS_OVER_RANKS` times and the fastest
    valid pair kept: a peer's lag lands in whichever chain it hits and
    can outlast the short chain's whole difference, which alone would
    leave the candidate unmeasured (NaN)."""
    from tpu_mpi_tests_torch.instrument.timers import chain_rate

    fn = _loop_fn(name, world, rank,
                  rdma_credits=getattr(args, "rdma_credits", 1))
    x = torch.ones(n, dtype=dtype, device=device)
    n_meas = max(10, args.n_iter // 10)
    sec, _ = chain_rate(fn, x, n_short=n_meas // 10 or 1, n_long=n_meas,
                        repeats=1 if world == 1 else SWEEP_REPEATS_OVER_RANKS)
    return sec


def resolve_variant(base, args, world, rank, n, dtype, device,
                    shard_bytes) -> str:
    """The collective an ``auto`` entry runs at one size (≅ JAX
    ``_resolve_variant``): :func:`tuned_variant`, and the library tier
    with a NOTE where the resolved variant cannot run here."""
    variant, why = tuned_variant(base, args, world, rank, n, dtype, device,
                                 shard_bytes)
    if why is not None:
        # a cached winner carried to a world or size it cannot run at
        _common.decline_note(
            f"coll_variant/{base} {variant} cannot run at bytes="
            f"{shard_bytes} world={world} ({why}); running {base}")
        return base
    return effective_name(base, variant)


def tuned_variant(base, args, world, rank, n, dtype, device,
                  shard_bytes) -> "tuple[str, str | None]":
    """``(variant, why it cannot run here or None)`` of
    ``coll_variant/<base>`` at one size: cached > prior, and with
    ``--tune`` a miss prices every variant on the device at this size
    (collbench's and ``decode``'s sweep). A variant that cannot run
    raises in its measurement, is recorded as declined with the reason
    and never wins; a malformed cached value gives the prior."""
    from tpu_mpi_tests_torch.tune.sweep import ensure_tuned
    from tpu_mpi_tests_torch.utils import TpuMtError

    def measure(variant):
        name = effective_name(base, variant)
        why = variant_refusal(name, n, world)
        if why is not None:
            raise TpuMtError(f"{name} declined: {why}")
        return _measure_chain(name, args, world, rank, n, dtype, device)

    variant = ensure_tuned(
        f"coll_variant/{base}", measure,
        # payload-keyed: the 16 MiB winner must not decide the 4 KiB row
        device_fallback=False,
        dtype=args.dtype, bytes=shard_bytes, world=world)
    if variant not in COLL_VARIANTS:
        variant = _priors.COLL_VARIANT  # a malformed cached value
    return variant, variant_refusal(effective_name(base, variant), n,
                                    world)


def _tune_dispatch_depth(args, world: int, rank: int, device) -> None:
    """Sweep the ``coll/dispatch_depth`` knob on a cache miss (≅ JAX
    ``_tune_dispatch_depth``): a host-chained run of small allreduces
    posted through a :class:`~tpu_mpi_tests_torch.comm.collectives.
    DispatchWindow` at each candidate depth — the latency-bound chaining
    pattern the window exists for — timed on the host clock from the
    first post to the wait after the last. The winner persists under the
    full and the device-only fingerprints, so every chained site on this
    machine (the serve ``halo`` handler) resolves it."""
    import time

    from tpu_mpi_tests_torch.comm import collectives as C
    from tpu_mpi_tests_torch.instrument.timers import block
    from tpu_mpi_tests_torch.tune.sweep import ensure_tuned

    dtype = _common.torch_dtype(args)
    # the smallest ladder size: the fixed cost of a dispatch dominates
    shard_bytes = min(int(s) for s in args.sizes_kib.split(",")) * 1024
    n = shard_bytes // torch.empty((), dtype=dtype).element_size()
    run_fn = _loop_fn("allreduce", world, rank)
    chain = max(16, args.n_iter // 10)
    nbytes = int(2 * (world - 1) / world * shard_bytes)

    def measure(cand):
        x = torch.ones(n, dtype=dtype, device=device)
        block(run_fn(x, 1))  # warm
        win = C.DispatchWindow(int(cand))
        t0 = time.perf_counter()
        for _ in range(chain):
            x = win.call("allreduce", run_fn, x, 1, nbytes=nbytes,
                         axis_name="shard", world=world)
        win.drain()
        block(x)
        return time.perf_counter() - t0

    ensure_tuned("coll/dispatch_depth", measure,
                 dtype=args.dtype, bytes=shard_bytes, world=world)


def _cost(name: str, shard_bytes: int, world: int) -> dict:
    """Analytic flops and bytes of one iteration of ``name``'s chain on
    a shard (each buffer read once, each result written once; the local
    epilogue's read and write of the shard included)."""
    base = name.removesuffix("_rdma").removesuffix("_oneshot")
    n_bytes = {"allgather": (2 + world) * shard_bytes,
               "allreduce": 4 * shard_bytes,
               "reducescatter": 4 * shard_bytes,
               "ppermute": 2 * shard_bytes,
               "alltoall": 4 * shard_bytes}[base]
    return {"bytes_accessed": n_bytes}


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
    from tpu_mpi_tests_torch.instrument import costs
    from tpu_mpi_tests_torch.utils import check_divisible

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
        # "auto" expands to the collectives with hand twins, each size's
        # variant resolved (explicit names never re-resolve)
        names = [m for n in names
                 for m in ([f"{b}:auto" for b in COLL_VARIANT_SPACES]
                           if n == "auto" else [n])]
        if args.tune:
            # the window knob is priced here, where the chained-collective
            # pattern lives, and read wherever chains are posted
            _tune_dispatch_depth(args, world, rank, device)

        dtype = _common.torch_dtype(args)
        itemsize = torch.empty((), dtype=dtype).element_size()
        for spec_name in names:
            base, _, mode = spec_name.partition(":")
            auto = mode == "auto"
            for kib in (int(s) for s in args.sizes_kib.split(",")):
                shard_bytes = kib * 1024
                n = shard_bytes // itemsize
                name = base
                if auto:
                    name = resolve_variant(base, args, world, rank, n,
                                           dtype, device, shard_bytes)
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
                # the row's first call (telemetry runs only)
                costs.compile_probe(run_fn, lambda: (x.clone(), 1),
                                    label=f"coll_{name}",
                                    **_cost(name, shard_bytes, world),
                                    dtype=args.dtype, bytes=shard_bytes,
                                    world=world)
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
                # nothing moves at world 1: 0 GB/s, even where a host
                # stall left the chain's two lengths without a time (NaN)
                busbw = moved / sec / 1e9 if moved else 0.0
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
                     # an auto row records that it was resolved
                     **({"auto": True} if auto else {}),
                     **cred_rec},
                )
                del x
        return 0


def serve_step_factory(device, shape, dtype):
    """Serve-mode handler (≅ JAX ``collbench.py:441-471``): ``step_fn(n)``
    runs ``n`` chained small-payload allreduces (the decode-step
    collective class: the fixed cost of an op dominates, which is what
    tail latency under mixed traffic stresses) through the library tier's
    chain, :func:`_loop_fn`'s ``allreduce`` — the program the ``COLL
    allreduce`` rows time. ``shape`` is elements a rank. A failed batch
    rebuilds the buffer before the error propagates (the JAX handler's
    rule: its chain donates)."""
    from tpu_mpi_tests_torch.comm import dist
    from tpu_mpi_tests_torch.instrument.timers import block

    if len(shape) != 1:
        raise ValueError(f"allreduce wants a 1-d shape, got {shape}")
    (n,) = shape
    w = dist.world()
    dt = _common.TORCH_DTYPES[dtype]
    run_fn = _loop_fn("allreduce", w.size, w.rank)

    def init():
        return torch.ones(n, dtype=dt, device=device)

    state = {"x": init()}

    def step(k: int):
        try:
            state["x"] = block(run_fn(state["x"], k))
        except Exception:
            state["x"] = init()
            raise

    step(1)  # warm before traffic opens
    step.state = state
    return step


_common.register_workload("allreduce", serve_step_factory)


def main(argv=None) -> int:
    p = _common.base_parser(__doc__)
    p.add_argument(
        "--collectives",
        default=",".join(COLLECTIVES),
        help="comma list of collectives to sweep; beyond the default "
        f"library tier, {'/'.join(COLLECTIVES_RDMA)} select the hand ring "
        "kernels (sizes the ring's chunking refuses are reported as "
        f"COLL-SKIP) and {'/'.join(COLLECTIVES_ONESHOT)} the one-shot "
        "kernel; 'auto' runs the collectives with hand twins with each "
        "size's variant resolved from the schedule cache (with --tune, a "
        "miss prices every variant on the device first)",
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
    args = p.parse_args(argv)
    if args.n_iter < 10:
        p.error("--n-iter must be >= 10")
    return _common.run_guarded(run, args)


if __name__ == "__main__":
    sys.exit(main())
