"""Decode-step collectives: tiny latency-bound allreduce/allgather (≅
``tpu_mpi_tests/workloads/decode.py``), one process per rank.

Autoregressive decode runs one collective a layer a *token*, at
batch×head payloads of a few KB, where the fixed cost of an op dominates
and GB/s is the wrong axis. This spec sweeps the decode collectives over
batch sizes at a fixed head count and reports **µs/op rows**, each a
``kind: "decode"`` record.

Each row runs the collective ``collbench`` times (its ``_loop_fn``
chain) through the variant the ``coll_variant/{allgather,allreduce}``
schedule resolves at that payload: cached > prior (``torch``, the
library call), and with ``--tune`` a miss prices ``torch``, ``rdma``
(the hand ring kernels, ``csrc/ring_collectives.cu``) and ``oneshot``
(``csrc/oneshot.cu``) on the device first — the same space, fingerprint
and cache entries as ``collbench --collectives auto``. A variant that
cannot run at a payload (the ring reduce-scatter's chunking,
``comm/collectives.allreduce_rdma_refusal``; a world the peer kernels
cannot map) runs the library tier instead, with a ``NOTE``.

The rows are timed by ``instrument/timers.chain_rate``: CUDA events
around a Python loop of launches, two chain lengths differenced. The JAX
µs/op is a device-side ``fori_loop``; the port's includes every call's
host path (the wrapper, the launches, over ranks the NCCL call), which
at these payloads is most of the row (ROADMAP queue 3 fault 1).

Output per (collective, batch), the JAX lines (``[variant]`` is the
resolved tier: ``torch``, ``rdma`` or ``oneshot``)::

    DECODE <coll>[<variant>] batch=<b> heads=<h> bytes=<per-shard> <us> us/op  n=<iters>
    WORKLOAD decode: allreduce_us_per_op=<v> us

Verification: the library collectives checked exactly against host
references (the sum for allreduce, the concatenation for allgather) on
integer-valued rows, as in the JAX spec. The serve-mode handler
(:meth:`DecodeSpec.serve_factory`) chains the allreduce of the variant
``coll_variant/allreduce`` resolves, and carries the ``tune_info`` recipe
the re-tune controller (``tune/controller.py``) rebuilds it with.
"""

from __future__ import annotations

import sys

from tpu_mpi_tests_torch.workloads import register_spec
from tpu_mpi_tests_torch.workloads.spec import RunContext, WorkloadSpec

#: the decode sweep's collectives: the tensor-parallel pair a decode
#: step issues (row-parallel matmul → allreduce; KV/head assembly →
#: allgather)
DECODE_COLLS = ("allreduce", "allgather")

# the JAX spec's parse pattern, character for character (a test holds
# the two strings equal)
DECODE_LINE_RE = (
    r"DECODE (\w+)\[(\w+)\] batch=(\d+) heads=(\d+) bytes=(\d+) "
    r"([\d.e+-]+|nan) us/op  n=(\d+)"
)


def _effective_coll(coll: str, variant, n: int, shard_bytes: int,
                    world: int, line, explicit: bool = False):
    """``(collective to run, variant)`` at one payload (≅ JAX
    ``_effective_coll``) for a resolved ``coll_variant/<coll>`` value:
    the spec's rows pass :func:`collbench.tuned_variant`'s (cached >
    prior, and with ``--tune`` a miss swept on the device), the serve
    handler the registry's resolution (explicit > cached > prior). A
    malformed value gives the prior. A variant that cannot run at this
    payload or world (``collbench.variant_refusal``) runs the library
    tier, with a NOTE through ``line``; asked for explicitly (a
    re-sweep's candidate), it raises instead, so that the sweep records
    it as declined and never times the other tier in its name."""
    from tpu_mpi_tests_torch.drivers import collbench as CB
    from tpu_mpi_tests_torch.tune import priors as _priors
    from tpu_mpi_tests_torch.utils import TpuMtError

    if variant not in CB.COLL_VARIANTS:
        variant = _priors.COLL_VARIANT  # a malformed cached value
    why = CB.variant_refusal(CB.effective_name(coll, variant), n, world)
    if why is not None:
        if explicit:
            raise TpuMtError(f"decode {coll}: {variant} variant cannot "
                             f"run at {shard_bytes} B ({why})")
        line(f"NOTE decode {coll}: cached {variant} variant "
             f"infeasible at {shard_bytes} B ({why}); using "
             f"{_priors.COLL_VARIANT}")
        return coll, _priors.COLL_VARIANT
    return CB.effective_name(coll, variant), variant


class DecodeSpec(WorkloadSpec):
    name = "decode"
    title = __doc__

    def add_args(self, p) -> None:
        p.add_argument(
            "--batches", default="1,8,32",
            help="comma list of decode batch sizes to sweep (default "
            "1,8,32 — the single-stream / small-batch / saturated "
            "decode regimes)",
        )
        p.add_argument(
            "--heads", type=int, default=16,
            help="attention heads per token step (payload elements per "
            "shard = batch x heads; default 16)",
        )
        p.add_argument(
            "--colls", default=",".join(DECODE_COLLS),
            help=f"comma list of collectives ({'/'.join(DECODE_COLLS)})",
        )
        p.add_argument(
            "--n-iter", type=int, default=2000,
            help="chained iterations per measurement (default 2000; "
            "tiny ops need a long chain to clear timer noise)",
        )

    def check_args(self, p, args) -> None:
        if args.heads < 1:
            p.error(f"--heads must be positive, got {args.heads}")
        if args.n_iter < 10:
            p.error("--n-iter must be >= 10")
        try:
            batches = [int(b) for b in args.batches.split(",") if b]
        except ValueError:
            p.error(f"--batches must be a comma list of ints, got "
                    f"{args.batches!r}")
        if not batches or any(b < 1 for b in batches):
            p.error(f"--batches entries must be positive, got "
                    f"{args.batches!r}")

    def build(self, ctx: RunContext):
        from tpu_mpi_tests_torch.drivers import _common
        from tpu_mpi_tests_torch.workloads.spec import SpecError

        names = _common.parse_choice_list(
            ctx.args.colls, DECODE_COLLS, "decode collective"
        )
        if names is None:
            raise SpecError(2)  # parse_choice_list printed the ERROR
        batches = [int(b) for b in ctx.args.batches.split(",") if b]
        ctx.rep.banner(
            f"decode: world={ctx.world} batches={ctx.args.batches} "
            f"heads={ctx.args.heads} colls={','.join(names)} "
            f"n_iter={ctx.args.n_iter} dtype={ctx.args.dtype}"
        )
        return {"colls": names, "batches": batches, "rows": []}

    def step(self, ctx: RunContext, state):
        import torch

        from tpu_mpi_tests_torch.drivers import collbench as CB
        from tpu_mpi_tests_torch.instrument import costs
        from tpu_mpi_tests_torch.instrument.timers import chain_rate

        args, world = ctx.args, ctx.world
        rank = ctx.topo.process_index
        dtype = ctx.dtype()
        itemsize = torch.empty((), dtype=dtype).element_size()
        with ctx.phase("decode_sweep"):
            for coll in state["colls"]:
                for batch in state["batches"]:
                    n = batch * args.heads  # elements a shard
                    shard_bytes = n * itemsize
                    variant, _why = CB.tuned_variant(
                        coll, args, world, rank, n, dtype, ctx.device,
                        shard_bytes)
                    eff, variant = _effective_coll(
                        coll, variant, n, shard_bytes, world, ctx.rep.line)
                    run_fn = CB._loop_fn(eff, world, rank)
                    x = torch.ones(n, dtype=dtype, device=ctx.device)
                    costs.compile_probe(
                        run_fn, lambda: (x.clone(), 1),
                        label=f"decode_{coll}",
                        **CB._cost(eff, shard_bytes, world),
                        dtype=args.dtype, bytes=shard_bytes, world=world,
                    )
                    sec, x = chain_rate(
                        run_fn, x,
                        n_short=args.n_iter // 10 or 1,
                        n_long=args.n_iter,
                    )
                    us = sec * 1e6
                    row = {
                        "kind": "decode", "collective": coll,
                        "batch": batch, "heads": args.heads,
                        "shard_bytes": shard_bytes, "us_per_op": us,
                        "world": world, "dtype": args.dtype,
                        "n_iter": args.n_iter, "variant": variant,
                    }
                    state["rows"].append(row)
                    ctx.rep.line(
                        f"DECODE {coll}[{variant}] batch={batch} "
                        f"heads={args.heads} bytes={shard_bytes} "
                        f"{us:0.3f} us/op  n={args.n_iter}",
                        row,
                    )
                    del x
        return state

    def verify(self, ctx: RunContext, state) -> int:
        """Exact host-reference check of the library collectives:
        per-rank rows of small integers — allreduce must return the
        elementwise sum on every rank, allgather the concatenation."""
        import numpy as np
        import torch

        from tpu_mpi_tests_torch.comm import collectives as C

        world, rank = ctx.world, ctx.topo.process_index
        dtype = ctx.dtype()
        L = max(int(ctx.args.heads), 4)
        rows = np.arange(world * L, dtype=np.float64).reshape(world, L) % 7
        mine = torch.from_numpy(rows[rank:rank + 1]).to(ctx.device, dtype)
        got_ar = np.asarray(
            C.host_value(C.all_gather(C.allreduce_sum(mine.clone()))),
            np.float64)
        want = np.broadcast_to(rows.sum(axis=0), (world, L))
        if not np.array_equal(got_ar, want):
            ctx.rep.line("DECODE FAIL: allreduce mismatch vs host sum")
            return 1
        got_ag = np.asarray(C.host_value(C.all_gather(mine[0].clone())),
                            np.float64)
        if not np.array_equal(got_ag, rows.reshape(-1)):
            ctx.rep.line("DECODE FAIL: allgather mismatch vs host "
                         "concatenation")
            return 1
        return 0

    def bytes_model(self, ctx: RunContext, state) -> int:
        # the smallest row's payload (the headline latency row's bytes)
        import torch

        item = torch.empty((), dtype=ctx.dtype()).element_size()
        return min(state["batches"]) * ctx.args.heads * item

    def bench(self, ctx: RunContext, state) -> "dict | None":
        """Headline row: the smallest-batch allreduce latency, the
        single-stream decode step's cost (every row has its own ``kind:
        "decode"`` record)."""
        ar = [r for r in state["rows"] if r["collective"] == "allreduce"]
        rows = ar or state["rows"]
        if not rows:
            return None
        head = min(rows, key=lambda r: r["batch"])
        return {
            "metric": f"{head['collective']}_us_per_op",
            "value": head["us_per_op"],
            "unit": "us",
            "higher_better": False,
            "batch": head["batch"],
            "heads": head["heads"],
            "nbytes": self.bytes_model(ctx, state),
        }

    def serve_factory(self, device, shape, dtype):
        """Serve-mode handler (≅ JAX ``decode.py:272-337``):
        ``step_fn(n)`` runs ``n`` chained decode-step allreduces at the
        class's (batch, heads) shape — ``collbench._loop_fn`` of the
        variant ``coll_variant/allreduce`` resolves for this payload
        (explicit > cached > prior ``torch``; ``rdma`` is the ring
        reduce-scatter + all-gather kernels, ``oneshot`` the one-shot
        kernel, one launch a request at world 1). A failed batch rebuilds
        the buffer before the error propagates.

        The handler carries ``step.tune_info`` — the knob, its context,
        the candidates, the variant it serves and ``rebuild(value)`` — so
        the re-tune controller (``--retune``, ``tune/controller.py``) can
        re-sweep and hot-swap it; ``rebuild(None)`` re-resolves the knob.
        Over ranks a rebuilt handler's hand kernels reuse the ring's
        peer-memory workspaces (``PeerRing.workspace``, kept for the
        ring's life), so a swap allocates no peer memory."""
        import torch

        from tpu_mpi_tests_torch.comm import dist
        from tpu_mpi_tests_torch.drivers import _common
        from tpu_mpi_tests_torch.drivers import collbench as CB
        from tpu_mpi_tests_torch.instrument.timers import block
        from tpu_mpi_tests_torch.tune import priors as _priors
        from tpu_mpi_tests_torch.tune import registry as tr

        if len(shape) != 2:
            raise ValueError(f"decode wants (batch, heads), got {shape}")
        batch, heads = shape
        n = batch * heads
        w = dist.world()
        dt = _common.TORCH_DTYPES[dtype]
        shard_bytes = n * torch.empty((), dtype=dt).element_size()
        ctx = {"dtype": str(dtype), "bytes": shard_bytes, "world": w.size}

        def init():
            return torch.ones(n, dtype=dt, device=device)

        def build(variant=None):
            resolved = tr.resolve(
                "coll_variant/allreduce", explicit=variant,
                prior=_priors.COLL_VARIANT, device_fallback=False, **ctx)
            eff, v = _effective_coll("allreduce", resolved, n, shard_bytes,
                                     w.size, print,
                                     explicit=variant is not None)
            run_fn = CB._loop_fn(eff, w.size, w.rank)
            state = {"x": init()}

            def step(k: int):
                try:
                    state["x"] = block(run_fn(state["x"], k))
                except Exception:
                    state["x"] = init()
                    raise

            step(1)  # warm before traffic opens
            step.state = state
            step.tune_info = {
                "knob": "coll_variant/allreduce",
                "ctx": dict(ctx),
                "candidates": CB.COLL_VARIANTS,
                # the tier this handler serves (the DECODE [variant]
                # stamp's serve twin)
                "variant": v,
                "rebuild": build,
            }
            return step

        return build()


SPEC = register_spec(DecodeSpec())


def main(argv=None) -> int:
    from tpu_mpi_tests_torch.workloads.runner import make_main

    return make_main(SPEC)(argv)


if __name__ == "__main__":
    sys.exit(main())
