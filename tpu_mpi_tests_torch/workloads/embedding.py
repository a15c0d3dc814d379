"""Embedding gather/scatter pillar: sharded table lookup under load (≅
``tpu_mpi_tests/workloads/embedding.py``), one process per rank.

A ``(vocab, d_model)`` table row-sharded over the ranks, batches of ids
resolved to dense rows through the allreduce-of-partials lookup and
pushed back through the all-gather scatter-add (``comm/embedding.py``).
The local gather (``embedding/lookup``: a row gather ``take`` or a
one-hot matmul) is a tuned schedule: ``--lookup auto`` resolves the
cached winner, ``--tune`` prices both on this table first. Both
directions are verified exactly against the dense host reference
(lookups copy rows; the scatter sums integer-valued rows).

Output lines (the JAX spec's)::

    EMBED lookup: variant=<v> us_per_op=<t>
    EMBED scatter: us_per_op=<t>
    WORKLOAD embedding: lookup_us_per_op=<t> us

The µs/op rows are host wall time over a chain of calls with one wait at
its end (the JAX spec's bracket), so at small batches they are mostly
each call's host path (its launches and, over ranks, one NCCL call).
The serve-mode handler (:meth:`EmbeddingSpec.serve_factory`) resolves
one lookup batch a request against a persistent table.
"""

from __future__ import annotations

import sys

from tpu_mpi_tests_torch.workloads import register_spec
from tpu_mpi_tests_torch.workloads.spec import RunContext, WorkloadSpec


def _build_table(seed: int, vocab: int, d_model: int, batch: int):
    """Integer-valued table, ids and updates on the host (the JAX spec's
    generator, draw for draw): exact in every dtype while a row's sum
    stays within ±256 (table values in [-4, 4], updates in [-3, 3])."""
    import numpy as np

    rng = np.random.default_rng(seed)
    table = rng.integers(-4, 5, size=(vocab, d_model)).astype(np.float64)
    ids = rng.integers(0, vocab, size=(batch,)).astype(np.int32)
    updates = rng.integers(-3, 4, size=(batch, d_model)).astype(np.float64)
    return table, ids, updates


class EmbeddingSpec(WorkloadSpec):
    name = "embedding"
    title = __doc__

    def add_args(self, p) -> None:
        p.add_argument(
            "--vocab", type=int, default=65536,
            help="table rows (split over the ranks; must divide by the "
            "world)",
        )
        p.add_argument(
            "--d-model", type=int, default=64,
            help="row width (default 64)",
        )
        p.add_argument(
            "--batch", type=int, default=256,
            help="ids per lookup/scatter (must divide by the world for "
            "the scatter direction)",
        )
        p.add_argument(
            "--iters", type=int, default=32,
            help="timed lookups and scatters (default 32)",
        )
        p.add_argument(
            "--lookup", default="auto",
            choices=["auto", "take", "onehot"],
            help="local-gather schedule: 'auto' resolves the "
            "embedding/lookup knob (cached winner > prior 'take'; with "
            "--tune a miss prices both on this table first)",
        )
        p.add_argument(
            "--seed", type=int, default=0,
            help="table/id RNG seed (default 0)",
        )

    def check_args(self, p, args) -> None:
        for flag, val in (("--vocab", args.vocab),
                          ("--d-model", args.d_model),
                          ("--batch", args.batch),
                          ("--iters", args.iters)):
            if val < 1:
                p.error(f"{flag} must be positive, got {val}")

    def build(self, ctx: RunContext):
        import torch

        from tpu_mpi_tests_torch.comm.collectives import shard_1d
        from tpu_mpi_tests_torch.utils import check_divisible

        args, world, dev = ctx.args, ctx.world, ctx.device
        check_divisible(args.vocab, world, "embedding rows over mesh axis")
        check_divisible(args.batch, world, "embedding batch over mesh axis")
        dtype = ctx.dtype()
        t_host, ids_host, upd_host = _build_table(
            args.seed, args.vocab, args.d_model, args.batch
        )
        table = shard_1d(t_host, dev).to(dtype)
        # the ids every rank looks up (the same draws on every rank)
        ids_rep = torch.from_numpy(ids_host).to(dev)
        ids_sh = shard_1d(ids_host, dev)
        upd_sh = shard_1d(upd_host, dev).to(dtype)
        variant = None if args.lookup == "auto" else args.lookup
        if variant is None and args.tune:
            variant = self._tune_lookup(ctx, table, ids_rep)
        ctx.rep.banner(
            f"embedding: vocab={args.vocab} d_model={args.d_model} "
            f"batch={args.batch} world={world} dtype={args.dtype} "
            f"lookup={variant or 'auto'}"
        )
        return {
            "table": table, "ids_rep": ids_rep, "ids_sh": ids_sh,
            "upd_sh": upd_sh, "t_host": t_host, "ids_host": ids_host,
            "upd_host": upd_host, "variant": variant,
        }

    def _tune_lookup(self, ctx: RunContext, table, ids_rep):
        """``--tune`` with ``--lookup auto``: price both local gathers on
        this table (a warm call, then a chain of four, the device waited
        for), store the winner and return it."""
        import time

        from tpu_mpi_tests_torch.comm import embedding as E
        from tpu_mpi_tests_torch.instrument.timers import block
        from tpu_mpi_tests_torch.tune.sweep import ensure_tuned

        def measure(cand):
            block(E.embedding_lookup(table, ids_rep, variant=cand))
            t0 = time.perf_counter()
            for _ in range(4):
                out = E.embedding_lookup(table, ids_rep, variant=cand)
            block(out)
            return time.perf_counter() - t0

        return ensure_tuned(
            "embedding/lookup", measure, device_fallback=False,
            dtype=ctx.args.dtype, n=ctx.args.vocab,
            bytes=ctx.args.batch, world=ctx.world,
        )

    def step(self, ctx: RunContext, state):
        import time

        from tpu_mpi_tests_torch.comm import embedding as E
        from tpu_mpi_tests_torch.instrument.timers import block

        args = ctx.args
        table, ids_rep = state["table"], state["ids_rep"]
        variant = E.resolve_lookup(
            state["variant"], dtype=args.dtype, n=args.vocab,
            bytes=args.batch, world=ctx.world,
        )
        state["variant"] = variant
        # lookup: a warm call, then the timed chain
        out = E.embedding_lookup(table, ids_rep, variant=variant)
        block(out)
        with ctx.phase("lookup"):
            t0 = time.perf_counter()
            for _ in range(args.iters):
                out = E.embedding_lookup(table, ids_rep, variant=variant)
            block(out)
            lookup_s = time.perf_counter() - t0
        state["lookup_out"] = out
        state["lookup_us"] = lookup_s / args.iters * 1e6
        if ctx.topo.process_index == 0:
            ctx.rep.line(
                f"EMBED lookup: variant={variant} "
                f"us_per_op={state['lookup_us']:0.3f}",
                {"kind": "embed", "dir": "lookup", "variant": variant,
                 "us_per_op": state["lookup_us"], "vocab": args.vocab,
                 "d_model": args.d_model, "batch": args.batch,
                 "world": ctx.world, "dtype": args.dtype},
            )
        # scatter-add updates the table in place: the warm call adds into
        # a copy, so the timed chain starts from the reference state
        block(E.embedding_scatter_add(table.clone(), state["ids_sh"],
                                      state["upd_sh"]))
        tab = table
        with ctx.phase("scatter"):
            t0 = time.perf_counter()
            for _ in range(args.iters):
                tab = E.embedding_scatter_add(tab, state["ids_sh"],
                                              state["upd_sh"])
            block(tab)
            scatter_s = time.perf_counter() - t0
        state["table_out"] = tab
        state["scatter_us"] = scatter_s / args.iters * 1e6
        if ctx.topo.process_index == 0:
            ctx.rep.line(
                f"EMBED scatter: us_per_op={state['scatter_us']:0.3f}",
                {"kind": "embed", "dir": "scatter",
                 "us_per_op": state["scatter_us"], "vocab": args.vocab,
                 "d_model": args.d_model, "batch": args.batch,
                 "world": ctx.world, "dtype": args.dtype},
            )
        return state

    def verify(self, ctx: RunContext, state) -> int:
        import numpy as np
        import torch

        from tpu_mpi_tests_torch.comm.collectives import all_gather, \
            host_value

        t_host, ids, upd = (state["t_host"], state["ids_host"],
                            state["upd_host"])
        got = np.asarray(host_value(state["lookup_out"]), np.float64)
        want = t_host[ids]
        if not np.array_equal(got, want):
            bad = np.flatnonzero((got != want).any(axis=1))
            ctx.rep.line(
                f"EMBED FAIL lookup: {bad.size}/{len(ids)} rows "
                f"mismatch the dense reference, first at [{int(bad[0])}]"
            )
            return 1
        # iters scatter-adds of the same (ids, updates) accumulate
        # linearly, duplicates included (np.add.at semantics); each rank
        # holds its own rows against the reference's, and the mismatch
        # counts and first rows travel (every rank prints the same line)
        ref = t_host.copy()
        np.add.at(ref, ids, upd * ctx.args.iters)
        shard = host_value(state["table_out"])
        v_local = shard.shape[0]
        r = ctx.topo.process_index
        bad = np.flatnonzero(
            (shard != ref[r * v_local:(r + 1) * v_local]).any(axis=1))
        mine = torch.tensor([[bad.size, r * v_local + int(bad[0])
                              if bad.size else -1]], dtype=torch.int64)
        per_rank = host_value(all_gather(mine))
        n_bad = int(per_rank[:, 0].sum())
        if n_bad:
            first = int(per_rank[per_rank[:, 0] > 0][0, 1])
            ctx.rep.line(
                f"EMBED FAIL scatter: {n_bad}/{ref.shape[0]} table "
                f"rows mismatch the dense reference, first at [{first}]"
            )
            return 1
        return 0

    def bytes_model(self, ctx: RunContext, state) -> int:
        item = state["table"].element_size()
        row = ctx.args.batch * ctx.args.d_model * item
        return 2 * (ctx.world - 1) * row  # the lookup allreduce's model

    def bench(self, ctx: RunContext, state) -> dict:
        return {
            "metric": "lookup_us_per_op",
            "value": state["lookup_us"],
            "unit": "us",
            "higher_better": False,
            "variant": state["variant"],
            "scatter_us_per_op": state["scatter_us"],
            "vocab": ctx.args.vocab,
            "batch": ctx.args.batch,
            "nbytes": self.bytes_model(ctx, state),
        }

    def serve_factory(self, device, shape, dtype):
        """Serve-mode handler (≅ JAX ``embedding.py:274``): ``step_fn(n)``
        resolves ``n`` lookup batches (``comm/embedding.embedding_lookup``)
        against a persistent row-sharded table (shape = ``(vocab, batch,
        d_model)``; seed 0). Lookups keep their inputs, so a failed batch
        needs no rebuild; the local gather's variant resolves through the
        schedule cache like any knob. The last output is kept
        (``step.state["out"]``)."""
        import torch

        from tpu_mpi_tests_torch.comm import dist
        from tpu_mpi_tests_torch.comm import embedding as E
        from tpu_mpi_tests_torch.comm.collectives import shard_1d
        from tpu_mpi_tests_torch.drivers import _common
        from tpu_mpi_tests_torch.instrument.timers import block
        from tpu_mpi_tests_torch.utils import check_divisible

        if len(shape) != 3:
            raise ValueError(
                f"embedding wants (vocab, batch, d_model), got {shape}"
            )
        vocab, batch, d_model = shape
        world = dist.world().size
        check_divisible(vocab, world, "embedding rows over mesh axis")
        t_host, ids_host, _ = _build_table(0, vocab, d_model, batch)
        table = shard_1d(_common.host_tensor(t_host,
                                             _common.TORCH_DTYPES[dtype]),
                         device)
        del t_host
        ids = torch.from_numpy(ids_host).to(device)
        state = {"out": None}

        def step(k: int):
            out = None
            for _ in range(k):
                out = E.embedding_lookup(table, ids)
            state["out"] = block(out)

        step(1)  # warm before traffic opens
        step.state = state
        return step


SPEC = register_spec(EmbeddingSpec())


def main(argv=None) -> int:
    from tpu_mpi_tests_torch.workloads.runner import make_main

    return make_main(SPEC)(argv)


if __name__ == "__main__":
    sys.exit(main())
