"""MoE token-routing pillar: capacity-bucketed all-to-all under load (≅
``tpu_mpi_tests/workloads/moe.py``), one process per rank.

Tokens split over the ranks, each naming a destination expert (one per
rank), dispatched and combined through two all-to-all hops with a fixed
per-pair ``capacity`` and the standard MoE overflow-drop rule
(``comm/moe.py``). The measurement is the routing distribution as much as
the time: every routed step's occupancy, overflow % and per-expert
imbalance go out as ``kind: "route"`` records next to the
``us_per_step`` bench row. Verification is exact against the dense host
reference (``route_reference``): integer-valued tokens, analytic
``(e+1)·x`` experts.

Output lines (the JAX spec's)::

    ROUTE moe: world=<w> capacity=<c> tokens=<t> routed=<n> \
dropped=<d> overflow=<f>% occupancy=<o>% imbalance=<i>
    WORKLOAD moe: us_per_step=<v> us

``us_per_step`` is host wall time a routed step, the device waited for
each step (the JAX spec's bracket); it includes the step's host path
(the capacity bucketing's launches, two NCCL calls, the demand matrix's
read back). At world 1 there is one expert and both hops are the
identity. The serve-mode handler (:meth:`MoESpec.serve_factory`) routes
a persistent token set once a request.
"""

from __future__ import annotations

import sys

from tpu_mpi_tests_torch.workloads import register_spec
from tpu_mpi_tests_torch.workloads.spec import RunContext, WorkloadSpec


def _capacity(tokens: int, world: int, factor: float) -> int:
    """Per-(source, expert) slot count: the uniform expectation
    ``tokens/world²`` scaled by the provisioning factor, floored at 1."""
    expect = tokens / (world * world)
    return max(1, int(expect * factor + 0.999999))


def _build_tokens(seed: int, tokens: int, d_model: int, skew: float,
                  world: int):
    """Integer-valued tokens and skewed destinations on the host (the
    JAX spec's generator, draw for draw): expert weights ∝
    (e+1)^−skew, so imbalance (and, at factor ≈ 1, overflow) is real.
    Values stay in [1, 7], and ``(e+1)·x`` within ``7·world``: exact in
    bfloat16 up to world 36."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x = rng.integers(1, 8, size=(tokens, d_model))
    w_e = (np.arange(1, world + 1, dtype=np.float64)) ** (-skew)
    dest = rng.choice(world, size=tokens, p=w_e / w_e.sum())
    return x.astype(np.float64), dest.astype(np.int32)


class MoESpec(WorkloadSpec):
    name = "moe"
    title = __doc__

    def add_args(self, p) -> None:
        p.add_argument(
            "--tokens", type=int, default=4096,
            help="global token count (split over the ranks; must divide "
            "by the world)",
        )
        p.add_argument(
            "--d-model", type=int, default=64,
            help="token width (default 64)",
        )
        p.add_argument(
            "--capacity-factor", type=float, default=1.25,
            help="per-(source, expert) slots as a multiple of the "
            "uniform expectation tokens/world^2 (default 1.25; <= 1 "
            "guarantees overflow under any skew)",
        )
        p.add_argument(
            "--route-skew", type=float, default=0.5,
            help="destination skew: expert e drawn with weight "
            "(e+1)^-skew (0 = uniform; default 0.5)",
        )
        p.add_argument(
            "--iters", type=int, default=32,
            help="timed routed steps (default 32)",
        )
        p.add_argument(
            "--combine", default="auto",
            choices=["auto", "alltoall", "allgather"],
            help="combine-hop schedule: 'auto' resolves the moe/combine "
            "knob (cached winner > prior; with --tune a miss prices "
            "both on this shape first)",
        )
        p.add_argument(
            "--seed", type=int, default=0,
            help="token/destination RNG seed (deterministic routing and "
            "drop accounting across runs)",
        )

    def check_args(self, p, args) -> None:
        for flag, val in (("--tokens", args.tokens),
                          ("--d-model", args.d_model),
                          ("--iters", args.iters)):
            if val < 1:
                p.error(f"{flag} must be positive, got {val}")
        if args.capacity_factor <= 0:
            p.error("--capacity-factor must be positive")
        if args.route_skew < 0:
            p.error("--route-skew must be >= 0")

    def build(self, ctx: RunContext):
        from tpu_mpi_tests_torch.comm.collectives import shard_1d
        from tpu_mpi_tests_torch.comm.moe import resolve_combine
        from tpu_mpi_tests_torch.utils import check_divisible

        args, world = ctx.args, ctx.world
        check_divisible(args.tokens, world, "moe tokens over mesh axis")
        dtype = ctx.dtype()
        capacity = _capacity(args.tokens, world, args.capacity_factor)
        x_host, dest_host = _build_tokens(
            args.seed, args.tokens, args.d_model, args.route_skew, world
        )
        xs = shard_1d(x_host, ctx.device).to(dtype)
        ds = shard_1d(dest_host, ctx.device)
        combine = None if args.combine == "auto" else args.combine
        if combine is None and args.tune:
            combine = self._tune_combine(ctx, xs, ds, capacity)
        if combine is None:
            # the cached winner (route_tokens' fingerprint), so the
            # banner, the bytes model and the bench row name the variant
            # that runs
            combine = resolve_combine(dtype=args.dtype, n=args.tokens,
                                      world=world)
        ctx.rep.banner(
            f"moe: tokens={args.tokens} d_model={args.d_model} "
            f"world={world} capacity={capacity} "
            f"(factor={args.capacity_factor:g}) skew={args.route_skew:g} "
            f"dtype={args.dtype} combine={combine}"
        )
        return {
            "x": xs, "dest": ds, "x_host": x_host,
            "dest_host": dest_host, "capacity": capacity,
            "combine": combine,
        }

    def _tune_combine(self, ctx: RunContext, xs, ds, capacity):
        """``--tune`` with ``--combine auto``: price both combine hops on
        this shape (a warm step, then four, the device waited for), store
        the winner and return it (a warmed cache is a hit)."""
        import time

        from tpu_mpi_tests_torch.comm import moe as M
        from tpu_mpi_tests_torch.instrument.timers import block
        from tpu_mpi_tests_torch.tune.sweep import ensure_tuned

        def measure(cand):
            y, _ = M.route_tokens(xs, ds, capacity, combine=cand)
            block(y)
            t0 = time.perf_counter()
            for _ in range(4):
                y, _ = M.route_tokens(xs, ds, capacity, combine=cand)
            block(y)
            return time.perf_counter() - t0

        return ensure_tuned(
            "moe/combine", measure, device_fallback=False,
            dtype=ctx.args.dtype, n=ctx.args.tokens, world=ctx.world,
        )

    def step(self, ctx: RunContext, state):
        import time

        from tpu_mpi_tests_torch.comm import moe as M
        from tpu_mpi_tests_torch.instrument.timers import block

        args = ctx.args
        xs, ds = state["x"], state["dest"]
        capacity, combine = state["capacity"], state["combine"]
        # an untimed warm step
        y, stats = M.route_tokens(xs, ds, capacity, combine=combine)
        block(y)
        with ctx.phase("route"):
            t0 = time.perf_counter()
            for _ in range(args.iters):
                y, stats = M.route_tokens(xs, ds, capacity,
                                          combine=combine)
                block(y)
            seconds = time.perf_counter() - t0
        state["y"], state["stats"] = y, stats
        state["us_per_step"] = seconds / args.iters * 1e6
        if ctx.topo.process_index == 0:
            ctx.rep.line(
                f"ROUTE moe: world={stats.world} "
                f"capacity={stats.capacity} tokens={stats.tokens} "
                f"routed={stats.routed} dropped={stats.dropped} "
                f"overflow={stats.overflow_pct:.2f}% "
                f"occupancy={stats.occupancy_pct:.1f}% "
                f"imbalance={stats.imbalance:.3f}",
                stats.record(op="moe", dtype=args.dtype),
            )
        return state

    def verify(self, ctx: RunContext, state) -> int:
        import numpy as np

        from tpu_mpi_tests_torch.comm.collectives import all_gather, \
            host_value
        from tpu_mpi_tests_torch.comm.moe import route_reference

        got = host_value(all_gather(state["y"]))
        ref = route_reference(
            state["x_host"], state["dest_host"], ctx.world,
            state["capacity"],
        ).astype(got.dtype)
        if not np.array_equal(got, ref):
            bad = np.flatnonzero((got != ref).any(axis=1))
            i = int(bad[0])
            ctx.rep.line(
                f"ROUTE FAIL: {bad.size}/{got.shape[0]} token rows "
                f"mismatch the dense reference, first at [{i}]: got "
                f"{got[i][:4]}, expected {ref[i][:4]}"
            )
            return 1
        # the drop accounting must agree with the reference's drop rule
        ref_dropped = int((ref.sum(axis=1) == 0).sum()
                          - (state["x_host"].sum(axis=1) == 0).sum())
        if state["stats"].dropped != ref_dropped:
            ctx.rep.line(
                f"ROUTE FAIL: recorded dropped={state['stats'].dropped} "
                f"!= reference {ref_dropped}"
            )
            return 1
        return 0

    def bytes_model(self, ctx: RunContext, state) -> int:
        from tpu_mpi_tests_torch.comm.moe import route_payload_bytes

        return route_payload_bytes(
            state["x"], ctx.world, state["capacity"], state["combine"],
        )

    def bench(self, ctx: RunContext, state) -> dict:
        stats = state["stats"]
        return {
            "metric": "us_per_step",
            "value": state["us_per_step"],
            "unit": "us",
            "higher_better": False,
            "tokens": ctx.args.tokens,
            "capacity": stats.capacity,
            "overflow_pct": stats.overflow_pct,
            "occupancy_pct": stats.occupancy_pct,
            "imbalance": stats.imbalance,
            "nbytes": self.bytes_model(ctx, state),
        }

    def serve_factory(self, device, shape, dtype):
        """Serve-mode handler (≅ JAX ``moe.py:265``): ``step_fn(n)`` runs
        ``n`` routed steps (``comm/moe.route_tokens``) on a persistent
        token set (shape = ``(tokens, d_model)``; experts = ranks;
        capacity factor 1.25, seed 0 — deterministic drop accounting per
        class). Routing keeps its inputs, so a failed batch needs no
        rebuild; with ``--telemetry`` every request lands its route
        record on the JSONL stream. The last output is kept
        (``step.state["y"]``)."""
        from tpu_mpi_tests_torch.comm import dist
        from tpu_mpi_tests_torch.comm import moe as M
        from tpu_mpi_tests_torch.comm.collectives import shard_1d
        from tpu_mpi_tests_torch.drivers import _common
        from tpu_mpi_tests_torch.instrument.timers import block
        from tpu_mpi_tests_torch.utils import check_divisible

        if len(shape) != 2:
            raise ValueError(f"moe wants (tokens, d_model), got {shape}")
        tokens, d_model = shape
        world = dist.world().size
        check_divisible(tokens, world, "moe tokens over mesh axis")
        capacity = _capacity(tokens, world, 1.25)
        x_host, dest_host = _build_tokens(0, tokens, d_model, 0.5, world)
        xs = shard_1d(_common.host_tensor(x_host,
                                          _common.TORCH_DTYPES[dtype]),
                      device)
        ds = shard_1d(dest_host, device)
        state = {"y": None}

        def step(k: int):
            y = None
            for _ in range(k):
                y, _ = M.route_tokens(xs, ds, capacity)
            state["y"] = block(y)

        step(1)  # warm before traffic opens
        step.state = state
        return step


SPEC = register_spec(MoESpec())


def main(argv=None) -> int:
    from tpu_mpi_tests_torch.workloads.runner import make_main

    return make_main(SPEC)(argv)


if __name__ == "__main__":
    sys.exit(main())
