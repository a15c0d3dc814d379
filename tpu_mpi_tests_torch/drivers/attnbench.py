"""Attention-tier benchmark driver (≅ ``tpu_mpi_tests/drivers/attnbench.py``):
flash vs torch-op local attention, plus the sequence-parallel flavours over
the world's ranks, at CLI-selectable shapes.

    ATTN <tier> L=<L> d=<D> <dtype> <tflops> TFLOP/s

Tiers: ``xla`` (torch ops materialising the scores: the JAX XLA tier),
``flash`` (the hand CUDA kernel, ``kernels.hand.flash_attention``),
``ring`` / ``ulysses`` (``comm.ring`` / ``comm.alltoall`` with the hand
kernel as local compute, the sequence split over the ranks: each rank
takes its block of the global q, k, v made from one seed, so every world
solves the same problem). ``--ring-depth`` paces the ring's K/V hops and
``--ring-tier fused`` runs every ring step in one launch of
``kernels.hand.fused_ring_attention`` — at a geometry its gate refuses
(``hand.fused_ring_feasible``) a ``NOTE`` says so and the pipelined tier
runs; the line carries ``[fused]`` only when the fused kernel ran, and
the row the depth and tier that ran. Iterations chain with the output fed
back as the next query (``instrument.timers.chain_rate``: CUDA events on
the card, two run lengths differenced). FLOPs are 4·L²·d per attention
(2·L²·d when causal), counted globally, times ``world`` heads for
Ulysses. HIGHEST (the default) turns TF32 off; ``--fast`` runs DEFAULT
(TF32 / bf16 tensor cores). The TPU tile knobs ``--k-tile`` and
``--skip-tile`` reach the kernel's plain version; the card runs the
tile of the route that ran (``hand.FLASH_K_TILES``), which each row
records.

``--tune`` prices the ring's schedule knobs on a cache miss, each
candidate running the tier's real loop at a tenth of the chain (≅ JAX
``attnbench.py:183-290``): ``ring/pipeline_depth`` (a depth above the
world is declined with its reason, since the ring clamps it; at world 1
only the prior is left and nothing is swept) and ``ring/tier`` (the
sweep declines with a NOTE where ``hand.fused_ring_feasible`` refuses
the geometry). The JAX package's ``flash_tiles`` knob has no space in
the port (``comm/ring.py`` says why). Without ``--tune`` cached winners
still apply; a row names the depth and tier that ran. Under
``--telemetry`` each tier's first call is probed
(``instrument/costs.py``, ``attn_<tier>``). The ``attn`` serve workload
is ROADMAP queue 1 #19.
"""

from __future__ import annotations

import sys

from tpu_mpi_tests_torch.drivers import _common

TIERS = ("xla", "flash", "ring", "ulysses")


def run(args) -> int:
    import torch

    from tpu_mpi_tests_torch.comm.alltoall import ulysses_attention_fn
    from tpu_mpi_tests_torch.comm.collectives import shard_1d
    from tpu_mpi_tests_torch.comm.mesh import bootstrap, check_world, topology
    from tpu_mpi_tests_torch.comm.ring import ring_attention_fn, to_striped
    from tpu_mpi_tests_torch.instrument import costs
    from tpu_mpi_tests_torch.instrument.timers import chain_rate
    from tpu_mpi_tests_torch.kernels import hand
    from tpu_mpi_tests_torch.utils import TpuMtError, check_divisible

    dtype = _common.torch_dtype(args)
    if dtype == torch.float64:
        raise TpuMtError("attnbench runs float32 or bfloat16 (the flash "
                         "kernel has no float64 route, as in the JAX "
                         "package)")
    device = bootstrap(args.device)
    topo = topology(device)
    world = check_world(topo.global_device_count)
    precision = "default" if args.fast else "highest"

    rep = _common.make_reporter(args, rank=topo.process_index, size=world)
    with rep, hand.matmul_precision(precision):
        rep.banner(
            f"attnbench: L={args.seq_len} d={args.head_dim} tiers={args.tiers} "
            f"dtype={args.dtype} causal={args.causal} stripe={args.stripe} "
            f"k_tile={args.k_tile} skip_tile={args.skip_tile} "
            f"ring_tier={args.ring_tier} n_iter={args.n_iter} world={world}"
        )
        L, d = args.seq_len, args.head_dim
        # causal computes only the lower triangle — half the matmul work
        flops = (2.0 if args.causal else 4.0) * L * L * d
        tiers = _common.parse_choice_list(args.tiers, TIERS, "tier")
        if tiers is None:
            return 2
        tril = None

        def xla_attn(q, k, v):
            s = torch.matmul(q, k.T) / (d**0.5)
            if args.causal:
                s = torch.where(tril, s, float("-inf"))
            return torch.matmul(torch.softmax(s, dim=-1), v)

        rc = 0
        for tier in tiers:
            striped = tier == "ring" and args.stripe

            def make_qkv(tier=tier):
                # the global problem from one seed; each rank its block
                gen = torch.Generator(device=device).manual_seed(0)
                shape = (L, world, d) if tier == "ulysses" else (L, d)
                if tier in ("ring", "ulysses"):
                    check_divisible(L, world, "sequence over mesh axis")
                q, k, v = (torch.randn(shape, generator=gen, device=device,
                                       dtype=torch.float32).to(dtype)
                           for _ in range(3))
                if tier == "ring" and args.stripe:
                    # the striped causal layout; the chained output stays
                    # in it, position-consistent with the next query
                    q, k, v = (to_striped(t, world) for t in (q, k, v))
                if tier in ("ring", "ulysses"):
                    q, k, v = (shard_1d(t, device) for t in (q, k, v))
                return q, k, v

            def make_attn(tier=tier, depth=None, rtier=None):
                if tier == "ring":
                    return ring_attention_fn(
                        world, causal=args.causal, flash=True,
                        precision=precision, stripe=args.stripe,
                        k_tile=args.k_tile, skip_tile=args.skip_tile,
                        depth=args.ring_depth if depth is None else depth,
                        tier=args.ring_tier if rtier is None else rtier)
                if tier == "ulysses":
                    return ulysses_attention_fn(
                        world, causal=args.causal, flash=True,
                        precision=precision, k_tile=args.k_tile,
                        skip_tile=args.skip_tile)
                if tier == "flash":
                    def attn(q, k, v):
                        return hand.flash_attention(
                            q, k, v, causal=args.causal,
                            precision=precision, k_tile=args.k_tile,
                            skip_tile=args.skip_tile)
                    return attn
                return xla_attn

            if tier == "xla" and args.causal and tril is None:
                tril = torch.ones((L, L), dtype=torch.bool,
                                  device=device).tril()

            def make_loop(attn):
                def loop(state, n):
                    qq, kk, vv = state
                    for _ in range(n):
                        qq = attn(qq, kk, vv)
                    return qq, kk, vv
                return loop

            def timed(attn):
                # a sweep's measurement: the real loop, a tenth the chain
                n_long = max(11, args.n_iter // 10)
                sec, _ = chain_rate(make_loop(attn), make_qkv(),
                                    n_short=n_long // 10 or 1,
                                    n_long=n_long)
                return sec

            lq_local = L // world if tier == "ring" else L
            depth_eff = ring_tier_eff = None
            if tier == "ring":
                depth_eff, ring_tier_eff = resolve_ring_schedule(
                    args, world, dtype, lq_local, device,
                    lambda depth, rtier: timed(make_attn(depth=depth,
                                                         rtier=rtier)))

            loop = make_loop(make_attn(depth=depth_eff,
                                       rtier=ring_tier_eff))
            label = (f"attn_{tier}{'[striped]' if striped else ''}"
                     f"{'[fused]' if ring_tier_eff == 'fused' else ''}")
            heads = world if tier == "ulysses" else 1
            # the first call (telemetry runs only): q, k, v read and the
            # output written, each of this rank's (L_local, d) blocks
            costs.compile_probe(
                loop, lambda: (make_qkv(), 1), label=label,
                flops=flops * heads / world,
                bytes_accessed=4 * (L // world) * d * heads
                * torch.empty((), dtype=dtype).element_size(),
                dtype=args.dtype, lq=lq_local, world=world)
            sec, state = chain_rate(loop, make_qkv(),
                                    n_short=args.n_iter // 10 or 1,
                                    n_long=args.n_iter)
            del state
            tflops = flops / sec / 1e12
            tag = ("[striped]" if striped else "") + (
                "[fused]" if ring_tier_eff == "fused" else "")
            row = {"kind": "attn", "tier": tier, "L": L, "d": d,
                   "dtype": args.dtype, "causal": args.causal,
                   "stripe": striped,
                   "tflops": tflops * heads, "us_per_iter": sec * 1e6,
                   "world": world}
            if tier == "ring":
                # the resolved depth (the ring clamps it to the world) and
                # the tier that ran
                row["ring_depth"] = depth_eff
                row["ring_tier"] = ring_tier_eff
            if tier != "xla":  # flash-kernel tiers only
                # the key tile the fold ran at: the tile of the route that
                # ran on the card, the requested one (else the whole block)
                # on the CPU
                on_card = device.type == "cuda"
                block = L // world if tier == "ring" else L
                card_tile = card_k_tile(dtype, precision, d)
                row["k_tile_ceiling"] = (card_tile if on_card
                                         else args.k_tile or block)
                if args.skip_tile is not None:
                    row["skip_tile_ceiling"] = (card_tile if on_card
                                                else args.skip_tile)
                else:
                    row["skip_tile_req"] = None
            rep.line(
                f"ATTN {tier}{tag} L={L} d={d} "
                f"{args.dtype} {tflops * heads:0.1f} TFLOP/s",
                row,
            )
            if not (tflops > 0):
                rep.line(f"ATTN FAIL {tier}: non-positive rate {tflops}")
                rc = 1
        return rc


def resolve_ring_schedule(args, world, dtype, lq, device, timed):
    """``(depth, tier)`` of the ring tier: each explicit > cached >
    prior, and under ``--tune`` a miss sweeps it first, each candidate
    timed by ``timed(depth, tier)`` (≅ JAX ``attnbench.py:183-290``).
    Over several processes the cache hit or the sweep's winner is rank
    0's, broadcast (``tune.sweep.ensure_tuned``), so every rank runs one
    schedule. The ring clamps the depth to the world: a deeper candidate
    would run the world's depth again, so it is declined with that
    reason, and at world 1, where only the prior is left, nothing is
    swept. The tier sweep declines with a NOTE where
    ``hand.fused_ring_feasible`` refuses the geometry, and a fused
    request or cached winner there runs the pipelined tier with a NOTE.
    Results are depth- and tier-invariant bit for bit; only the schedule
    changes."""
    from tpu_mpi_tests_torch.comm.ring import (
        RING_DEPTH_SPACE,
        RING_TIERS,
        resolve_pipeline_depth,
        resolve_ring_tier,
    )
    from tpu_mpi_tests_torch.kernels import hand
    from tpu_mpi_tests_torch.tune import priors
    from tpu_mpi_tests_torch.tune.sweep import ensure_tuned
    from tpu_mpi_tests_torch.utils import TpuMtError

    card = device if device.type == "cuda" else None
    if args.ring_depth is not None:
        depth = args.ring_depth
    elif sum(int(c) <= world for c in RING_DEPTH_SPACE.candidates) < 2:
        if args.tune:
            _common.decline_note(
                f"ring/pipeline_depth sweep: the ring clamps the depth to "
                f"the world ({world}), so every candidate runs depth "
                f"{world}; keeping the prior")
        depth = resolve_pipeline_depth(None, dtype=dtype, lq=lq)
    else:
        def measure_depth(cand):
            if int(cand) > world:
                raise TpuMtError(f"depth {cand} declined: the ring clamps "
                                 f"the depth to the world ({world})")
            return timed(int(cand), "pipelined")

        val = ensure_tuned("ring/pipeline_depth", measure_depth,
                           dtype=args.dtype, lq=lq)
        try:
            depth = max(1, int(val))
        except (TypeError, ValueError):  # a malformed cached value
            depth = priors.RING_PIPELINE_DEPTH
    feasible = hand.fused_ring_feasible(lq, lq, args.head_dim, dtype, card)
    if args.ring_tier is not None:
        tier = args.ring_tier
    elif not feasible:
        if args.tune:
            _common.decline_note(
                f"ring/tier sweep: fused candidate infeasible at lq={lq} "
                f"d={args.head_dim} {args.dtype} (fused_ring_feasible); "
                f"keeping the pipelined tier")
        tier = resolve_ring_tier(None, dtype=dtype, lq=lq, d=args.head_dim,
                                 device=card)
    else:
        tier = ensure_tuned("ring/tier",
                            lambda cand: timed(depth, str(cand)),
                            device_fallback=False, dtype=args.dtype, lq=lq)
        if tier not in RING_TIERS:  # a malformed cached value
            tier = priors.RING_TIER
    if tier == "fused" and not feasible:
        _common.decline_note(
            f"ring tier fused infeasible at lq={lq} d={args.head_dim} "
            f"{args.dtype} (fused_ring_feasible: at most 8 ranks, d <= "
            f"{hand.FLASH_MAX_D}, the comm slots in free memory); running "
            f"the pipelined tier")
        tier = "pipelined"
    return depth, tier


def card_k_tile(dtype, precision: str, d: int) -> int:
    """The key tile of the fold on the card for this driver's operands:
    the tile of the route (``hand.flash_route``) that its contiguous
    (L, d), (L, H, d) or shard operands take — every one of them moves in
    16-byte chunks exactly when d does."""
    import torch

    from tpu_mpi_tests_torch.kernels import hand

    chunk = 16 // torch.empty((), dtype=dtype).element_size()
    return hand.FLASH_K_TILES[hand.flash_route(dtype, precision, d,
                                               d % chunk == 0)]


def main(argv=None) -> int:
    p = _common.base_parser(__doc__)
    p.add_argument("--seq-len", type=int, default=8192)
    p.add_argument("--head-dim", type=int, default=128)
    p.add_argument("--tiers", default="xla,flash",
                   help=f"comma list from {','.join(TIERS)}")
    p.add_argument("--causal", action="store_true")
    p.add_argument(
        "--stripe", action="store_true",
        help="striped causal layout for the ring tier (balanced: every "
        "rank ~half-live per step; requires --causal)",
    )
    p.add_argument(
        "--k-tile", type=int, default=None,
        help="the TPU flash kernel's key-tile width: the plain version on "
        "the CPU folds at it; the card runs the hand kernel's own 64-wide "
        "tile",
    )
    p.add_argument(
        "--skip-tile", type=int, default=None,
        help="the TPU kernel's causal sub-span skip width (0 = coupled): "
        "the plain version on the CPU folds at it; the hand kernel skips "
        "at its own tile",
    )
    p.add_argument(
        "--ring-depth", type=int, default=None,
        help="ring K/V prefetch depth: 1 (the default) rotates after each "
        "step's fold, d>=2 keeps the K/V queue d-1 blocks ahead with the "
        "next hop in flight under the fold (clamped to the world; results "
        "are depth-invariant bit for bit)",
    )
    p.add_argument(
        "--ring-tier", default=None,
        help="ring K/V rotation tier: 'pipelined' (the default: host-"
        "scheduled hops, paced by --ring-depth) or 'fused' (every step in "
        "one launch of the fused ring-attention kernel, the K/V rotation "
        "by peer stores; a geometry its gate refuses runs pipelined with "
        "a NOTE)",
    )
    p.add_argument(
        "--fast", action="store_true",
        help="DEFAULT precision (TF32 / bf16 tensor cores) instead of "
        "HIGHEST (f32 arithmetic)",
    )
    p.add_argument("--n-iter", type=int, default=1100,
                   help="chained iterations (delta = n_iter - n_iter/10)")
    args = p.parse_args(argv)
    if args.seq_len < 8 or args.head_dim < 1:
        p.error("--seq-len must be >= 8 and --head-dim >= 1")
    if args.n_iter < 10:
        p.error("--n-iter must be >= 10")
    if args.ring_depth is not None and args.ring_depth < 1:
        p.error("--ring-depth must be >= 1")
    if args.ring_tier is not None and args.ring_tier not in (
        "pipelined", "fused"
    ):
        p.error("--ring-tier must be 'pipelined' or 'fused'")
    if args.k_tile is not None and args.k_tile < 8:
        p.error("--k-tile must be >= 8")
    if args.skip_tile is not None and args.skip_tile != 0 \
            and args.skip_tile < 8:
        p.error("--skip-tile must be 0 (coupled) or >= 8")
    if args.stripe and not args.causal:
        p.error("--stripe requires --causal (non-causal rings are "
                "already balanced)")
    return _common.run_guarded(run, args)


if __name__ == "__main__":
    sys.exit(main())
