"""Attention-tier benchmark driver at world=1 (≅
``tpu_mpi_tests/drivers/attnbench.py``): flash vs torch-op local
attention, plus the sequence-parallel flavours, at CLI-selectable shapes.

    ATTN <tier> L=<L> d=<D> <dtype> <tflops> TFLOP/s

Tiers: ``xla`` (torch ops materialising the scores: the JAX XLA tier),
``flash`` (the hand CUDA kernel, ``kernels.hand.flash_attention``),
``ring`` / ``ulysses`` (``comm.ring`` / ``comm.alltoall`` with the hand
kernel as local compute; at world=1 the ring has one member and the
all-to-alls are the identity). Iterations chain with the output fed back
as the next query (``instrument.timers.chain_rate``: CUDA events on the
card, two run lengths differenced). FLOPs are 4·L²·d per attention (2·L²·d
when causal). HIGHEST (the default) turns TF32 off; ``--fast`` runs
DEFAULT (TF32 / bf16 tensor cores). The TPU tile knobs ``--k-tile`` and
``--skip-tile`` reach the kernel's plain version; the card runs the
kernel's own 64×64 tile, which each row records.

Not ported (ROADMAP queue 1): ``--tune`` (item 17, raises), the compile
probe (item 18) and the ``attn`` serve workload (item 19).
"""

from __future__ import annotations

import sys

from tpu_mpi_tests_torch.drivers import _common

TIERS = ("xla", "flash", "ring", "ulysses")


def run(args) -> int:
    import torch

    from tpu_mpi_tests_torch.comm.alltoall import ulysses_attention_fn
    from tpu_mpi_tests_torch.comm.mesh import bootstrap, topology
    from tpu_mpi_tests_torch.comm.ring import ring_attention_fn, to_striped
    from tpu_mpi_tests_torch.instrument.timers import chain_rate
    from tpu_mpi_tests_torch.kernels import hand
    from tpu_mpi_tests_torch.utils import TpuMtError, check_divisible

    if args.tune:
        raise TpuMtError("--tune (the flash tile / ring depth / ring tier "
                         "sweeps) is not ported: ROADMAP queue 1 item 17")
    dtype = _common.torch_dtype(args)
    if dtype == torch.float64:
        raise TpuMtError("attnbench runs float32 or bfloat16 (the flash "
                         "kernel has no float64 route, as in the JAX "
                         "package)")
    device = bootstrap(args.device)
    topo = topology(device)
    world = topo.global_device_count
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
                return q, k, v

            if tier == "ring":
                attn = ring_attention_fn(
                    world, causal=args.causal, flash=True,
                    precision=precision, stripe=args.stripe,
                    k_tile=args.k_tile, skip_tile=args.skip_tile,
                    depth=args.ring_depth, tier=args.ring_tier)
            elif tier == "ulysses":
                attn = ulysses_attention_fn(
                    world, causal=args.causal, flash=True,
                    precision=precision, k_tile=args.k_tile,
                    skip_tile=args.skip_tile)
            elif tier == "flash":
                def attn(q, k, v):
                    return hand.flash_attention(
                        q, k, v, causal=args.causal, precision=precision,
                        k_tile=args.k_tile, skip_tile=args.skip_tile)
            else:
                if args.causal and tril is None:
                    tril = torch.ones((L, L), dtype=torch.bool,
                                      device=device).tril()
                attn = xla_attn

            def loop(state, n, attn=attn):
                qq, kk, vv = state
                for _ in range(n):
                    qq = attn(qq, kk, vv)
                return qq, kk, vv

            sec, state = chain_rate(loop, make_qkv(),
                                    n_short=args.n_iter // 10 or 1,
                                    n_long=args.n_iter)
            del state
            tflops = flops / sec / 1e12
            heads = world if tier == "ulysses" else 1
            tag = "[striped]" if striped else ""
            row = {"kind": "attn", "tier": tier, "L": L, "d": d,
                   "dtype": args.dtype, "causal": args.causal,
                   "stripe": striped,
                   "tflops": tflops * heads, "us_per_iter": sec * 1e6,
                   "world": world}
            if tier == "ring":
                row["ring_depth"] = 1  # a ring of one: no rotation in flight
                row["ring_tier"] = "pipelined"
            if tier != "xla":  # flash-kernel tiers only
                # the key tile the fold ran at: the kernel's own on the
                # card, the requested one (else the whole block) on the CPU
                on_card = device.type == "cuda"
                row["k_tile_ceiling"] = (hand.FLASH_K_TILE if on_card
                                         else args.k_tile or L)
                if args.skip_tile is not None:
                    row["skip_tile_ceiling"] = (hand.FLASH_K_TILE if on_card
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
        help="ring K/V prefetch pipeline depth; a ring of one rank runs "
        "depth 1 whatever is asked (results are depth-invariant)",
    )
    p.add_argument(
        "--ring-tier", default=None,
        help="ring K/V rotation tier: 'pipelined' (the default); 'fused' "
        "(the one-launch fused-RDMA kernel) is not ported and raises "
        "(ROADMAP queue 2 item 14)",
    )
    p.add_argument(
        "--fast", action="store_true",
        help="DEFAULT precision (TF32 / bf16 tensor cores) instead of "
        "HIGHEST (f32 arithmetic)",
    )
    p.add_argument("--tune", action="store_true",
                   help="tile sweeps: not ported (ROADMAP queue 1 item 17; "
                   "raises)")
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
    return run(args)


if __name__ == "__main__":
    sys.exit(main())
