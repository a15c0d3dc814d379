"""The card's measured schedules, shipped as cold-start priors (≅
``tpu_mpi_tests/tune/priors.py``, whose tables were measured on a TPU and
are not this package's).

A prior is the first candidate a sweep measures, and the value every
resolver returns when the cache has no entry: a run with no cache and no
``--tune`` runs these schedules. The measured ones come from
``gpu/prior_sweep.py``: the port's bench (``tpu_mpi_tests_torch.bench``)
at 8192², one rank, every point on the k-step kernels' ``regs`` route,
the median of five chained samples (2100 timesteps each), in iter/s
(``PERF.md``, "Priors"). The knobs owned outside the stencil path have
structural priors (below). The JAX package's TPU tile priors
(``MEASURED_BEST_K_TILE``, ``MEASURED_BEST_SKIP_TILE``,
``STREAM_SKIP_TILE``) have no analogue here and are left out: the CUDA
flash fold runs one fixed key tile a route (``kernels.hand.FLASH_K_TILES``)
and takes no tile argument, so there is no tile knob to hold a prior.
"""

from __future__ import annotations

# Kernel tier of the stencil iterate, per dtype. Measured (NVIDIA H100
# 80GB HBM3, 700.00 W; PR 19) at each tier's best k (k = 8): float32
# blocks (S = 0) 27231.17, rdma-chained 26955.40, rdma-fused 25785.67,
# xla (k = 1) 395.16; bfloat16 blocks 49184.06, rdma-chained 48049.94,
# rdma-fused 43253.88, xla 622.73. The winner is "blocks", which runs on
# every topology the drivers accept. A cached RDMA winner carried to a
# world that cannot run the RDMA ring (more than one host, or ranks
# sharing a card: symmetric memory maps peers within one host and
# refuses two ranks on one card) resolves to STENCIL_TIER_NO_RDMA, and
# the resolution is printed (comm/halo.py resolve_stencil_tier).
STENCIL_TIER = {"float32": "blocks", "bfloat16": "blocks"}
STENCIL_TIER_NO_RDMA = "blocks"

# Resident-block count S of the "blocks" tier, per dtype (0 = the dim-1
# single buffer). Measured (NVIDIA H100 80GB HBM3, 700.00 W; PR 19) at
# k = 8: float32 S=0 27231.17, S=2 15024.27, S=4 13685.95; at k = 4:
# S=0 20514.37, S=2 18238.69, S=4 13937.14; bfloat16 at k = 8: S=0
# 49184.06, S=2 35669.53, S=4 20940.45. S = 0 wins at every k.
BENCH_BLOCKS = {"float32": 0, "bfloat16": 0}

# Temporal-blocking depth k (timesteps per launch; the regs route holds
# k <= 8). Measured (NVIDIA H100 80GB HBM3, 700.00 W; PR 19) on blocks
# S = 0: float32 k=1 4965.72, k=2 10575.04, k=4 20514.37, k=8 27231.17;
# bfloat16 k=1 10554.18, k=2 20542.59, k=4 39715.98, k=8 49184.06.
BENCH_STEPS = 8

# Structural, not measured: the halo exchange's staging prior is DIRECT
# (the edge bands straight to the process group; the staged and RDMA
# flavours are the candidates a sweep prices against it), and the halo
# pipeline depth is 1, the serialized schedule: the overlap engine's
# depth 2 ran at 0.33-0.55x the chained loop (PERF.md PR 18, ROADMAP
# queue 3 fault 6).
HALO_STAGING = "direct"
HALO_OVERLAP_DEPTH = 1

# Structural, not measured: the row block of the fused ring kernel's smem
# route when the caller names none (kernels/hand.py takes the largest
# divisor of the height up to this that holds the seam). The main path
# runs the regs route, which takes no row block, so no space is declared
# for it yet.
FUSED_BLOCK_ROWS = 64


def stencil_tier(dtype: "str | None") -> str:
    """The tier prior of ``dtype`` (float32's for any other dtype)."""
    return STENCIL_TIER.get(dtype or "float32", STENCIL_TIER["float32"])


def bench_blocks(dtype: "str | None") -> int:
    """The block-count prior of ``dtype`` (float32's for any other)."""
    return BENCH_BLOCKS.get(dtype or "float32", BENCH_BLOCKS["float32"])

# Structural, not measured: the priors of the knobs owned outside the
# stencil path (≅ the JAX package's COLL_VARIANT, COLL_DISPATCH_DEPTH,
# RING_PIPELINE_DEPTH, RING_TIER, DAXPY_CHUNK, MOE_COMBINE and
# EMBED_LOOKUP). Each is the value at
# which an untuned run is the run before the knob existed: the library
# tier of the collectives ("torch", where the JAX package says "xla",
# as drivers._common.resolve_kernel_auto maps it), a wait after every
# chained collective (the dispatch window's depth: no space yet, see
# comm/collectives.resolve_dispatch_depth), the ring rotating after each
# fold, the host-pipelined ring, one daxpy launch per iteration, the
# MoE combine hop as the inverse all-to-all of the dispatch, the
# embedding lookup as a row gather (the JAX priors' values, kept as
# structural defaults until a --tune on the card picks a winner). None
# of them is a speed figure of any device.
COLL_VARIANT = "torch"
COLL_DISPATCH_DEPTH = 1
RING_PIPELINE_DEPTH = 1
RING_TIER = "pipelined"
DAXPY_CHUNK = 1
MOE_COMBINE = "alltoall"
EMBED_LOOKUP = "take"
