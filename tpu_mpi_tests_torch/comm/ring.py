"""Ring attention at world=1 (≅ ``tpu_mpi_tests/comm/ring.py``).

The JAX module rotates K/V blocks around a mesh-axis ring with
``lax.ppermute`` while each shard folds its queries' attention online.
This slice of the port runs one rank, so the ring has one member: a
rotation returns the block itself, :func:`ring_scan` makes one step with
``src = 0``, and the pipeline depth is clamped to 1 (the JAX clamp to
the ring size, ``ring.py:139``). A ``world`` other than 1 raises through
``comm.mesh.check_world`` (multi-rank is ROADMAP queue 1 item 2).

* :func:`online_softmax_update` — the one recurrence every attention
  tier shares (ring, Ulysses, the flash kernel's plain version).
* :func:`to_striped` / :func:`from_striped` — the striped causal layout.
* :func:`ring_pass` / :func:`ring_scan` — rotate, and fold over the ring.
* :func:`ring_attention` / :func:`ring_attention_fn` — the flash tier
  (``kernels.hand.flash_attention_block``, the hand CUDA kernel) and
  the torch-op tier (the JAX package's XLA tier).

The TPU tile knobs (``k_tile``, ``skip_tile``) are accepted and reach the
flash kernel's plain version; the card runs the kernel's own tile. The
tuned-schedule cache of the JAX module (``tune/``) is ROADMAP queue 1
item 17: ``None`` knobs resolve to the priors (depth 1, tier
"pipelined").
"""

from __future__ import annotations

import torch

from tpu_mpi_tests_torch.comm.mesh import check_world
from tpu_mpi_tests_torch.kernels import hand
from tpu_mpi_tests_torch.utils import TpuMtError, check_divisible

#: the ring K/V rotation tiers; "fused" (the one-launch RDMA kernel,
#: ``fused_ring_attention_pallas``) is not ported
RING_TIERS = ("pipelined", "fused")


def online_softmax_update(m, l, s, keepdims: bool = False):
    """One block of the online-softmax recurrence (≅ ``ring.py:44``):
    given the running max ``m`` and denominator ``l`` (any batch shape; a
    trailing length-1 axis instead when ``keepdims``) and the block's
    scores ``s`` (batch shape + a trailing key axis), returns ``(m_new,
    l_new, p, corr)``: ``p`` the block's unnormalised probabilities,
    ``corr`` the caller's numerator rescale, ``acc_new = acc·corr[...,
    None] + p @ v_blk`` (no ``[..., None]`` under ``keepdims``).

    An all-masked block leaves ``m_new`` at -inf; the ``m_safe`` guard
    makes ``exp(s − m_safe) = exp(-inf) = 0`` with no −inf − −inf NaN."""
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=keepdims))
    m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
    p = torch.exp(s - (m_safe if keepdims else m_safe[..., None]))
    corr = torch.exp(m - m_safe)
    l_new = l * corr + p.sum(dim=-1, keepdim=keepdims)
    return m_new, l_new, p, corr


def to_striped(x: torch.Tensor, world: int) -> torch.Tensor:
    """Permute a global sequence (axis 0) into the striped causal layout:
    shard ``r`` holds tokens ``r, r+n, r+2n, …``, so striped row ``r·L_loc
    + i`` is global token ``i·n + r`` (positions stay affine, which the
    flash kernel's tile skip reads through ``pos_stride``)."""
    lloc = check_divisible(x.shape[0], world, "to_striped sequence length")
    return x.reshape((lloc, world) + x.shape[1:]).transpose(0, 1) \
        .reshape(x.shape)


def from_striped(x: torch.Tensor, world: int) -> torch.Tensor:
    """Inverse of :func:`to_striped`."""
    lloc = check_divisible(x.shape[0], world, "from_striped sequence length")
    return x.reshape((world, lloc) + x.shape[1:]).transpose(0, 1) \
        .reshape(x.shape)


def ring_pass(x, shift: int = 1, world: int = 1):
    """Rotate ``x`` ``shift`` steps around the ring (each rank receives
    the block of ``rank - shift``); on a ring of one it is ``x``."""
    check_world(world)
    return x


def ring_scan(f, init, block, world: int = 1, depth: int = 1):
    """Fold ``f(carry, block_j, j)`` over every rank's block as the blocks
    rotate; step ``s`` on rank ``r`` sees the block of rank ``(r - s) %
    n``. ``depth`` (the K/V prefetch pipeline) is clamped to the ring
    size; results do not depend on it."""
    n = check_world(world)
    if int(depth) < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    # min(depth, n) − 1 rotations would be in flight: none on a ring of one
    r = 0
    carry, blk = init, block
    for s in range(n):
        carry = f(carry, blk, (r - s + n) % n)
        blk = ring_pass(blk, world=world)
    return carry


def _resolve_tier(tier) -> str:
    if tier is None:
        return "pipelined"
    if tier == "fused":
        raise TpuMtError(
            "ring tier 'fused' (the one-launch fused-RDMA kernel, "
            "fused_ring_attention_pallas) is not ported: ROADMAP queue 2 "
            "item 14"
        )
    if tier != "pipelined":
        raise ValueError(f"ring tier must be one of {RING_TIERS}, got "
                         f"{tier!r}")
    return tier


def ring_attention(q, k, v, scale=None, causal: bool = False,
                   precision: str = "highest", flash: bool = False,
                   k_tile=None, skip_tile=None, stripe: bool = False,
                   depth=None, tier=None, world: int = 1):
    """Blockwise ring attention for this rank's blocks q, k, v (L_local,
    d) (≅ ``ring.py:308``): K/V blocks rotate around the ring and the
    online-softmax carry (m, l, acc) folds each one, so no rank holds the
    full attention matrix or the full K/V.

    ``flash=True`` folds each block with the hand CUDA kernel
    (:func:`kernels.hand.flash_attention_block`, f32 carry updated in
    place); otherwise torch ops in q's dtype materialise each step's
    (L_local × L_local) scores (the JAX XLA tier). ``precision`` is
    "highest" (f32 arithmetic; TF32 off) or "default" (the tensor cores).
    ``stripe=True`` (causal only) takes and returns the striped layout
    (positions ``i·n + r``). The TPU tile knobs ``k_tile``/``skip_tile``
    reach the plain version only.
    ``tier="fused"`` raises (ROADMAP queue 2 item 14)."""
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / (d**0.5)
    if stripe and not causal:
        raise ValueError(
            "stripe=True only makes sense for causal ring attention "
            "(non-causal work is already balanced)"
        )
    _resolve_tier(tier)
    depth = 1 if depth is None else depth
    n = check_world(world)
    r = 0
    lq = q.shape[0]

    if flash:
        kw = {"dtype": torch.float32, "device": q.device}
        init = (torch.full((lq, 1), float("-inf"), **kw),
                torch.zeros((lq, 1), **kw), torch.zeros((lq, d), **kw))

        def step(carry, kv_blk, src):
            k_blk, v_blk = kv_blk
            if stripe:  # striped position of row i on shard p: i·n + p
                q_off, k_off, stride = r, src, n
            else:
                q_off, k_off, stride = r * lq, src * k_blk.shape[0], 1
            return hand.flash_attention_block(
                q, k_blk, v_blk, *carry, q_off, k_off, scale=float(scale),
                causal=causal, pos_stride=stride, precision=precision,
                k_tile=k_tile, skip_tile=skip_tile)

        m, l, acc = ring_scan(step, init, (k, v), world, depth=depth)
        return (acc / l).to(q.dtype)

    init = (torch.full(q.shape[:-1], float("-inf"), dtype=q.dtype,
                       device=q.device),
            torch.zeros(q.shape[:-1], dtype=q.dtype, device=q.device),
            torch.zeros_like(q))

    def step(carry, kv_blk, src):
        m, l, acc = carry
        k_blk, v_blk = kv_blk
        s = torch.matmul(q, k_blk.T) * scale
        if causal:
            # global positions: the contiguous layout puts query i at
            # r·lq + i, the striped one at i·n + r (likewise the keys of
            # rank src); mask future keys
            lk = k_blk.shape[0]
            ar_q = torch.arange(lq, device=q.device)
            ar_k = torch.arange(lk, device=q.device)
            if stripe:
                q_pos, k_pos = ar_q * n + r, ar_k * n + src
            else:
                q_pos, k_pos = r * lq + ar_q, src * lk + ar_k
            s = torch.where(q_pos[:, None] >= k_pos[None, :], s,
                            float("-inf"))
        m_new, l, p, corr = online_softmax_update(m, l, s)
        acc = acc * corr[:, None] + torch.matmul(p, v_blk)
        return m_new, l, acc

    with hand.matmul_precision(precision):
        m, l, acc = ring_scan(step, init, (k, v), world, depth=depth)
    return acc / l[:, None]


def ring_attention_fn(world: int = 1, causal: bool = False,
                      flash: bool = False, k_tile=None, skip_tile=None,
                      precision: str = "highest", stripe: bool = False,
                      depth=None, tier=None):
    """Ring attention over a sequence split along the ring (≅
    ``ring.py:473``; inputs (L, d), here one rank's whole sequence).
    Checks the world and the tier when built, then returns ``attn(q, k,
    v)``."""
    check_world(world)
    _resolve_tier(tier)

    def attn(q, k, v):
        return ring_attention(
            q, k, v, causal=causal, flash=flash, k_tile=k_tile,
            skip_tile=skip_tile, precision=precision,
            stripe=stripe, depth=depth, tier=tier, world=world)

    return attn
