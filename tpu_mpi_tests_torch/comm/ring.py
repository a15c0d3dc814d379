"""Ring attention over the world's ranks (≅ ``tpu_mpi_tests/comm/ring.py``).

K/V blocks rotate around the 1-D ring of ranks (``Ring.shift``: one
``batch_isend_irecv`` hop to the right, NCCL on the card, gloo on the CPU)
while each rank folds its queries' attention online. At world=1 the ring
has one member: a rotation returns the block itself.

* :func:`online_softmax_update` — the one recurrence every attention
  tier shares (ring, Ulysses, the flash kernel's plain version).
* :func:`to_striped` / :func:`from_striped` — the striped causal layout.
* :func:`ring_pass` / :func:`ring_scan` — rotate, and fold over the ring;
  ``depth = d ≥ 2`` keeps the K/V queue d − 1 blocks ahead (JAX's
  ``ring.py:141-186``), bit for bit the same result.
* :func:`ring_attention` / :func:`ring_attention_fn` — the torch-op tier
  (the JAX package's XLA tier), the flash tier
  (``kernels.hand.flash_attention_block``, the hand CUDA kernel, at every
  step) and ``tier="fused"``: all w steps in one launch of
  ``kernels.hand.fused_ring_attention``, the K/V rotation by peer stores
  inside the kernel.

The TPU tile knobs (``k_tile``, ``skip_tile``) are accepted and reach the
flash kernel's plain version; the card runs the kernel's own tile. The
tuned-schedule cache of the JAX module (``tune/``) is ROADMAP queue 1
item 17: ``None`` knobs resolve to the priors (depth 1, tier
"pipelined").
"""

from __future__ import annotations

import torch

from tpu_mpi_tests_torch.comm.mesh import check_world, make_mesh
from tpu_mpi_tests_torch.kernels import hand
from tpu_mpi_tests_torch.utils import check_divisible

#: the ring K/V rotation tiers: the host-scheduled hops ("pipelined",
#: paced by ``depth``) and the one-launch peer-store kernel ("fused")
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
    """Rotate ``x`` (a tensor or a tuple of them) ``shift`` steps around
    the ring: each rank receives the block of ``rank - shift``. On a ring
    of one it is ``x`` itself."""
    n = check_world(world)
    if n == 1 or shift % n == 0:
        return x
    ring = make_mesh()
    for _ in range(shift % n):
        x = ring.shift(x)
    return x


def ring_scan(f, init, block, world: int = 1, depth: int = 1):
    """Fold ``f(carry, block_j, j)`` over every rank's block as the blocks
    rotate; step ``s`` on rank ``r`` sees the block of rank ``(r - s) %
    n``. ``block`` is a tensor or a tuple of them.

    ``depth`` is the K/V prefetch depth, clamped to the ring size (JAX's
    queue, ``ring.py:141-186``): 1 rotates the block after consuming it;
    ``d ≥ 2`` keeps the queue ``rot^s .. rot^{s+d-1}`` with the hop that
    delivers its last block in flight under step ``s``'s fold (each hop
    sends the block the previous one delivered, so one hop flies at a
    time; on the card it is queued on the NCCL stream and the fold does
    not wait for it). Every step consumes ``rot^s(block)`` whatever the
    depth, so results are bit for bit depth-invariant; no rotation past
    the last step is sent."""
    n = check_world(world)
    if int(depth) < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    d = min(int(depth), n)
    ring = make_mesh() if n > 1 else None
    r = ring.rank if ring is not None else 0
    carry = init
    if d == 1:
        blk = block
        for s in range(n):
            carry = f(carry, blk, (r - s) % n)
            if s < n - 1:
                blk = ring.shift(blk)
        return carry
    # the queue holds rot^s .. rot^{s+d-2} ready and rot^{s+d-1} in flight
    ready = [block]
    for _ in range(d - 2):
        ready.append(ring.shift(ready[-1]))
    hop = ring.shift_start(ready[-1])
    for s in range(n):
        carry = f(carry, ready.pop(0), (r - s) % n)
        if hop is not None:
            ready.append(hop.wait())
            hop = ring.shift_start(ready[-1]) if s + d < n else None
    return carry


def _resolve_tier(tier) -> str:
    """The K/V rotation tier: an explicit one, or the prior "pipelined"
    (the port has no tuned-schedule cache, ROADMAP queue 1 item 17)."""
    if tier is None:
        return "pipelined"
    if tier not in RING_TIERS:
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
    reach the plain version only. ``world`` is the process group's size
    (:func:`~tpu_mpi_tests_torch.comm.mesh.check_world`); this rank's
    queries sit at ``q_off = r·lq`` (striped: ``r``, stride ``n``) and
    step ``s``'s keys at ``k_off = src·lk`` (striped: ``src``), as in
    JAX's ``ring.py:421-426``.

    ``tier="fused"`` runs every step in one launch of
    :func:`kernels.hand.fused_ring_attention` (whatever ``flash``, as the
    JAX tier does); at a geometry its gate refuses
    (:func:`kernels.hand.fused_ring_feasible`) the explicit request
    raises ``ValueError`` naming the pipelined tier. ``None`` resolves to
    "pipelined"; ``depth`` paces the pipelined tier only."""
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / (d**0.5)
    if stripe and not causal:
        raise ValueError(
            "stripe=True only makes sense for causal ring attention "
            "(non-causal work is already balanced)"
        )
    n = check_world(world)
    if _resolve_tier(tier) == "fused":
        return hand.fused_ring_attention(q, k, v, scale=float(scale),
                                         causal=causal, stripe=stripe,
                                         precision=precision)
    depth = 1 if depth is None else depth
    r = make_mesh().rank if n > 1 else 0
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
    ``ring.py:473``; inputs (L_local, d): this rank's block of the global
    sequence, ``comm.collectives.shard_1d``). Checks the world and the
    tier when built, then returns ``attn(q, k, v)``."""
    check_world(world)
    _resolve_tier(tier)

    def attn(q, k, v):
        return ring_attention(
            q, k, v, causal=causal, flash=flash, k_tile=k_tile,
            skip_tile=skip_tile, precision=precision,
            stripe=stripe, depth=depth, tier=tier, world=world)

    return attn
