"""Halo exchange and the stencil hot-loop runners at world=1
(≅ ``tpu_mpi_tests/comm/halo.py``).

At world=1 a non-periodic exchange moves nothing (the only shard keeps
its physical ghosts) and a periodic one is a self-ring: the lo ghost band
takes the hi interior edge and the hi ghost band the lo interior edge.
Exchanges update the ghost bands IN PLACE and return the tensor (the JAX
functions return a new, donated array). A staged exchange packs the edge
bands into contiguous buffers first, by torch ops or, with
``kernel="hand"``, by the CUDA pack/unpack kernels.

Runners (``run(state, n_iter) -> state``) chain ``n_iter`` iterations as
a Python loop of launches:

* :func:`iterate_fused_fn` — the torch-op tier (≅ the XLA tier,
  ``halo.py:591``): exchange, 5-point derivative, ``interior += eps·dz``
  (its ``split=`` keyword is accepted and changes nothing here);
* :func:`iterate_hand_fn` — the hand kernel on one buffer
  (≅ ``iterate_pallas_fn``, ``halo.py:671``);
* :func:`iterate_hand_blocks_fn` — the hand kernel over S resident row
  blocks (≅ ``iterate_pallas_blocks_fn``, ``halo.py:955``).

The 2-D process grid on the 1×1 grid: :func:`heat_step2d_fn` (the heat
mini-app's chained Euler steps, ≅ ``halo.py:1371``) and
:func:`step2d_fn` (exchange both axes, both-axis derivatives, residual
allreduce, ≅ ``halo.py:1185``), each with ``kernel="torch"`` (the XLA
body as torch ops) or ``"hand"`` (the CUDA kernel).

The hand runners keep two buffers per block and swap them after each
launch: the CUDA kernels are out-of-place (see ``csrc/stencil_iterate.cu``
and ``csrc/heat2d.cu``).
"""

from __future__ import annotations

import enum

import torch

from tpu_mpi_tests_torch.comm.collectives import allreduce_sum
from tpu_mpi_tests_torch.kernels import hand
from tpu_mpi_tests_torch.kernels.hand import stencil2d_deriv, \
    stencil2d_iterate
from tpu_mpi_tests_torch.kernels.stencil import (
    N_BND,
    coef,
    dual_dim_step,
    heat2d_steps_,
    stencil1d_5,
)
from tpu_mpi_tests_torch.utils import TpuMtError, check_divisible

#: every kernel tier the JAX package's iterate knows; the port runs
#: "blocks" (the hand kernel) and "xla" (the torch-op formulation)
STENCIL_TIERS = ("blocks", "rdma-chained", "rdma-fused", "xla")
PORTED_TIERS = ("blocks", "xla")

# The JAX package's shipped schedule priors (tpu_mpi_tests/tune/priors.py
# :55-56,67), taken as they are: S=2 resident blocks for float32, the
# dim-1 single buffer (S=0) for bfloat16, k=4 timesteps per pass, the
# "blocks" tier. They were measured on a TPU; the card's own priors are
# a ROADMAP open item.
PRIOR_BLOCKS = {"float32": 2, "bfloat16": 0}
PRIOR_STEPS = 4
PRIOR_TIER = "blocks"


def check_tier(tier: str) -> str:
    """``tier`` if this port runs it; raise for the RDMA tiers, which
    need the multi-chip kernels still to port."""
    if tier not in STENCIL_TIERS:
        raise TpuMtError(
            f"unknown stencil tier {tier!r}; valid: {STENCIL_TIERS}"
        )
    if tier not in PORTED_TIERS:
        raise TpuMtError(
            f"stencil tier {tier!r} is not ported yet: it needs the RDMA "
            f"ring kernels (ROADMAP queue 2 items 2-3); ported tiers: "
            f"{PORTED_TIERS}"
        )
    return tier


class Staging(enum.Enum):
    """Halo staging modes (≅ the JAX enum; the reference's ``buf`` flag).
    The hand RDMA ring and the tuned ``auto`` mode are not ported."""

    DIRECT = "direct"
    DEVICE_STAGED = "device"
    HOST_STAGED = "host"

    @classmethod
    def parse(cls, s: "str | Staging") -> "Staging":
        if isinstance(s, Staging):
            return s
        if s.lower() == "pallas":
            raise TpuMtError(
                "staging 'pallas' (the hand RDMA ring) is not ported yet: "
                "ROADMAP queue 2 item 2"
            )
        try:
            return cls(s.lower())
        except ValueError:
            raise TpuMtError(
                f"unknown staging mode {s!r}; valid: "
                f"{[m.value for m in cls]}"
            ) from None


def halo_payload_bytes(zg: torch.Tensor, axis: int, world: int, n_bnd: int,
                       periodic: bool) -> int:
    """Payload convention for one halo exchange (≅ the JAX function):
    2 directions × one ghost band per neighbour pair (``world`` pairs on
    a periodic ring, ``world − 1`` otherwise); a band is ``n_bnd`` slabs
    of the non-decomposed extent."""
    pairs = world if periodic else world - 1
    band_bytes = n_bnd * (zg.numel() // zg.shape[axis]) * zg.element_size()
    return 2 * pairs * band_bytes


def exchange_shard(z: torch.Tensor, *, axis: int = 0, n_bnd: int = 2,
                   periodic: bool = False, staged: bool = False,
                   kernel: str = "torch") -> torch.Tensor:
    """World=1 halo exchange of one ghosted block, in place. Non-periodic:
    nothing moves (and nothing launches). Periodic: lo ghost ← hi
    interior edge, hi ghost ← lo interior edge. ``staged`` packs both
    edges into contiguous buffers first (≅ DEVICE_STAGED, the reference's
    ``buf_from_view``/``buf_to_view``): with ``kernel="torch"`` by
    ``clone``/``copy_``, with ``kernel="hand"`` by the CUDA kernels
    ``hand.pack_edges`` and ``hand.unpack_ghosts`` (one launch each; a
    2-D block). ``kernel`` changes nothing when not ``staged``."""
    _check_kernel("exchange_shard", kernel)
    if not periodic:
        return z
    n = z.shape[axis]
    if staged and kernel == "hand":
        lo_edge, hi_edge = hand.pack_edges(z, axis, n_bnd)
        return hand.unpack_ghosts(z, hi_edge, lo_edge, axis, n_bnd)
    lo_edge = z.narrow(axis, n_bnd, n_bnd)
    hi_edge = z.narrow(axis, n - 2 * n_bnd, n_bnd)
    if staged or n < 3 * n_bnd:
        # contiguous staging copies; also required when an edge overlaps
        # the ghost band the other edge lands in (tiny extents)
        lo_edge, hi_edge = lo_edge.clone(), hi_edge.clone()
    z.narrow(axis, 0, n_bnd).copy_(hi_edge)
    z.narrow(axis, n - n_bnd, n_bnd).copy_(lo_edge)
    return z


def _host_staged_exchange(z: torch.Tensor, axis: int, n_bnd: int,
                          periodic: bool) -> torch.Tensor:
    """Edge bands round-trip through host memory (≅ the reference's
    ``stage_host`` paths): only the two bands touch the host."""
    if not periodic:
        return z
    n = z.shape[axis]
    lo_edge = z.narrow(axis, n_bnd, n_bnd).cpu()
    hi_edge = z.narrow(axis, n - 2 * n_bnd, n_bnd).cpu()
    z.narrow(axis, 0, n_bnd).copy_(hi_edge)
    z.narrow(axis, n - n_bnd, n_bnd).copy_(lo_edge)
    return z


def halo_exchange(zg: torch.Tensor, axis: int = 0, n_bnd: int = 2,
                  periodic: bool = False,
                  staging: "Staging | str" = Staging.DIRECT,
                  kernel: str = "torch") -> torch.Tensor:
    """Exchange the ghost bands of a ghosted domain at world=1 (in place;
    returns ``zg``). ``kernel="hand"`` stages the DEVICE_STAGED bands
    through the CUDA pack/unpack kernels (:func:`exchange_shard`)."""
    staging = Staging.parse(staging)
    _check_kernel("halo_exchange", kernel)
    if staging is Staging.HOST_STAGED:
        return _host_staged_exchange(zg, axis, n_bnd, periodic)
    return exchange_shard(zg, axis=axis, n_bnd=n_bnd, periodic=periodic,
                          staged=staging is Staging.DEVICE_STAGED,
                          kernel=kernel)


def stencil_fn(axis: int, scale: float, kernel: str = "torch"):
    """Stencil application over the ghosted layout: ``apply(z)`` returns
    the interior derivative. ``kernel="hand"`` runs the CUDA kernel
    (≅ ``kernel="pallas"``, the SYCL-style hand kernel); ``"torch"`` the
    torch-op formulation (≅ the XLA tier)."""
    if kernel == "hand":
        return lambda z: stencil2d_deriv(z, scale, dim=axis)
    if kernel == "torch":
        return lambda z: stencil1d_5(z, scale=scale, axis=axis)
    raise TpuMtError(f"unknown stencil kernel {kernel!r}; valid: torch, "
                     f"hand")


def _check_kernel(name: str, kernel: str) -> None:
    if kernel not in ("torch", "hand"):
        raise TpuMtError(f"{name}: unknown kernel {kernel!r}; valid: torch, "
                         f"hand")


def exchange2d(z: torch.Tensor, n_bnd: int, periodic: bool) -> torch.Tensor:
    """Both-axis exchange of a both-axes-ghosted shard at world=1, in
    place: axis 0 first, then axis 1 over every row (the corner ghosts
    come right because the axis-1 bands include the fresh axis-0 ghost
    rows) — the order of the JAX bodies."""
    exchange_shard(z, axis=0, n_bnd=n_bnd, periodic=periodic)
    return exchange_shard(z, axis=1, n_bnd=n_bnd, periodic=periodic)


def heat_step2d_fn(n_bnd: int, cx: float, cy: float, steps: int = 1,
                   kernel: str = "torch"):
    """``run(z, n_outer)``: ``n_outer`` bodies of the heat mini-app on
    the periodic 1×1 grid (≅ ``heat_step2d_fn``, ``halo.py:1371``) — per
    body a periodic self-ring exchange on axis 0, then on axis 1, then
    ``steps`` explicit-Euler updates over the maximal span. ``steps=k``
    is temporal blocking: ghost width ``n_bnd >= k``, one exchange per k
    steps. ``kernel="torch"`` updates in place with torch ops (the XLA
    body); ``"hand"`` launches the CUDA kernel once per body on two
    ping-ponged buffers and returns whichever holds the result."""
    if n_bnd < steps:
        raise TpuMtError(
            f"heat_step2d_fn: ghost width n_bnd={n_bnd} must be >= "
            f"steps={steps} (one Laplacian radius per fused timestep)"
        )
    _check_kernel("heat_step2d_fn", kernel)

    def run(z: torch.Tensor, n_outer: int) -> torch.Tensor:
        spare = torch.empty_like(z) if kernel == "hand" else None
        for _ in range(n_outer):
            exchange2d(z, n_bnd, periodic=True)
            if kernel == "hand":
                out = hand.heat2d(z, cx, cy, steps=steps, out=spare)
                z, spare = out, z
            else:
                heat2d_steps_(z, cx, cy, steps)
        return z

    return run


def step2d_fn(n_bnd: int, scale_x: float, scale_y: float,
              kernel: str = "torch"):
    """``step(z) -> (dz_dx, dz_dy, residual)``: the 2-D process grid's
    full step on the 1×1 grid (≅ ``step2d_fn``, ``halo.py:1185``) —
    non-periodic exchanges on both axes (nothing moves at world=1: the
    physical ghosts come from init), both-axis derivatives and the
    residual (``kernel="torch"``: torch ops; ``"hand"``: the CUDA kernel,
    one read for all three), then the residual's allreduce."""
    _check_kernel("step2d_fn", kernel)
    dual = hand.dual_dim_step if kernel == "hand" else dual_dim_step

    def step(z: torch.Tensor):
        exchange2d(z, n_bnd, periodic=False)
        dz_dx, dz_dy, residual = dual(z, n_bnd, scale_x, scale_y)
        return dz_dx, dz_dy, allreduce_sum(residual.reshape(1))[0]

    return step


def iterate_fused_fn(axis: int, n_bnd: int, scale: float, eps: float = 1e-6,
                     staged: bool = False, periodic: bool = False,
                     split: bool = False):
    """``n_iter`` × (exchange, stencil, ``interior += eps·dz``) — the
    reference's hot loop (``mpi_stencil2d_gt.cc:511-535``) as torch ops.
    Updates ``z`` in place and returns it.

    ``split`` is the JAX function's split-vs-fused switch: there it puts
    an ``optimization_barrier`` between the exchange and the stencil so
    XLA cannot fuse them. Eager PyTorch launches every op on its own, so
    there is no fusion for a barrier to break: the keyword is accepted
    and the same ops run."""
    del split

    def run(z: torch.Tensor, n_iter: int) -> torch.Tensor:
        n = z.shape[axis]
        e = coef(eps, z)
        inner = z.narrow(axis, n_bnd, n - 2 * n_bnd)
        for _ in range(n_iter):
            exchange_shard(z, axis=axis, n_bnd=n_bnd, periodic=periodic,
                           staged=staged)
            dz = stencil1d_5(z, scale=scale, axis=axis)
            inner.copy_(inner + e * dz)
        return z

    return run


def _check_deep(name: str, n_bnd: int, steps: int) -> None:
    if n_bnd != steps * N_BND:
        raise TpuMtError(
            f"{name}: ghost width n_bnd={n_bnd} must equal steps({steps}) "
            f"x stencil radius({N_BND}) — deep halos carry one radius per "
            f"fused timestep"
        )


def iterate_hand_fn(n_bnd: int, scale_eps: float, axis: int = 1,
                    steps: int = 1, periodic: bool = False):
    """k-step hand-kernel iterate on one buffer (≅ ``iterate_pallas_fn``):
    per outer iteration one exchange of the k·N_BND-deep ghosts and one
    kernel launch advancing k timesteps. ``n_iter`` counts outer
    iterations (= n_iter·k timesteps). At world=1 the flags are static:
    both sides physical, or neither on a periodic self-ring."""
    _check_deep("iterate_hand_fn", n_bnd, steps)
    flags = (0, 0) if periodic else (1, 1)

    def run(z: torch.Tensor, n_iter: int) -> torch.Tensor:
        spare = torch.empty_like(z)
        for _ in range(n_iter):
            exchange_shard(z, axis=axis, n_bnd=n_bnd, periodic=periodic)
            out = stencil2d_iterate(z, scale_eps, dim=axis, steps=steps,
                                    phys_static=flags, out=spare)
            z, spare = out, z
        return z

    return run


def iterate_hand_blocks_fn(n_blocks: int, n_bnd: int, scale_eps: float,
                           steps: int = 1, periodic: bool = False):
    """k-step iterate over ``n_blocks`` resident row blocks (dim 0) —
    ≅ ``iterate_pallas_blocks_fn`` on one device. Per outer iteration the
    blocks' ghost bands are refreshed from their neighbours' interiors
    (the periodic self-ring wraps block 0 and block S−1), then each block
    takes one kernel launch. The refresh sources are interior rows,
    disjoint from every ghost band, so refreshing in place equals the
    JAX function's read-everything-first order.

    ``run(state, n_iter)`` takes and returns a tuple of S blocks
    ``(H/S + 2·n_bnd, W)`` (:func:`split_blocks` / :func:`merge_blocks`)."""
    _check_deep("iterate_hand_blocks_fn", n_bnd, steps)
    if n_blocks < 2:
        raise TpuMtError(
            f"iterate_hand_blocks_fn: n_blocks={n_blocks} < 2 — use "
            f"iterate_hand_fn for the single-buffer schedule"
        )
    S, K = n_blocks, n_bnd

    def flags(s):
        if periodic:
            return (0, 0)
        return (1 if s == 0 else 0, 1 if s == S - 1 else 0)

    def run(state, n_iter: int):
        blocks = list(state)
        if len(blocks) != S:
            raise TpuMtError(f"expected {S} blocks, got {len(blocks)}")
        hb = blocks[0].shape[0] - 2 * K
        if hb < K:
            raise TpuMtError(
                f"iterate_hand_blocks_fn: {hb} interior rows per block < "
                f"ghost width {K}"
            )
        spares = [torch.empty_like(b) for b in blocks]
        for _ in range(n_iter):
            for s in range(1, S):  # top ghost ← upper block's last rows
                blocks[s][0:K].copy_(blocks[s - 1][hb:hb + K])
            for s in range(S - 1):  # bottom ghost ← lower block's first
                blocks[s][hb + K:hb + 2 * K].copy_(blocks[s + 1][K:2 * K])
            if periodic:  # world=1 self-ring across the block tuple
                blocks[0][0:K].copy_(blocks[S - 1][hb:hb + K])
                blocks[S - 1][hb + K:hb + 2 * K].copy_(blocks[0][K:2 * K])
            for s in range(S):
                out = stencil2d_iterate(
                    blocks[s], scale_eps, dim=0, steps=steps,
                    phys_static=flags(s), out=spares[s],
                )
                blocks[s], spares[s] = out, blocks[s]
        return tuple(blocks)

    return run


def split_blocks(z: torch.Tensor, n_blocks: int, n_bnd: int):
    """Split a dim-0-ghosted domain ``(H + 2K, W)`` into ``n_blocks``
    resident blocks ``(H/S + 2K, W)`` with overlapping ghost bands — each
    its own tensor (views would share the overlapping rows)."""
    K = n_bnd
    hb = check_divisible(z.shape[0] - 2 * K, n_blocks,
                         "split_blocks interior rows")
    return tuple(
        z[s * hb:s * hb + hb + 2 * K].clone() for s in range(n_blocks)
    )


def merge_blocks(state, n_bnd: int) -> torch.Tensor:
    """Reassemble :func:`split_blocks` blocks into the whole ghosted
    domain (interiors concatenated, outermost ghost bands kept)."""
    K = n_bnd
    st = tuple(state)
    if len(st) == 1:
        return st[0]
    hb = st[0].shape[0] - 2 * K
    parts = [st[0][:K + hb]]
    parts += [b[K:K + hb] for b in st[1:-1]]
    parts.append(st[-1][K:])
    return torch.cat(parts, dim=0)
