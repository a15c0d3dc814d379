"""Halo exchange and the stencil hot-loop runners (≅
``tpu_mpi_tests/comm/halo.py``), one process per rank.

Each rank holds its ghosted block. At world=1 a non-periodic exchange
moves nothing (the only shard keeps its physical ghosts) and a periodic
one is a self-ring: the lo ghost band takes the hi interior edge and the
hi ghost band the lo interior edge. At world > 1 the edge bands travel to
the ±1 ring neighbours over the process group (``Ring.sendrecv``: NCCL on
the card, gloo on the CPU), and the ends of a non-periodic ring keep their
physical ghosts. Exchanges update the ghost bands IN PLACE and return the
tensor (the JAX functions return a new, donated array). The hand RDMA
exchange at world > 1 on the card stores into the neighbours' copies of
the tensor, so the tensor must live in the ring's peer memory
(``comm/peer.py``): :func:`staging_buffer` puts a shard there. A staged
exchange packs the edge bands into contiguous buffers first, by torch ops
or, with ``kernel="hand"``, by the CUDA pack/unpack kernels; torch is
row-major, so the dim-1 bands are always packed before a send.

Runners (``run(state, n_iter) -> state``) chain ``n_iter`` iterations as
a Python loop of launches:

* :func:`iterate_fused_fn` — the torch-op tier (≅ the XLA tier,
  ``halo.py:591``): exchange, 5-point derivative, ``interior += eps·dz``
  (its ``split=`` keyword is accepted and changes nothing here);
* :func:`iterate_hand_fn` — the hand kernel on one buffer
  (≅ ``iterate_pallas_fn``, ``halo.py:671``); ``rdma=True`` exchanges
  through the hand RDMA ring (``hand.ring_halo``) — the ``rdma-chained``
  tier;
* :func:`iterate_fused_rdma_fn` — exchange and update in one hand launch
  (``hand.stencil2d_fused_rdma``, ≅ ``halo.py:803``) — the ``rdma-fused``
  tier, with :func:`fused_overlap_record` for its OVERLAP probe;
* :func:`iterate_hand_blocks_fn` — the hand kernel over S resident row
  blocks per rank (≅ ``iterate_pallas_blocks_fn``, ``halo.py:955``).

The 2-D process grid (``comm.mesh.make_grid``): :func:`exchange2d`
exchanges axis 0 over the grid's column ring, then axis 1 over its row
ring; :func:`heat_step2d_fn` (the heat mini-app's chained Euler steps, ≅
``halo.py:1371``) and :func:`step2d_fn` (exchange both axes, both-axis
derivatives, the residual summed over the whole grid, ≅
``halo.py:1185``) run on it, each with ``kernel="torch"`` (the XLA body
as torch ops) or ``"hand"`` (the CUDA kernel; at world > 1 the strided
axis-1 bands then go through the pack and unpack kernels).

The hand runners keep two buffers per block and swap them after each
launch: the CUDA kernels are out-of-place (see ``csrc/stencil_iterate.cu``
and ``csrc/heat2d.cu``).
"""

from __future__ import annotations

import enum

import torch

from tpu_mpi_tests_torch.comm.collectives import allreduce_sum
from tpu_mpi_tests_torch.comm.mesh import Grid, Ring, make_grid, make_mesh
from tpu_mpi_tests_torch.comm.peer import peer_ring
from tpu_mpi_tests_torch.kernels import hand
from tpu_mpi_tests_torch.kernels import pack as _pack
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

#: every kernel tier the JAX package's iterate knows: "blocks" (the hand
#: kernel over resident blocks), the hand RDMA ring chained to it or fused
#: with it, and "xla" (the torch-op formulation)
STENCIL_TIERS = ("blocks", "rdma-chained", "rdma-fused", "xla")

# The JAX package's shipped schedule priors (tpu_mpi_tests/tune/priors.py
# :55-56,67), taken as they are: S=2 resident blocks for float32, the
# dim-1 single buffer (S=0) for bfloat16, k=4 timesteps per pass, the
# "blocks" tier. They were measured on a TPU; the card's own priors are
# a ROADMAP open item.
PRIOR_BLOCKS = {"float32": 2, "bfloat16": 0}
PRIOR_STEPS = 4
PRIOR_TIER = "blocks"


def check_tier(tier: str) -> str:
    """``tier`` if it names a stencil tier; raise otherwise."""
    if tier not in STENCIL_TIERS:
        raise TpuMtError(
            f"unknown stencil tier {tier!r}; valid: {STENCIL_TIERS}"
        )
    return tier


class Staging(enum.Enum):
    """Halo staging modes (≅ the JAX enum; the reference's ``buf`` flag):
    ``PALLAS_RDMA`` ("pallas") is the hand RDMA ring, ``hand.ring_halo``.
    The tuned ``auto`` mode is ROADMAP queue 1 item 17."""

    DIRECT = "direct"
    DEVICE_STAGED = "device"
    HOST_STAGED = "host"
    PALLAS_RDMA = "pallas"

    @classmethod
    def parse(cls, s: "str | Staging") -> "Staging":
        if isinstance(s, Staging):
            return s
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


def _write_ghosts(z: torch.Tensor, axis: int, n_bnd: int, from_left,
                  from_right) -> torch.Tensor:
    """Arrived bands into the ghost bands (a None side keeps its
    physical ghosts); returns ``z``."""
    n = z.shape[axis]
    if from_left is not None:
        z.narrow(axis, 0, n_bnd).copy_(from_left)
    if from_right is not None:
        z.narrow(axis, n - n_bnd, n_bnd).copy_(from_right)
    return z


def exchange_shard(z: torch.Tensor, *, axis: int = 0, n_bnd: int = 2,
                   periodic: bool = False, staged: bool = False,
                   kernel: str = "torch",
                   ring: "Ring | None" = None) -> torch.Tensor:
    """Halo exchange of this rank's ghosted block, in place (≅ the JAX
    ``exchange_shard``): the interior edge bands go to the ±1 ring
    neighbours and the received bands land in the ghost bands; the ends of
    a non-periodic ring keep their physical ghosts.

    ``ring`` is the axis's ring (default: the world's, ``make_mesh()``).
    A ring of one rank: non-periodic, nothing moves (and nothing
    launches); periodic, lo ghost ← hi interior edge, hi ghost ← lo
    interior edge. More ranks: one ``Ring.sendrecv`` to the ring's
    neighbours.

    ``staged`` packs both edges into contiguous buffers first (≅
    DEVICE_STAGED, the reference's ``buf_from_view``/``buf_to_view``):
    with ``kernel="torch"`` by ``clone``/``copy_``, with ``kernel="hand"``
    by the CUDA kernels ``hand.pack_edges`` and ``hand.unpack_ghosts``
    (one launch each; a 2-D block). A strided band (axis 1) is packed
    before any send whatever ``staged`` says; ``kernel`` changes nothing
    when neither applies."""
    _check_kernel("exchange_shard", kernel)
    ring = make_mesh() if ring is None else ring
    if ring.size > 1:
        return _exchange_ring(z, ring, axis, n_bnd, periodic, staged, kernel)
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


def _exchange_ring(z, ring, axis, n_bnd, periodic, staged, kernel):
    """The world > 1 leg of :func:`exchange_shard`."""
    n = z.shape[axis]
    hand_pack = kernel == "hand" and z.dim() == 2 and (staged or axis == 1)
    if hand_pack:
        lo_edge, hi_edge = hand.pack_edges(z, axis, n_bnd)
    elif staged or not z.narrow(axis, n_bnd, n_bnd).is_contiguous():
        lo_edge, hi_edge = _pack.pack_edges(z, axis, n_bnd)
    else:  # rows of a row-major block: the bands are contiguous views
        lo_edge = z.narrow(axis, n_bnd, n_bnd)
        hi_edge = z.narrow(axis, n - 2 * n_bnd, n_bnd)
        if n < 3 * n_bnd:
            lo_edge, hi_edge = lo_edge.clone(), hi_edge.clone()
    from_left, from_right = ring.sendrecv(lo_edge, hi_edge, periodic)
    if hand_pack:
        # the unpack kernel writes both bands: a side that received nothing
        # gets its own physical ghosts back
        if from_left is None:
            from_left = z.narrow(axis, 0, n_bnd).clone(
                memory_format=torch.contiguous_format)
        if from_right is None:
            from_right = z.narrow(axis, n - n_bnd, n_bnd).clone(
                memory_format=torch.contiguous_format)
        return hand.unpack_ghosts(z, from_left, from_right, axis, n_bnd)
    return _write_ghosts(z, axis, n_bnd, from_left, from_right)


def _host_staged_exchange(z: torch.Tensor, axis: int, n_bnd: int,
                          periodic: bool) -> torch.Tensor:
    """Edge bands round-trip through host memory (≅ the reference's
    ``stage_host`` paths): only the two bands touch the host; at world > 1
    the host copies travel over the gloo group."""
    ring = make_mesh()
    if not periodic and ring.size == 1:
        return z
    lo_edge, hi_edge = (t.cpu() for t in _pack.pack_edges(z, axis, n_bnd))
    if ring.size == 1:
        from_left, from_right = hi_edge, lo_edge
    else:
        from_left, from_right = ring.sendrecv(lo_edge, hi_edge, periodic)
    return _write_ghosts(z, axis, n_bnd, from_left, from_right)


def halo_exchange(zg: torch.Tensor, axis: int = 0, n_bnd: int = 2,
                  periodic: bool = False,
                  staging: "Staging | str" = Staging.DIRECT,
                  kernel: str = "torch") -> torch.Tensor:
    """Exchange the ghost bands of this rank's ghosted block (in place;
    returns ``zg``). ``kernel="hand"`` stages the DEVICE_STAGED bands
    through the CUDA pack/unpack kernels (:func:`exchange_shard`).
    ``PALLAS_RDMA`` is one ``hand.ring_halo`` launch (≅
    ``_exchange_pallas_fn``; world=1 non-periodic still launches and no
    store fires, as in the JAX package); at world > 1 on the card ``zg``
    must live in peer memory (:func:`staging_buffer`)."""
    staging = Staging.parse(staging)
    _check_kernel("halo_exchange", kernel)
    if staging is Staging.HOST_STAGED:
        return _host_staged_exchange(zg, axis, n_bnd, periodic)
    if staging is Staging.PALLAS_RDMA:
        return hand.ring_halo(zg, axis=axis, n_bnd=n_bnd, periodic=periodic)
    return exchange_shard(zg, axis=axis, n_bnd=n_bnd, periodic=periodic,
                          staged=staging is Staging.DEVICE_STAGED,
                          kernel=kernel)


def staging_buffer(zg: torch.Tensor,
                   staging: "Staging | str") -> torch.Tensor:
    """``zg`` where :func:`halo_exchange` with ``staging`` can exchange it
    in place: for ``PALLAS_RDMA`` a copy in the ring's peer memory
    (``PeerRing.empty``; collective at world > 1), for every other
    staging ``zg`` itself. A driver calls it once, when it makes its
    shard."""
    if Staging.parse(staging) is not Staging.PALLAS_RDMA:
        return zg
    out = peer_ring(zg.device).empty(zg.shape, zg.dtype)
    return out.copy_(zg)


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


def exchange2d(z: torch.Tensor, n_bnd: int, periodic: bool,
               grid: "Grid | None" = None,
               kernel: str = "torch") -> torch.Tensor:
    """Both-axis exchange of this rank's both-axes-ghosted block, in
    place, on ``grid`` (default: the 1×1 grid): axis 0 over the column
    ring first, then axis 1 over the row ring with bands the full height
    of the block, ghost rows included — the order of the JAX bodies
    (``halo.py:1228-1229``), which brings the corner ghosts from the
    diagonal neighbour in two hops. ``kernel`` passes through to
    :func:`exchange_shard`: with ``"hand"`` a strided axis-1 band that
    leaves the rank goes through the pack and unpack kernels."""
    grid = make_grid(1, 1) if grid is None else grid
    exchange_shard(z, axis=0, n_bnd=n_bnd, periodic=periodic, kernel=kernel,
                   ring=grid.x)
    return exchange_shard(z, axis=1, n_bnd=n_bnd, periodic=periodic,
                          kernel=kernel, ring=grid.y)


def heat_step2d_fn(n_bnd: int, cx: float, cy: float, steps: int = 1,
                   kernel: str = "torch", grid: "Grid | None" = None):
    """``run(z, n_outer)``: ``n_outer`` bodies of the heat mini-app on
    the periodic process grid ``grid`` (default: 1×1; ≅
    ``heat_step2d_fn``, ``halo.py:1371``) — per body a periodic exchange
    on axis 0, then on axis 1 (:func:`exchange2d`), then ``steps``
    explicit-Euler updates over the maximal span of this rank's block.
    ``steps=k`` is temporal blocking: ghost width ``n_bnd >= k``, one
    exchange per k steps. ``kernel="torch"`` updates in place with torch
    ops (the XLA body); ``"hand"`` launches the CUDA kernel once per body
    on two ping-ponged buffers and returns whichever holds the result."""
    if n_bnd < steps:
        raise TpuMtError(
            f"heat_step2d_fn: ghost width n_bnd={n_bnd} must be >= "
            f"steps={steps} (one Laplacian radius per fused timestep)"
        )
    _check_kernel("heat_step2d_fn", kernel)
    grid = make_grid(1, 1) if grid is None else grid

    def run(z: torch.Tensor, n_outer: int) -> torch.Tensor:
        spare = torch.empty_like(z) if kernel == "hand" else None
        for _ in range(n_outer):
            exchange2d(z, n_bnd, True, grid, kernel)
            if kernel == "hand":
                out = hand.heat2d(z, cx, cy, steps=steps, out=spare)
                z, spare = out, z
            else:
                heat2d_steps_(z, cx, cy, steps)
        return z

    return run


def step2d_fn(n_bnd: int, scale_x: float, scale_y: float,
              kernel: str = "torch", grid: "Grid | None" = None):
    """``step(z) -> (dz_dx, dz_dy, residual)``: the 2-D process grid's
    full step on ``grid`` (default: 1×1; ≅ ``step2d_fn``,
    ``halo.py:1185``) — non-periodic exchanges on both axes (the grid's
    edge blocks keep the physical ghosts from init; on the 1×1 grid
    nothing moves), both-axis derivatives and the residual of this
    rank's block (``kernel="torch"``: torch ops; ``"hand"``: the CUDA
    kernel, one read for all three), then the residual summed over the
    whole grid (≅ ``lax.psum(residual, (axis_x, axis_y))``)."""
    _check_kernel("step2d_fn", kernel)
    dual = hand.dual_dim_step if kernel == "hand" else dual_dim_step
    grid = make_grid(1, 1) if grid is None else grid

    def step(z: torch.Tensor):
        exchange2d(z, n_bnd, False, grid, kernel)
        dz_dx, dz_dy, residual = dual(z, n_bnd, scale_x, scale_y)
        if grid.size > 1:  # a grid of several ranks is the world
            residual = allreduce_sum(residual.reshape(1))[0]
        return dz_dx, dz_dy, residual

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


def _phys_kwargs(ring, periodic: bool, device, side=(True, True)):
    """The iterate kernel's flags for this rank (≅ ``halo.py:735-752``):
    static on a periodic ring ((0, 0)) and at world=1 ((1, 1)); at
    world > 1 dynamic, a device int pair, since whether a side is
    physical depends on the rank. ``side`` masks the flags of a block that
    owns only one of the shard's ends (the resident-block schedule)."""
    if periodic:
        return {"phys_static": (0, 0)}
    if ring.size == 1:
        return {"phys_static": tuple(int(s) for s in side)}
    lo, hi = ring.phys(periodic)
    flags = [lo if side[0] else 0, hi if side[1] else 0]
    return {"phys": torch.tensor(flags, dtype=torch.int32, device=device)}


def iterate_hand_fn(n_bnd: int, scale_eps: float, axis: int = 1,
                    steps: int = 1, periodic: bool = False,
                    rdma: bool = False):
    """k-step hand-kernel iterate on one buffer (≅ ``iterate_pallas_fn``):
    per outer iteration one exchange of the k·N_BND-deep ghosts and one
    kernel launch advancing k timesteps. ``n_iter`` counts outer
    iterations (= n_iter·k timesteps). Flags: static on a periodic ring
    and at world=1, dynamic (a device pair) on a non-periodic ring at
    world > 1, where only the ring's ends are physical.

    ``rdma=True`` swaps the exchange for the hand RDMA ring
    (``hand.ring_halo``, ≅ ``iterate_pallas_fn(rdma=True)``): the
    ``rdma-chained`` tier, 100 % hand kernels; its two buffers are a pair
    in peer memory (``PeerRing.pair``) and the result is one of them."""
    _check_deep("iterate_hand_fn", n_bnd, steps)

    def run(z: torch.Tensor, n_iter: int) -> torch.Tensor:
        ring = make_mesh()
        flags = _phys_kwargs(ring, periodic, z.device)
        if rdma:
            z, spare = peer_ring(z.device).pair(z)
        else:
            spare = torch.empty_like(z)
        for _ in range(n_iter):
            if rdma:
                hand.ring_halo(z, axis=axis, n_bnd=n_bnd, periodic=periodic)
            else:
                exchange_shard(z, axis=axis, n_bnd=n_bnd, periodic=periodic)
            out = stencil2d_iterate(z, scale_eps, dim=axis, steps=steps,
                                    out=spare, **flags)
            z, spare = out, z
        return z

    return run


def iterate_fused_rdma_fn(n_bnd: int, scale_eps: float, axis: int = 0,
                          steps: int = 1, periodic: bool = False,
                          tile_rows: "int | None" = None,
                          local_only: bool = False):
    """The one-launch fused tier (≅ ``iterate_fused_rdma_fn``,
    ``halo.py:803``): per outer iteration ONE ``hand.stencil2d_fused_rdma``
    launch stores the edge bands into the neighbours' ghosts while the
    interior row blocks advance k timesteps, then finishes the seam
    blocks — no ghost-byte round trip through device memory between an
    exchange kernel and a compute kernel. Bitwise equal to
    ``iterate_hand_fn(axis=0, rdma=True)``.

    Dim 0 only (the fused schedule is a row-block stream); deep ghosts as
    ever (``n_bnd = k·N_BND``). A 1-shard non-periodic ring degenerates to
    the pure compute pass; ``local_only=True`` forces that compute-only
    twin on any ring — the baseline :func:`fused_overlap_record` prices
    the seam wait against (its ghosts are then fixed bands, so its VALUES
    mean something only on a 1-shard ring). ``tile_rows`` caps the row
    block (``hand.fused_block_rows``)."""
    if axis != 0:
        raise TpuMtError(
            "iterate_fused_rdma_fn: the fused tier streams row blocks — "
            "dim-0 decomposition only (decompose the other way or use "
            "iterate_hand_fn)"
        )
    _check_deep("iterate_fused_rdma_fn", n_bnd, steps)

    def run(z: torch.Tensor, n_iter: int) -> torch.Tensor:
        ring = make_mesh()
        pure_compute = local_only or (ring.size == 1 and not periodic)
        flags = _phys_kwargs(ring, periodic, z.device)
        z, spare = peer_ring(z.device).pair(z)
        for _ in range(n_iter):
            out = hand.stencil2d_fused_rdma(
                z, scale_eps, steps=steps, periodic=periodic,
                tile_rows=tile_rows, local_only=pure_compute, out=spare,
                **flags)
            z, spare = out, z
        return z

    return run


def fused_overlap_record(op: str, *, steps: int, fused_s: float,
                         compute_s: float, world: int, **extra) -> dict:
    """The fused tier's ``kind: "overlap"`` record (≅
    ``fused_overlap_record``, ``halo.py:924``, the same fields):
    ``fused_s`` is the host-bracketed wall time of the one-launch fused
    runner, ``compute_s`` that of its compute-only twin
    (``iterate_fused_rdma_fn(local_only=True)`` — the same kernel and
    geometry, the exchange compiled out). Their difference is the
    SEAM-WAIT cost (barrier, sends, arrival waits and whatever the
    interior failed to hide); ``overlap_frac = 1 − seam_wait/total`` and
    ``drain_s`` carries the seam wait."""
    seam_wait = max(0.0, float(fused_s) - float(compute_s))
    frac = (1.0 - seam_wait / fused_s) if fused_s > 0 else 0.0
    return {
        "kind": "overlap",
        "op": op,
        "depth": 2,
        "steps": steps,
        "overlap_frac": frac,
        "comm_s": float(fused_s),
        "compute_s": float(compute_s),
        "drain_s": seam_wait,
        "world": world,
        "tier": "rdma-fused",
        **extra,
    }


def iterate_hand_blocks_fn(n_blocks: int, n_bnd: int, scale_eps: float,
                           steps: int = 1, periodic: bool = False):
    """k-step iterate over ``n_blocks`` resident row blocks (dim 0) per
    rank — ≅ ``iterate_pallas_blocks_fn`` (``mesh=None`` at world=1, the
    rank's shard of the mesh otherwise). Per outer iteration the blocks'
    ghost bands are refreshed from their neighbours' interiors, then each
    block takes one kernel launch. The two OUTERMOST ghost bands (block
    0's top, block S−1's bottom) come from the ring: at world=1 the
    periodic self-ring wraps block 0 and block S−1; at world > 1 they ride
    ``Ring.sendrecv`` to the neighbour ranks, whose ends keep their
    physical ghosts on a non-periodic ring (dynamic flags on the edge
    blocks). Every refresh source is an interior row, disjoint from every
    ghost band, so refreshing in place equals the JAX function's
    read-everything-first order.

    ``run(state, n_iter)`` takes and returns a tuple of S blocks
    ``(H/S + 2·n_bnd, W)`` (:func:`split_blocks` / :func:`merge_blocks`)."""
    _check_deep("iterate_hand_blocks_fn", n_bnd, steps)
    if n_blocks < 2:
        raise TpuMtError(
            f"iterate_hand_blocks_fn: n_blocks={n_blocks} < 2 — use "
            f"iterate_hand_fn for the single-buffer schedule"
        )
    S, K = n_blocks, n_bnd

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
        ring = make_mesh()
        device = blocks[0].device
        flags = [_phys_kwargs(ring, periodic, device,
                              side=(s == 0, s == S - 1)) for s in range(S)]
        spares = [torch.empty_like(b) for b in blocks]
        for _ in range(n_iter):
            outer = (None, None)
            if ring.size > 1:  # the shard's edges to the neighbour ranks
                outer = ring.sendrecv(blocks[0][K:2 * K].contiguous(),
                                      blocks[S - 1][hb:hb + K].contiguous(),
                                      periodic)
            for s in range(1, S):  # top ghost ← upper block's last rows
                blocks[s][0:K].copy_(blocks[s - 1][hb:hb + K])
            for s in range(S - 1):  # bottom ghost ← lower block's first
                blocks[s][hb + K:hb + 2 * K].copy_(blocks[s + 1][K:2 * K])
            if ring.size > 1:
                if outer[0] is not None:
                    blocks[0][0:K].copy_(outer[0])
                if outer[1] is not None:
                    blocks[S - 1][hb + K:hb + 2 * K].copy_(outer[1])
            elif periodic:  # world=1 self-ring across the block tuple
                blocks[0][0:K].copy_(blocks[S - 1][hb:hb + K])
                blocks[S - 1][hb + K:hb + 2 * K].copy_(blocks[0][K:2 * K])
            for s in range(S):
                out = stencil2d_iterate(
                    blocks[s], scale_eps, dim=0, steps=steps,
                    out=spares[s], **flags[s],
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
