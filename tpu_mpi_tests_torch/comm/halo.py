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
a Python loop of launches, which ``chain_rate`` captures into a CUDA
graph on the card (no host wait or read inside a runner):

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

The overlap engine (≅ ``halo.py:1495-1905``): :class:`OverlapRunner`
runs one pipelined step — at depth 2 the exchange in flight on a comm
stream of its own while the core computes on the current stream — and
:func:`overlap_jacobi_fns`, :func:`heat_overlap_fns` and
:func:`grid_overlap_fns` split the 1-D Jacobi, heat and grid bodies into
``(exchange_nod, core, seam)``; :func:`overlap_steps` chains a pipeline
on two ping-ponged buffers. :func:`iterate_overlap_fn` is the bench's
overlap schedule around the hand iterate kernel.
"""

from __future__ import annotations

import contextlib
import enum
import functools
import sys
import time

import torch

from tpu_mpi_tests_torch.comm import dist
from tpu_mpi_tests_torch.comm.collectives import allreduce_sum
from tpu_mpi_tests_torch.comm.mesh import Grid, Hop, Ring, make_grid, \
    make_mesh
from tpu_mpi_tests_torch.comm.peer import peer_ring
from tpu_mpi_tests_torch.comm.topology import mesh_partner_links
from tpu_mpi_tests_torch.instrument.telemetry import (
    armed as telemetry_armed,
    async_span,
    span_call,
)
from tpu_mpi_tests_torch.instrument.timers import block_stream, stream_event
from tpu_mpi_tests_torch.instrument.watchdog import note_comm_op
from tpu_mpi_tests_torch.kernels import hand
from tpu_mpi_tests_torch.kernels import pack as _pack
from tpu_mpi_tests_torch.kernels.hand import stencil2d_deriv, \
    stencil2d_iterate
from tpu_mpi_tests_torch.kernels.stencil import (
    N_BND,
    STENCIL5,
    coef,
    dual_dim_step,
    heat2d_steps_,
    stencil1d_5,
)
from tpu_mpi_tests_torch.tune import priors as _priors
from tpu_mpi_tests_torch.tune import registry as _tune
from tpu_mpi_tests_torch.tune.registry import declare_space
from tpu_mpi_tests_torch.utils import TpuMtError, check_divisible

#: every kernel tier the JAX package's iterate knows: "blocks" (the hand
#: kernel over resident blocks), the hand RDMA ring chained to it or fused
#: with it, and "xla" (the torch-op formulation)
STENCIL_TIERS = ("blocks", "rdma-chained", "rdma-fused", "xla")


def _prior_first(prior, values) -> tuple:
    return (prior,) + tuple(v for v in values if v != prior)


#: the halo exchange schedule space (≅ JAX ``halo.py:81``): staging and
#: exchange flavour in one knob — direct and device ride the process
#: group, pallas is the hand RDMA ring (HOST_STAGED is a measurement
#: mode, never a candidate)
HALO_STAGING_SPACE = declare_space(
    "halo/staging",
    _prior_first(_priors.HALO_STAGING, ("direct", "device", "pallas")),
    describe="halo staging strategy + process-group-vs-RDMA exchange "
             "flavour",
)

#: the k-step hot loop's resident-block count (0 = the dim-1 single
#: buffer) and temporal-blocking depth; the f32 prior leads, the bf16
#: prior comes from the same table where a site knows its dtype
STENCIL_BLOCKS_SPACE = declare_space(
    "stencil/blocks",
    _prior_first(_priors.BENCH_BLOCKS["float32"], (2, 0, 4)),
    describe="resident row-block count per shard (0 = single buffer)",
)
STENCIL_STEPS_SPACE = declare_space(
    "stencil/steps",
    _prior_first(_priors.BENCH_STEPS, (4, 2, 8, 1)),
    describe="temporal-blocking depth (timesteps fused per HBM pass)",
)

#: the kernel tier of the stencil iterate hot loop (≅ JAX ``halo.py:111``)
STENCIL_TIER_SPACE = declare_space(
    "stencil/tier",
    _prior_first(_priors.STENCIL_TIER["float32"], STENCIL_TIERS),
    describe="kernel tier of the stencil iterate hot loop: blocks / "
             "chained RDMA / one-launch fused RDMA / torch ops",
)


def stencil_tier_candidates(dtype: "str | None") -> tuple:
    """The tier candidates for ``dtype``, its prior first."""
    return _prior_first(_priors.stencil_tier(dtype), STENCIL_TIERS)


def stencil_blocks_candidates(dtype: "str | None") -> tuple:
    """The block-count candidates for ``dtype``, its prior first."""
    return _prior_first(_priors.bench_blocks(dtype),
                        STENCIL_BLOCKS_SPACE.candidates)


def rdma_refusal() -> "str | None":
    """Why this world cannot run the hand RDMA tiers, or None. On the
    card they need one host and a card per rank: symmetric memory maps
    peers within one host and refuses two ranks on one card. The CPU's
    plain versions run at any world."""
    w = dist.world()
    if w.device.type != "cuda" or w.size == 1:
        return None
    if w.hosts > 1:
        return f"{w.hosts} hosts (the RDMA ring maps peers within one)"
    n_cards = torch.cuda.device_count()
    if w.ranks_per_host > n_cards:
        return (f"{w.ranks_per_host} ranks on {n_cards} card(s) (the RDMA "
                f"ring needs a card per rank)")
    return None


def resolve_stencil_tier(explicit=None, **ctx) -> str:
    """The kernel tier of the stencil iterate: ``explicit`` > the cached
    winner > the dtype's prior (``tune.priors.STENCIL_TIER``; ≅ JAX
    ``halo.py:125``). Context-sensitive (no device-only fallback); a
    malformed cached value gives the prior. A resolved RDMA tier that
    this world cannot run (:func:`rdma_refusal`) resolves to
    ``tune.priors.STENCIL_TIER_NO_RDMA``, and the resolution is printed
    (≅ the JAX degrade rule, ``comm/ring.py:239-250``); an explicit tier
    is never changed."""
    prior = _priors.stencil_tier(ctx.get("dtype"))
    if explicit is not None:
        return check_tier(explicit)
    val = _tune.resolve("stencil/tier", prior=prior,
                        device_fallback=False, **ctx)
    if val not in STENCIL_TIERS:
        val = prior
    why = rdma_refusal() if val.startswith("rdma") else None
    if why is not None:
        print(f"NOTE stencil/tier {val} cannot run here ({why}); resolved "
              f"-> {_priors.STENCIL_TIER_NO_RDMA}", file=sys.stderr,
              flush=True)
        val = _priors.STENCIL_TIER_NO_RDMA
    return val


def resolve_stencil_blocks(explicit=None, **ctx) -> int:
    """The resident-block count: ``explicit`` > cached > the dtype's
    prior (``tune.priors.BENCH_BLOCKS``); context-sensitive, a malformed
    cached value gives the prior."""
    prior = _priors.bench_blocks(ctx.get("dtype"))
    val = _tune.resolve("stencil/blocks", explicit=explicit, prior=prior,
                        device_fallback=False, **ctx)
    try:
        return max(0, int(val))
    except (TypeError, ValueError):
        return prior


def resolve_stencil_steps(explicit=None, **ctx) -> int:
    """The temporal-blocking depth: ``explicit`` > cached > prior
    (``tune.priors.BENCH_STEPS``); context-sensitive, a malformed cached
    value gives the prior."""
    val = _tune.resolve("stencil/steps", explicit=explicit,
                        prior=_priors.BENCH_STEPS, device_fallback=False,
                        **ctx)
    try:
        return max(1, int(val))
    except (TypeError, ValueError):
        return _priors.BENCH_STEPS


#: the halo pipeline depth (≅ JAX ``halo.py:143``): 1 = the serialized
#: exchange-then-update schedule, 2 = the exchange in flight under the
#: core
HALO_OVERLAP_SPACE = declare_space(
    "halo/overlap",
    (_priors.HALO_OVERLAP_DEPTH, 2),
    describe="halo pipeline depth: 1 = serialized, 2 = exchange in "
             "flight under the interior compute",
)


def resolve_overlap_depth(explicit=None, **ctx) -> int:
    """The halo pipeline depth to run: ``explicit`` > cached winner >
    prior (``tune.priors.HALO_OVERLAP_DEPTH``, 1), clamped to [1, 2] (≅
    JAX ``halo.py:153``). Context-sensitive; a value that is not an
    integer gives the prior."""
    val = _tune.resolve("halo/overlap", explicit=explicit,
                        prior=_priors.HALO_OVERLAP_DEPTH,
                        device_fallback=False, **ctx)
    try:
        depth = int(val)
    except (TypeError, ValueError):
        depth = _priors.HALO_OVERLAP_DEPTH
    return max(1, min(depth, 2))


def check_tier(tier: str) -> str:
    """``tier`` if it names a stencil tier; raise otherwise."""
    if tier not in STENCIL_TIERS:
        raise TpuMtError(
            f"unknown stencil tier {tier!r}; valid: {STENCIL_TIERS}"
        )
    return tier


class Staging(enum.Enum):
    """Halo staging modes (≅ the JAX enum; the reference's ``buf`` flag):
    ``PALLAS_RDMA`` ("pallas") is the hand RDMA ring, ``hand.ring_halo``;
    ``AUTO`` resolves through the schedule cache (:func:`resolve_staging`:
    the tuned winner for this configuration, else the DIRECT prior)."""

    DIRECT = "direct"
    DEVICE_STAGED = "device"
    HOST_STAGED = "host"
    PALLAS_RDMA = "pallas"
    AUTO = "auto"

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


def _staging_context(zg: torch.Tensor, axis: int, world: int) -> dict:
    """Cache context of the ``halo/staging`` knob (≅ JAX ``halo.py:170``):
    dtype, the decomposed extent (bucketed) and the ring size, shared by
    ``halo_exchange``'s AUTO resolution and the drivers' sweeps so the
    stored winner and the lookup compose one key. ``zg`` is this rank's
    ghosted block; the extent is the world's (``world`` blocks along
    ``axis``), the extent of the JAX package's global array."""
    return {
        "dtype": str(zg.dtype).removeprefix("torch."),
        "extent": int(zg.shape[axis]) * int(world),
        "world": int(world),
    }


def resolve_staging(staging: "Staging | str", zg: torch.Tensor, axis: int,
                    world: int) -> Staging:
    """``Staging.AUTO`` → the tuned winner for this configuration, else
    the DIRECT prior (≅ JAX ``halo.py:182``); a concrete mode passes
    through. A malformed cached value, AUTO itself or HOST_STAGED (a
    measurement mode a cache must never select) gives DIRECT."""
    staging = Staging.parse(staging)
    if staging is not Staging.AUTO:
        return staging
    val = _tune.resolve("halo/staging", prior=_priors.HALO_STAGING,
                        device_fallback=False,
                        **_staging_context(zg, axis, world))
    try:
        resolved = Staging.parse(val)
    except (TpuMtError, AttributeError):
        resolved = Staging.DIRECT
    if resolved in (Staging.AUTO, Staging.HOST_STAGED):
        resolved = Staging.DIRECT
    return resolved


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
                  kernel: str = "torch", window=None) -> torch.Tensor:
    """Exchange the ghost bands of this rank's ghosted block (in place;
    returns ``zg``). ``kernel="hand"`` stages the DEVICE_STAGED bands
    through the CUDA pack/unpack kernels (:func:`exchange_shard`).
    ``PALLAS_RDMA`` is one ``hand.ring_halo`` launch (≅
    ``_exchange_pallas_fn``; world=1 non-periodic still launches and no
    store fires, as in the JAX package); at world > 1 on the card ``zg``
    must live in peer memory (:func:`staging_buffer`).

    ``window`` (a ``collectives.DispatchWindow``) posts the DIRECT and
    DEVICE_STAGED exchange through its bounded in-flight window (≅ JAX
    ``:470``); None is the per-call path. HOST_STAGED (synchronous by
    construction) and PALLAS_RDMA ignore it. ``AUTO`` resolves first
    (:func:`resolve_staging`)."""
    _check_kernel("halo_exchange", kernel)
    world = make_mesh().size
    staging = resolve_staging(staging, zg, axis, world)
    if window is None and not telemetry_armed():
        # no span and no NaN check: nothing to describe
        return _exchange(zg, staging, axis, n_bnd, periodic, kernel, world)
    # the JAX span's payload (2 directions × one ghost band a neighbour
    # pair) and its rank-pair metadata: each rank sends one band to each
    # ring neighbour, ``partner_nbytes`` a directed edge; the link classes
    # of its two offsets (comm/topology.py) are {} on one host
    nbytes = halo_payload_bytes(zg, axis, world, n_bnd, periodic)
    pairs = world if periodic else world - 1
    partner_meta = ({"partners": [-1, 1], "periodic": periodic,
                     "partner_nbytes": nbytes // (2 * pairs),
                     **mesh_partner_links(None, "shard", (-1, 1), periodic)}
                    if pairs > 0 else {})
    args = (zg, staging, axis, n_bnd, periodic, kernel, world)
    if staging in _SPAN_OPS:
        return span_call(_SPAN_OPS[staging], _exchange, *args,
                         nbytes=nbytes, axis_name="shard", world=world,
                         **partner_meta)
    call = window.call if window is not None else span_call
    return call("halo_exchange", _exchange, *args, nbytes=nbytes,
                axis_name="shard", world=world, staging=staging.value,
                **partner_meta)


#: the span ops of the stagings that take no dispatch window
_SPAN_OPS = {Staging.HOST_STAGED: "halo_exchange_host",
             Staging.PALLAS_RDMA: "halo_exchange_rdma"}


def _exchange(zg, staging, axis, n_bnd, periodic, kernel, world):
    """One exchange under a resolved ``staging`` (:func:`halo_exchange`)."""
    if staging is Staging.HOST_STAGED:
        return _host_staged_exchange(zg, axis, n_bnd, periodic)
    if staging is Staging.PALLAS_RDMA:
        # a peer-store kernel waiting on a dead neighbour hangs silently:
        # note the launch so a watchdog fire can name it
        note_comm_op("ring_halo", axis=axis, n_bnd=n_bnd,
                     periodic=periodic, world=world, shape=zg.shape)
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


def exchange_stencil_fused_fn(axis: int, n_bnd: int, scale: float,
                              staged: bool = False):
    """Halo exchange + stencil as one callable (≅ JAX ``halo.py:1468``,
    the fused side of the split-vs-fused measurement): ``step(z)``
    exchanges ``z``'s ghost bands in place (DIRECT, or DEVICE_STAGED with
    ``staged``, the only stagings the JAX function takes) and returns the
    torch-op derivative, with no host sync between the two: the
    exchange's copies and sends and the stencil's launches queue back to
    back on the current stream (the JAX package compiles them into one
    program), and the caller waits once, after the stencil."""

    def step(z: torch.Tensor) -> torch.Tensor:
        exchange_shard(z, axis=axis, n_bnd=n_bnd, staged=staged)
        return stencil1d_5(z, scale=scale, axis=axis)

    return step


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
    phys = torch.empty(2, dtype=torch.int32, device=device)
    # filled on the device, not copied from the host: a chained runner's
    # body stays legal inside a CUDA graph capture
    phys[0].fill_(int(lo if side[0] else 0))
    phys[1].fill_(int(hi if side[1] else 0))
    return {"phys": phys}


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
            # a peer-store launch a step, each noted for the hang dump
            note = (f"ring_halo(axis={axis}, n_bnd={n_bnd}, "
                    f"periodic={periodic}, world={ring.size}, "
                    f"shape={tuple(z.shape)})")
        else:
            spare = torch.empty_like(z)
        for _ in range(n_iter):
            if rdma:
                note_comm_op(note, record=False)
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
        # a peer-store launch a step, each noted for the hang dump
        note = (f"stencil2d_fused_rdma(steps={steps}, periodic={periodic}, "
                f"world={ring.size}, shape={tuple(z.shape)})")
        for _ in range(n_iter):
            note_comm_op(note, record=False)
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


# ---------------------------------------------------------------------------
# The overlap engine (≅ ``halo.py:1495-1905``): the exchange in flight on a
# comm stream while the core computes, the seam patched after the drain
# ---------------------------------------------------------------------------


class OverlapRunner:
    """The comm/compute overlap engine for one pipelined phase (≅ the JAX
    ``OverlapRunner``): the reference's Irecv / compute the interior /
    Waitall / fill the boundary (``mpi_stencil2d_gt.cc:136-255``),
    scheduled from the host.

    Depth 1 (the serialized schedule): the exchange runs on the current
    stream and is waited for, then the core computes inside the phase.
    Depth ≥ 2, in the JAX order: open an async span; post the exchange on
    the runner's comm stream (made once per runner, after the current
    stream's work so far); compute the core on the current stream from
    the pre-exchange buffer and wait for it inside the phase
    (:func:`~tpu_mpi_tests_torch.instrument.timers.block_stream`: the
    core's stream alone, so the wait does not swallow the exchange);
    drain the exchange (``AsyncSpan.done`` on the comm stream's event);
    then the current stream waits on that event, so the caller's seam
    sees the arrived ghosts. On the CPU there are no streams: the same
    functions run in the same order with the same results.

    The split functions (:func:`overlap_jacobi_fns`,
    :func:`heat_overlap_fns`, :func:`grid_overlap_fns`) keep depth 2
    race-free on the card by this invariant: the exchange in flight reads
    only the edge bands and writes only the ghost cells of ``z``; the core
    reads no ghost cell and writes only into a buffer of its own, never
    ``z``; the seam reads ``ex`` (``z`` after the exchange) and writes the
    boundary frame and the ghosts into the core's buffer. Both depths run
    the same functions on the same inputs, so their results are equal bit
    for bit.

    Accounting, as in the JAX package: ``overlap_frac`` is the host-clock
    overlap of the exchange's span with the core's window over the core's
    seconds — SCHEDULE overlap, ≈ 1 at depth 2 by construction and
    exactly 0 at depth 1; ``drain_s`` is the measured hiding signal (~0:
    the exchange finished under the core); ``comm_s`` the span's width
    (post → drain). Only a device trace shows that the two streams ran at
    once (``gpu/trace_summary.py``'s ``overlap_ms``).

    The engine never puts a kernel whose CTAs wait on each other (the
    ring collectives, ``ring_halo``, ``oneshot``, the fused ring
    attention: grids at the occupancy API's resident count) on its comm
    stream: beside another kernel such a grid can hang. Its exchanges go
    through ``Ring.sendrecv`` or local copies, never PALLAS_RDMA."""

    def __init__(self, op: str, *, depth: int, nbytes: int = 0,
                 axis_name: "str | None" = None, world: int = 1,
                 timer=None, phase: str = "overlap_interior", **meta):
        self.op = op
        self.depth = max(1, int(depth))
        self.nbytes = int(nbytes)
        self.axis_name = axis_name
        self.world = world
        self.timer = timer
        self.phase = phase
        self.meta = meta
        self.comm_s = 0.0
        self.compute_s = 0.0
        self.overlap_s = 0.0
        self.drain_s = 0.0
        self.steps = 0
        #: the comm stream (card tensors, depth ≥ 2; made at the first
        #: step) and the steps whose exchange ran on it
        self.comm_stream = None
        self.streamed_steps = 0

    def _phase_ctx(self):
        if self.timer is not None:
            return self.timer.phase(self.phase)
        return contextlib.nullcontext()

    def step(self, exchange_fn, core_fn, z):
        """One pipeline step: returns ``(ex, core_out)``; the caller
        applies the seam to both. ``exchange_fn(z)`` exchanges ``z``'s
        ghosts in place and returns it (``ex``); ``core_fn`` computes from
        ``ex`` at depth 1 and from ``z`` at depth 2, equal where it reads
        since it taps no ghost."""
        if self.depth <= 1:
            ex = block_stream(span_call(self.op, exchange_fn, z,
                                        nbytes=self.nbytes,
                                        axis_name=self.axis_name,
                                        world=self.world, **self.meta))
            t0 = time.perf_counter()
            with self._phase_ctx():
                out = block_stream(core_fn(ex))
            self.compute_s += time.perf_counter() - t0
            self.steps += 1
            return ex, out

        h = async_span(self.op, nbytes=self.nbytes, axis_name=self.axis_name,
                       world=self.world, overlap_depth=self.depth,
                       **self.meta)
        ev = None
        if z.is_cuda:
            compute = torch.cuda.current_stream(z.device)
            if self.comm_stream is None:
                self.comm_stream = torch.cuda.Stream(device=z.device)
            self.comm_stream.wait_stream(compute)
            with torch.cuda.stream(self.comm_stream):
                ex = exchange_fn(z)
                ev = stream_event(ex)
            self.streamed_steps += 1
        else:
            ex = exchange_fn(z)
        t0 = time.perf_counter()
        with self._phase_ctx():
            # the deliberate sync of the region: the interior compute
            # must finish under its phase bracket, which IS the window
            # the exchange hides under; block_stream waits for the
            # core's own stream only, so the exchange stays in flight
            out = block_stream(core_fn(z))  # tpumt: ignore[TPM801]
        t1 = time.perf_counter()
        h.done(ev)
        if ev is not None:
            compute.wait_event(ev)
        self.compute_s += t1 - t0
        self.comm_s += h.mono_end - h.mono_start
        self.drain_s += h.drain_s
        self.overlap_s += max(0.0, min(h.mono_end, t1)
                              - max(h.mono_start, t0))
        self.steps += 1
        return ex, out

    @property
    def overlap_frac(self) -> float:
        return self.overlap_s / self.compute_s if self.compute_s else 0.0

    def annotate(self, timer=None) -> None:
        """Attach the measured overlap to the compute phase's JSONL
        ``time`` record (``PhaseTimer.annotate``)."""
        t = timer if timer is not None else self.timer
        if t is not None:
            t.annotate(self.phase, overlap_frac=self.overlap_frac,
                       comm_overlap_s=self.overlap_s,
                       overlap_depth=self.depth)

    def record(self, op: "str | None" = None, **extra) -> dict:
        """The ``kind: "overlap"`` JSONL record of this run (RECORDS.md's
        ``overlap`` row, the JAX fields)."""
        return {
            "kind": "overlap",
            "op": op or self.op,
            "depth": self.depth,
            "steps": self.steps,
            "overlap_frac": self.overlap_frac,
            "comm_s": self.comm_s,
            "compute_s": self.compute_s,
            "drain_s": self.drain_s,
            "world": self.world,
            **extra,
        }


def overlap_steps(runner: OverlapRunner, fns, z: torch.Tensor,
                  n_steps: int) -> torch.Tensor:
    """``n_steps`` steps of the pipeline ``fns = (exchange_nod, core,
    seam)`` under ``runner`` on two ping-ponged buffers (the cores are out
    of place): each step's core writes the buffer the previous step
    read. Returns the buffer that holds the result."""
    exchange_nod, core, seam = fns
    spare = torch.empty_like(z)
    for _ in range(n_steps):
        ex, zc = runner.step(exchange_nod,
                             functools.partial(core, out=spare), z)
        z, spare = seam(ex, zc), z
    return z


def _pipeline_staging(name: str, staging: "Staging | str") -> bool:
    """Whether a pipeline's exchange stages its bands (DEVICE_STAGED);
    raise for the stagings the engine cannot put in flight: PALLAS_RDMA
    (``ring_halo``'s CTAs wait on each other, and beside the core on
    another stream they can hang) and HOST_STAGED (synchronous by
    construction), and AUTO, which the caller resolves first
    (:func:`resolve_staging`)."""
    staging = Staging.parse(staging)
    if staging is Staging.AUTO:
        raise TpuMtError(f"{name}: resolve staging 'auto' first "
                         f"(resolve_staging)")
    if staging in (Staging.PALLAS_RDMA, Staging.HOST_STAGED):
        raise TpuMtError(
            f"{name}: the overlap engine exchanges through the process "
            f"group or local copies (direct or device staging), not "
            f"{staging.value!r}: the hand RDMA ring's CTAs wait on each "
            f"other and must not run beside another kernel, and host "
            f"staging is synchronous"
        )
    return staging is Staging.DEVICE_STAGED


def _check_radius(name: str, n_bnd: int) -> None:
    if n_bnd != N_BND:
        raise TpuMtError(
            f"{name}: n_bnd={n_bnd} must equal the stencil radius "
            f"({N_BND}) — the boundary strips are 3·radius windows"
        )


def _out(out, z):
    return torch.empty_like(z) if out is None else out


def overlap_jacobi_fns(axis: int, n_bnd: int, scale: float, eps: float,
                       periodic: bool = False,
                       staging: "Staging | str" = Staging.DIRECT):
    """The 1-D Jacobi pipeline (the :func:`iterate_fused_fn` body) split
    into ``(exchange_nod, core, seam)`` (≅ ``overlap_jacobi_fns``,
    ``halo.py:1656``):

    * ``exchange_nod(z)``: the ghost exchange over the world's ring, in
      place on ``z``'s ghost bands;
    * ``core(z, out=None)``: ``interior += eps·dz`` on the cells whose
      stencil touches no ghost, ``[2·n_bnd, N − 2·n_bnd)``, written into
      ``out`` (a new buffer when None);
    * ``seam(ex, zc)``: the two ``n_bnd``-wide strips from the arrived
      ghosts (windows of ``ex``) and the ghost bands, written into ``zc``;
      returns ``zc``.

    Per cell the arithmetic is :func:`iterate_fused_fn`'s, so the result
    equals it bit for bit. ``staging`` takes DIRECT or DEVICE_STAGED."""
    staged = _pipeline_staging("overlap_jacobi_fns", staging)
    _check_radius("overlap_jacobi_fns", n_bnd)
    nb = n_bnd

    def exchange_nod(z):
        return exchange_shard(z, axis=axis, n_bnd=nb, periodic=periodic,
                              staged=staged)

    def core(z, out=None):
        N = z.shape[axis]
        if N < 4 * nb + 1:
            raise TpuMtError(
                f"overlap_jacobi_fns: local ghosted extent {N} too small "
                f"for the interior/boundary split (need > {4 * nb})"
            )
        out = _out(out, z)
        # core cells [2nb, N-2nb) tap [nb, N-nb): no ghost
        dz = stencil1d_5(z.narrow(axis, nb, N - 2 * nb), scale=scale,
                         axis=axis)
        inner = z.narrow(axis, 2 * nb, N - 4 * nb)
        out.narrow(axis, 2 * nb, N - 4 * nb).copy_(inner + coef(eps, z) * dz)
        return out

    def seam(ex, zc):
        N = ex.shape[axis]
        e = coef(eps, ex)
        for lo, mid in ((0, nb), (N - 3 * nb, N - 2 * nb)):
            # strip [mid, mid+nb) taps the window [lo, lo+3nb) of ex
            dz = stencil1d_5(ex.narrow(axis, lo, 3 * nb), scale=scale,
                             axis=axis)
            zc.narrow(axis, mid, nb).copy_(ex.narrow(axis, mid, nb) + e * dz)
        # the ghost bands: the exchange's arrivals (the serial body
        # keeps them)
        zc.narrow(axis, 0, nb).copy_(ex.narrow(axis, 0, nb))
        zc.narrow(axis, N - nb, nb).copy_(ex.narrow(axis, N - nb, nb))
        return zc

    return exchange_nod, core, seam


def _lap(zz, ix, iy, jx, jy, cx, cy):
    """One Euler update of the window ``[ix:jx) × [iy:jy)`` from its ±1
    neighbours: :func:`heat2d_steps_`'s arithmetic on a sub-slab, op for
    op (≅ the JAX ``_lap``)."""
    mid = zz[ix:jx, iy:jy]
    d2x = zz[ix + 1:jx + 1, iy:jy] + zz[ix - 1:jx - 1, iy:jy] \
        - coef(2.0, zz) * mid
    d2y = zz[ix:jx, iy + 1:jy + 1] + zz[ix:jx, iy - 1:jy - 1] \
        - coef(2.0, zz) * mid
    return mid + coef(cx, zz) * d2x + coef(cy, zz) * d2y


def heat_overlap_fns(cx: float, cy: float, grid: "Grid | None" = None):
    """The heat pipeline (periodic both axes, ghost width 1, one Euler
    step per exchange — the torch body of :func:`heat_step2d_fn` at k=1)
    split into ``(exchange_nod, core, seam)`` (≅ ``heat_overlap_fns``,
    ``halo.py:1764``) on ``grid`` (default: 1×1): ``exchange_nod`` is
    :func:`exchange2d` in place; ``core(z, out=None)`` updates the cells
    at distance ≥ 2 from every edge of the block (no ghost tap) into
    ``out``; ``seam(ex, zc)`` writes the 1-wide frame from the arrived
    ghosts and the ghost rows and columns into ``zc``. Per cell the
    arithmetic is :func:`heat2d_steps_`'s: the result equals the torch
    heat runner at k=1 bit for bit."""
    grid = make_grid(1, 1) if grid is None else grid

    def exchange_nod(z):
        return exchange2d(z, 1, True, grid, "torch")

    def core(z, out=None):
        nx, ny = z.shape
        if min(nx, ny) < 5:
            raise TpuMtError(
                f"heat_overlap_fns: ghosted block {nx}x{ny} too small for "
                f"the interior/boundary split (need >= 5 a side)"
            )
        out = _out(out, z)
        out[2:nx - 2, 2:ny - 2] = _lap(z, 2, 2, nx - 2, ny - 2, cx, cy)
        return out

    def seam(ex, zc):
        nx, ny = ex.shape
        # the frame from the arrived ghosts: two full-width rows, then two
        # columns without the rows already written
        for ix, iy, jx, jy in ((1, 1, 2, ny - 1), (nx - 2, 1, nx - 1, ny - 1),
                               (2, 1, nx - 2, 2), (2, ny - 2, nx - 2, ny - 1)):
            zc[ix:jx, iy:jy] = _lap(ex, ix, iy, jx, jy, cx, cy)
        # ghost rows and columns as the exchange left them
        zc[0:1, :] = ex[0:1, :]
        zc[nx - 1:nx, :] = ex[nx - 1:nx, :]
        zc[:, 0:1] = ex[:, 0:1]
        zc[:, ny - 1:ny] = ex[:, ny - 1:ny]
        return zc

    return exchange_nod, core, seam


def grid_overlap_fns(n_bnd: int, scale_x: float, scale_y: float,
                     grid: "Grid | None" = None):
    """The grid step (the torch body of :func:`step2d_fn`) split into
    ``(exchange_nod, core, seam)`` (≅ ``grid_overlap_fns``,
    ``halo.py:1856``) on ``grid`` (default: 1×1): ``exchange_nod`` is the
    non-periodic :func:`exchange2d` in place; ``core(z, out=None)``
    computes both derivatives' rows and columns that tap no ghost (``dz_dx``
    rows ``[n_bnd, nxi − n_bnd)``, ``dz_dy`` columns alike, from the
    block's interior) into the full-size fields ``out = (dz_dx, dz_dy)``;
    ``seam(ex, dz_dx, dz_dy)`` completes the ``n_bnd``-wide frame rows and
    columns from the exchanged block and returns ``(dz_dx, dz_dy,
    residual)``, the residual summed over the whole grid. Per cell the
    arithmetic is the torch tier's: the result equals it bit for bit."""
    _check_radius("grid_overlap_fns", n_bnd)
    grid = make_grid(1, 1) if grid is None else grid
    nb = n_bnd

    def exchange_nod(z):
        return exchange2d(z, nb, False, grid, "torch")

    def core(z, out=None):
        nxg, nyg = z.shape
        nxi, nyi = nxg - 2 * nb, nyg - 2 * nb
        if min(nxi, nyi) < 2 * nb + 1:
            raise TpuMtError(
                f"grid_overlap_fns: interior {nxi}x{nyi} too small for the "
                f"interior/boundary split (need > {2 * nb} a side)"
            )
        if out is None:
            out = (z.new_empty((nxi, nyi)), z.new_empty((nxi, nyi)))
        dz_dx, dz_dy = out
        slab = z[nb:nxg - nb, nb:nyg - nb]  # interior on both axes
        dz_dx[nb:nxi - nb] = stencil1d_5(slab, scale=scale_x, axis=0)
        dz_dy[:, nb:nyi - nb] = stencil1d_5(slab, scale=scale_y, axis=1)
        return dz_dx, dz_dy

    def seam(ex, dz_dx, dz_dy):
        nxg, nyg = ex.shape
        nxi, nyi = nxg - 2 * nb, nyg - 2 * nb
        cols = slice(nb, nyg - nb)
        rows = slice(nb, nxg - nb)
        dz_dx[0:nb] = stencil1d_5(ex[0:3 * nb, cols], scale=scale_x, axis=0)
        dz_dx[nxi - nb:] = stencil1d_5(ex[nxg - 3 * nb:, cols],
                                       scale=scale_x, axis=0)
        dz_dy[:, 0:nb] = stencil1d_5(ex[rows, 0:3 * nb], scale=scale_y,
                                     axis=1)
        dz_dy[:, nyi - nb:] = stencil1d_5(ex[rows, nyg - 3 * nb:],
                                          scale=scale_y, axis=1)
        residual = torch.sum(torch.square(dz_dx)) \
            + torch.sum(torch.square(dz_dy))
        if grid.size > 1:  # a grid of several ranks is the world
            residual = allreduce_sum(residual.reshape(1))[0]
        return dz_dx, dz_dy, residual

    return exchange_nod, core, seam


def _iterate_strip(window: torch.Tensor, se, c1, c2, axis: int):
    """The middle ``N_BND`` cells of a ``3·N_BND`` window after one
    iterate step: the hand kernel's per-cell arithmetic (its plain
    version's, ``hand.stencil2d_iterate_ref``), so a patched strip equals
    the kernel's own bit for bit."""
    def w(off):
        return window.narrow(axis, N_BND + off, N_BND)

    return w(0) + se * (c1 * (w(1) - w(-1)) + c2 * (w(2) - w(-2)))


def _post_edges(z, ring, axis: int, nb: int, periodic: bool):
    """Post the edge bands toward the neighbours (≅ ``_receive_neighbors``,
    ``halo.py:245``): a :class:`~tpu_mpi_tests_torch.comm.mesh.Hop` at
    world > 1 (its ``wait`` gives ``(from_left, from_right)``), else that
    pair itself — at world 1 the periodic self-ring's edges (views: the
    schedule writes nothing into ``z``) or ``(None, None)``. Writes
    nothing into ``z``."""
    n = z.shape[axis]
    if ring.size == 1:
        if periodic:
            return (z.narrow(axis, n - 2 * nb, nb), z.narrow(axis, nb, nb))
        return None, None
    if z.narrow(axis, nb, nb).is_contiguous():
        lo, hi = z.narrow(axis, nb, nb), z.narrow(axis, n - 2 * nb, nb)
    else:
        lo, hi = _pack.pack_edges(z, axis, nb)
    return ring.sendrecv_start(lo, hi, periodic)


def _comm_stream(z: torch.Tensor, ring):
    """The overlap runner's comm stream: one on the card at world > 1;
    None at world 1, where nothing is in flight (the self-ring's edges
    are views of ``z``), so a fork and join would wrap no work. Such
    empty forks make a captured chain's instantiation superlinear in its
    length (``gpu/capture_cost.py`` times both at one commit)."""
    if z.is_cuda and ring.size > 1:
        return torch.cuda.Stream(device=z.device)
    return None


def iterate_overlap_fn(n_bnd: int, scale_eps: float, axis: int = 1,
                       periodic: bool = False):
    """The per-step iterate with the exchange in flight under the kernel
    (≅ ``iterate_overlap_fn``, ``halo.py:1248``) — the bench's overlap
    schedule. Per iteration:

    1. the edge bands are posted to the neighbours into receive buffers
       (on the card on a comm stream of the runner's, after the current
       stream's work so far); nothing is written into ``z``;
    2. the core: ``hand.stencil2d_iterate`` (one step) from ``z`` into
       the spare buffer on the current stream — its two boundary strips,
       computed from stale ghosts, are discarded;
    3. the current stream waits on the comm stream's event (the host
       does not), then the two ``n_bnd``-wide strips are patched from
       ``z``'s old-value windows and the arrived bands (the kernel's own
       arithmetic, :func:`_iterate_strip`), and the arrived ghosts written.

    The result equals :func:`iterate_hand_fn` at ``steps=1`` bit for bit
    (the JAX function's strips take ``stencil1d_5``'s arithmetic and
    agree to roundoff). ``n_bnd`` must be the stencil radius. No host
    wait inside the loop: ``chain_rate`` captures it into a CUDA graph.
    At world 1 no comm stream is forked (:func:`_comm_stream`)."""
    _check_radius("iterate_overlap_fn", n_bnd)
    nb = n_bnd

    def run(z: torch.Tensor, n_iter: int) -> torch.Tensor:
        ring = make_mesh()
        flags = _phys_kwargs(ring, periodic, z.device)
        spare = torch.empty_like(z)
        comm = _comm_stream(z, ring)
        se, c1, c2 = (coef(v, z) for v in (scale_eps, STENCIL5[3],
                                           STENCIL5[4]))
        for _ in range(n_iter):
            n = z.shape[axis]
            if comm is not None:
                compute = torch.cuda.current_stream(z.device)
                comm.wait_stream(compute)
                with torch.cuda.stream(comm):
                    posted = _post_edges(z, ring, axis, nb, periodic)
                    got = posted.wait() if isinstance(posted, Hop) \
                        else posted
                    ev = stream_event(z)
            else:
                posted = _post_edges(z, ring, axis, nb, periodic)
            out = stencil2d_iterate(z, scale_eps, dim=axis, steps=1,
                                    out=spare, **flags)
            if comm is None:
                got = posted.wait() if isinstance(posted, Hop) else posted
            else:
                compute.wait_event(ev)
                for t in got:
                    if t is not None:
                        t.record_stream(compute)
            from_left = z.narrow(axis, 0, nb) if got[0] is None else got[0]
            from_right = (z.narrow(axis, n - nb, nb) if got[1] is None
                          else got[1])
            lo = torch.cat([from_left, z.narrow(axis, nb, 2 * nb)], axis)
            hi = torch.cat([z.narrow(axis, n - 3 * nb, 2 * nb), from_right],
                           axis)
            out.narrow(axis, nb, nb).copy_(_iterate_strip(lo, se, c1, c2,
                                                          axis))
            out.narrow(axis, n - 2 * nb, nb).copy_(
                _iterate_strip(hi, se, c1, c2, axis))
            out.narrow(axis, 0, nb).copy_(from_left)
            out.narrow(axis, n - nb, nb).copy_(from_right)
            z, spare = out, z
        return z

    return run
