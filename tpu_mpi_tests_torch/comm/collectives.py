"""Collectives and shard placement (≅ the subset of
``tpu_mpi_tests/comm/collectives.py`` the stencil, grid and DAXPY drivers
and the bench use), over ``torch.distributed`` at world > 1 — one process
per rank, each holding its own block (the JAX functions' sharded global
array is the concatenation of the ranks' blocks). Card tensors go through
the world group (NCCL), host tensors through the gloo group
(``comm.dist.cpu_group``). At world=1 nothing communicates: the
allreduce is the identity, a gather copies the one shard.

The hand-kernel tiers (≅ JAX ``:363-684``) run the collectives through
the hand CUDA kernels (``kernels/hand.py``): :func:`all_gather_rdma` and
:func:`allreduce_rdma` through the ring all-gather and ring
reduce-scatter, :func:`all_gather_oneshot` and :func:`allreduce_oneshot`
through the one-shot kernel; :func:`reduce_scatter_sum` is the library
tier of the reduce-scatter. On the CPU the kernels' plain versions run
over the gloo group.

:class:`DispatchWindow` bounds how many chained ops run without a wait
(≅ JAX ``:87``); its depth is explicit or the prior
(:func:`resolve_dispatch_depth`).

Every public wrapper records a telemetry span (``instrument/telemetry``,
the JAX op names and payload conventions, counted over the global array:
this rank's block times the world), and the hand tiers note their
launch in the flight recorder first (``instrument/watchdog``).
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch
import torch.distributed as tdist

from tpu_mpi_tests_torch.comm import dist
from tpu_mpi_tests_torch.instrument import nans
from tpu_mpi_tests_torch.instrument.telemetry import (
    async_span,
    comm_span,
    span_call,
)
from tpu_mpi_tests_torch.instrument.timers import stream_event
from tpu_mpi_tests_torch.instrument.watchdog import note_comm_op
from tpu_mpi_tests_torch.tune import priors as _priors
from tpu_mpi_tests_torch.utils import TpuMtError, check_divisible


def resolve_dispatch_depth(explicit=None) -> int:
    """The dispatch-window depth: ``explicit``, else the prior (1); at
    least 1, and a value that is not an integer gives the prior (≅ JAX
    ``:60`` with an empty schedule cache). The JAX package's
    ``coll/dispatch_depth`` space and its ``collbench --tune`` sweep come
    with the window's one reader there, the serve halo handler (ROADMAP
    queue 1 item 19): a cached depth nothing in the port reads would
    price nothing."""
    val = _priors.COLL_DISPATCH_DEPTH if explicit is None else explicit
    try:
        depth = int(val)
    except (TypeError, ValueError):
        depth = _priors.COLL_DISPATCH_DEPTH
    return max(1, depth)


class DispatchWindow:
    """Bound the in-flight window of chained ops posted on one stream (≅
    JAX ``DispatchWindow``): up to ``depth`` calls run without a wait,
    then the window waits once. ``depth=1`` is :func:`span_call` per call,
    the per-call path unchanged; ``depth=None`` takes
    :func:`resolve_dispatch_depth`'s prior.

    Each call at depth ≥ 2 opens an async span and keeps the event
    recorded after the op on the current stream. The port's chains are
    in place (each call returns the tensor it was given), so the newest
    event vouches for every op before it on that stream: once ``depth``
    ops are in flight the window synchronizes it and closes every span,
    one wait per ``depth`` calls. On the CPU an op has finished when it
    returns and nothing is waited for. A context manager; exit drains.

    Its consumer, the serve halo handler (ROADMAP queue 1 item 19), is
    not ported: the tests hold it."""

    def __init__(self, depth: "int | None" = None):
        self.depth = resolve_dispatch_depth(depth)
        self._inflight: deque = deque()

    def call(self, op: str, fn, *args, nbytes: int = 0,
             axis_name: "str | None" = None, world: int = 1, **meta):
        """``fn(*args)`` under this window; returns its result."""
        if self.depth <= 1:
            return span_call(op, fn, *args, nbytes=nbytes,
                             axis_name=axis_name, world=world, **meta)
        handle = async_span(op, nbytes=nbytes, axis_name=axis_name,
                            world=world, dispatch_depth=self.depth, **meta)
        out = nans.check(op, fn(*args))
        self._inflight.append((handle, stream_event(out)))
        if len(self._inflight) >= self.depth:
            self.drain()
        return out

    def drain(self) -> None:
        """Wait for every op in flight and close its span; idempotent."""
        if not self._inflight:
            return
        newest = self._inflight[-1][1]
        while self._inflight:
            self._inflight.popleft()[0].done(newest)

    def __enter__(self) -> "DispatchWindow":
        return self

    def __exit__(self, *exc) -> None:
        self.drain()


def _group_for(t: torch.Tensor):
    return tdist.group.WORLD if t.is_cuda else dist.cpu_group()


def _gather_into(out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``out`` ← the ranks' ``x`` stacked along dim 0 (one collective)."""
    gather = getattr(tdist, "all_gather_single", None) \
        or tdist.all_gather_into_tensor
    gather(out, x.contiguous(), group=_group_for(x))
    return out


def shard_1d(arr, device, axis: int = 0) -> torch.Tensor:
    """This rank's block of a global array (numpy or tensor) along
    ``axis``, on ``device`` (≅ ``shard_1d``, :175; world=1: the whole
    array)."""
    t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(arr))
    w = dist.world()
    if w.size > 1:
        n = check_divisible(t.shape[axis], w.size, f"shard_1d axis {axis}")
        t = t.narrow(axis, w.rank * n, n).contiguous()
    return t.to(device)


def replicate(arr, device) -> torch.Tensor:
    """The same array on every rank (≅ ``replicate``, :184): rank 0's
    value, broadcast."""
    t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(arr))
    t = t.to(device).contiguous()
    if dist.world().size > 1:
        tdist.broadcast(t, src=0, group=_group_for(t))
    return t


def all_gather(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """``MPI_Allgather`` of each rank's block into a full copy per rank
    (≅ ``all_gather``, :329), the blocks concatenated along ``axis``: at
    world=1 a new tensor holding the one shard."""
    w = dist.world().size
    return span_call("all_gather", _all_gather, x, axis,
                     nbytes=_gather_payload_bytes(x, w), axis_name="shard",
                     world=w)


def _gather_payload_bytes(x: torch.Tensor, world: int) -> int:
    """The JAX payload convention of gather-like collectives: the bytes
    every rank receives, w−1 foreign blocks, summed over the ranks."""
    return (world - 1) * world * x.numel() * x.element_size()


def _row_bytes(per_rank: torch.Tensor) -> int:
    return per_rank.numel() * per_rank.element_size()


def _all_gather(x: torch.Tensor, axis: int) -> torch.Tensor:
    w = dist.world()
    if w.size == 1:
        return x.clone()
    xm = x.movedim(axis, 0)
    out = torch.empty((w.size * xm.shape[0],) + tuple(xm.shape[1:]),
                      dtype=x.dtype, device=x.device)
    return _gather_into(out, xm).movedim(0, axis)


def all_gather_inplace(allx: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """``MPI_Allgather(MPI_IN_PLACE)`` parity (≅ :459): ``allx`` is the
    full-size buffer whose own slice (block ``rank`` along ``axis``) each
    rank has filled; afterwards every slice holds its owner's values. The
    gathered buffer is ``allx`` itself (the JAX function donates its input
    for the same reason)."""
    w = dist.world().size
    return span_call("all_gather_inplace", _all_gather_inplace, allx, axis,
                     nbytes=(w - 1) * allx.numel() * allx.element_size(),
                     axis_name="shard", world=w)


def _all_gather_inplace(allx: torch.Tensor, axis: int) -> torch.Tensor:
    w = dist.world()
    if w.size == 1:
        return allx
    n = check_divisible(allx.shape[axis], w.size, "all_gather_inplace")
    mine = allx.narrow(axis, w.rank * n, n).clone()
    allx.copy_(_all_gather(mine, axis))
    return allx


def per_rank_sums(x: torch.Tensor, groups_per_shard: int = 1
                  ) -> np.ndarray:
    """Per-logical-rank local sums as a host numpy vector on every rank
    (≅ ``per_rank_sums``, :721; each rank's local checksum,
    ``mpi_daxpy_nvtx.cc:251-267``): this rank's block split into
    ``groups_per_shard`` equal logical ranks (the reference's
    ``ranks_per_device`` oversubscription, ``mpi_daxpy.cc:49-51``), each
    summed on the device in the array's dtype, then gathered."""
    check_divisible(x.shape[0], groups_per_shard, "per_rank_sums groups")
    sums = torch.sum(x.reshape(groups_per_shard, -1), dim=1)
    return host_value(all_gather(sums))


def gather_blocks(x: torch.Tensor) -> "list[np.ndarray] | None":
    """Every rank's ``x`` (one shape on every rank) on rank 0's host, in
    rank order, as numpy (:func:`host_value`); None on the other ranks.
    One ``gather`` to rank 0 over the group of ``x``'s device."""
    w = dist.world()
    if w.size == 1:
        return [host_value(x)]
    x = x.contiguous()
    got = [torch.empty_like(x) for _ in range(w.size)] if w.rank == 0 \
        else None
    tdist.gather(x, got, dst=0, group=_group_for(x))
    return None if got is None else [host_value(t) for t in got]


def barrier(device: torch.device) -> None:
    """≅ ``MPI_Barrier`` (:774): wait until this device has finished all
    queued work and, at world > 1, every rank has got there."""
    w = dist.world().size
    with comm_span("barrier", axis_name="shard", world=w):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        if w > 1:
            tdist.barrier(group=dist.cpu_group())


def shard_blocks(global_shape, dtype: torch.dtype, block_fn, device,
                 axis: int = 0) -> torch.Tensor:
    """This rank's block of a global array built from per-rank host
    blocks (≅ ``shard_blocks``, :188): ``block_fn(rank)`` (a numpy array
    of the global shape with ``axis`` divided by the world size), moved to
    ``device`` and cast to ``dtype`` — the global array is never built."""
    w = dist.world()
    want = list(global_shape)
    want[axis] = check_divisible(want[axis], w.size,
                                 f"shard_blocks axis {axis}")
    block = np.ascontiguousarray(block_fn(w.rank))
    if list(block.shape) != want:
        raise TpuMtError(
            f"shard_blocks: block shape {block.shape} != {tuple(want)}, the "
            f"global shape {tuple(global_shape)} split {w.size} ways along "
            f"axis {axis}"
        )
    return torch.from_numpy(block).to(device=device, dtype=dtype)


def device_init(block_fn) -> torch.Tensor:
    """This rank's block computed on its device (≅ ``device_init``,
    :236): ``block_fn(rank)``, a torch helper such as
    ``Domain2D.init_shard_torch``."""
    return block_fn(dist.world().rank)


def per_rank_err_norms(numeric: torch.Tensor, actual: torch.Tensor
                       ) -> np.ndarray:
    """Every rank's ``sqrt(Σ(numeric − actual)²)`` on every rank (≅
    ``per_rank_err_norms``, :286; each rank's err_norm,
    ``mpi_stencil_gt.cc:222``); the sum runs in the arrays' dtype on the
    device, as the JAX function's does, and only the per-rank sums move."""
    d = numeric - actual
    s = torch.sum(d * d).reshape(1)
    return np.sqrt(host_value(all_gather(s)).astype(np.float64).reshape(-1))


def allreduce_sum(per_rank: torch.Tensor) -> torch.Tensor:
    """In-place ``MPI_Allreduce(MPI_SUM)`` parity (≅ ``allreduce_sum``,
    :494): ``per_rank`` is this rank's row, shape (1, L); afterwards it
    holds the elementwise sum over the ranks' rows. The identity at
    world=1."""
    if per_rank.shape[0] != 1:
        raise TpuMtError(
            f"allreduce_sum: leading axis {per_rank.shape[0]} must be 1 "
            f"(this rank's row of the JAX function's (world, L) array)"
        )
    w = dist.world().size
    # the ring allreduce's payload: each rank moves 2(w−1)/w of its row,
    # 2(w−1) rows over the ranks
    return span_call("allreduce", allreduce_unrecorded, per_rank,
                     nbytes=2 * (w - 1) * _row_bytes(per_rank),
                     axis_name="shard", world=w)


def allreduce_unrecorded(per_rank: torch.Tensor) -> torch.Tensor:
    """:func:`allreduce_sum` without its telemetry span (≅ a bare
    ``lax.psum`` inside a JAX driver's jitted step)."""
    if dist.world().size > 1:
        tdist.all_reduce(per_rank, op=tdist.ReduceOp.SUM,
                         group=_group_for(per_rank))
    return per_rank


def _check_row(per_rank: torch.Tensor, name: str) -> int:
    """The world size, after checking that ``per_rank`` is this rank's
    (1, L) row of the JAX function's (n_ranks, L) array."""
    w = dist.world().size
    if per_rank.dim() != 2 or per_rank.shape[0] != 1:
        raise ValueError(
            f"{name}: need this rank's (1, L) row of the (n_ranks={w}, L) "
            f"array, got shape {tuple(per_rank.shape)}")
    return w


def reduce_scatter_sum(per_rank: torch.Tensor) -> torch.Tensor:
    """Library-tier reduce-scatter (≅ ``reduce_scatter_sum``, :539;
    ``MPI_Reduce_scatter_block``): ``per_rank`` is this rank's (1, L) row,
    ``L % n_ranks == 0``; returns the (1, L/n_ranks) chunk ``rank`` of the
    elementwise sum (``reduce_scatter_tensor`` over the process group; a
    copy at world=1)."""
    w = _check_row(per_rank, "reduce_scatter_sum")
    check_divisible(per_rank.shape[1], w, "reduce_scatter_sum chunking")
    return span_call("reduce_scatter", _reduce_scatter, per_rank,
                     nbytes=(w - 1) * _row_bytes(per_rank),
                     axis_name="shard", world=w)


def _reduce_scatter(per_rank: torch.Tensor) -> torch.Tensor:
    w = dist.world().size
    if w == 1:
        return per_rank.clone()
    n = per_rank.shape[1] // w
    out = torch.empty(n, dtype=per_rank.dtype, device=per_rank.device)
    tdist.reduce_scatter_tensor(out, per_rank[0].contiguous(),
                                op=tdist.ReduceOp.SUM,
                                group=_group_for(per_rank))
    return out[None]


def all_gather_rdma(x: torch.Tensor) -> torch.Tensor:
    """Hand-tier ``all_gather`` along axis 0 (≅ ``all_gather_rdma``,
    :383): this rank's block in, every rank's blocks in rank order out,
    through the ring all-gather kernel (``hand.ring_allgather``, w−1 hops;
    ≅ hand-writing the ``MPI_Allgather`` of ``mpi_daxpy_nvtx.cc:285-288``)."""
    from tpu_mpi_tests_torch.kernels import hand

    w = dist.world().size
    note_comm_op("ring_allgather", world=w, shape=x.shape)
    return span_call("all_gather_rdma", hand.ring_allgather, x.contiguous(),
                     nbytes=_gather_payload_bytes(x, w), axis_name="shard",
                     world=w)


def all_gather_oneshot(x: torch.Tensor) -> torch.Tensor:
    """Fixed-cost tier ``all_gather`` along axis 0 (≅
    ``all_gather_oneshot``, :431): one in-kernel burst into every peer
    instead of the ring's w−1 dependent hops (``hand.oneshot_allgather``)."""
    from tpu_mpi_tests_torch.kernels import hand

    w = dist.world().size
    note_comm_op("oneshot_allgather", world=w, shape=x.shape)
    return span_call("all_gather_oneshot", hand.oneshot_allgather,
                     x.contiguous(), nbytes=_gather_payload_bytes(x, w),
                     axis_name="shard", world=w)


def allreduce_rdma(per_rank: torch.Tensor, credits: int = 1
                   ) -> torch.Tensor:
    """Hand-tier :func:`allreduce_sum` (≅ ``allreduce_rdma``, :589): this
    rank's (1, L) row in, the (1, L) elementwise sum over the ranks out,
    through the ring reduce-scatter and the ring all-gather
    (``hand.ring_allreduce``; ≅ hand-writing the in-place device
    ``MPI_Allreduce(MPI_SUM)`` of ``mpi_stencil2d_gt.cc:615-625`` as
    2(w−1) ring hops). ``L % n_ranks == 0`` (the ring's chunking;
    ``ValueError`` otherwise). ``credits=2``: the double-buffered
    reduce-scatter. A new tensor (the JAX function returns one too)."""
    from tpu_mpi_tests_torch.kernels import hand

    w = _check_row(per_rank, "allreduce_rdma")
    note_comm_op("ring_allreduce", world=w, shape=per_rank.shape,
                 credits=credits)
    return span_call(
        "allreduce_rdma",
        lambda row: hand.ring_allreduce(row[0].contiguous(), credits)[None],
        per_rank, nbytes=2 * (w - 1) * _row_bytes(per_rank),
        axis_name="shard", world=w)


def allreduce_rdma_refusal(length: int) -> "str | None":
    """Why :func:`allreduce_rdma` cannot take a row of ``length``
    elements at this world (the ring reduce-scatter's chunking rule,
    ``hand.ring_chunk_rows``), or None when it can."""
    from tpu_mpi_tests_torch.kernels import hand

    try:
        hand.ring_chunk_rows(torch.empty(length, device="meta"),
                             dist.world().size, "ring_reduce_scatter")
    except ValueError as e:
        return str(e)
    return None


def allreduce_oneshot(per_rank: torch.Tensor) -> torch.Tensor:
    """Fixed-cost tier :func:`allreduce_sum` (≅ ``allreduce_oneshot``,
    :647): one in-kernel burst and a local ascending-rank fold
    (``hand.oneshot_allreduce``), so every rank holds bitwise
    ``reduce(add, rows)``; any L."""
    from tpu_mpi_tests_torch.kernels import hand

    w = _check_row(per_rank, "allreduce_oneshot")
    note_comm_op("oneshot_allreduce", world=w,
                 shape=per_rank.shape)
    # each rank ships its whole row to w−1 peers
    return span_call(
        "allreduce_oneshot",
        lambda row: hand.oneshot_allreduce(row[0].contiguous())[None],
        per_rank, nbytes=(w - 1) * _row_bytes(per_rank),
        axis_name="shard", world=w)


def reduce_sum(values) -> float:
    """Cross-rank scalar reduction (≅ ``reduce_sum``, :742;
    ``MPI_Reduce(..., MPI_SUM)``, ``mpi_stencil2d_gt.cc:562-566``): this
    rank's host partials summed in float64, then over the ranks; every
    rank returns the same total."""
    total = float(np.sum(np.asarray(values, dtype=np.float64)))
    w = dist.world().size
    if w > 1:
        with comm_span("reduce_sum", nbytes=8 * w, world=w):
            t = torch.tensor([total], dtype=torch.float64)
            tdist.all_reduce(t, op=tdist.ReduceOp.SUM,
                             group=dist.cpu_group())
            total = float(t[0])
    return total


def host_value(x: torch.Tensor) -> np.ndarray:
    """A tensor's value on the host as numpy; bfloat16 (which numpy
    lacks) widens to float32 exactly."""
    x = x.detach()
    if x.dtype == torch.bfloat16:
        x = x.float()
    return x.cpu().numpy()
