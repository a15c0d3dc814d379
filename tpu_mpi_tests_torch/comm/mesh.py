"""Process/device topology (≅ ``tpu_mpi_tests/comm/mesh.py``).

``bootstrap`` joins the world through :mod:`comm.dist` (one process per
rank; world=1 with no process group when no launcher set one) and returns
the rank's device. ``make_mesh`` gives the 1-D ``shard`` ring the
stencil and attention paths run on: the world group and each rank's left
and right neighbours, with a blocking and a non-blocking hop
(:meth:`Ring.shift`, :meth:`Ring.shift_start`). :func:`check_world`
holds a sequence-parallel attention path's ``world`` to the process
group's size.

Still one rank only, each raising with the next slice of ROADMAP queue 1
item 2: the 2-D process grids of ``heat2d`` and ``stencil2d_grid``
(:func:`check_grid`) and the drivers that :func:`check_single_rank`
guards (the DAXPY drivers).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as tdist

from tpu_mpi_tests_torch.comm import dist
from tpu_mpi_tests_torch.utils import TpuMtError, check_divisible

#: where the paths that still run one rank only are queued
NEXT_SLICE = ("the next slice of ROADMAP queue 1 item 2 (the 2-D grid "
              "and DAXPY paths over ranks)")


class MeshError(TpuMtError):
    """Invalid topology request."""


@dataclasses.dataclass(frozen=True)
class Topology:
    """Discovered topology; field names follow the JAX package's
    ``Topology`` so drivers read the same attributes. One device per
    rank: ``global_device_count`` is the world size, ``local_device_count``
    the ranks on this host (≅ the shared-memory communicator split)."""

    global_device_count: int
    platform: str
    device_kinds: tuple[str, ...]
    device: torch.device
    process_index: int = 0
    process_count: int = 1
    local_device_count: int = 1
    hosts: int = 1

    @property
    def is_multi_host(self) -> bool:
        return self.hosts > 1


@dataclasses.dataclass(frozen=True)
class Ring:
    """The 1-D ``shard`` ring (≅ ``make_mesh()``'s one axis): the group,
    this rank, the world size and the neighbours on the periodic ring.
    Whether a send crosses the wrap-around is the caller's ``periodic``
    (:meth:`sends`), as in the JAX kernels' send predicates."""

    rank: int
    size: int
    group: object = None

    @property
    def left(self) -> int:
        return (self.rank - 1) % self.size

    @property
    def right(self) -> int:
        return (self.rank + 1) % self.size

    def sends(self, periodic: bool) -> tuple[bool, bool]:
        """(send lo edge to the left, send hi edge to the right): every
        rank on a periodic ring, all but the ring's ends otherwise
        (``pallas_kernels.py:1775-1776``). A rank receives from a side
        exactly when it sends to it."""
        return (periodic or self.rank > 0,
                periodic or self.rank < self.size - 1)

    def phys(self, periodic: bool) -> tuple[int, int]:
        """Physical-side flags (lo, hi): the sides that receive nothing."""
        lo, hi = self.sends(periodic)
        return int(not lo), int(not hi)

    def sendrecv(self, lo_edge: torch.Tensor, hi_edge: torch.Tensor,
                 periodic: bool):
        """One ring step over the process group (≅ ``_ring_rotate``,
        ``halo.py:223``): my lo edge to the left, my hi edge to the right.
        Returns ``(from_left, from_right)`` — what belongs in my lo and hi
        ghost bands — with None on a side that receives nothing. Card
        tensors go over the world group, host tensors over the gloo group;
        both edges must be contiguous (gloo refuses strided tensors).
        Rightward traffic is posted before leftward on every rank, so at
        world=2, where both neighbours are one rank, each send meets its
        receive in order (NCCL matches point-to-point calls by order, not
        by tag)."""
        if self.size == 1:
            raise MeshError("Ring.sendrecv: world=1 has no peer to send to")
        send_lo, send_hi = self.sends(periodic)
        group = tdist.group.WORLD if lo_edge.is_cuda else dist.cpu_group()
        from_left = torch.empty_like(hi_edge) if send_lo else None
        from_right = torch.empty_like(lo_edge) if send_hi else None
        ops = []
        if send_hi:
            ops.append(tdist.P2POp(tdist.isend, hi_edge, self.right, group,
                                   tag=0))
        if send_lo:
            ops.append(tdist.P2POp(tdist.irecv, from_left, self.left, group,
                                   tag=0))
            ops.append(tdist.P2POp(tdist.isend, lo_edge, self.left, group,
                                   tag=1))
        if send_hi:
            ops.append(tdist.P2POp(tdist.irecv, from_right, self.right,
                                   group, tag=1))
        if ops:
            for req in tdist.batch_isend_irecv(ops):
                req.wait()
        return from_left, from_right

    def shift_start(self, x) -> "Hop":
        """Start one hop to the right on the periodic ring (≅
        ``lax.ppermute`` with ``(i, i+1 mod w)``) and return at once:
        ``x`` (a contiguous tensor, or a tuple of them, moved in one
        batch) goes to the right neighbour, and :meth:`Hop.wait` returns
        what the left one sent, shaped alike. Card tensors go over the
        world group, host tensors over the gloo group."""
        if self.size == 1:
            raise MeshError("Ring.shift: world=1 has no peer to send to")
        xs = x if isinstance(x, tuple) else (x,)
        got = tuple(torch.empty_like(t) for t in xs)
        group = tdist.group.WORLD if xs[0].is_cuda else dist.cpu_group()
        ops = []
        for i, (t, g) in enumerate(zip(xs, got)):
            ops.append(tdist.P2POp(tdist.isend, t, self.right, group,
                                   tag=2 + i))
            ops.append(tdist.P2POp(tdist.irecv, g, self.left, group,
                                   tag=2 + i))
        return Hop(tdist.batch_isend_irecv(ops),
                   got if isinstance(x, tuple) else got[0])

    def shift(self, x):
        """One hop to the right, waited for: :meth:`shift_start` then
        :meth:`Hop.wait`."""
        return self.shift_start(x).wait()


class Hop:
    """A hop in flight (:meth:`Ring.shift_start`). On the card ``wait``
    orders the current stream after the transfer; on the CPU it blocks
    until the block has arrived."""

    def __init__(self, reqs, got):
        self._reqs, self._got = reqs, got

    def wait(self):
        """What the left neighbour sent (a tensor, or a tuple of them)."""
        for req in self._reqs:
            req.wait()
        self._reqs = ()
        return self._got


def bootstrap(device="cuda") -> torch.device:
    """Join the world (≅ ``MPI_Init``; the card unless ``device="cpu"``)
    and return this rank's device."""
    return dist.init(device).device


def make_mesh() -> Ring:
    """The world's 1-D ring (world=1: a self-ring with no group)."""
    w = dist.world()
    return Ring(rank=w.rank, size=w.size, group=w.group)


def check_world(world: int) -> int:
    """A sequence-parallel attention path's ``world`` (the ring and
    all-to-all paths, ``attnbench``): it must be the process group's size
    (1 with no group). Returns the world."""
    size = dist.world().size
    if world != size:
        raise MeshError(
            f"sequence-parallel attention over world={world} ranks "
            f"requested, but the process group has {size} rank(s): start "
            f"one process per rank (torchrun, tpumt_run)"
        )
    return world


def check_grid(spec: "str | None") -> None:
    """Refuse a ``'PX,PY'`` process grid of more than one rank: the 2-D
    grid drivers run on the 1×1 grid only. A missing or malformed spec
    passes (``drivers._common.parse_grid_mesh`` resolves or reports it)."""
    try:
        px, py = (int(v) for v in spec.split(","))
    except (AttributeError, ValueError):
        return
    if px * py > 1:
        raise MeshError(
            f"--mesh {px},{py} asks for a {px}x{py} process grid of "
            f"{px * py} ranks, but the process grid over ranks (row and "
            f"column subgroups) is {NEXT_SLICE}"
        )


def check_single_rank(what: str) -> None:
    """Refuse to run ``what`` in a world of more than one rank."""
    size = dist.world().size
    if size > 1:
        raise MeshError(f"{what} runs one rank only (world size {size}); "
                        f"multi-rank {what} is {NEXT_SLICE}")


def topology(device: torch.device) -> Topology:
    """The world's topology on ``device``: platform ``gpu`` on the card
    (kind = ``torch.cuda.get_device_name``), ``cpu`` otherwise."""
    if device.type == "cuda":
        platform, kind = "gpu", torch.cuda.get_device_name(device)
    else:
        platform, kind = "cpu", "cpu"
    w = dist.world()
    return Topology(
        global_device_count=w.size,
        platform=platform,
        device_kinds=(kind,),
        device=device,
        process_index=w.rank,
        process_count=w.size,
        local_device_count=w.ranks_per_host,
        hosts=w.hosts,
    )


def device_report(device: torch.device, verbose: bool = False) -> str:
    """One-line (or per-device) binding report, in the JAX package's
    words (≅ the ``set_rank_device`` printouts, ``mpi_daxpy.cc:56-59``);
    ``verbose`` adds the device's memory size on the card."""
    topo = topology(device)
    lines = [
        f"{topo.process_index}/{topo.process_count} processes, "
        f"{topo.local_device_count} local / {topo.global_device_count} "
        f"global devices, platform={topo.platform}, "
        f"kinds={list(topo.device_kinds)}"
    ]
    if verbose:
        mem_s = ""
        if device.type == "cuda":
            mem = torch.cuda.get_device_properties(device).total_memory
            mem_s = f", mem_limit={mem / 2**30:.1f}GiB"
        lines.append(f"  device {device.index or 0}: "
                     f"{topo.device_kinds[0]}{mem_s}")
    return "\n".join(lines)


def ranks_per_device(world_size: "int | None" = None) -> int:
    """Oversubscription factor (reference ``ranks_per_device``,
    ``mpi_daxpy.cc:49-51``): how many logical ranks each device carries
    for a requested world size, over the world's devices (one per rank),
    with the reference's divisibility rule."""
    n_dev = dist.world().size
    if world_size is None or world_size <= n_dev:
        return 1
    return check_divisible(world_size, n_dev, "world_size over devices")
