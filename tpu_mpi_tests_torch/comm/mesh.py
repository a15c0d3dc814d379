"""Process/device topology (≅ ``tpu_mpi_tests/comm/mesh.py``).

``bootstrap`` joins the world through :mod:`comm.dist` (one process per
rank; world=1 with no process group when no launcher set one) and returns
the rank's device. ``make_mesh`` gives the 1-D ``shard`` ring the
stencil and attention paths run on: the world group and each rank's left
and right neighbours, with a blocking and a non-blocking hop
(:meth:`Ring.shift`, :meth:`Ring.shift_start`). :func:`check_world`
holds a sequence-parallel attention path's ``world`` to the process
group's size.

:func:`make_grid` is ``make_mesh({"x": px, "y": py})``: a :class:`Grid`
of one ring per axis over the world's ranks in row-major order (rank r
at ``divmod(r, py)``, as JAX reshapes its device list). An axis ring
knows its members (ring position → global rank), so its hops go to
global ranks over the world group and need no subgroup; a ring of one
member takes the world=1 branches (a periodic self-copy, or nothing).
:func:`make_mesh_2level` is the host layout's ``dcn`` × ``ici`` mesh;
its sums over one axis need subgroups, which every rank creates in the
same order (:func:`axis_groups`).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as tdist

from tpu_mpi_tests_torch.comm import dist
from tpu_mpi_tests_torch.utils import TpuMtError, check_divisible

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
    """One mesh axis as a ring (≅ ``make_mesh()``'s one axis): this
    rank's position, the ring's size, its group and the neighbours on the
    periodic ring. ``left`` and ``right`` are ring positions;
    ``members`` maps a position to its global rank (None: the world
    ring, where the two agree). Whether a send crosses the wrap-around is
    the caller's ``periodic`` (:meth:`sends`), as in the JAX kernels'
    send predicates. ``group`` / ``cpu_group`` are the ring's subgroups
    where a collective over the axis needs them (:func:`axis_groups`),
    else the world's."""

    rank: int
    size: int
    group: object = None
    members: "tuple[int, ...] | None" = None
    cpu_group: object = None

    def peer(self, pos: int) -> int:
        """The global rank at ring position ``pos``."""
        return pos if self.members is None else self.members[pos]

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
        ``halo.py:223``), waited for: :meth:`sendrecv_start` then
        :meth:`Hop.wait`. Returns ``(from_left, from_right)`` — what
        belongs in my lo and hi ghost bands — with None on a side that
        receives nothing."""
        return self.sendrecv_start(lo_edge, hi_edge, periodic).wait()

    def sendrecv_start(self, lo_edge: torch.Tensor, hi_edge: torch.Tensor,
                       periodic: bool) -> "Hop":
        """Post one ring step and return at once: my lo edge goes to the
        left, my hi edge to the right, and :meth:`Hop.wait` returns
        ``(from_left, from_right)`` (None on a side that receives
        nothing). Card tensors go over the world group, host tensors over
        the gloo group; both edges must be contiguous (gloo refuses
        strided tensors). Rightward traffic is posted before leftward on
        every rank, so at world=2, where both neighbours are one rank,
        each send meets its receive in order (NCCL matches point-to-point
        calls by order, not by tag).

        On the card NCCL's stream waits for the stream current at the
        post and ``wait`` orders the stream current then after the
        transfer: post and wait with one stream current. The receive
        buffers are allocated on it."""
        if self.size == 1:
            raise MeshError("Ring.sendrecv: world=1 has no peer to send to")
        send_lo, send_hi = self.sends(periodic)
        group = tdist.group.WORLD if lo_edge.is_cuda else dist.cpu_group()
        left, right = self.peer(self.left), self.peer(self.right)
        from_left = torch.empty_like(hi_edge) if send_lo else None
        from_right = torch.empty_like(lo_edge) if send_hi else None
        ops = []
        if send_hi:
            ops.append(tdist.P2POp(tdist.isend, hi_edge, right, group, tag=0))
        if send_lo:
            ops.append(tdist.P2POp(tdist.irecv, from_left, left, group,
                                   tag=0))
            ops.append(tdist.P2POp(tdist.isend, lo_edge, left, group, tag=1))
        if send_hi:
            ops.append(tdist.P2POp(tdist.irecv, from_right, right, group,
                                   tag=1))
        return Hop(tdist.batch_isend_irecv(ops), (from_left, from_right))

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
        left, right = self.peer(self.left), self.peer(self.right)
        ops = []
        for i, (t, g) in enumerate(zip(xs, got)):
            ops.append(tdist.P2POp(tdist.isend, t, right, group, tag=2 + i))
            ops.append(tdist.P2POp(tdist.irecv, g, left, group, tag=2 + i))
        return Hop(tdist.batch_isend_irecv(ops),
                   got if isinstance(x, tuple) else got[0])

    def shift(self, x):
        """One hop to the right, waited for: :meth:`shift_start` then
        :meth:`Hop.wait`."""
        return self.shift_start(x).wait()


class Hop:
    """A hop in flight (:meth:`Ring.shift_start`,
    :meth:`Ring.sendrecv_start`). On the card ``wait`` orders the current
    stream after the transfer; on the CPU it blocks until the blocks have
    arrived."""

    def __init__(self, reqs, got):
        self._reqs, self._got = reqs, got

    def wait(self):
        """What arrived: the left neighbour's block (a tensor, or a tuple
        of them) for a shift, ``(from_left, from_right)`` for a
        sendrecv."""
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


@dataclasses.dataclass(frozen=True)
class Grid:
    """A ``px × py`` process grid (≅ ``make_mesh({"x": px, "y": py})``):
    this rank's coordinates and one ring per axis — ``x`` the column
    ring along axis 0 (the ranks that share ``ry``), ``y`` the row ring
    along axis 1 (those that share ``rx``)."""

    px: int
    py: int
    rx: int
    ry: int
    x: Ring
    y: Ring

    @property
    def size(self) -> int:
        return self.px * self.py


def make_grid(px: int, py: int) -> Grid:
    """The world as a ``px × py`` grid (world=1: the 1×1 grid of two
    self-rings). Raises unless ``px · py`` is the world size. Collective
    over nothing: the axis rings' hops go to global ranks over the world
    group."""
    w = dist.world()
    if px < 1 or py < 1 or px * py != w.size:
        raise MeshError(f"a {px}x{py} process grid needs {px * py} ranks, "
                        f"the world has {w.size}")
    rx, ry = divmod(w.rank, py)
    group = w.group if w.size > 1 else None
    x = Ring(rank=rx, size=px, group=group,
             members=tuple(r * py + ry for r in range(px)))
    y = Ring(rank=ry, size=py, group=group,
             members=tuple(rx * py + c for c in range(py)))
    return Grid(px=px, py=py, rx=rx, ry=ry, x=x, y=y)


def local_grid() -> Grid:
    """The 1×1 grid of this rank alone, at any world: both rings hold
    only this rank (a block that is its own periodic neighbour, as the
    one-card run of a grid's global field)."""
    r = dist.world().rank
    return Grid(px=1, py=1, rx=0, ry=0, x=Ring(rank=0, size=1, members=(r,)),
                y=Ring(rank=0, size=1, members=(r,)))


def axis_groups(member_lists) -> list:
    """A subgroup per member list, created by every rank in the same
    order (``new_group`` is collective over the world): ``(group,
    cpu_group)`` for the lists this rank is in, None for the others. On
    a gloo world the two are one group; on NCCL the second is gloo, for
    host tensors (as ``comm.dist.cpu_group``)."""
    w = dist.world()
    out = []
    for ranks in member_lists:
        ranks = list(ranks)
        g = tdist.new_group(ranks)
        cg = g if w.backend == "gloo" else tdist.new_group(ranks,
                                                           backend="gloo")
        out.append((g, cg) if w.rank in ranks else None)
    return out


@dataclasses.dataclass(frozen=True)
class Mesh2Level:
    """The two-level mesh (≅ ``make_mesh_2level``): ``dcn`` spans the
    hosts, ``ici`` the ranks of one host. :meth:`psum` sums over one
    axis or both."""

    dcn: Ring
    ici: Ring

    def psum(self, t: torch.Tensor, axes=("dcn", "ici")) -> torch.Tensor:
        """``t`` summed over the ranks of ``axes`` (≅ ``lax.psum``), in
        place; returns it. A ring of one rank adds nothing."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        bad = set(axes) - {"dcn", "ici"}
        if bad:
            raise MeshError(f"unknown mesh axes {sorted(bad)}; the axes are "
                            f"dcn, ici")
        if set(axes) == {"dcn", "ici"}:
            groups = [(tdist.group.WORLD, dist.cpu_group())] \
                if dist.world().size > 1 else []
        else:
            ring = getattr(self, axes[0])
            groups = [(ring.group, ring.cpu_group)] if ring.size > 1 else []
        for group, cpu in groups:
            tdist.all_reduce(t, op=tdist.ReduceOp.SUM,
                             group=group if t.is_cuda else cpu)
        return t


def make_mesh_2level() -> Mesh2Level:
    """The host layout as a mesh (≅ ``make_mesh_2level``, the reference's
    ``MPI_Comm_split_type`` node axis, ``mpi_daxpy_nvtx.cc:72-82``): the
    outer ``dcn`` ring spans ``World.hosts``, the inner ``ici`` ring the
    ``ranks_per_host`` ranks of a host. Ranks are numbered host-major, as
    the launchers start them (``torchrun``, ``tpumt_run``); collective at
    world > 1 (it creates the axes' subgroups)."""
    w = dist.world()
    hosts, per = w.hosts, w.ranks_per_host
    if hosts * per != w.size:
        raise MeshError(f"{hosts} hosts x {per} ranks a host != world "
                        f"{w.size}: the hosts carry unequal rank counts")
    h, i = divmod(w.rank, per)
    dcn_members = [[hh * per + ii for hh in range(hosts)] for ii in range(per)]
    ici_members = [[hh * per + ii for ii in range(per)] for hh in range(hosts)]
    if w.size > 1:
        dcn_g = axis_groups(dcn_members)[i]
        ici_g = axis_groups(ici_members)[h]
    else:
        dcn_g = ici_g = (None, None)
    dcn = Ring(rank=h, size=hosts, group=dcn_g[0],
               members=tuple(dcn_members[i]), cpu_group=dcn_g[1])
    ici = Ring(rank=i, size=per, group=ici_g[0],
               members=tuple(ici_members[h]), cpu_group=ici_g[1])
    return Mesh2Level(dcn=dcn, ici=ici)


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
