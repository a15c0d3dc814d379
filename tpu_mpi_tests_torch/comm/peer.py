"""The peer-memory layer of the hand RDMA kernels (``ring_halo``,
``stencil2d_fused_rdma``, the collectives ``ring_allgather``,
``ring_reduce_scatter`` and ``oneshot``, and ``fused_ring_attention``):
where a rank's peers' buffers and signal pads live, as raw device
addresses.

The kernels take only raw pointers; this module is the only code that
knows where a peer pointer comes from:

* world > 1 on the card: buffers and pads are allocated in symmetric
  memory (``torch.distributed._symmetric_memory.empty`` + ``rendezvous``
  on the ring's group), so every rank maps every other rank's allocation
  and a kernel stores straight into a neighbour's ghost band (over NVLink
  between cards). Allocation is collective: every rank allocates the
  same shapes in the same order, so each allocation has its counterpart
  on every rank and a neighbour's copy of a buffer sits at the same
  offset in it. An allocation is freed with the last tensor that views
  it.
* world = 1 (the self-ring): the rank's own tensors and pad; any tensor
  on the card is its own "peer" buffer.

There is no fallback: a failed rendezvous raises, and so does a world > 1
ring on the card whose ranks cannot map each other's memory.

The ring kernels store into the left and right neighbours' copies
(:meth:`PeerRing.peer_ptrs`, :meth:`PeerRing.pad_ptrs`); the one-shot
kernel into every rank's (:meth:`PeerRing.peer_ptrs_all`,
:meth:`PeerRing.pad_ptrs_all`). The collectives' comm buffers and the
fused ring attention's K/V slots are workspaces kept for the life of the
ring (:meth:`PeerRing.workspace`).

The signal pad is 128 int32 words per rank, zeroed once; the word map is
``kernels/csrc/ring_common.cuh``'s. Words 0-3 are written by neighbours
(epoch counters of the ring halo kernels: barrier from the left, barrier
from the right, arrival from the left, arrival from the right), words 4-5
only by the rank's own CTAs (the work ticket and the done counter, each
reset to 0 by the last CTA of a launch). Words 6-59 belong to the
collective kernels: per-step arrival flags for the all-gather, arrival
and credit flags for the reduce-scatter, per-rank barrier and arrival
flags for the one-shot, and their CTAs' own counters. Words 64-98
belong to the fused ring attention: its entry barrier from either
neighbour, per-step arrival and credit flags, and its CTAs' per-step
send and retire counters and exit counter. So the collectives and the
fused ring attention run on at most :data:`COLL_MAX_WORLD` ranks
(:class:`PeerError` beyond).

Epochs count every RDMA launch of the process up from 1 (:meth:`PeerRing.
next_epoch`), one per launch of any RDMA kernel — the ring halo kernels,
the collectives and the fused ring attention share the count — so they agree across ranks as long
as every rank makes the same sequence of RDMA launches (SPMD), and a
peer's later epoch never reads as an earlier one.
"""

from __future__ import annotations

import dataclasses
import weakref

import torch

from tpu_mpi_tests_torch.comm import dist
from tpu_mpi_tests_torch.comm.mesh import Ring, make_mesh
from tpu_mpi_tests_torch.utils import TpuMtError

PAD_WORDS = 128
#: the most ranks (or self-ring steps) the collective kernels' and the
#: fused ring attention's words in the pad serve (``kCollMaxWorld``,
#: ``csrc/ring_common.cuh``)
COLL_MAX_WORLD = 8


class PeerError(TpuMtError):
    """The peer layer cannot serve a request."""


@dataclasses.dataclass
class _Allocation:
    storage: weakref.ref  # the allocation's storage, while a tensor holds it
    ptrs: "tuple[int, ...] | None"  # every rank's address of its first byte
    handle: object  # the rendezvous handle: keeps the peers' mappings
    pair: "tuple | None"  # (shape, dtype, half stride in bytes) of a pair


class PeerRing:
    """The ring's peer memory on one device: the signal pad, the
    allocations made in peer memory, and the epoch counter.

    An allocation lives as long as a tensor views it: when the last one
    goes, torch frees the memory and the ring forgets the allocation and
    drops its rendezvous handle, so a runner called again and again on
    fresh inputs holds no more memory than the results its caller keeps."""

    def __init__(self, ring: Ring, device: torch.device):
        self.ring = ring
        self.device = device
        self.epoch = 0
        self._allocs: dict[int, _Allocation] = {}
        self._workspaces: dict[str, torch.Tensor] = {}
        self.symmetric = device.type == "cuda" and ring.size > 1
        if device.type != "cuda":
            self.pad = None
            self._pad_ptrs = (0, 0, 0)
            self._all_pads = (0,) * ring.size
            return
        base, ptrs, self._pad_handle = self._allocate(PAD_WORDS * 4)
        self.pad = base.view(torch.int32)
        self.pad.zero_()
        if self.symmetric:
            torch.cuda.synchronize(device)
            torch.distributed.barrier(group=dist.cpu_group())
            self._pad_ptrs = (ptrs[ring.rank], ptrs[ring.left],
                              ptrs[ring.right])
            self._all_pads = tuple(ptrs)
        else:
            self._pad_ptrs = (self.pad.data_ptr(),) * 3
            self._all_pads = (self.pad.data_ptr(),)

    # -- allocation ---------------------------------------------------------

    def _allocate(self, nbytes: int):
        """``(base, ptrs, handle)``: ``nbytes`` of peer memory on the
        device (uint8), every rank's address of it and the rendezvous
        handle. At world > 1 on the card the allocation is symmetric;
        otherwise it is a plain tensor (``ptrs`` and ``handle`` None)."""
        if not self.symmetric:
            base = torch.empty(nbytes, dtype=torch.uint8, device=self.device)
            return base, None, None
        import torch.distributed._symmetric_memory as symm_mem

        base = symm_mem.empty(nbytes, dtype=torch.uint8, device=self.device)
        try:
            handle = symm_mem.rendezvous(base, self.ring.group)
        except RuntimeError as e:
            raise PeerError(
                f"symmetric-memory rendezvous over {self.ring.size} ranks "
                f"failed ({e}); the RDMA kernels need every rank of the "
                f"ring to map its neighbours' memory (peer access between "
                f"the ranks' cards)") from e
        off = base.data_ptr() - int(handle.buffer_ptrs[self.ring.rank])
        return base, tuple(int(p) + off for p in handle.buffer_ptrs), handle

    def empty(self, shape, dtype: torch.dtype, count: int = 1):
        """``count`` new tensors of ``shape`` and ``dtype`` in one peer
        allocation (``count=2``: a ping-pong pair, see :meth:`pair`).
        Collective at world > 1. Returns a tuple when ``count > 1``."""
        shape = tuple(int(s) for s in shape)
        numel = 1
        for s in shape:
            numel *= s
        itemsize = torch.empty((), dtype=dtype).element_size()
        stride = -(-numel * itemsize // 256) * 256  # 256-byte aligned
        base, ptrs, handle = self._allocate(max(stride * count, 1))
        storage = base.untyped_storage()
        key = storage.data_ptr()
        entry = _Allocation(weakref.ref(storage), ptrs, handle,
                            (shape, dtype, stride) if count == 2 else None)
        self._allocs[key] = entry
        weakref.finalize(storage, self._forget, key, entry).atexit = False
        out = tuple(base[i * stride:i * stride + numel * itemsize]
                    .view(dtype).view(shape) for i in range(count))
        return out if count > 1 else out[0]

    def _forget(self, key: int, entry: _Allocation) -> None:
        if self._allocs.get(key) is entry:
            if entry.handle is not None:
                # the handle maps the neighbours' copies: no launch of
                # this rank may still store into them when it goes
                torch.cuda.synchronize(self.device)
            del self._allocs[key]

    def _find(self, z: torch.Tensor) -> "_Allocation | None":
        storage = z.untyped_storage()
        a = self._allocs.get(storage.data_ptr())
        return a if a is not None and a.storage() is storage else None

    def pair(self, z: torch.Tensor):
        """``(current, spare)``, the two halves of a ping-pong pair in
        peer memory with ``current`` holding ``z``'s values: ``z`` itself
        and the other half when ``z`` is a half of such a pair (a runner's
        own earlier result, which the call then overwrites), else a new
        pair (collective at world > 1) with ``z`` copied into its first
        half. A pair is freed with the last tensor that views either
        half."""
        a = self._find(z)
        if a is not None and a.pair is not None:
            shape, dtype, stride = a.pair
            storage = a.storage()
            off = z.data_ptr() - storage.data_ptr()
            if (tuple(z.shape) == shape and z.dtype == dtype
                    and z.is_contiguous() and off in (0, stride)):
                spare = torch.empty(0, dtype=dtype, device=z.device)
                spare.set_(storage, (stride - off) // z.element_size(),
                           shape)
                return z, spare
        current, spare = self.empty(z.shape, z.dtype, count=2)
        current.copy_(z)
        return current, spare

    # -- what the kernels take ----------------------------------------------

    def peer_ptrs(self, z: torch.Tensor) -> tuple[int, int]:
        """The device addresses of ``z``'s counterpart in the left and the
        right neighbour's memory (world = 1: ``z``'s own address twice)."""
        ptrs = self.peer_ptrs_all(z)
        if len(ptrs) == 1:
            return ptrs[0], ptrs[0]
        return ptrs[self.ring.left], ptrs[self.ring.right]

    def peer_ptrs_all(self, z: torch.Tensor) -> tuple[int, ...]:
        """The device addresses of ``z``'s counterpart in every rank's
        memory, indexed by rank (world = 1: ``z``'s own address)."""
        if not self.symmetric:
            return (z.data_ptr(),)
        a = self._find(z)
        if a is None:
            raise PeerError(
                "the RDMA kernels store into their peers' copies of a "
                "buffer, so the tensor must live in peer memory: allocate "
                "it with PeerRing.empty()")
        off = z.data_ptr() - a.storage().data_ptr()
        return tuple(p + off for p in a.ptrs)

    def pad_ptrs(self) -> tuple[int, int, int]:
        """(mine, the left neighbour's, the right neighbour's) pads."""
        return self._pad_ptrs

    def pad_ptrs_all(self) -> tuple[int, ...]:
        """Every rank's pad, indexed by rank (world = 1: mine)."""
        return self._all_pads

    def workspace(self, name: str, nbytes: int) -> torch.Tensor:
        """``nbytes`` (uint8) of peer memory kept under ``name`` for the
        life of the ring: a collective kernel's comm buffer, which the
        peers write. Grown (collective at world > 1: every rank asks for
        the same sizes in the same order) when a call needs more than it
        holds; chained launches reuse it, the kernels' entry barriers
        keeping a peer from writing it before this rank's previous launch
        on it has finished."""
        nbytes = max(int(nbytes), 1)
        ws = self._workspaces.get(name)
        if ws is None or ws.numel() < nbytes:
            self._workspaces.pop(name, None)
            ws = self._workspaces[name] = self.empty((nbytes,), torch.uint8)
        return ws[:nbytes]

    def next_epoch(self) -> int:
        """The epoch of the next RDMA launch (1, 2, ...)."""
        self.epoch += 1
        if self.epoch >= 2**31:
            raise PeerError("signal epoch overflow")
        return self.epoch


_RINGS: dict = {}


def check_collective_world(size: int, what: str) -> int:
    """Refuse a collective or a fused ring attention over more ranks (or
    self-ring steps) than the signal pad serves; returns ``size``."""
    if size > COLL_MAX_WORLD:
        raise PeerError(
            f"{what} over {size} ranks: the ring kernels' signal words "
            f"serve at most {COLL_MAX_WORLD} (the {PAD_WORDS}-word pad, "
            f"csrc/ring_common.cuh)")
    return size


def peer_ring(device: torch.device) -> PeerRing:
    """The process's :class:`PeerRing` on ``device`` over the world ring
    (created on first use; collective at world > 1)."""
    device = torch.device(device)
    ring = make_mesh()
    key = (str(device), ring.rank, ring.size, id(ring.group))
    pr = _RINGS.get(key)
    if pr is None:
        pr = _RINGS[key] = PeerRing(ring, device)
    return pr


def reset() -> None:
    """Forget every ring and its allocations (after ``dist.shutdown``)."""
    _RINGS.clear()
