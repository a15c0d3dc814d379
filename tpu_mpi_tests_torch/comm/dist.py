"""Multi-rank ``torch.distributed``: one process per rank (≅
``tpu_mpi_tests/comm/mesh.py`` ``bootstrap`` :47, ``Topology`` :99,
``topology`` :123, and the reference's ``MPI_Init`` /
``MPI_Comm_split_type`` / ``set_rank_device``).

The world comes from the launcher's environment: torchrun's ``RANK`` /
``WORLD_SIZE`` / ``LOCAL_RANK`` / ``MASTER_ADDR`` / ``MASTER_PORT``, or
the ``JAX_PROCESS_ID`` / ``JAX_NUM_PROCESSES`` /
``JAX_COORDINATOR_ADDRESS`` that ``native/tpumt_run`` sets
(``native/launcher.cc:114-116``), so the same launcher starts the port's
ranks. A caller that has already initialised a process group (a test's
spawned worker) is adopted as it is. With none of these, the world is
one rank and no process group is created.

The backend follows the device: NCCL on the card, gloo on the CPU. A run
on the card also gets a gloo group over the same ranks (:func:`cpu_group`)
for host tensors — the host-staged exchange and the host-name gather.
Each rank binds to device ``local_rank mod device_count``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import socket
import tempfile

import torch
import torch.distributed as dist

from tpu_mpi_tests_torch.device import resolve_device
from tpu_mpi_tests_torch.utils import TpuMtError


@dataclasses.dataclass(frozen=True)
class World:
    """This process's place in the world."""

    rank: int
    size: int
    local_rank: int
    device: torch.device
    backend: "str | None"  # None: world=1 without a process group
    hosts: int = 1
    ranks_per_host: int = 1

    @property
    def group(self):
        """The default process group (None at world=1)."""
        return dist.group.WORLD if self.backend else None


_WORLD: "World | None" = None
_CPU_GROUP = None


def launch_env(environ=None) -> "dict | None":
    """``{rank, size, local_rank, init_method}`` from a launcher's
    variables (torchrun's first, then ``tpumt_run``'s ``JAX_*``), or None
    when no launcher set a world. ``local_rank`` is None when the launcher
    does not say (``tpumt_run``): the host-name gather decides it."""
    env = os.environ if environ is None else environ
    if env.get("WORLD_SIZE"):
        addr = env.get("MASTER_ADDR", "localhost")
        port = env.get("MASTER_PORT", "29500")
        local = env.get("LOCAL_RANK")
        return {"rank": int(env.get("RANK", "0")),
                "size": int(env["WORLD_SIZE"]),
                "local_rank": None if local is None else int(local),
                "init_method": f"tcp://{addr}:{port}"}
    if env.get("JAX_NUM_PROCESSES"):
        coord = env.get("JAX_COORDINATOR_ADDRESS", "localhost:29500")
        return {"rank": int(env.get("JAX_PROCESS_ID", "0")),
                "size": int(env["JAX_NUM_PROCESSES"]),
                "local_rank": None,
                "init_method": f"tcp://{coord}"}
    return None


def _bind(device: torch.device, local_rank: int) -> torch.device:
    """≅ ``set_rank_device``: rank ``local_rank`` of a host takes card
    ``local_rank mod device_count``."""
    if device.type != "cuda":
        return device
    idx = local_rank % torch.cuda.device_count()
    torch.cuda.set_device(idx)
    return torch.device("cuda", idx)


def _host_layout(rank: int, size: int) -> tuple[int, int, int]:
    """(hosts, ranks on my host, my index among them) from an all-gather
    of host names over the gloo group (≅ ``MPI_Comm_split_type``)."""
    names = [None] * size
    dist.all_gather_object(names, socket.gethostname(), group=cpu_group())
    mine = names[rank]
    return (len(set(names)), names.count(mine),
            sum(1 for n in names[:rank] if n == mine))


def init(device="cuda", environ=None) -> World:
    """Join the world (idempotent): adopt an initialised process group,
    else start one from the launcher's variables, else world=1 with no
    group. Binds the rank to its device and returns the :class:`World`."""
    global _WORLD, _CPU_GROUP
    dev = resolve_device(device)
    if _WORLD is not None and _WORLD.backend is not None \
            and dist.is_initialized():
        if _WORLD.device.type != dev.type:
            raise TpuMtError(f"the world is bound to {_WORLD.device}; "
                             f"cannot rejoin on {dev}")
        return _WORLD
    env = None if dist.is_initialized() else launch_env(environ)
    if not dist.is_initialized() and (env is None or env["size"] <= 1):
        _WORLD = World(rank=0, size=1, local_rank=0, device=dev,
                       backend=None)
        return _WORLD
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if env["local_rank"] is not None:
            dev = _bind(dev, env["local_rank"])
        dist.init_process_group(backend, init_method=env["init_method"],
                                rank=env["rank"], world_size=env["size"])
    rank, size = dist.get_rank(), dist.get_world_size()
    backend = dist.get_backend()
    _CPU_GROUP = None if backend == "gloo" else dist.new_group(
        backend="gloo")
    hosts, per_host, local = _host_layout(rank, size)
    if env is not None and env["local_rank"] is not None:
        local = env["local_rank"]
    dev = _bind(dev, local)
    _WORLD = World(rank=rank, size=size, local_rank=local, device=dev,
                   backend=backend, hosts=hosts, ranks_per_host=per_host)
    return _WORLD


def world() -> World:
    """The joined world; world=1 on the CPU when :func:`init` never ran
    (library calls outside a driver, as the world=1 paths always were)."""
    if _WORLD is None:
        if dist.is_initialized():
            raise TpuMtError("a process group exists but comm.dist.init() "
                             "was not called to bind this rank")
        return World(rank=0, size=1, local_rank=0,
                     device=torch.device("cpu"), backend=None)
    return _WORLD


def cpu_group():
    """A gloo group over every rank, for host tensors (the default group
    when it is gloo already)."""
    if not dist.is_initialized():
        return None
    return _CPU_GROUP if _CPU_GROUP is not None else dist.group.WORLD


def shutdown() -> None:
    """Leave the world: destroy the process group this module started or
    adopted and forget the binding."""
    global _WORLD, _CPU_GROUP
    if dist.is_initialized():
        dist.destroy_process_group()
    _WORLD = None
    _CPU_GROUP = None


@contextlib.contextmanager
def world_of_one(device="cuda"):
    """Join a process group of one rank for the life of the block (the
    path a world of N enters: ``init`` adopting a group, NCCL on the
    card, gloo on the CPU, the gloo host group beside it), then leave it
    and restore the world there was. Yields the :class:`World`. Refuses
    to run inside a group of another size."""
    global _WORLD, _CPU_GROUP
    if dist.is_initialized():
        if dist.get_world_size() != 1:
            raise TpuMtError(f"world_of_one inside a group of "
                             f"{dist.get_world_size()} ranks")
        yield init(device)
        return
    saved = (_WORLD, _CPU_GROUP)
    dev = resolve_device(device)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"file://{tmp}/rendezvous", rank=0, world_size=1)
        _WORLD = None
        try:
            yield init(dev)
        finally:
            shutdown()
            _WORLD, _CPU_GROUP = saved
