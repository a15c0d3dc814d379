"""Process/device topology at world=1 (≅ ``tpu_mpi_tests/comm/mesh.py``).

This slice of the port runs one rank on one device. ``bootstrap`` checks
that nothing asks for more: a multi-rank launch (``WORLD_SIZE`` or
``JAX_NUM_PROCESSES`` > 1) raises, naming the ROADMAP item that brings
``torch.distributed`` (queue 1 item 2, ``comm/dist.py``).
"""

from __future__ import annotations

import dataclasses
import os

import torch

from tpu_mpi_tests_torch.device import resolve_device
from tpu_mpi_tests_torch.utils import TpuMtError, check_divisible


class MeshError(TpuMtError):
    """Invalid topology request."""


@dataclasses.dataclass(frozen=True)
class Topology:
    """Discovered topology; field names follow the JAX package's
    ``Topology`` so drivers read the same attributes."""

    global_device_count: int
    platform: str
    device_kinds: tuple[str, ...]
    device: torch.device
    process_index: int = 0
    process_count: int = 1
    local_device_count: int = 1


def _requested_world() -> int:
    for var in ("WORLD_SIZE", "JAX_NUM_PROCESSES"):
        val = os.environ.get(var)
        if val:
            return int(val)
    return 1


def bootstrap(device="cuda") -> torch.device:
    """Resolve the run's device (the card unless ``device="cpu"``) and
    refuse multi-rank launches, which this slice does not run."""
    world = _requested_world()
    if world > 1:
        raise MeshError(
            f"world size {world} requested, but the port runs world=1 "
            f"only; multi-rank torch.distributed (comm/dist.py, NCCL/gloo "
            f"exchange_shard) is ROADMAP queue 1 item 2"
        )
    return resolve_device(device)


def check_world(world: int) -> int:
    """Refuse a sequence-parallel ``world`` of more than one rank (the
    ring and all-to-all attention paths run at world=1 only). Returns the
    world."""
    if world != 1:
        raise MeshError(
            f"sequence-parallel attention over world={world} ranks "
            f"requested, but the port runs world=1 only; multi-rank "
            f"torch.distributed (comm/dist.py) is ROADMAP queue 1 item 2"
        )
    return world


def check_grid(spec: "str | None") -> None:
    """Refuse a ``'PX,PY'`` process grid of more than one rank: this
    slice runs the 2-D grid drivers on the 1×1 grid only. A missing or
    malformed spec passes (``drivers._common.parse_grid_mesh`` resolves
    or reports it)."""
    try:
        px, py = (int(v) for v in spec.split(","))
    except (AttributeError, ValueError):
        return
    if px * py > 1:
        raise MeshError(
            f"--mesh {px},{py} asks for a {px}x{py} process grid of "
            f"{px * py} ranks, but the port runs world=1 (the 1x1 grid) "
            f"only; multi-rank torch.distributed (comm/dist.py, row and "
            f"column subgroups) is ROADMAP queue 1 item 2"
        )


def topology(device: torch.device) -> Topology:
    """World=1 topology on ``device``: platform ``gpu`` on the card
    (kind = ``torch.cuda.get_device_name``), ``cpu`` otherwise."""
    if device.type == "cuda":
        platform, kind = "gpu", torch.cuda.get_device_name(device)
    else:
        platform, kind = "cpu", "cpu"
    return Topology(
        global_device_count=1,
        platform=platform,
        device_kinds=(kind,),
        device=device,
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
    ``mpi_daxpy.cc:49-51``): how many logical ranks the one device
    carries for a requested world size, with the reference's
    divisibility rule (at world=1 every logical rank is on it)."""
    if world_size is None or world_size <= 1:
        return 1
    return check_divisible(world_size, 1, "world_size over devices")
