"""Memory spaces: device / managed / pinned-host memory (≅
``tpu_mpi_tests/arrays/spaces.py``).

The reference's memory-space axis is ``cudaMalloc`` vs
``cudaMallocManaged`` vs ``cudaMallocHost`` (``mpi_daxpy_nvtx.cc:178-198``,
``mpi_stencil2d_gt.cc:696-728``), with ``MEMINFO`` introspection
(``cuda_error.h:99-136``). In the port:

* ``DEVICE``  → a tensor on the run's device (the card's memory).
* ``HOST``    → a pinned (page-locked) CPU tensor.
* ``MANAGED`` → PyTorch has no public managed allocator, so MANAGED is
  emulated as the JAX package emulates it on the TPU: a pinned CPU
  tensor, moved to the device on its first device use
  (:func:`ensure_device`), so the migration lands in the phase that first
  touches it, as UVM page faults land in the reference's kernel time.

On a CPU run every space is plain CPU memory (pinning needs a card) —
the axis degrades as the JAX package's does on its CPU backend.
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from tpu_mpi_tests_torch.utils import TpuMtError


class Space(enum.Enum):
    """Placement space for benchmark arrays (≅ gtensor spaces)."""

    DEVICE = "device"
    HOST = "host"
    MANAGED = "managed"

    @classmethod
    def parse(cls, s: "str | Space") -> "Space":
        if isinstance(s, Space):
            return s
        try:
            return cls[s.upper()]
        except KeyError:
            raise TpuMtError(
                f"unknown space {s!r}; valid: "
                f"{[m.name.lower() for m in cls]}"
            ) from None


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))


def place(x, space: "Space | str", device: torch.device) -> torch.Tensor:
    """Place ``x`` (numpy array or tensor) in ``space`` for a run on
    ``device`` (≅ ``gt::copy`` into a spaced tensor): DEVICE → a tensor
    on ``device``; HOST and MANAGED → a pinned CPU tensor when
    ``device`` is the card, a plain CPU tensor on a CPU run."""
    space = Space.parse(space)
    t = _as_tensor(x)
    if space is Space.DEVICE:
        return t.to(device)
    t = t.cpu()
    return t.pin_memory() if device.type == "cuda" else t


def to_device(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """Explicit promotion host → device (≅ H2D ``gt::copy`` /
    ``cudaMemcpy``)."""
    return x.to(device)


def ensure_device(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """The managed-space rule: a tensor not yet on ``device`` moves there
    on its first device use; one already there is returned unchanged."""
    return x if x.device == device else to_device(x, device)


def _kind(x: torch.Tensor) -> str:
    if x.device.type != "cpu":
        return "device"
    return "pinned_host" if x.is_pinned() else "host"


def meminfo(x) -> str:
    """Where a tensor actually lives (≅ MEMINFO/PTRINFO,
    ``cuda_error.h:66-136``)."""
    if not isinstance(x, torch.Tensor):
        return f"host(python:{type(x).__name__})"
    return (
        f"kind={_kind(x)} devices=[{x.device}] "
        f"nbytes={x.numel() * x.element_size()} "
        f"dtype={str(x.dtype).removeprefix('torch.')} "
        f"shape={tuple(x.shape)}"
    )
