"""Collectives and shard placement at world=1 — the subset of
``tpu_mpi_tests/comm/collectives.py`` the stencil2d, grid and DAXPY
drivers and the bench use. With one rank, the allreduce is the identity,
a gather copies the one shard and the per-rank vectors have one entry
per logical rank; the functions keep the JAX signatures' roles so the
multi-rank slice (ROADMAP queue 1 item 2) can fill them in.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_mpi_tests_torch.utils import TpuMtError, check_divisible


def shard_1d(arr, device) -> torch.Tensor:
    """The global array placed on the ranks along axis 0 (≅ each rank
    holding its block): at world=1 the whole array (numpy or tensor) on
    ``device``."""
    t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(arr))
    return t.to(device)


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """``MPI_Allgather`` of each rank's shard into a full copy per rank:
    at world=1 a new tensor holding the one shard."""
    return x.clone()


def all_gather_inplace(allx: torch.Tensor) -> torch.Tensor:
    """``MPI_Allgather(MPI_IN_PLACE)`` parity: ``allx`` is the full-size
    buffer whose own slice each rank has filled; the gathered buffer is
    ``allx`` itself (the JAX function donates its input for the same
    reason). At world=1 every slice is already in place."""
    return allx


def per_rank_sums(x: torch.Tensor, groups_per_shard: int = 1
                  ) -> np.ndarray:
    """Per-logical-rank local sums as a host numpy vector (≅ each rank's
    local checksum, ``mpi_daxpy_nvtx.cc:251-267``): the one shard split
    into ``groups_per_shard`` equal logical ranks (the reference's
    ``ranks_per_device`` oversubscription, ``mpi_daxpy.cc:49-51``), each
    summed on the device in the array's dtype, as the JAX function
    sums."""
    check_divisible(x.shape[0], groups_per_shard, "per_rank_sums groups")
    return host_value(torch.sum(x.reshape(groups_per_shard, -1), dim=1))


def barrier(device: torch.device) -> None:
    """≅ ``MPI_Barrier``: at world=1, wait until the device has finished
    all queued work (the JAX function completes a collective and blocks
    on it)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def shard_blocks(global_shape, dtype: torch.dtype, block_fn, device,
                 axis: int = 0) -> torch.Tensor:
    """The global array built from per-rank host blocks: at world=1 the
    one block ``block_fn(0)`` (a numpy array), moved to ``device`` and
    cast to ``dtype``."""
    block = np.ascontiguousarray(block_fn(0))
    if tuple(block.shape) != tuple(global_shape):
        raise TpuMtError(
            f"shard_blocks: block shape {block.shape} != global shape "
            f"{tuple(global_shape)} at world=1 (axis {axis})"
        )
    return torch.from_numpy(block).to(device=device, dtype=dtype)


def device_init(block_fn) -> torch.Tensor:
    """The global array computed on the device: at world=1 the one block
    ``block_fn(0)`` (a torch helper such as
    ``Domain2D.init_shard_torch``)."""
    return block_fn(0)


def per_rank_err_norms(numeric: torch.Tensor, actual: torch.Tensor
                       ) -> np.ndarray:
    """Per-rank ``sqrt(Σ(numeric − actual)²)`` (≅ each rank's err_norm,
    ``mpi_stencil_gt.cc:222``); the sum runs in the arrays' dtype on the
    device, as the JAX function's does. One entry at world=1."""
    d = numeric - actual
    s = torch.sum(d * d)
    return np.sqrt(np.array([float(s)], dtype=np.float64))


def allreduce_sum(per_rank: torch.Tensor) -> torch.Tensor:
    """In-place ``MPI_Allreduce(MPI_SUM)`` parity: ``per_rank`` has one
    row per rank; every row becomes the sum. At world=1 that is the
    identity."""
    if per_rank.shape[0] != 1:
        raise TpuMtError(
            f"allreduce_sum: leading axis {per_rank.shape[0]} must equal "
            f"the world size 1 (one row per rank)"
        )
    return per_rank


def host_value(x: torch.Tensor) -> np.ndarray:
    """A tensor's value on the host as numpy; bfloat16 (which numpy
    lacks) widens to float32 exactly."""
    x = x.detach()
    if x.dtype == torch.bfloat16:
        x = x.float()
    return x.cpu().numpy()
