"""Collectives and shard placement at world=1 — the subset of
``tpu_mpi_tests/comm/collectives.py`` the stencil2d driver and the bench
use. With one rank, the allreduce is the identity and the per-rank error
vector has one entry; the functions keep the JAX signatures' roles so
the multi-rank slice can fill them in.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_mpi_tests_torch.utils import TpuMtError


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
