"""DAXPY: y ← a·x + y (≅ ``tpu_mpi_tests/kernels/daxpy.py``).

The torch tier of ``cublasDaxpy`` (``daxpy.cu:72-73``,
``mpi_daxpy_gt.cc:81``): one elementwise launch, bound by device memory
(three array accesses per element), so GB/s is the comparable metric.
The hand-written CUDA kernel is ``kernels.hand.daxpy``; the drivers use
this tier, as the JAX drivers use XLA's fused op.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_mpi_tests_torch.arrays.domain import _arange, _scalar


def daxpy(a: float, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """y ← a·x + y as one launch (a new tensor; ``a`` is rounded to the
    tensors' dtype first, as a weak-typed scalar is in the JAX op). On
    the card the multiply and the add may fuse into one FMA, as XLA may
    fuse them; at a = 2 (every driver gate) both forms are exact."""
    return torch.add(y, x, alpha=_scalar(a, x.dtype).item())


def daxpy_bytes(n: int, dtype: torch.dtype = torch.float32) -> int:
    """Memory traffic of one daxpy: read x, read y, write y."""
    return 3 * n * torch.empty((), dtype=dtype).element_size()


def init_xy(n: int, dtype: torch.dtype = torch.float32, device="cpu"):
    """Reference initialization x=i+1, y=-(i+1) (``daxpy.cu:56-59``),
    computed on ``device`` as ``jnp.arange(1, n + 1, dtype)`` builds it;
    y ← 2x+y = i+1 and the exact checksum is n(n+1)/2."""
    i = _arange(1, n + 1, dtype, device)
    return i, -i


def init_xy_np(n: int, dtype=np.float64):
    """Host-side variant of :func:`init_xy` (``mpi_daxpy.cc:94-97``)."""
    i = np.arange(1, n + 1, dtype=np.float64).astype(dtype)
    return i, -i


def init_xy_scaled_np(n: int, dtype=np.float64):
    """Flagship init x=(i+1)/n, y=-x (``mpi_daxpy_nvtx.cc:207-217``); with
    a=2 the result is y=x and the local checksum is (n+1)/2."""
    x = (np.arange(1, n + 1, dtype=np.float64) / n).astype(dtype)
    return x, -x


def init_xy_scaled(n: int, dtype: torch.dtype, device="cpu"):
    """Device-side twin of :func:`init_xy_scaled_np` (≅
    ``init_xy_scaled_jax``): at 48Mi elements the host init and copy cost
    more than the kernel, and the pattern is analytic. Computed as the
    JAX helper computes it: ``arange(1, n + 1)`` in the dtype, divided by
    ``n`` rounded to the dtype."""
    x = _arange(1, n + 1, dtype, device) / _scalar(n, dtype)
    return x, -x


def expected_checksum(n: int) -> float:
    return n * (n + 1) / 2


def expected_checksum_scaled(n: int) -> float:
    return (n + 1) / 2
