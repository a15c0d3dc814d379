"""Reductions: sum-of-squares error norms and axis sums as torch ops
(≅ ``tpu_mpi_tests/kernels/reductions.py``; ``gt::sum_squares``
``mpi_stencil_gt.cc:222``, ``gt::sum_axis_to`` ``mpi_stencil2d_gt.cc:611``).
"""

from __future__ import annotations

import torch


def sum_squares(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.square(x))


def err_norm(numeric: torch.Tensor, actual: torch.Tensor) -> torch.Tensor:
    """sqrt(Σ(numeric − actual)²) — the stencil correctness gate."""
    return torch.sqrt(sum_squares(numeric - actual))


def sum_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Reduce one axis to a vector (≅ ``gt::sum_axis_to``)."""
    return torch.sum(x, dim=axis)
