"""Shared fail-fast helpers (≅ ``tpu_mpi_tests/utils.py``, kept as the
port's own copy so the port never imports the JAX package)."""

from __future__ import annotations


class TpuMtError(ValueError):
    """Base error for invalid configurations (fail-fast)."""


def check_divisible(n: int, by: int, what: str = "size") -> int:
    """Fail-fast divisibility precondition (≅ the reference's early exit
    when the global size does not divide across ranks,
    ``mpi_stencil_gt.cc:141-145``). Returns ``n // by``."""
    if by <= 0:
        raise TpuMtError(f"{what}: divisor must be positive, got {by}")
    if n % by != 0:
        raise TpuMtError(f"{what}: {n} not evenly divisible by {by}")
    return n // by
