"""Halo pack/unpack as torch ops: edge-band extraction and ghost-band
writes (≅ ``tpu_mpi_tests/kernels/pack.py``; the reference's
``buf_from_view``/``buf_to_view`` SYCL kernels,
``mpi_stencil2d_sycl.cc:82-116``).

Layout along the exchange axis with boundary width ``b``::

    [0:b]        lo ghost      ← filled from the left neighbour's hi edge
    [b:2b]       lo edge       → sent to the left neighbour
    [n-2b:n-b]   hi edge       → sent to the right neighbour
    [n-b:n]      hi ghost      ← filled from the right neighbour's lo edge

``pack_edges`` returns new contiguous buffers (XLA copies a slice when it
materialises it, so the JAX function is the reference's "device staging
buffer" too). ``unpack_ghosts`` writes the two ghost bands IN PLACE and
returns ``z`` — the port's stated design difference for exchanges (the
JAX function is functional and returns an updated copy). The hand CUDA
kernels of the same names live in ``kernels/hand.py``; these are their
plain versions.
"""

from __future__ import annotations

import torch


def check_bands(n: int, n_bnd: int, what: str) -> None:
    """Both bands of width ``n_bnd`` must lie inside an extent of ``n``
    without meeting: below ``2·n_bnd`` the lo and hi bands overlap."""
    if n_bnd < 1:
        raise ValueError(f"{what}: n_bnd must be >= 1, got {n_bnd}")
    if n < 2 * n_bnd:
        raise ValueError(
            f"{what}: extent {n} along the exchange axis holds no two "
            f"bands of width {n_bnd} (needs >= {2 * n_bnd})"
        )


def pack_edges(z: torch.Tensor, axis: int = 0, n_bnd: int = 2):
    """The (lo_edge, hi_edge) interior bands to send to the neighbours,
    as new contiguous tensors (≅ ``buf_from_view``)."""
    n = z.shape[axis]
    check_bands(n, n_bnd, "pack_edges")
    lo = z.narrow(axis, n_bnd, n_bnd).clone(
        memory_format=torch.contiguous_format)
    hi = z.narrow(axis, n - 2 * n_bnd, n_bnd).clone(
        memory_format=torch.contiguous_format)
    return lo, hi


def unpack_ghosts(z: torch.Tensor, lo_ghost: torch.Tensor,
                  hi_ghost: torch.Tensor, axis: int = 0, n_bnd: int = 2
                  ) -> torch.Tensor:
    """Write received halo bands into the ghost bands of ``z``, in place
    (≅ ``buf_to_view``); returns ``z``."""
    n = z.shape[axis]
    check_bands(n, n_bnd, "unpack_ghosts")
    z.narrow(axis, 0, n_bnd).copy_(lo_ghost)
    z.narrow(axis, n - n_bnd, n_bnd).copy_(hi_ghost)
    return z


def interior(z: torch.Tensor, axis: int = 0, n_bnd: int = 2) -> torch.Tensor:
    """``z`` with the ghosts along ``axis`` stripped (a view)."""
    return z.narrow(axis, n_bnd, z.shape[axis] - 2 * n_bnd)
