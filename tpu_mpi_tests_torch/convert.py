"""JAX-package state → the port's tensors.

``state_from_jax`` takes what the JAX package's runners carry — one
ghosted domain, or an S-tuple of resident blocks — as numpy arrays (what
``np.asarray`` of a ``jax.Array`` gives) and returns torch tensors of the
same dtype on ``device``, bit for bit. ``grid_block`` cuts one rank's
ghosted block out of the JAX grid drivers' global host layout (the
blocks of a ``px × py`` grid side by side, ghosts included) and
``grid_join`` puts the blocks back. bfloat16 arrives as
``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses; it travels as
its 16-bit pattern (``.view(np.uint16)`` → ``.view(torch.bfloat16)``).
Nothing here imports jax or ml_dtypes.
"""

from __future__ import annotations

import numpy as np
import torch


def _is_bfloat16(dtype: np.dtype) -> bool:
    return dtype.name == "bfloat16"


def array_from_jax(x, device="cpu") -> torch.Tensor:
    """One array (numpy or anything ``np.asarray`` accepts) → a tensor."""
    # an owned, writable copy: arrays read from jax are read-only views
    a = np.array(np.asarray(x), copy=True, order="C")
    if _is_bfloat16(a.dtype):
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def state_from_jax(x, device="cpu"):
    """A ghosted domain → a tensor; a tuple/list of blocks → a tuple of
    tensors (the form ``iterate_hand_blocks_fn`` runs on)."""
    if isinstance(x, (tuple, list)):
        return tuple(array_from_jax(b, device) for b in x)
    return array_from_jax(x, device)


def grid_block(zg, px: int, py: int, rx: int, ry: int):
    """Block ``(rx, ry)`` of a ``px × py`` grid's global ghosted layout
    ``(px·gxs, py·gys)`` (``tpu_mpi_tests/drivers/heat2d.py:80-94``,
    ``stencil2d_grid.py``: each block ghosted on its own), numpy or
    tensor, as a view."""
    gxs, gys = zg.shape[0] // px, zg.shape[1] // py
    if gxs * px != zg.shape[0] or gys * py != zg.shape[1]:
        raise ValueError(f"grid_block: {tuple(zg.shape)} is not a {px}x{py} "
                         f"grid of equal blocks")
    return zg[rx * gxs:(rx + 1) * gxs, ry * gys:(ry + 1) * gys]


def grid_join(blocks, px: int, py: int):
    """The global layout from the ``px · py`` blocks in rank order
    (row-major: rank ``rx·py + ry`` holds block ``(rx, ry)``), numpy or
    tensors; the inverse of :func:`grid_block`."""
    blocks = list(blocks)
    if len(blocks) != px * py:
        raise ValueError(f"grid_join: {len(blocks)} blocks for a {px}x{py} "
                         f"grid")
    rows = [blocks[rx * py:(rx + 1) * py] for rx in range(px)]
    if isinstance(blocks[0], torch.Tensor):
        return torch.cat([torch.cat(r, dim=1) for r in rows], dim=0)
    return np.block(rows)
