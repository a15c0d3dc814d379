"""JAX-package state → the port's tensors.

``state_from_jax`` takes what the JAX package's runners carry — one
ghosted domain, or an S-tuple of resident blocks — as numpy arrays (what
``np.asarray`` of a ``jax.Array`` gives) and returns torch tensors of the
same dtype on ``device``, bit for bit. bfloat16 arrives as
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
