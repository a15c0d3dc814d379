"""Domain decomposition: ghost-cell layouts and local↔global index math.

The port's own copy of ``tpu_mpi_tests/arrays/domain.py`` (the numpy
layouts are unchanged, so ``init_shard`` is bit-identical to the JAX
package's). Conventions follow the reference exactly so error norms are
comparable:

* the global domain is ``[0, length)`` sampled at ``n_global`` points with
  spacing ``delta = length / n_global`` (``mpi_stencil_gt.cc:166-168``);
* shard ``r`` owns interior points ``r*n_local .. (r+1)*n_local - 1``;
* each shard carries ``n_bnd`` ghost points on both sides of the decomposed
  axis; interior ghosts are filled by halo exchange, *physical* ghosts on
  the first/last shard are filled analytically
  (``mpi_stencil_gt.cc:185-196``, ``mpi_stencil2d_gt.cc:458-497``).

The JAX package's traceable ``*_jax`` helpers become ``*_torch`` helpers
that compute the field ON THE DEVICE the way the JAX helpers do: in the
target dtype, op by op, in the same order (``start + idx·delta``, then
``fn``), with every Python scalar rounded to that dtype first (JAX's
weak-typed scalars) and the index vector built as ``jnp.arange`` builds
it (an iota in the dtype, plus the start). So the fields equal the JAX
helpers' bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from tpu_mpi_tests_torch.utils import check_divisible


def _scalar(value, dtype: torch.dtype) -> torch.Tensor:
    """``value`` rounded to ``dtype`` as a 0-dim CPU tensor — what a
    weak-typed Python scalar becomes in a JAX op on a ``dtype`` array."""
    return torch.tensor(float(value), dtype=dtype)


def _arange(lo: int, hi: int, dtype: torch.dtype, device) -> torch.Tensor:
    """``jnp.arange(lo, hi, dtype=dtype)``: an iota in ``dtype`` (index
    ``i`` rounded to the dtype), plus ``lo`` in the dtype when ``lo`` is
    not 0 — in bfloat16 that differs from the correctly rounded values
    past 256."""
    idx = torch.arange(hi - lo, dtype=dtype, device=device)
    return idx if lo == 0 else _scalar(lo, dtype) + idx


@dataclasses.dataclass(frozen=True)
class Domain1D:
    """1-D decomposed domain (≅ mpi_stencil_gt.cc sizing block :152-168)."""

    n_global: int
    n_shards: int
    n_bnd: int = 2
    length: float = 8.0

    def __post_init__(self):
        check_divisible(self.n_global, self.n_shards, "Domain1D n_global")

    @property
    def n_local(self) -> int:
        return self.n_global // self.n_shards

    @property
    def delta(self) -> float:
        return self.length / self.n_global

    @property
    def scale(self) -> float:
        """1/delta — the stencil scale factor (`mpi_stencil_gt.cc:168`)."""
        return self.n_global / self.length

    @property
    def n_ghosted(self) -> int:
        return self.n_local + 2 * self.n_bnd

    def interior_coords(self, rank: int, dtype=np.float64) -> np.ndarray:
        x0 = rank * (self.length / self.n_shards)
        return x0 + np.arange(self.n_local, dtype=dtype) * self.delta

    def ghosted_coords(self, rank: int, dtype=np.float64) -> np.ndarray:
        """Coordinates for the full ghosted block (ghosts continue the
        global grid, which for edge shards extends past [0, length))."""
        x0 = rank * (self.length / self.n_shards)
        idx = np.arange(-self.n_bnd, self.n_local + self.n_bnd, dtype=dtype)
        return x0 + idx * self.delta

    def init_shard(
        self, fn: Callable[[np.ndarray], np.ndarray], rank: int, dtype=np.float64
    ) -> np.ndarray:
        """Ghosted local block with interior = fn(x); interior ghosts zero;
        physical ghosts on edge shards filled analytically."""
        out = np.zeros(self.n_ghosted, dtype=dtype)
        out[self.n_bnd : self.n_bnd + self.n_local] = fn(
            self.interior_coords(rank, dtype)
        )
        xg = self.ghosted_coords(rank, dtype)
        if rank == 0:
            out[: self.n_bnd] = fn(xg[: self.n_bnd])
        if rank == self.n_shards - 1:
            out[-self.n_bnd :] = fn(xg[-self.n_bnd :])
        return out

    def _start(self, rank: int, dtype: torch.dtype) -> torch.Tensor:
        return _scalar(rank, dtype) * _scalar(self.n_local * self.delta,
                                              dtype)

    def init_shard_torch(self, fn, rank: int, dtype: torch.dtype,
                         device) -> torch.Tensor:
        """Device-side ghosted-shard init in ``dtype`` on ``device`` —
        same layout as :meth:`init_shard`, same values as
        ``init_shard_jax``."""
        idx = _arange(-self.n_bnd, self.n_local + self.n_bnd, dtype, device)
        x = self._start(rank, dtype) + idx * _scalar(self.delta, dtype)
        full = fn(x).to(dtype)
        i = torch.arange(self.n_ghosted, device=device)
        keep = (i >= self.n_bnd) & (i < self.n_bnd + self.n_local)
        if rank == 0:
            keep |= i < self.n_bnd
        if rank == self.n_shards - 1:
            keep |= i >= self.n_bnd + self.n_local
        return torch.where(keep, full, _scalar(0.0, dtype).to(device))

    def interior_shard_torch(self, fn, rank: int, dtype: torch.dtype,
                             device) -> torch.Tensor:
        """Device-side unghosted-shard field (err-norm references)."""
        idx = _arange(0, self.n_local, dtype, device)
        x = self._start(rank, dtype) + idx * _scalar(self.delta, dtype)
        return fn(x).to(dtype)

    def init_global(self, fn, dtype=np.float64) -> np.ndarray:
        """Ghosted-global concatenation of all shard blocks."""
        return np.concatenate(
            [self.init_shard(fn, r, dtype) for r in range(self.n_shards)]
        )

    def interior_global(self, fn, dtype=np.float64) -> np.ndarray:
        """Unghosted global field fn(x) — reference values for err norms."""
        return np.concatenate(
            [fn(self.interior_coords(r, dtype)) for r in range(self.n_shards)]
        )

    def strip_ghosts_global(self, zg: np.ndarray) -> np.ndarray:
        """Drop ghost points from a ghosted-global array → unghosted global."""
        blocks = zg.reshape(self.n_shards, self.n_ghosted)
        return blocks[:, self.n_bnd : self.n_bnd + self.n_local].reshape(-1)


@dataclasses.dataclass(frozen=True)
class Domain2D:
    """2-D array decomposed along one axis (≅ mpi_stencil2d_gt.cc:395-417).

    ``dim`` is the decomposed/derivative axis (0 or 1); the other axis is
    global on every shard. The decomposed axis is weak-scaled
    (``n_local_deriv`` per shard), the other axis is fixed globally
    (``mpi_stencil2d_gt.cc:656,675-676``).
    """

    n_local_deriv: int
    n_global_other: int
    n_shards: int
    dim: int = 0
    n_bnd: int = 2
    length: float = 8.0

    def __post_init__(self):
        if self.dim not in (0, 1):
            raise ValueError(f"dim must be 0 or 1, got {self.dim}")

    @property
    def n_global_deriv(self) -> int:
        return self.n_local_deriv * self.n_shards

    @property
    def delta(self) -> float:
        return self.length / self.n_global_deriv

    @property
    def scale(self) -> float:
        return self.n_global_deriv / self.length

    @property
    def local_shape(self) -> tuple[int, int]:
        s = [0, 0]
        s[self.dim] = self.n_local_deriv
        s[1 - self.dim] = self.n_global_other
        return tuple(s)

    @property
    def ghosted_shape(self) -> tuple[int, int]:
        s = list(self.local_shape)
        s[self.dim] += 2 * self.n_bnd
        return tuple(s)

    @property
    def global_ghosted_shape(self) -> tuple[int, int]:
        s = list(self.ghosted_shape)
        s[self.dim] *= self.n_shards
        return tuple(s)

    @property
    def global_interior_shape(self) -> tuple[int, int]:
        s = list(self.local_shape)
        s[self.dim] *= self.n_shards
        return tuple(s)

    def _coords(self, rank: int, ghosted: bool, dtype):
        """(x, y) 1-D coordinate vectors for this shard's block."""
        start = rank * self.n_local_deriv * self.delta
        if ghosted:
            idx = np.arange(
                -self.n_bnd, self.n_local_deriv + self.n_bnd, dtype=dtype
            )
        else:
            idx = np.arange(self.n_local_deriv, dtype=dtype)
        deriv_c = start + idx * self.delta
        other_c = np.arange(self.n_global_other, dtype=dtype) * self.delta
        return (deriv_c, other_c) if self.dim == 0 else (other_c, deriv_c)

    def init_shard(self, fn, rank: int, dtype=np.float64) -> np.ndarray:
        """Ghosted local block; interior = fn(x, y) on the shard grid;
        physical ghosts analytic on edge shards, interior ghosts zero."""
        x, y = self._coords(rank, ghosted=True, dtype=dtype)
        full = fn(x[:, None], y[None, :]).astype(dtype)
        out = np.zeros(self.ghosted_shape, dtype=dtype)
        sl = [slice(None), slice(None)]
        sl[self.dim] = slice(self.n_bnd, self.n_bnd + self.n_local_deriv)
        out[tuple(sl)] = full[tuple(sl)]
        if rank == 0:
            lo = [slice(None), slice(None)]
            lo[self.dim] = slice(0, self.n_bnd)
            out[tuple(lo)] = full[tuple(lo)]
        if rank == self.n_shards - 1:
            hi = [slice(None), slice(None)]
            hi[self.dim] = slice(self.n_bnd + self.n_local_deriv, None)
            out[tuple(hi)] = full[tuple(hi)]
        return out

    def init_global(self, fn, dtype=np.float64) -> np.ndarray:
        return np.concatenate(
            [self.init_shard(fn, r, dtype) for r in range(self.n_shards)],
            axis=self.dim,
        )

    def _coords_torch(self, rank: int, ghosted: bool, dtype, device):
        """(x, y) coordinate vectors in ``dtype`` on ``device``, computed
        as ``_coords_jax`` computes them."""
        start = _scalar(rank, dtype) * _scalar(
            self.n_local_deriv * self.delta, dtype)
        lo = -self.n_bnd if ghosted else 0
        hi = self.n_local_deriv + (self.n_bnd if ghosted else 0)
        delta = _scalar(self.delta, dtype)
        deriv_c = start + _arange(lo, hi, dtype, device) * delta
        other_c = _arange(0, self.n_global_other, dtype, device) * delta
        return (
            (deriv_c, other_c) if self.dim == 0 else (other_c, deriv_c)
        )

    def init_shard_torch(self, fn, rank: int, dtype: torch.dtype,
                         device) -> torch.Tensor:
        """Device-side ghosted-shard init: interior = fn, physical ghosts
        analytic on edge shards, interior ghosts zero — the layout of
        :meth:`init_shard`, the values of ``init_shard_jax``."""
        x, y = self._coords_torch(rank, True, dtype, device)
        full = fn(x[:, None], y[None, :]).to(dtype)
        i = torch.arange(self.n_local_deriv + 2 * self.n_bnd, device=device)
        keep = (i >= self.n_bnd) & (i < self.n_bnd + self.n_local_deriv)
        if rank == 0:
            keep |= i < self.n_bnd
        if rank == self.n_shards - 1:
            keep |= i >= self.n_bnd + self.n_local_deriv
        shape = [1, 1]
        shape[self.dim] = keep.shape[0]
        return torch.where(keep.reshape(shape), full,
                           _scalar(0.0, dtype).to(device))

    def interior_shard_torch(self, fn, rank: int, dtype: torch.dtype,
                             device) -> torch.Tensor:
        """Device-side unghosted-shard field — err-norm references."""
        x, y = self._coords_torch(rank, False, dtype, device)
        return fn(x[:, None], y[None, :]).to(dtype)

    def interior_shard(self, fn, rank: int, dtype=np.float64) -> np.ndarray:
        """One rank's unghosted block of fn(x, y) — per-rank err-norm
        reference values (the global field is never materialized)."""
        x, y = self._coords(rank, ghosted=False, dtype=dtype)
        return fn(x[:, None], y[None, :]).astype(dtype)

    def interior_global(self, fn, dtype=np.float64) -> np.ndarray:
        """Unghosted global field fn(x, y) — err-norm reference values."""
        return np.concatenate(
            [self.interior_shard(fn, r, dtype) for r in range(self.n_shards)],
            axis=self.dim,
        )

    def strip_ghosts_global(self, zg: np.ndarray) -> np.ndarray:
        ng = self.ghosted_shape[self.dim]
        blocks = np.split(zg, self.n_shards, axis=self.dim)
        sl = [slice(None), slice(None)]
        sl[self.dim] = slice(self.n_bnd, ng - self.n_bnd)
        return np.concatenate([b[tuple(sl)] for b in blocks], axis=self.dim)
