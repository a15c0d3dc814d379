"""5-point 4th-order centered first-derivative stencils as torch ops
(≅ ``tpu_mpi_tests/kernels/stencil.py``; the gtensor expression templates
``mpi_stencil_gt.cc:54-59``, ``mpi_stencil2d_gt.cc:84-110``).

Coefficients are (1/12, -2/3, 0, 2/3, -1/12); the input carries
``N_BND = 2`` ghost points per side along the stencil axis and the output
is the interior (input size − 4 along that axis).

Rounding: JAX multiplies an array by a weak-typed Python float in the
ARRAY's dtype (the scalar is rounded to bf16 first for a bf16 array),
while torch keeps a Python scalar at float32 "opmath" precision. Every
coefficient here is therefore a 0-dim tensor of the array's dtype
(:func:`coef`), so bf16 results round where the JAX package rounds.
"""

from __future__ import annotations

import numpy as np
import torch

# 4th-order central first-derivative coefficients (× 1/delta).
STENCIL5 = np.array([1.0 / 12.0, -2.0 / 3.0, 0.0, 2.0 / 3.0, -1.0 / 12.0])
N_BND = 2  # (len(STENCIL5) - 1) // 2


def coef(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` rounded to ``like``'s dtype, as a 0-dim CPU tensor (a
    CPU scalar tensor is legal in ops on CUDA tensors and costs no
    host→device copy)."""
    return torch.tensor(float(value), dtype=like.dtype)


def stencil1d_5(y: torch.Tensor, scale=1.0, axis: int = 0) -> torch.Tensor:
    """Apply the 5-point stencil along ``axis``: ``y`` is ghosted along
    ``axis``; the result has ``y.shape[axis] - 4`` there. ``scale`` is
    1/delta, applied after the stencil (``mpi_stencil_gt.cc:206``).
    Accumulation order ``((c0·y0 + c1·y1) + c3·y3) + c4·y4`` then
    ``· scale``, as in the JAX function."""
    n = y.shape[axis]
    if n < 2 * N_BND + 1:
        raise ValueError(
            f"stencil axis {axis} needs >= {2 * N_BND + 1} points, got {n}"
        )
    m = n - 2 * N_BND
    out = None
    for k, c in enumerate(STENCIL5.tolist()):
        if c == 0.0:
            continue
        term = coef(c, y) * y.narrow(axis, k, m)
        out = term if out is None else out + term
    return out * coef(scale, y)


def stencil2d_1d_5(z: torch.Tensor, scale=1.0, dim: int = 0) -> torch.Tensor:
    """2-D array, 1-D stencil along ``dim`` (≅ ``stencil2d_1d_5_d0/_d1``,
    ``mpi_stencil2d_gt.cc:84-110``)."""
    return stencil1d_5(z, scale=scale, axis=dim)


def dual_dim_step(z: torch.Tensor, n_bnd: int, scale_x: float,
                  scale_y: float):
    """Both-dim derivative + residual of a block ghosted along both axes
    (≅ ``stencil2d_1d_5_d0`` + ``_d1`` + ``gt::sum_squares``,
    ``mpi_stencil2d_gt.cc:84-110,555``). Returns
    ``(dz_dx, dz_dy, residual)`` with the ghost frame stripped."""
    if n_bnd != N_BND:
        raise ValueError(
            f"dual_dim_step requires n_bnd == {N_BND} (the 5-point stencil "
            f"strips exactly 2*{N_BND} along its axis), got {n_bnd}"
        )
    zx = z.narrow(1, n_bnd, z.shape[1] - 2 * n_bnd)
    dz_dx = stencil1d_5(zx, scale=scale_x, axis=0)
    zy = z.narrow(0, n_bnd, z.shape[0] - 2 * n_bnd)
    dz_dy = stencil1d_5(zy, scale=scale_y, axis=1)
    residual = torch.sum(torch.square(dz_dx)) + torch.sum(torch.square(dz_dy))
    return dz_dx, dz_dy, residual


def _pow(x, n: int):
    """``x**n`` as JAX computes it: on a tensor, the multiplications XLA
    lowers an integer power to (``x·(x·x)`` for n=3, rounded per op in
    the tensor's dtype, whatever ``torch.pow`` does on the device); on a
    numpy array, numpy's own ``**`` (the JAX package's host init)."""
    if not isinstance(x, torch.Tensor):
        return x**n
    return x * x if n == 2 else x * (x * x)


def heat2d_steps_(z: torch.Tensor, cx: float, cy: float, steps: int = 1
                  ) -> torch.Tensor:
    """``steps`` explicit-Euler heat updates of ``z`` IN PLACE — the XLA
    body of ``heat_step2d_fn`` (``tpu_mpi_tests/comm/halo.py:1445-1457``)
    op for op: every cell of ``[1, n0−1) × [1, n1−1)`` (the maximal span)
    gets ``(mid + cx·((z₊₁ + z₋₁) − 2·mid)) + cy·(…)`` per axis, with
    ``cx``, ``cy`` and 2 rounded to the array dtype; the outer ring keeps
    its value. Returns ``z``."""
    two, cxt, cyt = coef(2.0, z), coef(cx, z), coef(cy, z)
    mid = z[1:-1, 1:-1]
    for _ in range(steps):
        d2x = z[2:, 1:-1] + z[:-2, 1:-1] - two * mid
        d2y = z[1:-1, 2:] + z[1:-1, :-2] - two * mid
        mid.copy_(mid + cxt * d2x + cyt * d2y)
    return z


def analytic_pairs():
    """The reference's test functions: (f, df) pairs used by the drivers.
    They work on numpy arrays and torch tensors alike.

    1-D: y = x³, dy/dx = 3x² (``mpi_stencil_gt.cc:171-172``).
    2-D: z = x³ + y², dz/dx = 3x², dz/dy = 2y
    (``mpi_stencil2d_gt.cc:431-433``).
    """

    def x_cubed(x):
        return _pow(x, 3)

    def x_cubed_deriv(x):
        return 3 * _pow(x, 2)

    def z_fn(x, y):
        return _pow(x, 3) + _pow(y, 2)

    def dz_dx(x, y):
        return 3 * _pow(x, 2) + 0 * y

    def dz_dy(x, y):
        return 0 * x + 2 * y

    return {
        "1d": (x_cubed, x_cubed_deriv),
        "2d_dim0": (z_fn, dz_dx),
        "2d_dim1": (z_fn, dz_dy),
    }
