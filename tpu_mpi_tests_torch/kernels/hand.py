"""The hand-written CUDA kernels' wrappers and their plain-torch twins.

Two kernels carry the main path (≅ the two Pallas kernels of
``tpu_mpi_tests/kernels/pallas_kernels.py`` they replace):

* :func:`stencil2d_iterate` — k timesteps of the in-place-style update
  ``z += scale_eps·D5(z)`` along ``dim`` over k·N_BND-deep ghosts
  (``stencil2d_iterate_pallas``, :1177); source ``csrc/stencil_iterate.cu``.
* :func:`stencil2d_deriv` — the out-of-place 5-point derivative × scale
  (``stencil2d_pallas``, :636); source ``csrc/stencil_deriv.cu``.

A wrapper given a CUDA tensor launches its kernel on the current stream
or raises; it takes the plain version (``*_ref``) only because the
tensor it was given lies on the CPU. Each wrapper counts its launches in
a plain integer attribute (``stencil2d_iterate.launches``), so a run can
show that its main path went through the kernel.

The plain versions repeat the kernels' arithmetic op for op (coefficients
rounded to the array dtype first), so on the card a kernel and its plain
version agree bit for bit in float32 and bfloat16.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_mpi_tests_torch.kernels import build
from tpu_mpi_tests_torch.kernels.stencil import (
    N_BND,
    STENCIL5,
    coef,
    stencil1d_5,
)

# STENCIL5 is antisymmetric: the update uses the 2-difference form
# C1·(z₊₁−z₋₁) + C2·(z₊₂−z₋₂), as the JAX kernel's _step5 does
_C1, _C2 = float(STENCIL5[3]), float(STENCIL5[4])

#: dtype → the code the C entry points take (csrc/stencil_common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}

_c_void_p, _c_int, _c_ll, _c_double = (
    ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double)
_SIGNATURES = {
    "tpumt_stencil2d_iterate": [
        _c_void_p, _c_void_p, _c_int, _c_int, _c_ll, _c_ll, _c_int,
        _c_double, _c_double, _c_double, _c_int, _c_int, _c_void_p,
        _c_void_p,
    ],
    "tpumt_stencil2d_deriv": [
        _c_void_p, _c_void_p, _c_int, _c_int, _c_ll, _c_ll,
        _c_double, _c_double, _c_double, _c_double, _c_double, _c_double,
        _c_void_p,
    ],
}


def _entry(lib_name: str, fn_name: str):
    fn = getattr(build.load(lib_name), fn_name)
    fn.argtypes = _SIGNATURES[fn_name]
    fn.restype = ctypes.c_int
    return fn


def _rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` (what :func:`coef` multiplies by),
    as a Python float — exactly representable, so the kernel's
    double → dtype conversion is exact."""
    return torch.tensor(float(value), dtype=dtype).item()


def _check_cuda_operand(z: torch.Tensor, name: str) -> None:
    if z.dtype not in DTYPE_CODES:
        raise TypeError(
            f"{name}: dtype {z.dtype} unsupported by the CUDA kernel "
            f"(float32, float64, bfloat16)"
        )
    if not z.is_contiguous():
        raise ValueError(f"{name}: the CUDA kernel needs a contiguous "
                         f"tensor")


def _check_out(out: torch.Tensor, z: torch.Tensor, shape, name: str):
    if out.shape != torch.Size(shape) or out.dtype != z.dtype \
            or out.device != z.device:
        raise ValueError(
            f"{name}: out must be {tuple(shape)} {z.dtype} on {z.device}, "
            f"got {tuple(out.shape)} {out.dtype} on {out.device}"
        )
    if not out.is_contiguous():
        raise ValueError(f"{name}: out must be contiguous")
    if out.untyped_storage().data_ptr() == z.untyped_storage().data_ptr():
        raise ValueError(
            f"{name}: out must not share storage with z (the kernel is "
            f"out-of-place: CTAs that split the stencil axis would read "
            f"rows a neighbour already overwrote)"
        )


def _raise_launch(name: str, rc: int) -> None:
    raise RuntimeError(
        f"{name}: CUDA kernel launch failed with cudaError {rc}"
    )


# ---------------------------------------------------------------------------
# k-step iterate
# ---------------------------------------------------------------------------


def _iterate_flags(steps, phys_static, phys):
    # spans coincide at s=1, so the flags are irrelevant there; with no
    # flags at all both sides are exchange-fed (the JAX signature's rule)
    if steps == 1 or (phys is None and phys_static is None):
        return (0, 0), None
    return phys_static, phys


def _check_iterate(z: torch.Tensor, dim: int, steps: int) -> None:
    if z.dim() != 2:
        raise ValueError(f"stencil2d_iterate: 2-D input required, got "
                         f"shape {tuple(z.shape)}")
    if dim not in (0, 1):
        raise ValueError(f"dim must be 0 or 1, got {dim}")
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    if z.shape[dim] <= 2 * steps * N_BND:
        raise ValueError(
            f"extent {z.shape[dim]} along dim {dim} too small for "
            f"{steps}-step ghost width {2 * steps * N_BND}"
        )


def stencil2d_iterate_ref(z: torch.Tensor, scale_eps: float, dim: int = 1,
                          steps: int = 1, phys_static=None, phys=None
                          ) -> torch.Tensor:
    """Plain-torch version of :func:`stencil2d_iterate` (returns a new
    tensor). At step s, index a along ``dim`` is updated iff
    a ∈ [dlo_s, dhi_s): dlo_s = K if the lo side is physical else s·N_BND,
    dhi_s = N − (K if the hi side is physical else s·N_BND), K = steps·N_BND
    — the spans of ``_iterate_kernel``/``_kstep_advance``."""
    _check_iterate(z, dim, steps)
    phys_static, phys = _iterate_flags(steps, phys_static, phys)
    if phys_static is None:
        plo, phi = (int(v) != 0 for v in
                    torch.as_tensor(phys).reshape(2).tolist())
    else:
        plo, phi = bool(phys_static[0]), bool(phys_static[1])
    z = z.clone()
    n = z.shape[dim]
    K = steps * N_BND
    se, c1, c2 = coef(scale_eps, z), coef(_C1, z), coef(_C2, z)
    for s in range(1, steps + 1):
        dlo = K if plo else s * N_BND
        span = n - (K if phi else s * N_BND) - dlo

        def zs(off):
            return z.narrow(dim, dlo + off, span)

        upd = zs(0) + se * (c1 * (zs(1) - zs(-1)) + c2 * (zs(2) - zs(-2)))
        zs(0).copy_(upd)
    return z


def stencil2d_iterate(z: torch.Tensor, scale_eps: float, dim: int = 1,
                      steps: int = 1, phys_static=None, phys=None,
                      out: "torch.Tensor | None" = None) -> torch.Tensor:
    """``steps`` timesteps of ``interior += scale_eps·D5`` along ``dim``
    (≅ ``stencil2d_iterate_pallas``), written to ``out`` (a new tensor
    when None) — never in place: ``out`` must not share storage with
    ``z``. Callers ping-pong two buffers.

    Physical sides are flagged statically (``phys_static=(lo, hi)``) or
    dynamically (``phys``, two ints — a device tensor on the card); with
    neither, both sides are exchange-fed. Ghost rows are part of the
    result: on an exchange-fed side rows [N_BND, K) come back partly
    advanced, as the JAX kernel returns them."""
    _check_iterate(z, dim, steps)
    if out is not None:
        _check_out(out, z, z.shape, "stencil2d_iterate")
    if z.device.type == "cpu":
        ref = stencil2d_iterate_ref(z, scale_eps, dim, steps, phys_static,
                                    phys)
        return ref if out is None else out.copy_(ref)
    if z.device.type != "cuda":
        raise ValueError(f"stencil2d_iterate: unsupported device {z.device}")
    _check_cuda_operand(z, "stencil2d_iterate")
    phys_static, phys = _iterate_flags(steps, phys_static, phys)
    plo = phi = 0
    ph = None
    if phys_static is None:
        ph = torch.as_tensor(phys, dtype=torch.int32,
                             device=z.device).reshape(-1).contiguous()
        if ph.numel() != 2:
            raise ValueError("phys must hold two flags (lo, hi)")
    else:
        plo, phi = int(bool(phys_static[0])), int(bool(phys_static[1]))
    if out is None:
        out = torch.empty_like(z)
    fn = _entry("stencil_iterate", "tpumt_stencil2d_iterate")
    with torch.cuda.device(z.device):
        rc = fn(
            z.data_ptr(), out.data_ptr(), DTYPE_CODES[z.dtype], dim,
            z.shape[0], z.shape[1], steps,
            _rounded(scale_eps, z.dtype), _rounded(_C1, z.dtype),
            _rounded(_C2, z.dtype), plo, phi,
            None if ph is None else ph.data_ptr(),
            torch.cuda.current_stream(z.device).cuda_stream,
        )
    if rc != 0:
        _raise_launch("stencil2d_iterate", rc)
    stencil2d_iterate.launches += 1
    return out


stencil2d_iterate.launches = 0


# ---------------------------------------------------------------------------
# out-of-place derivative
# ---------------------------------------------------------------------------


def _deriv_shape(z: torch.Tensor, dim: int):
    if z.dim() != 2:
        raise ValueError(f"stencil2d_deriv: 2-D input required, got "
                         f"shape {tuple(z.shape)}")
    if dim not in (0, 1):
        raise ValueError(f"dim must be 0 or 1, got {dim}")
    if z.shape[dim] < 2 * N_BND + 1:
        raise ValueError(
            f"stencil axis {dim} needs >= {2 * N_BND + 1} points, got "
            f"{z.shape[dim]}"
        )
    shape = list(z.shape)
    shape[dim] -= 2 * N_BND
    return tuple(shape)


def stencil2d_deriv_ref(z: torch.Tensor, scale, dim: int = 0
                        ) -> torch.Tensor:
    """Plain-torch version of :func:`stencil2d_deriv`: the torch-op
    stencil, whose accumulation order is the kernel's."""
    _deriv_shape(z, dim)
    return stencil1d_5(z, scale=scale, axis=dim)


def stencil2d_deriv(z: torch.Tensor, scale, dim: int = 0,
                    out: "torch.Tensor | None" = None) -> torch.Tensor:
    """5-point first derivative × ``scale`` along ``dim`` of a 2-D array
    ghosted along ``dim`` (out has 2·N_BND fewer points there; ≅
    ``stencil2d_pallas`` and the SYCL ``stencil2d_1d_5``)."""
    shape = _deriv_shape(z, dim)
    if out is not None:
        _check_out(out, z, shape, "stencil2d_deriv")
    if z.device.type == "cpu":
        ref = stencil2d_deriv_ref(z, scale, dim)
        return ref if out is None else out.copy_(ref)
    if z.device.type != "cuda":
        raise ValueError(f"stencil2d_deriv: unsupported device {z.device}")
    _check_cuda_operand(z, "stencil2d_deriv")
    if out is None:
        out = torch.empty(shape, dtype=z.dtype, device=z.device)
    c = [_rounded(v, z.dtype) for v in STENCIL5.tolist()]
    fn = _entry("stencil_deriv", "tpumt_stencil2d_deriv")
    with torch.cuda.device(z.device):
        rc = fn(
            z.data_ptr(), out.data_ptr(), DTYPE_CODES[z.dtype], dim,
            z.shape[0], z.shape[1], *c, _rounded(scale, z.dtype),
            torch.cuda.current_stream(z.device).cuda_stream,
        )
    if rc != 0:
        _raise_launch("stencil2d_deriv", rc)
    stencil2d_deriv.launches += 1
    return out


stencil2d_deriv.launches = 0

#: every wrapper of a hand kernel (name → function with a .launches count)
WRAPPERS = {
    "stencil2d_iterate": stencil2d_iterate,
    "stencil2d_deriv": stencil2d_deriv,
}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
