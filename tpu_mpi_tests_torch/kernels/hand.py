"""The hand-written CUDA kernels' wrappers and their plain-torch twins.

Each replaces a Pallas kernel of
``tpu_mpi_tests/kernels/pallas_kernels.py``:

* :func:`stencil2d_iterate` — k timesteps of the in-place-style update
  ``z += scale_eps·D5(z)`` along ``dim`` over k·N_BND-deep ghosts
  (``stencil2d_iterate_pallas``, :1177); source ``csrc/stencil_iterate.cu``.
* :func:`stencil2d_deriv` — the out-of-place 5-point derivative × scale
  (``stencil2d_pallas``, :636); source ``csrc/stencil_deriv.cu``.
* :func:`heat2d` — k explicit-Euler steps of the 5-point Laplacian on a
  both-axes-ghosted shard (``heat2d_pallas``, :1448); source
  ``csrc/heat2d.cu``.
* :func:`dual_dim_step` — both-axis derivatives and their residual from
  one read (``dual_dim_step_pallas``, :1624); source
  ``csrc/dual_dim_step.cu``.

A wrapper given a CUDA tensor launches its kernel on the current stream
or raises; it takes the plain version (``*_ref``) only because the
tensor it was given lies on the CPU. Each wrapper counts its launches in
a plain integer attribute (``stencil2d_iterate.launches``), so a run can
show that its main path went through the kernel.

The plain versions repeat the kernels' arithmetic op for op (coefficients
rounded to the array dtype first), so on the card a kernel and its plain
version agree bit for bit in float32, float64 and bfloat16 — all but the
dual step's residual, a sum taken in another order (see
:func:`dual_dim_step`).
"""

from __future__ import annotations

import ctypes

import torch

from tpu_mpi_tests_torch.kernels import build
from tpu_mpi_tests_torch.kernels.stencil import (
    N_BND,
    STENCIL5,
    coef,
    dual_dim_step as _dual_dim_step_torch,
    heat2d_steps_,
    stencil1d_5,
)

# STENCIL5 is antisymmetric: the update uses the 2-difference form
# C1·(z₊₁−z₋₁) + C2·(z₊₂−z₋₂), as the JAX kernel's _step5 does
_C1, _C2 = float(STENCIL5[3]), float(STENCIL5[4])

#: dtype → the code the C entry points take (csrc/stencil_common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}

_c_void_p, _c_int, _c_ll, _c_double = (
    ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double)
# C entry point → (argument types, return type)
_SIGNATURES = {
    "tpumt_stencil2d_iterate": ([
        _c_void_p, _c_void_p, _c_int, _c_int, _c_ll, _c_ll, _c_int,
        _c_double, _c_double, _c_double, _c_int, _c_int, _c_void_p,
        _c_void_p,
    ], _c_int),
    "tpumt_stencil2d_deriv": ([
        _c_void_p, _c_void_p, _c_int, _c_int, _c_ll, _c_ll,
        _c_double, _c_double, _c_double, _c_double, _c_double, _c_double,
        _c_void_p,
    ], _c_int),
    "tpumt_heat2d": ([
        _c_void_p, _c_void_p, _c_int, _c_ll, _c_ll, _c_int, _c_double,
        _c_double, _c_double, _c_void_p,
    ], _c_int),
    "tpumt_heat2d_max_steps": ([_c_int], _c_int),
    "tpumt_dual_dim_step": ([
        _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_int,
        _c_ll, _c_ll, _c_double, _c_double, _c_double, _c_double,
        _c_double, _c_double, _c_double, _c_void_p,
    ], _c_int),
    "tpumt_dual_dim_step_tiles": ([_c_ll, _c_ll], _c_ll),
}


def _entry(lib_name: str, fn_name: str):
    fn = getattr(build.load(lib_name), fn_name)
    fn.argtypes, fn.restype = _SIGNATURES[fn_name]
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


# ---------------------------------------------------------------------------
# k-step heat update (both axes ghosted)
# ---------------------------------------------------------------------------


def _check_heat(z: torch.Tensor, steps: int) -> None:
    if z.dim() != 2:
        raise ValueError(f"heat2d: 2-D input required, got shape "
                         f"{tuple(z.shape)}")
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")


def heat2d_ref(z: torch.Tensor, cx: float, cy: float, steps: int = 1
               ) -> torch.Tensor:
    """Plain-torch version of :func:`heat2d` (returns a new tensor): the
    XLA body of ``heat_step2d_fn`` (``halo.py:1445-1457``) op for op —
    ``d2 = (z₊₁ + z₋₁) − 2·mid`` per axis, then ``(mid + cx·d2x) +
    cy·d2y`` — with ``cx``, ``cy`` and 2 rounded to the array dtype."""
    _check_heat(z, steps)
    return heat2d_steps_(z.clone(), cx, cy, steps)


def heat2d_max_steps(dtype: torch.dtype) -> int:
    """The deepest ``steps`` one :func:`heat2d` launch takes in
    ``dtype`` (the tile and its apron must fit in shared memory)."""
    fn = _entry("heat2d", "tpumt_heat2d_max_steps")
    return fn(DTYPE_CODES[dtype])


def heat2d(z: torch.Tensor, cx: float, cy: float, steps: int = 1,
           out: "torch.Tensor | None" = None) -> torch.Tensor:
    """``steps`` explicit-Euler steps ``mid += cx·δ²x + cy·δ²y`` of a
    both-axes-ghosted shard over the maximal span ``[1, n0−1) × [1,
    n1−1)``, the outer ring kept (≅ ``heat2d_pallas``), written to
    ``out`` (a new tensor when None) — never in place: ``out`` must not
    share storage with ``z``. Ghost-band cells are results too."""
    _check_heat(z, steps)
    if out is not None:
        _check_out(out, z, z.shape, "heat2d")
    if z.device.type == "cpu":
        ref = heat2d_ref(z, cx, cy, steps)
        return ref if out is None else out.copy_(ref)
    if z.device.type != "cuda":
        raise ValueError(f"heat2d: unsupported device {z.device}")
    _check_cuda_operand(z, "heat2d")
    deepest = heat2d_max_steps(z.dtype)
    if steps > deepest:
        raise ValueError(f"heat2d: steps={steps} > {deepest}, the deepest "
                         f"apron that fits in shared memory for {z.dtype}")
    if out is None:
        out = torch.empty_like(z)
    fn = _entry("heat2d", "tpumt_heat2d")
    with torch.cuda.device(z.device):
        rc = fn(
            z.data_ptr(), out.data_ptr(), DTYPE_CODES[z.dtype],
            z.shape[0], z.shape[1], steps, _rounded(cx, z.dtype),
            _rounded(cy, z.dtype), 2.0,
            torch.cuda.current_stream(z.device).cuda_stream,
        )
    if rc != 0:
        _raise_launch("heat2d", rc)
    heat2d.launches += 1
    return out


heat2d.launches = 0


# ---------------------------------------------------------------------------
# dual-axis derivative + residual
# ---------------------------------------------------------------------------


def _check_dual(z: torch.Tensor, n_bnd: int) -> None:
    if n_bnd != N_BND:
        raise ValueError(f"dual_dim_step requires n_bnd == {N_BND}, got "
                         f"{n_bnd}")
    if z.dim() != 2 or min(z.shape) < 2 * N_BND + 1:
        raise ValueError(
            f"dual_dim_step: a 2-D block with both dims >= {2 * N_BND + 1} "
            f"(2·n_bnd ghosts + interior) required, got {tuple(z.shape)}"
        )


def dual_dim_step_ref(z: torch.Tensor, n_bnd: int, scale_x: float,
                      scale_y: float):
    """Plain-torch version of :func:`dual_dim_step`: the torch-op
    ``kernels.stencil.dual_dim_step``."""
    _check_dual(z, n_bnd)
    return _dual_dim_step_torch(z, n_bnd, scale_x, scale_y)


#: |kernel − plain| / |plain| the dual step's residual may show on the
#: card. Both sum the same rounded squares, but in another order (the
#: kernel: per-thread, a fixed tree per CTA, a second pass over the CTA
#: partials; torch: its own reduction tree), so float32 differs by
#: rounding of ~10⁸ terms; in bfloat16 each side rounds its two sums and
#: their total to bf16, which can land one bf16 ulp apart twice.
RESIDUAL_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12,
                 torch.bfloat16: 2.0**-6}


def dual_dim_step(z: torch.Tensor, n_bnd: int, scale_x: float,
                  scale_y: float):
    """``(dz_dx, dz_dy, residual)`` of a block ghosted ``n_bnd`` = N_BND
    along both axes (≅ ``dual_dim_step_pallas``): the 5-point derivative
    along rows on the interior columns × ``scale_x``, along columns on
    the interior rows × ``scale_y``, both ``(n0−4, n1−4)``, and
    ``Σdz_dx² + Σdz_dy²`` as a 0-dim tensor of the array dtype. The
    derivatives match the plain version bit for bit; the residual is a
    deterministic sum in another order (:data:`RESIDUAL_RTOL`). One
    wrapper call is one count: the kernel runs as a tile pass and a
    one-CTA pass over the tiles' partials."""
    _check_dual(z, n_bnd)
    if z.device.type == "cpu":
        return dual_dim_step_ref(z, n_bnd, scale_x, scale_y)
    if z.device.type != "cuda":
        raise ValueError(f"dual_dim_step: unsupported device {z.device}")
    _check_cuda_operand(z, "dual_dim_step")
    n0, n1 = z.shape
    dx = torch.empty((n0 - 4, n1 - 4), dtype=z.dtype, device=z.device)
    dy = torch.empty_like(dx)
    res = torch.empty((), dtype=z.dtype, device=z.device)
    tiles = _entry("dual_dim_step", "tpumt_dual_dim_step_tiles")(n0, n1)
    acc = torch.float64 if z.dtype == torch.float64 else torch.float32
    part = torch.empty(2 * tiles, dtype=acc, device=z.device)
    c = [_rounded(v, z.dtype) for v in STENCIL5.tolist()]
    fn = _entry("dual_dim_step", "tpumt_dual_dim_step")
    with torch.cuda.device(z.device):
        rc = fn(
            z.data_ptr(), dx.data_ptr(), dy.data_ptr(), part.data_ptr(),
            res.data_ptr(), DTYPE_CODES[z.dtype], n0, n1, *c,
            _rounded(scale_x, z.dtype), _rounded(scale_y, z.dtype),
            torch.cuda.current_stream(z.device).cuda_stream,
        )
    if rc != 0:
        _raise_launch("dual_dim_step", rc)
    dual_dim_step.launches += 1
    return dx, dy, res


dual_dim_step.launches = 0

#: every wrapper of a hand kernel (name → function with a .launches count)
WRAPPERS = {
    "stencil2d_iterate": stencil2d_iterate,
    "stencil2d_deriv": stencil2d_deriv,
    "heat2d": heat2d,
    "dual_dim_step": dual_dim_step,
}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
