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
  one read (``dual_dim_step_pallas``, :1624), in its raw-tap and its
  ``lean`` body; source ``csrc/dual_dim_step.cu``.
* :func:`alu_probe` — ``reps`` repetitions of an op mix on blocks that
  stay on chip (``vpu_probe_pallas``, :469); source
  ``csrc/alu_probe.cu``.
* :func:`pack_edges`, :func:`unpack_ghosts` — the halo staging copies
  (``pack_edges_pallas`` :2772, ``unpack_ghosts_pallas`` :2803); source
  ``csrc/pack.cu``.
* :func:`daxpy`, :func:`stream_scale`, :func:`stream_sum3` — the
  streaming passes ``a·x + y``, ``a·x`` and ``(w + x) + y``
  (``daxpy_pallas`` :84, ``stream_scale_pallas`` :144,
  ``stream_sum3_pallas`` :190); source ``csrc/streams.cu``. Unlike the
  stencil kernels these may write in place: ``out`` may be the very
  tensor of an input.
* :func:`flash_attention_block` — the online-softmax fold of one K/V
  block into the (m, l, acc) carry, in place, causal in global positions
  (``flash_attention_block_pallas`` :3230), and :func:`flash_attention`
  on top of it (``flash_attention_pallas`` :3416); source
  ``csrc/flash_attention.cu``.

A wrapper given a CUDA tensor launches its kernel on the current stream
or raises; it takes the plain version (``*_ref``) only because the
tensor it was given lies on the CPU. Each wrapper counts its launches in
a plain integer attribute (``stencil2d_iterate.launches``), so a run can
show that its main path went through the kernel.

The plain versions repeat the kernels' arithmetic op for op (coefficients
rounded to the array dtype first), so on the card a kernel and its plain
version agree bit for bit in float32, float64 and bfloat16 — all but the
dual step's residual, a sum taken in another order (see
:func:`dual_dim_step`), the probe's two dual mixes, which feed such a sum
back into every element (:func:`alu_probe_tolerance`), and flash
attention, whose dot products and softmax sums run in another order
(stated tolerances, ``chip_smoke.py``).
"""

from __future__ import annotations

import contextlib
import ctypes

import numpy as np
import torch

from tpu_mpi_tests_torch.kernels import build
from tpu_mpi_tests_torch.kernels import pack as _pack
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
        _c_double, _c_double, _c_double, _c_int, _c_void_p,
    ], _c_int),
    "tpumt_dual_dim_step_tiles": ([_c_ll, _c_ll], _c_ll),
    # z, buffer a, buffer b, partials; dtype, mix, blocks, H, W, reps;
    # eight constants, float32(se); CTAs launched (out), stream
    "tpumt_alu_probe": (
        [_c_void_p] * 4 + [_c_int, _c_int, _c_ll, _c_ll, _c_ll, _c_int]
        + [_c_double] * 9 + [ctypes.POINTER(_c_int), _c_void_p], _c_int),
    "tpumt_alu_probe_tiles": ([_c_ll, _c_ll], _c_ll),
    "tpumt_alu_probe_l2_bytes": ([], _c_ll),
    # z, lo, hi; itemsize, axis, n0, n1, n_bnd, stream
    "tpumt_pack_edges": (
        [_c_void_p] * 3 + [_c_int, _c_int, _c_ll, _c_ll, _c_ll, _c_void_p],
        _c_int),
    "tpumt_unpack_ghosts": (
        [_c_void_p] * 3 + [_c_int, _c_int, _c_ll, _c_ll, _c_ll, _c_void_p],
        _c_int),
    "tpumt_daxpy": ([
        _c_double, _c_void_p, _c_void_p, _c_void_p, _c_int, _c_ll,
        _c_void_p,
    ], _c_int),
    "tpumt_stream_scale": ([
        _c_double, _c_void_p, _c_void_p, _c_int, _c_ll, _c_void_p,
    ], _c_int),
    "tpumt_stream_sum3": ([
        _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_int, _c_ll,
        _c_void_p,
    ], _c_int),
    # q, k, v, m/l/acc in, m/l/acc out; dtype, L, Lk, d, heads; (row,
    # head) strides of q, k, v, m, l, acc; q_off, k_off, pos_stride;
    # scale, causal, highest, stream
    "tpumt_flash_attention_block": (
        [_c_void_p] * 9 + [_c_int, _c_ll, _c_ll, _c_int, _c_int]
        + [_c_ll] * 15 + [_c_double, _c_int, _c_int, _c_void_p], _c_int),
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


#: the lean (difference-form) body per dtype when ``lean=None`` — a copy
#: of the JAX package's ``_DUAL_DIM_LEAN_DEFAULT`` (the raw-tap body
#: everywhere); the card's own verdict is the microbench row
#: ``dualdim_lean_gain_{dtype}``
_DUAL_DIM_LEAN_DEFAULT = {"float32": False, "bfloat16": False}


def _resolve_lean(lean, dtype: torch.dtype) -> bool:
    if lean is None:
        return _DUAL_DIM_LEAN_DEFAULT.get(str(dtype).split(".")[1], False)
    return bool(lean)


def _lean_coefs(scale: float, dtype: torch.dtype) -> tuple[float, float]:
    """The lean body's two coefficients of one axis: the scale (rounded
    to the dtype first) times C1 and C2, each product taken in float32
    and cast once to the dtype (``pallas_kernels.py:1549-1554``)."""
    s32 = np.float32(_rounded(scale, dtype))
    return tuple(_rounded(float(np.float32(s32 * np.float32(c))), dtype)
                 for c in (_C1, _C2))


def _dual_dim_step_lean(z: torch.Tensor, scale_x: float, scale_y: float):
    """The lean body as torch ops: ``c1·(z₊₁−z₋₁) + c2·(z₊₂−z₋₂)`` per
    axis on the both-axes interior, and one fused residual
    ``Σ(dx² + dy²)`` in float32 (float64 for float64), rounded once."""
    n0, n1 = z.shape
    core = z[:, N_BND:n1 - N_BND]
    mid = z[N_BND:n0 - N_BND]
    c1x, c2x = (coef(c, z) for c in _lean_coefs(scale_x, z.dtype))
    c1y, c2y = (coef(c, z) for c in _lean_coefs(scale_y, z.dtype))
    dx = c1x * (core[3:n0 - 1] - core[1:n0 - 3]) \
        + c2x * (core[4:n0] - core[0:n0 - 4])
    dy = c1y * (mid[:, 3:n1 - 1] - mid[:, 1:n1 - 3]) \
        + c2y * (mid[:, 4:n1] - mid[:, 0:n1 - 4])
    acc = torch.float64 if z.dtype == torch.float64 else torch.float32
    dxa, dya = dx.to(acc), dy.to(acc)
    return dx, dy, torch.sum(dxa * dxa + dya * dya).to(z.dtype)


def dual_dim_step_ref(z: torch.Tensor, n_bnd: int, scale_x: float,
                      scale_y: float, lean: "bool | None" = None):
    """Plain-torch version of :func:`dual_dim_step`: the torch-op
    ``kernels.stencil.dual_dim_step``, or with ``lean`` the
    difference-form body."""
    _check_dual(z, n_bnd)
    if _resolve_lean(lean, z.dtype):
        return _dual_dim_step_lean(z, scale_x, scale_y)
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
                  scale_y: float, lean: "bool | None" = None):
    """``(dz_dx, dz_dy, residual)`` of a block ghosted ``n_bnd`` = N_BND
    along both axes (≅ ``dual_dim_step_pallas``): the 5-point derivative
    along rows on the interior columns × ``scale_x``, along columns on
    the interior rows × ``scale_y``, both ``(n0−4, n1−4)``, and
    ``Σdz_dx² + Σdz_dy²`` as a 0-dim tensor of the array dtype. The
    derivatives match the plain version bit for bit; the residual is a
    deterministic sum in another order (:data:`RESIDUAL_RTOL`). One
    wrapper call is one count: the kernel runs as a tile pass and a
    one-CTA pass over the tiles' partials.

    ``lean`` selects the difference-form body (taps
    ``c1·(z₊₁−z₋₁) + c2·(z₊₂−z₋₂)`` with the scale folded into the
    coefficients, one fused float32 residual); ``None`` resolves through
    :data:`_DUAL_DIM_LEAN_DEFAULT` (the raw-tap body). The two bodies
    differ by floating-point association only."""
    _check_dual(z, n_bnd)
    lean = _resolve_lean(lean, z.dtype)
    if z.device.type == "cpu":
        return dual_dim_step_ref(z, n_bnd, scale_x, scale_y, lean=lean)
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
    if lean:
        (c1x, c2x), (c1y, c2y) = (_lean_coefs(s, z.dtype)
                                  for s in (scale_x, scale_y))
        c = [c1x, c2x, 0.0, c1y, c2y]
    else:
        c = [_rounded(v, z.dtype) for v in STENCIL5.tolist()]
    fn = _entry("dual_dim_step", "tpumt_dual_dim_step")
    with torch.cuda.device(z.device):
        rc = fn(
            z.data_ptr(), dx.data_ptr(), dy.data_ptr(), part.data_ptr(),
            res.data_ptr(), DTYPE_CODES[z.dtype], n0, n1, *c,
            _rounded(scale_x, z.dtype), _rounded(scale_y, z.dtype),
            int(lean), torch.cuda.current_stream(z.device).cuda_stream,
        )
    if rc != 0:
        _raise_launch("dual_dim_step", rc)
    dual_dim_step.launches += 1
    return dx, dy, res


dual_dim_step.launches = 0


# ---------------------------------------------------------------------------
# ALU op-rate probe
# ---------------------------------------------------------------------------

#: the op mixes of the probe, in the order of the kernel's mix codes
ALU_PROBE_MIXES = ("fma", "step5_d0", "step5_d1", "step5fma_d0",
                   "step5fma_d1", "heat5", "dualdim", "dualdim_lean")
_PROBE_DTYPES = (torch.float32, torch.bfloat16)
_PROBE_SCALE = 0.0078125  # 2⁻⁷: exact in bfloat16 and float32
#: arithmetic instructions one element really costs per rep (a lone add,
#: sub or mul each 1; built without FMA contraction), beside the JAX
#: metric's nominal counts 2, 7, 7, 11, 22, 14
ALU_PROBE_REAL_OPS = {"fma": 2, "step5_d0": 7, "step5_d1": 7,
                      "step5fma_d0": 8, "step5fma_d1": 8, "heat5": 10,
                      "dualdim": 25, "dualdim_lean": 19}


def _probe_consts(mix: str, se: float, dtype: torch.dtype) -> list[float]:
    """The mix's constants, each rounded to ``dtype`` (what the JAX body
    makes with ``jnp.asarray(c, z.dtype)`` and weak-typed floats), in the
    slots the kernel reads."""
    def r(v):
        return _rounded(v, dtype)

    if mix == "fma":
        return [r(0.9921875), r(1e-10)]
    if mix in ("step5_d0", "step5_d1"):
        return [r(se), r(_C1), r(_C2)]
    if mix in ("step5fma_d0", "step5fma_d1"):
        se = float(se)
        return [r(se * _C1), r(-se * _C1), r(se * _C2), r(-se * _C2)]
    if mix == "heat5":
        return [r(_PROBE_SCALE), r(_PROBE_SCALE), r(2.0)]
    if mix == "dualdim":
        taps = [r(c) for c in STENCIL5.tolist() if c != 0.0]
        return taps + [r(_PROBE_SCALE), r(_PROBE_SCALE), r(se)]
    # dualdim_lean: the scale folded into the taps in float32
    s32 = np.float32(_PROBE_SCALE)
    fc1, fc2 = (r(float(np.float32(s32 * np.float32(c))))
                for c in (_C1, _C2))
    return [fc1, fc2, fc1, fc2, r(se)]


def _check_probe(z: torch.Tensor, reps: int, mix: str) -> None:
    if mix not in ALU_PROBE_MIXES:
        raise ValueError(f"unknown mix {mix!r}; valid: {ALU_PROBE_MIXES}")
    if z.dim() not in (2, 3):
        raise ValueError(f"alu_probe: an (H, W) block or (B, H, W) blocks "
                         f"required, got shape {tuple(z.shape)}")
    if z.dtype not in _PROBE_DTYPES:
        raise TypeError(f"alu_probe: dtype {z.dtype} unsupported (float32, "
                        f"bfloat16)")
    if reps < 1:
        raise ValueError(f"reps must be >= 1, got {reps}")
    H, W = z.shape[-2:]
    need_h = mix in ("step5_d0", "step5fma_d0", "dualdim", "dualdim_lean")
    need_w = mix in ("step5_d1", "step5fma_d1", "dualdim", "dualdim_lean")
    if z.numel() == 0 or (need_h and H < 2 * N_BND + 1) \
            or (need_w and W < 2 * N_BND + 1):
        raise ValueError(f"alu_probe: block {tuple(z.shape)} too small for "
                         f"mix {mix!r} (the stencil axes need >= "
                         f"{2 * N_BND + 1} points)")


def _probe_rep(z: torch.Tensor, mix: str, k, se32: torch.Tensor):
    """One repetition of ``mix`` on one (H, W) block, op for op as
    ``_vpu_probe_kernel`` writes it. Returns (new block, the dual mixes'
    shift as a 0-dim float32 tensor or None)."""
    H, W = z.shape
    G = N_BND
    if mix == "fma":
        return k[0] * z + k[1], None
    if mix.startswith("step5"):
        axis = 0 if mix.endswith("_d0") else 1
        n = z.shape[axis]

        def zs(off):
            return z.narrow(axis, G + off, n - 2 * G)

        if mix.startswith("step5fma"):
            upd = zs(0) + k[0] * zs(1) + k[1] * zs(-1) + k[2] * zs(2) \
                + k[3] * zs(-2)
        else:
            upd = zs(0) + k[0] * (k[1] * (zs(1) - zs(-1))
                                  + k[2] * (zs(2) - zs(-2)))
        out = z.clone()
        out.narrow(axis, G, n - 2 * G).copy_(upd)
        return out, None
    if mix == "heat5":
        out = z.clone()
        if H >= 3 and W >= 3:
            w = z[1:-1, 1:-1]
            two_w = k[2] * w
            lx = z[2:, 1:-1] + z[:-2, 1:-1] - two_w
            ly = z[1:-1, :-2] + z[1:-1, 2:] - two_w
            out[1:-1, 1:-1] = w + k[0] * lx + k[1] * ly
        return out, None
    if mix == "dualdim":
        c0, c1, c3, c4, sx, sy, se_c = k
        dx = (c0 * z[0:H - 4] + c1 * z[1:H - 3] + c3 * z[3:H - 1]
              + c4 * z[4:H]) * sx                       # (H-2G, W)
        dy = (c0 * z[:, 0:W - 4] + c1 * z[:, 1:W - 3] + c3 * z[:, 3:W - 1]
              + c4 * z[:, 4:W]) * sy                    # (H, W-2G)
        dxf, dyf = dx.float(), dy.float()
        # two row-masked sums: each leaves out its last row
        r = (torch.sum((dxf * dxf)[:H - 2 * G - 1])
             + torch.sum((dyf * dyf)[:H - 1])) / 1024.0
        shift = se32 * r
        zx = z.clone()
        zx[G:H - G] = z[G:H - G] + se_c * dx
        zy = zx.clone()
        zy[:, G:W - G] = zx[:, G:W - G] + se_c * dy
        return zy + shift.to(z.dtype), shift
    # dualdim_lean
    c1x, c2x, c1y, c2y, se_c = k
    core = z[:, G:W - G]
    mid = z[G:H - G]
    dx = c1x * (core[3:H - 1] - core[1:H - 3]) \
        + c2x * (core[4:H] - core[0:H - 4])
    dy = c1y * (mid[:, 3:W - 1] - mid[:, 1:W - 3]) \
        + c2y * (mid[:, 4:W] - mid[:, 0:W - 4])
    dxf, dyf = dx.float(), dy.float()
    r = torch.sum((dxf * dxf + dyf * dyf)[:H - 2 * G - 1]) / 1024.0
    shift = se32 * r
    out = z.clone()
    out[G:H - G, G:W - G] = mid[:, G:W - G] + se_c * dx + se_c * dy
    return out + shift.to(z.dtype), shift


def alu_probe_ref(z: torch.Tensor, reps: int, mix: str = "fma",
                  se: float = 1e-9, shifts: "list | None" = None
                  ) -> torch.Tensor:
    """Plain-torch version of :func:`alu_probe` (returns a new tensor):
    the mix's body as torch ops, op for op, in a Python loop over
    ``reps``, each block of a (B, H, W) stack on its own. ``shifts``, when
    a list, receives the largest ``|shift|`` of the dual mixes' every rep
    (what :func:`alu_probe_tolerance` scales with)."""
    _check_probe(z, reps, mix)
    k = [coef(v, z) for v in _probe_consts(mix, se, z.dtype)]
    se32 = torch.tensor(float(se), dtype=torch.float32)
    blocks = [z] if z.dim() == 2 else list(z.unbind(0))
    for _ in range(reps):
        stepped = [_probe_rep(b, mix, k, se32) for b in blocks]
        blocks = [b for b, _ in stepped]
        if shifts is not None and stepped[0][1] is not None:
            shifts.append(max(abs(float(s)) for _, s in stepped))
    return blocks[0] if z.dim() == 2 else torch.stack(blocks)


def alu_probe_tolerance(dtype: torch.dtype, reps: int, max_abs: float,
                        max_shift: float) -> float:
    """Largest |kernel − plain| the dual mixes may show after ``reps``
    repetitions; 0 for every other mix, which is bit-exact. The kernel
    and the plain version sum the same squares in another order, so each
    rep's shift differs by :data:`RESIDUAL_RTOL` of its size at most
    (bfloat16: one ulp of the rounded shift), and adding it can flip the
    rounding of an element by one ulp of that element; the update is a
    contraction at the probe's scales, so the per-rep errors add up and
    do not grow: ``2·reps·(eps·max|z| + rtol·max|shift|)``."""
    eps = 2.0**-8 if dtype == torch.bfloat16 else 2.0**-23
    return 2.0 * reps * (eps * max_abs + RESIDUAL_RTOL[dtype] * max_shift)


def alu_probe_l2_bytes() -> int:
    """The L2 cache of the current CUDA device in bytes: the capacity two
    ping-pong buffers of :func:`alu_probe` must fit in."""
    return int(_entry("alu_probe", "tpumt_alu_probe_l2_bytes")())


def check_probe_capacity(total_bytes: int, l2_bytes: int) -> None:
    """Raise unless the probe's two ping-pong buffers of ``total_bytes``
    each fit in an L2 cache of ``l2_bytes``: past that every rep would
    stream device memory and the probe would price HBM, not an op mix."""
    if 2 * total_bytes > l2_bytes:
        raise ValueError(
            f"alu_probe: two ping-pong buffers of {total_bytes} B exceed "
            f"the card's {l2_bytes} B L2 cache; the blocks would not stay "
            f"on chip between reps (fewer or smaller blocks)"
        )


def alu_probe(z: torch.Tensor, reps: int, mix: str = "fma",
              se: float = 1e-9) -> torch.Tensor:
    """``body^reps(z)``: ``reps`` repetitions of op mix ``mix`` on one
    (H, W) block, or on each of the B independent blocks of a (B, H, W)
    stack in one launch (≅ ``vpu_probe_pallas``), every rep reading only
    the previous rep's values. Returns a new tensor (``z`` is only read),
    so the probe chains. Mixes: ``fma`` (``a·z + b``), ``step5_d0/_d1``
    (the k-step stencil update), ``step5fma_d0/_d1`` (its raw se-folded
    4-tap form), ``heat5`` (the heat Laplacian step), ``dualdim`` and
    ``dualdim_lean`` (the dual step's bodies, their residual fed back
    into every element at ``se``); any other name raises. ``se`` is the
    update scale: the 1e-9 default keeps long chains numerically inert.

    On the card the blocks live in two ping-pong buffers that must fit
    in the L2 cache together (:func:`check_probe_capacity` raises
    otherwise), and one cooperative launch of at most the co-resident
    number of CTAs advances them, a grid barrier between reps
    (``csrc/alu_probe.cu``). ``alu_probe.last_ctas`` holds the CTAs of
    the last launch. float32 and bfloat16."""
    _check_probe(z, reps, mix)
    if z.device.type == "cpu":
        return alu_probe_ref(z, reps, mix, se)
    if z.device.type != "cuda":
        raise ValueError(f"alu_probe: unsupported device {z.device}")
    _check_cuda_operand(z, "alu_probe")
    H, W = z.shape[-2:]
    n_blocks = z.shape[0] if z.dim() == 3 else 1
    with torch.cuda.device(z.device):
        check_probe_capacity(z.numel() * z.element_size(),
                             alu_probe_l2_bytes())
    buf = torch.empty((2,) + tuple(z.shape), dtype=z.dtype, device=z.device)
    tiles = _entry("alu_probe", "tpumt_alu_probe_tiles")(H, W)
    part = torch.empty(2 * n_blocks * tiles * 2, dtype=torch.float32,
                       device=z.device)
    k = _probe_consts(mix, se, z.dtype)
    k += [0.0] * (8 - len(k))
    ctas = _c_int(0)
    fn = _entry("alu_probe", "tpumt_alu_probe")
    with torch.cuda.device(z.device):
        rc = fn(z.data_ptr(), buf[0].data_ptr(), buf[1].data_ptr(),
                part.data_ptr(), DTYPE_CODES[z.dtype],
                ALU_PROBE_MIXES.index(mix), n_blocks, H, W, int(reps), *k,
                float(np.float32(se)), ctypes.byref(ctas),
                torch.cuda.current_stream(z.device).cuda_stream)
    if rc != 0:
        _raise_launch("alu_probe", rc)
    alu_probe.launches += 1
    alu_probe.last_ctas = ctas.value
    return buf[(reps - 1) & 1]


alu_probe.launches = 0
alu_probe.last_ctas = 0


# ---------------------------------------------------------------------------
# halo staging: pack the edge bands, unpack into the ghost bands
# ---------------------------------------------------------------------------


def _check_pack(name: str, z: torch.Tensor, axis: int, n_bnd: int):
    """The band shape of a 2-D ``z`` along ``axis``."""
    if z.dim() != 2:
        raise ValueError(f"{name}: 2-D input required, got shape "
                         f"{tuple(z.shape)}")
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    _pack.check_bands(z.shape[axis], n_bnd, name)
    shape = list(z.shape)
    shape[axis] = n_bnd
    return tuple(shape)


def pack_edges_ref(z: torch.Tensor, axis: int = 0, n_bnd: int = N_BND):
    """Plain-torch version of :func:`pack_edges`:
    ``kernels.pack.pack_edges``."""
    _check_pack("pack_edges", z, axis, n_bnd)
    return _pack.pack_edges(z, axis, n_bnd)


def pack_edges(z: torch.Tensor, axis: int = 0, n_bnd: int = N_BND):
    """``(lo, hi)``: the interior edge bands ``z[b:2b]`` and
    ``z[n−2b:n−b]`` along ``axis`` of a contiguous 2-D array, as two new
    contiguous buffers (≅ ``pack_edges_pallas``, the reference's
    ``buf_from_view``). A non-contiguous view raises on the card."""
    shape = _check_pack("pack_edges", z, axis, n_bnd)
    if z.device.type == "cpu":
        return pack_edges_ref(z, axis, n_bnd)
    if z.device.type != "cuda":
        raise ValueError(f"pack_edges: unsupported device {z.device}")
    _check_cuda_operand(z, "pack_edges")
    lo = torch.empty(shape, dtype=z.dtype, device=z.device)
    hi = torch.empty_like(lo)
    fn = _entry("pack", "tpumt_pack_edges")
    with torch.cuda.device(z.device):
        rc = fn(z.data_ptr(), lo.data_ptr(), hi.data_ptr(),
                z.element_size(), axis, z.shape[0], z.shape[1], n_bnd,
                torch.cuda.current_stream(z.device).cuda_stream)
    if rc != 0:
        _raise_launch("pack_edges", rc)
    pack_edges.launches += 1
    return lo, hi


pack_edges.launches = 0


def unpack_ghosts_ref(z: torch.Tensor, lo_ghost: torch.Tensor,
                      hi_ghost: torch.Tensor, axis: int = 0,
                      n_bnd: int = N_BND) -> torch.Tensor:
    """Plain-torch version of :func:`unpack_ghosts`:
    ``kernels.pack.unpack_ghosts`` (in place; returns ``z``)."""
    _check_pack("unpack_ghosts", z, axis, n_bnd)
    return _pack.unpack_ghosts(z, lo_ghost, hi_ghost, axis, n_bnd)


def unpack_ghosts(z: torch.Tensor, lo_ghost: torch.Tensor,
                  hi_ghost: torch.Tensor, axis: int = 0,
                  n_bnd: int = N_BND) -> torch.Tensor:
    """Write ``lo_ghost`` into ``z[0:b]`` and ``hi_ghost`` into
    ``z[n−b:n]`` along ``axis``, IN PLACE, and return ``z`` (≅
    ``unpack_ghosts_pallas``, the reference's ``buf_to_view``; the Pallas
    kernel returns an updated copy because it is functional). The two
    buffers are contiguous, band-shaped and share no storage with
    ``z``."""
    shape = _check_pack("unpack_ghosts", z, axis, n_bnd)
    for t, nm in ((lo_ghost, "lo_ghost"), (hi_ghost, "hi_ghost")):
        if tuple(t.shape) != shape or t.dtype != z.dtype \
                or t.device != z.device:
            raise ValueError(
                f"unpack_ghosts: {nm} must be {shape} {z.dtype} on "
                f"{z.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    if z.device.type == "cpu":
        return unpack_ghosts_ref(z, lo_ghost, hi_ghost, axis, n_bnd)
    if z.device.type != "cuda":
        raise ValueError(f"unpack_ghosts: unsupported device {z.device}")
    _check_cuda_operand(z, "unpack_ghosts")
    for t, nm in ((lo_ghost, "lo_ghost"), (hi_ghost, "hi_ghost")):
        if not t.is_contiguous():
            raise ValueError(f"unpack_ghosts: {nm} must be contiguous")
        if t.untyped_storage().data_ptr() == z.untyped_storage().data_ptr():
            raise ValueError(f"unpack_ghosts: {nm} must not share storage "
                             f"with z (pack the bands into buffers first)")
    fn = _entry("pack", "tpumt_unpack_ghosts")
    with torch.cuda.device(z.device):
        rc = fn(z.data_ptr(), lo_ghost.data_ptr(), hi_ghost.data_ptr(),
                z.element_size(), axis, z.shape[0], z.shape[1], n_bnd,
                torch.cuda.current_stream(z.device).cuda_stream)
    if rc != 0:
        _raise_launch("unpack_ghosts", rc)
    unpack_ghosts.launches += 1
    return z


unpack_ghosts.launches = 0


# ---------------------------------------------------------------------------
# streaming passes: daxpy, scale, sum3
# ---------------------------------------------------------------------------


def _check_stream(name: str, *operands: torch.Tensor) -> None:
    first = operands[0]
    for t in operands[1:]:
        if t.shape != first.shape or t.dtype != first.dtype \
                or t.device != first.device:
            raise ValueError(
                f"{name}: operands must share shape, dtype and device, got "
                f"{tuple(first.shape)} {first.dtype} on {first.device} and "
                f"{tuple(t.shape)} {t.dtype} on {t.device}"
            )


def _span(t: torch.Tensor) -> tuple[int, int]:
    lo = t.data_ptr()
    return lo, lo + t.numel() * t.element_size()


def _check_stream_out(name: str, out: torch.Tensor, *operands) -> None:
    """``out`` must be shaped like the operands and contiguous; it may be
    the very buffer of an operand (an in-place launch: each element is
    read, then written, by one thread) but never overlap one partly."""
    _check_stream(name, out, *operands)
    if not out.is_contiguous():
        raise ValueError(f"{name}: out must be contiguous")
    o_lo, o_hi = _span(out)
    for t in operands:
        lo, hi = _span(t)
        if lo != o_lo and lo < o_hi and o_lo < hi:
            raise ValueError(f"{name}: out overlaps an operand partly; it "
                             f"may only be an operand itself or disjoint")


def _stream_launch(name: str, fn_name: str, out, operands, *args) -> None:
    """Check the CUDA operands and launch ``fn_name`` as
    ``fn(*args, out, dtype, n, stream)`` (``args`` ends with the operand
    pointers)."""
    for t in operands:
        _check_cuda_operand(t, name)
    fn = _entry("streams", fn_name)
    t0 = operands[0]
    with torch.cuda.device(t0.device):
        rc = fn(*args, out.data_ptr(), DTYPE_CODES[t0.dtype], t0.numel(),
                torch.cuda.current_stream(t0.device).cuda_stream)
    if rc != 0:
        _raise_launch(name, rc)


def daxpy_ref(a: float, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain-torch version of :func:`daxpy`: ``a`` rounded to the dtype,
    then ``a·x`` and ``+ y`` as two ops, each rounded — never
    ``torch.add(y, x, alpha=a)``, which the card contracts into an FMA."""
    _check_stream("daxpy", x, y)
    return coef(a, x) * x + y


def daxpy(a: float, x: torch.Tensor, y: torch.Tensor,
          out: "torch.Tensor | None" = None) -> torch.Tensor:
    """``out = a·x + y`` elementwise (≅ ``daxpy_pallas``), ``a`` rounded
    to the dtype first; ``out`` is a new tensor when None, and ``out=y``
    is the in-place launch (``inplace=True``). Any length works."""
    _check_stream("daxpy", x, y)
    if out is not None:
        _check_stream_out("daxpy", out, x, y)
    if x.device.type == "cpu":
        ref = daxpy_ref(a, x, y)
        return ref if out is None else out.copy_(ref)
    if x.device.type != "cuda":
        raise ValueError(f"daxpy: unsupported device {x.device}")
    if out is None:
        out = torch.empty_like(y, memory_format=torch.contiguous_format)
    _stream_launch("daxpy", "tpumt_daxpy", out, (x, y, out),
                   _rounded(a, x.dtype), x.data_ptr(), y.data_ptr())
    daxpy.launches += 1
    return out


daxpy.launches = 0


def stream_scale_ref(a: float, x: torch.Tensor) -> torch.Tensor:
    """Plain-torch version of :func:`stream_scale`: ``a`` rounded to the
    dtype, times ``x``."""
    return coef(a, x) * x


def stream_scale(a: float, x: torch.Tensor,
                 out: "torch.Tensor | None" = None) -> torch.Tensor:
    """``out = a·x`` (≅ ``stream_scale_pallas``, the 2-stream probe);
    ``out=x`` is the in-place launch."""
    if out is not None:
        _check_stream_out("stream_scale", out, x)
    if x.device.type == "cpu":
        ref = stream_scale_ref(a, x)
        return ref if out is None else out.copy_(ref)
    if x.device.type != "cuda":
        raise ValueError(f"stream_scale: unsupported device {x.device}")
    if out is None:
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
    _stream_launch("stream_scale", "tpumt_stream_scale", out, (x, out),
                   _rounded(a, x.dtype), x.data_ptr())
    stream_scale.launches += 1
    return out


stream_scale.launches = 0


def stream_sum3_ref(w: torch.Tensor, x: torch.Tensor, y: torch.Tensor
                    ) -> torch.Tensor:
    """Plain-torch version of :func:`stream_sum3`: ``(w + x) + y``."""
    _check_stream("stream_sum3", w, x, y)
    return (w + x) + y


def stream_sum3(w: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                out: "torch.Tensor | None" = None) -> torch.Tensor:
    """``out = (w + x) + y`` (≅ ``stream_sum3_pallas``, the 4-stream
    probe: three reads and one write); ``out=y`` is the in-place
    launch."""
    _check_stream("stream_sum3", w, x, y)
    if out is not None:
        _check_stream_out("stream_sum3", out, w, x, y)
    if y.device.type == "cpu":
        ref = stream_sum3_ref(w, x, y)
        return ref if out is None else out.copy_(ref)
    if y.device.type != "cuda":
        raise ValueError(f"stream_sum3: unsupported device {y.device}")
    if out is None:
        out = torch.empty_like(y, memory_format=torch.contiguous_format)
    _stream_launch("stream_sum3", "tpumt_stream_sum3", out, (w, x, y, out),
                   w.data_ptr(), x.data_ptr(), y.data_ptr())
    stream_sum3.launches += 1
    return out


stream_sum3.launches = 0


# ---------------------------------------------------------------------------
# flash attention: the online-softmax fold of one K/V block
# ---------------------------------------------------------------------------

#: the CUDA kernel's own tiles (kQT, kKT of csrc/flash_attention.cu):
#: query rows per CTA and key columns per shared-memory tile
FLASH_Q_TILE, FLASH_K_TILE = 64, 64
#: the widest head the kernel takes (d is padded to 128 or 256)
FLASH_MAX_D = 256
#: "highest": f32 arithmetic (the CUDA cores); "default": the tensor
#: cores (bf16, or TF32 for float32 operands)
FLASH_PRECISIONS = ("highest", "default")
_FLASH_DTYPES = {torch.float32: 0, torch.bfloat16: 2}


@contextlib.contextmanager
def matmul_precision(precision: str):
    """Run the enclosed float32 ``torch.matmul``s at ``precision``:
    "highest" turns TF32 off on the card, "default" on (the card's
    counterpart of the TPU's single-pass DEFAULT). Restores the flag."""
    _check_precision(precision)
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision == "default"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def _check_precision(precision) -> None:
    if precision not in FLASH_PRECISIONS:
        raise ValueError(f"precision must be one of {FLASH_PRECISIONS}, got "
                         f"{precision!r}")


def _check_flash_operands(name: str, q, k, v) -> None:
    """q (L, d) or (L, H, d); k and v (Lk, d) or (Lk, H, d); one dtype
    (float32 or bfloat16) and one device; 1 <= d <= FLASH_MAX_D."""
    if q.dim() not in (2, 3) or k.dim() != q.dim() or v.dim() != q.dim():
        raise ValueError(f"{name}: q, k, v must all be (L, d) or (L, H, d), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if k.shape != v.shape or k.shape[1:] != q.shape[1:]:
        raise ValueError(f"{name}: k and v must be (Lk,) + q.shape[1:], got "
                         f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}")
    if q.shape[0] < 1 or k.shape[0] < 1:
        raise ValueError(f"{name}: empty sequence (L={q.shape[0]}, "
                         f"Lk={k.shape[0]})")
    if not 1 <= q.shape[-1] <= FLASH_MAX_D:
        raise ValueError(f"{name}: head dim {q.shape[-1]} outside [1, "
                         f"{FLASH_MAX_D}], the widest the kernel takes")
    if q.dtype not in _FLASH_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k, v must share a dtype of float32 or "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{name}: q, k, v on different devices")


def _check_carry(q, m, l, acc) -> None:
    L, d = q.shape[0], q.shape[-1]
    want = {"m": (m, (L, 1)), "l": (l, (L, 1)), "acc": (acc, (L, d))}
    for nm, (t, shape) in want.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32 \
                or t.device != q.device:
            raise ValueError(f"flash_attention_block: {nm} must be {shape} "
                             f"float32 on {q.device}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")


def flash_attention_block_ref(q, k, v, m, l, acc, q_off, k_off, *, scale,
                              causal: bool = False, pos_stride=1,
                              precision: str = "highest",
                              k_tile: "int | None" = None,
                              skip_tile: "int | None" = None):
    """Plain-torch version of :func:`flash_attention_block` (returns new
    ``(m, l, acc)``): ``comm.ring.online_softmax_update`` over
    ``k_tile``-wide key tiles (default: the whole block), operands cast as
    ``_qk_operands``/``_pv_operands`` cast them (f32 products; under
    "default" P rounded to a bf16 operand's type before the PV product).
    Causal: a tile dead for every row is skipped, and with ``skip_tile``
    a partly live tile folds in ``skip_tile``-wide sub-spans, each dead
    one skipped — the TPU kernel's fold granularity; the result differs
    only by rounding."""
    from tpu_mpi_tests_torch.comm.ring import online_softmax_update

    _check_flash_operands("flash_attention_block", q, k, v)
    _check_precision(precision)
    if q.dim() != 2:
        raise ValueError("flash_attention_block: (L, d) operands (one head)")
    _check_carry(q, m, l, acc)
    L, Lk = q.shape[0], k.shape[0]
    kt = Lk if not k_tile else int(k_tile)
    qf = q.float()
    q_pos = q_off + pos_stride * torch.arange(L, device=q.device)
    q_min, q_max = int(q_pos[0]), int(q_pos[-1])
    round_p = precision == "default" and v.dtype != torch.float32

    def fold(carry, j0, w):
        m, l, acc = carry
        s = (qf @ k[j0:j0 + w].float().T) * scale
        if causal:
            k_pos = k_off + pos_stride * torch.arange(j0, j0 + w,
                                                      device=q.device)
            s = torch.where(q_pos[:, None] >= k_pos[None, :], s,
                            float("-inf"))
        m_new, l, p, corr = online_softmax_update(m, l, s, keepdims=True)
        if round_p:
            p = p.to(v.dtype).float()
        return m_new, l, acc * corr + p @ v[j0:j0 + w].float()

    def k_pos_of(j):
        return k_off + pos_stride * j

    carry = (m.clone(), l.clone(), acc.clone())
    for j0 in range(0, Lk, kt):
        w = min(kt, Lk - j0)
        if causal and k_pos_of(j0) > q_max:
            break  # this tile and every later one are dead for all rows
        spans = [(j0, w)]
        if causal and skip_tile and k_pos_of(j0 + w - 1) > q_min:
            spans = [(a, min(skip_tile, j0 + w - a))
                     for a in range(j0, j0 + w, skip_tile)]
        for a, wa in spans:
            if not (causal and k_pos_of(a) > q_max):
                carry = fold(carry, a, wa)
    return carry


def _rows_heads(t: torch.Tensor, heads: int) -> tuple[int, int]:
    """(row stride, head stride) in elements: operands (L, H, d) and
    carries (L, H) hold the heads on axis 1; one head has no head axis."""
    return t.stride(0), t.stride(1) if heads > 1 else 0


def _flash_launch(q, k, v, carry_in, carry_out, *, scale, causal, q_off,
                  k_off, pos_stride, precision) -> None:
    """Launch the kernel over every head of ``q`` (the head axis of an
    (L, H, d) operand through its strides), ``carry_in`` → ``carry_out``."""
    for t, nm in ((q, "q"), (k, "k"), (v, "v"), (carry_in[2], "acc"),
                  (carry_out[2], "acc out")):
        if t.stride(-1) != 1:
            raise ValueError(f"flash attention: {nm} needs a contiguous last "
                             f"axis, got strides {t.stride()}")
    if int(pos_stride) < 1:
        raise ValueError(f"pos_stride must be >= 1, got {pos_stride}")
    heads = q.shape[1] if q.dim() == 3 else 1
    strides = [s for t in (q, k, v, *carry_in)
               for s in _rows_heads(t, heads)]
    fn = _entry("flash_attention", "tpumt_flash_attention_block")
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                *(t.data_ptr() for t in carry_in),
                *(t.data_ptr() for t in carry_out),
                _FLASH_DTYPES[q.dtype], q.shape[0], k.shape[0], q.shape[-1],
                heads, *strides, int(q_off), int(k_off), int(pos_stride),
                float(scale), int(bool(causal)),
                int(precision == "highest"),
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        _raise_launch("flash_attention_block", rc)
    flash_attention_block.launches += 1


def _check_flash_out(carry, out):
    """``out`` is None (the in-place fold) or three tensors shaped and
    strided like the carry, each the carry's own buffer or disjoint from
    every carry buffer."""
    if out is None:
        return carry
    out = tuple(out)
    bufs = {t.untyped_storage().data_ptr() for t in carry}
    for o, t in zip(out, carry, strict=True):
        if o.shape != t.shape or o.dtype != t.dtype or o.device != t.device \
                or o.stride() != t.stride():
            raise ValueError("flash_attention_block: out must match (m, l, "
                             "acc) in shape, dtype, device and strides")
        same = o.data_ptr() == t.data_ptr()
        if not same and o.untyped_storage().data_ptr() in bufs:
            raise ValueError("flash_attention_block: out must be the carry "
                             "itself or disjoint from it")
    return out


def flash_attention_block(q, k, v, m, l, acc, q_off, k_off, *, scale,
                          causal: bool = False, pos_stride=1,
                          precision: str = "highest", out=None,
                          k_tile: "int | None" = None,
                          skip_tile: "int | None" = None):
    """Fold one K/V block into the online-softmax carry (≅
    ``flash_attention_block_pallas``): q (L, d), k and v (Lk, d) float32
    or bfloat16; ``m``, ``l`` (L, 1) and ``acc`` (L, d) float32, updated
    IN PLACE (JAX donates and aliases them) unless ``out`` names three
    other tensors. Returns the written ``(m, l, acc)``.

    Causal masking runs in global positions ``off + pos_stride·idx``
    (runtime ints); every K/V tile dead for all of a CTA's rows is
    skipped. ``precision="highest"`` is f32 arithmetic on the CUDA cores
    (bf16 operands widened, P kept f32); ``"default"`` is the tensor
    cores: bf16 ``mma.sync`` with P rounded to bf16, or, for float32
    operands, TF32 ``mma.sync`` (the card's counterpart of the TPU's
    single-pass DEFAULT, ~3 decimal digits per operand). ``k_tile`` and
    ``skip_tile`` are the TPU kernel's tile knobs: the plain version on
    the CPU folds at them; the card runs the kernel's own 64×64 tiles."""
    _check_flash_operands("flash_attention_block", q, k, v)
    _check_precision(precision)
    if q.dim() != 2:
        raise ValueError("flash_attention_block: (L, d) operands (one head); "
                         "flash_attention takes (L, H, d)")
    _check_carry(q, m, l, acc)
    carry = (m, l, acc)
    dest = _check_flash_out(carry, out)
    if q.device.type == "cpu":
        got = flash_attention_block_ref(
            q, k, v, m, l, acc, q_off, k_off, scale=scale, causal=causal,
            pos_stride=pos_stride, precision=precision, k_tile=k_tile,
            skip_tile=skip_tile)
        for o, g in zip(dest, got):
            o.copy_(g)
        return dest
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_block: unsupported device "
                         f"{q.device}")
    _flash_launch(q, k, v, carry, dest, scale=scale, causal=causal,
                  q_off=q_off, k_off=k_off, pos_stride=pos_stride,
                  precision=precision)
    return dest


flash_attention_block.launches = 0


def _attention_carry(q):
    """The fresh carry of :func:`flash_attention`: m = -inf, l = 0 as
    (L, H) ((L, 1) for one head) and acc = 0 shaped like q, float32."""
    L = q.shape[0]
    H = q.shape[1] if q.dim() == 3 else 1
    kw = {"dtype": torch.float32, "device": q.device}
    return (torch.full((L, H), float("-inf"), **kw),
            torch.zeros((L, H), **kw), torch.zeros(q.shape, **kw))


def _normalise(q, l, acc):
    return (acc / (l[..., None] if q.dim() == 3 else l)).to(q.dtype)


def flash_attention_ref(q, k, v, *, scale=None, causal: bool = False,
                        precision: str = "highest",
                        k_tile: "int | None" = None,
                        skip_tile: "int | None" = None):
    """Plain-torch version of :func:`flash_attention`: one
    :func:`flash_attention_block_ref` per head from the fresh carry, then
    ``(acc / l)`` in q's dtype."""
    _check_flash_operands("flash_attention", q, k, v)
    if scale is None:
        scale = 1.0 / q.shape[-1] ** 0.5
    if q.dim() == 3:
        return torch.stack([
            flash_attention_ref(q[:, h], k[:, h], v[:, h], scale=scale,
                                causal=causal, precision=precision,
                                k_tile=k_tile, skip_tile=skip_tile)
            for h in range(q.shape[1])], dim=1)
    m, l, acc = flash_attention_block_ref(
        q, k, v, *_attention_carry(q), 0, 0, scale=scale, causal=causal,
        precision=precision, k_tile=k_tile, skip_tile=skip_tile)
    return _normalise(q, l, acc)


def flash_attention(q, k, v, *, scale=None, causal: bool = False,
                    precision: str = "highest",
                    k_tile: "int | None" = None,
                    skip_tile: "int | None" = None):
    """softmax(q·kᵀ·scale)·v without an L×L score matrix (≅
    ``flash_attention_pallas``; ``scale`` defaults to 1/√d): the carry
    starts at (-inf, 0, 0), one :func:`flash_attention_block` launch over
    all heads folds the whole block (causal: self-attention, offsets 0),
    and ``(acc / l)`` comes back in q's dtype through torch ops. q, k, v
    are (L, d), or (L, H, d) — every head in the one launch, read through
    the strides, giving the layout of ``jax.vmap(flash_attention_pallas,
    in_axes=1, out_axes=1)``."""
    _check_flash_operands("flash_attention", q, k, v)
    _check_precision(precision)
    if scale is None:
        scale = 1.0 / q.shape[-1] ** 0.5
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, scale=scale, causal=causal,
                                   precision=precision, k_tile=k_tile,
                                   skip_tile=skip_tile)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    carry = _attention_carry(q)
    _flash_launch(q, k, v, carry, carry, scale=scale, causal=causal,
                  q_off=0, k_off=0, pos_stride=1, precision=precision)
    return _normalise(q, carry[1], carry[2])


#: every wrapper of a hand kernel (name → function with a .launches count)
WRAPPERS = {
    "stencil2d_iterate": stencil2d_iterate,
    "stencil2d_deriv": stencil2d_deriv,
    "heat2d": heat2d,
    "dual_dim_step": dual_dim_step,
    "alu_probe": alu_probe,
    "pack_edges": pack_edges,
    "unpack_ghosts": unpack_ghosts,
    "daxpy": daxpy,
    "stream_scale": stream_scale,
    "stream_sum3": stream_sum3,
    "flash_attention_block": flash_attention_block,
}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
