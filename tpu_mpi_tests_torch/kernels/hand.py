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
* :func:`ring_halo` — both ``n_bnd``-wide interior edge bands stored
  straight into the ring neighbours' ghost bands (``ring_halo_pallas``,
  :1804); source ``csrc/ring_halo.cu``.
* :func:`stencil2d_fused_rdma` — that exchange and the k-step update
  along dim 0 in one launch, the interior computed while the edges fly
  (``stencil2d_fused_rdma_pallas``, :2090); source ``csrc/fused_rdma.cu``.
  The two ring kernels take their neighbours' addresses and signal pads
  from ``comm/peer.py``; their plain versions exchange over the process
  group (gloo on the CPU), or copy locally on the world=1 self-ring.
* :func:`ring_allgather` — the (w−1)-hop ring all-gather
  (``ring_allgather_pallas``, :2339), and :func:`ring_reduce_scatter` —
  the ring reduce-scatter with receiver credits
  (``ring_reduce_scatter_pallas``, :2576); :func:`ring_allreduce` is the
  two, one after the other (``ring_allreduce_pallas``, :2717); source
  ``csrc/ring_collectives.cu``. :func:`oneshot_allgather` and
  :func:`oneshot_allreduce` — one burst into every peer, then a copy or
  an ascending-rank fold (``collectives_pallas.py`` ``_oneshot_call``
  :179, kernel :74); source ``csrc/oneshot.cu``. Their plain versions
  move data over the process group (``Ring.shift``,
  ``collectives.all_gather``) and fold in the kernels' order.
* :func:`flash_attention_block` — the online-softmax fold of one K/V
  block into the (m, l, acc) carry, in place, causal in global positions
  (``flash_attention_block_pallas`` :3230), and :func:`flash_attention`
  on top of it (``flash_attention_pallas`` :3416); source
  ``csrc/flash_attention.cu``, its tile body ``csrc/flash_fold.cuh``.
* :func:`fused_ring_attention` — every step of ring attention in one
  launch, the K/V blocks forwarded to the right neighbour by peer stores
  under entry-barrier, arrival and credit flags, each step folded with
  the flash kernel's tile body (``collectives_pallas.py``
  ``fused_ring_attention_pallas`` :529); source
  ``csrc/fused_ring_attention.cu``. Its plain version runs the ring over
  the process group with :func:`flash_attention_block_ref` at each step.

A wrapper given a CUDA tensor launches its kernel on the current stream
or raises; it takes the plain version (``*_ref``) only because the
tensor it was given lies on the CPU. Each wrapper counts its launches in
a plain integer attribute (``stencil2d_iterate.launches``), so a run can
show that its main path went through the kernel; the two attention
wrappers also count per route (``launches_by_route``, keys
:data:`FLASH_ROUTES`, :func:`route_counts`), so a run shows which fold
body — ``wgmma``, ``mma`` or ``fma`` — its launches took, and so do the
two ring collectives, the one-shot kernel, the ring halo and the three
streaming kernels (keys :data:`COLL_ROUTES`: ``vec16`` or ``scalar``;
:func:`coll_route`, :func:`halo_route`, :func:`stream_route`) and the
two halo staging copies (keys
:data:`PACK_ROUTES`: ``vec16``, ``vec8`` or ``scalar``;
:func:`pack_route`) and the two k-step kernels (keys
:data:`KSTEP_ROUTES`: ``regs`` or ``smem``; :func:`kstep_route`), the
derivative (keys :data:`DERIV_ROUTES`: ``regs`` or ``scalar``;
:func:`deriv_route`), the heat update (keys :data:`HEAT_ROUTES`:
``regs`` or ``smem``; :func:`heat_route`), the dual step (keys
:data:`DUAL_ROUTES`: ``regs`` or ``smem``; :func:`dual_route`) and the
probe (keys :data:`PROBE_ROUTES`: ``cluster`` or ``l2``;
:func:`probe_route`).

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
import functools

import numpy as np
import torch

from tpu_mpi_tests_torch.comm.collectives import all_gather
from tpu_mpi_tests_torch.comm.mesh import Ring, make_mesh
from tpu_mpi_tests_torch.comm.peer import (
    COLL_MAX_WORLD,
    PAD_WORDS,
    check_collective_world,
    peer_ring,
)
from tpu_mpi_tests_torch.instrument.nans import checked
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
from tpu_mpi_tests_torch.tune import priors as _priors

# STENCIL5 is antisymmetric: the update uses the 2-difference form
# C1·(z₊₁−z₋₁) + C2·(z₊₂−z₋₂), as the JAX kernel's _step5 does
_C1, _C2 = float(STENCIL5[3]), float(STENCIL5[4])

#: dtype → the code the C entry points take (csrc/stencil_common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}

_c_void_p, _c_int, _c_ll, _c_double = (
    ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double)
# C entry point → (argument types, return type)
_SIGNATURES = {
    # z, out; dtype, dim, n0, n1, steps; se, c1, c2; phys_lo, phys_hi,
    # phys; route (KSTEP_ROUTES index), stream
    "tpumt_stencil2d_iterate": ([
        _c_void_p, _c_void_p, _c_int, _c_int, _c_ll, _c_ll, _c_int,
        _c_double, _c_double, _c_double, _c_int, _c_int, _c_void_p, _c_int,
        _c_void_p,
    ], _c_int),
    # z, out; dtype, dim, n0, n1; c0..c4, scale; route (DERIV_ROUTES
    # index), stream
    "tpumt_stencil2d_deriv": ([
        _c_void_p, _c_void_p, _c_int, _c_int, _c_ll, _c_ll,
        _c_double, _c_double, _c_double, _c_double, _c_double, _c_double,
        _c_int, _c_void_p,
    ], _c_int),
    # z, out; dtype, n0, n1, steps; cx, cy, two; route (HEAT_ROUTES
    # index), stream
    "tpumt_heat2d": ([
        _c_void_p, _c_void_p, _c_int, _c_ll, _c_ll, _c_int, _c_double,
        _c_double, _c_double, _c_int, _c_void_p,
    ], _c_int),
    "tpumt_heat2d_max_steps": ([_c_int], _c_int),
    # z, dx, dy, partials, residual; dtype, n0, n1; c0..c4, sx, sy; lean,
    # route (DUAL_ROUTES index), stream
    "tpumt_dual_dim_step": ([
        _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_int,
        _c_ll, _c_ll, _c_double, _c_double, _c_double, _c_double,
        _c_double, _c_double, _c_double, _c_int, _c_int, _c_void_p,
    ], _c_int),
    # dtype, n0, n1, route, lean
    "tpumt_dual_dim_step_parts": ([_c_int, _c_ll, _c_ll, _c_int, _c_int],
                                  _c_ll),
    "tpumt_dual_dim_step_route": ([_c_int, _c_void_p, _c_ll], _c_int),
    # z, buffer a, buffer b, partials; dtype, mix, blocks, H, W, reps;
    # eight constants, float32(se); route (PROBE_ROUTES index); CTAs
    # launched (out), stream
    "tpumt_alu_probe": (
        [_c_void_p] * 4 + [_c_int, _c_int, _c_ll, _c_ll, _c_ll, _c_int]
        + [_c_double] * 9 + [_c_int, ctypes.POINTER(_c_int), _c_void_p],
        _c_int),
    "tpumt_alu_probe_tiles": ([_c_ll, _c_ll], _c_ll),
    "tpumt_alu_probe_l2_bytes": ([], _c_ll),
    "tpumt_alu_probe_route": ([_c_int, _c_ll, _c_ll], _c_int),
    "tpumt_alu_issue_rate": ([], _c_double),
    "tpumt_alu_probe_clusters": ([_c_int, _c_ll, _c_ll], _c_int),
    # z, lo, hi; itemsize, axis, n0, n1, n_bnd, route (PACK_ROUTES
    # index), stream
    "tpumt_pack_edges": (
        [_c_void_p] * 3 + [_c_int, _c_int, _c_ll, _c_ll, _c_ll, _c_int,
                           _c_void_p], _c_int),
    "tpumt_unpack_ghosts": (
        [_c_void_p] * 3 + [_c_int, _c_int, _c_ll, _c_ll, _c_ll, _c_int,
                           _c_void_p], _c_int),
    # a; x, y, out; dtype, n, route (COLL_ROUTES index), stream
    "tpumt_daxpy": ([
        _c_double, _c_void_p, _c_void_p, _c_void_p, _c_int, _c_ll, _c_int,
        _c_void_p,
    ], _c_int),
    "tpumt_stream_scale": ([
        _c_double, _c_void_p, _c_void_p, _c_int, _c_ll, _c_int, _c_void_p,
    ], _c_int),
    "tpumt_stream_sum3": ([
        _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_int, _c_ll, _c_int,
        _c_void_p,
    ], _c_int),
    # q, k, v, m/l/acc in, m/l/acc out; dtype, L, Lk, d, heads; (row,
    # head) strides of q, k, v, m, l, acc; q_off, k_off, pos_stride;
    # scale, causal, route (FLASH_ROUTES index), stream
    "tpumt_flash_attention_block": (
        [_c_void_p] * 9 + [_c_int, _c_ll, _c_ll, _c_int, _c_int]
        + [_c_ll] * 15 + [_c_double, _c_int, _c_int, _c_void_p], _c_int),
    # z, left z, right z, pad, left pad, right pad; itemsize, axis, n0,
    # n1, n_bnd, send_lo, send_hi; stage; route (COLL_ROUTES index),
    # max_ctas, stream (every RDMA kernel reads its epoch from the pad)
    "tpumt_ring_halo": (
        [_c_void_p] * 6 + [_c_int, _c_int, _c_ll, _c_ll, _c_ll,
                           _c_int, _c_int, _c_void_p, _c_int, _c_int,
                           _c_void_p], _c_int),
    # z, out, left z, right z, pad, left pad, right pad; dtype, n0, n1,
    # steps, rows per block; se, c1, c2; phys_lo, phys_hi, phys;
    # send_lo, send_hi; route (KSTEP_ROUTES index); stage; rows per block
    # launched (out), stream
    "tpumt_stencil2d_fused_rdma": (
        [_c_void_p] * 7 + [_c_int, _c_ll, _c_ll, _c_int, _c_int]
        + [_c_double] * 3 + [_c_int, _c_int, _c_void_p, _c_int, _c_int,
                             _c_int, _c_void_p, ctypes.POINTER(_c_int),
                             _c_void_p], _c_int),
    # x, out, buf, right buf, pad, left pad, right pad; itemsize, w, my,
    # n, seed_all, route (COLL_ROUTES index), max_ctas, stream
    "tpumt_ring_allgather": (
        [_c_void_p] * 7 + [_c_int, _c_int, _c_int, _c_ll, _c_int,
                           _c_int, _c_int, _c_void_p], _c_int),
    # x, out, comm, right comm, send, pad, left pad, right pad; dtype, w,
    # my, chunk elements, credits, route (COLL_ROUTES index), max_ctas,
    # stream
    "tpumt_ring_reduce_scatter": (
        [_c_void_p] * 8 + [_c_int, _c_int, _c_int, _c_ll, _c_int,
                           _c_int, _c_int, _c_void_p], _c_int),
    # x, out, comm buffers (w), pads (w); dtype, w, my, n, sum, route
    # (COLL_ROUTES index), max_ctas, stream
    "tpumt_oneshot": (
        [_c_void_p] * 4 + [_c_int, _c_int, _c_int, _c_ll, _c_int,
                           _c_int, _c_int, _c_void_p], _c_int),
    # q, k, v, out, m, l, acc, slots, right slots, pad, left pad, right
    # pad; dtype, lq, lk, d, w, my, v_off; scale; causal, stripe, route
    # (FLASH_ROUTES index), max_ctas; CTAs launched (out), stream
    "tpumt_fused_ring_attention": (
        [_c_void_p] * 12 + [_c_int, _c_ll, _c_ll, _c_int, _c_int,
                            _c_int, _c_ll, _c_double, _c_int, _c_int,
                            _c_int, _c_int, ctypes.POINTER(_c_int),
                            _c_void_p], _c_int),
}


@functools.lru_cache(maxsize=None)
def _entry(lib_name: str, fn_name: str):
    """The C entry point, its argument types set once (cached: a launch
    does no symbol lookup)."""
    fn = getattr(build.load(lib_name), fn_name)
    fn.argtypes, fn.restype = _SIGNATURES[fn_name]
    return fn


@functools.lru_cache(maxsize=4096)
def _rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` (what :func:`coef` multiplies by),
    as a Python float — exactly representable, so the kernel's
    double → dtype conversion is exact. Cached per (value, dtype): a
    launch builds no tensor for its coefficients."""
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
    o_lo, o_hi = _span(out)
    z_lo, z_hi = _span(z)
    if o_lo < z_hi and z_lo < o_hi:
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


#: the routes of the k-step body (csrc/stencil_kstep.cuh; a route's code
#: is its index): "regs" — every k step in registers, a thread a column
#: vector through a row pipeline (dim 0), a warp a row segment stepped by
#: shuffles (dim 1); "smem" — the tile stepped in shared memory, any
#: steps, any alignment
KSTEP_ROUTES = ("smem", "regs")
# TPM701 suppressions in this module: each constant mirrors a
# compile-time constant of a csrc/ kernel (named beside it); the tuner
# cannot move it without rebuilding the kernel, so it is no schedule knob
#: the most steps the regs route's registers hold (kRegsMaxSteps)
KSTEP_REGS_MAX_STEPS = 8  # tpumt: ignore[TPM701]
#: the bytes every row of z and out starts on for the regs route of the
#: iterate (kIterateRowBytes) and of the fused kernel (kFusedRowBytes)
KSTEP_ROW_BYTES = 8  # tpumt: ignore[TPM701]
FUSED_ROW_BYTES = 16


def _rows_vec_bytes(widths, z: torch.Tensor, out, pitches) -> int:
    """The first of ``widths`` (bytes) that every row of ``z`` and ``out``
    (None: a fresh allocation, which starts on 16 bytes) starts on: both
    start there and each of ``pitches`` (bytes) is a whole multiple of it;
    else 0."""
    ptrs = (z.data_ptr(),) + (() if out is None else (out.data_ptr(),))
    for b in widths:
        if all(p % b == 0 for p in ptrs + tuple(pitches)):
            return b
    return 0


def kstep_vec_bytes(z: torch.Tensor,
                    out: "torch.Tensor | None" = None) -> int:
    """The regs route's vector for the contiguous 2-D ``z`` and ``out``
    (None: a fresh allocation, which starts on 16 bytes), as the C
    launchers take it (``kstep_vec_bytes``): 16 bytes where every row of
    both starts on 16 bytes (both start there and the row pitch is whole
    16-byte vectors), else 8 where every row starts on 8, else 0."""
    return _rows_vec_bytes((16, 8), z, out,
                           (z.shape[-1] * z.element_size(),))


def kstep_route(z: torch.Tensor, dim: int, steps: int,
                out: "torch.Tensor | None" = None,
                fused: bool = False) -> str:
    """The route (one of :data:`KSTEP_ROUTES`) of a k-step launch of
    :func:`stencil2d_iterate` (or, ``fused``, of
    :func:`stencil2d_fused_rdma`) on the contiguous 2-D ``z`` along
    ``dim`` into ``out``, by the rule the C launchers check: "regs" when
    1 ≤ ``steps`` ≤ :data:`KSTEP_REGS_MAX_STEPS` and every row of ``z``
    and ``out`` starts on :data:`KSTEP_ROW_BYTES` (the fused kernel:
    :data:`FUSED_ROW_BYTES`), else "smem"."""
    if dim not in (0, 1):
        raise ValueError(f"dim must be 0 or 1, got {dim}")
    least = FUSED_ROW_BYTES if fused else KSTEP_ROW_BYTES
    regs = (1 <= steps <= KSTEP_REGS_MAX_STEPS
            and kstep_vec_bytes(z, out) >= least)
    return "regs" if regs else "smem"


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


@checked
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
    advanced, as the JAX kernel returns them. The launch takes the route
    :func:`kstep_route` names for ``z``, ``out`` and ``steps``, counted in
    ``stencil2d_iterate.launches_by_route``."""
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
    route = kstep_route(z, dim, steps, out)
    fn = _entry("stencil_iterate", "tpumt_stencil2d_iterate")
    with torch.cuda.device(z.device):
        rc = fn(
            z.data_ptr(), out.data_ptr(), DTYPE_CODES[z.dtype], dim,
            z.shape[0], z.shape[1], steps,
            _rounded(scale_eps, z.dtype), _rounded(_C1, z.dtype),
            _rounded(_C2, z.dtype), plo, phi,
            None if ph is None else ph.data_ptr(),
            KSTEP_ROUTES.index(route),
            torch.cuda.current_stream(z.device).cuda_stream,
        )
    if rc != 0:
        _raise_launch(f"stencil2d_iterate ({route} route)", rc)
    stencil2d_iterate.launches += 1
    stencil2d_iterate.launches_by_route[route] += 1
    return out


stencil2d_iterate.launches = 0
stencil2d_iterate.launches_by_route = dict.fromkeys(KSTEP_ROUTES, 0)


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


#: the routes of the derivative (csrc/stencil_deriv.cu; a route's code is
#: its index): "regs" — every input row read once in 16- or 8-byte
#: vectors, a thread a column vector down a run of rows through a 5-row
#: register window (dim 0), a warp a row segment down a run of rows, its
#: lanes' right-hand taps by shuffles (dim 1); "scalar" — one element a
#: thread, any alignment
DERIV_ROUTES = ("scalar", "regs")

def deriv_vec_bytes(z: torch.Tensor, dim: int,
                    out: "torch.Tensor | None" = None) -> int:
    """The regs route's vector for the contiguous 2-D ``z`` and its
    derivative ``out`` along ``dim`` (None: a fresh allocation, which
    starts on 16 bytes), as the C launcher takes it
    (``deriv_vec_bytes``): 16 bytes where every row of both starts on 16
    (both start there and both row pitches — along dim 1 out's is 4
    elements shorter — are whole 16-byte vectors), else 8 where every row
    starts on 8, else 0."""
    item = z.element_size()
    m1 = z.shape[1] - 2 * N_BND if dim == 1 else z.shape[1]
    return _rows_vec_bytes((16, 8), z, out, (z.shape[1] * item, m1 * item))


def deriv_route(z: torch.Tensor, dim: int,
                out: "torch.Tensor | None" = None) -> str:
    """The route (one of :data:`DERIV_ROUTES`) of a
    :func:`stencil2d_deriv` launch on the contiguous 2-D ``z`` along
    ``dim`` into ``out``, by the rule the C launcher checks: "regs" where
    :func:`deriv_vec_bytes` finds a vector, else "scalar"."""
    if dim not in (0, 1):
        raise ValueError(f"dim must be 0 or 1, got {dim}")
    return "regs" if deriv_vec_bytes(z, dim, out) else "scalar"


def stencil2d_deriv_ref(z: torch.Tensor, scale, dim: int = 0
                        ) -> torch.Tensor:
    """Plain-torch version of :func:`stencil2d_deriv`: the torch-op
    stencil, whose accumulation order is the kernel's."""
    _deriv_shape(z, dim)
    return stencil1d_5(z, scale=scale, axis=dim)


@checked
def stencil2d_deriv(z: torch.Tensor, scale, dim: int = 0,
                    out: "torch.Tensor | None" = None) -> torch.Tensor:
    """5-point first derivative × ``scale`` along ``dim`` of a 2-D array
    ghosted along ``dim`` (out has 2·N_BND fewer points there; ≅
    ``stencil2d_pallas`` and the SYCL ``stencil2d_1d_5``). The launch
    takes the route :func:`deriv_route` names for ``z`` and ``out``,
    counted in ``stencil2d_deriv.launches_by_route``."""
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
    route = deriv_route(z, dim, out)
    fn = _entry("stencil_deriv", "tpumt_stencil2d_deriv")
    with torch.cuda.device(z.device):
        rc = fn(
            z.data_ptr(), out.data_ptr(), DTYPE_CODES[z.dtype], dim,
            z.shape[0], z.shape[1], *c, _rounded(scale, z.dtype),
            DERIV_ROUTES.index(route),
            torch.cuda.current_stream(z.device).cuda_stream,
        )
    if rc != 0:
        _raise_launch(f"stencil2d_deriv ({route} route)", rc)
    stencil2d_deriv.launches += 1
    stencil2d_deriv.launches_by_route[route] += 1
    return out


stencil2d_deriv.launches = 0
stencil2d_deriv.launches_by_route = dict.fromkeys(DERIV_ROUTES, 0)


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


#: the routes of the heat update (csrc/heat2d.cu; a route's code is its
#: index): "regs" — every step in registers, a warp a column segment
#: walking a run of rows through a k-stage pipeline of 3-row windows,
#: column neighbours by shuffles; "smem" — the tile stepped in shared
#: memory, any steps that fit, any alignment
HEAT_ROUTES = ("smem", "regs")
#: the most steps the regs route's registers hold (kHeatRegsMaxSteps)
HEAT_REGS_MAX_STEPS = 8  # tpumt: ignore[TPM701]


def heat_vec_bytes(z: torch.Tensor,
                   out: "torch.Tensor | None" = None) -> int:
    """The regs route's vector for the contiguous 2-D ``z`` and ``out``
    (None: a fresh allocation, which starts on 16 bytes), as the C
    launcher takes it (``heat_vec_bytes``): the widest of 16, 8 and 4
    bytes that every row of both starts on (both start there and the row
    pitch is whole vectors) and that holds a whole word (two bfloat16
    elements, one float32 or float64 element), else 0."""
    item = z.element_size()
    widths = (16, 8) if item == 8 else (16, 8, 4)  # a vector holds a word
    return _rows_vec_bytes(widths, z, out, (z.shape[-1] * item,))


def heat_route(z: torch.Tensor, steps: int,
               out: "torch.Tensor | None" = None) -> str:
    """The route (one of :data:`HEAT_ROUTES`) of a :func:`heat2d` launch
    on the contiguous 2-D ``z`` into ``out``, by the rule the C launcher
    checks: "regs" when 1 ≤ ``steps`` ≤ :data:`HEAT_REGS_MAX_STEPS` and
    :func:`heat_vec_bytes` finds a vector (float32 and float64 always;
    bfloat16 where every row starts on 4 bytes), else "smem"."""
    regs = 1 <= steps <= HEAT_REGS_MAX_STEPS and heat_vec_bytes(z, out) > 0
    return "regs" if regs else "smem"


@functools.lru_cache(maxsize=None)
def heat2d_max_steps(dtype: torch.dtype) -> int:
    """The deepest ``steps`` one :func:`heat2d` launch on the smem route
    takes in ``dtype`` (the tile and its apron must fit in shared memory;
    asked of the library once per dtype)."""
    fn = _entry("heat2d", "tpumt_heat2d_max_steps")
    return fn(DTYPE_CODES[dtype])


@checked
def heat2d(z: torch.Tensor, cx: float, cy: float, steps: int = 1,
           out: "torch.Tensor | None" = None) -> torch.Tensor:
    """``steps`` explicit-Euler steps ``mid += cx·δ²x + cy·δ²y`` of a
    both-axes-ghosted shard over the maximal span ``[1, n0−1) × [1,
    n1−1)``, the outer ring kept (≅ ``heat2d_pallas``), written to
    ``out`` (a new tensor when None) — never in place: ``out`` must not
    share storage with ``z``. Ghost-band cells are results too. The
    launch takes the route :func:`heat_route` names for ``z``, ``out``
    and ``steps``, counted in ``heat2d.launches_by_route``; only the smem
    route is bounded by shared memory (:func:`heat2d_max_steps`)."""
    _check_heat(z, steps)
    if out is not None:
        _check_out(out, z, z.shape, "heat2d")
    if z.device.type == "cpu":
        ref = heat2d_ref(z, cx, cy, steps)
        return ref if out is None else out.copy_(ref)
    if z.device.type != "cuda":
        raise ValueError(f"heat2d: unsupported device {z.device}")
    _check_cuda_operand(z, "heat2d")
    if out is None:
        out = torch.empty_like(z)
    route = heat_route(z, steps, out)
    if route == "smem":
        deepest = heat2d_max_steps(z.dtype)
        if steps > deepest:
            raise ValueError(
                f"heat2d: steps={steps} > {deepest}, the deepest apron that "
                f"fits in shared memory for {z.dtype} (the smem route)")
    fn = _entry("heat2d", "tpumt_heat2d")
    with torch.cuda.device(z.device):
        rc = fn(
            z.data_ptr(), out.data_ptr(), DTYPE_CODES[z.dtype],
            z.shape[0], z.shape[1], steps, _rounded(cx, z.dtype),
            _rounded(cy, z.dtype), 2.0, HEAT_ROUTES.index(route),
            torch.cuda.current_stream(z.device).cuda_stream,
        )
    if rc != 0:
        _raise_launch(f"heat2d ({route} route)", rc)
    heat2d.launches += 1
    heat2d.launches_by_route[route] += 1
    return out


heat2d.launches = 0
heat2d.launches_by_route = dict.fromkeys(HEAT_ROUTES, 0)


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


#: the routes of the dual step (csrc/dual_dim_step.cu; a route's code is
#: its index): "regs" — a thread walks 8 output columns down a run of
#: rows, the 5-row window in registers, bfloat16 where every row of z
#: starts on 4 elements; "smem" — a 32×128 output tile a CTA from a
#: shared-memory window, any dtype and alignment (float32's route: the
#: register walk ran 1-2 % behind it on the H100)
DUAL_ROUTES = ("smem", "regs")
#: elements every row of z starts on for the regs route
DUAL_ROW_ELEMS = 4


def dual_route(z: torch.Tensor) -> str:
    """The route (one of :data:`DUAL_ROUTES`) of a :func:`dual_dim_step`
    launch on the contiguous 2-D ``z``, by the rule the C launcher checks:
    "regs" for bfloat16 where every row of ``z`` starts on
    :data:`DUAL_ROW_ELEMS` elements (``z`` starts on that many elements'
    bytes and the row length is a multiple of it), else "smem"."""
    if z.dim() != 2:
        raise ValueError(f"dual_route: 2-D input required, got shape "
                         f"{tuple(z.shape)}")
    vb = DUAL_ROW_ELEMS * z.element_size()
    regs = (z.dtype == torch.bfloat16
            and z.shape[1] % DUAL_ROW_ELEMS == 0 and z.data_ptr() % vb == 0)
    return "regs" if regs else "smem"


#: |kernel − plain| / |plain| the dual step's residual may show on the
#: card. Both sum the same rounded squares, but in another order (the
#: kernel: per-thread, a fixed tree per CTA, a second pass over the CTA
#: partials; torch: its own reduction tree), so float32 differs by
#: rounding of ~10⁸ terms; in bfloat16 each side rounds its two sums and
#: their total to bf16, which can land one bf16 ulp apart twice.
RESIDUAL_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12,
                 torch.bfloat16: 2.0**-6}


@checked
def dual_dim_step(z: torch.Tensor, n_bnd: int, scale_x: float,
                  scale_y: float, lean: "bool | None" = None):
    """``(dz_dx, dz_dy, residual)`` of a block ghosted ``n_bnd`` = N_BND
    along both axes (≅ ``dual_dim_step_pallas``): the 5-point derivative
    along rows on the interior columns × ``scale_x``, along columns on
    the interior rows × ``scale_y``, both ``(n0−4, n1−4)``, and
    ``Σdz_dx² + Σdz_dy²`` as a 0-dim tensor of the array dtype. The
    derivatives match the plain version bit for bit; the residual is a
    deterministic sum in another order (:data:`RESIDUAL_RTOL`). One
    wrapper call is one count: the kernel runs as a pass over ``z`` on the
    route :func:`dual_route` names (counted in
    ``dual_dim_step.launches_by_route``) and a one-CTA pass over its
    partials.

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
    route = dual_route(z)
    with torch.cuda.device(z.device):
        parts = _entry("dual_dim_step", "tpumt_dual_dim_step_parts")(
            DTYPE_CODES[z.dtype], n0, n1, DUAL_ROUTES.index(route),
            int(lean))
    if parts <= 0:
        _raise_launch(f"dual_dim_step ({route} route)", 1)
    acc = torch.float64 if z.dtype == torch.float64 else torch.float32
    part = torch.empty(2 * parts, dtype=acc, device=z.device)
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
            int(lean), DUAL_ROUTES.index(route),
            torch.cuda.current_stream(z.device).cuda_stream,
        )
    if rc != 0:
        _raise_launch(f"dual_dim_step ({route} route)", rc)
    dual_dim_step.launches += 1
    dual_dim_step.launches_by_route[route] += 1
    return dx, dy, res


dual_dim_step.launches = 0
dual_dim_step.launches_by_route = dict.fromkeys(DUAL_ROUTES, 0)


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
                      "step5fma_d0": 8, "step5fma_d1": 8, "heat5": 9,
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


#: the routes of the probe (csrc/alu_probe.cu; a route's code is its
#: index): "cluster" — one thread-block cluster a block, held in its CTAs'
#: registers and shared memory for all reps (fma and the dim-1 mixes in
#: registers with no barrier, the dim-0 mixes in registers with their
#: runs' edge rows exchanged and a cluster barrier a rep, heat5 and the
#: dual mixes in a shared-memory ping-pong with a cluster barrier a rep);
#: "l2" — the blocks in two L2-resident ping-pong buffers, one cooperative
#: launch, a grid barrier a rep, for blocks no cluster holds
PROBE_ROUTES = ("l2", "cluster")
#: the cluster route's bounds (csrc/alu_probe.cu): dynamic shared memory a
#: CTA's ping-pong may take (kClusterSmem), CTAs a cluster at most
#: (kMaxCluster), the bytes of a slab row's vectors
PROBE_CLUSTER_SMEM = 232448 - 1024
PROBE_MAX_CLUSTER = 16
PROBE_VEC_BYTES = 16


def probe_cluster(H: int, W: int, dtype: torch.dtype):
    """The cluster of an (H, W) block of ``dtype`` on the cluster route,
    as ``cluster_config`` in ``csrc/alu_probe.cu`` picks it:
    ``(ctas, rows a CTA, slab pitch in elements, bytes of the two
    slabs)`` for the fewest CTAs (1, 2, 4, … :data:`PROBE_MAX_CLUSTER`)
    whose two slabs fit :data:`PROBE_CLUSTER_SMEM` with at least N_BND
    rows a slab (unless one CTA holds the block); None when none does."""
    item = torch.empty((), dtype=dtype).element_size()
    ve = PROBE_VEC_BYTES // item
    pitch = -(-W // ve) * ve
    cs = 1
    while cs <= PROBE_MAX_CLUSTER:
        rs = -(-H // cs)
        if cs > 1 and rs < N_BND:
            break
        if 2 * rs * pitch * item <= PROBE_CLUSTER_SMEM:
            return cs, rs, pitch, 2 * rs * pitch * item
        cs *= 2
    return None


def probe_route(z: torch.Tensor, mix: str = "fma") -> str:
    """The route (one of :data:`PROBE_ROUTES`) of an :func:`alu_probe`
    launch on ``z`` (an (H, W) block or a (B, H, W) stack), by the rule
    the C entry point checks: "cluster" where :func:`probe_cluster` finds
    a cluster for one block, else "l2". Every mix takes the same route."""
    _check_probe(z, 1, mix)
    H, W = z.shape[-2:]
    return "cluster" if probe_cluster(H, W, z.dtype) else "l2"


def alu_probe_clusters(H: int, W: int, dtype: torch.dtype) -> int:
    """Clusters of (H, W) blocks of ``dtype`` that the current CUDA
    device holds at once on the cluster route
    (``cudaOccupancyMaxActiveClusters``); 0 where the block takes the l2
    route."""
    if probe_cluster(H, W, dtype) is None:
        return 0
    n = int(_entry("alu_probe", "tpumt_alu_probe_clusters")(
        DTYPE_CODES[dtype], H, W))
    if n < 0:
        _raise_launch("alu_probe_clusters", -n)
    return n


#: lone mul/add/sub instructions an SM issues a clock (four schedulers,
#: 32 lanes each); a bf16x2 instruction does two elements
ALU_LANES_PER_SM = 128


def alu_issue_rate() -> float:
    """Lone float32 mul/add/sub the current CUDA device issues a second
    at most: SMs × :data:`ALU_LANES_PER_SM` × the peak SM clock
    (``cudaDevAttrMultiProcessorCount``, ``cudaDevAttrClockRate``).
    Unlike the published 67 TFLOP/s, which counts an FMA as two flops,
    this counts instructions, as the probe issues them."""
    rate = float(_entry("alu_probe", "tpumt_alu_issue_rate")())
    if not rate > 0:
        _raise_launch("alu_issue_rate", 1)
    return rate


def probe_bound_s(mix: str, dtype: torch.dtype, elements: int,
                  reps: int, issue_rate: float) -> float:
    """The least time the card takes for ``reps`` reps of ``mix`` on
    ``elements`` elements: the instructions issued
    (:data:`ALU_PROBE_REAL_OPS` an element, bfloat16 two elements an
    instruction) over ``issue_rate`` (:func:`alu_issue_rate`)."""
    per = 2 if dtype == torch.bfloat16 else 1
    return ALU_PROBE_REAL_OPS[mix] * elements * reps / per / issue_rate


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


@checked
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

    On the card the launch takes the route :func:`probe_route` names,
    counted in ``alu_probe.launches_by_route`` (``csrc/alu_probe.cu``):
    "cluster", one thread-block cluster a block holding it in its CTAs'
    registers and shared memory, a cluster barrier between the reps of
    the mixes that read other CTAs' rows (none for ``fma`` and the dim-1
    mixes, whose rows stay in a warp); or "l2" for blocks no cluster
    holds, two ping-pong buffers
    that must fit in the L2 cache together (:func:`check_probe_capacity`
    raises otherwise), advanced by one cooperative launch of at most the
    co-resident number of CTAs, a grid barrier between reps.
    ``alu_probe.last_ctas`` holds the CTAs of the last launch. float32
    and bfloat16."""
    _check_probe(z, reps, mix)
    if z.device.type == "cpu":
        return alu_probe_ref(z, reps, mix, se)
    if z.device.type != "cuda":
        raise ValueError(f"alu_probe: unsupported device {z.device}")
    _check_cuda_operand(z, "alu_probe")
    H, W = z.shape[-2:]
    n_blocks = z.shape[0] if z.dim() == 3 else 1
    route = probe_route(z, mix)
    if route == "cluster":
        out = torch.empty_like(z)
        bufs, part = (out, out), None
    else:
        with torch.cuda.device(z.device):
            check_probe_capacity(z.numel() * z.element_size(),
                                 alu_probe_l2_bytes())
        buf = torch.empty((2,) + tuple(z.shape), dtype=z.dtype,
                          device=z.device)
        bufs, out = (buf[0], buf[1]), buf[(reps - 1) & 1]
        tiles = _entry("alu_probe", "tpumt_alu_probe_tiles")(H, W)
        part = torch.empty(2 * n_blocks * tiles * 2, dtype=torch.float32,
                           device=z.device)
    k = _probe_consts(mix, se, z.dtype)
    k += [0.0] * (8 - len(k))
    ctas = _c_int(0)
    fn = _entry("alu_probe", "tpumt_alu_probe")
    with torch.cuda.device(z.device):
        rc = fn(z.data_ptr(), bufs[0].data_ptr(), bufs[1].data_ptr(),
                None if part is None else part.data_ptr(),
                DTYPE_CODES[z.dtype], ALU_PROBE_MIXES.index(mix), n_blocks,
                H, W, int(reps), *k, float(np.float32(se)),
                PROBE_ROUTES.index(route), ctypes.byref(ctas),
                torch.cuda.current_stream(z.device).cuda_stream)
    if rc != 0:
        _raise_launch(f"alu_probe ({route} route)", rc)
    alu_probe.launches += 1
    alu_probe.launches_by_route[route] += 1
    alu_probe.last_ctas = ctas.value
    return out


alu_probe.launches = 0
alu_probe.launches_by_route = dict.fromkeys(PROBE_ROUTES, 0)
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


#: the routes of the halo staging copies (csrc/pack.cu; a route's code is
#: its index), named after the word a thread moves: "vec16" (16 bytes),
#: "vec8" (8 bytes), "scalar" (one element)
PACK_ROUTES = ("scalar", "vec8", "vec16")


def pack_route(z: torch.Tensor, axis: int, n_bnd: int, *ptrs: int) -> str:
    """The route (one of :data:`PACK_ROUTES`) of a :func:`pack_edges` or
    :func:`unpack_ghosts` launch on the contiguous 2-D ``z`` along
    ``axis``, by the rule the C launcher checks: the widest word, 16 then
    8 bytes, that is wider than an element, on which ``z``'s data and
    every pointer in ``ptrs`` (the two band buffers) start, of which the
    row pitch is whole words and, along axis 1, so is a row's ``n_bnd``
    band (then so is each band's first column: b and n1−2b for pack, 0
    and n1−b for unpack); else "scalar". Integer arithmetic on the shape
    and the pointers only. Refuses what the launch refuses."""
    _check_pack("pack_route", z, axis, n_bnd)
    if not z.is_contiguous():
        raise ValueError("pack_route: the CUDA kernels need a contiguous "
                         "tensor")
    if z.element_size() not in (2, 4, 8):
        raise TypeError(f"pack_route: {z.dtype} elements of "
                        f"{z.element_size()} bytes are unsupported")
    return _pack_route(z, axis, n_bnd, ptrs)


def _pack_route(z: torch.Tensor, axis: int, n_bnd: int, ptrs) -> str:
    """:func:`pack_route` on an operand the wrapper has checked."""
    item = z.element_size()
    ptrs = (z.data_ptr(), *ptrs)
    for word, route in ((16, "vec16"), (8, "vec8")):
        if word <= item or z.shape[1] * item % word \
                or (axis == 1 and n_bnd * item % word):
            continue
        if all(p % word == 0 for p in ptrs):
            return route
    return "scalar"


def pack_edges_ref(z: torch.Tensor, axis: int = 0, n_bnd: int = N_BND):
    """Plain-torch version of :func:`pack_edges`:
    ``kernels.pack.pack_edges``."""
    _check_pack("pack_edges", z, axis, n_bnd)
    return _pack.pack_edges(z, axis, n_bnd)


@checked
def pack_edges(z: torch.Tensor, axis: int = 0, n_bnd: int = N_BND):
    """``(lo, hi)``: the interior edge bands ``z[b:2b]`` and
    ``z[n−2b:n−b]`` along ``axis`` of a contiguous 2-D array, as two new
    contiguous buffers (≅ ``pack_edges_pallas``, the reference's
    ``buf_from_view``). A non-contiguous view raises on the card. The
    launch takes the route :func:`pack_route` names for ``z`` and the two
    buffers, counted in ``pack_edges.launches_by_route``."""
    shape = _check_pack("pack_edges", z, axis, n_bnd)
    if z.device.type == "cpu":
        return pack_edges_ref(z, axis, n_bnd)
    if z.device.type != "cuda":
        raise ValueError(f"pack_edges: unsupported device {z.device}")
    _check_cuda_operand(z, "pack_edges")
    lo = torch.empty(shape, dtype=z.dtype, device=z.device)
    hi = torch.empty_like(lo)
    route = _pack_route(z, axis, n_bnd, (lo.data_ptr(), hi.data_ptr()))
    fn = _entry("pack", "tpumt_pack_edges")
    with torch.cuda.device(z.device):
        rc = fn(z.data_ptr(), lo.data_ptr(), hi.data_ptr(),
                z.element_size(), axis, z.shape[0], z.shape[1], n_bnd,
                PACK_ROUTES.index(route),
                torch.cuda.current_stream(z.device).cuda_stream)
    if rc != 0:
        _raise_launch(f"pack_edges ({route} route)", rc)
    pack_edges.launches += 1
    pack_edges.launches_by_route[route] += 1
    return lo, hi


pack_edges.launches = 0
pack_edges.launches_by_route = dict.fromkeys(PACK_ROUTES, 0)


def unpack_ghosts_ref(z: torch.Tensor, lo_ghost: torch.Tensor,
                      hi_ghost: torch.Tensor, axis: int = 0,
                      n_bnd: int = N_BND) -> torch.Tensor:
    """Plain-torch version of :func:`unpack_ghosts`:
    ``kernels.pack.unpack_ghosts`` (in place; returns ``z``)."""
    _check_pack("unpack_ghosts", z, axis, n_bnd)
    return _pack.unpack_ghosts(z, lo_ghost, hi_ghost, axis, n_bnd)


@checked
def unpack_ghosts(z: torch.Tensor, lo_ghost: torch.Tensor,
                  hi_ghost: torch.Tensor, axis: int = 0,
                  n_bnd: int = N_BND) -> torch.Tensor:
    """Write ``lo_ghost`` into ``z[0:b]`` and ``hi_ghost`` into
    ``z[n−b:n]`` along ``axis``, IN PLACE, and return ``z`` (≅
    ``unpack_ghosts_pallas``, the reference's ``buf_to_view``; the Pallas
    kernel returns an updated copy because it is functional). The two
    buffers are contiguous, band-shaped and share no storage with
    ``z``. The launch takes the route :func:`pack_route` names for ``z``
    and the two buffers, counted in
    ``unpack_ghosts.launches_by_route``."""
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
    route = _pack_route(z, axis, n_bnd,
                        (lo_ghost.data_ptr(), hi_ghost.data_ptr()))
    fn = _entry("pack", "tpumt_unpack_ghosts")
    with torch.cuda.device(z.device):
        rc = fn(z.data_ptr(), lo_ghost.data_ptr(), hi_ghost.data_ptr(),
                z.element_size(), axis, z.shape[0], z.shape[1], n_bnd,
                PACK_ROUTES.index(route),
                torch.cuda.current_stream(z.device).cuda_stream)
    if rc != 0:
        _raise_launch(f"unpack_ghosts ({route} route)", rc)
    unpack_ghosts.launches += 1
    unpack_ghosts.launches_by_route[route] += 1
    return z


unpack_ghosts.launches = 0
unpack_ghosts.launches_by_route = dict.fromkeys(PACK_ROUTES, 0)


# ---------------------------------------------------------------------------
# the RDMA ring: halo exchange by peer stores, and the fused exchange+update
# ---------------------------------------------------------------------------


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


#: the routes of the peer-store kernels (csrc/ring_common.cuh; a route's
#: code is its index): "vec16" — every pointer on 16 bytes and what each
#: thread walks (a ring collective's region or chunk, the one-shot shard,
#: a ring-halo row or band) whole 16-byte vectors, each thread moving
#: uint4s, several in flight; "scalar" — any other operand, one element at
#: a time
COLL_ROUTES = ("scalar", "vec16")
#: the bytes a thread moves at a time on the vec16 route
COLL_VEC_BYTES = 16


def coll_route(x: torch.Tensor, n: int, *ptrs: int) -> str:
    """The route (one of :data:`COLL_ROUTES`) of a collective kernel's
    launch over ``x`` whose regions (the ring all-gather), chunks (the
    ring reduce-scatter) or shard (the one-shot kernel) are ``n``
    elements, by the rule the C launchers check: "vec16" when ``x``'s
    data and every pointer in ``ptrs`` (the launch's other buffers) start
    on 16 bytes and ``n`` elements are a whole number of 16-byte vectors,
    else "scalar"."""
    aligned = all(p % COLL_VEC_BYTES == 0 for p in (x.data_ptr(), *ptrs))
    whole = n * x.element_size() % COLL_VEC_BYTES == 0
    return "vec16" if aligned and whole else "scalar"


def coll_route_code(route: str) -> int:
    """The code the C launchers take for ``route`` (its index in
    :data:`COLL_ROUTES`); ``ValueError`` for any other name."""
    if route not in COLL_ROUTES:
        raise ValueError(f"unknown collective route {route!r}; one of "
                         f"{', '.join(COLL_ROUTES)}")
    return COLL_ROUTES.index(route)


def _ring_operand(z: torch.Tensor, axis: int, n_bnd: int, name: str):
    """The 2-D view of a ring operand (a 1-D shard is an (n, 1) column,
    ``pallas_kernels.py:1827-1838``) and its axis, checked."""
    if z.dim() == 1:
        if axis != 0:
            raise ValueError(f"{name}: a 1-D shard exchanges along axis 0")
        z = z.view(-1, 1)
    if z.dim() != 2:
        raise ValueError(f"{name}: 1-D or 2-D input required, got shape "
                         f"{tuple(z.shape)}")
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    _pack.check_bands(z.shape[axis], n_bnd, name)
    return z


def ring_halo_ref(z: torch.Tensor, axis: int = 0,
                  n_bnd: int = N_BND, periodic: bool = False
                  ) -> torch.Tensor:
    """Plain version of :func:`ring_halo` (IN PLACE; returns ``z``): the
    edges packed into contiguous copies first (so an extent under
    3·``n_bnd``, where an edge overlaps the other ghost band, reads both
    edges before either ghost is written), then a local self-ring copy at
    world=1 or one ``Ring.sendrecv`` over the process group, each arrived
    band written into its ghost band; a side that receives nothing keeps
    its physical ghosts."""
    zz = _ring_operand(z, axis, n_bnd, "ring_halo")
    ring = make_mesh()
    n = zz.shape[axis]
    lo_edge, hi_edge = _pack.pack_edges(zz, axis, n_bnd)
    if ring.size == 1:
        if not periodic:
            return z
        from_left, from_right = hi_edge, lo_edge
    else:
        from_left, from_right = ring.sendrecv(lo_edge, hi_edge, periodic)
    if from_left is not None:
        zz.narrow(axis, 0, n_bnd).copy_(from_left)
    if from_right is not None:
        zz.narrow(axis, n - n_bnd, n_bnd).copy_(from_right)
    return z


@checked
def ring_halo(z: torch.Tensor, axis: int = 0,
              n_bnd: int = N_BND, periodic: bool = False) -> torch.Tensor:
    """Fill ``z``'s two ghost bands along ``axis`` from the ring
    neighbours, IN PLACE (≅ ``ring_halo_pallas``): my hi interior edge
    goes to the right neighbour's lo ghost and my lo edge to the left's hi
    ghost, each rank storing its edges straight into its neighbours'
    memory behind an entry barrier; the ends of a non-periodic ring keep
    their physical ghosts. At world=1 periodic it is the self-ring; at
    world=1 non-periodic it launches and moves nothing, as the JAX package
    does. Any dtype, either axis; a 1-D shard runs as an (n, 1) column.

    The neighbours are those of the process's ring on ``z``'s device
    (``comm.peer.peer_ring``). At world > 1 on the card ``z`` must live in
    peer memory (``PeerRing.empty``). One launch per call; all ranks
    must make the same sequence of ring calls. The launch takes the route
    :func:`halo_route` names for ``z``, its neighbours' copies and the
    band, counted in ``ring_halo.launches_by_route``."""
    zz = _ring_operand(z, axis, n_bnd, "ring_halo")
    if z.device.type == "cpu":
        return ring_halo_ref(z, axis, n_bnd, periodic)
    if z.device.type != "cuda":
        raise ValueError(f"ring_halo: unsupported device {z.device}")
    if not zz.is_contiguous():
        raise ValueError("ring_halo: the CUDA kernel needs a contiguous "
                         "tensor")
    if zz.element_size() not in (2, 4, 8):
        raise TypeError(f"ring_halo: {z.dtype} elements of "
                        f"{zz.element_size()} bytes are unsupported")
    peer = peer_ring(z.device)
    left_z, right_z = peer.peer_ptrs(zz)
    pad, left_pad, right_pad = peer.pad_ptrs()
    send_lo, send_hi = peer.ring.sends(periodic)
    n0, n1 = zz.shape
    stage = None
    if zz.shape[axis] < 3 * n_bnd and (send_lo or send_hi):
        stage = torch.empty(2 * n_bnd * (zz.numel() // zz.shape[axis]),
                            dtype=z.dtype, device=z.device)
    route = halo_route(zz, axis, n_bnd, left_z, right_z)
    fn = _entry("ring_halo", "tpumt_ring_halo")
    with torch.cuda.device(z.device):
        rc = fn(zz.data_ptr(), left_z, right_z, pad, left_pad, right_pad,
                zz.element_size(), axis, n0, n1, n_bnd,
                int(send_lo), int(send_hi),
                None if stage is None else stage.data_ptr(),
                coll_route_code(route), 0, _stream(z))
    if rc != 0:
        _raise_launch(f"ring_halo ({route} route)", rc)
    ring_halo.launches += 1
    ring_halo.launches_by_route[route] += 1
    return z


ring_halo.launches = 0
ring_halo.launches_by_route = dict.fromkeys(COLL_ROUTES, 0)


def halo_route(z: torch.Tensor, axis: int, n_bnd: int, *ptrs: int) -> str:
    """The route (one of :data:`COLL_ROUTES`) of a :func:`ring_halo`
    launch on ``z`` (1-D: an (n, 1) column) along ``axis``, by the rule
    the C launcher checks: "vec16" when ``z``'s data and every pointer in
    ``ptrs`` (the neighbours' copies) start on 16 bytes, the row pitch is
    a whole number of 16-byte vectors and, along axis 1, so is a row's
    ``n_bnd``-wide band; else "scalar" — and always for an extent under
    3·``n_bnd``, which is staged through one CTA."""
    zz = _ring_operand(z, axis, n_bnd, "ring_halo")
    item = zz.element_size()
    if zz.shape[axis] < 3 * n_bnd or zz.shape[1] * item % COLL_VEC_BYTES:
        return "scalar"
    whole = zz.shape[1] if axis == 0 else n_bnd
    return coll_route(zz, whole, *ptrs)


def ring_halo_world_ref(shards, axis: int = 0, n_bnd: int = N_BND,
                        periodic: bool = True) -> list:
    """Every rank's result of :func:`ring_halo` over the ranks' ghosted
    ``shards`` (one per rank, on any device), computed in one process:
    rank r's lo ghost band takes rank r−1's hi edge and its hi ghost band
    rank r+1's lo edge, each where the send predicates (``Ring.sends``)
    let the band move; the other ghosts keep their values. Holds the
    card's cross-wired instances (:func:`cross_wired`) against the plain
    version's values."""
    w = len(shards)
    views = [_ring_operand(t, axis, n_bnd, "ring_halo") for t in shards]
    edges = [_pack.pack_edges(v, axis, n_bnd) for v in views]
    outs = []
    for r, t in enumerate(shards):
        out = t.clone()
        zz = _ring_operand(out, axis, n_bnd, "ring_halo")
        n = zz.shape[axis]
        from_left, from_right = Ring(r, w).sends(periodic)
        if from_left:
            zz.narrow(axis, 0, n_bnd).copy_(edges[(r - 1) % w][1])
        if from_right:
            zz.narrow(axis, n - n_bnd, n_bnd).copy_(edges[(r + 1) % w][0])
        outs.append(out)
    return outs


#: rows per block of the fused ring kernel's smem route when ``tile_rows``
#: is None (the largest divisor of the height up to this that holds the
#: seam): a prior of the schedule plane (``tune/priors.py``)
FUSED_BLOCK_ROWS = _priors.FUSED_BLOCK_ROWS
#: the tallest row block the smem route's shared memory takes (kMaxB)
FUSED_MAX_BLOCK_ROWS = 256  # tpumt: ignore[TPM701]


def fused_block_rows(height: int, steps: int,
                     tile_rows: "int | None" = None,
                     route: str = "regs") -> int:
    """Rows per block of the fused ring kernel for a ghosted ``height``
    on ``route`` (:func:`kstep_route`): blocks must tile the height
    exactly and hold the whole 2K-row seam (B ≥ 2K, K = ``steps``·N_BND:
    only the first and the last block then touch a ghost band).
    ``tile_rows`` caps B as in the JAX kernel (the largest divisor of the
    height up to it). Without it, 0 on the regs route: the launcher takes
    the shortest divisor no shorter than the seam, 128 rows and the rows
    that fill the card once (``csrc/fused_rdma.cu``; the wrapper reports
    it as ``stencil2d_fused_rdma.block_rows``); on the smem route the
    largest divisor up to :data:`FUSED_BLOCK_ROWS` that holds the seam,
    else the smallest that does. The smem route takes none over
    :data:`FUSED_MAX_BLOCK_ROWS` (its shared memory). Raises
    ``ValueError`` (naming the seam) when none fits."""
    if route not in KSTEP_ROUTES:
        raise ValueError(f"unknown k-step route {route!r}; one of "
                         f"{', '.join(KSTEP_ROUTES)}")
    K = steps * N_BND
    if height <= 2 * K:
        raise ValueError(f"height {height} too small for {steps}-step ghost "
                         f"width {2 * K}")
    if tile_rows is None and route == "regs":
        return 0
    cap = height if route == "regs" else min(height, FUSED_MAX_BLOCK_ROWS)
    if tile_rows is not None:
        B = next((d for d in range(min(tile_rows, cap), 0, -1)
                  if height % d == 0), 1)
    else:
        fits = [d for d in range(2 * K, cap + 1) if height % d == 0]
        small = [d for d in fits if d <= FUSED_BLOCK_ROWS]
        B = max(small) if small else (min(fits) if fits else 1)
    if B < 2 * K:
        raise ValueError(
            f"stencil2d_fused_rdma: no row blocking of height {height} holds "
            f"the {2 * K}-row seam (largest fitting divisor {B}); pad the "
            f"domain or use another tier")
    return B


def stencil2d_fused_rdma_ref(z: torch.Tensor, scale_eps: float,
                             steps: int = 1, periodic: bool = False,
                             phys_static=None, phys=None,
                             tile_rows: "int | None" = None,
                             local_only: bool = False) -> torch.Tensor:
    """Plain version of :func:`stencil2d_fused_rdma` (returns a new
    tensor): :func:`ring_halo_ref` along dim 0 over K-deep ghosts (which,
    like the kernel's peer stores, writes ``z``'s own ghost bands; skipped
    when ``local_only``), then :func:`stencil2d_iterate_ref` along dim 0."""
    if z.dim() != 2:
        raise ValueError("stencil2d_fused_rdma: 2-D shards only")
    fused_block_rows(z.shape[0], steps, tile_rows)
    if not local_only:
        ring_halo_ref(z, 0, steps * N_BND, periodic)
    return stencil2d_iterate_ref(z, scale_eps, dim=0, steps=steps,
                                 phys_static=phys_static, phys=phys)


@checked
def stencil2d_fused_rdma(z: torch.Tensor, scale_eps: float,
                         steps: int = 1, periodic: bool = False,
                         phys_static=None, phys=None,
                         tile_rows: "int | None" = None,
                         local_only: bool = False,
                         out: "torch.Tensor | None" = None) -> torch.Tensor:
    """One launch of exchange + ``steps`` timesteps along dim 0 (≅
    ``stencil2d_fused_rdma_pallas``): the K-row edge bands (K =
    ``steps``·N_BND) are stored into the ring neighbours' ghost bands of
    THEIR copy of ``z`` while the interior row blocks are computed, then
    the two seam blocks are computed once the neighbours' edges have
    landed in ``z``'s ghosts. Written to ``out`` (a new tensor when None),
    never in place; equal bit for bit to :func:`ring_halo` followed by
    :func:`stencil2d_iterate` (dim 0) with the same flags. ``local_only``
    (which world=1 non-periodic reduces to) exchanges nothing: the pure
    compute pass. The ring and the peer-memory rule are
    :func:`ring_halo`'s; the sends take its walk, on the route
    :func:`halo_route` would name. Row blocks: :func:`fused_block_rows`
    on the route :func:`kstep_route` names for ``z``, ``out`` and
    ``steps`` (the launch counted in
    ``stencil2d_fused_rdma.launches_by_route``, its rows per block left in
    ``stencil2d_fused_rdma.block_rows``)."""
    if z.dim() != 2:
        raise ValueError("stencil2d_fused_rdma: 2-D shards only")
    if out is not None:
        _check_out(out, z, z.shape, "stencil2d_fused_rdma")
    fused_block_rows(z.shape[0], steps, tile_rows,
                     kstep_route(z, 0, steps, out, fused=True))
    if z.device.type == "cpu":
        ref = stencil2d_fused_rdma_ref(z, scale_eps, steps, periodic,
                                       phys_static, phys, tile_rows,
                                       local_only)
        return ref if out is None else out.copy_(ref)
    if z.device.type != "cuda":
        raise ValueError(f"stencil2d_fused_rdma: unsupported device "
                         f"{z.device}")
    _check_cuda_operand(z, "stencil2d_fused_rdma")
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
    peer = peer_ring(z.device)
    send_lo, send_hi = (False, False) if local_only else \
        peer.ring.sends(periodic)
    left_z = right_z = z.data_ptr()
    if send_lo or send_hi:
        left_z, right_z = peer.peer_ptrs(z)
    pad, left_pad, right_pad = peer.pad_ptrs()
    K = steps * N_BND
    stage = None
    if z.shape[0] < 3 * K and (send_lo or send_hi):
        stage = torch.empty(2 * K * z.shape[1], dtype=z.dtype,
                            device=z.device)
    if out is None:
        out = torch.empty_like(z)
    route = kstep_route(z, 0, steps, out, fused=True)
    B = fused_block_rows(z.shape[0], steps, tile_rows, route)
    fn = _entry("fused_rdma", "tpumt_stencil2d_fused_rdma")
    with torch.cuda.device(z.device):
        rc = fn(z.data_ptr(), out.data_ptr(), left_z, right_z, pad,
                left_pad, right_pad, DTYPE_CODES[z.dtype],
                z.shape[0], z.shape[1], steps, B,
                _rounded(scale_eps, z.dtype), _rounded(_C1, z.dtype),
                _rounded(_C2, z.dtype), plo, phi,
                None if ph is None else ph.data_ptr(), int(send_lo),
                int(send_hi), KSTEP_ROUTES.index(route),
                None if stage is None else stage.data_ptr(), _FUSED_B_REF,
                torch.cuda.current_stream(z.device).cuda_stream)
    if rc != 0:
        _raise_launch(f"stencil2d_fused_rdma ({route} route)", rc)
    stencil2d_fused_rdma.launches += 1
    stencil2d_fused_rdma.launches_by_route[route] += 1
    stencil2d_fused_rdma.block_rows = _FUSED_B.value
    return out


# the rows per block a fused launch reports
_FUSED_B = ctypes.c_int(0)
_FUSED_B_REF = ctypes.byref(_FUSED_B)
stencil2d_fused_rdma.launches = 0
stencil2d_fused_rdma.launches_by_route = dict.fromkeys(KSTEP_ROUTES, 0)
stencil2d_fused_rdma.block_rows = 0


# ---------------------------------------------------------------------------
# the collectives: ring all-gather, ring reduce-scatter / allreduce, one-shot
# ---------------------------------------------------------------------------


def _coll_shard(x: torch.Tensor, name: str) -> None:
    if x.dim() not in (1, 2) or x.numel() == 0:
        raise ValueError(f"{name}: a non-empty 1-D or 2-D shard required, "
                         f"got shape {tuple(x.shape)}")


def _coll_ring(name: str, self_ring: "int | None" = None):
    """``(k, my, ring)``: the ring's size and this rank's place in it —
    the world's ring, or at world=1 the ``self_ring=k`` validation mode
    (both neighbours the rank itself, ``my`` 0). Checked against the
    pad's limit (:class:`~tpu_mpi_tests_torch.comm.peer.PeerError`)."""
    ring = make_mesh()
    if self_ring is None:
        k, my = ring.size, ring.rank
    else:
        if ring.size != 1 or self_ring < 2:
            raise ValueError(
                f"{name}: self_ring={self_ring} is a single-device "
                f"validation mode (needs world 1 and self_ring >= 2, got "
                f"w={ring.size})")
        k, my = int(self_ring), 0
    check_collective_world(k, name)
    return k, my, ring


def _coll_cuda(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    _check_cuda_operand(x, name)


def ring_allgather_ref(x: torch.Tensor, self_ring: "int | None" = None
                       ) -> torch.Tensor:
    """Plain version of :func:`ring_allgather`: the ranks' shards stacked
    along dim 0 in rank order (``collectives.all_gather`` over the
    process group); at world=1 a copy, or ``self_ring=k`` copies of the
    shard."""
    _coll_shard(x, "ring_allgather")
    k, _, _ = _coll_ring("ring_allgather", self_ring)
    if self_ring is not None:
        return torch.cat([x] * k)
    return all_gather(x)


@checked
def ring_allgather(x: torch.Tensor, self_ring: "int | None" = None
                   ) -> torch.Tensor:
    """All-gather along dim 0 over the ring in w−1 hops (≅
    ``ring_allgather_pallas``): ``x`` is this rank's (n,) or (n, m) shard;
    returns the (w·n, …) array of every rank's shard in rank order. Step
    s stores region (rank − s) mod w into the right neighbour's buffer,
    each forward waiting for exactly the previous step's arrival. Any
    dtype of 2, 4 or 8 bytes and any n: the TPU's tile floor is Mosaic's
    and is not kept.

    ``self_ring=k`` (world=1 only, 2 ≤ k ≤ 8): every region seeded with
    ``x``, then the full k-step schedule into the rank's own buffer; the
    result is ``tile(x, k)``. One launch per call; every rank must make
    the same sequence of RDMA calls.

    The launch takes the route :func:`coll_route` names for its buffers
    and the shard's bytes ("vec16" for every main-path operand), counted
    in ``ring_allgather.launches_by_route``."""
    _coll_shard(x, "ring_allgather")
    k, my, _ = _coll_ring("ring_allgather", self_ring)
    if x.device.type == "cpu":
        return ring_allgather_ref(x, self_ring)
    if x.device.type != "cuda":
        raise ValueError(f"ring_allgather: unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("ring_allgather: the CUDA kernel needs a "
                         "contiguous tensor")
    if x.element_size() not in (2, 4, 8):
        raise TypeError(f"ring_allgather: {x.dtype} elements of "
                        f"{x.element_size()} bytes are unsupported")
    peer = peer_ring(x.device)
    out = torch.empty((k * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    buf = right = out.data_ptr()
    if peer.symmetric:  # the peers store into my receive buffer
        ws = peer.workspace("ring_allgather", out.numel() * x.element_size())
        buf, right = ws.data_ptr(), peer.peer_ptrs(ws)[1]
    pad, left_pad, right_pad = peer.pad_ptrs()
    route = coll_route(x, x.numel(), out.data_ptr(), buf, right)
    fn = _entry("ring_collectives", "tpumt_ring_allgather")
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), out.data_ptr(), buf, right, pad, left_pad,
                right_pad, x.element_size(), k, my,
                x.numel(), int(self_ring is not None),
                coll_route_code(route), 0, _stream(x))
    if rc != 0:
        _raise_launch(f"ring_allgather ({route} route)", rc)
    ring_allgather.launches += 1
    ring_allgather.launches_by_route[route] += 1
    return out


ring_allgather.launches = 0
ring_allgather.launches_by_route = dict.fromkeys(COLL_ROUTES, 0)


def ring_chunk_rows(x: torch.Tensor, k: int, name: str) -> int:
    """The rows (elements of a 1-D shard) of one of the k chunks, or
    ``ValueError`` with the rule."""
    n = x.shape[0]
    if n % k:
        what = "elements" if x.dim() == 1 else "rows"
        raise ValueError(
            f"{name}: a shard of {n} {what} does not split into {k} equal "
            f"chunks (the ring reduce-scatter needs {what} % w == 0)")
    return n // k


def ring_fold(chunk, k: int, my: int, shift) -> torch.Tensor:
    """The ring reduce-scatter's folds at rank ``my`` of a k-ring, step for
    step: ``chunk(c)`` is the rank's chunk c, ``shift(t)`` moves a partial
    one hop right and returns what arrives from the left. Step s sends
    the partial of chunk (my − s − 1) mod k and folds what arrives as
    ``received + local chunk``; the last fold is chunk ``my`` of the sum."""
    send = chunk((my - 1) % k)
    for s in range(k - 1):
        send = shift(send) + chunk((my - s - 2) % k)
    return send


def ring_reduce_scatter_ref(x: torch.Tensor, credits: int = 1,
                            self_ring: "int | None" = None) -> torch.Tensor:
    """Plain version of :func:`ring_reduce_scatter`: :func:`ring_fold`
    with ``Ring.shift`` over the process group (the self-ring: the shift
    is the identity); at world=1 a copy. ``credits`` changes when a
    payload may move, never the result."""
    _coll_shard(x, "ring_reduce_scatter")
    _check_credits(credits)
    k, my, ring = _coll_ring("ring_reduce_scatter", self_ring)
    rows = ring_chunk_rows(x, k, "ring_reduce_scatter")
    if k == 1:
        return x.clone()
    shift = (lambda t: t) if self_ring is not None else ring.shift
    return ring_fold(lambda c: x[c * rows:(c + 1) * rows], k, my,
                     shift).contiguous()


def _check_credits(credits: int) -> None:
    if credits not in (1, 2):
        raise ValueError(f"credits={credits} must be 1 or 2")


@checked
def ring_reduce_scatter(x: torch.Tensor, credits: int = 1,
                        self_ring: "int | None" = None) -> torch.Tensor:
    """Reduce-scatter along dim 0 over the ring (≅
    ``ring_reduce_scatter_pallas``): this rank's (n,) or (n, m) shard in;
    rank r returns chunk r (n/w rows, or elements of a 1-D shard) of the
    elementwise sum. w−1 hops; step s stores the running partial of chunk
    (r − s − 1) mod w into the right neighbour's comm slot s % credits,
    and the receiver folds ``received + local chunk`` in the dtype (bf16
    rounded per op): equal bit for bit to :func:`ring_reduce_scatter_ref`.
    ``credits=2`` lets two payloads be in flight. The one alignment rule is
    the algorithm's: n % w == 0 (``ValueError`` otherwise); world=1 is one
    copy. ``self_ring=k`` (world=1 only, 2 ≤ k ≤ 8) runs the k-step
    schedule on the rank itself and returns the fold of its own k chunks
    in the ring's order. float32, float64, bfloat16. One launch per
    call, on the route :func:`coll_route` names for its buffers and the
    chunk's bytes ("vec16" for every main-path operand), counted in
    ``ring_reduce_scatter.launches_by_route``; at ``credits=2`` the fold
    goes straight into the right neighbour's slot, at ``credits=1``
    through a local send buffer."""
    _coll_shard(x, "ring_reduce_scatter")
    _check_credits(credits)
    k, my, _ = _coll_ring("ring_reduce_scatter", self_ring)
    rows = ring_chunk_rows(x, k, "ring_reduce_scatter")
    if x.device.type == "cpu":
        return ring_reduce_scatter_ref(x, credits, self_ring)
    _coll_cuda(x, "ring_reduce_scatter")
    peer = peer_ring(x.device)
    out = torch.empty((rows,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    cn = out.numel()
    # one rank: one copy, no slots; credits=2 folds into the right's slot
    # and reads no send buffer
    comm = right = send = out.data_ptr()
    scratch = None
    if k > 1:
        ws = peer.workspace("ring_reduce_scatter",
                            credits * cn * x.element_size())
        comm = right = ws.data_ptr()
        if peer.symmetric:
            right = peer.peer_ptrs(ws)[1]
        if credits == 1:
            scratch = torch.empty(cn, dtype=x.dtype, device=x.device)
            send = scratch.data_ptr()
    pad, left_pad, right_pad = peer.pad_ptrs()
    route = coll_route(x, cn, out.data_ptr(), comm, right, send)
    fn = _entry("ring_collectives", "tpumt_ring_reduce_scatter")
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), out.data_ptr(), comm, right, send, pad,
                left_pad, right_pad, DTYPE_CODES[x.dtype], k, my, cn,
                credits,
                coll_route_code(route), 0, _stream(x))
    if rc != 0:
        _raise_launch(f"ring_reduce_scatter ({route} route)", rc)
    ring_reduce_scatter.launches += 1
    ring_reduce_scatter.launches_by_route[route] += 1
    return out


ring_reduce_scatter.launches = 0
ring_reduce_scatter.launches_by_route = dict.fromkeys(COLL_ROUTES, 0)


@checked
def ring_allreduce(x: torch.Tensor, credits: int = 1) -> torch.Tensor:
    """Ring allreduce (≅ ``ring_allreduce_pallas``): every rank returns
    the elementwise sum of the ranks' shards — :func:`ring_reduce_scatter`
    then :func:`ring_allgather`, two launches with no barrier between
    them (the all-gather's entry barrier orders the phases, :2732-2734);
    one reduce-scatter launch (a copy) at world=1. On the CPU the two
    wrappers take their plain versions."""
    rs = ring_reduce_scatter(x, credits)
    return rs if make_mesh().size == 1 else ring_allgather(rs)


def oneshot_ref(x: torch.Tensor, op: str = "gather") -> torch.Tensor:
    """Plain version of :func:`oneshot`: the ranks' shards gathered
    (``collectives.all_gather``); for ``op="sum"`` folded in ascending source
    rank, ``acc = shard_0; acc = acc + shard_s`` — bitwise
    ``functools.reduce(add, shards)``."""
    _coll_shard(x, "oneshot")
    _check_op(op)
    k, _, _ = _coll_ring("oneshot")
    g = all_gather(x)
    if op == "gather":
        return g
    n = x.shape[0]
    acc = g[:n]
    for s in range(1, k):
        acc = acc + g[s * n:(s + 1) * n]
    return acc.contiguous()


def _check_op(op: str) -> None:
    if op not in ("gather", "sum"):
        raise ValueError(f"op must be 'gather' or 'sum', got {op!r}")


@checked
def oneshot(x: torch.Tensor, op: str = "gather") -> torch.Tensor:
    """One-shot all-gather (``op="gather"``) or allreduce (``"sum"``) along
    dim 0 (≅ ``_oneshot_call``): one launch in which every rank stores its
    whole shard into its slot of every peer's comm buffer behind an
    all-to-all entry barrier, waits for the w−1 arrivals, then copies the
    slots to the (w·n, …) output or folds them in ascending source rank
    into the (n, …) output — the same bits on every rank. Any n (the JAX
    wrapper's pad to a TPU tile is Mosaic's); float32, float64, bfloat16;
    at most 8 ranks. World=1: one copy. The launch takes the route
    :func:`coll_route` names for ``x``, the output and the comm buffers
    over the shard's elements ("vec16" for every main-path shard),
    counted in ``oneshot.launches_by_route``."""
    _coll_shard(x, "oneshot")
    _check_op(op)
    k, my, _ = _coll_ring("oneshot")
    if x.device.type == "cpu":
        return oneshot_ref(x, op)
    _coll_cuda(x, "oneshot")
    peer = peer_ring(x.device)
    rows = x.shape[0] * (k if op == "gather" else 1)
    out = torch.empty((rows,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    comms = (out.data_ptr(),)  # world=1: no comm buffer is read
    if k > 1:
        ws = peer.workspace("oneshot", k * x.numel() * x.element_size())
        comms = peer.peer_ptrs_all(ws)
    pads = peer.pad_ptrs_all()
    route = coll_route(x, x.numel(), out.data_ptr(), *comms)
    fn = _entry("oneshot", "tpumt_oneshot")
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), out.data_ptr(), (_c_void_p * k)(*comms),
                (_c_void_p * k)(*pads), DTYPE_CODES[x.dtype], k, my,
                x.numel(), int(op == "sum"),
                coll_route_code(route), 0, _stream(x))
    if rc != 0:
        _raise_launch(f"oneshot ({route} route)", rc)
    oneshot.launches += 1
    oneshot.launches_by_route[route] += 1
    return out


oneshot.launches = 0
oneshot.launches_by_route = dict.fromkeys(COLL_ROUTES, 0)


@checked
def oneshot_allgather(x: torch.Tensor) -> torch.Tensor:
    """≅ ``oneshot_allgather_pallas``: :func:`oneshot` with ``op="gather"``."""
    return oneshot(x, "gather")


@checked
def oneshot_allreduce(x: torch.Tensor) -> torch.Tensor:
    """≅ ``oneshot_allreduce_pallas``: :func:`oneshot` with ``op="sum"``."""
    return oneshot(x, "sum")


def coll_world_ref(name: str, shards) -> list:
    """Every rank's result of the collective ``name`` (``ring_allgather``,
    ``ring_reduce_scatter``, ``oneshot_allgather``, ``oneshot_allreduce``)
    over the ranks' ``shards`` (one per rank, on any device), computed in
    one process: the plain versions' copies and folds with the ring's hops
    done by indexing. Holds the card's cross-wired instances
    (:func:`cross_wired`) against the plain versions' values."""
    k = len(shards)
    if name in ("ring_allgather", "oneshot_allgather"):
        g = torch.cat(list(shards))
        return [g.clone() for _ in range(k)]
    if name == "oneshot_allreduce":
        acc = shards[0]
        for s in range(1, k):
            acc = acc + shards[s]
        return [acc.clone() for _ in range(k)]
    if name != "ring_reduce_scatter":
        raise ValueError(f"unknown collective {name!r}")
    rows = ring_chunk_rows(shards[0], k, name)
    # step-synchronous ring: sends[r] moves to rank r + 1 each step
    sends = [shards[r][((r - 1) % k) * rows:((r - 1) % k + 1) * rows]
             for r in range(k)]
    for s in range(k - 1):
        sends = [sends[(r - 1) % k] + shards[r][
            ((r - s - 2) % k) * rows:((r - s - 2) % k + 1) * rows]
            for r in range(k)]
    return [t.contiguous() for t in sends]


def cross_wired(name: str, shards, credits: int = 1,
                max_ctas: int = 4, **kw) -> list:
    """``len(shards)`` instances of a collective kernel, of the ring halo
    or of the fused ring attention, launched from one process on one
    card, each on its own stream with its own buffers and signal pad,
    their peer pointers wired to each other's: the kernels' w > 1 data
    path and cross-rank signalling on a single card. Each instance's grid
    is capped at ``max_ctas`` so that every instance is resident at once.
    For ``"ring_halo"`` each shard is a rank's ghosted array (copied:
    the instances exchange the copies' bands, distinct left and right
    neighbours from w = 3) and ``kw`` holds ``axis``, ``n_bnd`` and
    ``periodic`` (:func:`ring_halo_world_ref` is its plain world); for
    ``"stencil2d_fused_rdma"`` the same, ``kw`` holding ``scale_eps``,
    ``steps`` and ``periodic`` (:func:`stencil2d_fused_rdma_world_ref`;
    its grid is its geometry's, so the shards are kept small enough that
    every instance is resident at once). For
    ``"fused_ring_attention"`` each shard is a rank's ``(q, k, v)`` and
    ``kw`` holds the keywords of :func:`fused_ring_attention` (``scale``,
    ``causal``, ``stripe``, ``precision``). Every launch takes the route
    its operands' rule names. Counts no launch (a check, not a path).
    Returns the instances' outputs (in rank order)."""
    k = len(shards)
    check_collective_world(k, name)
    attention = name == "fused_ring_attention"
    x0 = shards[0][0] if attention else shards[0]
    dev = x0.device
    item = x0.element_size()
    pads = [torch.zeros(PAD_WORDS, dtype=torch.int32, device=dev)
            for _ in range(k)]
    streams = [torch.cuda.Stream(dev) for _ in range(k)]
    torch.cuda.synchronize(dev)
    if name == "ring_allgather":
        outs = [torch.empty((k * x0.shape[0],) + tuple(x0.shape[1:]),
                            dtype=x0.dtype, device=dev) for _ in range(k)]
        bufs = [torch.empty_like(o) for o in outs]
        fn = _entry("ring_collectives", "tpumt_ring_allgather")

        def launch(r):
            ptrs = (outs[r].data_ptr(), bufs[r].data_ptr(),
                    bufs[(r + 1) % k].data_ptr())
            route = coll_route(shards[r], x0.numel(), *ptrs)
            return fn(shards[r].data_ptr(), *ptrs,
                      pads[r].data_ptr(), pads[(r - 1) % k].data_ptr(),
                      pads[(r + 1) % k].data_ptr(), item, k, r,
                      x0.numel(), 0, coll_route_code(route), max_ctas,
                      streams[r].cuda_stream)
    elif name == "ring_reduce_scatter":
        rows = ring_chunk_rows(x0, k, name)
        outs = [torch.empty((rows,) + tuple(x0.shape[1:]), dtype=x0.dtype,
                            device=dev) for _ in range(k)]
        cn = outs[0].numel()
        comms = [torch.empty(credits * cn, dtype=x0.dtype, device=dev)
                 for _ in range(k)]
        sends = [torch.empty(cn, dtype=x0.dtype, device=dev)
                 for _ in range(k)]
        fn = _entry("ring_collectives", "tpumt_ring_reduce_scatter")

        def launch(r):
            ptrs = (outs[r].data_ptr(), comms[r].data_ptr(),
                    comms[(r + 1) % k].data_ptr(), sends[r].data_ptr())
            route = coll_route(shards[r], cn, *ptrs)
            return fn(shards[r].data_ptr(), *ptrs, pads[r].data_ptr(),
                      pads[(r - 1) % k].data_ptr(),
                      pads[(r + 1) % k].data_ptr(),
                      DTYPE_CODES[x0.dtype], k, r, cn, credits,
                      coll_route_code(route), max_ctas,
                      streams[r].cuda_stream)
    elif attention:
        outs, launch = _fused_ring_cross(shards, pads, streams, max_ctas,
                                         **kw)
    elif name == "ring_halo":
        outs, launch = _ring_halo_cross(shards, pads, streams, max_ctas,
                                        **kw)
    elif name == "stencil2d_fused_rdma":
        outs, launch = _fused_rdma_cross(shards, pads, streams, **kw)
    elif name in ("oneshot_allgather", "oneshot_allreduce"):
        gather = name == "oneshot_allgather"
        rows = x0.shape[0] * (k if gather else 1)
        outs = [torch.empty((rows,) + tuple(x0.shape[1:]), dtype=x0.dtype,
                            device=dev) for _ in range(k)]
        comms = [torch.empty(k * x0.numel(), dtype=x0.dtype, device=dev)
                 for _ in range(k)]
        comm_ptrs = (_c_void_p * k)(*[c.data_ptr() for c in comms])
        pad_ptrs = (_c_void_p * k)(*[p.data_ptr() for p in pads])
        fn = _entry("oneshot", "tpumt_oneshot")

        def launch(r):
            route = coll_route(shards[r], x0.numel(), outs[r].data_ptr(),
                               *(c.data_ptr() for c in comms))
            return fn(shards[r].data_ptr(), outs[r].data_ptr(), comm_ptrs,
                      pad_ptrs, DTYPE_CODES[x0.dtype], k, r, x0.numel(),
                      int(not gather), coll_route_code(route), max_ctas,
                      streams[r].cuda_stream)
    else:
        raise ValueError(f"unknown collective {name!r}")
    with torch.cuda.device(dev):
        for r in range(k):
            rc = launch(r)
            if rc != 0:
                _raise_launch(f"cross-wired {name} instance {r}", rc)
    torch.cuda.synchronize(dev)
    return outs


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


def stream_route(*operands: "torch.Tensor | None") -> str:
    """The route (one of :data:`COLL_ROUTES`, whose names fit: the same
    rule over the same 16-byte vectors) of a streaming launch over
    ``operands`` — its inputs and ``out``; a None ``out`` is a fresh
    allocation, which starts on 16 bytes — by the rule the C launchers
    check (``csrc/streams.cu``): "vec16" when every data pointer starts
    on 16 bytes (any n: the ragged tail runs element by element in the
    same launch), else "scalar"."""
    aligned = all(t.data_ptr() % COLL_VEC_BYTES == 0
                  for t in operands if t is not None)
    return "vec16" if aligned else "scalar"


#: the 16-byte packs one CTA takes on the vec16 route, kUnroll × kThreads
#: of ``csrc/streams.cu``: the group whose edges the card's tests cross
STREAM_GROUP_PACKS = 256


def _stream_launch(fn, fn_name: str, out, operands, *args) -> None:
    """Check the CUDA operands (``out`` among them) and launch
    ``fn_name`` as ``fn(*args, out, dtype, n, route, stream)`` (``args``
    ends with the operand pointers) on the route :func:`stream_route`
    names, counted on wrapper ``fn``; an empty operand launches
    nothing."""
    name = fn.__name__
    for t in operands:
        _check_cuda_operand(t, name)
    t0 = operands[0]
    if t0.numel() == 0:
        return
    route = stream_route(*operands)
    entry = _entry("streams", fn_name)
    with torch.cuda.device(t0.device):
        rc = entry(*args, out.data_ptr(), DTYPE_CODES[t0.dtype], t0.numel(),
                   coll_route_code(route),
                   torch.cuda.current_stream(t0.device).cuda_stream)
    if rc != 0:
        _raise_launch(f"{name} ({route} route)", rc)
    fn.launches += 1
    fn.launches_by_route[route] += 1


def daxpy_ref(a: float, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain-torch version of :func:`daxpy`: ``a`` rounded to the dtype,
    then ``a·x`` and ``+ y`` as two ops, each rounded — never
    ``torch.add(y, x, alpha=a)``, which the card contracts into an FMA."""
    _check_stream("daxpy", x, y)
    return coef(a, x) * x + y


@checked
def daxpy(a: float, x: torch.Tensor, y: torch.Tensor,
          out: "torch.Tensor | None" = None) -> torch.Tensor:
    """``out = a·x + y`` elementwise (≅ ``daxpy_pallas``), ``a`` rounded
    to the dtype first; ``out`` is a new tensor when None, and ``out=y``
    is the in-place launch (``inplace=True``). Any length works. The
    launch takes the route :func:`stream_route` names for ``x``, ``y`` and
    ``out``, counted in ``daxpy.launches_by_route``."""
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
    _stream_launch(daxpy, "tpumt_daxpy", out, (x, y, out),
                   _rounded(a, x.dtype), x.data_ptr(), y.data_ptr())
    return out


daxpy.launches = 0
daxpy.launches_by_route = dict.fromkeys(COLL_ROUTES, 0)


def stream_scale_ref(a: float, x: torch.Tensor) -> torch.Tensor:
    """Plain-torch version of :func:`stream_scale`: ``a`` rounded to the
    dtype, times ``x``."""
    return coef(a, x) * x


@checked
def stream_scale(a: float, x: torch.Tensor,
                 out: "torch.Tensor | None" = None) -> torch.Tensor:
    """``out = a·x`` (≅ ``stream_scale_pallas``, the 2-stream probe);
    ``out=x`` is the in-place launch, on the route :func:`stream_route`
    names (``stream_scale.launches_by_route``)."""
    if out is not None:
        _check_stream_out("stream_scale", out, x)
    if x.device.type == "cpu":
        ref = stream_scale_ref(a, x)
        return ref if out is None else out.copy_(ref)
    if x.device.type != "cuda":
        raise ValueError(f"stream_scale: unsupported device {x.device}")
    if out is None:
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
    _stream_launch(stream_scale, "tpumt_stream_scale", out, (x, out),
                   _rounded(a, x.dtype), x.data_ptr())
    return out


stream_scale.launches = 0
stream_scale.launches_by_route = dict.fromkeys(COLL_ROUTES, 0)


def stream_sum3_ref(w: torch.Tensor, x: torch.Tensor, y: torch.Tensor
                    ) -> torch.Tensor:
    """Plain-torch version of :func:`stream_sum3`: ``(w + x) + y``."""
    _check_stream("stream_sum3", w, x, y)
    return (w + x) + y


@checked
def stream_sum3(w: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                out: "torch.Tensor | None" = None) -> torch.Tensor:
    """``out = (w + x) + y`` (≅ ``stream_sum3_pallas``, the 4-stream
    probe: three reads and one write); ``out=y`` is the in-place
    launch, on the route :func:`stream_route` names
    (``stream_sum3.launches_by_route``)."""
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
    _stream_launch(stream_sum3, "tpumt_stream_sum3", out, (w, x, y, out),
                   w.data_ptr(), x.data_ptr(), y.data_ptr())
    return out


stream_sum3.launches = 0
stream_sum3.launches_by_route = dict.fromkeys(COLL_ROUTES, 0)


# ---------------------------------------------------------------------------
# flash attention: the online-softmax fold of one K/V block
# ---------------------------------------------------------------------------

#: query rows per CTA (kQT of csrc/flash_fold.cuh), every route
FLASH_Q_TILE = 64  # tpumt: ignore[TPM701]
#: the fold's routes (csrc/flash_fold.cuh; a route's code is its index):
#: "fma" — HIGHEST where tf32x3 does not take the geometry, f32 on the
#: CUDA cores; "mma" — DEFAULT on mma.sync (TF32 for float32, and bf16
#: where wgmma does not take the geometry); "wgmma" — bf16 DEFAULT at d <=
#: FLASH_WGMMA_MAX_D with every operand in 16-byte chunks: TMA loads, a
#: producer warpgroup, wgmma products; "tf32x3" — float32 HIGHEST at the
#: same geometry: the wgmma route's shape with every product in three
#: TF32 passes (small·big + big·small + big·big, :func:`tf32x3_matmul`)
FLASH_ROUTES = ("fma", "mma", "wgmma", "tf32x3")
#: key rows per shared-memory tile of each route (kKT, kWgKT, kX3KT): the
#: tf32x3 route's two 32-key stages, with Q's and K's two parts, Vᵀ's
#: two, the V landing buffer and half of acc, fill 224 KB of shared memory
FLASH_K_TILES = {  # tpumt: ignore[TPM701] (compiled-in tile geometry)
    "fma": 64, "mma": 64, "wgmma": 128, "tf32x3": 32}
#: the widest head the kernel takes (d is padded to 128 or 256)
FLASH_MAX_D = 256
#: the widest head of the wgmma and tf32x3 routes (d is padded to 128)
FLASH_WGMMA_MAX_D = 128
#: "highest": f32 arithmetic (3xTF32 on the tensor cores, or the CUDA
#: cores); "default": the tensor cores (bf16, or TF32 for float32
#: operands)
FLASH_PRECISIONS = ("highest", "default")
_FLASH_DTYPES = {torch.float32: 0, torch.bfloat16: 2}


def flash_route(dtype, precision: str, d: int, aligned: bool) -> str:
    """The route a fold takes (one of :data:`FLASH_ROUTES`), by the rule
    the C launchers check, at d <= :data:`FLASH_WGMMA_MAX_D` with
    ``aligned`` operands (every pointer, row and head start on 16 bytes
    and d a whole number of 16-byte chunks, :func:`flash_aligned`):
    HIGHEST → "tf32x3" for float32, DEFAULT → "wgmma" for bfloat16; every
    other geometry HIGHEST → "fma" (bfloat16 operands are widened to f32
    as the JAX kernel upcasts them), DEFAULT → "mma"."""
    _check_precision(precision)
    tma = d <= FLASH_WGMMA_MAX_D and aligned
    if precision == "highest":
        return "tf32x3" if dtype == torch.float32 and tma else "fma"
    return "wgmma" if dtype == torch.bfloat16 and tma else "mma"


def flash_aligned(d: int, *operands) -> bool:
    """Do ``operands`` move in 16-byte chunks: every data pointer 16-byte
    aligned, and d and every stride but the last a whole number of
    chunks. The launchers' ``vec`` (csrc/flash_attention.cu,
    csrc/fused_ring_attention.cu)."""
    n = 16 // operands[0].element_size()
    return d % n == 0 and all(
        t.data_ptr() % 16 == 0 and all(st % n == 0 for st in t.stride()[:-1])
        for t in operands)


def _route_of(precision: str, q, k, v) -> str:
    d = q.shape[-1]
    return flash_route(q.dtype, precision, d, flash_aligned(d, q, k, v))


def route_counts() -> dict:
    """Launches per route of the two attention kernels (keys
    :data:`FLASH_ROUTES`), the two ring collectives, the one-shot kernel,
    the ring halo and the three streaming kernels (keys
    :data:`COLL_ROUTES`), the two halo staging copies (keys
    :data:`PACK_ROUTES`), the two k-step kernels (keys
    :data:`KSTEP_ROUTES`), the derivative (keys :data:`DERIV_ROUTES`), the
    heat update (keys :data:`HEAT_ROUTES`), the dual step (keys
    :data:`DUAL_ROUTES`) and the probe (keys :data:`PROBE_ROUTES`) since
    the last :func:`reset_launch_counts`."""
    return {fn.__name__: dict(fn.launches_by_route)
            for fn in (flash_attention_block, fused_ring_attention,
                       ring_allgather, ring_reduce_scatter, oneshot,
                       ring_halo, pack_edges, unpack_ghosts, daxpy,
                       stream_scale, stream_sum3, stencil2d_iterate,
                       stencil2d_fused_rdma, stencil2d_deriv, heat2d,
                       dual_dim_step, alu_probe)}


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
    route = _route_of(precision, q, k, v)
    fn = _entry("flash_attention", "tpumt_flash_attention_block")
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                *(t.data_ptr() for t in carry_in),
                *(t.data_ptr() for t in carry_out),
                _FLASH_DTYPES[q.dtype], q.shape[0], k.shape[0], q.shape[-1],
                heads, *strides, int(q_off), int(k_off), int(pos_stride),
                float(scale), int(bool(causal)), FLASH_ROUTES.index(route),
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        _raise_launch(f"flash_attention_block ({route} route)", rc)
    flash_attention_block.launches += 1
    flash_attention_block.launches_by_route[route] += 1


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


@checked
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
    skipped. ``precision="highest"`` is f32 arithmetic: 3xTF32 on the
    tensor cores for float32 at d <= 128 in 16-byte chunks (the "tf32x3"
    route), else the CUDA cores (bf16 operands widened, P kept f32);
    ``"default"`` is the tensor cores: bf16 ``mma.sync`` with P rounded to bf16, or, for float32
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
flash_attention_block.launches_by_route = dict.fromkeys(FLASH_ROUTES, 0)


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


@checked
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


# The tf32x3 route's arithmetic in plain torch, for the CPU tests: the
# card's path never calls these (the kernel splits in registers and
# shared memory, csrc/flash_fold.cuh's x3_split).

def tf32_round(x: torch.Tensor, *, truncate: bool = False) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (8 exponent and 10 mantissa bits) by
    integer operations on its bits, as ``cvt.rna.tf32.f32`` rounds: to
    nearest on the 13 low bits, ties away from zero (half the dropped
    range added to the magnitude, then the 13 bits cleared). ``truncate``:
    the bits only cleared, as the tensor cores read a raw f32 word.
    Infinities and NaNs pass through."""
    if x.dtype != torch.float32:
        raise TypeError(f"tf32_round: float32 only, got {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    if not truncate:
        bits = bits + 0x1000
    out = (bits & -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(x), out, x)


def tf32_split(x: torch.Tensor, *, truncate: bool = False):
    """``(big, small)``, the tf32x3 route's split of float32 ``x``: big =
    tf32(x), small = tf32(x - big); x - big - small is ~2^-22·|x| (2^-21
    with ``truncate``, the kernel's compile-time alternative)."""
    big = tf32_round(x, truncate=truncate)
    return big, tf32_round(x - big, truncate=truncate)


def tf32x3_matmul(a: torch.Tensor, b: torch.Tensor, *, passes: int = 3,
                  truncate: bool = False) -> torch.Tensor:
    """``a @ b`` of float32 matrices as the tf32x3 route's products
    compute it: both split by :func:`tf32_split`, then small·big +
    big·small, then + big·big (a product of two TF32 values is exact in
    f32; the sums round in f32). ``passes=1``: big·big alone — one TF32
    pass, the DEFAULT route's arithmetic."""
    if passes not in (1, 3):
        raise ValueError(f"tf32x3_matmul: passes must be 1 or 3, got "
                         f"{passes}")
    a_big, a_small = tf32_split(a, truncate=truncate)
    b_big, b_small = tf32_split(b, truncate=truncate)
    if passes == 1:
        return a_big @ b_big
    return (a_small @ b_big + a_big @ b_small) + a_big @ b_big


def flash_attention_tf32x3_emulated(q, k, v, *, scale=None,
                                    causal: bool = False, passes: int = 3,
                                    truncate: bool = False,
                                    k_tile: "int | None" = None):
    """The tf32x3 route's fold emulated on float32 (L, d) self-attention
    operands from the fresh carry: :func:`flash_attention_block_ref`'s
    online softmax over key tiles of the route's width
    (``FLASH_K_TILES["tf32x3"]``), S = Q·Kᵀ and P·V by
    :func:`tf32x3_matmul` (P split as the kernel splits it in registers),
    then acc / l. ``passes=1`` folds with one TF32 pass instead."""
    from tpu_mpi_tests_torch.comm.ring import online_softmax_update

    _check_flash_operands("flash_attention_tf32x3_emulated", q, k, v)
    if q.dtype != torch.float32 or q.dim() != 2:
        raise ValueError("flash_attention_tf32x3_emulated: (L, d) float32 "
                         "operands")
    L, d = q.shape
    scale = d**-0.5 if scale is None else scale
    kt = k_tile or FLASH_K_TILES["tf32x3"]
    mm = functools.partial(tf32x3_matmul, passes=passes, truncate=truncate)
    m, l, acc = _attention_carry(q)
    q_pos = torch.arange(L)
    for j0 in range(0, k.shape[0], kt):
        kb, vb = k[j0:j0 + kt], v[j0:j0 + kt]
        s = mm(q, kb.T) * scale
        if causal:
            k_pos = torch.arange(j0, j0 + kb.shape[0])
            s = torch.where(q_pos[:, None] >= k_pos[None, :], s,
                            float("-inf"))
        m, l, p, corr = online_softmax_update(m, l, s, keepdims=True)
        acc = acc * corr + mm(p, vb)
    return acc / l


# ---------------------------------------------------------------------------
# fused ring attention: every ring step in one launch
# ---------------------------------------------------------------------------


def fused_ring_slot_offset(lk: int, d: int, itemsize: int) -> int:
    """Bytes from K to V in one K/V slot of the fused ring attention: the
    block's bytes rounded up to 16. A slot is twice that; the comm
    workspace holds two slots (the parities)."""
    return -(-lk * d * itemsize // 16) * 16


def fused_ring_feasible(lq: int, lk: int, d: int, dtype,
                        device=None) -> bool:
    """Can the fused ring-attention kernel run this geometry on this
    world? True iff the dtype is float32 or bfloat16, 1 <= d <=
    :data:`FLASH_MAX_D`, the world has at most :data:`COLL_MAX_WORLD`
    ranks (the signal pad's words) and, on more than one rank, the comm
    workspace (two parity slots of K ‖ V, about 4·lk·d·itemsize bytes)
    fits the card's free memory — ``device``'s, or the current card's
    where one exists (on the CPU the plain version needs none; one rank
    forwards nothing). The JAX gate's VMEM model and
    sublane rule (``collectives_pallas.py:344-373``) are the TPU's: the
    CUDA kernel streams 64-row tiles through shared memory at any length,
    on every route in a fixed footprint (the tf32x3 route's, 224 KB, the
    largest, holds one CTA an SM at any lq, lk and d <= 128).
    Drivers consult it to decline with a NOTE (``attnbench``)."""
    if dtype not in _FLASH_DTYPES or not 1 <= d <= FLASH_MAX_D \
            or lq < 1 or lk < 1:
        return False
    w = make_mesh().size
    if w > COLL_MAX_WORLD:
        return False
    if w == 1:
        return True
    if device is None and torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
    if device is not None and torch.device(device).type == "cuda":
        item = torch.empty((), dtype=dtype).element_size()
        need = 4 * fused_ring_slot_offset(lk, d, item)
        return need <= torch.cuda.mem_get_info(torch.device(device))[0]
    return True


def _check_fused(q, k, v, causal, stripe, precision) -> None:
    _check_flash_operands("fused_ring_attention", q, k, v)
    _check_precision(precision)
    if q.dim() != 2:
        raise ValueError("fused_ring_attention: (L, d) blocks (one head)")
    if stripe and not causal:
        raise ValueError(
            "stripe=True only makes sense for causal ring attention "
            "(non-causal work is already balanced)")


def ring_attention_steps(q, block_of_step, my: int, w: int, *, scale,
                         causal: bool = False, stripe: bool = False,
                         precision: str = "highest", kernel: bool = False):
    """The fused tier's fold, step by step, on rank ``my`` of a
    ``w``-ring: step ``s`` folds ``block_of_step(s)`` — the (k, v) block
    of source rank ``(my - s) mod w`` — into the f32 carry at JAX's
    causal positions (contiguous: ``q_off = my·lq``, ``k_off = src·lk``;
    striped: ``my``, ``src``, stride ``w``), with
    :func:`flash_attention_block_ref`, or with ``kernel=True`` the
    :func:`flash_attention_block` wrapper (on the card: the pipelined
    tier's w launches, which the fused kernel equals bit for bit).
    Returns ``acc / l`` in q's dtype."""
    fold = flash_attention_block if kernel else flash_attention_block_ref
    lq = q.shape[0]
    kw = {"dtype": torch.float32, "device": q.device}
    carry = (torch.full((lq, 1), float("-inf"), **kw),
             torch.zeros((lq, 1), **kw), torch.zeros(q.shape, **kw))
    for s in range(w):
        kb, vb = block_of_step(s)
        src = (my - s) % w
        if stripe:
            q_off, k_off, stride = my, src, w
        else:
            q_off, k_off, stride = my * lq, src * kb.shape[0], 1
        carry = fold(q, kb, vb, *carry, q_off, k_off, scale=scale,
                     causal=causal, pos_stride=stride, precision=precision)
    return (carry[2] / carry[1]).to(q.dtype)


def fused_ring_attention_ref(q, k, v, *, scale=None, causal: bool = False,
                             stripe: bool = False,
                             precision: str = "highest",
                             self_ring: "int | None" = None):
    """Plain version of :func:`fused_ring_attention`: the ring over the
    process group (``Ring.shift`` of (k, v) after each step but the last)
    with :func:`flash_attention_block_ref` at each step
    (:func:`ring_attention_steps`) — bit for bit the port's pipelined
    flash tier on the CPU. ``self_ring=k`` folds the rank's own block k
    times, the sources of a k-ring's rank 0."""
    _check_fused(q, k, v, causal, stripe, precision)
    w, my, ring = _coll_ring("fused_ring_attention", self_ring)
    if scale is None:
        scale = 1.0 / q.shape[-1] ** 0.5
    state = {"kv": (k, v)}

    def block_of_step(s):
        if s > 0 and self_ring is None:
            state["kv"] = ring.shift(state["kv"])
        return state["kv"]

    return ring_attention_steps(q, block_of_step, my, w, scale=float(scale),
                                causal=causal, stripe=stripe,
                                precision=precision)


def fused_ring_world_ref(blocks, *, scale=None, causal: bool = False,
                         stripe: bool = False, precision: str = "highest",
                         kernel: bool = False) -> list:
    """Every rank's result of :func:`fused_ring_attention` over the ranks'
    ``(q, k, v)`` ``blocks``, in one process, the hops done by indexing
    (≅ :func:`coll_world_ref`): the plain versions' values, or with
    ``kernel=True`` the pipelined tier's flash launches on the card. Holds
    the cross-wired instances (:func:`cross_wired`) to both."""
    w = len(blocks)
    if scale is None:
        scale = 1.0 / blocks[0][0].shape[-1] ** 0.5
    return [ring_attention_steps(
        blocks[r][0], lambda s, r=r: blocks[(r - s) % w][1:], r, w,
        scale=float(scale), causal=causal, stripe=stripe,
        precision=precision, kernel=kernel) for r in range(w)]


@checked
def fused_ring_attention(q, k, v, *, scale=None, causal: bool = False,
                         stripe: bool = False, precision: str = "highest",
                         self_ring: "int | None" = None):
    """Ring attention of this rank's block in one launch (≅
    ``fused_ring_attention_pallas``): q (lq, d), k and v (lk, d), float32
    or bfloat16, d <= 256; returns (lq, d) in q's dtype. At step s the
    kernel forwards the current K/V block into the right neighbour's
    comm slot (peer stores, ``comm/peer.py``; credits=2) and folds the
    block of source rank (rank − s) mod w with the flash kernel's tile
    body at JAX's causal positions (contiguous or ``stripe``d), so the
    result equals the pipelined flash tier's (w launches of
    :func:`flash_attention_block`) bit for bit. ``precision``: "highest"
    (f32 arithmetic: 3xTF32 on the tensor cores or the CUDA cores, by
    :func:`flash_route`) or "default" (the tensor cores).

    ``self_ring=k`` (world 1 only, 2 <= k <= 8): the full k-step schedule
    into the rank's own slots, folding its own block k times. An
    explicit request at a geometry :func:`fused_ring_feasible` refuses
    raises ``ValueError`` naming the pipelined tier; more than 8 ranks
    raise :class:`~tpu_mpi_tests_torch.comm.peer.PeerError`. One launch
    per call; every rank must make the same sequence of RDMA calls."""
    _check_fused(q, k, v, causal, stripe, precision)
    w, my, _ = _coll_ring("fused_ring_attention", self_ring)
    lq, d = q.shape
    lk = k.shape[0]
    if not fused_ring_feasible(lq, lk, d, q.dtype,
                               q.device if q.is_cuda else None):
        raise ValueError(
            f"fused ring attention cannot run lq={lq} lk={lk} d={d} "
            f"{q.dtype} on {w} rank(s) (fused_ring_feasible: float32 or "
            f"bfloat16, d <= {FLASH_MAX_D}, at most {COLL_MAX_WORLD} "
            f"ranks, the comm slots in free memory); use the pipelined "
            f"tier (ring tier 'pipelined') at this geometry")
    if scale is None:
        scale = 1.0 / d**0.5
    if q.device.type == "cpu":
        return fused_ring_attention_ref(q, k, v, scale=scale, causal=causal,
                                        stripe=stripe, precision=precision,
                                        self_ring=self_ring)
    if q.device.type != "cuda":
        raise ValueError(f"fused_ring_attention: unsupported device "
                         f"{q.device}")
    for t, nm in ((q, "q"), (k, "k"), (v, "v")):
        if not t.is_contiguous():
            raise ValueError(f"fused_ring_attention: {nm} must be "
                             f"contiguous")
    peer = peer_ring(q.device)
    v_off = fused_ring_slot_offset(lk, d, k.element_size())
    slots = right = 0  # one rank: no slot is read
    if w > 1:
        ws = peer.workspace("fused_ring_attention", 4 * v_off)
        slots = right = ws.data_ptr()
        if peer.symmetric:
            right = peer.peer_ptrs(ws)[1]
    out = torch.empty_like(q)
    m, l, acc = _fused_carry(q)
    pad, left_pad, right_pad = peer.pad_ptrs()
    route = _route_of(precision, q, k, v)
    fn = _entry("fused_ring_attention", "tpumt_fused_ring_attention")
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                m.data_ptr(), l.data_ptr(), acc.data_ptr(), slots, right,
                pad, left_pad, right_pad, _FLASH_DTYPES[q.dtype], lq, lk,
                d, w, my, v_off,
                float(scale), int(bool(causal)), int(bool(stripe)),
                FLASH_ROUTES.index(route), 0, None, _stream(q))
    if rc != 0:
        _raise_launch(f"fused_ring_attention ({route} route)", rc)
    fused_ring_attention.launches += 1
    fused_ring_attention.launches_by_route[route] += 1
    return out


fused_ring_attention.launches = 0
fused_ring_attention.launches_by_route = dict.fromkeys(FLASH_ROUTES, 0)


def _fused_carry(q):
    """The kernel's carry scratch: m, l (lq,) and acc (lq, d) float32,
    written by the kernel before its first fold."""
    kw = {"dtype": torch.float32, "device": q.device}
    return (torch.empty(q.shape[0], **kw), torch.empty(q.shape[0], **kw),
            torch.empty(q.shape, **kw))


def _ring_halo_cross(shards, pads, streams, max_ctas, *, axis: int = 0,
                     n_bnd: int = N_BND, periodic: bool = True):
    """:func:`cross_wired`'s ring halo: the instances' arrays (copies of
    ``shards``), and the launch of instance r into its neighbours r−1 and
    r+1, on the route :func:`halo_route` names, staged through a scratch
    buffer of its own where the extent is under 3·``n_bnd``."""
    w = len(shards)
    outs = [t.clone() for t in shards]
    views = [_ring_operand(t, axis, n_bnd, "ring_halo") for t in outs]
    z0 = views[0]
    for v in views:
        if v.shape != z0.shape or v.dtype != z0.dtype:
            raise ValueError("ring_halo: cross-wired shards must share "
                             "shape and dtype")
    n = z0.shape[axis]
    stages = [torch.empty(2 * n_bnd * (z0.numel() // n), dtype=z0.dtype,
                          device=z0.device) if n < 3 * n_bnd else None
              for _ in range(w)]
    fn = _entry("ring_halo", "tpumt_ring_halo")

    def launch(r):
        left, right = views[(r - 1) % w], views[(r + 1) % w]
        send_lo, send_hi = Ring(r, w).sends(periodic)
        route = halo_route(views[r], axis, n_bnd, left.data_ptr(),
                           right.data_ptr())
        return fn(views[r].data_ptr(), left.data_ptr(), right.data_ptr(),
                  pads[r].data_ptr(), pads[(r - 1) % w].data_ptr(),
                  pads[(r + 1) % w].data_ptr(), z0.element_size(), axis,
                  z0.shape[0], z0.shape[1], n_bnd, int(send_lo),
                  int(send_hi),
                  None if stages[r] is None else stages[r].data_ptr(),
                  coll_route_code(route), max_ctas, streams[r].cuda_stream)

    return outs, launch


def _fused_rdma_cross(shards, pads, streams, *, scale_eps: float,
                      steps: int = 1, periodic: bool = True):
    """:func:`cross_wired`'s fused ring kernel: instance r's input (a copy
    of ``shards[r]``, also written by its neighbours' sends) and output,
    launched into its neighbours r−1 and r+1 on the k-step route
    :func:`kstep_route` names, the ring's ends physical when not
    ``periodic`` (``Ring.phys``), staged through a scratch buffer of its
    own where the height is under 3K."""
    w = len(shards)
    zs = [t.clone() for t in shards]
    outs = [torch.empty_like(t) for t in shards]
    z0 = zs[0]
    K = steps * N_BND
    stages = [torch.empty(2 * K * z0.shape[1], dtype=z0.dtype,
                          device=z0.device) if z0.shape[0] < 3 * K else None
              for _ in range(w)]
    fn = _entry("fused_rdma", "tpumt_stencil2d_fused_rdma")

    def launch(r):
        ring = Ring(r, w)
        send_lo, send_hi = ring.sends(periodic)
        plo, phi = ring.phys(periodic) if steps > 1 else (0, 0)
        route = kstep_route(zs[r], 0, steps, outs[r], fused=True)
        B = fused_block_rows(z0.shape[0], steps, None, route)
        return fn(zs[r].data_ptr(), outs[r].data_ptr(),
                  zs[(r - 1) % w].data_ptr(), zs[(r + 1) % w].data_ptr(),
                  pads[r].data_ptr(), pads[(r - 1) % w].data_ptr(),
                  pads[(r + 1) % w].data_ptr(), DTYPE_CODES[z0.dtype],
                  z0.shape[0], z0.shape[1], steps, B,
                  _rounded(scale_eps, z0.dtype), _rounded(_C1, z0.dtype),
                  _rounded(_C2, z0.dtype), plo, phi, None, int(send_lo),
                  int(send_hi), KSTEP_ROUTES.index(route),
                  None if stages[r] is None else stages[r].data_ptr(), None,
                  streams[r].cuda_stream)

    return outs, launch


def stencil2d_fused_rdma_world_ref(shards, scale_eps: float, steps: int = 1,
                                   periodic: bool = True) -> list:
    """Every rank's result of :func:`stencil2d_fused_rdma` over the
    ranks' ghosted ``shards`` (one per rank, on any device), computed in
    one process: :func:`ring_halo_world_ref` along dim 0 over K-deep
    ghosts, then :func:`stencil2d_iterate_ref` along dim 0 on each, the
    ring's ends physical when not ``periodic``. Holds the card's
    cross-wired fused instances against the plain version's values."""
    w = len(shards)
    halo = ring_halo_world_ref(shards, 0, steps * N_BND, periodic)
    return [stencil2d_iterate_ref(h, scale_eps, dim=0, steps=steps,
                                  phys_static=Ring(r, w).phys(periodic))
            for r, h in enumerate(halo)]


def _fused_ring_cross(blocks, pads, streams, max_ctas, *, scale=None,
                      causal: bool = False, stripe: bool = False,
                      precision: str = "highest"):
    """(outputs, launch(r)) of :func:`cross_wired`'s fused ring attention
    instances: rank r's slots, pads and streams wired to its neighbours'."""
    w = len(blocks)
    q0, k0, _ = blocks[0]
    for q, k, v in blocks:
        _check_fused(q, k, v, causal, stripe, precision)
        if q.shape != q0.shape or k.shape != k0.shape or not (
                q.is_contiguous() and k.is_contiguous()
                and v.is_contiguous()):
            raise ValueError("cross-wired fused_ring_attention: contiguous "
                             "blocks of one shape on every rank")
    lq, d = q0.shape
    lk = k0.shape[0]
    if scale is None:
        scale = 1.0 / d**0.5
    v_off = fused_ring_slot_offset(lk, d, k0.element_size())
    slots = [torch.empty(4 * v_off, dtype=torch.uint8, device=q0.device)
             for _ in range(w)]
    outs = [torch.empty_like(q) for q, _, _ in blocks]
    carries = [_fused_carry(q) for q, _, _ in blocks]
    fn = _entry("fused_ring_attention", "tpumt_fused_ring_attention")

    def launch(r):
        q, k, v = blocks[r]
        route = _route_of(precision, q, k, v)
        return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), outs[r].data_ptr(),
                  *(t.data_ptr() for t in carries[r]), slots[r].data_ptr(),
                  slots[(r + 1) % w].data_ptr(), pads[r].data_ptr(),
                  pads[(r - 1) % w].data_ptr(), pads[(r + 1) % w].data_ptr(),
                  _FLASH_DTYPES[q.dtype], lq, lk, d, w, r, v_off,
                  float(scale), int(bool(causal)), int(bool(stripe)),
                  FLASH_ROUTES.index(route), max_ctas, None,
                  streams[r].cuda_stream)

    return outs, launch


#: every wrapper of a hand kernel (name → function with a .launches count)
WRAPPERS = {
    "stencil2d_iterate": stencil2d_iterate,
    "stencil2d_deriv": stencil2d_deriv,
    "heat2d": heat2d,
    "dual_dim_step": dual_dim_step,
    "alu_probe": alu_probe,
    "pack_edges": pack_edges,
    "unpack_ghosts": unpack_ghosts,
    "ring_halo": ring_halo,
    "stencil2d_fused_rdma": stencil2d_fused_rdma,
    "ring_allgather": ring_allgather,
    "ring_reduce_scatter": ring_reduce_scatter,
    "oneshot": oneshot,
    "daxpy": daxpy,
    "stream_scale": stream_scale,
    "stream_sum3": stream_sum3,
    "flash_attention_block": flash_attention_block,
    "fused_ring_attention": fused_ring_attention,
}

#: every CUDA kernel of ``csrc/`` (the identifier its mangled name ends
#: in, below namespace ``tpumt``) → the wrappers whose counted launch may
#: run it. A counted launch runs exactly one kernel of its wrapper's, so
#: a graph's nodes of a group of wrappers that share kernels number their
#: launches (``instrument/timers.check_graph_launches``); ``()`` marks a
#: kernel a launch runs beside its own (the dual step's one-CTA sum).
KERNELS = {
    "iterate_kernel": ("stencil2d_iterate",),
    "iterate_regs_dim0": ("stencil2d_iterate",),
    "iterate_regs_dim1": ("stencil2d_iterate",),
    "deriv_kernel": ("stencil2d_deriv",),
    "deriv_regs_dim0": ("stencil2d_deriv",),
    "deriv_regs_dim1": ("stencil2d_deriv",),
    "heat2d_kernel": ("heat2d",),
    "heat2d_regs": ("heat2d",),
    "dual_kernel": ("dual_dim_step",),
    "dual_regs_kernel": ("dual_dim_step",),
    "reduce_kernel": (),
    "probe_kernel": ("alu_probe",),
    "probe_cluster_kernel": ("alu_probe",),
    "flat_copy_kernel": ("pack_edges", "unpack_ghosts"),
    "seam_walk_kernel": ("pack_edges", "unpack_ghosts"),
    "ring_halo_kernel": ("ring_halo",),
    "fused_rdma_kernel": ("stencil2d_fused_rdma",),
    "coll_copy_kernel": ("ring_allgather", "ring_reduce_scatter"),
    "ring_allgather_kernel": ("ring_allgather",),
    "ring_reduce_scatter_kernel": ("ring_reduce_scatter",),
    "oneshot_kernel": ("oneshot",),
    "stream_vec16_kernel": ("daxpy", "stream_scale", "stream_sum3"),
    "stream_scalar_kernel": ("daxpy", "stream_scale", "stream_sum3"),
    "flash_fma_kernel": ("flash_attention_block",),
    "flash_mma_kernel": ("flash_attention_block",),
    "flash_wg_kernel": ("flash_attention_block",),
    "flash_x3_kernel": ("flash_attention_block",),
    "fused_ring_attention_kernel": ("fused_ring_attention",),
    "fused_ring_wg_kernel": ("fused_ring_attention",),
    "fused_ring_x3_kernel": ("fused_ring_attention",),
}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
        if hasattr(fn, "launches_by_route"):
            fn.launches_by_route = dict.fromkeys(fn.launches_by_route, 0)


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
