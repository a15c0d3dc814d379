#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Run from the repository root on a machine with a CUDA card. Phases (any
failure exits non-zero and prints no result line):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build all eleven hand kernels (eight libraries) from
   ``tpu_mpi_tests_torch/kernels/csrc`` (``nvcc`` for ``sm_90a``, one
   process per source, in parallel);
3. hold each kernel against its plain PyTorch version on the card: the
   k-step iterate over dim 0/1 × steps 1/4 × static flags (0,0)/(1,1)/(1,0)
   and dynamic flags, float32 and bfloat16, ragged tile edges, and every
   operand the main path gives it (the bench's f32 blocks and bf16
   buffer, the driver's periodic iterate blocks); the derivative over
   dim 0/1 × float32/bfloat16 and its main-path shapes; the heat update
   over float32/bfloat16/float64 × steps 1..4 × ragged shapes (68×52,
   1000×777), the heat runner (exchange + kernel) against its torch tier
   at ghost width 1 and 4, and the heat path's operands (8200² at k=4 in
   float32 and bfloat16, 8194² at k=1); the dual step over the three
   dtypes × ragged shapes and its operand (8196² float32). Tolerance: 0 —
   bit-exact in every dtype. The kernels round after every op exactly
   where the eager PyTorch ops round (float32/float64: one IEEE op each,
   no FMA contraction; bfloat16: each op in float32, rounded to bf16),
   so any difference is a fault. The one exception is the dual step's
   residual, a deterministic sum in another order than torch's, held to
   ``hand.RESIDUAL_RTOL`` (relative). The streaming kernels (daxpy,
   scale, sum3) over float32/float64/bfloat16 × n 1, 127, 1000003 (and
   one misaligned view) × a 2, 1e-7, 1+1e-9 × out of place and in place,
   and at the microbench's operands (2^26 and 2^28 float32), tolerance 0.
   The flash-attention fold (``check_flash_kernel``) over float32/bf16 ×
   L 1..1024 × Lk 1..300 × d 4..256 × dense and causal (partly masked,
   fully masked, fully live, stride 4) × HIGHEST/DEFAULT, a chain of two
   folds, the (L, H, d) layout in one launch and the main path's
   operands: HIGHEST holds the carry to FLASH_RTOL/FLASH_ATOL, DEFAULT
   the normalised output to FLASH_DEFAULT_ATOL of the plain version at
   HIGHEST (sums in another order, tensor-core operands rounded), the
   largest error of each class printed. The ALU probe
   (``check_probe_kernel``) over its eight mixes × float32/bfloat16 ×
   (8, 128), (16, 128), (37, 200), (512, 512), a (3, 70, 130) stack and
   the main path's (B, 512, 512) stack × reps 1, 3, 64 × ``se`` 1e-9 and
   0.05: ``fma``, ``step5*`` and ``heat5`` bit-exact; the two dual mixes,
   which feed a sum taken in another order back into every element,
   within ``hand.alu_probe_tolerance`` (2·reps·(eps·max|z| +
   rtol·max|shift|)); the chain property
   ``probe(probe(z, r1), r2) == probe(z, r1 + r2)`` bit for bit in every
   mix; the capacity guard raising. Pack and unpack
   (``check_pack_kernels``) over both axes × three dtypes × ``n_bnd`` 1,
   2, 8 × ragged shapes, the round trip, and the staged exchange's
   operands (1028 × 524288 axis 0, 524288 × 1028 axis 1, 8192 × 8196
   axis 1), tolerance 0. The dual step's lean body over the shapes the
   raw one has (derivatives bit-exact, residual within
   ``hand.RESIDUAL_RTOL``);
4. the main path, seven paths in turn, each with every launch count set
   to 0 just before it and read just after (and its peak device memory
   read): the headline bench (``tpu_mpi_tests_torch.bench``) at n=8192
   in float32 (S=2 resident blocks, k=4), the same in bfloat16 (dim-1
   single buffer, k=4), the ``stencil2d`` driver with ``--kernel hand``
   at the reference sizes (n_local 1024, n_other 524288) plus its
   iterate leg (``--iterate-tier blocks --iterate-steps 4``), the
   ``heat2d`` driver with ``--kernel hand --mesh 1,1`` at 8192² for 200
   steps (``--halo-steps 4`` float32, ``--halo-steps 1`` float32,
   ``--halo-steps 4`` bfloat16), and the ``stencil2d_grid`` driver with
   ``--kernel hand --mesh 1,1`` at 8192² (20 iterations after 2 warmup).
   Every err-norm and eigen gate must pass, each path's own kernels must
   have launched, and its launches per timestep must be what its
   schedule makes. Then the DAXPY slice, each path alone in the same
   way: the microbench groups ``daxpy``, ``ceiling`` and ``streams``
   (each must launch exactly the streaming kernels its schedule makes,
   and every GB/s row must be finite and at most 1.05 × 3350), and the
   five DAXPY drivers at the reference's sizes with every gate passing
   and no hand kernel launched (the JAX drivers reach no Pallas kernel).
   Then the attention slice, each path alone: ``attnbench`` at L=8192,
   d=128 over the tiers xla, flash, ring, ulysses in float32, causal and
   bfloat16 ``--fast``, and the striped causal ring, and the microbench
   groups ``attention`` and ``causal`` at the JAX sizes: the flash kernel
   launched once per attention call of the flash, ring and ulysses tiers
   (none in xla), no FAIL, every TFLOP/s row finite and at most 1.05 ×
   the peak of its arithmetic (67 f32, 495 TF32, 989 bf16). Then the
   one-card slice (``run_one_card_slice``), each path alone: the
   microbench groups ``vpu`` and ``roofline2`` at the full (512, 512)
   probe block and the JAX kernel sizes (fewer chained probe calls than
   ``python -m tpu_mpi_tests_torch.microbench`` makes, the same reps
   triples; ``roofline2`` a second time at 8192² and 4104..8200, where
   one body's device work outlasts the host's enqueue time), then
   ``stencil``, ``iterate``, ``splitfused``, ``blocks`` and ``heat`` at
   the JAX sizes — every group launches exactly what its
   schedule makes, every rate row is finite (or NaN by its own fit gate)
   and none exceeds 1.05 × the peak of the instructions it issues (the
   probe rows: issued lone mul/add/sub per element against 67 TFLOP/s
   float32, which bfloat16 also runs on, rounding after every op); the
   periodic DEVICE_STAGED exchange with ``kernel="hand"`` on both axes
   (one pack and one unpack launch per exchange, the result equal to
   DIRECT bit for bit); the ``stencil1d`` driver at 32 Mi points (gate
   passing, no hand kernel launched);
5. time each kernel at its main-path shapes with CUDA events (warmed),
   beside its plain version, its one-call PyTorch yardstick where one
   exists (``F.conv2d``, TF32 off: for the derivative, and for the dual
   step a (2,1,5,5) cross-shaped weight giving both derivatives but not
   the residual; none for the k-step updates) and its bound: the larger
   of bytes moved (each input read once, each output written once) over
   3.35 TB/s and flops over 67 TFLOP/s (H100 SXM float32 outside the
   tensor cores; bf16 arithmetic runs in float32 units). The streaming
   kernels are timed in place at 2^26 (and daxpy at 2^28) float32 beside
   ``y.add_(x, alpha=a)`` and ``x.mul_(a)``; the daxpy row also carries
   ``dispatch_rate``'s host-clock time of the same launch. The flash
   fold at (8192, 128) f32 HIGHEST dense and causal, bf16 DEFAULT, and
   (32768, 128) bf16 DEFAULT causal, beside its plain version, its flop
   bound over the peak of its arithmetic, and
   ``F.scaled_dot_product_attention`` (TF32 off for f32). The probe at
   (B, 512, 512) per mix (bound: issued operations over 67 TFLOP/s; no
   library call computes it); pack and unpack at the staged exchange's
   operands beside ``torch.stack`` of the two ``narrow``s and two
   ``copy_`` (bound: bytes, the strided side counted in 32-byte sectors
   touched; timed with their launches queued behind a stall, since they
   are shorter than their wrappers' host cost); the lean dual step
   beside the raw one's yardstick;
6. print the card line, the ``kernels`` JSON line and, last, the device
   JSON line.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import time
import traceback

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published, at 700 W
F32_FLOPS_PER_S = 67e12    # H100 SXM float32 outside the tensor cores
TOLERANCE = 0.0            # bit-exact, see the module docstring
ITERATE_SOURCE = "tpu_mpi_tests_torch/kernels/csrc/stencil_iterate.cu"
DERIV_SOURCE = "tpu_mpi_tests_torch/kernels/csrc/stencil_deriv.cu"
HEAT_SOURCE = "tpu_mpi_tests_torch/kernels/csrc/heat2d.cu"
DUAL_SOURCE = "tpu_mpi_tests_torch/kernels/csrc/dual_dim_step.cu"
ITERATE_REPLACES = "tpu_mpi_tests/kernels/pallas_kernels.py:1177"
DERIV_REPLACES = "tpu_mpi_tests/kernels/pallas_kernels.py:636"
HEAT_REPLACES = "tpu_mpi_tests/kernels/pallas_kernels.py:1448"
DUAL_REPLACES = "tpu_mpi_tests/kernels/pallas_kernels.py:1624"
REF_N_LOCAL, REF_N_OTHER = 1024, 512 * 1024  # the driver's defaults
BENCH_N = 8192  # the headline domain
# the bench's own defaults, set explicitly so its timesteps are known
BENCH_ITERS_SHORT, BENCH_ITERS_LONG, BENCH_SAMPLES = 100, 2100, 5
DRIVER_N_ITER, DRIVER_N_WARMUP, DRIVER_ITERATE_ITERS = 5, 2, 4
K4 = 2 * 4     # ghost width of the k=4 schedules
BENCH_SE = 1e-6 * BENCH_N / 8.0  # the bench's eps × scale
DRIVER_SE = 0.01                 # the driver's iterate-leg scale_eps
GRID_N = 8192                    # the 2-D grid paths' local extent
HEAT_N_STEPS = 200               # the heat driver's default step count
HEAT_RUNS = (("float32", 4), ("float32", 1), ("bfloat16", 4))
GRID_N_ITER, GRID_N_WARMUP = 20, 2
GRID_SCALE = GRID_N / 8.0        # dz scale of the grid driver (Domain1D)
STREAMS_SOURCE = "tpu_mpi_tests_torch/kernels/csrc/streams.cu"
STREAM_REPLACES = {
    "daxpy": "tpu_mpi_tests/kernels/pallas_kernels.py:84",
    "stream_scale": "tpu_mpi_tests/kernels/pallas_kernels.py:144",
    "stream_sum3": "tpu_mpi_tests/kernels/pallas_kernels.py:190",
}
STREAM_KERNELS = tuple(STREAM_REPLACES)
GBPS_CAP = 1.05 * HBM_BYTES_PER_S / 1e9  # a faster row is a timing bug
FLASH_SOURCE = "tpu_mpi_tests_torch/kernels/csrc/flash_attention.cu"
FLASH_REPLACES = "tpu_mpi_tests/kernels/pallas_kernels.py:3230"
FLASH_ALSO_REPLACES = "tpu_mpi_tests/kernels/pallas_kernels.py:3416"
# H100 SXM dense peaks (published, 700 W) of each arithmetic the
# attention paths run: f32 on the CUDA cores (HIGHEST), TF32 and bf16 on
# the tensor cores (DEFAULT); a TFLOP/s row above 1.05x its peak is a
# timing bug
PEAK_FLOPS = {"f32": F32_FLOPS_PER_S, "tf32": 495e12, "bf16": 989e12}
# kernel vs plain: f32 arithmetic (HIGHEST, either operand dtype) holds
# the carry to rtol/atol 1e-5 (dot products and sums in another order) —
# acc's atol times its row's weight l where l > 1: acc = Σ p·v sums up to
# Lk terms of size p·|v|, so two summation orders differ by ~eps·l·|v|
# where the terms cancel (at 8192×128: 3e-4 on acc, 4e-7 on acc/l);
# the tensor-core route (DEFAULT) holds the normalised output acc/l to an
# absolute 8e-3 (bf16: P rounded to bf16) and 5e-3 (TF32 operands) of
# the plain version at HIGHEST
FLASH_RTOL = FLASH_ATOL = 1e-5
FLASH_DEFAULT_ATOL = {"bfloat16": 8e-3, "float32": 5e-3}
ATTN_L, ATTN_D, ATTN_L_LONG = 8192, 128, 32768
ATTN_N_ITER = 110
# attnbench paths: (path, extra argv, flash-kernel tiers); every
# flash-kernel tier chains 3 warm + n_iter/10 + n_iter calls, one launch
# each (the ring at world=1 makes one step per call), the xla tier none
_ATTN_ARGV = ["--seq-len", str(ATTN_L), "--head-dim", str(ATTN_D),
              "--n-iter", str(ATTN_N_ITER)]
ATTN_CALLS = 3 + ATTN_N_ITER // 10 + ATTN_N_ITER
ATTNBENCH_PATHS = (
    ("attnbench float32", ["--tiers", "xla,flash,ring,ulysses"], 3),
    ("attnbench float32 causal",
     ["--tiers", "xla,flash,ring,ulysses", "--causal"], 3),
    ("attnbench bfloat16 fast", ["--tiers", "xla,flash,ring,ulysses",
                                 "--dtype", "bfloat16", "--fast"], 3),
    ("attnbench ring causal stripe",
     ["--tiers", "ring", "--causal", "--stripe"], 1),
)
# the attention microbench groups: attention = 2 dtypes x one chained
# flash arm of 3 + 100 + 1100 calls; causal = 5 arms per size of 3 +
# iters/10 + iters calls, iters = 800 at L=8192 and 200 at L=32768
ATTN_MICROBENCH_LAUNCHES = {
    "attention": 2 * (3 + 100 + 1100),
    "causal": 5 * (3 + 80 + 800) + 5 * (3 + 20 + 200),
}
PROBE_SOURCE = "tpu_mpi_tests_torch/kernels/csrc/alu_probe.cu"
PROBE_REPLACES = "tpu_mpi_tests/kernels/pallas_kernels.py:469"
PACK_SOURCE = "tpu_mpi_tests_torch/kernels/csrc/pack.cu"
PACK_REPLACES = {
    "pack_edges": "tpu_mpi_tests/kernels/pallas_kernels.py:2772",
    "unpack_ghosts": "tpu_mpi_tests/kernels/pallas_kernels.py:2803",
}
PROBE_HW = 512                   # the probe block of the vpu/roofline2 groups
PROBE_SE_VISIBLE = 0.05          # an update scale the arithmetic shows at
# chained probe calls per timing point in this script (the microbench's
# own default is 400); the reps triples are the groups' own
SMOKE_PROBE_ITERS = 40
SECTOR = 32                      # bytes the card moves per touched sector
# the staged exchange's operands: (shape, axis) — the stencil2d driver's
# two decompositions and the splitfused group's periodic field
STAGED_CASES = (((REF_N_LOCAL + 4, REF_N_OTHER), 0),
                ((REF_N_OTHER, REF_N_LOCAL + 4), 1),
                ((BENCH_N, BENCH_N + 4), 1))
STAGED_EXCHANGES = 20
# roofline2 a second time at sizes whose per-body device work outlasts the
# host's enqueue time on this card (the JAX sizes, 2048^2 and 2056..4104,
# are host-bound in a Python loop of launches); same size ratios, so the
# same chain lengths
ROOFLINE_LARGE = {"n": GRID_N, "sizes": (4104, 5800, 8200)}
STENCIL1D_N = 32 * 1024 * 1024   # the 1-D driver's default size
N26, N28 = 1 << 26, 1 << 28
# launches each microbench group's schedule makes (microbench.py):
# dispatch_rate = 1 warm + n_base + (n_base + n_iter) calls; chain_rate =
# 3 warm + n_short + n_long launches
_DR = {1000: 1 + 100 + 1100, 500: 1 + 50 + 550}
MICROBENCH_LAUNCHES = {
    "daxpy": {"daxpy": 2 * _DR[1000] + _DR[500] + 2 * (3 + 100 + 1100),
              "stream_scale": 0, "stream_sum3": 0},
    "ceiling": {"daxpy": _DR[1000], "stream_scale": _DR[1000],
                "stream_sum3": 0},
    "streams": {"daxpy": (3 + 100 + 1000) + (3 + 30 + 300),
                "stream_scale": 3 + 100 + 1000,
                "stream_sum3": 3 + 100 + 1000},
}


def _chain(n_short, n_long, repeats=1):
    """Calls one ``chain_rate`` makes: 3 warm, then the two runs."""
    return 3 + repeats * (n_short + n_long)


def _kstep_calls(short, floor, ks=(2, 4, 6, 8)):
    return sum(_chain(max(short[1], short[0] // k), max(floor, 2000 // k))
               for k in ks)


def one_card_launches():
    """Launches each one-card microbench group's schedule makes
    (microbench.py), per kernel; a kernel not named launches nothing."""
    point = _chain(max(1, SMOKE_PROBE_ITERS // 10), SMOKE_PROBE_ITERS)
    kstep = _kstep_calls((50, 5), 50)
    dual = sum(_chain(it // 10, it, repeats=2) for it in
               (max(40, 400 * 2056**2 // nn**2) for nn in (2056, 2904, 4104)))
    heat = sum(_chain(max(1, 40 // k), max(max(1, 40 // k) + 1, 2000 // k))
               for k in (1, 4, 8))
    return {
        # 3 mixes x 2 dtypes x 3 reps values; S=2 blocks f32 + bf16 dim 1
        "vpu": {"alu_probe": 18 * point, "stencil2d_iterate": 3 * kstep},
        # the ceiling fit, 3 mixes x 2 dtypes x 3 reps, heat and both
        # dual bodies in 2 dtypes
        "roofline2": {"daxpy": _DR[1000], "stream_scale": _DR[1000],
                      "alu_probe": 18 * point,
                      "heat2d": 2 * _kstep_calls((50, 2), 20),
                      "dual_dim_step": 2 * 2 * dual},
        # the same schedule at sizes that keep the card busy
        "roofline2 large": {"daxpy": _DR[1000], "stream_scale": _DR[1000],
                            "alu_probe": 18 * point,
                            "heat2d": 2 * _kstep_calls((50, 2), 20),
                            "dual_dim_step": 2 * 2 * dual},
        "stencil": {"stencil2d_deriv": 2 * (1 + 50 + 550)},
        "iterate": {"stencil2d_iterate": 3 * _chain(100, 2100)
                    + 3 * _chain(25, 525)},
        "splitfused": {},
        "blocks": {"stencil2d_iterate": 3 * _chain(25, 525)},
        "heat": {"heat2d": 2 * heat},
    }


# the DAXPY drivers at the reference's sizes: (path, module, argv, lines)
DAXPY_DRIVERS = (
    ("daxpy", "daxpy", ["--n", str(N26), "--dtype", "float64", "--iters",
                        "20"], ("0/1 SUM = ", "TIME kernel : ")),
    ("mpi_daxpy", "mpi_daxpy", ["--n-total", str(N26), "--ranks", "4",
                                "--dtype", "float64"],
     ("4 logical ranks over 1 devices", "3/4 SUM = ")),
    ("mpi_daxpy_nvtx float32", "mpi_daxpy_nvtx", ["--dtype", "float32"],
     ("0/1 ALLSUM = ", "TIME gather : ")),
    ("mpi_daxpy_nvtx float64", "mpi_daxpy_nvtx", ["--dtype", "float64"],
     ("0/1 ALLSUM = 25165824.500000", "TIME gather : ")),
    ("mpi_daxpy_nvtx managed", "mpi_daxpy_nvtx",
     ["--dtype", "float64", "--space", "managed", "--barrier"],
     ("0/1 ALLSUM = 25165824.500000", "TIME barrier : ")),
    ("gather_inplace", "gather_inplace",
     ["--n-per-rank", str(128 << 20), "--dtype", "float64"],
     ("0/1 lsum=134217728.0 asum=134217728.0",)),
    ("envprobe", "envprobe", ["--verbose"], ("0/1 MEMORY_PER_CORE=",)),
)


class SmokeFailure(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    if not out:
        raise SmokeFailure("nvidia-smi printed nothing")
    return out.splitlines()[0]


def iterate_cases():
    """The iterate kernel's operands on the main path, from the schedules
    the bench and the driver build: (path, shape, dtype, dim, flags,
    scale_eps). The bench's f32 blocks are physical at the domain's
    outer edges; the driver's iterate leg runs a periodic self-ring."""
    import torch

    from tpu_mpi_tests_torch.comm import halo as H

    S = H.PRIOR_BLOCKS["float32"]
    bench_block = (BENCH_N // S + 2 * K4, BENCH_N)
    driver_block = (REF_N_LOCAL // S + 2 * K4, REF_N_OTHER)
    return [
        ("bench float32", bench_block, torch.float32, 0, (1, 0), BENCH_SE),
        ("bench float32", bench_block, torch.float32, 0, (0, 1), BENCH_SE),
        ("bench bfloat16", (BENCH_N, BENCH_N + 2 * K4), torch.bfloat16, 1,
         (1, 1), BENCH_SE),
        ("stencil2d", driver_block, torch.float32, 0, (0, 0), DRIVER_SE),
    ]


def heat_cases():
    """The heat update's operands on the main path: (path, shape, dtype,
    steps, cx, cy) — the driver's 8192² shard ghosted k deep on both
    axes, with the driver's own coefficients."""
    import torch

    from tpu_mpi_tests_torch.drivers import heat2d

    _, cx, cy = heat2d.coefficients(GRID_N, GRID_N, 0.1)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    return [(f"heat2d {dt} k={k}", (GRID_N + 2 * k, GRID_N + 2 * k),
             dtypes[dt], k, cx, cy) for dt, k in HEAT_RUNS]


def compare(name, got, want, failures):
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        failures.append(f"{name}: shape/dtype {tuple(got.shape)} "
                        f"{got.dtype} != {tuple(want.shape)} {want.dtype}")
        return float("inf")
    diff = (got.double() - want.double()).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    same = torch.equal(got, want) or err <= TOLERANCE
    if not same or not torch.isfinite(got.double()).all():
        failures.append(f"{name}: max |kernel - plain| = {err:g} "
                        f"(tolerance {TOLERANCE:g})")
    return err


def check_kernels(device):
    """Phase 3: every kernel against its plain version on the card.
    Returns the max abs error per kernel at its main-path shapes."""
    import torch

    from tpu_mpi_tests_torch.kernels import hand

    gen = torch.Generator(device=device).manual_seed(1234)

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32).to(dtype)

    failures = []
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for dim in (0, 1):
            for steps in (1, 4):
                K = 2 * steps
                # ragged against both tile shapes (64x64 at dim 0,
                # 8x256 at dim 1)
                shape = (2 * K + 150, 200) if dim == 0 else (37, 2 * K + 600)
                z = rand(shape, dtype)
                for flags in ((0, 0), (1, 1), (1, 0), "dynamic"):
                    kw = ({"phys": torch.tensor([0, 1], dtype=torch.int32,
                                                device=device)}
                          if flags == "dynamic" else {"phys_static": flags})
                    got = hand.stencil2d_iterate(z, 0.37, dim=dim,
                                                 steps=steps, **kw)
                    want = hand.stencil2d_iterate_ref(z, 0.37, dim=dim,
                                                      steps=steps, **kw)
                    compare(f"iterate {dtype} dim={dim} steps={steps} "
                            f"flags={flags}", got, want, failures)
                    n_cases += 1
        for dim in (0, 1):
            shape = (133, 301) if dim == 0 else (301, 133)
            z = rand(shape, dtype)
            compare(f"deriv {dtype} dim={dim}",
                    hand.stencil2d_deriv(z, 3.0, dim=dim),
                    hand.stencil2d_deriv_ref(z, 3.0, dim=dim), failures)
            n_cases += 1
    z = rand((70, 40), torch.float64)
    compare("iterate float64 dim=0 steps=4",
            hand.stencil2d_iterate(z, 0.37, dim=0, steps=4,
                                   phys_static=(1, 0)),
            hand.stencil2d_iterate_ref(z, 0.37, dim=0, steps=4,
                                       phys_static=(1, 0)), failures)
    n_cases += 1

    n_cases += check_grid_kernels(device, rand, failures)
    n_stream, stream_errs = check_stream_kernels(device, gen, failures)
    n_cases += n_stream
    n_flash, flash_errs, flash_main = check_flash_kernel(device, gen,
                                                         failures)
    n_probe, probe_errs = check_probe_kernel(device, rand, failures)
    n_cases += n_probe
    n_pack, pack_errs = check_pack_kernels(device, rand, failures)
    n_cases += n_pack

    # the main-path shapes: the bench's f32 blocks and bf16 dim-1 buffer,
    # the driver's periodic iterate blocks, the driver's derivatives, the
    # heat paths' shards, the grid path's block
    errs = {"stencil2d_iterate": 0.0, "stencil2d_deriv": 0.0,
            "heat2d": 0.0, "dual_dim_step": 0.0,
            "dual_dim_step residual (relative)": 0.0, **stream_errs,
            **probe_errs, **pack_errs}
    for _, shape, dtype, dim, flags, se in iterate_cases():
        z = rand(shape, dtype)
        err = compare(
            f"iterate main-path {shape} {dtype} flags={flags}",
            hand.stencil2d_iterate(z, se, dim=dim, steps=4,
                                   phys_static=flags),
            hand.stencil2d_iterate_ref(z, se, dim=dim, steps=4,
                                       phys_static=flags), failures)
        errs["stencil2d_iterate"] = max(errs["stencil2d_iterate"], err)
        n_cases += 1
        del z
    for shape, dim in (((REF_N_LOCAL + 4, REF_N_OTHER), 0),
                       ((REF_N_LOCAL, REF_N_OTHER + 4), 1)):
        z = rand(shape, torch.float32)
        err = compare(f"deriv main-path {shape} dim={dim}",
                      hand.stencil2d_deriv(z, 128.0, dim=dim),
                      hand.stencil2d_deriv_ref(z, 128.0, dim=dim),
                      failures)
        errs["stencil2d_deriv"] = max(errs["stencil2d_deriv"], err)
        n_cases += 1
        del z
    for path, shape, dtype, k, cx, cy in heat_cases():
        z = rand(shape, dtype)
        err = compare(f"heat2d main-path {path} {shape}",
                      hand.heat2d(z, cx, cy, steps=k),
                      hand.heat2d_ref(z, cx, cy, steps=k), failures)
        errs["heat2d"] = max(errs["heat2d"], err)
        n_cases += 1
        del z
        torch.cuda.empty_cache()
    z = rand((GRID_N + 4, GRID_N + 4), torch.float32)
    err, rel = compare_dual("dual_dim_step main-path", z, GRID_SCALE,
                            GRID_SCALE, failures)
    errs["dual_dim_step"] = max(errs["dual_dim_step"], err)
    errs["dual_dim_step residual (relative)"] = rel
    err, rel = compare_dual("dual_dim_step lean main-path", z, GRID_SCALE,
                            GRID_SCALE, failures, lean=True)
    errs["dual_dim_step"] = max(errs["dual_dim_step"], err)
    errs["dual_dim_step lean residual (relative)"] = rel
    n_cases += 2
    del z
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if failures:
        raise SmokeFailure("kernel/plain mismatches:\n  "
                           + "\n  ".join(failures))
    log(f"CHECK {n_cases} kernel-vs-plain cases bit-exact (the probe's dual "
        f"mixes and the dual step's residuals within their tolerances), "
        f"{n_flash} flash cases within their tolerances")
    # the flash kernel's main-path error: the normalised output at the
    # f32 HIGHEST operand; every class beside it
    errs["flash_attention_block"] = max(
        v for k, v in flash_main.items() if "highest" in k)
    errs["flash_attention_block classes"] = flash_errs
    errs["flash_attention_block main path"] = flash_main
    return errs


def compare_dual(name, z, sx, sy, failures, lean=False):
    """The dual step (its raw or its lean body) against its plain
    version: both derivatives bit-exact, the residual within
    ``hand.RESIDUAL_RTOL``. Returns (max abs error of the derivatives,
    relative error of the residual)."""
    from tpu_mpi_tests_torch.kernels import hand

    gx, gy, gr = hand.dual_dim_step(z, 2, sx, sy, lean=lean)
    wx, wy, wr = hand.dual_dim_step_ref(z, 2, sx, sy, lean=lean)
    err = max(compare(f"{name} {tuple(z.shape)} {z.dtype} dz_dx", gx, wx,
                      failures),
              compare(f"{name} {tuple(z.shape)} {z.dtype} dz_dy", gy, wy,
                      failures))
    want = float(wr)
    rel = abs(float(gr) - want) / max(abs(want), 1e-300)
    rtol = hand.RESIDUAL_RTOL[z.dtype]
    if gr.dtype != z.dtype or not rel <= rtol:
        failures.append(f"{name} {tuple(z.shape)} {z.dtype} residual: "
                        f"{float(gr)!r} vs {want!r}, relative {rel:g} "
                        f"(tolerance {rtol:g})")
    return err, rel


def check_grid_kernels(device, rand, failures) -> int:
    """The heat update and the dual step at small ragged shapes in every
    dtype, and the heat runner at ghost widths 1 and 4. Returns the
    number of cases."""
    import torch

    from tpu_mpi_tests_torch.comm import halo as H
    from tpu_mpi_tests_torch.kernels import hand

    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16, torch.float64):
        # ragged against the 32x128 output tile on both axes
        for shape in ((68, 52), (1000, 777)):
            z = rand(shape, dtype)
            for steps in (1, 2, 3, 4):
                compare(f"heat2d {dtype} {shape} steps={steps}",
                        hand.heat2d(z, 0.13, 0.21, steps=steps),
                        hand.heat2d_ref(z, 0.13, 0.21, steps=steps),
                        failures)
                n_cases += 1
            compare_dual("dual_dim_step", z, 3.0, 0.5, failures)
            compare_dual("dual_dim_step lean", z, 3.0, 0.5, failures,
                         lean=True)
            n_cases += 2
    # the runner: periodic exchange on both axes + the kernel on two
    # ping-ponged buffers, against the torch tier, 3 bodies
    for n_bnd, steps in ((1, 1), (4, 1), (4, 2), (4, 3), (4, 4)):
        z = rand((100 + 2 * n_bnd, 260 + 2 * n_bnd), torch.float32)
        got = H.heat_step2d_fn(n_bnd, 0.2, 0.2, steps=steps,
                               kernel="hand")(z.clone(), 3)
        want = H.heat_step2d_fn(n_bnd, 0.2, 0.2, steps=steps,
                                kernel="torch")(z.clone(), 3)
        compare(f"heat runner n_bnd={n_bnd} steps={steps}", got, want,
                failures)
        n_cases += 1
    return n_cases


def probe_batch(device) -> int:
    """Blocks per probe launch on the main path (the groups' own rule)."""
    from tpu_mpi_tests_torch import microbench

    return microbench.probe_batch(PROBE_HW, PROBE_HW, device)


def check_probe_kernel(device, rand, failures):
    """The ALU probe against its plain version: every mix × float32 and
    bfloat16 × small, ragged, batched and main-path shapes × reps 1, 3,
    64 × the inert and a visible ``se``. ``fma``, ``step5*`` and
    ``heat5``: tolerance 0. The dual mixes: ``hand.alu_probe_tolerance``
    from the plain run's largest value and shift. Then the chain
    property, bit for bit in every mix, and the capacity guard. Returns
    (number of cases, {"alu_probe": max abs error of the bit-exact mixes
    at the main-path stack, "alu_probe dual mixes": their largest error
    and the tolerance it was held to})."""
    import torch

    from tpu_mpi_tests_torch.kernels import hand

    B = probe_batch(device)
    main = (B, PROBE_HW, PROBE_HW)
    shapes = ((8, 128), (16, 128), (37, 200), (PROBE_HW, PROBE_HW),
              (3, 70, 130), main)
    n_cases = 0
    errs = {"alu_probe": 0.0}
    dual = {"max_abs_err": 0.0, "tolerance_at_that_case": 0.0, "equal": 0,
            "cases": 0}
    for dtype in (torch.float32, torch.bfloat16):
        for shape in shapes:
            z = rand(shape, dtype)
            for mix in hand.ALU_PROBE_MIXES:
                for reps in (1, 3, 64):
                    for se in (1e-9, PROBE_SE_VISIBLE):
                        name = (f"alu_probe {mix} {dtype} {shape} "
                                f"reps={reps} se={se}")
                        got = hand.alu_probe(z, reps, mix, se=se)
                        shifts = []
                        want = hand.alu_probe_ref(z, reps, mix, se=se,
                                                  shifts=shifts)
                        n_cases += 1
                        if not mix.startswith("dualdim"):
                            err = compare(name, got, want, failures)
                            if shape == main:
                                errs["alu_probe"] = max(errs["alu_probe"],
                                                        err)
                            continue
                        err = float((got.double() - want.double()).abs()
                                    .max())
                        tol = hand.alu_probe_tolerance(
                            dtype, reps, float(want.double().abs().max()),
                            max(shifts))
                        dual["cases"] += 1
                        dual["equal"] += int(torch.equal(got, want))
                        if err >= dual["max_abs_err"]:
                            dual["max_abs_err"] = err
                            dual["tolerance_at_that_case"] = tol
                        if not err <= tol or not torch.isfinite(
                                got.double()).all():
                            failures.append(f"{name}: max |kernel - plain| "
                                            f"= {err:g} beyond {tol:g}")
            del z
    errs["alu_probe dual mixes"] = dual
    # chain property: two launches equal one, bit for bit, in every mix
    z = rand((2, 100, 300), torch.float32)
    for mix in hand.ALU_PROBE_MIXES:
        once = hand.alu_probe(z, 7, mix, se=PROBE_SE_VISIBLE)
        twice = hand.alu_probe(hand.alu_probe(z, 3, mix, se=PROBE_SE_VISIBLE),
                               4, mix, se=PROBE_SE_VISIBLE)
        if not torch.equal(once, twice) or torch.equal(once, z):
            failures.append(f"alu_probe {mix}: probe(probe(z, 3), 4) != "
                            f"probe(z, 7)")
        n_cases += 1
    # the capacity guard: two buffers over the L2 raise, nothing launches
    l2 = hand.alu_probe_l2_bytes()
    big = torch.zeros((l2 // 4 // 1024 // 2 + 1024, 1024), device=device)
    before = hand.alu_probe.launches
    try:
        hand.alu_probe(big, 2, "fma")
        failures.append("alu_probe: a block pair over the L2 did not raise")
    except ValueError as e:
        if "L2" not in str(e) or hand.alu_probe.launches != before:
            failures.append(f"alu_probe capacity guard: {e}")
    n_cases += 1
    del big
    log(f"PROBE {n_cases} cases; main-path stack {list(main)}, L2 {l2} B; "
        f"dual mixes {json.dumps(dual)}")
    return n_cases, errs


def check_pack_kernels(device, rand, failures):
    """Pack and unpack against their plain versions, tolerance 0: both
    axes × float32/float64/bfloat16 × n_bnd 1, 2, 8 × ragged shapes, the
    round trip (ghosts take the packed edges, the interior is untouched),
    and the staged exchange's operands. Returns (number of cases, max abs
    error per kernel at those operands)."""
    import torch

    from tpu_mpi_tests_torch.kernels import hand

    def one(z, axis, n_bnd, where):
        name = f"{where} {z.dtype} {tuple(z.shape)} axis={axis} b={n_bnd}"
        lo, hi = hand.pack_edges(z, axis, n_bnd)
        wlo, whi = hand.pack_edges_ref(z, axis, n_bnd)
        e_pack = max(compare(f"pack_edges lo {name}", lo, wlo, failures),
                     compare(f"pack_edges hi {name}", hi, whi, failures))
        n = z.shape[axis]
        got = hand.unpack_ghosts(z.clone(), lo, hi, axis, n_bnd)
        want = hand.unpack_ghosts_ref(z.clone(), lo, hi, axis, n_bnd)
        e_unpack = compare(f"unpack_ghosts {name}", got, want, failures)
        inner = (n_bnd, n - 2 * n_bnd)
        if not (torch.equal(got.narrow(axis, 0, n_bnd), lo)
                and torch.equal(got.narrow(axis, n - n_bnd, n_bnd), hi)
                and torch.equal(got.narrow(axis, *inner),
                                z.narrow(axis, *inner))):
            failures.append(f"pack/unpack round trip {name}")
        return e_pack, e_unpack

    n_cases = 0
    for dtype in (torch.float32, torch.float64, torch.bfloat16):
        for shape in ((37, 201), (300, 1028)):
            z = rand(shape, dtype)
            for axis in (0, 1):
                for n_bnd in (1, 2, 8):
                    one(z, axis, n_bnd, "ragged")
                    n_cases += 1
    errs = {"pack_edges": 0.0, "unpack_ghosts": 0.0}
    for shape, axis in STAGED_CASES:
        z = rand(shape, torch.float32)
        e_pack, e_unpack = one(z, axis, 2, "main-path")
        errs["pack_edges"] = max(errs["pack_edges"], e_pack)
        errs["unpack_ghosts"] = max(errs["unpack_ghosts"], e_unpack)
        n_cases += 1
        del z
        torch.cuda.empty_cache()
    return n_cases, errs


def stream_calls(name, a, ops, inplace):
    """(kernel call, plain call) of streaming kernel ``name`` on operands
    ``ops`` (x, y for daxpy; x for scale; w, x, y for sum3); in place, the
    kernel writes into a copy of its last operand, and returns it."""
    from tpu_mpi_tests_torch.kernels import hand

    kernel, plain = getattr(hand, name), getattr(hand, f"{name}_ref")
    args = ops if name == "stream_sum3" else (a, *ops)

    def run_kernel():
        if not inplace:
            return kernel(*args)
        tgt = args[-1].clone()
        return kernel(*args[:-1], tgt, out=tgt)

    return run_kernel, lambda: plain(*args)


def check_stream_kernels(device, gen, failures):
    """The streaming kernels against their plain versions, tolerance 0:
    every dtype × ragged n (and one view 4 bytes off 16-byte alignment,
    which takes the element-wise path) × a × out of place / in place,
    then the microbench's own operands at 2^26 and 2^28 float32. Returns
    (number of cases, max abs error per kernel at the main-path
    operands)."""
    import torch

    def rand(n, dtype, offset=0):
        t = torch.rand(n + offset, generator=gen, device=device,
                       dtype=torch.float32) * 4 - 2
        return t.to(dtype)[offset:]

    n_cases = 0
    for dtype in (torch.float32, torch.float64, torch.bfloat16):
        for n, offset in ((1, 0), (127, 0), (1000003, 0), (1000003, 1)):
            w, x, y = (rand(n, dtype, offset) for _ in range(3))
            for name in STREAM_KERNELS:
                ops = {"daxpy": (x, y), "stream_scale": (x,),
                       "stream_sum3": (w, x, y)}[name]
                for a in ((None,) if name == "stream_sum3"
                          else (2.0, 1e-7, 1.0 + 1e-9)):
                    for inplace in (False, True):
                        got, want = (f() for f in stream_calls(
                            name, a, ops, inplace))
                        compare(f"{name} {dtype} n={n} offset={offset} "
                                f"a={a} inplace={inplace}", got, want,
                                failures)
                        n_cases += 1
    # the main path's operands: the microbench's calls, each shape once
    errs = dict.fromkeys(STREAM_KERNELS, 0.0)
    for name, n, a, inplace in (
            ("daxpy", N26, 2.0, False), ("daxpy", N26, 1e-7, True),
            ("daxpy", N26, 1.0, True), ("daxpy", N28, 2.0, False),
            ("daxpy", N28, 1.0, True), ("stream_scale", N26, 2.0, False),
            ("stream_scale", N26, 1.0 + 1e-9, True),
            ("stream_sum3", N26, None, True)):
        k = {"daxpy": 2, "stream_scale": 1, "stream_sum3": 3}[name]
        ops = tuple(rand(n, torch.float32) for _ in range(k))
        got, want = (f() for f in stream_calls(name, a, ops, inplace))
        errs[name] = max(errs[name], compare(
            f"{name} main-path n={n} a={a} inplace={inplace}", got, want,
            failures))
        n_cases += 1
        del ops, got, want
        torch.cuda.empty_cache()
    return n_cases, errs


def check_flash_kernel(device, gen, failures):
    """The flash kernel against its plain version: f32 and bf16 × L 1, 7,
    100, 257, 1024 × Lk 1, 64, 300 × d 4, 17, 64, 128, 256, non-causal
    and causal with offsets that leave the block partly live (0, 0),
    fully masked (0, 10^6), fully live (10^6, 0) and partly live at
    pos_stride 4, each at HIGHEST (the carry, FLASH_RTOL/ATOL) and
    DEFAULT (the normalised output against the plain version at HIGHEST,
    FLASH_DEFAULT_ATOL); a chain of two folds against one fold over the
    concatenated block; the (L, H, d) layout with H=4 in one launch; the
    main path's operands (8192×128 f32 and bf16, 32768×128 bf16 causal).
    Returns (number of cases, largest error per class, the main-path
    errors)."""
    import torch

    from tpu_mpi_tests_torch.kernels import hand

    torch.backends.cuda.matmul.allow_tf32 = False
    errs: dict[str, float] = {}

    def rand(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    def carry(L, d, fresh=False):
        if fresh:
            return (torch.full((L, 1), float("-inf"), device=device),
                    torch.zeros((L, 1), device=device),
                    torch.zeros((L, d), device=device))
        return rand((L, 1)), rand((L, 1)).abs() + 0.5, rand((L, d))

    def note(cls, err):
        errs[cls] = max(errs.get(cls, 0.0), err)
        return err

    def close(name, cls, got, want):
        """Carries at HIGHEST: rtol/atol, -inf rows equal; acc's atol
        scaled by its row's weight l where l > 1 (see FLASH_ATOL)."""
        err = 0.0
        for g, w, what in zip(got, want, ("m", "l", "acc")):
            atol = FLASH_ATOL
            if what == "acc":
                atol = FLASH_ATOL * want[1].clamp(min=1.0)
            ok = (g - w).abs() <= atol + FLASH_RTOL * w.abs()
            ok |= g == w  # -inf rows
            fin = torch.isfinite(w)
            if fin.any():
                err = max(err, float((g[fin] - w[fin]).abs().max()))
            if not bool(ok.all()):
                failures.append(f"flash {name} {what}: max |kernel - plain|"
                                f" = {err:g} beyond rtol/atol {FLASH_RTOL:g}")
        return note(cls, err)

    def normalised_close(name, cls, got, want, dtype):
        g, w = got[2] / got[1], want[2] / want[1]
        err = float((g - w).abs().max())
        tol = FLASH_DEFAULT_ATOL[str(dtype).split(".")[1]]
        if not err <= tol:
            failures.append(f"flash {name}: max |out - plain out| = {err:g}"
                            f" beyond {tol:g}")
        return note(cls, err)

    def fold(q, k, v, c, offs, causal, precision, plain=False, **kw):
        fn = hand.flash_attention_block_ref if plain \
            else hand.flash_attention_block
        args = [t.clone() for t in c] if not plain else list(c)
        return fn(q, k, v, *args, offs[0], offs[1], scale=q.shape[1]**-0.5,
                  causal=causal, pos_stride=offs[2], precision=precision,
                  **kw)

    n_cases = 0
    big = 10**6
    offsets = ((False, (0, 0, 1), "dense"),
               (True, (0, 0, 1), "partly masked"),
               (True, (0, big, 1), "fully masked"),
               (True, (big, 0, 1), "fully live"),
               (True, (40, 16, 4), "stride 4"))
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for L in (1, 7, 100, 257, 1024):
            for Lk in (1, 64, 300):
                for d in (4, 17, 64, 128, 256):
                    q, k, v = rand((L, d), dtype), rand((Lk, d), dtype), \
                        rand((Lk, d), dtype)
                    c = carry(L, d)
                    for causal, offs, what in offsets:
                        name = f"{dn} L={L} Lk={Lk} d={d} {what}"
                        want = fold(q, k, v, c, offs, causal, "highest",
                                    plain=True)
                        close(name + " highest", f"{dn} highest",
                              fold(q, k, v, c, offs, causal, "highest"),
                              want)
                        normalised_close(
                            name + " default", f"{dn} default",
                            fold(q, k, v, c, offs, causal, "default"), want,
                            dtype)
                        n_cases += 2
    # two folds chained against one fold over the concatenated block
    for causal in (False, True):
        q, k1, v1 = rand((300, 64)), rand((200, 64)), rand((200, 64))
        k2, v2 = rand((150, 64)), rand((150, 64))
        c = carry(300, 64, fresh=True)
        mid = fold(q, k1, v1, c, (100, 0, 1), causal, "highest")
        got = fold(q, k2, v2, mid, (100, 200, 1), causal, "highest")
        want = fold(q, torch.cat([k1, k2]), torch.cat([v1, v2]), c,
                    (100, 0, 1), causal, "highest", plain=True)
        close(f"chain of two folds causal={causal}", "float32 highest", got,
              want)
        n_cases += 1
    # (L, H, d) with H=4: one launch over the heads, no copy
    for dtype, precision in ((torch.float32, "highest"),
                             (torch.bfloat16, "default")):
        q, k, v = (rand((333, 4, 64), dtype) for _ in range(3))
        before = hand.flash_attention_block.launches
        got = hand.flash_attention(q, k, v, causal=True, precision=precision)
        if hand.flash_attention_block.launches != before + 1:
            failures.append("flash (L, H, d): not one launch")
        want = hand.flash_attention_ref(q, k, v, causal=True)
        err = float((got.float() - want.float()).abs().max())
        # in q's dtype: a bf16 output adds its own rounding (half an ulp)
        tol = (FLASH_ATOL if precision == "highest" else
               FLASH_DEFAULT_ATOL["bfloat16"]
               + 2.0**-9 * float(want.float().abs().max()))
        if not err <= tol:
            failures.append(f"flash (L, 4, d) {dtype} {precision}: "
                            f"{err:g} beyond {tol:g}")
        note(f"(L, H, d) {str(dtype).split('.')[1]} {precision}", err)
        n_cases += 1
    # the main path's operands, from the fresh carry as flash_attention
    # starts it
    main = {}
    for L, dtype, causal, precision in (
            (ATTN_L, torch.float32, False, "highest"),
            (ATTN_L, torch.float32, True, "highest"),
            (ATTN_L, torch.bfloat16, False, "default"),
            (ATTN_L_LONG, torch.bfloat16, True, "default")):
        q, k, v = (rand((L, ATTN_D), dtype) for _ in range(3))
        c = carry(L, ATTN_D, fresh=True)
        name = f"main-path {L}x{ATTN_D} {dtype} causal={causal} {precision}"
        want = fold(q, k, v, c, (0, 0, 1), causal, "highest", plain=True,
                    k_tile=4096)
        got = fold(q, k, v, c, (0, 0, 1), causal, precision)
        if precision == "highest":
            close(name, "main-path highest", got, want)
        else:
            normalised_close(name, "main-path default", got, want, dtype)
        main[name] = float((got[2] / got[1] - want[2] / want[1]).abs().max())
        n_cases += 1
        del q, k, v, c, got, want
        torch.cuda.empty_cache()
    torch.cuda.synchronize(device)
    log(f"FLASH_ERRORS largest per class {json.dumps(errs)}")
    log(f"FLASH_ERRORS main path (normalised output) {json.dumps(main)}")
    return n_cases, errs, main


def drive_path(path, fn, kernels, peaks):
    """Run one main path with every launch count set to 0 just before and
    read just after; fail unless each of ``kernels`` launched in it.
    Records the path's peak device memory in ``peaks``. Returns (fn's
    result, the path's counts)."""
    import torch

    from tpu_mpi_tests_torch.kernels import hand

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    hand.reset_launch_counts()
    result = fn()
    counts = hand.launch_counts()
    peaks[path] = torch.cuda.max_memory_allocated()
    for name in kernels:
        if counts[name] <= 0:
            raise SmokeFailure(f"kernel {name} was never launched on the "
                               f"{path} path")
    return result, counts


def drive_driver(path, module, argv, kernels, needed, peaks):
    """Run a driver's ``main(argv)`` as one main path (:func:`drive_path`)
    with its output captured and logged; fail unless it exits 0 with no
    FAIL line and prints each of ``needed``. Returns the path's counts."""
    log(f"DRIVER python -m {module.__name__} " + " ".join(argv))

    def run():
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = module.main(argv)
        return rc, out.getvalue()

    (rc, text), counts = drive_path(path, run, kernels, peaks)
    for line in text.splitlines():
        log(f"  {line}")
    if rc != 0 or "FAIL" in text:
        raise SmokeFailure(f"{path} driver failed (rc={rc})")
    for want in needed:
        if want not in text:
            raise SmokeFailure(f"{path} output lacks {want!r}")
    return counts


def check_per_timestep(path, name, launches, timesteps, want):
    """Launches per timestep measured on a path, held against what its
    schedule makes (S launches per k timesteps on S blocks, one per k on
    a single buffer, one derivative per driver iteration)."""
    got = launches / timesteps
    if abs(got - want) > 1e-12:
        raise SmokeFailure(f"{path}: {name} made {launches} launches in "
                           f"{timesteps} timesteps ({got:g} per timestep), "
                           f"its schedule makes {want:g}")
    return got


def run_main_path(device):
    """Phase 4: the bench in each dtype and the driver, each path with
    the counts zeroed just before it and read just after. Returns
    (counts per path, launches per timestep per path, bench records)."""
    from tpu_mpi_tests_torch import bench
    from tpu_mpi_tests_torch.comm import halo as H
    from tpu_mpi_tests_torch.drivers import heat2d, stencil2d, stencil2d_grid

    # the bench's default schedules at the headline size, one dtype per
    # run so each has counts of its own, whatever the caller's
    # environment selects
    for var in [v for v in os.environ if v.startswith("TPU_MPI_BENCH_")]:
        del os.environ[var]
    os.environ.update({
        "TPU_MPI_BENCH_N": str(BENCH_N),
        "TPU_MPI_BENCH_SECOND_DTYPE": "none",
        "TPU_MPI_BENCH_ITERS_SHORT": str(BENCH_ITERS_SHORT),
        "TPU_MPI_BENCH_ITERS_LONG": str(BENCH_ITERS_LONG),
        "TPU_MPI_BENCH_SAMPLES": str(BENCH_SAMPLES),
    })
    counts, per_step, recs, peaks = {}, {}, {}, {}
    for dtype in ("float32", "bfloat16"):
        path = f"bench {dtype}"
        os.environ["TPU_MPI_BENCH_DTYPE"] = dtype

        def run_bench():
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rec = bench.main(["--device", device.type])
            log(f"BENCH {out.getvalue().strip().splitlines()[-1]}")
            return rec

        rec, counts[path] = drive_path(path, run_bench,
                                       ["stencil2d_iterate"], peaks)
        if rec.get("tier") != "blocks" or not rec.get("value", 0) > 0:
            raise SmokeFailure(f"{path}: not a measured blocks-tier run: "
                               f"{rec}")
        # chain_rate runs 3 warm calls, then n_short and n_long calls per
        # sample; each call advances k timesteps (bench.measure)
        k = rec["steps"]
        n_short = max(1, BENCH_ITERS_SHORT // k)
        n_long = max(n_short + 1, BENCH_ITERS_LONG // k)
        timesteps = BENCH_SAMPLES * (3 + n_short + n_long) * k
        n_blocks = (H.PRIOR_BLOCKS[dtype]
                    if rec["schedule"].startswith("blocks") else 1)
        per_step[path] = {"stencil2d_iterate": check_per_timestep(
            path, "stencil2d_iterate", counts[path]["stencil2d_iterate"],
            timesteps, n_blocks / k)}
        recs[dtype] = rec

    path = "stencil2d"
    argv = ["--device", device.type, "--n-local", str(REF_N_LOCAL),
            "--n-other", str(REF_N_OTHER),
            "--n-iter", str(DRIVER_N_ITER), "--n-warmup",
            str(DRIVER_N_WARMUP), "--kernel", "hand",
            "--iterate-tier", "blocks", "--iterate-steps", "4",
            "--iterate-iters", str(DRIVER_ITERATE_ITERS)]
    counts[path] = drive_driver(
        path, stencil2d, argv, ["stencil2d_iterate", "stencil2d_deriv"],
        ("TEST dim:0", "TEST dim:1", "ITER ERR rel="), peaks)
    # the iterate leg: one warm call, then --iterate-iters calls, k
    # timesteps each, S blocks; the derivative: dim × buf = 4 tests of
    # n_warmup + n_iter iterations, one launch each
    k = 4
    n_blocks = H.PRIOR_BLOCKS["float32"]
    per_step[path] = {
        "stencil2d_iterate": check_per_timestep(
            path, "stencil2d_iterate", counts[path]["stencil2d_iterate"],
            (1 + DRIVER_ITERATE_ITERS) * k, n_blocks / k),
        "stencil2d_deriv": check_per_timestep(
            path, "stencil2d_deriv", counts[path]["stencil2d_deriv"],
            4 * (DRIVER_N_WARMUP + DRIVER_N_ITER), 1.0),
    }

    # the heat mini-app: one launch per outer body of k timesteps
    for dtype, k in HEAT_RUNS:
        path = f"heat2d {dtype} k={k}"
        argv = ["--device", device.type, "--kernel", "hand", "--mesh", "1,1",
                "--nx-local", str(GRID_N), "--ny-local", str(GRID_N),
                "--n-steps", str(HEAT_N_STEPS), "--halo-steps", str(k),
                "--dtype", dtype]
        counts[path] = drive_driver(path, heat2d, argv, ["heat2d"],
                                    ("HEAT mesh:1x1", "HEAT ERR rel="),
                                    peaks)
        per_step[path] = {"heat2d": check_per_timestep(
            path, "heat2d", counts[path]["heat2d"], HEAT_N_STEPS, 1 / k)}

    # the 2-D grid step: one dual-step launch per iteration
    path = "stencil2d_grid"
    argv = ["--device", device.type, "--kernel", "hand", "--mesh", "1,1",
            "--nx-local", str(GRID_N), "--ny-local", str(GRID_N),
            "--n-iter", str(GRID_N_ITER), "--n-warmup", str(GRID_N_WARMUP)]
    counts[path] = drive_driver(path, stencil2d_grid, argv,
                                ["dual_dim_step"],
                                ("GRID TEST px:1 py:1", "step mean="),
                                peaks)
    per_step[path] = {"dual_dim_step": check_per_timestep(
        path, "dual_dim_step", counts[path]["dual_dim_step"],
        GRID_N_ITER + GRID_N_WARMUP, 1.0)}

    recs["microbench"] = run_daxpy_slice(device, counts, peaks)
    recs["attention"] = run_attention_slice(device, counts, peaks)
    recs["one_card"] = run_one_card_slice(device, counts, peaks)
    # the staged legs of the stencil2d driver were handed the pack/unpack
    # kernels; its non-periodic world=1 exchange moves nothing
    for name in ("pack_edges", "unpack_ghosts"):
        if counts["stencil2d"][name]:
            raise SmokeFailure(f"stencil2d: {name} launched "
                               f"{counts['stencil2d'][name]} times on a "
                               f"non-periodic world=1 exchange")

    log(f"LAUNCHES {json.dumps(counts)}")
    log(f"LAUNCHES_PER_TIMESTEP {json.dumps(per_step)}")
    log(f"PEAK_BYTES {json.dumps(peaks)}")
    return counts, per_step, recs


def run_daxpy_slice(device, counts, peaks):
    """The DAXPY slice's paths: the three microbench groups (each must
    launch exactly what its schedule makes, every GB/s row finite and at
    most ``GBPS_CAP``), then the five DAXPY drivers (every gate passing,
    no hand kernel launched). Fills ``counts``/``peaks`` per path and
    returns the microbench records."""
    import importlib

    from tpu_mpi_tests_torch import microbench

    records = []
    for group, want in MICROBENCH_LAUNCHES.items():
        path = f"microbench {group}"

        def run(group=group):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                recs = microbench.run_groups([group], device)
            for line in out.getvalue().splitlines():
                log(f"  {line}")
            return recs

        recs, counts[path] = drive_path(
            path, run, [k for k, v in want.items() if v], peaks)
        got = {k: counts[path][k] for k in want}
        if got != want:
            raise SmokeFailure(f"{path}: launches {got}, its schedule "
                               f"makes {want}")
        for r in recs:
            v = r["value"]
            if r["unit"] == "GB/s" and not 0 < v <= GBPS_CAP:
                raise SmokeFailure(f"{path}: {r['metric']} = {v} GB/s is "
                                   f"not finite in (0, {GBPS_CAP:g}]")
        records += recs

    for path, name, argv, needed in DAXPY_DRIVERS:
        module = importlib.import_module(
            f"tpu_mpi_tests_torch.drivers.{name}")
        counts[path] = drive_driver(path, module,
                                    ["--device", device.type] + argv, [],
                                    needed, peaks)
        if any(counts[path].values()):
            raise SmokeFailure(f"{path}: the DAXPY drivers launch no hand "
                               f"kernel (parity with the JAX drivers), "
                               f"got {counts[path]}")
    return records


def check_one_card_rates(path, recs):
    """Every rate row of a one-card group: finite and positive, or NaN
    where the row's own fit gate said so (the ``vpu_*_gops`` and
    ``roofline_*``/``dualdim_lean_gain_*`` rows: at the JAX sizes the
    heat and dual-step chains are host-bound on a fast card); no GB/s row above
    ``GBPS_CAP``; no probe row above 1.05 × 67 TFLOP/s counted in the
    instructions it issues."""
    import math

    from tpu_mpi_tests_torch.kernels import hand

    for r in recs:
        v, metric = r["value"], r["metric"]
        gated = (metric.endswith(("_gops", "_ceiling", "_marginal_ps"))
                 or metric.startswith(("dualdim_lean_gain_",
                                       "roofline_heat_")))
        if gated and math.isnan(v):
            log(f"  NOTE {path}: {metric} is NaN by its fit gate: "
                f"{r.get('detail', '')[:160]}")
            continue
        if not (math.isfinite(v) and v > 0):
            raise SmokeFailure(f"{path}: {metric} = {v} is not a finite "
                               f"positive value")
        if r["unit"] == "GB/s" and v > GBPS_CAP:
            raise SmokeFailure(f"{path}: {metric} = {v} GB/s above "
                               f"{GBPS_CAP:g}")
        if r["unit"] == "Gop/s":
            mix = next(m for m in sorted(hand.ALU_PROBE_MIXES, key=len,
                                         reverse=True)
                       if metric.startswith(f"vpu_{m}_"))
            nominal = int(r["detail"].split("nominal ")[1].split()[0])
            issued = v * hand.ALU_PROBE_REAL_OPS[mix] / nominal  # Gop/s
            if issued > 1.05 * F32_FLOPS_PER_S / 1e9:
                raise SmokeFailure(f"{path}: {metric} issues {issued:g} "
                                   f"Gop/s, above 1.05x the float32 peak")


def run_one_card_slice(device, counts, peaks):
    """The one-card slice's paths, each alone: the microbench groups
    ``vpu``, ``roofline2``, ``stencil``, ``iterate``, ``splitfused``,
    ``blocks`` and ``heat`` (exact launch counts, rate checks), the
    periodic hand-staged exchange on both axes against DIRECT, and the
    ``stencil1d`` driver. Returns the microbench records."""
    import torch

    from tpu_mpi_tests_torch import microbench
    from tpu_mpi_tests_torch.comm import halo as H
    from tpu_mpi_tests_torch.drivers import stencil1d
    from tpu_mpi_tests_torch.kernels import hand

    os.environ.pop("TPU_MPI_VPU_STEP5FMA", None)
    sizes = {"vpu": {"iters": SMOKE_PROBE_ITERS},
             "roofline2": {"iters": SMOKE_PROBE_ITERS},
             "roofline2 large": {"iters": SMOKE_PROBE_ITERS,
                                 **ROOFLINE_LARGE}}
    records = []
    for name, want in one_card_launches().items():
        path = f"microbench {name}"
        group = name.split()[0]

        def run(group=group, name=name):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                recs = microbench.run_groups(
                    [group], device, **{group: sizes.get(name, {})})
            for line in out.getvalue().splitlines():
                log(f"  {line}")
            return recs

        t0 = time.perf_counter()
        recs, counts[path] = drive_path(path, run, list(want), peaks)
        want_all = dict.fromkeys(counts[path], 0) | want
        if counts[path] != want_all:
            raise SmokeFailure(f"{path}: launches {counts[path]}, its "
                               f"schedule makes {want_all}")
        check_one_card_rates(path, recs)
        log(f"  {path}: {time.perf_counter() - t0:.1f} s")
        records += recs

    # the periodic self-ring exchange, DEVICE_STAGED through the hand
    # pack/unpack kernels, against DIRECT on the same field
    gen = torch.Generator(device=device).manual_seed(4321)
    for shape, axis in STAGED_CASES:
        path = f"staged exchange {shape[0]}x{shape[1]} axis {axis}"
        z = torch.randn(shape, generator=gen, device=device)

        def run(z=z, axis=axis):
            got = z.clone()
            for _ in range(STAGED_EXCHANGES):
                got = H.halo_exchange(got, axis, 2, True, "device",
                                      kernel="hand")
            torch.cuda.synchronize(device)
            return got

        got, counts[path] = drive_path(path, run,
                                       ["pack_edges", "unpack_ghosts"],
                                       peaks)
        want = dict.fromkeys(counts[path], 0) | {
            "pack_edges": STAGED_EXCHANGES, "unpack_ghosts": STAGED_EXCHANGES}
        if counts[path] != want:
            raise SmokeFailure(f"{path}: launches {counts[path]}, one pack "
                               f"and one unpack per exchange make {want}")
        direct = H.halo_exchange(z.clone(), axis, 2, True, "direct")
        if not torch.equal(got, direct) or torch.equal(got, z):
            raise SmokeFailure(f"{path}: the hand-staged exchange differs "
                               f"from DIRECT")
        nbytes = H.halo_payload_bytes(z, axis, 1, 2, True)
        log(f"STAGED {path}: {STAGED_EXCHANGES} exchanges equal DIRECT bit "
            f"for bit, payload {nbytes} B each")
        del z, got, direct
        torch.cuda.empty_cache()

    for dtype in ("float32", "float64"):
        path = f"stencil1d {dtype}"
        counts[path] = drive_driver(
            path, stencil1d, ["--device", device.type, "--n-global",
                              str(STENCIL1D_N), "--dtype", dtype], [],
            ("0/1 exchange time ", "err_norm = "), peaks)
        if any(counts[path].values()):
            raise SmokeFailure(f"{path}: the 1-D stencil driver launches no "
                               f"hand kernel (parity with the JAX driver), "
                               f"got {counts[path]}")
    return records


def attn_peak(dtype: str, fast: bool, tier: str) -> float:
    """The peak of the arithmetic an attnbench row runs: DEFAULT (--fast)
    puts float32 on TF32 and bf16 on the bf16 tensor cores; HIGHEST runs
    the flash kernel in f32 on the CUDA cores, and torch's matmul (the
    xla tier) in f32 for float32 and on the bf16 tensor cores for bf16."""
    if fast:
        return PEAK_FLOPS["tf32" if dtype == "float32" else "bf16"]
    if tier == "xla" and dtype == "bfloat16":
        return PEAK_FLOPS["bf16"]
    return PEAK_FLOPS["f32"]


def check_rate(path, name, tflops, peak):
    cap = 1.05 * peak / 1e12
    if not 0 < tflops <= cap:
        raise SmokeFailure(f"{path}: {name} = {tflops} TFLOP/s is not "
                           f"finite in (0, {cap:g}] (1.05x its peak)")


def run_attention_slice(device, counts, peaks):
    """The attention slice's paths, each alone: attnbench at L=8192,
    d=128 (float32; causal; bfloat16 --fast; the striped causal ring) and
    the microbench groups ``attention`` and ``causal`` at the JAX sizes.
    Each must launch the flash kernel exactly as its schedule makes,
    print no FAIL, and keep every TFLOP/s row finite and at most 1.05x
    the peak of its arithmetic. Returns the microbench records."""
    import re

    from tpu_mpi_tests_torch import microbench
    from tpu_mpi_tests_torch.drivers import attnbench

    line_re = re.compile(r"^ATTN (\w+)(\[striped\])? L=\d+ d=\d+ (\w+) "
                         r"(\S+) TFLOP/s$")
    for path, extra, n_flash_tiers in ATTNBENCH_PATHS:
        argv = ["--device", device.type] + _ATTN_ARGV + extra
        fast = "--fast" in extra
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            counts[path] = drive_driver(path, attnbench, argv,
                                        ["flash_attention_block"],
                                        ("ATTN ",), peaks)
        text = out.getvalue()
        for line in text.splitlines():
            log(line)
        want = n_flash_tiers * ATTN_CALLS
        got = counts[path]["flash_attention_block"]
        if got != want:
            raise SmokeFailure(f"{path}: {got} flash launches, its schedule "
                               f"makes {want} ({n_flash_tiers} flash tiers "
                               f"x {ATTN_CALLS} calls)")
        # drive_driver logged the driver's lines indented, into ``out``
        rows = [line_re.match(ln.strip()) for ln in text.splitlines()
                if ln.strip().startswith("ATTN ")]
        if not rows or not all(rows):
            raise SmokeFailure(f"{path}: malformed ATTN lines")
        for r in rows:
            check_rate(path, f"ATTN {r[1]}", float(r[4]),
                       attn_peak(r[3], fast, r[1]))

    records = []
    for group, want in ATTN_MICROBENCH_LAUNCHES.items():
        path = f"microbench {group}"

        def run(group=group):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                recs = microbench.run_groups([group], device)
            for line in out.getvalue().splitlines():
                log(f"  {line}")
            return recs

        recs, counts[path] = drive_path(path, run,
                                        ["flash_attention_block"], peaks)
        got = counts[path]["flash_attention_block"]
        if got != want:
            raise SmokeFailure(f"{path}: {got} flash launches, its schedule "
                               f"makes {want}")
        for r in recs:
            if r["unit"] == "TFLOP/s":  # DEFAULT: TF32 or bf16
                peak = PEAK_FLOPS["tf32" if "float32" in r["metric"]
                                  else "bf16"]
                check_rate(path, r["metric"], r["value"], peak)
            else:  # ms/attn, bf16 DEFAULT, "useful <x> TFLOP/s"
                useful = float(re.search(r"useful (\S+) TFLOP/s",
                                         r["detail"])[1])
                check_rate(path, r["metric"], useful, PEAK_FLOPS["bf16"])
        records += recs
    return records


def time_cuda(fn, n_iter: int) -> float:
    """Mean milliseconds per call of ``fn`` (warmed), CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n_iter):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n_iter


def time_cuda_queued(fn, n_iter: int, stall_ms: float = 20.0) -> float:
    """Mean device milliseconds per call of ``fn`` with the host taken
    out: the stream is stalled first (a spin kernel of ``stall_ms``), so
    the ``n_iter`` calls' launches queue up behind it and then run back
    to back between the two events. For kernels shorter than their
    wrapper's host cost, where :func:`time_cuda` would time the host."""
    import torch

    fn()
    torch.cuda.synchronize()
    khz = getattr(torch.cuda.get_device_properties(0), "clock_rate", 1.7e6)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(stall_ms * khz))
    start.record()
    for _ in range(n_iter):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n_iter


def iterate_work(shape, dtype, dim, steps, flags):
    """(bytes, flops) the k-step update needs: the array read once and
    written once; 7 flops per updated point per step (spans from the
    flags, as the kernel computes them)."""
    import torch

    n, m = shape[dim], shape[1 - dim]
    itemsize = torch.empty((), dtype=dtype).element_size()
    K = 2 * steps
    updated = 0
    for s in range(1, steps + 1):
        lo = K if flags[0] else 2 * s
        hi = n - (K if flags[1] else 2 * s)
        updated += max(0, hi - lo) * m
    return 2 * shape[0] * shape[1] * itemsize, 7 * updated


def deriv_work(shape, dtype, dim):
    import torch

    itemsize = torch.empty((), dtype=dtype).element_size()
    out = list(shape)
    out[dim] -= 4
    n_out = out[0] * out[1]
    return (shape[0] * shape[1] + n_out) * itemsize, 8 * n_out


def heat_work(shape, dtype, steps):
    """(bytes, flops) of a k-step heat launch: the shard read once and
    written once; 9 flops per updated cell ([1, n0−1) × [1, n1−1)) per
    step."""
    import torch

    itemsize = torch.empty((), dtype=dtype).element_size()
    updated = (shape[0] - 2) * (shape[1] - 2)
    return 2 * shape[0] * shape[1] * itemsize, 9 * updated * steps


def dual_work(shape, dtype, lean=False):
    """(bytes, flops) of a dual step: the block read once, both
    (n0−4, n1−4) derivatives written once (the residual scalar is
    negligible); per output point 8 flops per derivative (5 in the lean
    body) and 4 for the two squares and their sums."""
    import torch

    itemsize = torch.empty((), dtype=dtype).element_size()
    n_out = (shape[0] - 4) * (shape[1] - 4)
    return ((shape[0] * shape[1] + 2 * n_out) * itemsize,
            (14 if lean else 20) * n_out)


def bound_ms(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_kernels(device):
    """Phase 5: per-launch times at the main-path shapes."""
    import torch
    import torch.nn.functional as F

    from tpu_mpi_tests_torch.kernels import hand
    from tpu_mpi_tests_torch.kernels.stencil import STENCIL5

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(99)
    rows = {}

    def iterate_row(path, shape, dtype, dim, flags, se):
        z = torch.randn(shape, generator=gen, device=device).to(dtype)
        out = torch.empty_like(z)
        ms = time_cuda(lambda: hand.stencil2d_iterate(
            z, se, dim=dim, steps=4, phys_static=flags, out=out), 50)
        plain = time_cuda(lambda: hand.stencil2d_iterate_ref(
            z, se, dim=dim, steps=4, phys_static=flags), 5)
        b, why = bound_ms(*iterate_work(shape, dtype, dim, 4, flags))
        return {"path": path, "shape": list(shape),
                "dtype": str(dtype).split(".")[1], "dim": dim, "steps": 4,
                "phys_static": list(flags), "ms": ms, "plain_ms": plain,
                "bound_ms": b, "bound_by": why, "library_ms": None}

    def deriv_row(shape, dtype, dim):
        z = torch.randn(shape, generator=gen, device=device).to(dtype)
        scale = 128.0
        out_shape = list(shape)
        out_shape[dim] -= 4
        out = torch.empty(out_shape, device=device, dtype=dtype)
        ms = time_cuda(lambda: hand.stencil2d_deriv(z, scale, dim=dim,
                                                    out=out), 20)
        plain = time_cuda(lambda: hand.stencil2d_deriv_ref(z, scale,
                                                           dim=dim), 5)
        w = torch.tensor(STENCIL5 * scale, dtype=dtype, device=device)
        w = w.reshape(1, 1, 5, 1) if dim == 0 else w.reshape(1, 1, 1, 5)
        lib_out = F.conv2d(z[None, None], w)[0, 0]
        if lib_out.shape != out.shape:
            raise SmokeFailure("conv2d yardstick shape mismatch")
        lib = time_cuda(lambda: F.conv2d(z[None, None], w), 10)
        b, why = bound_ms(*deriv_work(shape, dtype, dim))
        return {"path": "stencil2d", "shape": list(shape),
                "dtype": str(dtype).split(".")[1], "dim": dim, "ms": ms,
                "plain_ms": plain, "bound_ms": b, "bound_by": why,
                "library_ms": lib}

    def heat_row(path, shape, dtype, k, cx, cy):
        z = torch.randn(shape, generator=gen, device=device).to(dtype)
        out = torch.empty_like(z)
        ms = time_cuda(lambda: hand.heat2d(z, cx, cy, steps=k, out=out), 50)
        plain = time_cuda(lambda: hand.heat2d_ref(z, cx, cy, steps=k), 5)
        b, why = bound_ms(*heat_work(shape, dtype, k))
        return {"path": path, "shape": list(shape),
                "dtype": str(dtype).split(".")[1], "steps": k, "ms": ms,
                "plain_ms": plain, "bound_ms": b, "bound_by": why,
                "library_ms": None}

    def dual_row(shape, dtype, lean=False):
        z = torch.randn(shape, generator=gen, device=device).to(dtype)
        s = GRID_SCALE
        ms = time_cuda(lambda: hand.dual_dim_step(z, 2, s, s, lean=lean), 20)
        plain = time_cuda(lambda: hand.dual_dim_step_ref(z, 2, s, s,
                                                         lean=lean), 5)
        # the yardstick: both derivatives from one cross-shaped (2,1,5,5)
        # convolution, valid padding (no residual)
        w = torch.zeros((2, 1, 5, 5), dtype=torch.float64)
        w[0, 0, :, 2] = torch.from_numpy(STENCIL5 * s)
        w[1, 0, 2, :] = torch.from_numpy(STENCIL5 * s)
        w = w.to(device=device, dtype=dtype)
        lib_out = F.conv2d(z[None, None], w)[0]
        if tuple(lib_out.shape) != (2, shape[0] - 4, shape[1] - 4):
            raise SmokeFailure("dual-step conv2d yardstick shape mismatch")
        del lib_out
        lib = time_cuda(lambda: F.conv2d(z[None, None], w), 10)
        b, why = bound_ms(*dual_work(shape, dtype, lean))
        return {"path": ("microbench roofline2" if lean
                         else "stencil2d_grid"),
                "body": "lean" if lean else "raw", "shape": list(shape),
                "dtype": str(dtype).split(".")[1], "ms": ms,
                "plain_ms": plain, "bound_ms": b, "bound_by": why,
                "library_ms": lib,
                "library_call": "F.conv2d (2,1,5,5) cross weight, TF32 off; "
                                "both derivatives, no residual"}

    # one row per distinct schedule: bench f32 block 0, bench bf16, the
    # driver's periodic block
    rows["stencil2d_iterate"] = []
    for i in (0, 2, 3):
        rows["stencil2d_iterate"].append(iterate_row(*iterate_cases()[i]))
        torch.cuda.empty_cache()
    rows["stencil2d_deriv"] = [
        deriv_row((REF_N_LOCAL + 4, REF_N_OTHER), torch.float32, 0),
        deriv_row((REF_N_LOCAL, REF_N_OTHER + 4), torch.float32, 1),
        deriv_row((REF_N_LOCAL + 4, REF_N_OTHER), torch.bfloat16, 0),
    ]
    torch.cuda.empty_cache()
    rows["heat2d"] = []
    for case in heat_cases():
        rows["heat2d"].append(heat_row(*case))
        torch.cuda.empty_cache()
    rows["dual_dim_step"] = [
        dual_row((GRID_N + 4, GRID_N + 4), dtype, lean=lean)
        for dtype in (torch.float32, torch.bfloat16)
        for lean in (False, True)]
    torch.cuda.empty_cache()
    rows.update(time_probe_and_pack(device, gen))
    rows.update(time_stream_kernels(device, gen))
    rows["flash_attention_block"] = time_flash_kernel(device, gen)
    for name, rs in rows.items():
        for r in rs:
            log(f"TIME {name} {json.dumps(r)}")
    return rows


def band_sectors(shape, axis, n_bnd, itemsize, starts):
    """Bytes the strided side of a pack or unpack moves, counted in whole
    32-byte sectors touched: along axis 0 a band is contiguous (its own
    bytes); along axis 1 each row's ``n_bnd`` elements cost every sector
    they touch."""
    import numpy as np

    n0, n1 = shape
    if axis == 0:
        return len(starts) * n_bnd * n1 * itemsize
    rows = np.arange(n0, dtype=np.int64)
    total = 0
    for start in starts:
        first = (rows * n1 + start) * itemsize
        last = first + n_bnd * itemsize - 1
        total += int((last // SECTOR - first // SECTOR + 1).sum()) * SECTOR
    return total


def time_probe_and_pack(device, gen):
    """Per-launch times of the probe at the main path's (B, 512, 512)
    stack — float32 per mix at the middle of its reps triple, and the
    bfloat16 ``step5_d1`` the vpu group holds the bf16 kernel against —
    with its bound (operations issued over 67 TFLOP/s against the stack
    read and written once over 3.35 TB/s) and its plain version (no
    library call computes it); and of pack and unpack at the staged
    exchange's operands, with the byte bound (the strided side counted
    in 32-byte sectors touched), the plain version and the one-call
    yardsticks ``torch.stack`` of the two ``narrow``s and two
    ``copy_``. These copies are shorter than their wrappers' host cost,
    so they are timed queued behind a stall (:func:`time_cuda_queued`);
    ``ms_host_loop`` is the plain loop's time, which is the host's."""
    import torch

    from tpu_mpi_tests_torch.kernels import hand

    B = probe_batch(device)
    shape = (B, PROBE_HW, PROBE_HW)
    elems = B * PROBE_HW * PROBE_HW
    rows = {"alu_probe": [], "pack_edges": [], "unpack_ghosts": []}
    cases = [("step5_d0", torch.float32, 1024), ("fma", torch.float32, 2048),
             ("step5_d1", torch.float32, 256), ("heat5", torch.float32, 256),
             ("dualdim", torch.float32, 128),
             ("dualdim_lean", torch.float32, 128),
             ("step5_d1", torch.bfloat16, 256)]
    for mix, dtype, reps in cases:
        z = torch.randn(shape, generator=gen, device=device).to(dtype)
        ms = time_cuda(lambda: hand.alu_probe(z, reps, mix), 10)
        plain = time_cuda(lambda: hand.alu_probe_ref(z, reps, mix), 1)
        ops = hand.ALU_PROBE_REAL_OPS[mix] * elems * reps
        b, why = bound_ms(2 * elems * z.element_size(), ops)
        rows["alu_probe"].append({
            "path": "microbench vpu/roofline2", "shape": list(shape),
            "dtype": str(dtype).split(".")[1], "mix": mix, "reps": reps,
            "ctas": hand.alu_probe.last_ctas, "ms": ms,
            "us_per_rep": 1e3 * ms / reps, "plain_ms": plain, "bound_ms": b,
            "bound_by": why, "library_ms": None,
            "issued_gops": ops / ms / 1e6,
            "where": "two L2-resident ping-pong buffers in global memory, "
                     "one cooperative launch, a grid barrier per rep"})
        del z
    for case_shape, axis in STAGED_CASES:
        z = torch.randn(case_shape, generator=gen, device=device)
        n = case_shape[axis]
        lo, hi = hand.pack_edges(z, axis, 2)
        contiguous = 2 * lo.numel() * 4
        common = {"path": "staged exchange", "shape": list(case_shape),
                  "dtype": "float32", "axis": axis, "n_bnd": 2,
                  "bound_by": "bytes", "bound_counts":
                  "32-byte sectors touched on the strided side"}
        pack_bytes = band_sectors(case_shape, axis, 2, 4,
                                  (2, n - 4)) + contiguous
        rows["pack_edges"].append({
            **common,
            "ms": time_cuda_queued(lambda: hand.pack_edges(z, axis, 2), 20),
            "ms_host_loop": time_cuda(lambda: hand.pack_edges(z, axis, 2),
                                      20),
            "plain_ms": time_cuda_queued(
                lambda: hand.pack_edges_ref(z, axis, 2), 20),
            "bound_ms": pack_bytes / HBM_BYTES_PER_S * 1e3,
            "library_ms": time_cuda_queued(lambda: torch.stack(
                (z.narrow(axis, 2, 2), z.narrow(axis, n - 4, 2))), 20),
            "library_call": "torch.stack of the two narrows"})
        unpack_bytes = band_sectors(case_shape, axis, 2, 4,
                                    (0, n - 2)) + contiguous
        rows["unpack_ghosts"].append({
            **common,
            "ms": time_cuda_queued(
                lambda: hand.unpack_ghosts(z, lo, hi, axis, 2), 20),
            "ms_host_loop": time_cuda(
                lambda: hand.unpack_ghosts(z, lo, hi, axis, 2), 20),
            "plain_ms": time_cuda_queued(lambda: hand.unpack_ghosts_ref(
                z, lo, hi, axis, 2), 20),
            "bound_ms": unpack_bytes / HBM_BYTES_PER_S * 1e3,
            "library_ms": time_cuda_queued(lambda: (
                z.narrow(axis, 0, 2).copy_(lo),
                z.narrow(axis, n - 2, 2).copy_(hi)), 20),
            "library_call": "two copy_ into the narrows"})
        del z, lo, hi
        torch.cuda.empty_cache()
    return rows


def time_stream_kernels(device, gen):
    """Per-launch times of the streaming kernels in place (``out`` = the
    written operand, as the chained microbench rows launch them) at the
    microbench's sizes, beside the plain version, the one-call torch
    yardstick (``y.add_(x, alpha=a)``, ``x.mul_(a)``; none for sum3) and
    the byte bound; the 2^26 daxpy row also carries ``dispatch_rate``'s
    host-clock time of the same launch, to check that clock."""
    import torch

    from tpu_mpi_tests_torch.instrument.timers import dispatch_rate
    from tpu_mpi_tests_torch.kernels import hand

    rows = {name: [] for name in STREAM_KERNELS}
    a = 1e-7

    def rand(n):
        return torch.rand(n, generator=gen, device=device) + 1.0

    flops_per_elt = {"daxpy": 2, "stream_scale": 1, "stream_sum3": 2}

    def row(name, n, streams, ms, plain, lib, **extra):
        # each stream read or written once; the ops of the table row
        b, why = bound_ms(streams * n * 4, flops_per_elt[name] * n)
        rows[name].append({"path": "microbench", "shape": [n],
                           "dtype": "float32", "inplace": True, "ms": ms,
                           "plain_ms": plain, "bound_ms": b, "bound_by": why,
                           "library_ms": lib, **extra})

    for n in (N26, N28):
        x, y = rand(n), rand(n)
        ms = time_cuda(lambda: hand.daxpy(a, x, y, out=y), 50)
        plain = time_cuda(lambda: hand.daxpy_ref(a, x, y), 10)
        lib = time_cuda(lambda: y.add_(x, alpha=a), 50)
        extra = {}
        if n == N26:
            extra["dispatch_rate_ms"] = 1e3 * dispatch_rate(
                lambda: hand.daxpy(a, x, y, out=y), n_iter=1000,
                n_base=100)
        row("daxpy", n, 3, ms, plain, lib,
            library_call="y.add_(x, alpha=a)", **extra)
        del x, y
        torch.cuda.empty_cache()
    x = rand(N26)
    row("stream_scale", N26, 2,
        time_cuda(lambda: hand.stream_scale(1.0, x, out=x), 50),
        time_cuda(lambda: hand.stream_scale_ref(1.0, x), 10),
        time_cuda(lambda: x.mul_(1.0), 50), library_call="x.mul_(a)")
    w, y = rand(N26), rand(N26)
    row("stream_sum3", N26, 4,
        time_cuda(lambda: hand.stream_sum3(w, x, y, out=y), 50),
        time_cuda(lambda: hand.stream_sum3_ref(w, x, y), 10), None)
    del w, x, y
    torch.cuda.empty_cache()
    return rows


def flash_work(L, d, dtype, causal):
    """(bytes, flops) one fold needs on self-attention operands (L, d):
    q, k, v read once and the f32 carry (m, l, acc) read and written
    once; 4·d flops per live (query, key) pair — all L² of them, or the
    L·(L+1)/2 on or below the diagonal when causal."""
    import torch

    itemsize = torch.empty((), dtype=dtype).element_size()
    pairs = L * (L + 1) // 2 if causal else L * L
    return 3 * L * d * itemsize + 2 * 4 * (2 * L + L * d), 4 * d * pairs


def time_flash_kernel(device, gen):
    """The flash kernel at the main path's shapes, CUDA events (warmed):
    (8192, 128) f32 HIGHEST non-causal and causal, (8192, 128) bf16
    DEFAULT, (32768, 128) bf16 DEFAULT causal — one fold from the fresh
    carry into a second buffer (the same work every launch) — beside its
    plain version at the same precision, the bound (flops over the peak
    of the arithmetic, or bytes over 3.35 TB/s) and
    ``F.scaled_dot_product_attention`` on (1, 1, L, d) as the one-call
    yardstick (TF32 off for f32; the port never calls it)."""
    import torch
    import torch.nn.functional as F

    from tpu_mpi_tests_torch.kernels import hand

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    for L, dtype, causal, precision in (
            (ATTN_L, torch.float32, False, "highest"),
            (ATTN_L, torch.float32, True, "highest"),
            (ATTN_L, torch.bfloat16, False, "default"),
            (ATTN_L_LONG, torch.bfloat16, True, "default")):
        d = ATTN_D
        q, k, v = (torch.randn((L, d), generator=gen, device=device)
                   .to(dtype) for _ in range(3))
        kw = {"dtype": torch.float32, "device": device}
        carry = (torch.full((L, 1), float("-inf"), **kw),
                 torch.zeros((L, 1), **kw), torch.zeros((L, d), **kw))
        out = tuple(torch.empty_like(t) for t in carry)
        args = dict(scale=d**-0.5, causal=causal, precision=precision)
        n = 20 if L == ATTN_L else 5
        ms = time_cuda(lambda: hand.flash_attention_block(
            q, k, v, *carry, 0, 0, out=out, **args), n)
        plain = time_cuda(lambda: hand.flash_attention_block_ref(
            q, k, v, *carry, 0, 0, k_tile=4096, **args), 2)
        lib = time_cuda(lambda: F.scaled_dot_product_attention(
            q[None, None], k[None, None], v[None, None], is_causal=causal),
            n)
        nbytes, flops = flash_work(L, d, dtype, causal)
        arith = "f32" if precision == "highest" else (
            "bf16" if dtype == torch.bfloat16 else "tf32")
        t_ops = flops / PEAK_FLOPS[arith] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        rows.append({
            "path": "attnbench/microbench", "shape": [L, d],
            "dtype": str(dtype).split(".")[1], "causal": causal,
            "precision": precision, "arithmetic": arith,
            "ctas": -(-L // hand.FLASH_Q_TILE), "ms": ms, "plain_ms": plain,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": lib,
            "library_call": "F.scaled_dot_product_attention (1,1,L,d)"
                            + (", TF32 off" if dtype == torch.float32
                               else ""),
            "tflops": flops / ms / 1e9})
        del q, k, v, carry, out
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable ({e})", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "smoke test needs a CUDA card", file=sys.stderr)
        return 2
    try:
        from tpu_mpi_tests_torch.kernels import build, hand
    except ImportError as e:
        print(f"chip_smoke: the port package is not importable ({e}); run "
              f"from the repository root", file=sys.stderr)
        return 2

    t0 = time.perf_counter()
    try:
        card = card_line()
        log(f"CARD {card}")
        log(f"TORCH {torch.__version__} CUDA {torch.version.cuda} "
            f"python {sys.version.split()[0]}")
        device = torch.device("cuda", 0)

        tb = time.perf_counter()
        paths = build.build()
        log(f"BUILD {len(paths)} libraries in "
            f"{time.perf_counter() - tb:.1f} s")
        for name, text in build.BUILD_LOGS.items():
            for line in text.splitlines():
                if "registers" in line or "spill" in line or \
                        "error" in line.lower() or (
                            name == "flash_attention"
                            and "Compiling entry" in line):
                    log(f"  ptxas {name}: {line.strip()}")

        errs = check_kernels(device)
        torch.cuda.empty_cache()
        counts, per_step, recs = run_main_path(device)
        torch.cuda.empty_cache()
        rows = time_kernels(device)
        ceiling = next(r["value"] for r in recs["microbench"]
                       if r["metric"] == "hbm_ceiling_fit_gbps")
        log(f"HBM_CEILING measured hbm_ceiling_fit_gbps {ceiling} GB/s, "
            f"published {HBM_BYTES_PER_S / 1e9:g} GB/s "
            f"(ratio {ceiling / (HBM_BYTES_PER_S / 1e9):.4f})")
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1

    kernels = []
    for name, source, replaces in (
            ("stencil2d_iterate", ITERATE_SOURCE, ITERATE_REPLACES),
            ("stencil2d_deriv", DERIV_SOURCE, DERIV_REPLACES),
            ("heat2d", HEAT_SOURCE, HEAT_REPLACES),
            ("dual_dim_step", DUAL_SOURCE, DUAL_REPLACES),
            ("alu_probe", PROBE_SOURCE, PROBE_REPLACES),
            *((name, PACK_SOURCE, PACK_REPLACES[name])
              for name in PACK_REPLACES),
            *((name, STREAMS_SOURCE, STREAM_REPLACES[name])
              for name in STREAM_KERNELS),
            ("flash_attention_block", FLASH_SOURCE, FLASH_REPLACES)):
        main_row = rows[name][0]
        extra = {}
        if name == "flash_attention_block":
            # max_abs_err: the normalised output at the f32 HIGHEST
            # main-path operands; every class and main-path case beside it
            extra = {"also_replaces": FLASH_ALSO_REPLACES,
                     "max_abs_err_by_class":
                         errs["flash_attention_block classes"],
                     "max_abs_err_main_path":
                         errs["flash_attention_block main path"]}
        if name == "dual_dim_step":
            # max_abs_err is the derivatives'; the residual is a sum in
            # another order, held to a relative tolerance
            extra = {"residual_rel_err": errs["dual_dim_step residual "
                                              "(relative)"],
                     "lean_residual_rel_err": errs["dual_dim_step lean "
                                                   "residual (relative)"],
                     "residual_rtol": hand.RESIDUAL_RTOL[torch.float32]}
        if name == "alu_probe":
            # max_abs_err is the bit-exact mixes' (fma, step5*, heat5);
            # the dual mixes feed a sum in another order back and are
            # held to hand.alu_probe_tolerance
            extra = {"dual_mixes": errs["alu_probe dual mixes"]}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(c[name] for c in counts.values()),
            "launches_per_path": {p: c[name] for p, c in counts.items()},
            "launches_per_timestep": {p: s[name]
                                      for p, s in per_step.items()
                                      if name in s},
            "max_abs_err": errs[name],
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            "variants": rows[name],
            **extra,
        })
    log(f"SECONDS {time.perf_counter() - t0:.1f}")
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
