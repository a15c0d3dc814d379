#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Run from the repository root on a machine with a CUDA card. Phases (any
failure exits non-zero and prints no result line):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build all seven hand kernels (five libraries) from
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
   and at the microbench's operands (2^26 and 2^28 float32), tolerance 0;
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
   and no hand kernel launched (the JAX drivers reach no Pallas kernel);
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
   ``dispatch_rate``'s host-clock time of the same launch;
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

    # the main-path shapes: the bench's f32 blocks and bf16 dim-1 buffer,
    # the driver's periodic iterate blocks, the driver's derivatives, the
    # heat paths' shards, the grid path's block
    errs = {"stencil2d_iterate": 0.0, "stencil2d_deriv": 0.0,
            "heat2d": 0.0, "dual_dim_step": 0.0,
            "dual_dim_step residual (relative)": 0.0, **stream_errs}
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
    n_cases += 1
    del z
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if failures:
        raise SmokeFailure("kernel/plain mismatches:\n  "
                           + "\n  ".join(failures))
    log(f"CHECK {n_cases} kernel-vs-plain cases bit-exact")
    return errs


def compare_dual(name, z, sx, sy, failures):
    """The dual step against its plain version: both derivatives
    bit-exact, the residual within ``hand.RESIDUAL_RTOL``. Returns (max
    abs error of the derivatives, relative error of the residual)."""
    from tpu_mpi_tests_torch.kernels import hand

    gx, gy, gr = hand.dual_dim_step(z, 2, sx, sy)
    wx, wy, wr = hand.dual_dim_step_ref(z, 2, sx, sy)
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
            n_cases += 1
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


def dual_work(shape, dtype):
    """(bytes, flops) of a dual step: the block read once, both
    (n0−4, n1−4) derivatives written once (the residual scalar is
    negligible); per output point 8 flops per derivative and 4 for the
    two squares and their sums."""
    import torch

    itemsize = torch.empty((), dtype=dtype).element_size()
    n_out = (shape[0] - 4) * (shape[1] - 4)
    return (shape[0] * shape[1] + 2 * n_out) * itemsize, 20 * n_out


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

    def dual_row(shape, dtype):
        z = torch.randn(shape, generator=gen, device=device).to(dtype)
        s = GRID_SCALE
        ms = time_cuda(lambda: hand.dual_dim_step(z, 2, s, s), 20)
        plain = time_cuda(lambda: hand.dual_dim_step_ref(z, 2, s, s), 5)
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
        b, why = bound_ms(*dual_work(shape, dtype))
        return {"path": "stencil2d_grid", "shape": list(shape),
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
    rows["dual_dim_step"] = [dual_row((GRID_N + 4, GRID_N + 4),
                                      torch.float32)]
    torch.cuda.empty_cache()
    rows.update(time_stream_kernels(device, gen))
    for name, rs in rows.items():
        for r in rs:
            log(f"TIME {name} {json.dumps(r)}")
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
                        "error" in line.lower():
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
            *((name, STREAMS_SOURCE, STREAM_REPLACES[name])
              for name in STREAM_KERNELS)):
        main_row = rows[name][0]
        extra = {}
        if name == "dual_dim_step":
            # max_abs_err is the derivatives'; the residual is a sum in
            # another order, held to a relative tolerance
            extra = {"residual_rel_err": errs["dual_dim_step residual "
                                              "(relative)"],
                     "residual_rtol": hand.RESIDUAL_RTOL[torch.float32]}
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
