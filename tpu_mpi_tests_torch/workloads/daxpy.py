"""Single-device DAXPY with checksum verification — as a workload spec
(≅ ``tpu_mpi_tests/workloads/daxpy.py``).

≅ ``daxpy.cu`` (and, with ``--profile-dir``, ``daxpy_nvtx.cu``).
Semantics preserved: n=1024 default, a=2.0, x=i+1, y=-(i+1), result
y=i+1, checksum n(n+1)/2 printed as ``SUM = <v>`` (``daxpy.cu:82-88``);
the copyInput/kernel/copyOutput phases of ``daxpy_nvtx.cu:72-91`` are
trace ranges + phase timers, printed as ``TIME <phase> : <s>``.

The kernel is the torch tier (``kernels.daxpy.daxpy``, one launch), as the
JAX spec runs XLA's fused op. ``--iters K`` applies it K times, grouped
by the ``daxpy/chunk`` knob (:data:`CHUNK_SPACE`; cached > prior 1, a
``--tune`` miss sweeps): a chunk of k is k launches queued back to back
with one wait at the end (not a CUDA graph). Every application computes
from the same operands, so any chunk gives the result of one
application bit for bit and the gates do not change. Its serve handler
(:meth:`DaxpySpec.serve_factory`, the ``daxpy`` workload class) chains
the bounded recurrence ``y ← a·x + y/2`` in torch ops. In a world of
several ranks every rank runs the spec on its own card and reports as
the JAX spec does on one of several devices; a ``--tune`` sweep there is
rank 0's, its winner broadcast.
"""

from __future__ import annotations

import sys

import numpy as np

from tpu_mpi_tests_torch.tune import priors as _priors
from tpu_mpi_tests_torch.tune.registry import declare_space
from tpu_mpi_tests_torch.workloads import register_spec
from tpu_mpi_tests_torch.workloads.spec import RunContext, WorkloadSpec

#: launches queued per wait (≅ JAX ``CHUNK_SPACE``): 1, the prior, is the
#: reference's wait after every application
CHUNK_SPACE = declare_space(
    "daxpy/chunk", (_priors.DAXPY_CHUNK, 8, 32),
    describe="daxpy launches queued back to back per host wait",
)


class DaxpySpec(WorkloadSpec):
    name = "daxpy"
    title = __doc__
    needs_mesh = False

    def add_args(self, p) -> None:
        p.add_argument("--n", type=int, default=1024, help="vector length")
        p.add_argument(
            "--a", type=float, default=2.0, help="scalar multiplier"
        )
        p.add_argument(
            "--print-elements",
            action="store_true",
            help="print every y element (the reference always does; "
            "daxpy.cu:84)",
        )
        p.add_argument(
            "--iters",
            type=int,
            default=1,
            metavar="K",
            help="re-run the identical kernel K times (same inputs each "
            "time, so the result and every gate are unchanged; the kernel "
            "phase is entered K times). Default 1 = the reference's "
            "one-shot semantics",
        )

    def check_args(self, p, args) -> None:
        if args.n < 1:
            p.error(f"--n must be positive, got {args.n}")
        if args.iters < 1:
            p.error(f"--iters must be positive, got {args.iters}")

    def build(self, ctx: RunContext):
        import tpu_mpi_tests_torch.kernels.daxpy as kd
        from tpu_mpi_tests_torch.arrays.spaces import Space, place, to_device
        from tpu_mpi_tests_torch.drivers import _common
        from tpu_mpi_tests_torch.instrument.timers import block

        dtype = ctx.dtype()
        # initializeArrays on host, then copyInput H2D (daxpy_nvtx.cu:72-79)
        h_x, h_y = (_common.host_tensor(a, dtype) for a in
                    kd.init_xy_np(ctx.args.n, _common.numpy_dtype(ctx.args)))
        with ctx.phase("copyInput"):
            d_x = block(to_device(place(h_x, Space.HOST, ctx.device),
                                  ctx.device))
            d_y = block(to_device(place(h_y, Space.HOST, ctx.device),
                                  ctx.device))
        return {"d_x": d_x, "d_y": d_y, "dtype": dtype}

    def step(self, ctx: RunContext, state):
        import time

        import tpu_mpi_tests_torch.kernels.daxpy as kd
        from tpu_mpi_tests_torch.comm.collectives import host_value
        from tpu_mpi_tests_torch.instrument import costs
        from tpu_mpi_tests_torch.instrument.timers import block
        from tpu_mpi_tests_torch.tune.sweep import ensure_tuned

        a, d_x, d_y0 = ctx.args.a, state["d_x"], state["d_y"]
        n, dtype = ctx.args.n, state["dtype"]
        # the first call's cost (telemetry runs only): 2n flops, x and y
        # read and the result written
        costs.compile_probe(kd.daxpy, lambda: (a, d_x, d_y0),
                            label="daxpy", phase="kernel", flops=2 * n,
                            bytes_accessed=kd.daxpy_bytes(n, dtype),
                            n=n, dtype=ctx.args.dtype)

        def chain(k):
            # k applications from the same operands, one wait
            out = None
            for _ in range(k):
                out = kd.daxpy(a, d_x, d_y0)
            return block(out)

        def measure(cand):
            c = max(1, int(cand))
            chain(c)  # warm
            reps = max(2, 16 // c)
            t0 = time.perf_counter()
            for _ in range(reps):
                chain(c)
            return (time.perf_counter() - t0) / (reps * c)

        chunk = ensure_tuned("daxpy/chunk", measure, n=n,
                             dtype=ctx.args.dtype)
        try:
            chunk = max(1, int(chunk))
        except (TypeError, ValueError):
            chunk = _priors.DAXPY_CHUNK  # a malformed cached value
        state["chunk"] = chunk
        # --iters re-runs the IDENTICAL call (original y each time), so
        # the result and every gate stay those of one application
        left = ctx.args.iters
        while left > 0:
            k = min(chunk, left)
            with ctx.phase("kernel"):
                d_y = chain(k)
            left -= k

        with ctx.phase("copyOutput"):
            state["y"] = host_value(d_y)
        return state

    def verify(self, ctx: RunContext, state) -> int:
        import tpu_mpi_tests_torch.kernels.daxpy as kd
        from tpu_mpi_tests_torch.comm.collectives import host_value
        from tpu_mpi_tests_torch.drivers import _common

        args, rep, y = ctx.args, ctx.rep, state["y"]
        n = args.n
        if args.print_elements:
            for v in y:
                rep.line(f"{v:f}")
        total = float(y.sum(dtype=np.float64))
        rep.sum_line(total)
        # --verbose appends count/mean/min/max per phase on the TIME lines
        rep.time_lines(ctx.timer, stats=args.verbose)

        # per-element verification (≅ daxpy.cu:82-87): at a=2 every element
        # is exact for ANY n and dtype — x̂ = dtype(i+1), 2x̂ is exact and
        # 2x̂ − x̂ = x̂ (Sterbenz) — so y must equal dtype(i+1) bit for bit
        if args.a == 2.0:
            want = host_value(_common.host_tensor(
                np.arange(1, n + 1, dtype=np.float64).astype(
                    _common.numpy_dtype(args)), state["dtype"]))
            bad = np.flatnonzero(y != want)
            if bad.size:
                i = int(bad[0])
                rep.line(
                    f"ELEMENT FAIL: {bad.size}/{n} mismatches, first at "
                    f"[{i}]: got {y[i]}, expected {want[i]}"
                )
                return 1

        expected = kd.expected_checksum(n)
        # float32 accumulates rounding over large n; scale tolerance with n
        tol = 0 if args.dtype == "float64" else max(1e-6 * expected, 1.0)
        if abs(total - expected) > tol:
            rep.line(f"CHECKSUM FAIL: got {total}, expected {expected}")
            return 1
        return 0

    def serve_factory(self, device, shape, dtype):
        """Serve-mode handler (``drivers/_common.py`` workload registry,
        ≅ JAX ``daxpy.py:225``): ``step_fn(n)`` runs ``n`` chained DAXPY
        steps on persistent buffers. The recurrence ``y ← a·x + y/2``
        (a = 2, x = i + 1) keeps the iterate bounded (fixed point 2·a·x),
        so an hours-long run never overflows the state the way the raw
        accumulating update would; each step is one torch launch
        (``torch.add(a·x, y, alpha=0.5)``: both products are exact, so
        the step rounds once, as the JAX handler's fused loop body does).
        The JAX handler's loop is one compiled program of ``n`` steps;
        here ``n`` launches are queued with one wait at the end. DAXPY is
        the single-device class: nothing communicates."""
        import torch

        from tpu_mpi_tests_torch.drivers import _common
        from tpu_mpi_tests_torch.instrument.timers import block

        if len(shape) != 1:
            raise ValueError(f"daxpy wants a 1-d shape, got {shape}")
        (n,) = shape
        dt = _common.TORCH_DTYPES[dtype]
        # x = i + 1 as ``jnp.arange(1, n + 1, dtype)`` makes it: the index
        # in the dtype, then + 1 in the dtype (two roundings in bfloat16)
        wide = torch.float64 if dt == torch.float64 else torch.float32
        x = torch.arange(n, dtype=wide, device=device).to(dt) + 1
        ax = x * 2.0  # exact: a power of two
        state = {"y": torch.zeros(n, dtype=dt, device=device)}

        def step(k: int):
            y = state["y"]
            for _ in range(k):
                torch.add(ax, y, alpha=0.5, out=y)
            block(y)

        step(1)  # warm before traffic opens
        step.state = state
        return step


SPEC = register_spec(DaxpySpec())


def main(argv=None) -> int:
    from tpu_mpi_tests_torch.workloads.runner import make_main

    return make_main(SPEC)(argv)


if __name__ == "__main__":
    sys.exit(main())
