"""Microbenchmarks on the card (≅ the ``daxpy``, ``ceiling``, ``streams``,
``attention`` and ``causal`` groups of ``tpu/microbench.py``).

    python -m tpu_mpi_tests_torch.microbench [daxpy] [ceiling] [streams]
        [attention] [causal] [--device cuda|cpu]

Runs the selected groups (default: all five) and prints one JSON line
``{"metric", "value", "unit", "detail"}`` per measurement, then a summary
table. The JAX groups' sizes (2^24/2^26/2^28 float32) and iteration
counts are kept; their ``xla``/``pallas`` tiers are the port's ``torch``
(``kernels.daxpy.daxpy``, one ``torch.add``) and ``hand`` (the CUDA
kernels of ``kernels/csrc/streams.cu``) tiers. Timing: ``dispatch_rate``
(host clock around batches of independent launches, differenced) for
the per-launch rows; ``chain_rate`` (CUDA events around a Python loop of
launches, differenced) for the chained rows, whose aliased form writes
into ``y`` itself (``out=y``). The JAX ``streams`` group's
``daxpy_block{br}_gbps`` sweep varies a TPU VMEM tile and has no
counterpart here. The attention groups run the hand flash kernel
(``csrc/flash_attention.cu``) and torch ops, chained with the output fed
back as the next query; the TPU tile sweeps ``stripeskip`` and
``stripebalance`` are not ported (ROADMAP queue 1 item 21).

Each group function takes its sizes as keyword arguments (defaults: the
JAX sizes), so the CPU tests run them small.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from tpu_mpi_tests_torch.device import DEVICES, resolve_device
from tpu_mpi_tests_torch.instrument.timers import chain_rate, dispatch_rate
from tpu_mpi_tests_torch.kernels import daxpy as kd
from tpu_mpi_tests_torch.kernels import hand
from tpu_mpi_tests_torch.utils import TpuMtError

F32 = 4  # bytes per element: every group streams float32


def _emit(results, metric, value, unit, detail=""):
    rec = {"metric": metric, "value": round(value, 3), "unit": unit}
    if detail:
        rec["detail"] = detail
    print(json.dumps(rec), flush=True)
    results.append(rec)


def _log2(n: int) -> int:
    return n.bit_length() - 1


def _init_xy(n: int, device):
    return kd.init_xy(n, torch.float32, device)


def _uniform(n: int, seed: int, device) -> torch.Tensor:
    """Uniform in [1e-9, 2e-9) float32, made on ``device`` from ``seed``
    (the JAX group's operand range)."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.rand(n, generator=g, device=device) * 1e-9 + 1e-9


def bench_daxpy(results, device, sizes=(1 << 24, 1 << 26, 1 << 28),
                chain_n=1 << 26):
    """Per-launch daxpy GB/s of both tiers at each size, then the chained
    hand daxpy in place (``out=y``) and out of place (a new output each
    iteration)."""
    for n in sizes:
        x, y = _init_xy(n, device)
        gb = 3 * F32 * n / 1e9
        # fewer iters at 2^28 keeps device time ~0.5 s
        iters = 1000 if n < (1 << 28) else 500
        for tier, fn in (("torch", kd.daxpy), ("hand", hand.daxpy)):
            t = dispatch_rate(lambda a, b, fn=fn: fn(2.0, a, b), x, y,
                              n_iter=iters, n_base=iters // 10)
            _emit(results, f"daxpy_{tier}_2^{_log2(n)}_gbps", gb / t,
                  "GB/s")
        del x, y

    gb = 3 * F32 * chain_n / 1e9
    for inplace in (False, True):
        x, y = _init_xy(chain_n, device)

        def run(cur, n_iter, x=x, inplace=inplace):
            for _ in range(n_iter):
                cur = hand.daxpy(1e-7, x, cur, out=cur if inplace else None)
            return cur

        per, _ = chain_rate(run, y, n_short=100, n_long=1100)
        _emit(
            results,
            f"daxpy_chained_{'aliased' if inplace else 'outofplace'}_gbps",
            gb / per, "GB/s",
            f"2^{_log2(chain_n)} f32, 1000-launch chain",
        )
        del x, y


def bench_ceiling(results, device, n=1 << 26):
    """Practical HBM ceiling by a two-point overhead fit: a 3-pass daxpy
    and a 2-pass scale at the same size give ``t3 = 3·b/B + τ`` and
    ``t2 = 2·b/B + τ``, solved for the stream bandwidth B and the
    per-launch overhead τ."""
    b = F32 * n / 1e9  # GB per pass
    x, y = _init_xy(n, device)
    t3 = dispatch_rate(lambda a, c: hand.daxpy(2.0, a, c), x, y,
                       n_iter=1000, n_base=100)
    t2 = dispatch_rate(lambda a: hand.stream_scale(2.0, a), x,
                       n_iter=1000, n_base=100)
    tag = f"2^{_log2(n)} f32"
    _emit(results, "stream_daxpy_3pass_gbps", 3 * b / t3, "GB/s",
          f"raw 3-pass probe, {tag}")
    _emit(results, "stream_scale_2pass_gbps", 2 * b / t2, "GB/s",
          f"raw 2-pass probe, {tag}")
    raw3 = 3 * b / t3
    bw = b / (t3 - t2) if t3 > t2 else float("inf")
    tau = 3 * t2 - 2 * t3  # fitted per-launch overhead
    # noise guard: t3 ~ t2 blows the fit up, and tau < 0 (⇔ bw < raw3)
    # puts the fitted ceiling below the raw row it must bound
    if t3 > t2 and raw3 <= bw <= 2 * raw3 and tau >= 0:
        _emit(results, "hbm_ceiling_fit_gbps", bw, "GB/s",
              f"two-point overhead fit; per-kernel overhead "
              f"{tau * 1e6:.0f} us")
    else:
        _emit(results, "hbm_ceiling_fit_gbps", raw3, "GB/s",
              "fit degenerate (noise outside [raw, 2x raw]); raw 3-pass rate")


def bench_streams(results, device, n=1 << 26, n_big=1 << 28):
    """Stream-count probe family: chained in-place launches at S = 2
    (scale), 3 (daxpy) and 4 (sum3) HBM streams; the linear fit
    t(S) = oh + S·bytes/BW gives a measured per-stream bandwidth. Then
    the chained daxpy at 4× the bytes."""
    nb = n * F32
    w = _uniform(n, 1, device)
    x = _uniform(n, 2, device)

    def chain(step, y0, iters=1000):
        def run(y, n_iter):
            for _ in range(n_iter):
                step(y)
            return y

        per, _ = chain_rate(run, y0, n_short=iters // 10, n_long=iters)
        return per

    tag = f"2^{_log2(n)} f32"
    times = {}
    # S=2: y = a·y in place (read + write)
    times[2] = chain(lambda y: hand.stream_scale(1.0 + 1e-9, y, out=y),
                     torch.ones(n, device=device))
    _emit(results, "stream2_scale_gbps", 2 * nb / times[2] / 1e9, "GB/s",
          f"chained in-place y=a*y, {tag}")
    # S=3: y = a·x + y in place (the daxpy under test)
    times[3] = chain(lambda y: hand.daxpy(1.0, x, y, out=y),
                     torch.ones(n, device=device))
    _emit(results, "stream3_daxpy_gbps", 3 * nb / times[3] / 1e9, "GB/s",
          f"chained in-place y=a*x+y, {tag}")
    # S=4: y = w + x + y in place (3 reads + 1 write)
    times[4] = chain(lambda y: hand.stream_sum3(w, x, y, out=y),
                     torch.ones(n, device=device))
    _emit(results, "stream4_sum3_gbps", 4 * nb / times[4] / 1e9, "GB/s",
          f"chained in-place y=w+x+y, {tag}")
    # least-squares fit t(S) = oh + S·nb/BW over the 3 points
    S = np.array(sorted(times))
    t = np.array([times[int(s)] for s in S])
    slope, oh = np.polyfit(S, t, 1)
    pred3 = oh + 3 * slope
    _emit(results, "stream_fit_per_stream_gbps", nb / slope / 1e9, "GB/s",
          f"t(S)=oh+S*nb/BW fit; oh={oh * 1e6:.0f} us; "
          f"daxpy/pred3={pred3 / times[3]:.3f}")
    del w

    # 4x the bytes, same kernel
    x_big = _uniform(n_big, 3, device)
    per = chain(lambda y: hand.daxpy(1.0, x_big, y, out=y),
                torch.ones(n_big, device=device), iters=300)
    _emit(results, f"stream3_daxpy_2^{_log2(n_big)}_gbps",
          3 * n_big * F32 / per / 1e9, "GB/s",
          "chained in-place, 4x bytes of the fit family")


def _attention_operands(L: int, d: int, dtype, device):
    """q, k, v (L, d) standard normal in ``dtype``, made on ``device``."""
    g = torch.Generator(device=device).manual_seed(0)
    return tuple(torch.randn((L, d), generator=g, device=device).to(dtype)
                 for _ in range(3))


def _chain_attention(attn, state, n_short, n_long):
    """Seconds per call of ``attn`` chained with its output fed back as
    the next query, and the final state."""
    def run(st, n_iter):
        qq, k, v = st
        for _ in range(n_iter):
            qq = attn(qq, k, v)
        return qq, k, v

    return chain_rate(run, state, n_short=n_short, n_long=n_long)


def bench_attention(results, device, L=8192, d=128, n_short=100,
                    n_long=1100):
    """Flash vs torch-op local attention (≅ the JAX ``attention`` group):
    softmax(q·kᵀ/√d)·v at L=8192, d=128 in float32 and bfloat16, both
    tiers at DEFAULT precision (the hand kernel on the tensor cores —
    TF32 for float32 — and ``torch.matmul`` with TF32 on), chained."""
    flops = 4.0 * L * L * d  # two L×L×d matmuls per iteration

    def xla_attn(q, k, v):
        s = torch.matmul(q, k.T) / (d**0.5)
        return torch.matmul(torch.softmax(s, dim=-1), v)

    def flash_attn(q, k, v):
        return hand.flash_attention(q, k, v, precision="default")

    with hand.matmul_precision("default"):
        for dtype in ("float32", "bfloat16"):
            state = _attention_operands(L, d, getattr(torch, dtype), device)
            for name, attn in (("flash", flash_attn), ("xla", xla_attn)):
                per, state = _chain_attention(attn, state, n_short, n_long)
                _emit(results, f"attention_{name}_{dtype}_tflops",
                      flops / per / 1e12, "TFLOP/s",
                      f"L={L} d={d} softmax(qk^T)v")
            del state


def bench_causal(results, device, sizes=((8192, "resident"),
                                         (32768, "stream")), d=128,
                 iters=None):
    """Causal tile-skip A/B (≅ the JAX ``causal`` group): bf16 at DEFAULT,
    the full and causal arms of the hand kernel at each size, the causal
    pair alternating twice and the minimum reported (contention only
    inflates). The TPU's "resident"/"stream" kernel paths and its
    ``skip_tile=256`` decoupled arm keep their metric names; on the card
    one kernel runs all of them at its own 64-wide skip tile. Emits ms
    per attention with the useful TFLOP/s (causal counts half the
    flops)."""
    variants = [(False, None, "full"), (True, None, "causal"),
                (True, 256, "causal_decoupled"), (True, None, "causal"),
                (True, 256, "causal_decoupled")]
    for L, path in sizes:
        state = _attention_operands(L, d, torch.bfloat16, device)
        n_long = iters or max(100, 800 * 8192 // L)
        readings: dict[str, list] = {}
        for causal, skt, tag in variants:
            def attn(q, k, v, causal=causal, skt=skt):
                return hand.flash_attention(q, k, v, causal=causal,
                                            skip_tile=skt,
                                            precision="default")

            per, state = _chain_attention(attn, state, n_long // 10 or 1,
                                          n_long)
            readings.setdefault(tag, []).append((causal, per))
        for tag, reads in readings.items():
            causal = reads[0][0]
            pers = [p for _, p in reads]
            per = min(pers)
            useful = 4.0 * L * L * d * (0.5 if causal else 1.0)
            all_r = ",".join(f"{p * 1e3:.3f}" for p in pers)
            _emit(results, f"attn_{path}_{tag}_bf16_L{L}", per * 1e3,
                  "ms/attn",
                  f"useful {useful / per / 1e12:.1f} TFLOP/s"
                  + (f"; reads [{all_r}]" if len(pers) > 1 else ""))
        del state


GROUPS = {
    "daxpy": bench_daxpy,
    "ceiling": bench_ceiling,
    "streams": bench_streams,
    "attention": bench_attention,
    "causal": bench_causal,
}


def run_groups(groups, device, **sizes) -> list[dict]:
    """Run ``groups`` in order on ``device``; returns the records. A name
    that is not a ported group raises."""
    unknown = [g for g in groups if g not in GROUPS]
    if unknown:
        raise TpuMtError(
            f"unknown or unported microbench groups {unknown}; ported: "
            f"{list(GROUPS)} (the other tpu/microbench.py groups are "
            f"ROADMAP queue 1 item 21)"
        )
    results = []
    for g in groups:
        GROUPS[g](results, device, **sizes.get(g, {}))
    return results


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("groups", nargs="*", default=list(GROUPS))
    p.add_argument("--device", default="cuda", choices=DEVICES,
                   help="the GPU (default; raises when none is present) "
                   "or, only when asked, the CPU")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    results = run_groups(args.groups or list(GROUPS), device)
    width = max(len(r["metric"]) for r in results) if results else 0
    print("-" * (width + 20))
    for r in results:
        print(f"{r['metric']:<{width}}  {r['value']:>10} {r['unit']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
