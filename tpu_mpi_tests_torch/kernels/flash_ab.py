"""A/B timing of the flash fold's wgmma and tf32x3 routes under other
compile-time choices, for the card:

    python -m tpu_mpi_tests_torch.kernels.flash_ab base kt64 st3 lb2 base
    python -m tpu_mpi_tests_torch.kernels.flash_ab x3 x3rna x3c240 x3

Each variant is a copy of the package under ``build/flash_ab/<name>/``
(listed in ``.gitignore``) with one choice of ``csrc/flash_fold.cuh``
changed; ``base`` and ``x3`` are the tree itself. Each is built and timed
in its own process, in the order given (so that two versions compare
within one call: base, change, change, base). One JSON line per run: the
ptxas registers and spill bytes of the route's flash instance, and the
time of one fold from the fresh carry, queued behind a stall (the
wrapper's host time out), with its largest normalised error against the
plain version at HIGHEST.

The wgmma route (bf16 DEFAULT) at (8192, 128) and (32768, 128) causal:
``kt64`` 64 key rows a K/V stage (the tree: 128); ``st3`` three K/V
stages (the tree: two); ``lb2`` two CTAs an SM (``__launch_bounds__(256,
2)``) with the register split 48/208 that sums to its 128-register entry
(the tree: one CTA, 56/216).

The tf32x3 route (float32 HIGHEST) at (8192, 128) dense and causal:
``x3rna`` both parts of a split by cvt.rna (the tree: the raw f32 word as
the big part, which the tensor cores read as TF32 by dropping its 13 low
bits, and the exact residual as the small one); ``x3c240`` 240 and 120
registers for the consumer and producer warpgroups (the tree: 248 and
88); ``x3t384`` a third warpgroup of splitters (the tree: two
warpgroups); ``x3hoist`` the products' descriptors left to the compiler
(the tree: made opaque at each issue); and two diagnostics whose
results are wrong by design, ``x3nosplit``
(nothing split or transposed, every barrier kept: the time without that
work) and ``x3pass1`` (one TF32 pass a product: the schedule without the
cross terms). Where the other choices the design weighed stand (64-key
tiles, a prologue launch that splits once): ``PERF.md``.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
#: variant -> (file, old text, new text) edits of the package's sources
VARIANTS = {
    "base": (),
    "kt64": (("flash_fold.cuh", "constexpr int kWgKT = 128;",
              "constexpr int kWgKT = 64;"),),
    "st3": (("flash_fold.cuh", "constexpr int kWgStages = 2;",
             "constexpr int kWgStages = 3;"),),
    "lb2": (("flash_fold.cuh", "constexpr int kWgProducerRegs = 56;",
             "constexpr int kWgProducerRegs = 48;"),
            ("flash_fold.cuh", "constexpr int kWgConsumerRegs = 216;",
             "constexpr int kWgConsumerRegs = 208;"),
            ("flash_attention.cu", "__launch_bounds__(kWgThreads, 1)",
             "__launch_bounds__(kWgThreads, 2)")),
    "x3": (),
    "x3rna": (("flash_fold.cuh", "constexpr bool kX3Rna = false;",
               "constexpr bool kX3Rna = true;"),),
    "x3t384": (("flash_fold.cuh",
                "constexpr int kX3Threads = 2 * kWgConsumers;",
                "constexpr int kX3Threads = 3 * kWgConsumers;"),),
    "x3c240": (("flash_fold.cuh", "constexpr int kX3ProducerRegs = 88;",
                "constexpr int kX3ProducerRegs = 120;"),
               ("flash_fold.cuh", "constexpr int kX3ConsumerRegs = 248;",
                "constexpr int kX3ConsumerRegs = 240;")),
    "x3hoist": (("flash_fold.cuh", "      opaque(qb, qs, dkb, dks);\n", ""),
                ("flash_fold.cuh", "      opaque(dvb, dvs, unused, unused2);\n",
                 "")),
    "x3nosplit": (("flash_fold.cuh",
                   "for (int c = tid; c < bytes / 16; c += nthr)",
                   "for (int c = tid; c < 0 * bytes; c += nthr)"),
                  ("flash_fold.cuh",
                   "const int n_it = qn * 8 * kX3KT;",
                   "const int n_it = 0 * qn;")),
    "x3pass1": (("flash_fold.cuh",
                 "wgmma_x3_ss(s, qs + qo(kk), dkb + ko(kk), kk > 0);",
                 "if (false) wgmma_x3_ss(s, qs + qo(kk), dkb + ko(kk), 0);"),
                ("flash_fold.cuh",
                 "wgmma_x3_ss(s, qb + qo(kk), dks + ko(kk), 1);",
                 "if (false) wgmma_x3_ss(s, qb + qo(kk), dks + ko(kk), 1);"),
                ("flash_fold.cuh",
                 "wgmma_x3_ss(s, qb + qo(kk), dkb + ko(kk), 1);",
                 "wgmma_x3_ss(s, qb + qo(kk), dkb + ko(kk), kk > 0);"),
                ("flash_fold.cuh",
                 "        wgmma_x3_rs(pv, ps[ks], dvb + vo(ks), ks > 0);\n"
                 "        wgmma_x3_rs(pv, pb[ks], dvs + vo(ks), 1);\n", ""),
                ("flash_fold.cuh",
                 "wgmma_x3_rs(pv, pb[ks], dvb + vo(ks), 1);",
                 "wgmma_x3_rs(pv, pb[ks], dvb + vo(ks), ks > 0);")),
}


def make(name: str, variants=VARIANTS, folder: str = "flash_ab") -> Path:
    """The package copy of variant ``name`` of ``variants`` under
    ``build/<folder>/``; its libraries build into its own
    ``build/torch_kernels``."""
    root = ROOT / "build" / folder / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(ROOT / "tpu_mpi_tests_torch",
                    root / "tpu_mpi_tests_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    csrc = root / "tpu_mpi_tests_torch" / "kernels" / "csrc"
    for file, old, new in variants[name]:
        text = (csrc / file).read_text()
        if old not in text:
            raise ValueError(f"variant {name}: {old!r} is not in {file}")
        (csrc / file).write_text(text.replace(old, new))
    return root


def time_queued(fn, n_iter: int, stall_ms: float = 20.0) -> float:
    """Mean device milliseconds per call with the launches queued behind
    a stall (chip_smoke.py's ``time_cuda_queued``)."""
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


def ptxas_row(build, kernel: str) -> dict:
    """Registers and spill bytes of ``kernel``'s instance in this
    process's build of the flash library."""
    row = {}
    lines = build.BUILD_LOGS.get("flash_attention", "").splitlines()
    at = [i for i, ln in enumerate(lines)
          if "Compiling entry" in ln and kernel in ln]
    for ln in lines[at[0]:at[0] + 4] if at else ():
        if m := re.search(r"(\d+) bytes spill stores", ln):
            row["spill_stores"] = int(m[1])
        if m := re.search(r"Used (\d+) registers", ln):
            row["registers"] = int(m[1])
    return row


def measure(name: str) -> dict:
    """Build the package this process imported and time the route: the
    wgmma route in bf16 DEFAULT, or for an ``x3`` variant the tf32x3
    route in float32 HIGHEST."""
    import torch

    from tpu_mpi_tests_torch.kernels import build, hand

    build.build(["flash_attention"])
    x3 = name.startswith("x3")
    row = {"variant": name,
           **ptxas_row(build, "flash_x3_kernel" if x3 else
                       "flash_wg_kernel")}
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = ((8192, False), (8192, True)) if x3 else \
        ((8192, False), (32768, True))
    for L, causal in cases:
        d = 128
        q, k, v = (torch.randn((L, d), generator=gen, device=dev)
                   .to(torch.float32 if x3 else torch.bfloat16)
                   for _ in range(3))
        kw = {"dtype": torch.float32, "device": dev}
        carry = (torch.full((L, 1), float("-inf"), **kw),
                 torch.zeros((L, 1), **kw), torch.zeros((L, d), **kw))
        out = tuple(torch.empty_like(t) for t in carry)
        args = dict(scale=d**-0.5, causal=causal,
                    precision="highest" if x3 else "default")

        def fold():
            return hand.flash_attention_block(q, k, v, *carry, 0, 0,
                                              out=out, **args)

        ms = time_queued(fold, 20 if L == 8192 else 5)
        want = hand.flash_attention_block_ref(q, k, v, *carry, 0, 0,
                                              k_tile=4096, **(args | {
                                                  "precision": "highest"}))
        err = float((out[2] / out[1] - want[2] / want[1]).abs().max())
        row[f"{L}{' causal' if causal else ''}"] = {
            "queued_ms": ms, "err": err,
            "routes": {r: n for r, n in
                       hand.flash_attention_block.launches_by_route.items()
                       if n}}
        del q, k, v, carry, out, want
    return row


def main(argv=None, module: str = "flash_ab", variants=VARIANTS,
         default=("base", "kt64")) -> int:
    """Build and time each variant named in ``argv`` in its own process,
    ``module``'s ``measure`` printing one JSON line each."""
    names = list(sys.argv[1:] if argv is None else argv) or list(default)
    for name in names:
        if name not in variants:
            print(f"{module}: unknown variant {name!r}; one of "
                  f"{', '.join(variants)}", file=sys.stderr)
            return 2
    for name in names:
        root = make(name, variants, module)
        run = subprocess.run(
            [sys.executable, "-c",
             "import json, sys; from tpu_mpi_tests_torch.kernels import "
             f"{module}; print(json.dumps({module}.measure(sys.argv[1])))",
             name], cwd=root, capture_output=True, text=True)
        if run.returncode != 0:
            print(json.dumps({"variant": name, "failed": run.returncode,
                              "stderr": run.stderr[-2000:]}))
            return 1
        print(run.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
