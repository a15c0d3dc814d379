"""A/B timing of the flash fold's wgmma route under other compile-time
choices, for the card:

    python -m tpu_mpi_tests_torch.kernels.flash_ab base kt64 st3 lb2

Each variant is a copy of the package under ``build/flash_ab/<name>/``
(listed in ``.gitignore``) with one choice of ``csrc/flash_fold.cuh``
changed — ``kt64``: 64 key rows a K/V stage (the tree: 128); ``st3``:
three K/V stages (the tree: two); ``lb2``: two CTAs an SM
(``__launch_bounds__(256, 2)``) with the register split 48/208 that
sums to its 128-register entry (the tree: one CTA, 56/216) — and
``base`` is the tree itself. Each is built and timed in its own process,
in the order given (so that two versions compare within one call: base,
change, change, base). One JSON line per run: the ptxas registers and
spill bytes of the wgmma flash instance, and for (8192, 128) bf16 and
(32768, 128) bf16 causal the time of one fold from the fresh carry,
queued behind a stall (the wrapper's host time out), with its largest
normalised error against the plain version at HIGHEST.
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


def measure(name: str) -> dict:
    """Build the package this process imported and time the route."""
    import torch

    from tpu_mpi_tests_torch.kernels import build, hand

    build.build(["flash_attention"])
    row = {"variant": name}
    lines = build.BUILD_LOGS.get("flash_attention", "").splitlines()
    at = [i for i, ln in enumerate(lines)
          if "Compiling entry" in ln and "flash_wg_kernel" in ln]
    for ln in lines[at[0]:at[0] + 4] if at else ():
        if m := re.search(r"(\d+) bytes spill stores", ln):
            row["spill_stores"] = int(m[1])
        if m := re.search(r"Used (\d+) registers", ln):
            row["registers"] = int(m[1])
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for L, causal in ((8192, False), (32768, True)):
        d = 128
        q, k, v = (torch.randn((L, d), generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        kw = {"dtype": torch.float32, "device": dev}
        carry = (torch.full((L, 1), float("-inf"), **kw),
                 torch.zeros((L, 1), **kw), torch.zeros((L, d), **kw))
        out = tuple(torch.empty_like(t) for t in carry)
        args = dict(scale=d**-0.5, causal=causal, precision="default")

        def fold():
            return hand.flash_attention_block(q, k, v, *carry, 0, 0,
                                              out=out, **args)

        ms = time_queued(fold, 20 if L == 8192 else 5)
        want = hand.flash_attention_block_ref(q, k, v, *carry, 0, 0,
                                              k_tile=4096, **(args | {
                                                  "precision": "highest"}))
        err = float((out[2] / out[1] - want[2] / want[1]).abs().max())
        row[f"{L}{' causal' if causal else ''}"] = {"queued_ms": ms,
                                                    "err": err}
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
