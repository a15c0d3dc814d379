"""The schedule sweep behind ``tpu_mpi_tests_torch/tune/priors.py``: the
port's bench (``tpu_mpi_tests_torch.bench.measure``) at 8192², one rank,
over every tier, resident-block count S and temporal-blocking depth k,
in float32 and bfloat16, one JSON line a point.

    python gpu/prior_sweep.py [OUT.jsonl]

The grid: the ``blocks`` tier at S in {0, 2, 4} and k in {1, 2, 4, 8}
(at k = 1 the tier runs the dim-1 single buffer whatever S says, so S = 0
alone is measured there), ``rdma-chained`` and ``rdma-fused`` at k in
{1, 2, 4, 8}, and ``xla`` (the torch-op tier, k = 1). Each line holds
the point, the bench's median iter/s and its samples, the schedule string
that ran, and the k-step launches by route (``hand.route_counts()``: the
point is on the ``regs`` route when every launch of the iterate and the
fused kernel is). The card's name and power limit come first. The bench's
own environment variables (``TPU_MPI_BENCH_SAMPLES``, ``_ITERS_SHORT``,
``_ITERS_LONG``) size each point. Needs the card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from tpu_mpi_tests_torch import bench  # noqa: E402
from tpu_mpi_tests_torch.comm.halo import STENCIL_STEPS_SPACE  # noqa: E402
from tpu_mpi_tests_torch.comm.mesh import bootstrap  # noqa: E402
from tpu_mpi_tests_torch.kernels import hand  # noqa: E402

N = 8192
#: the temporal-blocking depths of the registry's ``stencil/steps`` space
STEPS = tuple(sorted(STENCIL_STEPS_SPACE.candidates))


def grid():
    """``(tier, S, k)`` points in the order they run."""
    for k in STEPS:
        for s in ((0,) if k == 1 else (0, 2, 4)):
            yield "blocks", s, k
    for tier in ("rdma-chained", "rdma-fused"):
        for k in STEPS:
            yield tier, 0, k
    yield "xla", 0, 1


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("prior_sweep: no card", file=sys.stderr)
        return 1
    device = bootstrap("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(f"CARD {card}", flush=True)
    out = open(argv[0], "w") if argv else None
    try:
        for dtype in bench.BENCH_DTYPES:
            for tier, s, k in grid():
                hand.reset_launch_counts()
                rec = bench.measure(dtype, n=N, steps=k, device=device,
                                    blocks_env=str(s), tier_env=tier)
                routes = hand.route_counts()
                line = {
                    "dtype": dtype, "tier": tier, "blocks": s, "steps": k,
                    "iter_per_s": rec["value"], "samples": rec["samples"],
                    "tier_ran": rec["tier"], "schedule": rec["schedule"],
                    "iterate_routes": routes["stencil2d_iterate"],
                    "fused_routes": routes["stencil2d_fused_rdma"],
                    "card": card,
                }
                print(json.dumps(line), flush=True)
                if out is not None:
                    out.write(json.dumps(line) + "\n")
                del rec
                torch.cuda.empty_cache()
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
