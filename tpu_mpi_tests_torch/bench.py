"""Headline benchmark of the port: 2-D stencil full-step throughput at
8192² (``python -m tpu_mpi_tests_torch.bench``; ≅ the root ``bench.py``).

Runs the flagship per-iteration pipeline — halo exchange + 5-point
stencil update, the ``mpi_stencil2d_gt.cc:511-535`` hot loop — on an
8192×8192 domain and prints ONE JSON line with the root bench's keys
(metric ``stencil2d_fullstep_8192_iters_per_s``).

Each rank holds its block of rows (dim 0) or columns (dim 1) of the
domain; the world comes from the process group (``comm.dist``: torchrun
or ``native/tpumt_run``), one rank per card. Default schedules (the JAX
package's shipped priors, read from ``comm/halo.py``; the tune cache is
not ported):

* float32: the ``blocks`` tier on S=2 resident row blocks at k=4 — two
  launches of the hand k-step kernel per 4 timesteps, dim 0;
* bfloat16 (measured second, nested under its name): the dim-1 single
  buffer at k=4 — one launch per 4 timesteps.

The same ``TPU_MPI_BENCH_*`` variables as the root bench select the run:
``_N``, ``_DTYPE``, ``_SECOND_DTYPE``, ``_STEPS``, ``_BLOCKS``, ``_TIER``
(``blocks``, ``xla``, ``rdma-chained`` — the hand RDMA ring chained to
the k-step kernel on the dim-1 decomposition — or ``rdma-fused`` — the
one-launch fused kernel on dim 0, a geometry it cannot block declining to
``blocks`` with a NOTE; both on the JAX bench's non-periodic ring),
``_ITERS_SHORT``,
``_ITERS_LONG``, ``_SAMPLES``, ``_OVERLAP`` (the halo pipeline depth,
clamped to [1, 2]: depth 2 runs ``halo.iterate_overlap_fn``, the
exchange in flight on a comm stream under the iterate kernel, where the
JAX bench applies it — on the card, the ``blocks`` tier's dim-1 single
buffer at ``_STEPS=1``; anywhere else a NOTE, and the serialized
schedule runs). The schedule string names the depth that ran
(``_ov1``/``_ov2``). Chaining is a Python loop of launches;
two run lengths are differenced with CUDA events on the card.
``vs_baseline`` compares against the V100 equal-width roofline the root
bench defines (``bench.py:445-448``): (2 reads + 1 write) × itemsize ×
8192² bytes per iteration over 810 GB/s.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics

import numpy as np
import torch

from tpu_mpi_tests_torch.arrays.domain import Domain2D
from tpu_mpi_tests_torch.comm import dist
from tpu_mpi_tests_torch.comm import halo as H
from tpu_mpi_tests_torch.comm.mesh import bootstrap
from tpu_mpi_tests_torch.device import DEVICES
from tpu_mpi_tests_torch.drivers._common import TORCH_DTYPES, decline_note
from tpu_mpi_tests_torch.instrument.timers import chain_rate
from tpu_mpi_tests_torch.kernels import hand
from tpu_mpi_tests_torch.kernels.stencil import N_BND, analytic_pairs
from tpu_mpi_tests_torch.utils import check_divisible

METRIC = "stencil2d_fullstep_8192_iters_per_s"
V100_HBM_GBPS = 810.0  # STREAM-class HBM2 bandwidth (root bench.py:47)
V100_F64_ITERS_PER_S = 503.0  # 810e9 / (3 * 8 * 8192**2)
BENCH_DTYPES = ("float32", "bfloat16")


def build_schedule(dtype_name: str, *, n: int, steps: int, n_blocks: int,
                   tier: str, device, overlap: bool = False):
    """``(run, state, use_blocks, bench_dim)`` for one dtype on this
    rank (≅ the root bench's ``_build_schedule``): the resident-block hand
    schedule where it applies (``blocks`` tier, k>1, S>=2 dividing the
    rank's rows), else the dim-1 single-buffer hand kernel — with
    ``overlap``, its overlap schedule (``halo.iterate_overlap_fn``, k=1);
    the RDMA tiers (chained on dim 1, fused on dim 0); or the torch-op
    ``xla`` tier (k=1, shallow ghosts). Initial fields are computed on the
    device (f64, cast once)."""
    w = dist.world()
    dtype = TORCH_DTYPES[dtype_name]
    eps = 1e-6
    n_local = check_divisible(n, w.size, "TPU_MPI_BENCH_N over the world")
    use_blocks = (tier == "blocks" and steps > 1 and n_blocks >= 2
                  and n_local % n_blocks == 0)
    bench_dim = 0 if (use_blocks or tier == "rdma-fused") else 1
    d = Domain2D(n_local_deriv=n_local, n_global_other=n, n_shards=w.size,
                 dim=bench_dim, n_bnd=N_BND * steps)
    f, _ = analytic_pairs()[f"2d_dim{bench_dim}"]
    zg = d.init_shard_torch(f, w.rank, dtype, device)
    se = eps * d.scale
    if use_blocks:
        run = H.iterate_hand_blocks_fn(n_blocks, d.n_bnd, se, steps=steps)
        return run, H.split_blocks(zg, n_blocks, d.n_bnd), True, bench_dim
    if tier == "rdma-fused":
        run = H.iterate_fused_rdma_fn(d.n_bnd, se, steps=steps)
    elif tier == "rdma-chained":
        run = H.iterate_hand_fn(d.n_bnd, se, axis=1, steps=steps, rdma=True)
    elif overlap:
        run = H.iterate_overlap_fn(d.n_bnd, se, axis=1)
    elif tier == "blocks":
        run = H.iterate_hand_fn(d.n_bnd, se, axis=1, steps=steps)
    else:
        run = H.iterate_fused_fn(1, d.n_bnd, d.scale, eps)
    return run, zg, False, bench_dim


def resolve_overlap(env_val: "str | None") -> int:
    """The bench's halo pipeline depth (≅ the root bench's
    ``_resolve_overlap``): ``TPU_MPI_BENCH_OVERLAP`` clamped to [1, 2],
    else the prior (1; the schedule cache is not ported)."""
    if env_val is not None:
        return max(1, min(int(env_val), 2))
    return H.HALO_OVERLAP_DEPTH


def measure(dtype_name: str, *, n: int, steps: int, device,
            blocks_env: "str | None", tier_env: "str | None",
            ov_depth: int = 1) -> dict:
    """One dtype's measurement: build the schedule, chain-time it,
    median of samples. Returns the JSON-ready dict."""
    tier = H.check_tier(tier_env or H.PRIOR_TIER)
    if tier == "xla":
        steps = 1  # the torch-op iterate runs shallow halos
    if blocks_env is not None:
        n_blocks = int(blocks_env)
    else:
        n_blocks = H.PRIOR_BLOCKS.get(dtype_name, H.PRIOR_BLOCKS["float32"])
    on_card = device.type == "cuda"
    if tier == "rdma-fused":
        world = dist.world().size
        try:
            hand.fused_block_rows(n // world + 2 * N_BND * steps, steps)
        except ValueError as e:
            # never a dead headline, never a mislabeled one: the JSON
            # names the tier that ran
            decline_note(f"tier rdma-fused infeasible at n={n} "
                         f"world={world} steps={steps} ({e}); running the "
                         f"blocks tier")
            tier = "blocks"
    ov_eff = 1
    if ov_depth >= 2 and on_card and steps == 1 and tier == "blocks":
        ov_eff = 2  # the dim-1 single buffer: no resident blocks at k=1
    elif ov_depth >= 2:
        decline_note(f"overlap depth {ov_depth} not applicable "
                     f"(platform={'gpu' if on_card else device.type} "
                     f"steps={steps} blocks={n_blocks} tier={tier}); "
                     f"running the serialized schedule (_ov1)")
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    run, state, use_blocks, bench_dim = build_schedule(
        dtype_name, n=n, steps=steps, n_blocks=n_blocks, tier=tier,
        device=device, overlap=ov_eff >= 2,
    )
    if blocks_env is not None and n_blocks >= 2 and not use_blocks:
        decline_note(f"TPU_MPI_BENCH_BLOCKS={n_blocks} not applicable "
                     f"(tier={tier} steps={steps} n={n}); running the "
                     f"dim-{bench_dim} single-buffer schedule")

    n_short = int(os.environ.get("TPU_MPI_BENCH_ITERS_SHORT", 100))
    n_long = int(os.environ.get("TPU_MPI_BENCH_ITERS_LONG", 2100))
    # counts are in TIMESTEPS; each call advances k of them
    n_short = max(1, n_short // steps)
    n_long = max(n_short + 1, n_long // steps)
    n_samples = int(os.environ.get("TPU_MPI_BENCH_SAMPLES", 5))
    samples = []
    for _ in range(max(1, n_samples)):
        sec_per_call, state = chain_rate(run, state, n_short=n_short,
                                         n_long=n_long)
        samples.append(steps / sec_per_call)
    finite = [s for s in samples if np.isfinite(s)]
    iters_per_s = statistics.median(finite) if finite else float("nan")

    itemsize = torch.empty((), dtype=TORCH_DTYPES[dtype_name]).element_size()
    equal_width_baseline = V100_HBM_GBPS * 1e9 / (3 * itemsize * 8192**2)
    hbm = {}
    if on_card:
        hbm = {"hbm_peak_bytes": torch.cuda.max_memory_allocated(device),
               "hbm_bytes_in_use": torch.cuda.memory_allocated(device)}
    w = dist.world()
    world = w.size
    suffix = f"_h{w.hosts}x{w.ranks_per_host}"
    # the _ov<d> suffix names the pipeline depth that ran
    schedule = (
        f"blocks{n_blocks}_dim0_world{world}_{dtype_name}_ov{ov_eff}_{tier}"
        f"{suffix}" if use_blocks
        else f"dim{bench_dim}_world{world}_{dtype_name}_ov{ov_eff}_{tier}"
        f"{suffix}"
    )
    return {
        **hbm,
        "value": round(iters_per_s, 2),
        "unit": "iter/s",
        "vs_baseline": round(iters_per_s / equal_width_baseline, 3),
        "vs_f64_reference_roofline": round(
            iters_per_s / V100_F64_ITERS_PER_S, 3),
        "dtype": dtype_name,
        "samples": [round(s, 2) if np.isfinite(s) else None
                    for s in samples],
        "schedule": schedule,
        "steps": steps,
        "tier": tier,
        "topology": suffix.lstrip("_"),
    }


def _dtype_env(var: str, value: str, allowed) -> str:
    if value not in allowed:
        raise SystemExit(f"{var}={value!r} unsupported "
                         f"({' | '.join(allowed)})")
    return value


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda", choices=DEVICES,
                   help="the GPU (default; raises when none is present) "
                   "or, only when asked, the CPU with the plain versions")
    args = p.parse_args(argv)
    device = bootstrap(args.device)

    n = int(os.environ.get("TPU_MPI_BENCH_N", 8192))
    dtype_name = _dtype_env("TPU_MPI_BENCH_DTYPE",
                            os.environ.get("TPU_MPI_BENCH_DTYPE", "float32"),
                            BENCH_DTYPES)
    if os.environ.get("TPU_MPI_BENCH_TUNE", "").lower() not in (
            "", "0", "false"):
        decline_note("TPU_MPI_BENCH_TUNE: the tune cache is not ported; "
                     "running the prior schedule")
    ov_depth = resolve_overlap(os.environ.get("TPU_MPI_BENCH_OVERLAP"))
    steps_env = os.environ.get("TPU_MPI_BENCH_STEPS")
    steps = int(steps_env) if steps_env is not None else H.PRIOR_STEPS
    tier_env = os.environ.get("TPU_MPI_BENCH_TIER")

    rec = {"metric": METRIC}
    rec.update(measure(
        dtype_name, n=n, steps=steps, device=device,
        blocks_env=os.environ.get("TPU_MPI_BENCH_BLOCKS"),
        tier_env=tier_env, ov_depth=ov_depth,
    ))
    second = os.environ.get("TPU_MPI_BENCH_SECOND_DTYPE", "")
    if second in ("none", "0"):
        second_dtype = None
    elif second:
        second_dtype = _dtype_env("TPU_MPI_BENCH_SECOND_DTYPE", second,
                                  BENCH_DTYPES)
    else:
        second_dtype = "bfloat16" if dtype_name == "float32" else "float32"
    if second_dtype == dtype_name:
        decline_note(f"TPU_MPI_BENCH_SECOND_DTYPE={second!r} equals the "
                     f"primary dtype; no second measurement")
    elif second_dtype:
        # the secondary always runs its default schedule (the explicit
        # block count applies to the primary only, as in the root bench)
        rec[second_dtype] = measure(
            second_dtype, n=n, steps=steps, device=device,
            blocks_env=None, tier_env=tier_env, ov_depth=ov_depth,
        )
    if dist.world().rank == 0:
        print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
