"""Headline benchmark of the port: 2-D stencil full-step throughput at
8192² (``python -m tpu_mpi_tests_torch.bench``; ≅ the root ``bench.py``).

Runs the flagship per-iteration pipeline — halo exchange + 5-point
stencil update, the ``mpi_stencil2d_gt.cc:511-535`` hot loop — on an
8192×8192 domain and prints ONE JSON line with the root bench's keys
(metric ``stencil2d_fullstep_8192_iters_per_s``).

Each rank holds its block of rows (dim 0) or columns (dim 1) of the
domain; the world comes from the process group (``comm.dist``: torchrun
or ``native/tpumt_run``), one rank per card. The schedule — kernel tier,
resident-block count S, temporal-blocking depth k, halo pipeline depth —
resolves per dtype (float32 first, bfloat16 second, nested under its
name) explicit environment variable > the schedule cache's winner (the
cache loads when ``TPU_MPI_BENCH_TUNE`` is set or the cache file,
``TPU_MPI_TUNE_CACHE`` else ``~/.cache/tpumt/tune.json``, exists) > the
card's measured priors (``tune/priors.py``). ``TPU_MPI_BENCH_TUNE=1``
sweeps the tier, then (for the ``blocks`` tier) the block count, on a
cache miss and stores the winners (≅ the root ``bench.py:301-400``); the
sweep records go to stderr as JSON lines, and a ``SCHEDULE bench`` line
on stderr names each dtype's resolved schedule and where each knob came
from (explicit, cache, sweep or prior).

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
(``_ov1``/``_ov2``). Chaining is ``chain_rate``: on the card two run
lengths are captured as CUDA graphs, replayed between CUDA events and
differenced.
``vs_baseline`` compares against the V100 equal-width roofline the root
bench defines (``bench.py:445-448``): (2 reads + 1 write) × itemsize ×
8192² bytes per iteration over 810 GB/s.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

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
from tpu_mpi_tests_torch.tune import cache as _tc
from tpu_mpi_tests_torch.tune import fleet
from tpu_mpi_tests_torch.tune import registry as _tr
from tpu_mpi_tests_torch.tune.sweep import sweep as _sweep
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


def resolve_overlap(env_val: "str | None", **ctx) -> int:
    """The bench's halo pipeline depth (≅ the root bench's
    ``_resolve_overlap``): ``TPU_MPI_BENCH_OVERLAP`` clamped to [1, 2],
    else the cached winner, else the prior (1)."""
    if env_val is not None:
        return max(1, min(int(env_val), 2))
    return H.resolve_overlap_depth(None, **ctx)


def _tune_emit(rec) -> None:
    # stdout stays the one JSON result line; sweep records go to stderr
    print(json.dumps(rec), file=sys.stderr, flush=True)


def _tier_refusal(tier: str, *, n: int, steps: int) -> "str | None":
    """Why ``tier`` cannot run at this geometry and world, or None."""
    if tier.startswith("rdma"):
        why = H.rdma_refusal()
        if why is not None:
            return why
    if tier == "rdma-fused":
        try:
            hand.fused_block_rows(n // dist.world().size + 2 * N_BND * steps,
                                  steps)
        except ValueError as e:
            return str(e)
    return None


def _chain_seconds(dtype_name, *, n, steps, n_blocks, tier, device):
    """Per-timestep seconds of one candidate schedule (a short chain)."""
    run, state, _, _ = build_schedule(dtype_name, n=n, steps=steps,
                                      n_blocks=n_blocks, tier=tier,
                                      device=device)
    sec, state = chain_rate(run, state, n_short=5, n_long=55)
    del state
    return sec / steps


def _sweep_on_miss(knob: str, **ctx) -> bool:
    """Whether to sweep ``knob``: ``TPU_MPI_BENCH_TUNE`` armed the
    registry and rank 0's cache has no entry. Over several ranks rank 0
    decides and broadcasts, so that every rank enters the sweep's
    exchanges together."""
    if not _tr.tuning_enabled():
        return False
    miss = _tr.lookup(knob, device_fallback=False, **ctx) is None
    return bool(fleet.bcast(miss if fleet.process_index() == 0 else None,
                            f"bench:{knob}:miss"))


def resolve_schedule(dtype_name: str, *, n: int, device,
                     steps_env: "str | None" = None,
                     blocks_env: "str | None" = None,
                     tier_env: "str | None" = None,
                     overlap_env: "str | None" = None) -> dict:
    """One dtype's schedule, each knob explicit env > cached winner >
    prior, with the on-miss sweeps of ``TPU_MPI_BENCH_TUNE`` (≅ the root
    bench's ``_measure``). Returns ``{tier, steps, n_blocks, ov_depth,
    source}``; ``source`` says where each knob came from. Over several
    ranks every rank runs rank 0's resolution (per-rank caches can
    differ, and ranks running different schedules would hang in the
    exchanges)."""
    world = dist.world().size
    ctx = {"dtype": dtype_name, "n": n, "world": world}
    src = {}
    if steps_env is not None:
        steps, src["steps"] = int(steps_env), "explicit"
    else:
        hit = _tr.lookup("stencil/steps", device_fallback=False, n=n,
                         world=world)
        steps = H.resolve_stencil_steps(n=n, world=world)
        src["steps"] = "cache" if hit is not None else "prior"

    if tier_env is not None:
        tier, src["tier"] = H.check_tier(tier_env), "explicit"
    elif _sweep_on_miss("stencil/tier", **ctx):
        def measure_tier(cand):
            steps_c = 1 if cand == "xla" else steps
            why = _tier_refusal(cand, n=n, steps=steps_c)
            if why is not None:
                raise ValueError(f"tier={cand} not applicable ({why})")
            return _chain_seconds(
                dtype_name, n=n, steps=steps_c, tier=cand, device=device,
                n_blocks=H.resolve_stencil_blocks(blocks_env, **ctx))

        tier = str(_sweep("stencil/tier", measure_tier,
                          candidates=H.stencil_tier_candidates(dtype_name),
                          emit=_tune_emit, **ctx))
        src["tier"] = "sweep"
    else:
        hit = _tr.lookup("stencil/tier", device_fallback=False, **ctx)
        tier = H.resolve_stencil_tier(None, **ctx)
        src["tier"] = "cache" if hit is not None else "prior"
    if tier == "xla":
        steps = 1  # the torch-op iterate runs shallow halos

    if blocks_env is not None:
        n_blocks, src["blocks"] = int(blocks_env), "explicit"
    elif tier == "blocks" and _sweep_on_miss("stencil/blocks", **ctx):
        local = n // world

        def measure_blocks(cand):
            if int(cand) >= 2 and not (steps > 1 and local % int(cand) == 0):
                raise ValueError(f"blocks={cand} not applicable "
                                 f"(steps={steps} n={n} world={world})")
            return _chain_seconds(dtype_name, n=n, steps=steps,
                                  n_blocks=int(cand), tier="blocks",
                                  device=device)

        n_blocks = int(_sweep(
            "stencil/blocks", measure_blocks,
            candidates=H.stencil_blocks_candidates(dtype_name),
            emit=_tune_emit, **ctx))
        src["blocks"] = "sweep"
    else:
        hit = _tr.lookup("stencil/blocks", device_fallback=False, **ctx)
        n_blocks = H.resolve_stencil_blocks(None, **ctx)
        src["blocks"] = "cache" if hit is not None else "prior"

    sched = {"tier": tier, "steps": steps, "n_blocks": n_blocks,
             "ov_depth": resolve_overlap(overlap_env, **ctx), "source": src}
    return fleet.bcast(sched if fleet.process_index() == 0 else None,
                       "bench:schedule")


def measure(dtype_name: str, *, n: int, steps: int, device,
            blocks_env: "str | None", tier_env: "str | None",
            ov_depth: int = 1) -> dict:
    """One dtype's measurement at an explicit schedule: build it,
    chain-time it, median of samples. Returns the JSON-ready dict."""
    rec, state = measure_schedule(
        dtype_name, n=n, steps=steps, device=device,
        n_blocks=(int(blocks_env) if blocks_env is not None
                  else H.resolve_stencil_blocks(dtype=dtype_name)),
        tier=H.check_tier(tier_env or H.resolve_stencil_tier(
            None, dtype=dtype_name)),
        ov_depth=ov_depth, blocks_explicit=blocks_env is not None)
    del state
    return rec


def measure_schedule(dtype_name: str, *, n: int, steps: int, device,
                     n_blocks: int, tier: str, ov_depth: int = 1,
                     blocks_explicit: bool = False):
    """Build and chain-time one resolved schedule (median of samples).
    Returns ``(record, final state)``: the state after the whole chain,
    the same for two runs of one schedule with the same environment."""
    if tier == "xla":
        steps = 1  # the torch-op iterate runs shallow halos
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
    if blocks_explicit and n_blocks >= 2 and not use_blocks:
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
    }, state


def _dtype_env(var: str, value: str, allowed) -> str:
    if value not in allowed:
        raise SystemExit(f"{var}={value!r} unsupported "
                         f"({' | '.join(allowed)})")
    return value


def configure_tuning() -> None:
    """Load the schedule cache (``TPU_MPI_TUNE_CACHE``, else the default
    path) when ``TPU_MPI_BENCH_TUNE`` asks for sweeps or the file exists;
    else leave the registry unconfigured, so every knob takes its prior
    (≅ the root bench's ``bench.py:533-545``; ``TPU_MPI_TUNE_BUDGET``
    caps a sweep, in seconds)."""
    _tr.deconfigure()
    tune = os.environ.get("TPU_MPI_BENCH_TUNE", "").lower() not in (
        "", "0", "false")
    path = _tc.default_cache_path()
    if tune or os.path.exists(path):
        budget = os.environ.get("TPU_MPI_TUNE_BUDGET")
        _tr.configure(cache_path=path, enabled=tune,
                      budget_s=float(budget) if budget else None)


def run_dtype(dtype_name: str, *, n: int, device,
              blocks_env: "str | None" = None, **env):
    """Resolve one dtype's schedule (:func:`resolve_schedule`), print it
    on stderr with where each knob came from, and measure it. Returns
    ``(record, final state)``."""
    sched = resolve_schedule(dtype_name, n=n, device=device,
                             blocks_env=blocks_env, **env)
    src = sched["source"]
    print(f"SCHEDULE bench {dtype_name}: tier={sched['tier']} "
          f"({src['tier']}) steps={sched['steps']} ({src['steps']}) "
          f"blocks={sched['n_blocks']} ({src['blocks']}) "
          f"overlap={sched['ov_depth']}", file=sys.stderr, flush=True)
    return measure_schedule(
        dtype_name, n=n, steps=sched["steps"], device=device,
        n_blocks=sched["n_blocks"], tier=sched["tier"],
        ov_depth=sched["ov_depth"], blocks_explicit=blocks_env is not None)


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
    configure_tuning()
    env = {"steps_env": os.environ.get("TPU_MPI_BENCH_STEPS"),
           "tier_env": os.environ.get("TPU_MPI_BENCH_TIER"),
           "overlap_env": os.environ.get("TPU_MPI_BENCH_OVERLAP")}

    rec = {"metric": METRIC}
    rec.update(run_dtype(
        dtype_name, n=n, device=device,
        blocks_env=os.environ.get("TPU_MPI_BENCH_BLOCKS"), **env,
    )[0])
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
        # the secondary resolves its own schedule (the explicit block
        # count applies to the primary only, as in the root bench)
        rec[second_dtype] = run_dtype(
            second_dtype, n=n, device=device, blocks_env=None, **env,
        )[0]
    if dist.world().rank == 0:
        print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
