#!/usr/bin/env bash
# Chained rows as CUDA graph replays over ranks: the chain_rate sites
# whose bodies run NCCL (point-to-point and collectives) or the RDMA
# kernels across cards, captured at world W on one host's cards, one
# process a card (torchrun --standalone):
#   * collbench: every collective at 4 KiB-16 MiB (the library tier over
#     NCCL, the hand rings, the one-shot), then --collectives auto --tune
#     on a fresh cache at 4-64 KiB (the coll_variant sweep, graph-timed);
#   * decode (bf16, Llama 3 70B's 8192 heads, batches 1, 8, 32) under
#     --tune on a fresh cache;
#   * attnbench's ring and ulysses tiers (NCCL point-to-point, all-to-all);
#   * stencil2d --iterate-tier auto --tune (the tier sweep's chains over
#     NCCL point-to-point and the RDMA ring);
#   * the stencil1d spec's --staging auto --tune (the halo/staging sweep's
#     feedback chains);
#   * the bench's blocks and rdma-fused tiers at 8192²;
#   * graph_chain_check: the bench's blocks (k=8), rdma-chained and
#     rdma-fused (k=4) tiers at 8192² f32 and the collbench all-reduce and
#     all-gather loops of every tier at 4 and 64 KiB, each timed by
#     chain_rate eagerly and as graph replays from copies of one start on
#     every rank (chip_smoke.chain_both), the final states equal bit for
#     bit (CHAIN <path>_world<w>_rank<r> lines);
#   * gpu/capture_cost.py: the host cost of capturing the k=1 schedules.
# A run whose capture fails exits non-zero: its last lines are printed
# and the script exits 1 at the end. Every run's output goes to
# OUT/<name>.log; its result lines to standard output, after the card's
# name and power limit.
#
#   [WORLD=4] bash gpu/graph_worlds.sh [OUT]   (default chiprun_out/graph_worlds)
#   WORLD=2 bash gpu/graph_worlds.sh OUT cpu   (a gloo dry run, tiny shapes)
set -u
out=${1:-chiprun_out/graph_worlds}
mode=${2:-gpu}
w=${WORLD:-4}
repo=$(cd "$(dirname "$0")/.." && pwd)
export PYTHONPATH="$repo${PYTHONPATH:+:$PYTHONPATH}"
mkdir -p "$out"
rc=0

if [ "$mode" = cpu ]; then
  dev=(--device cpu)
  sizes=4,64
  tune_sizes=4
  attn=(--seq-len 256 --head-dim 16 --n-iter 10)
  sten=(--n-local 32 --n-other 64 --n-iter 3)
  s1d=(--n-global 4096)
  bench_env=(TPU_MPI_BENCH_N=128 TPU_MPI_BENCH_ITERS_SHORT=50
             TPU_MPI_BENCH_ITERS_LONG=250 TPU_MPI_BENCH_SAMPLES=1)
  capture=()
else
  nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
  dev=()
  sizes=4,64,1024,16384
  tune_sizes=4,16,64
  attn=(--seq-len 32768 --head-dim 128 --n-iter 20)
  sten=(--n-local 1024 --n-other 524288 --n-iter 30 --kernel hand)
  s1d=()
  bench_env=()
  capture=(1)
  python -c "from tpu_mpi_tests_torch.kernels import build; build.build()" \
    > "$out/build.log" 2>&1 || { tail -n 20 "$out/build.log"; exit 1; }
fi

run() {  # run NAME PATTERN COMMAND...: the command's lines matching PATTERN
  local name=$1 pattern=$2
  shift 2
  # a hung NCCL capture ends at the limit instead of holding the cards
  if timeout -k 10 "${RUN_LIMIT_S:-420}" "$@" > "$out/$name.log" 2>&1; then
    grep -E "$pattern" "$out/$name.log" | sed "s|^|$name: |"
  else
    echo "$name: FAILED (exit $?)"
    tail -n 30 "$out/$name.log"
    rc=1
  fi
}

# one process a card (a command, not a function: timeout runs it)
trun=(torchrun --standalone --nproc-per-node "$w" -m)

run collbench '^COLL' "${trun[@]}" tpu_mpi_tests_torch.drivers.collbench \
  ${dev[@]+"${dev[@]}"} --sizes-kib "$sizes" --n-iter 200
run collbench_tune '^(COLL|  TUNE coll_variant|  SWEEP coll_variant)' \
  "${trun[@]}" tpu_mpi_tests_torch.drivers.collbench ${dev[@]+"${dev[@]}"} \
  --collectives auto --tune --tune-cache "$out/coll_tune.json" \
  --sizes-kib "$tune_sizes" --n-iter 200 --verbose
run decode '^(decode|DECODE|  TUNE coll_variant)' \
  "${trun[@]}" tpu_mpi_tests_torch.workloads decode ${dev[@]+"${dev[@]}"} \
  --heads 8192 --batches 1,8,32 --dtype bfloat16 --tune \
  --tune-cache "$out/decode_tune.json"
run attnbench '^ATTN' "${trun[@]}" tpu_mpi_tests_torch.drivers.attnbench \
  ${dev[@]+"${dev[@]}"} --tiers ring,ulysses "${attn[@]}"
run stencil2d '^(TUNE|  TUNE stencil|  SWEEP stencil|ITER|TEST)' \
  "${trun[@]}" tpu_mpi_tests_torch.drivers.stencil2d ${dev[@]+"${dev[@]}"} \
  "${sten[@]}" --iterate-tier auto --tune --verbose \
  --tune-cache "$out/stencil2d_tune.json"
run stencil1d '(TUNE|SWEEP) halo/staging' \
  "${trun[@]}" tpu_mpi_tests_torch.workloads stencil1d ${dev[@]+"${dev[@]}"} \
  ${s1d[@]+"${s1d[@]}"} --staging auto --tune --verbose \
  --tune-cache "$out/stencil1d_tune.json"
for tier in blocks rdma-fused; do
  run "bench_$tier" '^\{' env ${bench_env[@]+"${bench_env[@]}"} \
    TPU_MPI_BENCH_TIER=$tier TPU_MPI_BENCH_SECOND_DTYPE=none \
    "${trun[@]}" tpu_mpi_tests_torch.bench ${dev[@]+"${dev[@]}"}
done
chain_check='
import torch
import chip_smoke as CS
from tpu_mpi_tests_torch import bench
from tpu_mpi_tests_torch.comm import dist
from tpu_mpi_tests_torch.drivers import collbench
w = dist.init("cuda")
tag = f"world{w.size}_rank{w.rank}"
for tier, k in (("blocks", 8), ("rdma-chained", 4), ("rdma-fused", 4)):
    run, state, _, _ = bench.build_schedule(
        "float32", n=CS.BENCH_N, steps=k, n_blocks=0, tier=tier,
        device=w.device)
    n_short = max(1, CS.BENCH_ITERS_SHORT // k)
    CS.chain_both(f"bench_{tier}_float32_{CS.BENCH_N}_k{k}_{tag}", run,
                  state, n_short, max(n_short + 1, CS.BENCH_ITERS_LONG // k))
    del run, state
for name in ("allreduce", "allreduce_rdma", "allreduce_oneshot",
             "allgather", "allgather_rdma", "allgather_oneshot"):
    for kib in (4, 64):
        CS.chain_both(f"collbench_{name}_{kib}KiB_{tag}",
                      collbench._loop_fn(name, w.size, w.rank),
                      torch.ones(kib * 256, device=w.device),
                      *CS.CHAIN_COLL_ITERS)
'
if [ -n "${capture[*]}" ]; then
  run graph_chain_check '^CHAIN' torchrun --standalone --nproc-per-node \
    "$w" --no-python python -c "$chain_check"
  run capture_cost '^CAPTURE' torchrun --standalone --nproc-per-node "$w" \
    "$repo/gpu/capture_cost.py" 50 100 200 400
fi
exit $rc
