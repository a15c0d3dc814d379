#!/usr/bin/env bash
# The port's multi-rank paths timed on the cards of one host, one process
# per card (torchrun --standalone picks a free rendezvous port):
#   * the bench (stencil2d_fullstep_8192_iters_per_s, float32 then
#     bfloat16) under the blocks, rdma-chained and rdma-fused tiers at
#     world 1, 2 and 4 (8192² strong-scaled over the ranks);
#   * heat2d --kernel hand at the three heat runs (float32 k=4, float32
#     k=1, bfloat16 k=4; 200 steps) on the 1x1 grid and on the 2x2 grid,
#     weak-scaled (8192² a rank) and strong-scaled (4096² a rank);
#   * stencil2d_grid --kernel hand on the same grids (20 iterations after
#     2 warmup);
#   * mpi_daxpy_nvtx at world 1 and 4 (2^26 float32 a node, the world's
#     one host);
#   * the overlap engine: the bench's blocks tier at TPU_MPI_BENCH_STEPS=1,
#     _ov1 against _ov2, at world 1, 2 and 4; heat2d and stencil2d_grid
#     --kernel torch on the 2x2 grid, weak-scaled (8192² a rank), at
#     --overlap 1 and 2, each run once for its rates and OVERLAP record
#     (OUT/<name>.jsonl: overlap_frac, drain_s) and once, shorter, under
#     --profile-dir (OUT/prof/<name>; gpu/trace_summary.py's idle share
#     and stream overlap a rank).
# Every run's whole output goes to OUT/<name>.log and its result lines
# to standard output, after the card's name and power limit. Needs four
# cards; exits non-zero if any run failed.
#
#   gpu/world_timings.sh [OUT] [all|overlap]
#       (default OUT: build/world_timings; "overlap": that part alone)
set -u
out=${1:-build/world_timings}
mode=${2:-all}
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
rc=0

run() {  # run NAME PATTERN COMMAND...: the command's lines matching PATTERN
  local name=$1 pattern=$2
  shift 2
  if "$@" > "$out/$name.log" 2>&1; then
    grep -E "$pattern" "$out/$name.log" | sed "s|^|$name: |"
  else
    echo "$name: FAILED (exit $?)"
    tail -n 20 "$out/$name.log"
    rc=1
  fi
}

trun() {  # trun WORLD MODULE ARGS...: one process per card
  local w=$1
  shift
  torchrun --standalone --nproc-per-node "$w" -m "$@"
}

overlap_timings() {
  for w in 1 2 4; do
    for ov in 1 2; do
      run "bench_blocks_k1_ov${ov}_w$w" '^\{' env TPU_MPI_BENCH_TIER=blocks \
        TPU_MPI_BENCH_STEPS=1 TPU_MPI_BENCH_OVERLAP=$ov \
        torchrun --standalone --nproc-per-node "$w" -m tpu_mpi_tests_torch.bench
    done
  done
  for ov in 1 2; do
    run "heat2d_torch_2x2_ov$ov" '^(OVERLAP|HEAT|ITER)' \
      trun 4 tpu_mpi_tests_torch.drivers.heat2d --kernel torch --mesh 2,2 \
      --nx-local 8192 --ny-local 8192 --n-steps 200 --overlap "$ov" \
      --jsonl "$out/heat2d_torch_2x2_ov$ov.jsonl"
    run "heat2d_torch_2x2_ov${ov}_prof" '^(OVERLAP|HEAT)' \
      trun 4 tpu_mpi_tests_torch.drivers.heat2d --kernel torch --mesh 2,2 \
      --nx-local 8192 --ny-local 8192 --n-steps 20 --overlap "$ov" \
      --profile-dir "$out/prof/heat2d_torch_2x2_ov$ov"
    run "stencil2d_grid_torch_2x2_ov$ov" '^(OVERLAP|GRID|ITER)' \
      trun 4 tpu_mpi_tests_torch.drivers.stencil2d_grid --kernel torch \
      --mesh 2,2 --nx-local 8192 --ny-local 8192 --n-iter 20 --n-warmup 2 \
      --overlap "$ov" --jsonl "$out/stencil2d_grid_torch_2x2_ov$ov.jsonl"
    run "stencil2d_grid_torch_2x2_ov${ov}_prof" '^(OVERLAP|GRID)' \
      trun 4 tpu_mpi_tests_torch.drivers.stencil2d_grid --kernel torch \
      --mesh 2,2 --nx-local 8192 --ny-local 8192 --n-iter 6 --n-warmup 2 \
      --overlap "$ov" --profile-dir "$out/prof/stencil2d_grid_torch_2x2_ov$ov"
  done
  for f in "$out"/*_ov[12].p*.jsonl; do
    [ -e "$f" ] && grep -h '"kind": "overlap"' "$f" | sed "s|^|$(basename "$f"): |"
  done
  python gpu/trace_summary.py "$out"/prof/*
}

if [ "$mode" = overlap ]; then
  overlap_timings
  exit $rc
fi

for w in 1 2 4; do
  for tier in blocks rdma-chained rdma-fused; do
    run "bench_${tier}_w$w" '^\{' env TPU_MPI_BENCH_TIER=$tier \
      torchrun --standalone --nproc-per-node "$w" -m tpu_mpi_tests_torch.bench
  done
done

for run_ in "float32 4" "float32 1" "bfloat16 4"; do
  set -- $run_
  dt=$1 k=$2
  for grid in "1 1,1 8192" "4 2,2 8192" "4 2,2 4096"; do
    set -- $grid
    w=$1 mesh=$2 n=$3
    run "heat2d_${dt}_k${k}_${mesh/,/x}_n$n" '^(HEAT|ITER)' \
      trun "$w" tpu_mpi_tests_torch.drivers.heat2d --kernel hand \
      --mesh "$mesh" --nx-local "$n" --ny-local "$n" --n-steps 200 \
      --halo-steps "$k" --dtype "$dt"
  done
done

for grid in "1 1,1 8192" "4 2,2 8192" "4 2,2 4096"; do
  set -- $grid
  w=$1 mesh=$2 n=$3
  run "stencil2d_grid_${mesh/,/x}_n$n" '^(GRID|ITER)' \
    trun "$w" tpu_mpi_tests_torch.drivers.stencil2d_grid --kernel hand \
    --mesh "$mesh" --nx-local "$n" --ny-local "$n" --n-iter 20 \
    --n-warmup 2
done

for w in 1 4; do
  run "mpi_daxpy_nvtx_w$w" '(ALLSUM|TIME|nodes)' \
    trun "$w" tpu_mpi_tests_torch.drivers.mpi_daxpy_nvtx \
    --n-per-node 67108864 --dtype float32
done
overlap_timings
exit $rc
