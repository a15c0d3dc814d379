#!/bin/bash
# The multi-card protocol of the port (≅ tpu/pod.sh): ONE submission that
# turns a host of several cards (four, say) into the multi-rank rows, one
# process a card:
#
#   1. the bench at world N (gpu/world_timings.sh's bench runs, blocks and
#      rdma-fused tiers, at world 1 and N);
#   2. collbench sweeps: the library tier against the hand ring tiers,
#      allreduce_rdma at credits 1 and 2 (NCCL under both);
#   3. causal ring attention, contiguous against striped, f32 and bf16
#      (--fast), attnbench's ring tier (the wall clock over ranks that
#      microbench stripebalance proxies on one card);
#   4. the stencil2d halo driver at the reference's scale (exact gates);
#   5. gather_inplace over the hand ring all-gather;
#   6. the serving-era specs at world N (gpu/serving_worlds.sh);
#   7. the chaos kill and straggler legs at world 2 (the daxpy spec,
#      `kill:rank=1:phase=kernel:after=10`, `straggler:rank=1:delay_ms=25`)
#      under native/tpumt_run, whose survivor keeps recording: their JSONL
#      is for the JAX tpumt-doctor on a machine with the JAX package.
#
# Every cell lands in OUTDIR as out-pod-<cell>.{txt,jsonl} (torchrun's
# per-rank logs under OUTDIR/logs/<cell>); the run ends with
# OUTDIR/PODRUN.json, a MULTICHIP_r*.json-shaped summary:
#   {"ok": bool, "world": N, "platform": "gpu", "devices": [...],
#    "cells": {name: rc}}
# where a chaos cell's rc is 0 when the leg exited with its injected code.
#
# Usage:
#   gpu/pod.sh                # every card of this host (default OUTDIR
#                             # chiprun_out/pod)
#   gpu/pod.sh -w 2 -c        # dry run: a 2-process gloo world on the
#                             # CPU, tiny shapes, no serving cell
#   gpu/pod.sh -o DIR         # write under DIR
# Exits non-zero if any cell failed.

set -u

outdir=chiprun_out/pod
world=0   # 0 = every card this host has
ci=0
while getopts "o:w:ch" opt; do
  case "$opt" in
    o) outdir=$OPTARG ;;
    w) world=$OPTARG ;;
    c) ci=1 ;;
    h)
      sed -n '2,/^$/p' "$0" | grep '^#' | sed 's/^# \{0,1\}//'
      exit 0
      ;;
    *) exit 1 ;;
  esac
done
shift $((OPTIND - 1))

gpu_dir=$(cd "$(dirname "$0")" && pwd)
repo_dir=$(cd "$gpu_dir/.." && pwd)
export PYTHONPATH="$repo_dir${PYTHONPATH:+:$PYTHONPATH}"
mkdir -p "$outdir/logs"
outdir=$(cd "$outdir" && pwd)
cd "$repo_dir"

if [ "$ci" -eq 1 ]; then
  [ "$world" -gt 0 ] || world=2
  dev=(--device cpu)
  sizes_kib="4,64"
  coll_iter=20
  attn_args=(--seq-len 256 --head-dim 16 --n-iter 10)
  sten_args=(--n-local 32 --n-other 64 --n-iter 3)
  gather_args=(--n-per-rank 1024)
  daxpy_n=(--n 1048576)
  kill_iters=40
  bench_env=(TPU_MPI_BENCH_N=128 TPU_MPI_BENCH_ITERS_SHORT=50
             TPU_MPI_BENCH_ITERS_LONG=1050 TPU_MPI_BENCH_SAMPLES=1)
else
  nvidia-smi --query-gpu=name,power.limit --format=csv,noheader \
    | tee "$outdir/cards.txt"
  [ "$world" -gt 0 ] || world=$(nvidia-smi -L | wc -l)
  dev=()
  sizes_kib="4,64,1024,16384"
  coll_iter=200
  attn_args=(--seq-len 32768 --head-dim 128 --n-iter 20)
  sten_args=(--n-local 1024 --n-other 524288 --n-iter 30 --kernel hand)
  gather_args=(--n-per-rank 16777216)
  daxpy_n=(--n 67108864)
  # the survivor must record on for over a second past the death
  kill_iters=5000
  bench_env=()
  python -c "from tpu_mpi_tests_torch.kernels import build; build.build()" \
    > "$outdir/build.log" 2>&1 || { tail -n 20 "$outdir/build.log"; exit 1; }
fi

declare -A cell_rc=()
run_cell() {
  # run_cell NAME WANT -- CMD...: the command's output to out-pod-NAME.txt;
  # the cell passes when it exits WANT
  local name=$1 want=$2 rc=0
  shift 3
  echo "== pod cell: $name" >&2
  "$@" > "$outdir/out-pod-${name}.txt" 2>&1 || rc=$?
  if [ "$rc" -eq "$want" ]; then
    cell_rc[$name]=0
  else
    cell_rc[$name]=$rc
    echo "   cell $name FAILED rc=$rc (want $want)" >&2
    tail -n 15 "$outdir/out-pod-${name}.txt" >&2
  fi
}

trun() {  # trun CELL MODULE ARGS...: one process a rank
  local cell=$1
  shift
  torchrun --standalone --nproc-per-node "$world" --log-dir \
    "$outdir/logs/$cell" --tee 3 -m "$@"
}

# 1. the bench at world 1 and N
if [ "$ci" -eq 1 ]; then
  run_cell bench 0 -- env ${bench_env[@]+"${bench_env[@]}"} \
    torchrun --standalone --nproc-per-node "$world" \
    -m tpu_mpi_tests_torch.bench --device cpu
else
  run_cell bench 0 -- env WORLDS="1 $world" TIERS="blocks rdma-fused" \
    "$gpu_dir/world_timings.sh" "$outdir/world_timings" bench
fi

# 2. collective sweeps: the library tier, the hand rings at credits 1, 2
run_cell coll-torch 0 -- trun coll-torch tpu_mpi_tests_torch.drivers.collbench \
  ${dev[@]+"${dev[@]}"} --sizes-kib "$sizes_kib" --n-iter "$coll_iter" \
  --jsonl "$outdir/out-pod-coll-torch.jsonl"
run_cell coll-rdma-c1 0 -- trun coll-rdma-c1 \
  tpu_mpi_tests_torch.drivers.collbench ${dev[@]+"${dev[@]}"} \
  --sizes-kib "$sizes_kib" --n-iter "$coll_iter" \
  --collectives allgather_rdma,allreduce_rdma --rdma-credits 1 \
  --jsonl "$outdir/out-pod-coll-rdma-c1.jsonl"
run_cell coll-rdma-c2 0 -- trun coll-rdma-c2 \
  tpu_mpi_tests_torch.drivers.collbench ${dev[@]+"${dev[@]}"} \
  --sizes-kib "$sizes_kib" --n-iter "$coll_iter" \
  --collectives allreduce_rdma --rdma-credits 2 \
  --jsonl "$outdir/out-pod-coll-rdma-c2.jsonl"

# 3. causal ring attention, contiguous against striped, both dtypes
for dt in f32 bf16; do
  if [ "$dt" = f32 ]; then dt_args=(--dtype float32)
  else dt_args=(--dtype bfloat16 --fast); fi
  for layout in contig striped; do
    stripe=()
    [ "$layout" = striped ] && stripe=(--stripe)
    run_cell "attn-$layout-$dt" 0 -- trun "attn-$layout-$dt" \
      tpu_mpi_tests_torch.drivers.attnbench ${dev[@]+"${dev[@]}"} \
      --tiers ring --causal ${stripe[@]+"${stripe[@]}"} "${attn_args[@]}" \
      "${dt_args[@]}" --jsonl "$outdir/out-pod-attn-$layout-$dt.jsonl"
  done
done

# 4. the halo exchange driver (exact gates inside)
run_cell stencil2d 0 -- trun stencil2d tpu_mpi_tests_torch.drivers.stencil2d \
  ${dev[@]+"${dev[@]}"} "${sten_args[@]}" \
  --jsonl "$outdir/out-pod-stencil2d.jsonl"

# 5. the in-place gather through the hand ring all-gather
run_cell gather-rdma 0 -- trun gather-rdma \
  tpu_mpi_tests_torch.drivers.gather_inplace ${dev[@]+"${dev[@]}"} \
  "${gather_args[@]}" --rdma --jsonl "$outdir/out-pod-gather.jsonl"

# 6. the serving-era specs at world N
if [ "$ci" -eq 0 ]; then
  run_cell serving 0 -- env WORLDS="$world" \
    bash "$gpu_dir/serving_worlds.sh" "$outdir/serving"
fi

# 7. the chaos legs at world 2 under the native launcher: its survivor
#    records on after the kill (torchrun would stop it)
if make -C "$repo_dir/native" tpumt_run > "$outdir/logs/native.log" 2>&1; then
  run_cell chaos-kill 137 -- env \
    TPU_MPI_CHAOS="kill:rank=1:phase=kernel:after=10" \
    "$repo_dir/native/tpumt_run" -n 2 -o "$outdir/out-pod-chaos-kill-r" -- \
    python -c "import os, sys; \
from tpu_mpi_tests_torch.workloads.daxpy import main; \
rc = main(sys.argv[1:]); sys.stdout.flush(); sys.stderr.flush(); \
os._exit(rc)" ${dev[@]+"${dev[@]}"} "${daxpy_n[@]}" --iters "$kill_iters" \
    --telemetry --memwatch --mem-interval 0.05 \
    --jsonl "$outdir/out-pod-chaos-kill.jsonl"
  run_cell chaos-straggler 0 -- env \
    TPU_MPI_CHAOS="straggler:rank=1:delay_ms=25" \
    "$repo_dir/native/tpumt_run" -n 2 \
    -o "$outdir/out-pod-chaos-straggler-r" -- \
    python -m tpu_mpi_tests_torch.drivers.daxpy ${dev[@]+"${dev[@]}"} \
    "${daxpy_n[@]}" --iters 40 --telemetry --memwatch --mem-interval 0.05 \
    --jsonl "$outdir/out-pod-chaos-straggler.jsonl"
else
  cell_rc[chaos-kill]=127
  cell_rc[chaos-straggler]=127
  echo "   native/tpumt_run did not build (logs/native.log)" >&2
fi

python - "$outdir" "$world" "$ci" "${!cell_rc[@]}" -- "${cell_rc[@]}" <<'EOF'
import json
import os
import subprocess
import sys

outdir, world, ci = sys.argv[1], int(sys.argv[2]), sys.argv[3] == "1"
args = sys.argv[4:]
sep = args.index("--")
cells = dict(zip(args[:sep], (int(r) for r in args[sep + 1:])))
devices = []
if not ci:
    q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True)
    devices = [ln.strip() for ln in q.stdout.splitlines() if ln.strip()]
out = {"ok": bool(cells) and all(r == 0 for r in cells.values()),
       "world": world, "platform": "cpu" if ci else "gpu",
       "devices": devices, "cells": dict(sorted(cells.items()))}
with open(os.path.join(outdir, "PODRUN.json"), "w") as f:
    json.dump(out, f, indent=1)
print(json.dumps(out))
EOF

for name in "${!cell_rc[@]}"; do
  [ "${cell_rc[$name]}" -eq 0 ] || exit 1
done
exit 0
