#!/usr/bin/env bash
# What the instrument spine costs when none of its flags is given: two
# checkouts of the port (A, B) run the same flagless paths on one card in
# ROUNDS rounds (default 3) of the order A B B A, so a drift of the card
# over the call shows as a difference between runs of one tree:
#   * stencil2d --rdma at the driver's sizes (1024 x 524288 float32 a rank,
#     --kernel hand: the hand RDMA exchange and allreduce), 300 iterations
#     after 2 warmup; its ITER lines (exchange means and minima);
#   * collbench at its ladder (4 KiB-16 MiB float32) over the library tier
#     and the hand ring and one-shot tiers at --n-iter 100; its COLL lines.
# Then B once more with --telemetry --jsonl, the price of the spans when
# they are on. Every run's whole output goes to OUT/<tree><i>_<path>.log
# and its result lines to standard output, after the card's name and
# power limit; last, each tree's median over its runs of every ITER
# exchange mean and minimum and every COLL row. Exits non-zero if any run
# failed.
#
#   [ROUNDS=3] gpu/flagless_ab.sh A_DIR B_DIR [OUT]
#       (default OUT: build/flagless_ab)
set -u
a=$(cd "$1" && pwd)
b=$(cd "$2" && pwd)
out=${3:-build/flagless_ab}
mkdir -p "$out"
out=$(cd "$out" && pwd)
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
rc=0

run() {  # run TAG DIR PATTERN MODULE ARGS...: the run's lines matching PATTERN
  local tag=$1 dir=$2 pattern=$3
  shift 3
  if (cd "$dir" && python -m "$@") > "$out/$tag.log" 2>&1; then
    grep -E "$pattern" "$out/$tag.log" | sed "s|^|$tag: |"
  else
    echo "$tag: FAILED (exit $?)"
    tail -n 20 "$out/$tag.log" | sed "s|^|$tag: |"
    rc=1
  fi
}

stencil=(tpu_mpi_tests_torch.drivers.stencil2d --device cuda
         --n-local 1024 --n-other 524288 --n-iter 300 --n-warmup 2
         --kernel hand --rdma)
coll=(tpu_mpi_tests_torch.drivers.collbench --device cuda --collectives
      allgather,allreduce,allgather_rdma,allreduce_rdma,allgather_oneshot,allreduce_oneshot
      --n-iter 100)

i=0
for round in $(seq "${ROUNDS:-3}"); do
  for tree in A B B A; do
    i=$((i + 1))
    dir=$a
    [ "$tree" = B ] && dir=$b
    run "${tree}${i}_stencil2d" "$dir" '^ITER' "${stencil[@]}"
    run "${tree}${i}_collbench" "$dir" '^COLL' "${coll[@]}"
  done
done
run "B$((i + 1))_stencil2d_telemetry" "$b" '^ITER' "${stencil[@]}" \
  --telemetry --jsonl "$out/telemetry.jsonl"
python3 - "$out" <<'PY'
import glob, os, re, statistics, sys
rows = {}
for path in sorted(glob.glob(os.path.join(sys.argv[1], "*.log"))):
    name = os.path.basename(path)[:-4]
    tree = name[0] + ("+telemetry" if "telemetry" in name else "")
    for line in open(path):
        m = re.match(r"ITER dim:(\d), device , buf:(\d); exchange "
                     r"mean=(\S+), min=(\S+),", line)
        if m:
            key = f"ITER dim{m[1]} buf{m[2]}"
            rows.setdefault((key + " mean us", tree), []).append(
                float(m[3]) * 1e6)
            rows.setdefault((key + " min us", tree), []).append(
                float(m[4]) * 1e6)
        m = re.match(r"COLL (\w+) bytes=(\d+) (\S+) us/iter", line)
        if m:
            rows.setdefault((f"COLL {m[1]} {m[2]} us", tree), []).append(
                float(m[3]))
for key in sorted({k for k, _ in rows}):
    cells = [f"{t} median {statistics.median(v):.2f} of {len(v)}"
             for (k, t), v in sorted(rows.items()) if k == key]
    print(f"MEDIAN {key}: " + "; ".join(cells))
PY
exit $rc
