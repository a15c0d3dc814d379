#!/bin/bash
# Sweep matrix of the port (≅ tpu/job.sh, itself ≅ summit/job.lsf and
# jlse/job.pbs): enumerate {world sizes × drivers × memory spaces ×
# profilers}, run every cell through gpu/run.sh, and finish with a
# tpu/avg.py summary over the collected out-*.txt files — one command
# reproduces the reference's result matrix on one host's cards.
#
# Usage: gpu/job.sh [-w "1 2"] [-d "mpi_daxpy_nvtx"] [-s "device managed"]
#                   [-p "none torch"] [-a PATTERN]
#                   [-x "driver=args ..."] [-- driver args...]
#   -w  world sizes (space-separated). 1 runs one process; N>1 runs N
#       under `torchrun --standalone` (one process a card, rank r on card
#       r mod the cards; NCCL needs a card a rank). That is why the port
#       has no sibling of tpu/run_local_multiproc.sh or tpu/worldlib.sh
#   -d  driver modules under tpu_mpi_tests_torch.drivers
#   -s  memory-space twins (≅ um|noum managed/unmanaged binaries)
#   -p  profilers of gpu/run.sh (torch, nsys, none)
#   -a  tpu/avg.py pattern for the final summary (default: gather, the
#       reference's avg.sh default)
#   -x  per-driver extra args, "driver=args..." (repeatable; repeats for
#       one driver append), e.g. -x "stencil2d=--n-iter 30". Args are
#       split on whitespace with no quote parsing
# Extra args after -- go to every driver cell verbatim (all drivers must
# accept them; e.g. -- --device cpu for a dry run without a card).
#
# Output: out-<space>_<prof>_<driver>_<host>[_w<N>_r<r>].txt per cell
# (rank) in the CWD, then the aggregated table on stdout.

set -eu

worlds="1"
drivers="mpi_daxpy_nvtx"
spaces="device"
profs="none"
avg_pattern="gather"
declare -A driver_extra=()

while getopts "w:d:s:p:a:x:h" opt; do
  case "$opt" in
    w) worlds=$OPTARG ;;
    d) drivers=$OPTARG ;;
    s) spaces=$OPTARG ;;
    p) profs=$OPTARG ;;
    a) avg_pattern=$OPTARG ;;
    x)
      key=${OPTARG%%=*}
      if [ "$key" == "$OPTARG" ] || [ -z "$key" ]; then
        echo "-x needs driver=args, got: $OPTARG" >&2
        exit 1
      fi
      driver_extra[$key]="${driver_extra[$key]:-} ${OPTARG#*=}"
      ;;
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
run_sh=$gpu_dir/run.sh

# an -x key must name a driver that runs, or a typo gives a default-sized
# sweep read as if the extras applied
for key in "${!driver_extra[@]}"; do
  case " $drivers " in
    *" $key "*) ;;
    *)
      echo "-x driver '$key' not in -d list ($drivers)" >&2
      exit 1
      ;;
  esac
done

for w in $worlds; do
  for driver in $drivers; do
    for space in $spaces; do
      for prof in $profs; do
        echo "== cell: world=${w} driver=${driver} space=${space}" \
          "prof=${prof}" >&2
        # split the extras without pathname expansion (read -ra does not
        # glob; a bare $var would expand against the out-*.txt files)
        read -ra cell_extra <<< "${driver_extra[$driver]:-}"
        if [ "$w" -eq 1 ]; then
          "$run_sh" "$space" "$prof" "$driver" \
            ${cell_extra[@]+"${cell_extra[@]}"} "$@"
        elif ! torchrun --standalone --nproc-per-node "$w" --no-python \
            "$run_sh" "$space" "$prof" "$driver" \
            ${cell_extra[@]+"${cell_extra[@]}"} "$@" >&2; then
          echo "cell failed" >&2
          exit 1
        fi
      done
    done
  done
done

echo "== matrix complete; aggregating (pattern=${avg_pattern}) =="
python "$repo_dir/tpu/avg.py" --pattern "$avg_pattern" out-*.txt
