#!/bin/bash
# Launch wrapper of the port (≅ tpu/run.sh, itself ≅ summit/run.sh): runs
# ONE rank's share of a driver of tpu_mpi_tests_torch.drivers on the card.
# Over several ranks, start it once a rank: torchrun (RANK / WORLD_SIZE)
# or native/tpumt_run (JAX_PROCESS_ID / JAX_NUM_PROCESSES) sets the
# variables the port's comm/dist.py and this script's rank tag read;
# gpu/job.sh does it for a world on one host.
#
# Usage: gpu/run.sh device|managed torch|nsys|none <driver> [driver args...]
#   arg1: memory space twin (≅ um|noum managed/unmanaged binaries):
#         mpi_daxpy_nvtx gets --space, stencil2d --managed
#   arg2: profiler: torch writes a torch.profiler Chrome trace under
#         profile/<tag> (--profile-dir); nsys runs the driver under
#         `nsys profile -o profile/<tag>` and fails when nsys is not on
#         PATH; none
#   arg3: driver module under tpu_mpi_tests_torch.drivers (e.g.
#         mpi_daxpy_nvtx, stencil2d, daxpy)
# Output: out-<tag>.txt in the CWD (+ out-<tag>.jsonl); summarise with
# tpu/avg.py.

set -eu

if [ $# -lt 3 ]; then
  echo "Usage: $0 device|managed torch|nsys|none <driver> [driver args...]"
  exit 1
fi

space=$1
prof=$2
driver=$3
shift 3

case "$space" in device|managed) ;; *)
  echo "run.sh: space must be device or managed, got '$space'" >&2
  exit 1 ;;
esac
case "$prof" in torch|nsys|none) ;; *)
  echo "run.sh: profiler must be torch, nsys or none, got '$prof'" >&2
  exit 1 ;;
esac

repo_dir=$(cd "$(dirname "$0")/.." && pwd)
# the rank tag (≅ %q{PMIX_RANK}): two ranks on one host must not share
# out-<tag>.txt or profile/<tag>
rank="${RANK:-${JAX_PROCESS_ID:-}}"
world="${WORLD_SIZE:-${JAX_NUM_PROCESSES:-}}"
tag="${space}_${prof}_${driver}_$(hostname -s)"
tag="${tag}${world:+_w${world}}${rank:+_r${rank}}"

launch=()
prof_args=()
case "$prof" in
  torch)
    mkdir -p profile
    prof_args=(--profile-dir "profile/${tag}")
    ;;
  nsys)
    if ! command -v nsys > /dev/null; then
      echo "run.sh: profiler nsys requested but nsys is not on PATH" >&2
      exit 1
    fi
    mkdir -p profile
    launch=(nsys profile -o "profile/${tag}" --force-overwrite true)
    ;;
esac

space_args=()
case "$driver" in
  mpi_daxpy_nvtx) space_args=(--space "$space") ;;
  stencil2d) if [ "$space" == "managed" ]; then space_args=(--managed); fi ;;
esac

PYTHONPATH="$repo_dir${PYTHONPATH:+:$PYTHONPATH}" \
  ${launch[@]+"${launch[@]}"} python -m "tpu_mpi_tests_torch.drivers.${driver}" \
  ${space_args[@]+"${space_args[@]}"} ${prof_args[@]+"${prof_args[@]}"} \
  --jsonl "out-${tag}.jsonl" "$@" > "out-${tag}.txt" 2>&1
echo "wrote out-${tag}.txt"
