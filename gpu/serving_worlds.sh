#!/usr/bin/env bash
# The serving-era specs over ranks on one host's cards: moe, embedding
# and decode at world 2 and 4 (torchrun --standalone, one process a
# card, NCCL), bf16 at published widths: the MoE tokens at Mixtral 8x7B's
# hidden width (8192 x 4096), Llama 3 8B's embedding table (128256 x
# 4096), the decode all-reduce at Llama 3 70B's hidden width (8192 heads
# a token, batches 1, 8, 32).
#
# Each world: moe and embedding under --tune (rank 0 prices both
# schedules, every rank runs the broadcast winner), decode under --tune
# on a fresh cache (the coll_variant sweep over torch, rdma, oneshot),
# the same decode as cache hits, and again armed with --metrics-port 0
# --metrics-all-ranks (every rank serves /metrics and writes heartbeats).
# Logs, JSONL (one .p<rank> file a rank) and caches go under OUT
# (default chiprun_out/serving); the card's name and power limit first.
#
#   bash gpu/serving_worlds.sh [OUT]   # one host, four cards, < 1500 s
set -euo pipefail
OUT=${1:-chiprun_out/serving}
WORLDS=${WORLDS:-2 4}
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader \
    | tee "$OUT/cards.txt"
python -c "from tpu_mpi_tests_torch.kernels import build; build.build()"

run() {  # world case spec args...
    local w=$1 case=$2 dir
    shift 2
    dir="$OUT/${case}_w$w"
    echo "== world $w $case: $*"
    # one stdout and stderr file a rank (torchrun's log dir)
    if ! torchrun --standalone --nproc-per-node "$w" --log-dir "$dir" \
            --redirects 3 -m tpu_mpi_tests_torch.workloads "$@" \
            --jsonl "$dir.jsonl" > "$dir.log" 2>&1; then
        tail -n 40 "$dir.log"
        find "$dir" -name "std*.log" -exec tail -n 20 {} +
        return 1
    fi
    for f in $(find "$dir" -path "*/attempt_0/*/stdout.log" | sort); do
        echo "-- rank $(basename "$(dirname "$f")")"
        grep -E "^(ROUTE|EMBED|DECODE|WORKLOAD|TUNE|NOTE|METRICS|moe|embedding|decode)" \
            "$f" || true
    done
}

for w in $WORLDS; do
    cache="$OUT/tune_w$w.json"
    run "$w" moe moe --tokens 8192 --d-model 4096 --dtype bfloat16 \
        --tune --tune-cache "$cache"
    run "$w" embedding embedding --vocab 128256 --d-model 4096 \
        --dtype bfloat16 --tune --tune-cache "$cache"
    run "$w" decode decode --heads 8192 --batches 1,8,32 \
        --dtype bfloat16 --tune --tune-cache "$cache"
    run "$w" decode_hit decode --heads 8192 --batches 1,8,32 \
        --dtype bfloat16 --tune-cache "$cache"
    run "$w" decode_live decode --heads 8192 --batches 1,8,32 \
        --dtype bfloat16 --tune-cache "$cache" --metrics-port 0 \
        --metrics-interval 0.2 --metrics-all-ranks
done
python - "$OUT" <<'PY'
import glob, json, os, sys
out = sys.argv[1]
for path in sorted(glob.glob(os.path.join(out, "decode_live_w*.p*.jsonl"))):
    recs = [json.loads(ln) for ln in open(path)]
    beats = [r for r in recs if r.get("kind") == "health"
             and r.get("event") == "heartbeat"]
    print(f"LIVE {os.path.basename(path)}: {len(beats)} heartbeats, "
          f"final={beats[-1].get('final') if beats else None}, "
          f"rank={beats[-1].get('rank') if beats else None}")
PY
