"""What a ``--telemetry --jsonl`` span adds to an exchange, split between
its wait and its JSONL writes, on one card.

:data:`EXCHANGES` exchanges of the stencil2d ``--rdma`` driver's (a
``halo_exchange`` of its dim-0 shard, 1024 × 512 Ki f32 plus ghosts,
through ``ring_halo`` on the non-periodic world-1 ring), each waited
for on the host as the driver's ITER phase does, in four modes:
telemetry off; spans with no sink; spans writing each record to a JSONL
file (a line and a flush, as the reporter does); and the same with the
span waiting device-wide (``timers.block`` in place of the wait for its
result's stream). The modes run in turns, forward and back, four
rounds; each mode's figure is the median of its rounds. Prints the card's name and power limit, then one line::

    SPANSPLIT ms an exchange (median of 4 rounds): off <ms>, spans <ms>,
        +jsonl <ms>, +device-wide wait <ms>; ...

At world 1 the exchange runs on one stream, so the device-wide wait
and the stream's wait wait for the same work: their difference is the
cost of the wait call alone.

    python gpu/span_split.py
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from tpu_mpi_tests_torch.comm import halo as H  # noqa: E402
from tpu_mpi_tests_torch.instrument import telemetry, timers  # noqa: E402

EXCHANGES = 200
MODES = ("off", "spans", "spans_jsonl", "spans_jsonl_device_wait")


def span_split(device) -> dict[str, float]:
    """The median seconds an exchange in each of :data:`MODES`."""
    z = torch.randn((CS.REF_N_LOCAL + 4, CS.REF_N_OTHER), device=device,
                    generator=torch.Generator(device=device).manual_seed(3))
    z = H.staging_buffer(z, "pallas")
    jl = os.path.join(tempfile.mkdtemp(prefix="span_split_"), "s.jsonl")
    stream_wait = timers.block_stream
    samples = {m: [] for m in MODES}
    with open(jl, "a") as f:
        def sink(rec):
            f.write(json.dumps(rec) + "\n")
            f.flush()

        def timed(mode):
            if mode != "off":
                telemetry.enable(sink=None if mode == "spans" else sink)
            if mode.endswith("device_wait"):
                timers.block_stream = timers.block
            try:
                timers.block(H.halo_exchange(z, 0, 2, False, "pallas"))
                t0 = time.perf_counter()
                for _ in range(EXCHANGES):
                    timers.block(H.halo_exchange(z, 0, 2, False, "pallas"))
                return (time.perf_counter() - t0) / EXCHANGES
            finally:
                timers.block_stream = stream_wait
                telemetry.disable()

        for order in (MODES, MODES[::-1]) * 2:
            for mode in order:
                samples[mode].append(timed(mode))
    return {m: statistics.median(v) for m, v in samples.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("span_split: needs a card", file=sys.stderr)
        return 1
    CS.log(CS.card_line())
    ms = {k: v * 1e3 for k, v in span_split(torch.device("cuda", 0)).items()}
    CS.log(f"SPANSPLIT ms an exchange (median of 4 rounds): off "
           f"{ms['off']:.4f}, spans {ms['spans']:.4f}, +jsonl "
           f"{ms['spans_jsonl']:.4f}, +device-wide wait "
           f"{ms['spans_jsonl_device_wait']:.4f}; the device-wide wait "
           f"{ms['spans_jsonl_device_wait'] - ms['spans_jsonl']:.4f}, the "
           f"jsonl writes {ms['spans_jsonl'] - ms['spans']:.4f}, the span "
           f"itself {ms['spans'] - ms['off']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
