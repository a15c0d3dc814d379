"""Device time in ``torch.profiler`` Chrome traces, one JSON line a trace.

    python gpu/trace_summary.py DIR [DIR ...]

For every ``trace_*.json`` under each DIR (what ``--profile-dir`` writes,
one file a rank): the window from the first device event's start to the
last one's end, the device's busy time in it (the union of the kernel,
copy and set intervals over every stream, so overlapping streams count
once) and its idle share, and each group's summed kernel time — NCCL
(``nccl`` in the name), the heat update, the dual step, pack/unpack and
the rest; and the device time in which kernels (copies, sets) of two or
more streams ran at once (``overlap_ms``, the overlap engine's proof that
its comm stream ran beside the compute stream), with the streams seen.
Only the card's own events count: a trace taken on the CPU has none and
reports a zero window.
"""

from __future__ import annotations

import glob
import json
import os
import sys

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
GROUPS = (("nccl", ("nccl",)), ("heat2d", ("heat2d",)),
          ("dual_dim_step", ("dual",)), ("pack", ("pack", "unpack")))


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def stream_of(event: dict):
    """The stream a device event ran on (``args.stream``; the thread id
    of the trace's device lane where that is missing)."""
    return event.get("args", {}).get("stream", event.get("tid"))


def overlap_us(spans) -> float:
    """Time in which intervals of two or more streams were open at once:
    ``spans`` is ``[(start, end, stream), ...]``."""
    edges = sorted([(lo, 1, s) for lo, _, s in spans]
                   + [(hi, -1, s) for _, hi, s in spans],
                   key=lambda e: (e[0], e[1]))  # ends before starts
    active, total, last = {}, 0.0, None
    for t, step, s in edges:
        if last is not None and sum(1 for n in active.values() if n) >= 2:
            total += t - last
        active[s] = active.get(s, 0) + step
        last = t
    return total


def summarize(path: str) -> dict:
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    spans, by_group, streamed = [], {}, []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        start, dur = float(e["ts"]), float(e.get("dur", 0.0))
        spans.append((start, start + dur))
        streamed.append((start, start + dur, stream_of(e)))
        g = group_of(e.get("name", ""))
        by_group[g] = by_group.get(g, 0.0) + dur
    busy, end = 0.0, None
    for lo, hi in sorted(spans):  # the union of the intervals
        if end is None or lo > end:
            busy += hi - lo
            end = hi
        elif hi > end:
            busy += hi - end
            end = hi
    window = (max(h for _, h in spans) - min(lo for lo, _ in spans)
              if spans else 0.0)
    return {"trace": path, "window_ms": window / 1e3,
            "busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / window if window else None,
            "kernel_ms_by_group": {g: t / 1e3 for g, t in
                                   sorted(by_group.items())},
            "overlap_ms": overlap_us(streamed) / 1e3,
            "streams": len({s for _, _, s in streamed}),
            "device_events": len(spans)}


def main(argv) -> int:
    if not argv:
        print(__doc__.strip().splitlines()[2].strip(), file=sys.stderr)
        return 2
    paths = sorted(p for d in argv
                   for p in glob.glob(os.path.join(d, "trace_*.json")))
    if not paths:
        print(f"no trace_*.json under {argv}", file=sys.stderr)
        return 1
    for p in paths:
        print(json.dumps(summarize(p)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
