"""Bounded-memory latency histograms (≅
``tpu_mpi_tests/serve/histogram.py``, a copy of its arithmetic).

A steady-state run completes an unbounded number of requests, so keeping
every sample for a sorted-list percentile grows without bound. This is
the fixed-footprint alternative: log-spaced buckets (HdrHistogram's idea
at benchmark scale), one integer counter per bucket, so a million
samples and ten take the same memory and a percentile read is
O(buckets).

Resolution is the bucket width: with :data:`BUCKETS_PER_DECADE` = 24 a
reported percentile is within ~±5% relative of the true sample value
(geometric-midpoint readout, half a bucket each way).

Pure stdlib: no torch, no device.
"""

from __future__ import annotations

import math

#: smallest resolvable latency (seconds); everything below lands in the
#: underflow bucket and reads back as the recorded minimum
MIN_LATENCY_S = 1e-6

#: decades covered above :data:`MIN_LATENCY_S` (1 us .. 1000 s)
DECADES = 9

#: buckets per decade of latency; 24 → ~10% bucket width, ~±5% readout
BUCKETS_PER_DECADE = 24


class LatencyHistogram:
    """Fixed-size log-bucketed latency accumulator.

    ``record`` is one index computation and two adds; ``percentile``
    walks the fixed bucket array. The footprint does not depend on the
    number of recorded samples."""

    __slots__ = ("counts", "count", "total_s", "min_s", "max_s")

    def __init__(self):
        self.counts = [0] * (DECADES * BUCKETS_PER_DECADE + 2)
        self.count = 0
        self.total_s = 0.0
        self.min_s = math.inf
        self.max_s = 0.0

    def _index(self, seconds: float) -> int:
        """Bucket index: 0 = underflow, last = overflow, in between the
        log-spaced ladder starting at :data:`MIN_LATENCY_S`."""
        if seconds < MIN_LATENCY_S:
            return 0
        idx = int(
            math.log10(seconds / MIN_LATENCY_S) * BUCKETS_PER_DECADE
        ) + 1
        return min(idx, len(self.counts) - 1)

    def record(self, seconds: float) -> None:
        if not (seconds >= 0.0):  # NaN / negative: an invalid latency
            return
        # TPM1601 suppressions: the lockset engine merges every
        # LatencyHistogram instance into one abstract location, and the
        # heartbeat/exporter threads do read histograms, but only the
        # MetricsRegistry-owned instances, whose every touch happens
        # under the registry's _lock; the serve loop's own instances
        # never leave its single thread. Per-instance ownership is the
        # blind spot of the per-class location abstraction.
        self.counts[self._index(seconds)] += 1  # tpumt: ignore[TPM1601]
        self.count += 1  # tpumt: ignore[TPM1601]
        self.total_s += seconds
        self.min_s = min(self.min_s, seconds)  # tpumt: ignore[TPM1601]
        self.max_s = max(self.max_s, seconds)  # tpumt: ignore[TPM1601]

    def mean(self) -> float | None:
        return self.total_s / self.count if self.count else None

    def percentile(self, q: float) -> float | None:
        """Nearest-rank percentile, read back as the bucket's geometric
        midpoint clamped into the observed [min, max] (so neither the
        under/overflow buckets nor the quantisation can report a latency
        outside what was recorded). None when empty."""
        if not self.count:
            return None
        rank = max(1, math.ceil(q / 100.0 * self.count))
        acc = 0
        for idx, c in enumerate(self.counts):
            acc += c
            if acc >= rank:
                if idx == 0:
                    return self.min_s
                lo = MIN_LATENCY_S * 10 ** ((idx - 1) / BUCKETS_PER_DECADE)
                hi = lo * 10 ** (1 / BUCKETS_PER_DECADE)
                mid = math.sqrt(lo * hi)
                return min(max(mid, self.min_s), self.max_s)
        return self.max_s  # unreachable: acc ends at self.count

    def reset(self) -> None:
        for i in range(len(self.counts)):
            self.counts[i] = 0
        self.count = 0
        self.total_s = 0.0
        self.min_s = math.inf
        self.max_s = 0.0

    def percentiles_ms(self) -> dict[str, float]:
        """The p50/p95/p99/mean fields in milliseconds; an empty dict
        when nothing was recorded (absent fields, never zeros)."""
        if not self.count:
            return {}
        out = {}
        for name, q in (("p50_ms", 50.0), ("p95_ms", 95.0),
                        ("p99_ms", 99.0)):
            v = self.percentile(q)
            if v is not None:
                out[name] = v * 1e3
        mean = self.mean()
        if mean is not None:
            out["mean_ms"] = mean * 1e3
        return out
