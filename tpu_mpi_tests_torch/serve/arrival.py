"""Request arrival processes for the serving loop (≅
``tpu_mpi_tests/serve/arrival.py``; the same seeds give the same
schedules, draw for draw).

Two load models (the open-vs-closed distinction of Schroeder's "Open
Versus Closed" — conflating them is the classic benchmarking bug):

* **Open loop** (:class:`OpenLoopPoisson`): arrivals are scheduled by an
  external Poisson clock that does NOT care whether the system keeps up.
  A request's latency is measured from its *scheduled* arrival, so a
  stalled server accumulates queue delay instead of silently slowing the
  generator down (coordinated omission is impossible by construction).

* **Closed loop** (:class:`ClosedLoop`): a fixed population of
  ``concurrency`` logical clients, each issuing its next request the
  moment the previous one completes — the throughput-under-load probe.

Both are driven by the single-threaded serve loop through one small
interface: ``start(t0)`` anchors the process, ``take_due(now, limit)``
pops the arrival times that have come due, ``next_event()`` tells the
loop how long it may sleep, ``on_complete(n, now)`` feeds completions
back (a no-op for the open loop). Times are whatever monotonic clock the
loop uses; the processes never read a clock themselves, which is what
makes them deterministic under a seeded RNG and testable without one.

Pure stdlib (``random.Random``).
"""

from __future__ import annotations

import random


class OpenLoopPoisson:
    """Poisson arrivals at ``rate_hz``: exponential inter-arrival gaps
    from a seeded ``random.Random`` stream — two instances with the same
    (rate, seed) generate the same schedule."""

    def __init__(self, rate_hz: float, seed: int = 0):
        if not rate_hz > 0:
            raise ValueError(f"rate_hz must be positive, got {rate_hz}")
        self.rate_hz = float(rate_hz)
        self._rng = random.Random(f"poisson:{seed}")
        self._next: float | None = None

    def start(self, t0: float) -> None:
        self._next = t0 + self._rng.expovariate(self.rate_hz)

    def take_due(self, now: float, limit: float | None = None) -> list[float]:
        """Arrival times scheduled at or before ``now`` (and at or before
        ``limit`` — the run deadline: arrivals past it are never
        generated, so a drain after the deadline terminates)."""
        if self._next is None:
            return []
        due: list[float] = []
        cutoff = now if limit is None else min(now, limit)
        while self._next <= cutoff:
            due.append(self._next)
            self._next += self._rng.expovariate(self.rate_hz)
        return due

    def next_event(self) -> float | None:
        return self._next

    def on_complete(self, n: int, now: float) -> None:
        pass  # open loop: completions never gate arrivals


class ClosedLoop:
    """``concurrency`` logical clients, each re-issuing on completion.

    ``start`` schedules the initial population at ``t0``; every
    completion re-arms that many clients at the completion time. The
    offered rate is whatever the system sustains — which is the point.
    """

    def __init__(self, concurrency: int):
        # no RNG here: a fixed population re-issuing on completion is
        # deterministic by construction (the mix drawer has the stream)
        if concurrency < 1:
            raise ValueError(
                f"concurrency must be >= 1, got {concurrency}"
            )
        self.concurrency = int(concurrency)
        self._pending: list[float] = []

    def start(self, t0: float) -> None:
        self._pending = [t0] * self.concurrency

    def take_due(self, now: float, limit: float | None = None) -> list[float]:
        cutoff = now if limit is None else min(now, limit)
        due = [t for t in self._pending if t <= cutoff]
        self._pending = [t for t in self._pending if t > cutoff]
        return due

    def next_event(self) -> float | None:
        return min(self._pending) if self._pending else None

    def on_complete(self, n: int, now: float) -> None:
        self._pending.extend([now] * n)
