"""Online re-tune controller (≅ ``tpu_mpi_tests/tune/controller.py``):
observability → schedule → SLO, closed.

The metrics tee (``instrument/metrics.py``) latches ``kind:"health"
event:"tune_stale"`` when an op's rolling achieved GB/s (or
``roofline_frac``) sags below the tuned winner's own fresh baseline, and
the serve loop (``serve/loop.py``) has a between-windows point where
nothing is mid-batch. The controller subscribes to the stale latch and,
at the next window boundary, runs a BOUNDED re-sweep of the sagging
class's knob — quarantine-style degraded service: arrivals keep queueing
while it runs, the watchdog stays armed, and the budget is the batch
deadline — then hot-swaps the handler through ``registry.resolve`` (the
re-sweep persisted a new winner, so a rebuild with no explicit value
picks it up) and emits a ``kind:"control" event:"tune_swap"`` record.
``tpumt-report`` renders those as the CONTROL table, ``tpumt-trace``
places them as instant markers, and ``tpumt-doctor`` convicts
``stale_schedule`` exactly where a stale latch was left unanswered.

Every rebuild and probe — the only device work here — runs on the serve
loop's thread, inside :meth:`TuneController.window_boundary`; the latch
callback only records.

Handler contract (``drivers/_common.py`` workload registry): a serve
factory that wants closed-loop re-tuning attaches ``step.tune_info``::

    step.tune_info = {
        "knob": "coll_variant/allreduce",   # the declared space
        "ctx": {...},                       # its fingerprint context
        "candidates": (...),                # or None = the space's
        "rebuild": callable(value) -> step  # build a new handler;
    }                                       # value None = re-resolve

``rebuild`` must return a warmed handler (the factory contract already
requires it) and re-attach ``tune_info`` so a swapped class can be
re-tuned again later. Classes without ``tune_info`` are never re-tuned —
the controller degrades to a no-op, never an error.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

from tpu_mpi_tests_torch.tune import registry
from tpu_mpi_tests_torch.tune.sweep import sweep

#: how many coalesced requests the re-sweep's probe batch executes per
#: candidate measurement — long enough to clear dispatch noise, short
#: enough that candidates × probe stays inside a batch deadline
PROBE_REQUESTS = 4

#: failed re-tunes retried at later window boundaries before giving up
#: — the stale latch is one-shot per op, so abandoning on the first
#: transient rebuild error would leave the loop silently open for good
RETUNE_RETRIES = 2


class TuneController:
    """Latches ``tune_stale`` health events and answers each with a
    between-windows re-sweep + hot swap. Single-threaded apply: the
    latch callback only records (any thread); all re-tuning happens in
    :meth:`window_boundary` on the serve loop's thread."""

    def __init__(
        self,
        metrics,
        handlers: dict[str, Callable],
        *,
        sink: Callable[[dict], None] | None = None,
        line: Callable[[str], None] = print,
        budget_s: float | None = None,
        watchdog=None,
        probe_requests: int = PROBE_REQUESTS,
        clock: Callable[[], float] = time.monotonic,
        wall: Callable[[], float] = time.time,
    ):
        self._metrics = metrics
        self._handlers = handlers  # the LIVE dict the loop dispatches from
        self._sink = sink
        self._line = line
        self._budget = budget_s
        self._watchdog = watchdog
        self._probe_n = max(1, int(probe_requests))
        self._clock = clock
        self._wall = wall
        self._lock = threading.Lock()
        self._pending: list[dict] = []
        self._retries: dict[str, int] = {}  # op -> failed attempts
        self.swaps = 0
        if metrics is not None:
            metrics.add_health_listener(self._on_health)

    # -- latch (any thread) ------------------------------------------------

    def _on_health(self, rec: dict) -> None:
        if rec.get("event") != "tune_stale":
            return
        with self._lock:
            self._pending.append(dict(rec))

    # -- apply (the serve loop's thread, between windows) ------------------

    def _class_key(self, op) -> str | None:
        """A stale span op → the serve class it belongs to. Request
        spans are ``serve:<class>`` (serve/loop.py); anything else
        (an op inside a handler) has no handler to rebuild."""
        if isinstance(op, str) and op.startswith("serve:"):
            key = op[len("serve:"):]
            if key in self._handlers:
                return key
        return None

    def window_boundary(self, t_wall: float) -> int:
        """Drain the latched stale events; re-sweep + hot-swap each
        class that exposes a ``tune_info`` recipe. Returns how many
        swaps happened (0 on the overwhelmingly common quiet path)."""
        with self._lock:
            pending, self._pending = self._pending, []
        swapped = 0
        for stale in pending:
            key = self._class_key(stale.get("op"))
            if key is None:
                continue
            info = getattr(self._handlers[key], "tune_info", None)
            if not info:
                continue
            swapped += self._retune(key, info, stale, t_wall)
        return swapped

    def _retune(self, key: str, info: dict, stale: dict,
                t_wall: float) -> int:
        knob = info["knob"]
        ctx = dict(info.get("ctx") or {})
        candidates = info.get("candidates")
        rebuild = info["rebuild"]

        def _guarded(fn, *args):
            # the watchdog is re-armed PER candidate (and per rebuild):
            # the whole re-sweep legitimately runs up to budget + one
            # candidate, and the budget often IS the batch deadline —
            # arming once across the sweep would hard-exit a healthy
            # budget-saturating re-sweep, while per-dispatch arming
            # still catches a genuinely wedged rebuild/probe
            if self._watchdog is not None:
                self._watchdog.arm(f"serve:retune:{key}")
            try:
                return fn(*args)
            finally:
                if self._watchdog is not None:
                    self._watchdog.disarm()

        t0 = self._clock()
        try:
            old = registry.resolve(
                knob, prior=(candidates[0] if candidates else None),
                **ctx)
            # the real sweep engine: sync-honest candidate windows,
            # budget-capped with reported skips, winner persisted (rank
            # 0 is the only writer; serve mode is single-process) — each
            # candidate is a freshly built (and warmed) handler timed
            # over a probe batch, exactly what the class's latency is
            # made of
            def measure(cand):
                step = _guarded(rebuild, cand)
                t = time.perf_counter()
                _guarded(step, self._probe_n)  # blocks by contract
                return time.perf_counter() - t

            winner = sweep(
                knob, measure,
                candidates=candidates,
                budget_s=self._budget,
                emit=self._sink,
                **ctx,
            )
            # hot swap THROUGH registry.resolve: rebuild(None)
            # re-resolves the knob, which now hits the re-swept winner
            new_step = _guarded(rebuild, None)
        except Exception as e:  # a failed re-tune must not kill serving
            self._line(f"RETUNE ERROR {key}: {type(e).__name__}: {e}")
            # the tune_stale latch is ONE-SHOT per op: dropping this
            # event would disable re-tuning for the op forever. Retry
            # at later window boundaries; once the retries are spent,
            # re-baseline the watch so a sustained sag can latch again
            # instead of the loop staying silently open.
            op = str(stale.get("op"))
            tries = self._retries.get(op, 0) + 1
            self._retries[op] = tries
            if tries <= RETUNE_RETRIES:
                with self._lock:
                    self._pending.append(stale)
            else:
                # retries spent: clear the counter so a FUTURE episode
                # gets the full retry budget again, and re-baseline the
                # watch so a sustained sag can re-latch
                self._retries.pop(op, None)
                if self._metrics is not None:
                    self._metrics.reset_stale(op)
            return 0
        resweep_s = self._clock() - t0
        self._handlers[key] = new_step
        self.swaps += 1
        self._retries.pop(str(stale.get("op")), None)
        if self._metrics is not None:
            # re-baseline the op on the new schedule so recovery is
            # measurable and a future sag can latch again
            self._metrics.reset_stale(str(stale.get("op")))
        rec = {
            "kind": "control",
            "event": "tune_swap",
            "class": key,
            "knob": knob,
            "op": stale.get("op"),
            "signal": stale.get("signal"),
            "sag_pct": stale.get("sag_pct"),
            "old": old,
            "new": winner,
            "resweep_s": resweep_s,
            "t": t_wall,
        }
        if self._sink is not None:
            self._sink(rec)
        self._line(
            f"RETUNE {key}: {knob} {old!r} -> {winner!r} "
            f"(sag={stale.get('sag_pct')}% signal={stale.get('signal')} "
            f"resweep={resweep_s:.2f}s)"
        )
        return 1
