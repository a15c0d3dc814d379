"""Live metrics plane: a bounded in-process registry fed by the record
stream the spine already writes (≅ ``tpu_mpi_tests/instrument/metrics.py``;
the same series from the same records).

A :class:`MetricsRegistry` of counters, gauges and rolling-window
histograms is fed from the reporter's JSONL chokepoint
(``Reporter.attach_metrics``), so every record a run already writes —
``kind: "span"/"mem"/"overlap"/"route"/"decode"/"time"/...`` — updates
named series with no new call site. The OpenMetrics exporter
(``instrument/export.py``) and the JAX package's ``tpumt-top`` (which
follows the JSONL; not ported) read them.

Three contracts, the JAX module's:

* **Bounded**: rolling histograms are a fixed ring of
  :class:`~tpu_mpi_tests_torch.serve.histogram.LatencyHistogram`
  sub-windows and the series table is capped: past :data:`MAX_SERIES`
  distinct (name, labels) pairs new series are dropped and counted in
  ``tpumt_series_dropped``.
* **Nothing when disarmed**: nothing here runs unless
  ``--metrics-port`` armed the tee (one ``None`` check on the reporter
  path), and the module is not even imported then.
* **Never raises**: :meth:`MetricsRegistry.observe` is on the record
  path of a measured run; a metrics fault must not fail the op that was
  being recorded.

The registry only ever holds numbers copied out of records: no tensor,
no device handle, and none of its methods touches the card.

It also hosts the ``tune_stale`` watermark rule: once a tuned schedule
is active (a ``tune_hit``/``tune_result`` record flowed through), each
op's first :data:`STALE_SAMPLES` GB/s readings (and ``roofline_frac``,
where the cost model attached one) are the winner's baseline; a later
window of the same width sagging below it by more than the noise band
emits one ``kind: "health" event: "tune_stale"`` record.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable

from tpu_mpi_tests_torch.serve.histogram import LatencyHistogram

#: rolling-histogram window: percentiles cover the last this-many seconds
ROLLING_WINDOW_S = 60.0

#: sub-windows per rolling histogram (expiry granularity = window/slots)
ROLLING_SLOTS = 6

#: hard cap on distinct (name, labels) series; excess increments
#: ``tpumt_series_dropped`` instead of growing the table
MAX_SERIES = 1024

#: tune_stale window width: baseline = the op's first this-many samples
#: after a tuned schedule went live, rolling = the most recent this-many
STALE_SAMPLES = 8

#: tune_stale noise-band floor: a sag smaller than this fraction of the
#: baseline never fires, however tight the baseline's own spread was
STALE_MIN_SAG = 0.15


class RollingHistogram:
    """Fixed-footprint rolling-window histogram: a ring of
    :class:`LatencyHistogram` sub-windows, one per
    ``window_s / slots`` time slice, expired by slot age on read. The
    merged readout covers at most ``window_s`` (and at least
    ``window_s - window_s/slots``) of trailing samples."""

    __slots__ = ("_slot_s", "_max", "_ring", "_clock")

    def __init__(self, window_s: float = ROLLING_WINDOW_S,
                 slots: int = ROLLING_SLOTS,
                 clock: Callable[[], float] = time.monotonic):
        self._slot_s = float(window_s) / max(1, int(slots))
        self._max = max(1, int(slots))
        self._ring: deque = deque()  # (slot_index, LatencyHistogram)
        self._clock = clock

    def record(self, seconds: float) -> None:
        idx = int(self._clock() / self._slot_s)
        if not self._ring or self._ring[-1][0] != idx:
            self._ring.append((idx, LatencyHistogram()))
            while len(self._ring) > self._max \
                    or self._ring[0][0] <= idx - self._max:
                self._ring.popleft()
        self._ring[-1][1].record(seconds)

    def merged(self) -> LatencyHistogram:
        """One histogram over the non-expired slots (age judged now, so
        a quiet series forgets its stale samples on read)."""
        idx = int(self._clock() / self._slot_s)
        out = LatencyHistogram()
        for slot_idx, sub in self._ring:
            if slot_idx <= idx - self._max or not sub.count:
                continue
            for i, c in enumerate(sub.counts):
                out.counts[i] += c
            out.count += sub.count
            out.total_s += sub.total_s
            out.min_s = min(out.min_s, sub.min_s)
            out.max_s = max(out.max_s, sub.max_s)
        return out


class _Series:
    __slots__ = ("kind", "value", "hist")

    def __init__(self, kind: str, clock):
        self.kind = kind
        self.value = 0.0
        self.hist = RollingHistogram(clock=clock) \
            if kind == "histogram" else None


def _mean(vals) -> float:
    vals = list(vals)
    return sum(vals) / len(vals) if vals else 0.0


class _TuneStaleWatch:
    """The watermark rule: per op, the first :data:`STALE_SAMPLES`
    readings after a tuned schedule went live are the winner's fresh
    baseline; a full rolling window sagging below it by more than
    ``max(STALE_MIN_SAG, baseline spread)`` fires exactly one health
    record (latched per op). Both achieved GB/s and ``roofline_frac``
    feed the same latch — whichever signal sags first convicts."""

    def __init__(self, registry: "MetricsRegistry"):
        self._reg = registry
        self._lock = threading.Lock()
        self._knobs: list[str] = []
        self._ops: dict[str, dict] = {}

    def tuned(self, knob) -> None:
        with self._lock:
            if knob and knob not in self._knobs:
                self._knobs.append(str(knob))

    def reset(self, op: str) -> None:
        """Forget an op's baseline AND its latch: the serve loop's
        re-tune controller (``tune/controller.py``) calls this after a
        ``tune_swap`` so the op re-baselines on the
        NEW schedule's first readings — recovery becomes measurable and
        a future sag of the new winner can fire again."""
        with self._lock:
            self._ops.pop(op, None)

    def span(self, op: str, gbps, roofline_frac) -> None:
        with self._lock:
            if not self._knobs:
                return  # no tuned schedule active: nothing to go stale
            st = self._ops.setdefault(op, {
                "gbps": {"base": [], "roll": deque(maxlen=STALE_SAMPLES)},
                "roofline_frac": {"base": [],
                                  "roll": deque(maxlen=STALE_SAMPLES)},
                "fired": False,
            })
            for signal, v in (("gbps", gbps),
                              ("roofline_frac", roofline_frac)):
                if not isinstance(v, (int, float)) or v != v or v <= 0:
                    continue
                win = st[signal]
                if len(win["base"]) < STALE_SAMPLES:
                    win["base"].append(float(v))
                    continue
                win["roll"].append(float(v))
                if st["fired"] or len(win["roll"]) < STALE_SAMPLES:
                    continue
                base = _mean(win["base"])
                if base <= 0:
                    continue
                band = (max(win["base"]) - min(win["base"])) / base
                threshold = max(STALE_MIN_SAG, band)
                rolling = _mean(win["roll"])
                sag = 1.0 - rolling / base
                if sag <= threshold:
                    continue
                st["fired"] = True
                rec = {
                    "kind": "health", "event": "tune_stale", "op": op,
                    "signal": signal,
                    "baseline": round(base, 6),
                    "rolling": round(rolling, 6),
                    "sag_pct": round(100.0 * sag, 2),
                    "threshold_pct": round(100.0 * threshold, 2),
                    "n": STALE_SAMPLES,
                    "knobs": list(self._knobs),
                    "t": self._reg.wall(),
                }
                break
            else:
                return
        # emit OUTSIDE the lock: the sink is the Reporter's JSONL, whose
        # tee feeds the record straight back into this registry
        self._reg.emit_health(rec)


class MetricsRegistry:
    """Thread-safe named-series table + the record-kind dispatch that
    turns the spine's JSONL records into series updates."""

    def __init__(self, *, wall: Callable[[], float] = time.time,
                 clock: Callable[[], float] = time.monotonic,
                 max_series: int = MAX_SERIES,
                 health_sink: Callable[[dict], None] | None = None):
        self._lock = threading.Lock()
        self._series: dict[tuple, _Series] = {}
        self.wall = wall
        self.clock = clock
        self._max_series = max_series
        self._health_sink = health_sink
        #: recent kind:"health" records (observed or self-fired) for the
        #: dashboard's HEALTH section — bounded by construction
        self.health_events: deque = deque(maxlen=16)
        #: synchronous subscribers to non-heartbeat health events (the
        #: serve loop's re-tune controller, ``tune/controller.py``,
        #: latches tune_stale through this); registered during single-threaded
        #: setup, called on the observing thread, exceptions swallowed
        #: like every tee path
        self._health_listeners: list = []
        self.started_wall = wall()
        self._stale = _TuneStaleWatch(self)

    def set_health_sink(self, sink: Callable[[dict], None] | None) -> None:
        self._health_sink = sink

    def add_health_listener(self, cb: Callable[[dict], None]) -> None:
        self._health_listeners.append(cb)

    def reset_stale(self, op: str) -> None:
        """Re-baseline an op's tune_stale watch (post-swap)."""
        self._stale.reset(op)

    # -- series primitives -------------------------------------------------

    def _get(self, name: str, kind: str, labels: tuple) -> _Series | None:
        key = (name, labels)
        s = self._series.get(key)
        if s is not None:
            return s
        if len(self._series) >= self._max_series:
            # the cap is the bounded-memory contract: count the drop
            # (the one series allowed past the cap) instead of growing
            drop_key = ("tpumt_series_dropped", ())
            dropped = self._series.get(drop_key)
            if dropped is None:
                dropped = self._series[drop_key] = _Series(
                    "counter", self.clock)
            dropped.value += 1
            return None
        s = self._series[key] = _Series(kind, self.clock)
        return s

    def inc(self, name: str, labels: tuple = (), v: float = 1) -> None:
        with self._lock:
            s = self._get(name, "counter", labels)
            if s is not None:
                s.value += v

    def set_gauge(self, name: str, labels: tuple = (),
                  v: float = 0.0) -> None:
        with self._lock:
            s = self._get(name, "gauge", labels)
            if s is not None:
                s.value = v

    def observe_sample(self, name: str, labels: tuple = (),
                       value: float = 0.0) -> None:
        """Record into a rolling-window histogram series (latency
        seconds, rates — any positive value the log buckets cover)."""
        with self._lock:
            s = self._get(name, "histogram", labels)
            if s is not None:
                s.hist.record(value)

    def value(self, name: str, labels: tuple = ()):
        """Current counter/gauge value (None for unknown series)."""
        with self._lock:
            s = self._series.get((name, labels))
            return None if s is None or s.kind == "histogram" else s.value

    def snapshot(self) -> dict[str, dict]:
        """``{name: {"type", "samples": [(labels, value-or-quantiles)]}}``
        — the read side the exporter and the dashboard render from.
        Histogram samples resolve to ``{count, sum, p50, p99}`` over the
        rolling window."""
        with self._lock:
            fams: dict[str, dict] = {}
            for (name, labels), s in sorted(
                    self._series.items(), key=lambda kv: kv[0]):
                fam = fams.setdefault(
                    name, {"type": s.kind, "samples": []})
                if s.kind == "histogram":
                    h = s.hist.merged()
                    fam["samples"].append((labels, {
                        "count": h.count, "sum": h.total_s,
                        "p50": h.percentile(50.0),
                        "p99": h.percentile(99.0),
                    }))
                else:
                    fam["samples"].append((labels, s.value))
            return fams

    def emit_health(self, rec: dict) -> None:
        """Route a self-generated health record outward (the Reporter's
        JSONL, whose tee will feed it back here) or, with no sink
        (``tpumt-top``'s standalone registry), absorb it directly."""
        sink = self._health_sink
        if sink is not None:
            try:
                sink(rec)
                return
            except Exception:
                pass
        self.observe(rec)

    # -- the tee entry -----------------------------------------------------

    def observe(self, rec: dict) -> None:
        """Update series from one JSONL record. Never raises — this sits
        on the measured run's record path."""
        try:
            self._observe(rec)
        except Exception:
            pass

    def _observe(self, rec: dict) -> None:
        kind = rec.get("kind")
        if not isinstance(kind, str):
            return
        self.inc("tpumt_records", (("kind", kind),))
        handler = getattr(self, f"_on_{kind}", None)
        if handler is not None:
            handler(rec)

    # one handler per record kind; unknown kinds only count in
    # tpumt_records — forward-compatible by construction

    def _on_span(self, rec: dict) -> None:
        op = str(rec.get("op", "?"))
        if rec.get("async"):
            op += "[async]"
        L = (("op", op),)
        self.inc("tpumt_spans", L)
        self.inc("tpumt_span_bytes", L, int(rec.get("nbytes") or 0))
        secs = rec.get("seconds")
        if isinstance(secs, (int, float)):
            self.inc("tpumt_span_seconds", L, float(secs))
            self.observe_sample("tpumt_span_latency_seconds", L,
                                float(secs))
            self.observe_sample("tpumt_latency_seconds", (),
                                float(secs))
        gbps = rec.get("gbps")
        if isinstance(gbps, (int, float)):
            # last value as a gauge AND a rolling window: the
            # dashboard's "rolling per-op GB/s" promise is the window's
            # median, not whichever span happened to land last
            self.set_gauge("tpumt_span_gbps", L, float(gbps))
            self.observe_sample("tpumt_span_gbps_window", L,
                                float(gbps))
        # per-link-class series (comm/topology.py wrapper stamps):
        # intra- vs inter-host bytes and bandwidth live on tpumt-top.
        # Flat-topology runs carry no ``link`` → no series appear.
        link = rec.get("link")
        if isinstance(link, str):
            LL = (("link", link),)
            self.inc("tpumt_span_link_bytes", LL,
                     int(rec.get("nbytes") or 0))
            if isinstance(secs, (int, float)):
                self.inc("tpumt_span_link_seconds", LL, float(secs))
            if isinstance(gbps, (int, float)):
                self.set_gauge("tpumt_span_link_gbps", LL, float(gbps))
                self.observe_sample("tpumt_span_link_gbps_window", LL,
                                    float(gbps))
        rf = rec.get("roofline_frac")
        if isinstance(rf, (int, float)):
            self.set_gauge("tpumt_roofline_frac", L, float(rf))
        if not rec.get("async"):
            self._stale.span(op, gbps, rf)

    def _on_serve(self, rec: dict) -> None:
        cls = str(rec.get("class", "?"))
        L = (("class", cls),)
        event = rec.get("event")
        if event == "window":
            for field, name in (("arrivals", "tpumt_serve_arrivals"),
                                ("requests", "tpumt_serve_requests"),
                                ("errors", "tpumt_serve_errors"),
                                ("shed", "tpumt_serve_shed")):
                v = rec.get(field)
                if isinstance(v, (int, float)):
                    self.inc(name, L, v)
            depth = rec.get("queue_depth", rec.get("queue_max"))
            if isinstance(depth, (int, float)):
                self.set_gauge("tpumt_serve_queue_depth", L, depth)
            for field in ("p50_ms", "p95_ms", "p99_ms", "offered_hz",
                          "achieved_hz"):
                v = rec.get(field)
                if isinstance(v, (int, float)):
                    self.set_gauge(f"tpumt_serve_{field}", L, v)
            # the latency decomposition as standing gauges: queue-delay
            # and service p99 per class, live on the OpenMetrics
            # endpoint — the saturation early warning (queue-delay
            # share climbing toward the SLO bound) without waiting for
            # the post-mortem table
            for field, name in (
                    ("qd_p99_ms", "tpumt_serve_queue_delay_p99_ms"),
                    ("svc_p99_ms", "tpumt_serve_service_p99_ms")):
                v = rec.get(field)
                if isinstance(v, (int, float)):
                    self.set_gauge(name, L, v)
        elif event == "quarantine":
            self.inc("tpumt_serve_quarantines", L)

    def _on_mem(self, rec: dict) -> None:
        L = ()
        if rec.get("rank") is not None:
            L = (("rank", str(rec["rank"])),)
        for field, name in (
                ("bytes_in_use", "tpumt_hbm_bytes_in_use"),
                ("peak_bytes_in_use", "tpumt_hbm_peak_bytes_in_use"),
                ("live_bytes", "tpumt_live_bytes")):
            v = rec.get(field)
            if isinstance(v, (int, float)):
                self.set_gauge(name, L, v)

    def _on_overlap(self, rec: dict) -> None:
        L = (("op", str(rec.get("op", "?"))),)
        for field, name in (("overlap_frac", "tpumt_overlap_frac"),
                            ("drain_s", "tpumt_overlap_drain_seconds")):
            v = rec.get(field)
            if isinstance(v, (int, float)):
                self.set_gauge(name, L, v)

    def _on_route(self, rec: dict) -> None:
        L = (("op", str(rec.get("op", "?"))),)
        for field, name in (("overflow_pct", "tpumt_route_overflow_pct"),
                            ("occupancy_pct", "tpumt_route_occupancy_pct"),
                            ("imbalance", "tpumt_route_imbalance")):
            v = rec.get(field)
            if isinstance(v, (int, float)):
                self.set_gauge(name, L, v)
        for field, name in (("routed", "tpumt_route_tokens_routed"),
                            ("dropped", "tpumt_route_tokens_dropped")):
            v = rec.get(field)
            if isinstance(v, (int, float)):
                self.inc(name, L, v)

    def _on_decode(self, rec: dict) -> None:
        key = (f"{rec.get('collective', '?')}:"
               f"{rec.get('batch', '?')}x{rec.get('heads', '?')}")
        v = rec.get("us_per_op")
        if isinstance(v, (int, float)):
            self.set_gauge("tpumt_decode_us_per_op", (("key", key),), v)

    def _on_time(self, rec: dict) -> None:
        # cumulative either way: a final PhaseTimer record carries the
        # phase's accumulated seconds, a live event:"progress" snapshot
        # carries the running total — both map to the same gauge
        phase = rec.get("phase")
        v = rec.get("seconds")
        if phase and isinstance(v, (int, float)):
            self.set_gauge("tpumt_phase_seconds",
                           (("phase", str(phase)),), v)

    def _on_watchdog(self, rec: dict) -> None:
        self.inc("tpumt_watchdog_fires", ())

    def _on_finding(self, rec: dict) -> None:
        self.inc("tpumt_findings",
                 (("class", str(rec.get("class", "?"))),))

    def _on_health(self, rec: dict) -> None:
        self.inc("tpumt_health_events",
                 (("event", str(rec.get("event", "?"))),))
        if rec.get("event") != "heartbeat":
            self.health_events.append(dict(rec))
            for cb in self._health_listeners:
                try:
                    cb(rec)
                except Exception:
                    pass

    def _on_control(self, rec: dict) -> None:
        self.inc("tpumt_control_events",
                 (("event", str(rec.get("event", "?"))),))

    def _on_tune_hit(self, rec: dict) -> None:
        self.inc("tpumt_tune_resolutions",
                 (("knob", str(rec.get("knob", "?"))),
                  ("kind", "hit")))
        self._stale.tuned(rec.get("knob"))

    def _on_tune_result(self, rec: dict) -> None:
        self.inc("tpumt_tune_resolutions",
                 (("knob", str(rec.get("knob", "?"))),
                  ("kind", "result")))
        self._stale.tuned(rec.get("knob"))


class CommWaitWatch:
    """Cross-rank live wait_frac: the communication-anatomy match
    (``instrument/anatomy.py`` semantics) run incrementally over the
    multi-rank record stream ``tpumt-top`` already tails.

    The in-process tee sees only its own rank's spans, so it cannot
    decompose wait from wire; the dashboard sees every rank's file and
    knows which file is which rank — it feeds seq-stamped collective
    spans here with their rank and clock offset, and each call matched
    across all expected ranks updates a cumulative per-op
    ``tpumt_comm_wait_frac`` gauge on the registry (rendered as the
    OPS table's WAIT column). Bounded: at most :data:`MAX_PENDING`
    partially-matched calls are held; the oldest are dropped first (a
    dead rank's unmatched calls must not grow the table). Waits below
    the clock-sync uncertainty read as zero — the honesty floor."""

    MAX_PENDING = 2048

    def __init__(self, registry: MetricsRegistry):
        self._reg = registry
        self.expected = 0  # ranks per matched call (manifest count)
        self._pending: dict[tuple, dict[int, tuple[float, float]]] = {}
        self._spread: dict[int, float] = {}
        self._tot: dict[str, list] = {}  # op -> [wait_s, span_s]

    def clock_sync(self, rank: int, rec: dict) -> None:
        self._spread[rank] = float(rec.get("spread_s") or 0.0)

    def reset(self) -> None:
        self._pending.clear()
        self._spread.clear()
        self._tot.clear()

    def span(self, rank: int, rec: dict, offset: float) -> None:
        if (rec.get("seq") is None or rec.get("async")
                or int(rec.get("world") or 1) < 2
                or rec.get("t_start") is None
                or rec.get("t_end") is None
                or self.expected < 2):
            return
        op = str(rec.get("op", "?"))
        key = (op, rec.get("axis"), int(rec["seq"]))
        entries = self._pending.setdefault(key, {})
        entries.setdefault(rank, (float(rec["t_start"]) - offset,
                                  float(rec["t_end"]) - offset))
        if len(entries) < self.expected:
            while len(self._pending) > self.MAX_PENDING:
                self._pending.pop(next(iter(self._pending)))
            return
        del self._pending[key]
        unc = sum(sorted(self._spread.values(), reverse=True)[:2])
        latest = max(e for e, _x in entries.values())
        wait_s = span_s = 0.0
        for entry, end in entries.values():
            span_s += max(end - entry, 0.0)
            w = latest - entry
            if w >= unc:
                wait_s += w
        tot = self._tot.setdefault(op, [0.0, 0.0])
        tot[0] += wait_s
        tot[1] += span_s
        if tot[1] > 0:
            self._reg.set_gauge("tpumt_comm_wait_frac", (("op", op),),
                                tot[0] / tot[1])


class PhaseProgress:
    """Streaming per-phase progress: a ``timers`` phase hook that keeps
    its own cumulative seconds/count per phase and emits throttled
    ``kind: "time" event: "progress"`` snapshots through the sink.

    This is what lets the ONLINE doctor convict a phase straggler while
    the run is still executing: the final ``time`` records land only at
    driver exit, but these cumulative snapshots stream every
    ``interval_s`` — and because they are snapshots (latest wins), not
    deltas, the offline consumers that sum ``time`` records skip them
    (``event: "progress"``) and the doctor's straggler digest lets a
    final record override them, so a completed stream reads identically
    with or without the live trail. Armed only by ``--metrics-port``
    (``drivers/_common.make_reporter``); own accumulation, so warmup-
    skipping in PhaseTimer never skews the live ratio between ranks."""

    def __init__(self, sink: Callable[[dict], None],
                 interval_s: float = 1.0,
                 clock: Callable[[], float] = time.perf_counter,
                 wall: Callable[[], float] = time.time):
        self._sink = sink
        self._interval = float(interval_s)
        self._clock = clock
        self._wall = wall
        self._open: dict[str, float] = {}
        self._tot: dict[str, float] = {}
        self._cnt: dict[str, int] = {}
        self._first_wall: dict[str, float] = {}
        self._last_emit: dict[str, float] = {}

    def __call__(self, name: str, event: str) -> None:
        now = self._clock()
        if event == "begin":
            self._open[name] = now
            return
        t0 = self._open.pop(name, None)
        if t0 is None:
            return
        self._tot[name] = self._tot.get(name, 0.0) + (now - t0)
        self._cnt[name] = self._cnt.get(name, 0) + 1
        w = self._wall()
        self._first_wall.setdefault(name, w)
        if w - self._last_emit.get(name, 0.0) < self._interval:
            return
        self._last_emit[name] = w
        self._emit(name, w)

    def _emit(self, name: str, w: float) -> None:
        try:
            self._sink({
                "kind": "time", "event": "progress", "phase": name,
                "seconds": self._tot[name], "count": self._cnt[name],
                "t_start": self._first_wall[name], "t_end": w, "t": w,
            })
        except Exception:
            pass  # a closing sink must not fail the phase being timed

    def start(self) -> "PhaseProgress":
        from tpu_mpi_tests_torch.instrument import timers

        timers.add_phase_hook(self)
        return self

    def stop(self) -> None:
        from tpu_mpi_tests_torch.instrument import timers

        timers.remove_phase_hook(self)
        w = self._wall()
        for name in list(self._tot):
            self._emit(name, w)  # final cumulative snapshot per phase
