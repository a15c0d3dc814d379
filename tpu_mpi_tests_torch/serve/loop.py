"""The steady-state serving loop: unbounded time, bounded memory (≅
``tpu_mpi_tests/serve/loop.py``; the same records for the same arrivals,
handlers and clocks).

Every other driver is a one-shot benchmark. Here one process and one set
of warmed handlers (the state they hold on the card included) stay
alive while an arrival process (``serve/arrival.py``) generates requests
drawn from a mixed workload table (``serve/workloads.py``), the batcher
(``serve/batcher.py``) coalesces compatible requests, and per-request
latency lands in fixed-size histograms (``serve/histogram.py``).

Observability rides the existing spine:

* per-class SLO records (``kind: "serve"``, ``event: "window"`` every
  ``window_s`` plus one ``event: "summary"``) flow through the caller's
  sink onto the same JSONL stream every other record uses, wall-clock
  stamped so ``tpumt-trace`` places them and ``tpumt-report`` renders
  the SLO table / ``--diff`` gates it;
* each executed batch is bracketed in a telemetry ``comm_span``
  (``op: "serve:<class>"``), so with ``--telemetry`` the request stream
  appears on the timeline as request spans (the span waits for the
  device before it reads the clock);
* the watchdog integration is idle-aware (``IdleAwareWatchdog``): armed
  only around active dispatch, so an arbitrarily long Poisson gap can
  never fire it while a wedged batch still does.

The loop itself is single-threaded pure Python with injectable clocks —
deterministic under test (fake clock, fake handlers, no torch import)
and honest on the card (handlers wait for the device before returning,
so a latency reading is a completed request, not a launch).
"""

from __future__ import annotations

import time
from typing import Any, Callable

from tpu_mpi_tests_torch.serve.batcher import coalesce
from tpu_mpi_tests_torch.serve.histogram import LatencyHistogram
from tpu_mpi_tests_torch.serve.workloads import WorkloadClass, WorkloadMix

#: longest single sleep while idle — keeps the loop responsive to the
#: run deadline and window boundaries without busy-waiting
MAX_IDLE_SLEEP_S = 0.25

#: pause after a failed batch: closed-loop clients re-arm the instant
#: their batch completes, so a persistently failing handler would
#: otherwise busy-spin the loop at CPU speed for the whole run — this
#: bounds it to ~20 error batches/s while leaving transient errors
#: nearly free
FAIL_BACKOFF_S = 0.05

#: chaos arm point, the JAX loop's slot (``chaos/inject.py`` rebinds it
#: when a ``flood`` fault is armed; nothing else sets it):
#: ``hook(window_index) -> int`` synthetic arrivals to flood into the
#: queue at an SLO window boundary. Consulted once per window — a rare
#: branch on an idle-path boundary, and a disarmed run (slot None) takes
#: the same code path as a build without the chaos layer.
_CHAOS_FLOOD = None


class Request:
    """One in-queue request: its workload class and scheduled arrival
    time (the open-loop latency origin — queue wait counts).
    ``synthetic`` marks chaos-flood injections: they are served and
    accounted like any request but never fed back to the arrival
    process — a closed loop's fixed client population must not be
    permanently inflated by a transient burst."""

    __slots__ = ("cls", "arrival", "synthetic")

    def __init__(self, cls: WorkloadClass, arrival: float,
                 synthetic: bool = False):
        self.cls = cls
        self.arrival = arrival
        self.synthetic = synthetic


#: per-(class, window) exemplar budget for shed and error terminal
#: records — the sampler's rate cap (plus exactly one p99-worst
#: completion), so the ``kind:"req"`` stream stays bounded per window
#: no matter how hard a storm sheds
REQ_EXEMPLAR_CAP = 2


class _ClassStats:
    """Per-class accumulators, total + current-window. Fixed size: six
    histograms (e2e + queue-delay + service, total and window), a
    bounded exemplar set, and a handful of counters, regardless of
    request count."""

    __slots__ = ("hist", "win_hist", "qd_hist", "svc_hist",
                 "win_qd_hist", "win_svc_hist", "requests", "errors",
                 "shed", "batches", "arrivals", "queue_max",
                 "win_requests", "win_errors", "win_shed", "win_batches",
                 "win_arrivals", "win_queue_max", "shed_wait_s",
                 "shed_wait_max_s", "win_shed_wait_s",
                 "win_shed_wait_max_s", "win_worst", "win_shed_ex",
                 "win_err_ex", "consec_errors", "quarantines",
                 "quarantine_s", "streak_errors", "quar_errors",
                 "quar_shed")

    def __init__(self):
        self.hist = LatencyHistogram()
        self.win_hist = LatencyHistogram()
        # the latency DECOMPOSITION: e2e = queue delay (arrival ->
        # dispatch) + service (dispatch -> completion), recorded from
        # the same three stamps so qd + svc == e2e per request exactly
        # and the percentile readouts reconcile within bucket tolerance
        self.qd_hist = LatencyHistogram()
        self.svc_hist = LatencyHistogram()
        self.win_qd_hist = LatencyHistogram()
        self.win_svc_hist = LatencyHistogram()
        self.requests = self.errors = self.shed = 0
        self.batches = self.arrivals = self.queue_max = 0
        self.win_requests = self.win_errors = self.win_shed = 0
        self.win_batches = self.win_arrivals = self.win_queue_max = 0
        # terminal accounting for requests that never complete: the
        # queue time a shed request had accumulated when dropped
        # (admission sheds + quarantine backlog drops) — kept OUT of
        # qd_hist so the qd+svc≈e2e reconciliation stays a completions-
        # only identity, but first-class in the window record
        self.shed_wait_s = 0.0
        self.shed_wait_max_s = 0.0
        self.win_shed_wait_s = 0.0
        self.win_shed_wait_max_s = 0.0
        # the bounded per-window request exemplars: the p99-worst
        # completed request (one), plus up to REQ_EXEMPLAR_CAP shed and
        # error terminals — ready-to-sink dicts, wall-stamped at
        # capture time
        self.win_worst: dict | None = None
        self.win_shed_ex: list[dict] = []
        self.win_err_ex: list[dict] = []
        # graceful degradation bookkeeping: consecutive failed batches
        # (reset on any success), completed quarantine episodes, and
        # total seconds the class spent quarantined
        self.consec_errors = 0
        self.quarantines = 0
        self.quarantine_s = 0.0
        # quarantine ATTRIBUTION: request-unit errors in the failure
        # streak that ended in quarantine (streak_errors accumulates,
        # moves to quar_errors on entry) and sheds caused by the
        # quarantine itself (dropped backlog + quarantined-arrival
        # sheds) — so the driver can forgive exactly the degradation
        # the quarantine accounts for, and nothing else
        self.streak_errors = 0
        self.quar_errors = 0
        self.quar_shed = 0

    def window_active(self) -> bool:
        return bool(self.win_arrivals or self.win_requests
                    or self.win_errors or self.win_shed)

    def reset_window(self) -> None:
        self.win_hist.reset()
        self.win_qd_hist.reset()
        self.win_svc_hist.reset()
        self.win_requests = self.win_errors = self.win_shed = 0
        self.win_batches = self.win_arrivals = self.win_queue_max = 0
        self.win_shed_wait_s = 0.0
        self.win_shed_wait_max_s = 0.0
        self.win_worst = None
        self.win_shed_ex = []
        self.win_err_ex = []

    def note_shed_wait(self, wait_s: float) -> None:
        wait_s = max(wait_s, 0.0)
        self.shed_wait_s += wait_s
        self.shed_wait_max_s = max(self.shed_wait_max_s, wait_s)
        self.win_shed_wait_s += wait_s
        self.win_shed_wait_max_s = max(self.win_shed_wait_max_s, wait_s)


class ServeLoop:
    """Drive ``handlers`` under ``arrival`` for ``duration_s`` seconds.

    ``handlers`` maps each class key to a ``step_fn(n)`` executing ``n``
    coalesced requests and returning only after device completion (the
    driver-registry contract, ``drivers/_common.py``). ``sink`` receives
    every ``kind: "serve"`` record; ``watchdog`` (optional) must expose
    the idle-aware ``arm(phase)``/``disarm()`` API. ``clock``/``wall``/
    ``sleep`` are injectable for deterministic tests.
    """

    def __init__(
        self,
        classes: list[WorkloadClass],
        handlers: dict[str, Callable[[int], Any]],
        arrival,
        *,
        duration_s: float,
        max_batch: int = 8,
        window_s: float = 5.0,
        max_queue: int = 10000,
        seed: int = 0,
        sink: Callable[[dict], None] | None = None,
        watchdog=None,
        quarantine_after: int | None = None,
        controller=None,
        recorder=None,
        clock: Callable[[], float] = time.monotonic,
        wall: Callable[[], float] = time.time,
        sleep: Callable[[float], None] = time.sleep,
    ):
        missing = [c.key for c in classes if c.key not in handlers]
        if missing:
            raise ValueError(f"no handler for classes: {missing}")
        self.classes = list(classes)
        self.handlers = dict(handlers)
        self.arrival = arrival
        self.duration_s = float(duration_s)
        self.max_batch = max(1, int(max_batch))
        self.window_s = float(window_s)
        self.max_queue = int(max_queue)
        self.mix = WorkloadMix(classes, seed=seed)
        self.sink = sink
        self.watchdog = watchdog
        # graceful degradation: after N consecutive failed batches a
        # class is quarantined — its arrivals shed, the others keep
        # serving — instead of error-spinning an hours-long run; a
        # window-boundary probe re-admits it once the handler recovers
        # (None = off)
        self.quarantine_after = (int(quarantine_after)
                                 if quarantine_after else None)
        # online re-tuning (tune/controller.py, --retune): consulted at
        # window boundaries only — between batches, like the quarantine
        # probes — so a bounded re-sweep is quarantine-style degraded
        # service (arrivals queue through it), never a mid-batch stall.
        # None = off.
        self.controller = controller
        # traffic capture (serve/replay.py TrafficRecorder, --record):
        # fed the OFFERED stream — every admission attempt, before the
        # shed decision, chaos-flood injections included — so a replay
        # re-offers exactly what this run saw, storms and all
        self.recorder = recorder
        self._quarantined: dict[str, float] = {}  # key -> wall t of entry
        self._clock = clock
        self._wall = wall
        self._sleep = sleep
        self.stats: dict[str, _ClassStats] = {
            c.key: _ClassStats() for c in classes
        }
        self._by_key = {c.key: c for c in classes}

    # -- record emission ---------------------------------------------------

    def _emit(self, event: str, cls: WorkloadClass, st: _ClassStats,
              t_start: float, t_end: float, window: bool,
              offered_dur: float | None = None,
              queue_depth: int | None = None) -> dict:
        """``offered_dur`` divides the offered rate when the record's
        span is longer than the window arrivals were generated in: a
        summary covers traffic + drain, and dividing arrivals by the
        drain-inclusive span would make a saturated run (offered ≫
        sustained, everything eventually served) read as offered ==
        achieved — the exact signal the pair exists to expose."""
        dur = max(t_end - t_start, 1e-9)
        if window:
            arrivals, requests = st.win_arrivals, st.win_requests
            errors, shed = st.win_errors, st.win_shed
            batches, qmax = st.win_batches, st.win_queue_max
            hist, qd_hist = st.win_hist, st.win_qd_hist
            svc_hist = st.win_svc_hist
            shed_wait_s = st.win_shed_wait_s
            shed_wait_max_s = st.win_shed_wait_max_s
        else:
            arrivals, requests = st.arrivals, st.requests
            errors, shed = st.errors, st.shed
            batches, qmax = st.batches, st.queue_max
            hist, qd_hist, svc_hist = st.hist, st.qd_hist, st.svc_hist
            shed_wait_s = st.shed_wait_s
            shed_wait_max_s = st.shed_wait_max_s
        rec = {
            "kind": "serve",
            "event": event,
            "class": cls.key,
            "workload": cls.workload,
            "shape": list(cls.shape),
            "dtype": cls.dtype,
            "t_start": t_start,
            "t_end": t_end,
            "duration_s": dur,
            "arrivals": arrivals,
            "requests": requests,
            "errors": errors,
            "shed": shed,
            "batches": batches,
            "offered_hz": arrivals / (offered_dur or dur),
            "achieved_hz": requests / dur,
            "queue_max": qmax,
            **hist.percentiles_ms(),
            # the decomposition columns: e2e ≈ qd + svc per percentile
            # (exact per request; percentiles reconcile within the
            # histogram's readout tolerance)
            **{f"qd_{k}": v
               for k, v in qd_hist.percentiles_ms().items()},
            **{f"svc_{k}": v
               for k, v in svc_hist.percentiles_ms().items()},
        }
        if shed:
            # queue time the shed/dropped requests had accumulated —
            # the coordinated-omission blind spot, measured: a storm's
            # victims carry their wait into the record instead of
            # vanishing from every histogram
            rec["shed_wait_ms_mean"] = shed_wait_s / shed * 1e3
            rec["shed_wait_ms_max"] = shed_wait_max_s * 1e3
        if queue_depth is not None:
            # the STANDING backlog at emission time (queue_max is the
            # window's high-water mark): the live pressure signal the
            # metrics tee turns into the serve queue-depth gauge — this
            # loop knows nothing about metrics, only its own record
            rec["queue_depth"] = queue_depth
        if not window and st.quarantines:
            rec["quarantines"] = st.quarantines
            rec["quarantine_s"] = st.quarantine_s
            rec["quar_errors"] = st.quar_errors
            rec["quar_shed"] = st.quar_shed
        if offered_dur is not None and dur > offered_dur:
            # how long past the deadline the queue took to drain — a
            # saturated run's backlog, first-class in the record
            rec["drain_s"] = dur - offered_dur
        if self.sink is not None:
            self.sink(rec)
        return rec

    def _emit_req_exemplars(self, st: _ClassStats) -> None:
        """Flush the window's bounded request exemplars: the p99-worst
        completion plus the capped shed/error terminals, captured as
        ready-to-sink ``kind:"req"`` dicts. Called at every window
        boundary just after the window record, so a trace reader sees
        the exemplars inside the window they describe."""
        if self.sink is None:
            return
        if st.win_worst is not None:
            self.sink(st.win_worst)
        for rec in st.win_shed_ex:
            self.sink(rec)
        for rec in st.win_err_ex:
            self.sink(rec)

    # -- graceful degradation ----------------------------------------------

    def _enter_quarantine(self, cls: WorkloadClass, st: _ClassStats,
                          t_wall: float, t_mono: float, queue: list,
                          waiting: dict) -> None:
        """A handler class that stayed dead past ``quarantine_after``
        consecutive failed batches stops being served: its backlog is
        shed, future arrivals shed on admission, and the rest of the
        classes keep their SLO — instead of the whole hours-long run
        error-spinning to rc 1. Emits ``kind:"serve"
        event:"quarantine"``; a window-boundary probe re-admits the
        class when the handler recovers."""
        self._quarantined[cls.key] = t_wall
        st.quar_errors += st.streak_errors
        st.streak_errors = 0
        dropped = [r for r in queue if r.cls.key == cls.key]
        if dropped:
            queue[:] = [r for r in queue if r.cls.key != cls.key]
            st.shed += len(dropped)
            st.win_shed += len(dropped)
            st.quar_shed += len(dropped)
            waiting[cls.key] = 0
            # lifecycle terminals for the dropped backlog: each request
            # dies with the queue time it had accumulated, so a
            # quarantine drop leaves a latency trace
            for r in dropped:
                wait_s = max(t_mono - r.arrival, 0.0)
                st.note_shed_wait(wait_s)
                if len(st.win_shed_ex) < REQ_EXEMPLAR_CAP:
                    st.win_shed_ex.append({
                        "kind": "req", "event": "shed",
                        "class": cls.key,
                        "sampled": "quarantine_drop",
                        "t_arrival": t_wall - wait_s,
                        "t_done": t_wall,
                        "queue_ms": wait_s * 1e3,
                    })
        if self.sink is not None:
            self.sink({
                "kind": "serve", "event": "quarantine", "class": cls.key,
                "workload": cls.workload, "dtype": cls.dtype,
                "t": t_wall, "consecutive_errors": st.consec_errors,
                "dropped": len(dropped),
            })

    def _probe_quarantined(self, t_wall: float) -> None:
        """One probe batch (n=1, synthetic — no queued request is
        risked) per quarantined class per window boundary; success
        re-admits the class and records the downtime."""
        for key in list(self._quarantined):
            if self.watchdog is not None:
                self.watchdog.arm(f"serve:probe:{key}")
            try:
                self.handlers[key](1)
                ok = True
            except Exception:
                ok = False
            finally:
                if self.watchdog is not None:
                    self.watchdog.disarm()
            if not ok:
                continue
            t_q = self._quarantined.pop(key)
            st = self.stats[key]
            st.consec_errors = 0
            st.quarantines += 1
            st.quarantine_s += max(t_wall - t_q, 0.0)
            if self.sink is not None:
                self.sink({
                    "kind": "serve", "event": "recover", "class": key,
                    "t": t_wall, "downtime_s": max(t_wall - t_q, 0.0),
                })

    # -- the loop ----------------------------------------------------------

    def run(self) -> list[dict]:
        """Serve until the deadline, drain the queue, return the per-class
        ``event: "summary"`` records (also pushed through the sink)."""
        from tpu_mpi_tests_torch.instrument.telemetry import comm_span

        clock, wall = self._clock, self._wall
        t0 = clock()
        wall0 = wall()
        t_end = t0 + self.duration_s
        self.arrival.start(t0)
        queue: list[Request] = []
        # per-class waiting counts, maintained incrementally (+1 on
        # enqueue, -batch on coalesce): the SLO queue-depth column must
        # not cost an O(queue) scan inside the latency-measuring loop
        waiting: dict[str, int] = {}
        window_start = t0
        window_wall = wall0
        window_index = 0

        def wall_at(t_mono: float) -> float:
            return wall0 + (t_mono - t0)

        # replay hook: a ReplayArrivals process carries the recorded
        # class keys and hands them out in admission order, overriding
        # the seeded mix drawer — two replays of one artifact admit the
        # exact same (time, class) sequence
        draw_recorded = getattr(self.arrival, "draw_class", None)

        def admit(t_arr: float, synthetic: bool = False) -> None:
            """One arrival: draw its class, then queue / shed it. A
            quarantined class sheds on arrival — the whole point is
            that its backlog cannot starve the healthy classes."""
            cls = None
            if draw_recorded is not None and not synthetic:
                key = draw_recorded()
                cls = self._by_key.get(key) if key is not None else None
            if cls is None:
                cls = self.mix.draw()
            if self.recorder is not None:
                self.recorder.add(t_arr - t0, cls.key)
            st = self.stats[cls.key]
            st.arrivals += 1
            st.win_arrivals += 1
            if len(queue) >= self.max_queue or cls.key in self._quarantined:
                # shed and gone: a shed request is never fed back
                # through on_complete (re-arming what the full
                # queue just rejected would spin) — closed-loop
                # callers must keep concurrency <= max_queue or
                # the population decays (the driver enforces it)
                st.shed += 1
                st.win_shed += 1
                if cls.key in self._quarantined:
                    st.quar_shed += 1
                # terminal lifecycle accounting: the request dies HERE
                # with the queue time it accumulated between its
                # scheduled arrival and the shed decision (a loop
                # running behind schedule sheds late, and that lateness
                # is real queue delay the victim experienced)
                wait_s = max(now - t_arr, 0.0)
                st.note_shed_wait(wait_s)
                if len(st.win_shed_ex) < REQ_EXEMPLAR_CAP:
                    st.win_shed_ex.append({
                        "kind": "req", "event": "shed",
                        "class": cls.key, "sampled": "shed",
                        "t_arrival": wall_at(t_arr),
                        "t_done": wall_at(now),
                        "queue_ms": wait_s * 1e3,
                    })
                return
            queue.append(Request(cls, t_arr, synthetic))
            d = waiting.get(cls.key, 0) + 1
            waiting[cls.key] = d
            st.queue_max = max(st.queue_max, d)
            st.win_queue_max = max(st.win_queue_max, d)

        while True:
            now = clock()
            # ingest arrivals scheduled up to now (never past the
            # deadline — the post-deadline drain must terminate)
            for t_arr in self.arrival.take_due(now, limit=t_end):
                admit(t_arr)
            # window boundary: emit + reset (drain windows included)
            if now - window_start >= self.window_s:
                w_end = wall_at(now)
                for cls in self.classes:
                    st = self.stats[cls.key]
                    if st.window_active():
                        self._emit("window", cls, st, window_wall,
                                   w_end, window=True,
                                   queue_depth=waiting.get(cls.key, 0))
                        self._emit_req_exemplars(st)
                    st.reset_window()
                    # requests already waiting carry into the new
                    # window's depth — a backlog is not depth zero
                    st.win_queue_max = waiting.get(cls.key, 0)
                window_start = now
                window_wall = w_end
                window_index += 1
                flood = _CHAOS_FLOOD
                if flood is not None:
                    for _ in range(flood(window_index)):
                        admit(now, synthetic=True)
                if self._quarantined:
                    self._probe_quarantined(w_end)
                if self.controller is not None:
                    self.controller.window_boundary(w_end)

            if queue:
                batch, queue = coalesce(queue, self.max_batch)
                cls = batch[0].cls
                waiting[cls.key] -= len(batch)
                st = self.stats[cls.key]
                if self.watchdog is not None:
                    self.watchdog.arm(f"serve:{cls.key}")
                # the dispatch stamp: everything before it is queue
                # delay (arrival -> coalesce -> here), everything after
                # is service — e2e = qd + svc per request by identity
                t_disp = clock()
                failed = False
                try:
                    with comm_span(
                        f"serve:{cls.key}",
                        nbytes=cls.nbytes * len(batch),
                        requests=len(batch),
                    ):
                        # handler blocks on device completion before
                        # returning (registry contract) — the span and
                        # the latency reads below are sync-honest
                        self.handlers[cls.key](len(batch))
                except Exception:
                    failed = True
                finally:
                    if self.watchdog is not None:
                        self.watchdog.disarm()
                done = clock()
                st.batches += 1
                st.win_batches += 1
                svc = max(done - t_disp, 0.0)
                if failed:
                    st.errors += len(batch)
                    st.win_errors += len(batch)
                    st.streak_errors += len(batch)
                    st.consec_errors += 1
                    if len(st.win_err_ex) < REQ_EXEMPLAR_CAP:
                        # one exemplar per failed batch, carrying the
                        # oldest member's queue delay — enough to see
                        # WHERE the failed request spent its life
                        oldest = min(r.arrival for r in batch)
                        st.win_err_ex.append({
                            "kind": "req", "event": "error",
                            "class": cls.key, "sampled": "error",
                            "t_arrival": wall_at(oldest),
                            "t_dispatch": wall_at(t_disp),
                            "t_done": wall_at(done),
                            "queue_ms": max(t_disp - oldest, 0.0) * 1e3,
                            "service_ms": svc * 1e3,
                            "requests": len(batch),
                        })
                    if (self.quarantine_after
                            and st.consec_errors >= self.quarantine_after
                            and cls.key not in self._quarantined):
                        self._enter_quarantine(cls, st, wall_at(done),
                                               done, queue, waiting)
                else:
                    st.consec_errors = 0
                    st.streak_errors = 0
                    for req in batch:
                        qd = max(t_disp - req.arrival, 0.0)
                        lat = qd + svc
                        st.requests += 1
                        st.win_requests += 1
                        st.hist.record(lat)
                        st.win_hist.record(lat)
                        st.qd_hist.record(qd)
                        st.win_qd_hist.record(qd)
                        st.svc_hist.record(svc)
                        st.win_svc_hist.record(svc)
                        worst = st.win_worst
                        if (worst is None
                                or lat * 1e3 > worst["e2e_ms"]):
                            # the window's p99-worst completion — the
                            # one request a trace reader always gets
                            st.win_worst = {
                                "kind": "req", "event": "complete",
                                "class": cls.key,
                                "sampled": "p99_worst",
                                "t_arrival": wall_at(req.arrival),
                                "t_dispatch": wall_at(t_disp),
                                "t_done": wall_at(done),
                                "queue_ms": qd * 1e3,
                                "service_ms": svc * 1e3,
                                "e2e_ms": lat * 1e3,
                            }
                # synthetic (chaos-flood) completions never re-arm the
                # arrival process: a closed loop's population must
                # return to exactly --concurrency once the burst drains
                organic = sum(1 for r in batch if not r.synthetic)
                self.arrival.on_complete(organic, done)
                if failed:
                    self._sleep(FAIL_BACKOFF_S)
                continue

            if now >= t_end:
                break  # deadline passed, queue drained
            nxt = self.arrival.next_event()
            targets = [t_end, window_start + self.window_s]
            if nxt is not None:
                targets.append(nxt)
            gap = min(targets) - now
            if gap > 0:
                self._sleep(min(gap, MAX_IDLE_SLEEP_S))

        end_wall = wall_at(clock())
        # a class still quarantined at run end charges its open episode
        # to the summary's downtime accounting
        for key, t_q in self._quarantined.items():
            st = self.stats[key]
            st.quarantines += 1
            st.quarantine_s += max(end_wall - t_q, 0.0)
        # final partial window, then the run summaries
        for cls in self.classes:
            st = self.stats[cls.key]
            if st.window_active():
                self._emit("window", cls, st, window_wall, end_wall,
                           window=True,
                           queue_depth=waiting.get(cls.key, 0))
                self._emit_req_exemplars(st)
            st.reset_window()
        return [
            self._emit("summary", self._by_key[key], st, wall0,
                       end_wall, window=False,
                       offered_dur=min(self.duration_s,
                                       max(end_wall - wall0, 1e-9)))
            for key, st in self.stats.items()
        ]
