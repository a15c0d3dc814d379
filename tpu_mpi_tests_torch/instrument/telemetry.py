"""Comm-layer telemetry: spans, cumulative counters and a flight recorder
(≅ ``tpu_mpi_tests/instrument/telemetry.py``), three pieces sharing one
process-wide registry:

* **Spans** (:func:`comm_span`, :func:`span_call`): every public
  collective, halo, ring and all-to-all wrapper brackets its call in a
  span that records the op, its payload bytes, the axis, the seconds and
  the derived bandwidth. Spans are sync-honest: before the clock is read
  they wait for the op's result (:func:`~tpu_mpi_tests_torch.instrument.
  timers.block`), since a CUDA launch returns before the card has run it.
  Recording is off by default, and a disabled span is one attribute check
  and the call: no launch, no wait (``--telemetry`` turns it on).

* **Counters**: ops, bytes and seconds per op (:func:`counters`),
  written as ``telemetry_summary`` records when the driver's reporter
  closes.

* **Flight recorder**: a bounded ring buffer of recent comm events.
  Dispatch notes (:func:`note_dispatch`: a peer-store kernel about to
  launch, which can wedge on a dead peer) are recorded even with
  telemetry off, one deque append each; a watchdog fire dumps the last
  events with their ages (:func:`flight_lines`).

Where the JAX module skips spans under a jax trace, this one skips them
while the current stream is being captured into a CUDA graph: a capture
runs the wrapper once and no clock read there measures anything.

Bandwidth is ``nbytes / seconds``, an algorithmic rate (like
nccl-tests' busbw), not a per-link measurement. The payload conventions
are the JAX wrappers', counted over the global array (each rank's
block times the world where the JAX function takes the sharded global
array).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable

import torch

#: default flight-recorder depth; the watchdog dumps up to this many events
FLIGHT_CAPACITY = 64


@dataclass(slots=True)
class CommEvent:
    """One recorded communication event (a completed span or a dispatch
    note). ``seconds``/``gbps`` are None for dispatch-only notes.

    ``t_start``/``t_end`` are wall-clock (Unix) bounds and
    ``mono_start``/``mono_end`` the matching ``perf_counter`` reads: the
    timeline merger (``instrument/timeline.py``) places the span from the
    wall pair (clock-offset corrected) and keeps the monotonic pair as the
    duration witness."""

    op: str
    nbytes: int = 0
    axis_name: str | None = None
    world: int = 1
    seconds: float | None = None
    gbps: float | None = None
    wall_time: float = 0.0
    note: str | None = None
    t_start: float | None = None
    t_end: float | None = None
    mono_start: float | None = None
    mono_end: float | None = None
    seq: int | None = None
    meta: dict[str, Any] = field(default_factory=dict)

    def describe(self, now: float | None = None) -> str:
        """Human line for hang dumps: op, payload, axis, duration, age."""
        age = (now if now is not None else time.time()) - self.wall_time
        parts = [self.note or self.op]
        if self.nbytes:
            parts.append(f"{self.nbytes}B")
        if self.axis_name:
            parts.append(f"axis={self.axis_name}x{self.world}")
        if self.seconds is not None:
            parts.append(f"{self.seconds * 1e3:.3f}ms")
            if self.gbps is not None:
                parts.append(f"{self.gbps:.2f}GB/s")
        else:
            parts.append("dispatched")
        parts.append(f"{age:.1f}s ago")
        return " ".join(parts)

    def record(self) -> dict[str, Any]:
        """JSONL record shape (``kind: "span"``, RECORDS.md's fields)."""
        rec: dict[str, Any] = {
            "kind": "span",
            "op": self.op,
            "nbytes": self.nbytes,
            "axis": self.axis_name,
            "world": self.world,
            "seconds": self.seconds,
            "gbps": self.gbps,
            "t_start": self.t_start,
            "t_end": self.t_end,
            "mono_start": self.mono_start,
            "mono_end": self.mono_end,
        }
        if self.seq is not None:
            # per-(op, axis) call number: the k-th allreduce on rank 0
            # matches the k-th on every other rank (the anatomy key)
            rec["seq"] = self.seq
        if self.meta:
            rec.update(self.meta)
        return rec


class DispatchNote:
    """A dispatch-only flight-recorder entry (:func:`note_dispatch`): an
    op about to launch, kept light because comm wrappers note one on
    every call, traced or not. ``fields`` are formatted only when the
    note is read (:meth:`note_text`)."""

    __slots__ = ("op", "note", "wall_time", "meta", "fields")
    seconds = None

    def __init__(self, op: str, note: str, wall_time: float,
                 meta: dict[str, Any], fields: dict[str, Any] | None):
        self.op, self.note, self.wall_time = op, note, wall_time
        self.meta, self.fields = meta, fields

    def note_text(self) -> str:
        """``note(k=v, ...)`` when fields were given, else the note (a
        shape as a tuple)."""
        if not self.fields:
            return self.note
        args = ", ".join(
            f"{k}={tuple(v) if isinstance(v, torch.Size) else v}"
            for k, v in self.fields.items())
        return f"{self.note}({args})"

    def describe(self, now: float | None = None) -> str:
        """The hang dump's line, as :meth:`CommEvent.describe` words a
        dispatch: the note, ``dispatched`` and its age."""
        age = (now if now is not None else time.time()) - self.wall_time
        return f"{self.note_text()} dispatched {age:.1f}s ago"


class FlightRecorder:
    """Bounded, thread-safe ring buffer of recent :class:`CommEvent` and
    :class:`DispatchNote` entries."""

    def __init__(self, capacity: int = FLIGHT_CAPACITY):
        self._events: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()

    def push(self, event: "CommEvent | DispatchNote") -> None:
        with self._lock:
            self._events.append(event)

    def recent(self, n: int | None = None) -> list:
        """Most recent events, oldest first."""
        with self._lock:
            events = list(self._events)
        return events if n is None else events[-n:]

    def clear(self) -> None:
        with self._lock:
            self._events.clear()


class Telemetry:
    """Process-wide registry: the switch, counters, flight recorder and
    an optional per-event sink (the reporter's JSONL)."""

    def __init__(self, flight_capacity: int = FLIGHT_CAPACITY):
        self.enabled = False
        #: ``--debug-nans``: comm and hand-kernel wrappers check their
        #: outputs (instrument/nans.py)
        self.check_nans = False
        #: ``enabled or check_nans``: :func:`span_call`'s one check
        self.armed = False
        #: dispatch notes go to the flight recorder (on by default; a
        #: driver turns it off when nothing can read it: no ``--deadline``
        #: watchdog, :func:`record_flight`)
        self.notes_on = True
        self.flight = FlightRecorder(flight_capacity)
        self._sink: Callable[[dict], None] | None = None
        self._lock = threading.Lock()
        # op -> [ops, bytes, seconds]
        self._counters: dict[str, list] = {}
        # (op, axis) -> next call number; every rank runs the same
        # program, so the same counter gives matching seq values
        self._seq: dict[tuple[str, str | None], int] = {}

    def enable(self, sink: Callable[[dict], None] | None = None) -> None:
        # attribute stores are atomic under the GIL; no lock here, so a
        # watchdog thread inside emit() is never kept waiting by a main
        # thread that may be wedged (emit re-checks its snapshot, and a
        # sink that disappears mid-emit is swallowed by emit's except)
        self._sink = sink  # tpumt: ignore[TPM1601]
        self.enabled = True  # tpumt: ignore[TPM1601]
        self.armed = True

    def disable(self) -> None:
        self.enabled = False
        self._sink = None
        self.armed = self.check_nans

    def set_check_nans(self, on: bool) -> None:
        self.check_nans = bool(on)
        self.armed = self.enabled or self.check_nans

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._seq.clear()
        self.flight.clear()

    def next_seq(self, op: str, axis_name: str | None) -> int:
        """The next per-(op, axis) call number, from 0."""
        key = (op, axis_name)
        with self._lock:
            n = self._seq.get(key, 0)
            self._seq[key] = n + 1
        return n

    def record(self, event: CommEvent) -> None:
        """Record a completed span: counters, flight recorder, sink."""
        with self._lock:
            c = self._counters.setdefault(event.op, [0, 0, 0.0])
            c[0] += 1
            c[1] += event.nbytes
            c[2] += event.seconds or 0.0
        self.flight.push(event)
        if self._sink is not None:
            self._sink(event.record())

    def emit(self, record: dict[str, Any]) -> None:
        """Best-effort raw record to the sink (no counters, no flight
        entry): dispatch notes and watchdog fires. Never raises: the
        callers are hang dumps and teardown paths."""
        sink = self._sink
        if not self.enabled or sink is None:
            return
        try:
            sink(record)
        except Exception:
            pass

    def counters(self) -> dict[str, dict[str, Any]]:
        with self._lock:
            return {
                op: {"ops": c[0], "bytes": c[1], "seconds": c[2]}
                for op, c in self._counters.items()
            }


_TELEMETRY = Telemetry()

#: chaos arm point (``chaos/inject.py`` rebinds it when it arms; nothing
#: else sets it): called as ``hook(op, when)`` with ``when`` "enter"
#: before the span's clock starts and "exit" after its event recorded.
#: Read only on the enabled span path, so the disabled path stays one
#: attribute check and a disarmed run runs the code it ran before.
_CHAOS_SPAN_HOOK: Callable[[str, str], None] | None = None

#: optional cost provider (instrument/costs.py registers itself at its
#: first probe): ``provider(op, seconds)`` returns extra span fields
_COST_PROVIDER: Callable[[str, float], dict] | None = None


def set_cost_provider(provider: Callable[[str, float], dict] | None) -> None:
    global _COST_PROVIDER
    _COST_PROVIDER = provider


def _cost_meta(op: str, seconds: float) -> dict:
    """Cost fields for a closing span; a provider bug never fails the
    measured op."""
    if _COST_PROVIDER is None:
        return {}
    try:
        return _COST_PROVIDER(op, seconds) or {}
    except Exception:
        return {}


def registry() -> Telemetry:
    """The process-wide telemetry registry."""
    return _TELEMETRY


def enable(sink: Callable[[dict], None] | None = None) -> None:
    _TELEMETRY.enable(sink)


def disable() -> None:
    _TELEMETRY.disable()


def counters() -> dict[str, dict[str, Any]]:
    """Cumulative per-op counters: ``{op: {ops, bytes, seconds}}``."""
    return _TELEMETRY.counters()


def record_flight(on: bool = True) -> None:
    """Keep dispatch notes in the flight recorder (the default) or drop
    them. Its one reader is the watchdog's fire dump, so a driver run
    without ``--deadline`` drops them and a comm wrapper's note costs a
    call that returns (``drivers._common.run_guarded``)."""
    _TELEMETRY.notes_on = bool(on)


def armed() -> bool:
    """True while spans record or ``--debug-nans`` checks: what a caller
    tests before building a span's metadata."""
    return _TELEMETRY.armed


def note_dispatch(desc: str, *, record: bool = True,
                  fields: dict[str, Any] | None = None, **meta) -> None:
    """Record a dispatch-only event in the flight recorder (always on:
    one deque append). ``fields`` are the note's arguments, formatted
    as ``desc(k=v, ...)`` only when the note is read. With telemetry on
    and ``record``, the note also goes to the JSONL sink (``kind:
    "dispatch"``) so the timeline marks the op's last dispatch;
    ``record=False`` keeps it for the hang dump alone (a chained loop's
    peer-store launch a step)."""
    record = record and _TELEMETRY.enabled
    if not (record or _TELEMETRY.notes_on):
        return
    event = DispatchNote(meta.pop("op", "dispatch"), desc, time.time(),
                         meta, fields)
    if _TELEMETRY.notes_on:
        _TELEMETRY.flight.push(event)
    if record:
        _TELEMETRY.emit({"kind": "dispatch", "note": event.note_text(),
                         "op": event.op, "t": event.wall_time,
                         **event.meta})


def emit(record: dict[str, Any]) -> None:
    """Raw record to the enabled registry's sink (:meth:`Telemetry.emit`)."""
    _TELEMETRY.emit(record)


def flight_events(n: int | None = None) -> list[CommEvent]:
    return _TELEMETRY.flight.recent(n)


def flight_lines(n: int = 16) -> list[str]:
    """Formatted dump of the last ``n`` comm events, oldest first."""
    now = time.time()
    return [e.describe(now) for e in _TELEMETRY.flight.recent(n)]


class _Span:
    """Handle yielded by :func:`comm_span`; set ``result`` to the op's
    output so the span waits for it before reading the clock."""

    __slots__ = ("result",)

    def __init__(self):
        self.result = None


def _under_capture() -> bool:
    """True while the current stream is being captured into a CUDA
    graph: the wrapper runs once at capture, so a span there would time
    the capture, and a wait there is illegal. Consulted on the enabled
    path only."""
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


@contextmanager
def comm_span(op: str, nbytes: int = 0, axis_name: str | None = None,
              world: int = 1, **meta):
    """Record one communication op: seconds (sync-honest when the body
    sets ``span.result``: the span waits for the current stream of the
    result's device, not for the whole device), payload bytes and the
    derived bandwidth. An inert span when telemetry is off. Spans nest:
    each level records its own event and counter line."""
    reg = _TELEMETRY
    if not reg.enabled or _under_capture():
        yield _Span()
        return
    from tpu_mpi_tests_torch.instrument import timers

    chaos_hook = _CHAOS_SPAN_HOOK
    if chaos_hook is not None:
        # entry faults (kill, wedge) land before the clock starts, so a
        # killed span never records: dead mid-collective
        chaos_hook(op, "enter")
    span = _Span()
    seq = reg.next_seq(op, axis_name)
    t0_wall = time.time()
    t0 = time.perf_counter()
    try:
        yield span
    finally:
        if span.result is not None:
            # the result's stream only (≅ JAX's wait for the span's own
            # result): work on other streams is not the span's op
            timers.block_stream(span.result)
        t1 = time.perf_counter()
        dt = t1 - t0
        gbps = (nbytes / dt / 1e9) if (nbytes and dt > 0) else None
        cost = _cost_meta(op, dt)
        if cost:
            meta = {**cost, **meta}  # the caller's meta wins
        # wall end = start + the monotonic duration, so t_end - t_start
        # equals seconds even across a clock step
        reg.record(CommEvent(
            op=op, nbytes=int(nbytes), axis_name=axis_name, world=world,
            seconds=dt, gbps=gbps, wall_time=t0_wall + dt,
            t_start=t0_wall, t_end=t0_wall + dt, mono_start=t0,
            mono_end=t1, seq=seq, meta=meta))
        if chaos_hook is not None:
            # exit faults (the op-scoped straggler) sleep after the event
            # recorded, outside the measured window
            chaos_hook(op, "exit")


class AsyncSpan:
    """Dispatch-window span handle for the overlap engine: opened when a
    comm op is posted, closed by :meth:`done`, which waits for the op
    (the drain point) and records the event.

    The window runs from the post to the observed completion, so it is
    wider than the op's device time: it covers whatever ran alongside.
    Its records carry ``async: true`` so consumers can tell it from a
    sync-honest span. ``drain_s`` is the time :meth:`done` spent waiting:
    ~0 when the op finished under the work beside it. The host-clock
    bounds are kept whether or not telemetry records (the overlap engine
    measures with them)."""

    __slots__ = ("op", "nbytes", "axis_name", "world", "meta", "t0_wall",
                 "mono_start", "mono_end", "drain_s", "closed", "_armed",
                 "seq")

    def __init__(self, op: str, nbytes: int = 0,
                 axis_name: "str | None" = None, world: int = 1, **meta):
        self.op = op
        self.nbytes = int(nbytes)
        self.axis_name = axis_name
        self.world = world
        self.meta = meta
        self.closed = False
        self._armed = _TELEMETRY.enabled and not _under_capture()
        # numbered in post order, which every rank shares
        self.seq = (_TELEMETRY.next_seq(op, axis_name)
                    if self._armed else None)
        self.t0_wall = time.time()
        self.mono_start = time.perf_counter()
        self.mono_end = self.mono_start
        self.drain_s = 0.0

    def done(self, result=None) -> None:
        """Wait for ``result`` and close the span; idempotent.
        ``result`` is a ``torch.cuda.Event`` recorded after the op (only
        it is synchronized: the span waits on the comm event, never on
        the whole device), or the op's tensors (their current stream's
        work is waited for); None closes without a wait (the CPU, where
        the op completed when it returned)."""
        if self.closed:
            return
        self.closed = True
        if result is not None:
            from tpu_mpi_tests_torch.instrument.timers import block_stream

            t_wait = time.perf_counter()
            if isinstance(result, torch.cuda.Event):
                result.synchronize()
            else:
                block_stream(result)
            self.drain_s = time.perf_counter() - t_wait
        self.mono_end = time.perf_counter()
        if not self._armed:
            return
        dt = self.mono_end - self.mono_start
        gbps = (self.nbytes / dt / 1e9) if (self.nbytes and dt > 0) else None
        _TELEMETRY.record(CommEvent(
            op=self.op, nbytes=self.nbytes, axis_name=self.axis_name,
            world=self.world, seconds=dt, gbps=gbps,
            wall_time=self.t0_wall + dt, t_start=self.t0_wall,
            t_end=self.t0_wall + dt, mono_start=self.mono_start,
            mono_end=self.mono_end, seq=self.seq,
            meta={"async": True, "drain_s": self.drain_s, **self.meta}))


def async_span(op: str, nbytes: int = 0, axis_name: "str | None" = None,
               world: int = 1, **meta) -> AsyncSpan:
    """Open a dispatch-window span (:class:`AsyncSpan`): the op is posted
    now, the caller computes beside it, ``handle.done(...)`` drains it."""
    return AsyncSpan(op, nbytes=nbytes, axis_name=axis_name, world=world,
                     **meta)


def span_call(op: str, fn: Callable, *args, nbytes: int = 0,
              axis_name: "str | None" = None, world: int = 1, **meta):
    """``fn(*args)`` bracketed in a :func:`comm_span` that waits for its
    result. With telemetry off and ``--debug-nans`` unarmed this is one
    attribute check and the call; armed, the result is also checked for
    NaN (:mod:`~tpu_mpi_tests_torch.instrument.nans`). The JAX function
    also compile-probes jitted ops here; the port has nothing to compile
    per call and probes at the drivers' wrap points
    (``instrument/costs.py``)."""
    if not _TELEMETRY.armed:
        return fn(*args)
    from tpu_mpi_tests_torch.instrument import nans

    if not _TELEMETRY.enabled or _under_capture():
        return nans.check(op, fn(*args))
    with comm_span(op, nbytes=nbytes, axis_name=axis_name, world=world,
                   **meta) as span:
        out = fn(*args)
        span.result = out
    return nans.check(op, out)

