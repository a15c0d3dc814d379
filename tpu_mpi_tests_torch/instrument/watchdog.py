"""Hang watchdog: a deadline that dumps a diagnosis and hard-exits (≅
``tpu_mpi_tests/instrument/watchdog.py``).

A peer that dies inside a collective stalls every other rank; so does a
peer-store kernel waiting on a flag that never comes. A deadline turns
that stall into an immediate, attributed failure: the fire prints the
last comm events of the telemetry flight recorder (every span and every
dispatch note, :func:`note_comm_op`) with their ages, and the memory
state, then exits the process.

The fire runs on a timer thread while the main thread may sit in a
launch or a wait that never returns. Its dump therefore never waits for
the device and never reads a device tensor: the flight recorder is host
state, and the memory lines are the caching allocator's host-side
counters and block list (``instrument/memwatch.py``, the card's limit
only if it was already read). It then exits with ``os._exit``, which
does not wait for the device either.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from contextlib import contextmanager

from tpu_mpi_tests_torch.instrument import telemetry as _telemetry

#: how many flight-recorder events a fire dumps
DUMP_EVENTS = 16

#: how many census buckets a fire dumps
MEM_DUMP_TOP_K = 8


def note_comm_op(desc: str, record: bool = True, **fields) -> None:
    """Record a comm op about to be launched in the flight recorder
    (always on: one append). A launch returns at once and a hang shows
    at a later wait; the recently launched comm ops are the best
    attribution of what wedged. ``fields`` describe the op as
    ``desc(k=v, ...)``, formatted only when a dump or a record reads
    the note. ``record=False`` keeps the note out of the JSONL (a
    chained loop's launch a step)."""
    _telemetry.note_dispatch(desc, record=record, fields=fields or None)


def last_comm_op() -> str | None:
    """The most recent comm event, formatted with its age."""
    lines = _telemetry.flight_lines(1)
    return lines[-1] if lines else None


def comm_op_history(n: int = DUMP_EVENTS) -> list[str]:
    """The last ``n`` comm events (oldest first), formatted."""
    return _telemetry.flight_lines(n)


def memory_state_lines(top_k: int = MEM_DUMP_TOP_K) -> list[str]:
    """The memory state for a fire dump (watermarks and the top census
    buckets), mirrored into the JSONL sink as a ``kind: "mem"`` record
    (``event: "watchdog"``) when telemetry is on. Never raises and never
    waits for the device."""
    try:
        from tpu_mpi_tests_torch.instrument import memwatch

        _telemetry.emit(memwatch.mem_record(event="watchdog", top_k=top_k,
                                            query_limit=False))
        return memwatch.watermark_lines(top_k)
    except Exception:
        return []


class Watchdog:
    """A timer around a named phase: if the phase has not finished in
    ``seconds``, print a diagnosis to stderr and hard-exit."""

    def __init__(self, seconds: float, phase: str = "phase",
                 exit_code: int = 9, _on_timeout=None):
        self.seconds = seconds
        self.phase = phase
        self.exit_code = exit_code
        self._on_timeout = _on_timeout  # test hook
        self._timer: threading.Timer | None = None

    def _fire(self):
        # the fire's place on the merged timeline (best effort)
        _telemetry.emit({"kind": "watchdog", "phase": self.phase,
                         "deadline_s": self.seconds, "t": time.time()})
        history = comm_op_history()
        attribution = (
            f" last {len(history)} comm ops (newest last):\n    "
            + "\n    ".join(history) + "\n " if history else "")
        mem_lines = memory_state_lines()
        memory = (f" memory at fire:\n    " + "\n    ".join(mem_lines)
                  + "\n " if mem_lines else "")
        msg = (
            f"WATCHDOG: phase '{self.phase}' exceeded {self.seconds}s — "
            f"likely a hung collective (dead peer / mismatched world / "
            f"wedged peer-store flag);{attribution}{memory} "
            f"aborting pid {os.getpid()}\n"
        )
        if self._on_timeout is not None:
            self._on_timeout(msg)
            return
        sys.stderr.write(msg)
        sys.stderr.flush()
        sys.stdout.flush()
        os._exit(self.exit_code)

    def start(self):
        self._timer = threading.Timer(self.seconds, self._fire)
        self._timer.daemon = True
        self._timer.start()
        return self

    def cancel(self):
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None


class IdleAwareWatchdog(Watchdog):
    """A watchdog whose deadline runs only while armed (≅ the JAX class):
    ``arm()`` (re)starts the timer before a dispatch, ``disarm()`` stops
    it when the batch completed, so idle gaps between batches never
    fire; an armed batch that never completes still dumps and exits."""

    def arm(self, phase: str | None = None) -> "IdleAwareWatchdog":
        """(Re)start the deadline for one active window."""
        if phase is not None:
            # a firing timer reading phase mid-update can only mislabel
            # its dump (a str rebind is atomic under the GIL), and arm()
            # cancels the old timer before starting the next
            self.phase = phase  # tpumt: ignore[TPM1601]
        self.cancel()
        return self.start()

    def disarm(self) -> None:
        """Back to idle: the deadline stops."""
        self.cancel()

    @contextmanager
    def active(self, phase: str | None = None):
        """``with wd.active("batch"): dispatch()``: armed only inside."""
        self.arm(phase)
        try:
            yield self
        finally:
            self.disarm()


@contextmanager
def deadline(seconds: float | None, phase: str = "phase"):
    """``with deadline(120, "allgather"): ...``; a no-op when
    ``seconds`` is None or 0, so drivers thread ``--deadline`` through."""
    if not seconds:
        yield
        return
    wd = Watchdog(seconds, phase).start()
    try:
        yield
    finally:
        wd.cancel()
