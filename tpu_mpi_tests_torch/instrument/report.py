"""Structured result reporting: stable stdout lines + JSONL
(≅ ``tpu_mpi_tests/instrument/report.py``, the line shapes kept exactly so
the reference's aggregation workflow parses the port's output):

  ``<rank>/<size> SUM = <v>``
  ``TEST dim:<d>, <space>, buf:<b>; <t>, err=<e>``
  ``ITER dim:<d>, <space>, buf:<b>; <phase> mean=<m>, min=<m>, max=<m>``
  ``TIME <phase> : <s>``
"""

from __future__ import annotations

import json
import sys
import threading
import time
from pathlib import Path
from typing import IO, Any


def rank_suffixed_path(path: str, proc_index: int) -> str:
    """``out.jsonl`` → ``out.p<i>.jsonl``: one file per rank (≅ the JAX
    function), so ranks never interleave partial lines in one file."""
    p = Path(path)
    return str(p.with_suffix("")) + f".p{proc_index}" + p.suffix


class Reporter:
    """Line + JSONL emitter; a context manager that closes the JSONL file.
    Every rank prints its lines; banner lines are rank-0 only, like the
    reference's (``mpi_stencil2d_gt.cc:682-688``).

    ``rank``/``size`` are the logical rank and world the lines name;
    ``proc_index``/``proc_count`` the real process (default: the same).
    With more than one process the JSONL path is suffixed per process
    (:func:`rank_suffixed_path`). Closing it stops the attached live
    plane (:meth:`attach_live`: the heartbeat's and the progress hook's
    final records) and memory watcher (its final record), flushes the
    telemetry summary when :meth:`attach_telemetry` opted in, closes the file and, with
    ``trace_out`` on process 0, merges the run's JSONL into a trace
    (:meth:`_write_trace`)."""

    def __init__(self, rank: int = 0, size: int = 1,
                 jsonl_path: str | None = None,
                 stream: IO[str] | None = None,
                 proc_index: "int | None" = None,
                 proc_count: "int | None" = None,
                 trace_out: str | None = None):
        self.rank = rank
        self.size = size
        self.proc_index = rank if proc_index is None else proc_index
        proc_count = size if proc_count is None else proc_count
        # the unsuffixed path: the trace merge finds every rank's file
        # from it
        self._jsonl_base = jsonl_path
        if jsonl_path and proc_count > 1:
            jsonl_path = rank_suffixed_path(jsonl_path, self.proc_index)
        self.jsonl_path = jsonl_path
        self.trace_out = trace_out
        self.stream = stream or sys.stdout
        self._jsonl_file: IO[str] | None = None
        self._jsonl_lock = threading.Lock()
        self._telemetry = False
        self._memwatch = None
        #: the live plane (``--metrics-port``): the registry the records
        #: are teed into, and the parts closing stops
        self._metrics = None
        self._live: list = []
        self._created_at = time.time()  # the trace merge skips older files
        #: this run's clock_sync identity (set by make_reporter)
        self.run_sync_us: int | None = None

    def __enter__(self) -> "Reporter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def line(self, text: str, record: dict[str, Any] | None = None):
        print(text, file=self.stream, flush=True)
        if record is not None:
            self.jsonl(record)

    def banner(self, text: str):
        if self.rank == 0:
            self.line(text)

    def sum_line(self, value: float, label: str = "SUM", rank=None):
        r = self.rank if rank is None else rank
        self.line(
            f"{r}/{self.size} {label} = {value:f}",
            {"kind": "sum", "label": label, "rank": r, "size": self.size,
             "value": float(value)},
        )

    def time_line(self, phase: str, seconds: float,
                  t_start: float | None = None, t_end: float | None = None):
        """One ``TIME`` line + ``time`` record; ``t_start``/``t_end`` are
        the phase's wall-clock bounds (``PhaseTimer.wall_span``), taken as
        ``[now − seconds, now]`` when the caller has none."""
        if t_end is None:
            t_end = time.time()
        if t_start is None:
            t_start = t_end - seconds
        self.line(
            f"TIME {phase} : {seconds:0.6f}",
            {"kind": "time", "phase": phase, "seconds": float(seconds),
             "t_start": t_start, "t_end": t_end, "rank": self.rank},
        )

    def time_lines(self, timer, stats: bool = False):
        """One ``TIME`` line per accumulated phase of a ``PhaseTimer``
        (with ``stats``: count/mean/min/max on the line); the JSONL
        ``time`` record always carries the distribution."""
        for text in timer.lines(stats=stats):
            print(text, file=self.stream, flush=True)
        for name in timer.seconds:
            t_start, t_end = timer.wall_span(name)
            self.jsonl(
                {"kind": "time", "phase": name,
                 "seconds": float(timer.seconds[name]),
                 "count": timer.counts[name],
                 "mean_s": timer.mean(name),
                 "min_s": timer.mins.get(name, 0.0),
                 "max_s": timer.maxs.get(name, 0.0),
                 "t_start": t_start, "t_end": t_end,
                 "mono_start": timer.mono_starts.get(name),
                 "mono_end": timer.mono_ends.get(name),
                 "rank": self.rank,
                 # annotated extras (PhaseTimer.annotate): overlap_frac
                 **timer.extras.get(name, {})}
            )

    def test_line(self, dim: int, space: str, buf, seconds: float,
                  err: float, extra_label: str | None = None,
                  show_err: bool = True):
        space_s = f"{space:7s}"
        if extra_label:
            text = (f"TEST dim:{dim}, {space_s}, buf:{int(buf)}; "
                    f"{extra_label}={seconds:f}")
            if show_err:
                text += f", err={err:e}"
        else:
            text = (f"TEST dim:{dim}, {space_s}, buf:{int(buf)}; "
                    f"{seconds:f}, err={err:e}")
        self.line(
            text,
            {"kind": "test", "dim": dim, "space": space, "buf": int(buf),
             "seconds": float(seconds), "err": float(err),
             "label": extra_label},
        )

    def iter_line(self, dim: int, space: str, buf, phase: str,
                  mean_s: float, min_s: float, max_s: float):
        space_s = f"{space:7s}"
        self.line(
            f"ITER dim:{dim}, {space_s}, buf:{int(buf)}; {phase} "
            f"mean={mean_s:e}, min={min_s:e}, max={max_s:e}",
            {"kind": "iter", "dim": dim, "space": space, "buf": int(buf),
             "phase": phase, "mean_s": float(mean_s),
             "min_s": float(min_s), "max_s": float(max_s)},
        )

    def attach_telemetry(self):
        """Flush the telemetry registry on close: a ``TELEMETRY`` line and
        a ``telemetry_summary`` record per op, then disable it."""
        self._telemetry = True

    def attach_memwatch(self, memwatch):
        """Own a running ``MemWatch``: closing stops it (its final
        record lands before the file closes)."""
        self._memwatch = memwatch

    def attach_metrics(self, registry):
        """Tee every record this reporter writes into a live
        :class:`~tpu_mpi_tests_torch.instrument.metrics.MetricsRegistry`
        (≅ the JAX method): whatever flows to the JSONL also updates the
        named series. Attached during setup, before any live thread
        starts; a reporter without a registry pays one ``None`` check."""
        # jsonl's unlocked read on a live thread sees either None or the
        # final binding, never a torn value (attribute stores are atomic
        # under the GIL)
        self._metrics = registry  # tpumt: ignore[TPM1601]

    @property
    def metrics(self):
        """The attached live registry, or None."""
        return self._metrics

    def attach_live(self, *stoppables):
        """Own live-plane parts (the heartbeat thread, the exporter, the
        phase-progress hook): closing calls ``stop()`` on each, in attach
        order, before the JSONL file closes, so their final records
        still land."""
        self._live.extend(stoppables)

    def jsonl(self, record: dict[str, Any]):
        # the live tee runs outside the lock (observe locks itself, and a
        # tune_stale health record emitted from inside observe re-enters
        # here) and before the path check, so the series update even
        # with no JSONL file
        if self._metrics is not None:
            try:
                self._metrics.observe(record)
            except Exception:
                pass
        # one locked write() a record: the memory sampler, the heartbeat
        # and the watchdog write from their own threads
        if not self.jsonl_path:
            return
        line = json.dumps(record) + "\n"
        with self._jsonl_lock:
            if self._jsonl_file is None:
                self._jsonl_file = open(self.jsonl_path, "a")
            self._jsonl_file.write(line)
            self._jsonl_file.flush()

    def close(self):
        live, self._live = self._live, []
        for obj in live:
            try:
                obj.stop()  # final heartbeat / progress snapshot first
            except Exception:
                pass
        if self._memwatch is not None:
            memwatch, self._memwatch = self._memwatch, None
            try:
                memwatch.stop()
            except Exception:
                pass
        if self._telemetry:
            self._telemetry = False
            from tpu_mpi_tests_torch.instrument import telemetry as T

            for op, c in sorted(T.counters().items()):
                self.line(
                    f"TELEMETRY {op} : ops={c['ops']} bytes={c['bytes']} "
                    f"seconds={c['seconds']:0.6f}",
                    {"kind": "telemetry_summary", "op": op,
                     "rank": self.rank, **c},
                )
            T.disable()
        with self._jsonl_lock:
            if self._jsonl_file is not None:
                self._jsonl_file.close()
                self._jsonl_file = None
        self._write_trace()

    def _write_trace(self):
        """``--trace-out``: once this rank's JSONL is closed, process 0
        merges this run's rank files into a Chrome trace (the port's
        ``instrument/timeline.py``). A file belongs to the run when one of
        its runs carries this run's ``clock_sync`` stamp; a file with no
        stamp falls back to a modification-time window. Ranks that have
        not flushed yet contribute fewer events."""
        if not self.trace_out or self.proc_index != 0:
            return
        self.trace_out, out = None, self.trace_out  # once per close
        if not self._jsonl_base:
            self.line(f"TRACE SKIPPED {out}: --trace-out needs --jsonl "
                      f"records to merge")
            return
        from tpu_mpi_tests_torch.instrument.timeline import (
            expand_rank_files,
            file_in_run,
            write_trace,
        )

        def current(f: str) -> bool:
            if self.jsonl_path and Path(f) == Path(self.jsonl_path):
                return True
            return file_in_run(f, self.run_sync_us,
                               mtime_after=self._created_at - 5.0)

        files = [f for f in expand_rank_files([self._jsonl_base])
                 if Path(f).exists() and current(f)]
        try:
            n = write_trace(files, out, run_sync_us=self.run_sync_us)
        except OSError as e:
            self.line(f"TRACE ERROR {out}: {e}")
            return
        self.line(f"TRACE {out}: {n} events from {len(files)} "
                  f"file{'s' if len(files) != 1 else ''} "
                  f"(open in Perfetto / chrome://tracing)")
