"""The cross-rank timeline merge (≅ ``tpu_mpi_tests/instrument/timeline.py``,
``tpumt-trace``): per-rank telemetry JSONL into one Chrome trace-event
JSON for Perfetto or ``chrome://tracing``. ``--trace-out`` calls
:func:`write_trace` when the reporter closes on rank 0.

A close copy of the JAX merge (it reads records, not devices): each
stream is assigned its rank (manifest ``process_index``) and shifted onto
rank 0's clock (``clock_sync`` offset); one trace process a rank, with a
``comm`` thread (spans; dispatch notes as instants), a ``phases`` thread
(PhaseTimer windows), a ``compile`` thread and counter tracks (``mem``
records, per-neighbour bytes). The record loader, the rank-file
expansion and the two anatomy helpers the merge calls (the partner edges
and the wait/wire split points) are copied in below. Left out: the
diagnosis markers (``FINDING`` instants, ``tpumt-doctor``'s rules, not
ported), the ASCII swimlane and the CLI; the JAX ``tpumt-trace`` reads
the port's JSONL as it is.

Stdlib only.
"""

from __future__ import annotations

import glob
import json
import sys
from pathlib import Path
from typing import Any

#: thread ids within each rank's trace process
TID_COMM = 0
TID_PHASE = 1
TID_COMPILE = 2
TID_REQ = 3

_US = 1e6  # trace-event ts/dur unit is microseconds


def load_with_lines(path: str,
                    prog: str = "tpumt-trace") -> list[tuple[int, dict]]:
    """``[(line_number, record)]`` of one JSONL file; unparsable lines
    are skipped (≅ ``diagnose.load_with_lines``)."""
    out: list[tuple[int, dict]] = []
    try:
        text = Path(path).read_text()
    except OSError as e:
        print(f"{prog}: cannot open {path}: {e}", file=sys.stderr)
        return out
    for i, line in enumerate(text.splitlines(), start=1):
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(rec, dict):
            out.append((i, rec))
    return out


def _load_records(path: str) -> list[dict]:
    return [r for _, r in load_with_lines(path)]


def expand_rank_files(paths: list[str]) -> list[str]:
    """Each path, plus the ``<stem>.p<i><suffix>`` siblings the
    per-rank reporter suffixing made; sorted, deduplicated (≅
    ``aggregate.expand_rank_files``)."""
    out: list[str] = []
    for p in paths:
        hits = set(glob.glob(p))
        path = Path(p)
        hits.update(glob.glob(str(path.with_suffix("")) + ".p*"
                              + path.suffix))
        out.extend(sorted(hits) or [p])
    seen: set[str] = set()
    return [f for f in out if not (f in seen or seen.add(f))]


def partner_edges(rec: dict, rank: int) -> list[tuple[int, int]]:
    """``[(dst, bytes)]`` sent by ``rank`` for one span carrying
    ``partners`` ring-offset metadata (≅ ``anatomy.partner_edges``)."""
    if rec.get("kind") != "span" or not rec.get("partners"):
        return []
    world = int(rec.get("world") or 1)
    per_edge = int(rec.get("partner_nbytes") or 0)
    if world < 2 or not per_edge:
        return []
    edges = []
    for d in rec["partners"]:
        dst = rank + int(d)
        if rec.get("periodic"):
            dst %= world
        elif not (0 <= dst < world):
            continue
        edges.append((dst, per_edge))
    return edges


def _eligible(rec: dict) -> bool:
    """Sync-honest collective spans the cross-rank match may align."""
    return (rec.get("kind") == "span" and rec.get("seq") is not None
            and int(rec.get("world") or 1) >= 2 and not rec.get("async")
            and rec.get("t_start") is not None
            and rec.get("t_end") is not None)


def wait_wire_subspans(streams) -> dict[tuple[str, Any, int], float]:
    """``{(op, axis, seq): latest_entry}`` for every call matched on
    every rank whose entry skew clears the clock floor (the two worst
    ``clock_sync`` spreads summed) — the wait/wire split points (≅
    ``anatomy.wait_wire_subspans``)."""
    spreads: dict[int, float] = {}
    table: dict[tuple[str, Any], dict[int, list]] = {}
    for rank, offset, records in streams:
        spreads.setdefault(rank, 0.0)
        for rec in records:
            if rec.get("kind") == "clock_sync":
                spreads[rank] = float(rec.get("spread_s") or 0.0)
            if not _eligible(rec):
                continue
            key = (rec.get("op", "?"), rec.get("axis"))
            table.setdefault(key, {}).setdefault(rank, []).append(
                (int(rec["seq"]), float(rec["t_start"]) - offset))
    unc = sum(sorted(spreads.values(), reverse=True)[:2])
    out: dict[tuple[str, Any, int], float] = {}
    for (op, axis), per_rank in table.items():
        if len(per_rank) < 2:
            continue
        by_seq: dict[int, dict[int, float]] = {}
        for rank, calls in per_rank.items():
            for seq, entry in calls:
                by_seq.setdefault(seq, {}).setdefault(rank, entry)
        ranks = set(per_rank)
        for seq, entries in by_seq.items():
            if set(entries) != ranks:
                continue
            latest = max(entries.values())
            if latest - min(entries.values()) >= unc:
                out[(op, axis, seq)] = latest
    return out


def _run_segments(records: list[dict]) -> list[list[dict]]:
    """Split one file's record stream at manifest boundaries. JSONL
    opens in append mode, so a reused ``--jsonl`` path holds several
    runs back to back; each run starts with its manifest. Records
    before the first manifest (or a file with none) form one leading
    segment, so manifest-less streams pass through whole."""
    segments: list[list[dict]] = [[]]
    for rec in records:
        if rec.get("kind") == "manifest" and segments[-1]:
            segments.append([])
        segments[-1].append(rec)
    return segments


def _segment_run_id(segment: list[dict]):
    for rec in segment:
        if rec.get("kind") == "clock_sync":
            return rec.get("run_sync_us")
    return None


def run_sync_ids(path: str) -> set:
    """All ``run_sync_us`` stamps present in a JSONL file (one per run
    appended to it) — the run-identity probe the ``--trace-out`` merge
    uses to tell sibling rank files of the current run from stale ones."""
    return {
        rid
        for seg in _run_segments(_load_records(path))
        if (rid := _segment_run_id(seg)) is not None
    }


def file_in_run(path: str, run_sync_us, mtime_after=None,
                ids: "set | None" = None) -> bool:
    """Whether ``path`` belongs to the run identified by
    ``run_sync_us`` — THE shared ghost-track filter (one copy of the
    logic): the ``--trace-out`` auto-merge, ``tpumt-top``, and
    ``tpumt-doctor --follow`` all use it to keep stale ``.p<i>``
    sibling files from an earlier run at the same base path out of the
    current run's set. Primary identity is the shared ``clock_sync``
    stamp (a file qualifies when ANY of its appended runs carries it);
    files with no stamp at all (older format / handshake unavailable)
    fall back to the ``mtime_after`` window, and pass when no window
    was given. ``ids`` is the file's precomputed :func:`run_sync_ids`
    set — the follow-mode tailer passes a cheaply scanned one so
    admitting a multi-GB file does not cost a full JSON parse."""
    if ids is None:
        ids = run_sync_ids(path)
    if run_sync_us is not None and ids:
        return run_sync_us in ids
    if mtime_after is None:
        return True
    try:
        return Path(path).stat().st_mtime >= mtime_after
    except OSError:
        return False


def rank_streams(
    files: list[str], run_sync_us: int | None = None,
    loaded: dict[str, list[tuple[int, dict]]] | None = None,
) -> list[tuple[int, float, list[dict]]]:
    """``[(rank, offset_s, records)]`` per file — ONE run's records per
    file. A file reused across runs (append mode) is segmented at its
    manifests: with ``run_sync_us`` the segment carrying that
    ``clock_sync`` stamp is chosen (newest segment when absent), else
    the newest segment — earlier runs' events must not bleed onto the
    merged timeline, where the chosen run's clock offset would misplace
    them. Rank comes from the segment's manifest ``process_index``
    (file order as fallback), the clock offset from its ``clock_sync``
    record (0 when absent — old files merge uncorrected rather than
    erroring). ``loaded`` is pre-parsed :func:`load_with_lines`
    output (line numbers dropped here) so :func:`chrome_trace` parses
    each file once for both the trace and its finding markers."""
    streams = []
    for idx, path in enumerate(files):
        pairs = (loaded or {}).get(path)
        records = ([r for _, r in pairs] if pairs is not None
                   else _load_records(path))
        segments = _run_segments(records)
        chosen = segments[-1]
        if run_sync_us is not None:
            for seg in segments:
                if _segment_run_id(seg) == run_sync_us:
                    chosen = seg
                    break
        rank, offset = idx, 0.0
        for rec in chosen:
            kind = rec.get("kind")
            if kind == "manifest" and "process_index" in rec:
                rank = rec["process_index"]
            elif kind == "clock_sync":
                offset = float(rec.get("offset_s") or 0.0)
        streams.append((rank, offset, chosen))
    return streams


def _collect(streams):
    """Split aligned records into (spans, instants, counters,
    n_unplaced).

    spans:    (rank, tid, name, cat, t_start, dur_s, args)
    instants: (rank, tid, name, cat, t, scope, args)
    counters: (rank, name, t, series_dict) — Perfetto counter samples
              from ``kind: "mem"`` records: per-device ``bytes_in_use``
              where the backend reports watermarks, live-array bytes
              (the census-only CPU/fake-device degrade path) otherwise
    Timestamps are wall-clock seconds already shifted onto rank 0's
    clock (``t - offset``); records with no ``t_start``/``t`` cannot be
    placed and are only counted (pre-timeline JSONL compatibility)."""
    spans, instants, counters, unplaced = [], [], [], 0
    # cross-rank wait/wire split points per matched (op, axis, seq)
    # call (instrument/anatomy.py): empty on pre-seq streams, so the
    # legacy trace document is byte-identical
    splits = wait_wire_subspans(streams)
    # cumulative bytes sent per (src rank → dst rank) edge, sampled at
    # each partner-annotated span's end — the traffic matrix as
    # Perfetto counter tracks
    sent: dict[int, dict[str, int]] = {}
    # cumulative bytes per link class (comm/topology.py partner_link
    # stamps) — its own counter track, present only on non-flat runs
    sent_link: dict[int, dict[str, int]] = {}

    def args_from(rec, keys):
        return {k: rec[k] for k in keys if rec.get(k) is not None}

    for rank, offset, records in streams:
        for rec in records:
            kind = rec.get("kind")
            if kind == "span":
                if rec.get("t_start") is None:
                    unplaced += 1
                    continue
                start = float(rec["t_start"]) - offset
                end = float(rec.get("t_end") or rec["t_start"]) - offset
                op = rec.get("op", "?")
                spans.append((
                    rank, TID_COMM, op, "comm", start,
                    max(end - start, 0.0),
                    args_from(rec, ("nbytes", "gbps", "axis", "world",
                                    "seconds", "cost_bytes",
                                    "model_gbps", "roofline_frac",
                                    "async", "overlap_depth",
                                    "dispatch_depth", "seq", "link")),
                ))
                # wait/wire sub-spans nested under the collective span
                # (appended after the parent, so stable ts-sorting
                # keeps parent-before-child for the nesting renderer):
                # wait = own entry → last arriver, wire = the rest
                split = (splits.get((op, rec.get("axis"), rec["seq"]))
                         if rec.get("seq") is not None
                         and not rec.get("async") else None)
                if split is not None and end > start:
                    sub_args = {"seq": rec["seq"]}
                    if start < split < end:
                        spans.append((rank, TID_COMM, f"wait {op}",
                                      "comm_wait", start, split - start,
                                      sub_args))
                        spans.append((rank, TID_COMM, f"wire {op}",
                                      "comm_wire", split, end - split,
                                      sub_args))
                    else:
                        # this rank IS the last arriver (or the split
                        # clamps outside its span): all wire
                        spans.append((rank, TID_COMM, f"wire {op}",
                                      "comm_wire", start, end - start,
                                      sub_args))
                edges = partner_edges(rec, rank)
                if edges:
                    cum = sent.setdefault(rank, {})
                    for dst, nbytes in edges:
                        key = f"to r{dst}"
                        cum[key] = cum.get(key, 0) + nbytes
                    counters.append((rank, "comm bytes sent", end,
                                     dict(cum)))
                    links = rec.get("partner_link")
                    if links:
                        # align classes with the kept edges — the same
                        # out-of-range drop rule as partner_edges
                        world = int(rec.get("world") or 1)
                        kept = [
                            str(cls)
                            for d, cls in zip(rec.get("partners") or [],
                                              links)
                            if rec.get("periodic")
                            or 0 <= rank + int(d) < world
                        ]
                        lcum = sent_link.setdefault(rank, {})
                        for (_dst, nbytes), cls in zip(edges, kept):
                            lcum[cls] = lcum.get(cls, 0) + nbytes
                        counters.append((rank, "comm bytes by link",
                                         end, dict(lcum)))
            elif kind == "time":
                if rec.get("event") == "progress":
                    # live cumulative snapshots (metrics plane): their
                    # t_start..t_end window is the phase's whole
                    # lifetime so far — rendering each would stack
                    # ever-longer ghost spans over the real phases
                    continue
                if rec.get("t_start") is None:
                    unplaced += 1
                    continue
                start = float(rec["t_start"]) - offset
                end = float(rec.get("t_end") or rec["t_start"]) - offset
                spans.append((
                    rank, TID_PHASE, rec.get("phase", "?"), "phase",
                    start, max(end - start, 0.0),
                    args_from(rec, ("seconds", "count", "mean_s", "min_s",
                                    "max_s")),
                ))
            elif kind == "dispatch":
                if rec.get("t") is None:
                    unplaced += 1
                    continue
                instants.append((
                    rank, TID_COMM,
                    rec.get("note") or rec.get("op", "dispatch"),
                    "dispatch", float(rec["t"]) - offset, "t", {},
                ))
            elif kind == "watchdog":
                if rec.get("t") is None:
                    unplaced += 1
                    continue
                instants.append((
                    rank, TID_COMM,
                    f"WATCHDOG {rec.get('phase', '?')}", "watchdog",
                    float(rec["t"]) - offset, "p",
                    args_from(rec, ("deadline_s",)),
                ))
            elif kind == "control":
                # the re-tune controller acting (tune/controller.py):
                # a process-scoped marker at the hot-swap instant, so
                # the timeline shows the schedule change between the
                # sagging windows and the recovered ones
                if rec.get("t") is None:
                    unplaced += 1
                    continue
                instants.append((
                    rank, TID_COMM,
                    f"CONTROL {rec.get('event', '?')} "
                    f"{rec.get('class') or rec.get('knob', '?')}",
                    "control", float(rec["t"]) - offset, "p",
                    args_from(rec, ("knob", "op", "old", "new",
                                    "sag_pct", "signal", "resweep_s")),
                ))
            elif kind == "compile":
                if rec.get("t_start") is None:
                    unplaced += 1
                    continue
                start = float(rec["t_start"]) - offset
                end = float(rec.get("t_end") or rec["t_start"]) - offset
                spans.append((
                    rank, TID_COMPILE,
                    f"compile {rec.get('label', '?')}", "compile",
                    start, max(end - start, 0.0),
                    args_from(rec, ("seconds", "flops", "bytes_accessed",
                                    "temp_bytes", "output_bytes",
                                    "fingerprint")),
                ))
            elif kind == "req":
                # request lifecycle exemplars (serve loop sampler): the
                # window's p99-worst completion plus shed/error
                # terminals, rendered as a queue span (arrival ->
                # dispatch, or -> death for sheds) and a service span
                # (dispatch -> done) on the owning rank's requests
                # track — per-request latency anatomy on the timeline
                t_arr = rec.get("t_arrival")
                if t_arr is None:
                    unplaced += 1
                    continue
                t_arr = float(t_arr) - offset
                t_disp = rec.get("t_dispatch")
                t_done = rec.get("t_done")
                label = f"{rec.get('event', '?')} {rec.get('class', '?')}"
                q_end = float(t_disp if t_disp is not None
                              else (t_done if t_done is not None
                                    else rec["t_arrival"])) - offset
                spans.append((
                    rank, TID_REQ, f"queue {label}", "req_queue",
                    t_arr, max(q_end - t_arr, 0.0),
                    args_from(rec, ("sampled", "queue_ms", "e2e_ms")),
                ))
                if t_disp is not None and t_done is not None:
                    start = float(t_disp) - offset
                    end = float(t_done) - offset
                    spans.append((
                        rank, TID_REQ, f"service {label}", "req_service",
                        start, max(end - start, 0.0),
                        args_from(rec, ("sampled", "service_ms",
                                        "e2e_ms", "requests")),
                    ))
            elif kind == "mem":
                if rec.get("t") is None:
                    unplaced += 1
                    continue
                t = float(rec["t"]) - offset
                devices = rec.get("devices") or {}
                if devices:
                    counters.append((
                        rank, "HBM bytes_in_use", t,
                        {f"dev{d}": s.get("bytes_in_use", 0)
                         for d, s in sorted(devices.items())},
                    ))
                elif rec.get("live_bytes") is not None:
                    # census-only degrade path (no memory_stats): the
                    # live-array total still draws a counter track
                    counters.append((
                        rank, "live bytes", t,
                        {"bytes": rec["live_bytes"]},
                    ))
    return spans, instants, counters, unplaced


def chrome_trace(
    files: list[str], run_sync_us: int | None = None
) -> dict:
    """Merge the per-rank files into a Chrome trace-event document
    (the JSON-object form: ``{"traceEvents": [...], ...}``). ``ts`` is
    microseconds from the earliest aligned event; the absolute epoch is
    kept in ``otherData.t0_unix_s``. ``run_sync_us`` selects one run's
    segment in files appended to across runs (see
    :func:`rank_streams`)."""
    loaded = {p: load_with_lines(p) for p in files}
    streams = rank_streams(files, run_sync_us, loaded=loaded)
    spans, instants, counters, unplaced = _collect(streams)
    starts = ([s[4] for s in spans] + [i[4] for i in instants]
              + [c[2] for c in counters])
    t0 = min(starts) if starts else 0.0

    compile_ranks = {s[0] for s in spans if s[1] == TID_COMPILE}
    req_ranks = {s[0] for s in spans if s[1] == TID_REQ}
    events = []
    for rank in sorted({r for r, _, _ in streams}):
        events.append({"ph": "M", "name": "process_name", "pid": rank,
                       "tid": 0, "args": {"name": f"rank {rank}"}})
        events.append({"ph": "M", "name": "thread_name", "pid": rank,
                       "tid": TID_COMM, "args": {"name": "comm"}})
        events.append({"ph": "M", "name": "thread_name", "pid": rank,
                       "tid": TID_PHASE, "args": {"name": "phases"}})
        if rank in compile_ranks:
            events.append({"ph": "M", "name": "thread_name", "pid": rank,
                           "tid": TID_COMPILE,
                           "args": {"name": "compile"}})
        if rank in req_ranks:
            events.append({"ph": "M", "name": "thread_name", "pid": rank,
                           "tid": TID_REQ,
                           "args": {"name": "requests"}})
    for rank, tid, name, cat, start, dur, args in sorted(
        spans, key=lambda s: s[4]
    ):
        events.append({"ph": "X", "name": name, "cat": cat, "pid": rank,
                       "tid": tid, "ts": (start - t0) * _US,
                       "dur": dur * _US, "args": args})
    for rank, tid, name, cat, t, scope, args in sorted(
        instants, key=lambda s: s[4]
    ):
        events.append({"ph": "i", "name": name, "cat": cat, "pid": rank,
                       "tid": tid, "ts": (t - t0) * _US, "s": scope,
                       "args": args})
    # counter tracks ("C" events): one track per (rank, name) — memory
    # watermarks (one series per device, or the census-only live-bytes
    # series) and the cumulative per-neighbor traffic-matrix bytes
    for rank, name, t, series in sorted(counters, key=lambda c: c[2]):
        cat = ("traffic"
               if name in ("comm bytes sent", "comm bytes by link")
               else "mem")
        events.append({"ph": "C", "name": name, "cat": cat, "pid": rank,
                       "tid": 0, "ts": (t - t0) * _US, "args": series})
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "files": list(files),
            "t0_unix_s": t0,
            "unplaced_records": unplaced,
            "clock_offsets_s": {
                str(r): off for r, off, _ in streams
            },
        },
    }


def placed_events(doc: dict) -> int:
    """Placed (non-metadata) event count of a trace document."""
    return sum(1 for e in doc["traceEvents"] if e["ph"] != "M")


def write_trace(
    files: list[str], out_path: str, run_sync_us: int | None = None
) -> int:
    """Merge ``files`` and write the trace document to ``out_path``.
    Returns the number of placed events (metadata excluded)."""
    doc = chrome_trace(files, run_sync_us)
    Path(out_path).write_text(json.dumps(doc))
    return placed_events(doc)


# ---------------------------------------------------------------------------
# terminal fallback: ASCII swimlane + per-step skew (tpumt-report --timeline)
# ---------------------------------------------------------------------------
