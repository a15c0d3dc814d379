"""Deterministic traffic record/replay for the serving loop (≅
``tpu_mpi_tests/serve/replay.py``: the same ``tpumt-traffic`` format,
version 1, and the same fingerprint, so an artifact either package
writes loads in the other under the same identity).

A serve run's load is defined by its arrival-time + class-key stream.
Seeding the generators (``serve/arrival.py`` + the mix drawer) makes two
runs *statistically* identical; an A/B of two schedules wants more: the
same traffic, not two draws from the same distribution.

* :class:`TrafficRecorder` — rides the loop's admission path
  (``--record traffic.json``) and captures every offered arrival as
  ``(relative_time, class_key)``: the artifact is the *offered* stream,
  whether the system served or shed each request is the measured
  response.
* :func:`save_traffic`/:func:`load_traffic` — the versioned portable
  artifact, fingerprinted over its count / duration / per-class
  composition / microsecond-rounded event stream, so two artifacts
  with the same fingerprint carry the same traffic and a corrupted or
  version-skewed file is refused loudly (:class:`TrafficFormatError`),
  never half-replayed.
* :class:`ReplayArrivals` — an arrival process (the same four-method
  interface the loop drives) that reproduces the recorded stream:
  arrivals are re-scheduled at their recorded offsets from the loop's
  own ``t0`` (clock-injectable, so tests replay a long trace instantly)
  and the recorded class keys override the mix drawer via the loop's
  ``draw_class`` hook. Open- and closed-loop recordings replay the same
  way — a closed loop's completion-gated admission times *are* its
  traffic.

Pure stdlib (json + hashlib).
"""

from __future__ import annotations

import hashlib
import json

#: artifact format marker — a file without it is not a traffic artifact
TRAFFIC_FORMAT = "tpumt-traffic"

#: artifact schema version; :func:`load_traffic` refuses other versions
#: (forward-compat: an older build must not silently mis-replay a newer
#: artifact's stream)
TRAFFIC_VERSION = 1


class TrafficFormatError(ValueError):
    """A traffic artifact that cannot be trusted: unreadable, not the
    expected format, a version this build does not speak, or contents
    that fail the fingerprint self-check."""


def traffic_fingerprint(events: list, duration_s: float) -> str:
    """Stable identity of one traffic stream: sha256 (truncated) over
    the count, the microsecond-rounded duration, the per-class
    composition, and the microsecond-rounded event stream itself.
    Rounding to 1 us makes the fingerprint robust to float round-trips
    through JSON while still pinning the actual schedule, not just its
    histogram."""
    comp: dict[str, int] = {}
    for _t, key in events:
        comp[key] = comp.get(key, 0) + 1
    payload = {
        "version": TRAFFIC_VERSION,
        "count": len(events),
        "duration_us": int(round(float(duration_s) * 1e6)),
        "classes": {k: comp[k] for k in sorted(comp)},
        "events": [[int(round(float(t) * 1e6)), key]
                   for t, key in events],
    }
    blob = json.dumps(payload, sort_keys=True,
                      separators=(",", ":")).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


class TrafficRecorder:
    """Capture the offered arrival stream of one serve run.

    The loop calls :meth:`add` once per admission attempt (before the
    shed decision — the artifact is the load, not the outcome) with the
    arrival's offset from the run's ``t0`` and the drawn class key.
    :meth:`finalize` freezes the artifact dict."""

    def __init__(self, arrival: str = "?", load: str = ""):
        self.arrival = arrival
        self.load = load
        self.events: list[tuple[float, str]] = []

    def add(self, rel_t: float, class_key: str) -> None:
        self.events.append((float(rel_t), class_key))

    def finalize(self, duration_s: float) -> dict:
        comp: dict[str, int] = {}
        for _t, key in self.events:
            comp[key] = comp.get(key, 0) + 1
        return {
            "format": TRAFFIC_FORMAT,
            "version": TRAFFIC_VERSION,
            "arrival": self.arrival,
            "load": self.load,
            "duration_s": float(duration_s),
            "count": len(self.events),
            "classes": {k: comp[k] for k in sorted(comp)},
            "fingerprint": traffic_fingerprint(self.events, duration_s),
            "events": [[t, key] for t, key in self.events],
        }


def save_traffic(path: str, artifact: dict) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(artifact, f, indent=1)
        f.write("\n")


def load_traffic(path: str) -> dict:
    """Load + validate a traffic artifact. Raises
    :class:`TrafficFormatError` with a human-readable reason on ANY
    defect — the driver turns it into a visible NOTE + exit 2, never a
    crash and never a silent partial replay."""
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
    except OSError as e:
        raise TrafficFormatError(f"cannot open {path}: {e}") from e
    except json.JSONDecodeError as e:
        raise TrafficFormatError(
            f"{path} is not valid JSON ({e}) — corrupted or not a "
            f"traffic artifact") from e
    if not isinstance(doc, dict) or doc.get("format") != TRAFFIC_FORMAT:
        raise TrafficFormatError(
            f"{path} is not a {TRAFFIC_FORMAT} artifact (format="
            f"{doc.get('format') if isinstance(doc, dict) else type(doc).__name__!r})")
    if doc.get("version") != TRAFFIC_VERSION:
        raise TrafficFormatError(
            f"{path} is traffic schema version {doc.get('version')!r}; "
            f"this build speaks version {TRAFFIC_VERSION} — re-record "
            f"with this build or replay with the one that recorded it")
    events = doc.get("events")
    if not isinstance(events, list) or any(
        not (isinstance(e, list) and len(e) == 2
             and isinstance(e[0], (int, float))
             and isinstance(e[1], str))
        for e in events
    ):
        raise TrafficFormatError(
            f"{path}: malformed event stream — want [[seconds, "
            f"class_key], ...]")
    if doc.get("count") != len(events):
        raise TrafficFormatError(
            f"{path}: count={doc.get('count')} does not match "
            f"{len(events)} events — truncated artifact")
    pairs = [(float(t), key) for t, key in events]
    if any(b[0] < a[0] for a, b in zip(pairs, pairs[1:])):
        raise TrafficFormatError(
            f"{path}: event times are not monotone — corrupted stream")
    want = traffic_fingerprint(pairs, float(doc.get("duration_s") or 0.0))
    if doc.get("fingerprint") != want:
        raise TrafficFormatError(
            f"{path}: fingerprint {doc.get('fingerprint')!r} does not "
            f"match the recomputed stream identity {want!r} — the "
            f"artifact was edited or corrupted")
    return doc


class ReplayArrivals:
    """Arrival process replaying a recorded stream byte-identically.

    Implements the loop's four-method arrival interface (``start`` /
    ``take_due`` / ``next_event`` / ``on_complete``) plus the
    ``draw_class`` hook the loop consults when present: class keys come
    from the recording, in admission order, instead of the seeded mix
    drawer — two replays of one artifact admit the exact same
    ``(time, class)`` sequence. ``on_complete`` is a no-op: replay is
    open-loop by construction even for closed-loop recordings, because
    the recorded admission times already encode the original
    completion gating."""

    def __init__(self, artifact: dict):
        events = artifact.get("events") or []
        self._rel = [float(t) for t, _k in events]
        self._keys = [str(k) for _t, k in events]
        self.duration_s = float(artifact.get("duration_s") or 0.0)
        self.fingerprint = artifact.get("fingerprint")
        self.classes = dict(artifact.get("classes") or {})
        self._t0: float | None = None
        self._i = 0  # next arrival to schedule
        self._j = 0  # next class key to hand out

    def start(self, t0: float) -> None:
        self._t0 = t0
        self._i = self._j = 0

    def take_due(self, now: float, limit: float | None = None) -> list[float]:
        if self._t0 is None:
            return []
        cutoff = now if limit is None else min(now, limit)
        due: list[float] = []
        while (self._i < len(self._rel)
               and self._t0 + self._rel[self._i] <= cutoff):
            due.append(self._t0 + self._rel[self._i])
            self._i += 1
        return due

    def next_event(self) -> float | None:
        if self._t0 is None or self._i >= len(self._rel):
            return None
        return self._t0 + self._rel[self._i]

    def on_complete(self, n: int, now: float) -> None:
        pass  # the recording already encodes any completion gating

    def draw_class(self) -> str | None:
        """The recorded class key for the next admitted arrival; None
        once exhausted (the loop falls back to its mix drawer — only
        reachable if something injects arrivals beyond the recording,
        e.g. a flood hook in the loop's ``_CHAOS_FLOOD`` slot armed on
        top of a replay)."""
        if self._j >= len(self._keys):
            return None
        key = self._keys[self._j]
        self._j += 1
        return key
