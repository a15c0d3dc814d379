"""Persistent schedule cache (≅ ``tpu_mpi_tests/tune/cache.py``): one
JSON file mapping (knob, fingerprint) to a measured winner.

The file's layout, :data:`CACHE_VERSION`, the ``TPU_MPI_TUNE_CACHE``
variable and the default path (``~/.cache/tpumt/tune.json``, honouring
``XDG_CACHE_HOME``) are the JAX package's, so both packages may read and
write one file: their fingerprints differ (``tune/fingerprint.py``: the
port's carry ``stack=torch``), so neither ever resolves the other's
entries. A corrupt, unreadable or version-mismatched file loads as empty
(resolvers then take the priors); writes are atomic (tempfile + rename)
and merged over the file's current content under the cache's lock.

Entry shape::

    {"version": 1,
     "entries": {"<knob>|<fingerprint>": {
         "value": <winner>, "seconds": <measured best>,
         "knob": ..., "fingerprint": ..., "t": <time of measurement>}}}
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Any

CACHE_VERSION = 1

#: the path override every consumer reads (drivers put ``--tune-cache``
#: on top; the bench reads only this)
CACHE_ENV = "TPU_MPI_TUNE_CACHE"


def default_cache_path() -> str:
    """``$TPU_MPI_TUNE_CACHE``, else ``~/.cache/tpumt/tune.json``
    (honouring ``XDG_CACHE_HOME``)."""
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    base = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache"
    )
    return os.path.join(base, "tpumt", "tune.json")


def _key(knob: str, fingerprint: str) -> str:
    return f"{knob}|{fingerprint}"


class ScheduleCache:
    """In-memory view of one cache file. ``load`` never raises on bad
    content (a file that exists but does not parse prints a NOTE on
    stderr); ``save`` is atomic and merge-on-write, so a concurrent
    writer of another knob on the same file loses nothing.

    ``read_only`` makes :meth:`save` a no-op: the single-writer rule of a
    run over several ranks (``tune.registry.configure`` marks every rank
    but 0 read-only), since merge-on-write saves of N ranks on one shared
    file would still clobber each other."""

    def __init__(self, path: str):
        self.path = str(path)
        self.entries: dict[str, dict[str, Any]] = {}
        self.read_only = False
        self._lock = threading.Lock()

    @classmethod
    def load(cls, path: str) -> "ScheduleCache":
        cache = cls(path)
        cache.entries = cls._read_entries(path, note=True)
        return cache

    @staticmethod
    def _read_entries(path: str, note: bool = False
                      ) -> dict[str, dict[str, Any]]:
        p = Path(path)
        if not p.exists():
            return {}
        try:
            doc = json.loads(p.read_text())
        except (OSError, json.JSONDecodeError, UnicodeDecodeError) as e:
            if note:
                print(f"NOTE tune cache {path}: unreadable "
                      f"({type(e).__name__}); resolving from the priors",
                      file=sys.stderr, flush=True)
            return {}
        if (
            not isinstance(doc, dict)
            or doc.get("version") != CACHE_VERSION
            or not isinstance(doc.get("entries"), dict)
        ):
            if note:
                print(f"NOTE tune cache {path}: not a version-"
                      f"{CACHE_VERSION} schedule cache; resolving from "
                      f"the priors", file=sys.stderr, flush=True)
            return {}
        return {
            k: v for k, v in doc["entries"].items() if isinstance(v, dict)
        }

    def lookup(self, knob: str, fingerprint: str):
        """The cached winner, or None (None is never a winner: candidates
        are concrete schedules)."""
        entry = self.entries.get(_key(knob, fingerprint))
        return None if entry is None else entry.get("value")

    def store(self, knob: str, fingerprint: str, value,
              seconds: "float | None" = None, **extra) -> None:
        entry = {
            "value": value,
            "seconds": seconds,
            "knob": knob,
            "fingerprint": fingerprint,
            # the time of measurement: what the pack merge's
            # newer-measurement-wins rule arbitrates with
            "t": time.time(),
            **extra,
        }
        with self._lock:
            self.entries[_key(knob, fingerprint)] = entry

    def save(self) -> None:
        """Atomic write, merged over the file's current content. A
        ``read_only`` cache never writes."""
        if self.read_only:
            return
        with self._lock:
            merged = self._read_entries(self.path)
            merged.update(self.entries)
            doc = {"version": CACHE_VERSION, "entries": merged}
            directory = os.path.dirname(self.path) or "."
            os.makedirs(directory, exist_ok=True)
            fd, tmp = tempfile.mkstemp(
                dir=directory, prefix=".tune.", suffix=".tmp"
            )
            try:
                with os.fdopen(fd, "w") as fh:
                    json.dump(doc, fh, indent=1, sort_keys=True)
                    fh.write("\n")
                os.replace(tmp, self.path)
            except OSError:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
            self.entries = merged

    def __len__(self) -> int:
        return len(self.entries)
