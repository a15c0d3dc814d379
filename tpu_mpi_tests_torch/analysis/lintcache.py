"""Content-hash-keyed analysis cache of the port's linter (≅
``tpu_mpi_tests/analysis/lintcache.py``).

One JSON file (default ``~/.cache/tpumt/lint_torch.json``, overridable
via ``$TPU_MPI_LINT_CACHE`` / ``--cache``; ``--no-cache`` disables)
mapping each linted path to its last analysis: the sha256 of the file's
bytes, the file-scope findings it raised, its serialized whole-program
facts (:mod:`tpu_mpi_tests_torch.analysis.program`), and its
suppression comments. A warm run replays all four for unchanged files.

Two invalidation axes, both automatic:

* **content**: the key is the file's hash;
* **engine**: the cache carries a *salt* hashed over the analysis
  package's own sources and the engine's name, so editing a rule or the
  extractor discards every entry at once, and the JAX package's linter,
  whose salt hashes other sources under another name, never reads this
  linter's entries through a shared ``$TPU_MPI_LINT_CACHE`` (nor the
  other way round): a salt mismatch reads as a cold cache.

Corrupted/stale/unwritable cache files degrade to empty: the linter never
fails because its cache did. Stdlib-only, like the rest of the analysis
package.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from pathlib import Path

#: the facts schema's version: a cache written under another shape reads
#: as cold, never as "no schedule"
CACHE_VERSION = 3

#: the engine the salt names (the JAX package's linter hashes other
#: sources and no name, so its salt never equals this one)
ENGINE = "tpu_mpi_tests_torch.analysis"


def default_cache_path() -> str:
    env = os.environ.get("TPU_MPI_LINT_CACHE")
    if env:
        return env
    return str(Path.home() / ".cache" / "tpumt" / "lint_torch.json")


def engine_salt() -> str:
    """Hash of the engine's name and the analysis package's own sources
    (fixtures excluded): any rule/extractor edit auto-invalidates every
    cached verdict, and the two linters' entries never mix."""
    h = hashlib.sha256(ENGINE.encode())
    pkg = Path(__file__).resolve().parent
    for f in sorted(pkg.rglob("*.py")):
        if "fixtures" in f.parts or "__pycache__" in f.parts:
            continue
        h.update(str(f.relative_to(pkg)).encode())
        try:
            h.update(f.read_bytes())
        except OSError:
            pass
    return h.hexdigest()


class LintCache:
    """path → {hash, findings, facts, supps, malformed} with atomic
    merge-on-write saves. Keys are RESOLVED ABSOLUTE paths: relative
    keys would alias across working directories in a shared cache
    (the default lives under ``~/.cache``), and the stale-path eviction
    below could not tell "deleted" from "relative to somewhere else"."""

    @staticmethod
    def _key(path: str) -> str:
        try:
            return str(Path(path).resolve())
        except OSError:
            return str(path)

    def __init__(self, path: str):
        self.path = Path(path)
        self.salt = engine_salt()
        self._entries: dict[str, dict] = {}
        self._dirty = False
        self._entries = self._read(self.path)

    def _read(self, path: Path) -> dict[str, dict]:
        try:
            doc = json.loads(path.read_text())
        except (OSError, ValueError):
            return {}
        if not isinstance(doc, dict):
            return {}
        if doc.get("version") != CACHE_VERSION or doc.get(
            "salt"
        ) != self.salt:
            return {}  # engine changed (or foreign format): cold start
        entries = doc.get("entries")
        return entries if isinstance(entries, dict) else {}

    def get(self, path: str, digest: str) -> dict | None:
        entry = self._entries.get(self._key(path))
        if not isinstance(entry, dict) or entry.get("hash") != digest:
            return None
        # shape/type validation happens at replay
        # (core.replay_cache_entry) — a hand-edited or type-corrupted
        # entry degrades to a miss there, never crashes the run
        return entry

    def put(self, path: str, digest: str, entry: dict) -> None:
        self._entries[self._key(path)] = {"hash": digest, **entry}
        self._dirty = True

    def save(self) -> None:
        # evict entries for deleted/renamed files: without this, stale
        # paths accumulate until the next engine-salt reset
        stale = [p for p in self._entries if not Path(p).exists()]
        for p in stale:
            del self._entries[p]
            self._dirty = True
        if not self._dirty:
            return
        tmp = None
        try:
            # merge-on-write: concurrent linters over disjoint path sets
            # keep each other's entries (last writer wins per path);
            # the eviction filter applies to the on-disk side too
            merged = {
                p: e for p, e in self._read(self.path).items()
                if Path(p).exists()
            }
            merged.update(self._entries)
            self.path.parent.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(
                dir=str(self.path.parent), suffix=".tmp"
            )
            with os.fdopen(fd, "w") as fh:
                json.dump({"version": CACHE_VERSION, "salt": self.salt,
                           "entries": merged}, fh)
            os.replace(tmp, self.path)
            tmp = None
        except OSError:
            pass  # an unwritable cache never fails the lint
        finally:
            if tmp is not None:
                try:  # failed write/replace: don't orphan the temp file
                    os.unlink(tmp)
                except OSError:
                    pass
