"""Tunable-space declarations and the process-wide resolution state (≅
``tpu_mpi_tests/tune/registry.py``).

Spaces are declared where the knob lives (``comm/halo.py`` declares the
halo staging, resident-block, k-step, tier and overlap-depth spaces,
``comm/collectives.py`` the dispatch depth, ``comm/ring.py`` the ring's
depth, tier and flash tiles, ``drivers/collbench.py`` the collective
variants, ``workloads/daxpy.py`` the chunk) by
:func:`declare_space` at import time; the candidate values come from
:mod:`~tpu_mpi_tests_torch.tune.priors`. The first candidate is the
PRIOR: what a sweep measures first, and what resolution returns when the
cache has no entry.

Resolution precedence at every site::

    explicit argument  >  cached winner  >  shipped prior

The cache is read only after :func:`configure` loaded one (drivers do so
from ``--tune`` / ``--tune-cache`` / ``--tune-pack`` or an existing
default cache file, the bench from ``TPU_MPI_BENCH_TUNE`` or an existing
file); bare library use reads no file and sees the priors.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Callable, Iterable

from tpu_mpi_tests_torch.tune.cache import ScheduleCache, default_cache_path


@dataclass(frozen=True)
class TunableSpace:
    """One declared knob: its candidate schedules (prior FIRST) and a
    one-line rationale. Candidates are JSON-serialisable (ints, strings
    or flat dicts of those): they round-trip through the cache file."""

    knob: str
    candidates: tuple
    describe: str = ""

    @property
    def prior(self):
        """Cold-start winner: the shipped measured best."""
        return self.candidates[0]


_SPACES: dict[str, TunableSpace] = {}
_SPACES_LOCK = threading.Lock()


def declare_space(knob: str, candidates: Iterable,
                  describe: str = "") -> TunableSpace:
    """Register a tunable space (idempotent: redeclaring a knob returns
    the existing space)."""
    with _SPACES_LOCK:
        existing = _SPACES.get(knob)
        if existing is not None:
            return existing
        sp = TunableSpace(knob, tuple(candidates), describe)
        if not sp.candidates:
            raise ValueError(f"tunable space {knob!r} has no candidates")
        _SPACES[knob] = sp
        return sp


def space(knob: str) -> TunableSpace:
    # the knob owners declare at import; asking for a space must not
    # depend on whether the caller imported the owner first
    _import_knob_owners()
    return _SPACES[knob]


def spaces() -> dict[str, TunableSpace]:
    _import_knob_owners()
    return dict(_SPACES)


def _import_knob_owners() -> None:
    """Import every module that declares spaces (lazily: the owners
    import this module): the halo and stencil knobs, the ring's depth
    and tier, the collective variants and the daxpy chunk. The MoE and
    embedding spaces come with their modules, and the collective
    dispatch depth with its reader, the serve halo handler (ROADMAP
    queue 1)."""
    import tpu_mpi_tests_torch.comm.halo  # noqa: F401
    import tpu_mpi_tests_torch.comm.ring  # noqa: F401
    import tpu_mpi_tests_torch.drivers.collbench  # noqa: F401
    import tpu_mpi_tests_torch.workloads.daxpy  # noqa: F401


class _State:
    def __init__(self):
        self.cache: ScheduleCache | None = None
        self.enabled = False
        self.budget_s: float | None = None
        self.emit: Callable[[dict], None] | None = None


_STATE = _State()
_STATE_LOCK = threading.Lock()


def configure(cache_path: "str | None" = None, enabled: bool = False,
              budget_s: "float | None" = None,
              emit: "Callable[[dict], None] | None" = None
              ) -> ScheduleCache:
    """Load the schedule cache and set the process-wide switches.

    ``cache_path=None`` takes ``TPU_MPI_TUNE_CACHE``, then the default
    path; a missing or corrupt file loads as empty. ``enabled`` arms
    sweeps on a miss (:func:`~tpu_mpi_tests_torch.tune.sweep.ensure_tuned`);
    lookups work regardless. ``emit`` is the default sink of sweep
    records. Every rank but 0 of a run over several processes gets a
    read-only cache: the winner every rank applies arrives by broadcast,
    and rank 0 alone writes the file."""
    with _STATE_LOCK:
        _STATE.cache = ScheduleCache.load(cache_path or default_cache_path())
        _STATE.cache.read_only = _nonzero_rank()
        _STATE.enabled = bool(enabled)
        _STATE.budget_s = budget_s
        _STATE.emit = emit
        return _STATE.cache


def _nonzero_rank() -> bool:
    """True on the ranks of a run over several processes that must not
    write the cache: every rank but 0 of the process group."""
    from tpu_mpi_tests_torch.tune import fleet

    return fleet.process_count() > 1 and fleet.process_index() != 0


def mark_fleet_rank() -> None:
    """Re-apply the single-writer marking once the rank is known (a
    cache configured before the process group existed)."""
    with _STATE_LOCK:
        if _STATE.cache is not None and _nonzero_rank():
            _STATE.cache.read_only = True


def deconfigure() -> None:
    """Back to the unconfigured state (tests, and runs that configure
    more than once)."""
    with _STATE_LOCK:
        _STATE.cache = None
        _STATE.enabled = False
        _STATE.budget_s = None
        _STATE.emit = None


def configured_cache() -> "ScheduleCache | None":
    return _STATE.cache


def tuning_enabled() -> bool:
    return _STATE.enabled


def tune_budget_s() -> "float | None":
    return _STATE.budget_s


def default_emit() -> "Callable[[dict], None] | None":
    return _STATE.emit


def set_emit(emit: "Callable[[dict], None] | None") -> None:
    """Install the default sweep-record sink after configuration (a
    driver's reporter exists later than its cache)."""
    with _STATE_LOCK:
        _STATE.emit = emit


def lookup(knob: str, device_fallback: bool = True, **ctx) -> Any | None:
    """The cached winner of ``knob`` in the caller's context, or None:
    the full fingerprint first, then (``device_fallback``) the
    device-only one. Context-sensitive sites pass
    ``device_fallback=False`` so that another context's winner never
    leaks in."""
    cache = _STATE.cache
    if cache is None or not len(cache):
        return None
    from tpu_mpi_tests_torch.tune.fingerprint import (
        device_fingerprint,
        fingerprint,
    )

    val = cache.lookup(knob, fingerprint(**ctx))
    if val is None and ctx and device_fallback:
        val = cache.lookup(knob, device_fingerprint())
    return val


def resolve(knob: str, explicit=None, prior=None,
            device_fallback: bool = True, **ctx):
    """``explicit`` when given, else the cached winner, else ``prior``
    (default: the declared space's first candidate)."""
    if explicit is not None:
        return explicit
    cached = lookup(knob, device_fallback=device_fallback, **ctx)
    if cached is not None:
        return cached
    if prior is not None:
        return prior
    return space(knob).prior


def preload() -> dict[str, Any]:
    """Import every knob owner, touch the cache, and return the
    device-level resolution of every declared space (a server's start:
    no first request pays the import, the read or the fingerprint)."""
    _import_knob_owners()
    return {knob: resolve(knob) for knob in sorted(_SPACES)}
