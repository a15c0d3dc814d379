"""The measured sweep (≅ ``tpu_mpi_tests/tune/sweep.py``): price candidate
schedules on the device, persist the winner, report every measurement.

The caller's ``measure(candidate) -> seconds`` times the candidate; on
the card it ends on CUDA events, not the host clock
(:func:`feedback_rate` and ``instrument.timers.chain_rate``). Each
candidate's window is a trace range ``tune:<knob>``.

Budget (``--tune-budget``): a wall-clock cap over the candidate list.
The prior (the first candidate) is always measured; later candidates are
dropped once the budget is spent, and every drop is a ``skipped``
record. A candidate that raises (a tier the topology cannot run, a
geometry no block fits) is a declined record with its error, scores NaN
and never wins; it is never fatal.

JSONL records, the JAX package's kinds and fields:

* ``{"kind": "tune", knob, candidate, seconds|skipped|error,
  fingerprint}`` — one per candidate;
* ``{"kind": "tune_result", knob, value, seconds, measured, skipped,
  fingerprint}`` — the winner;
* ``{"kind": "tune_hit", knob, value, fingerprint}`` — a resolution
  served from the cache with no sweep.

Several processes (:func:`_fleet_sweep`): every rank measures every
candidate (a candidate's exchanges need every rank), but only rank 0's
clock decides. The per-candidate go/stop and the winner are broadcast
from rank 0 (``tune.fleet.bcast``) before any rank acts on them, so the
executed candidates and the applied schedule are the same on every rank
by construction; rank 0 alone emits the ``tune`` records and writes the
cache, and every rank emits the broadcast ``tune_result``.
"""

from __future__ import annotations

import time
from typing import Callable, Iterable

from tpu_mpi_tests_torch.tune import registry
from tpu_mpi_tests_torch.tune.fingerprint import (
    device_fingerprint,
    fingerprint,
)


def feedback_rate(fn, state, n_short: int = 4, n_long: int = 12):
    """Seconds per call of a single-step function whose output is fed
    back as its next input (``state = fn(state)``), by differencing two
    run lengths after a warm run: ``instrument.timers.chain_rate`` over
    the loop, so on the card the runs are replays of CUDA graphs between
    CUDA events. Returns ``(seconds_per_call, final_state)``; NaN on a
    non-positive delta."""
    from tpu_mpi_tests_torch.instrument.timers import chain_rate

    def run(state, n):
        for _ in range(n):
            state = fn(state)
        return state

    return chain_rate(run, state, n_short=n_short, n_long=n_long)


def _process_count() -> int:
    from tpu_mpi_tests_torch.tune import fleet

    return fleet.process_count()


def _measure_one(knob, measure, cand):
    """``(seconds, error)`` of one candidate: NaN and the error's text
    when it raises. The window is a trace range and a ``tune:<knob>``
    telemetry span (≅ JAX ``:149,246``)."""
    from tpu_mpi_tests_torch.instrument.telemetry import comm_span
    from tpu_mpi_tests_torch.instrument.trace import trace_range

    with trace_range(f"tune:{knob}"), comm_span(f"tune:{knob}",
                                                candidate=cand):
        try:
            return float(measure(cand)), None
        except Exception as e:  # an infeasible candidate, not a dead sweep
            return float("nan"), f"{type(e).__name__}: {e}"


def _tune_record(knob, cand, sec, err, fp) -> dict:
    rec = {"kind": "tune", "knob": knob, "candidate": cand,
           "seconds": None if sec != sec else sec, "fingerprint": fp}
    if err is not None:
        rec["error"] = err
    return rec


def _persist(knob, fp, value, seconds, ctx) -> None:
    cache = registry.configured_cache()
    if cache is None:
        return
    cache.store(knob, fp, value, seconds=seconds)
    if ctx:
        cache.store(knob, device_fingerprint(), value, seconds=seconds)
    cache.save()


def sweep(knob: str, measure: Callable[[object], float], *,
          candidates: "Iterable | None" = None,
          budget_s: "float | None" = None,
          emit: "Callable[[dict], None] | None" = None,
          persist: bool = True, **ctx):
    """Measure every candidate within budget, persist and return the
    winner (under the full fingerprint and the device-only one).
    ``measure(candidate) -> seconds`` (NaN = invalid)."""
    if candidates is None:
        candidates = registry.space(knob).candidates
    candidates = list(candidates)
    if budget_s is None:
        budget_s = registry.tune_budget_s()
    emit = emit or registry.default_emit() or (lambda rec: None)
    fp = fingerprint(**ctx)

    if _process_count() > 1:
        return _fleet_sweep(knob, measure, candidates, budget_s, emit,
                            persist, ctx, fp)

    t_begin = time.perf_counter()
    best, best_sec = None, float("inf")
    measured = skipped = 0
    for i, cand in enumerate(candidates):
        if (i and budget_s is not None
                and time.perf_counter() - t_begin >= budget_s):
            # budget spent: report the drop, never truncate silently
            skipped = len(candidates) - i
            for c in candidates[i:]:
                emit({"kind": "tune", "knob": knob, "candidate": c,
                      "skipped": "budget", "fingerprint": fp})
            break
        sec, err = _measure_one(knob, measure, cand)
        emit(_tune_record(knob, cand, sec, err, fp))
        if sec == sec:  # finite/valid
            measured += 1
            if sec < best_sec:
                best, best_sec = cand, sec

    if best is None:
        # nothing measured validly: the prior stays, nothing persists (a
        # later run retries)
        emit({"kind": "tune_result", "knob": knob, "value": candidates[0],
              "seconds": None, "measured": 0, "skipped": skipped,
              "fingerprint": fp, "note": "no valid measurement"})
        return candidates[0]

    if persist:
        _persist(knob, fp, best, best_sec, ctx)
    emit({"kind": "tune_result", "knob": knob, "value": best,
          "seconds": best_sec, "measured": measured, "skipped": skipped,
          "fingerprint": fp})
    return best


def _fleet_sweep(knob, measure, candidates, budget_s, emit, persist,
                 ctx, fp):
    """The rank-0-swept, broadcast-applied sweep of several processes
    (see the module docstring)."""
    from tpu_mpi_tests_torch.tune import fleet

    try:
        # the opening handshake is the transport probe: without one,
        # every rank takes the cached > prior path alike
        fleet.bcast({"knob": knob, "n": len(candidates)}, f"{knob}:open")
    except fleet.FleetUnavailable as e:
        fallback = registry.lookup(knob, **ctx)
        if fallback is None:
            fallback = candidates[0]
        emit({"kind": "tune_result", "knob": knob, "value": fallback,
              "seconds": None, "measured": 0,
              "skipped": len(candidates), "fingerprint": fp,
              "note": f"sweep skipped: multi-process run with no fleet "
                      f"broadcast transport ({e}); warm the cache "
                      f"single-process or ship a --tune-pack"})
        return fallback

    rank = fleet.process_index()
    t_begin = time.perf_counter()
    best, best_sec = None, float("inf")
    measured = skipped = 0
    for i, cand in enumerate(candidates):
        # rank 0's clock is the only budget authority
        if rank == 0:
            go = bool(i == 0 or budget_s is None
                      or time.perf_counter() - t_begin < budget_s)
        else:
            go = None
        go = fleet.bcast(go, f"{knob}:go{i}")
        if not go:
            skipped = len(candidates) - i
            if rank == 0:
                for c in candidates[i:]:
                    emit({"kind": "tune", "knob": knob, "candidate": c,
                          "skipped": "budget", "fingerprint": fp})
            break
        sec, err = _measure_one(knob, measure, cand)
        if rank == 0:
            emit(_tune_record(knob, cand, sec, err, fp))
            if sec == sec:
                measured += 1
                if sec < best_sec:
                    best, best_sec = cand, sec

    # rank 0 builds the whole winner record and broadcasts it; every rank
    # emits the broadcast copy and applies its value
    if rank == 0:
        if best is None:
            result = {"kind": "tune_result", "knob": knob,
                      "value": candidates[0], "seconds": None,
                      "measured": 0, "skipped": skipped,
                      "fingerprint": fp, "note": "no valid measurement"}
        else:
            result = {"kind": "tune_result", "knob": knob, "value": best,
                      "seconds": best_sec, "measured": measured,
                      "skipped": skipped, "fingerprint": fp}
    else:
        result = None
    result = fleet.bcast(result, f"{knob}:result")
    emit(result)

    if rank == 0 and persist and result.get("note") is None:
        # the one cache writer (the cache is read-only on the others too)
        _persist(knob, fp, result["value"], result["seconds"], ctx)
    return result["value"]


def ensure_tuned(knob: str, measure: Callable[[object], float], *,
                 explicit=None, prior=None,
                 candidates: "Iterable | None" = None,
                 budget_s: "float | None" = None,
                 emit: "Callable[[dict], None] | None" = None,
                 device_fallback: bool = True, **ctx):
    """The driver-side entry point: explicit > cached (a ``tune_hit``
    record) > a sweep on a miss when ``--tune`` armed the registry >
    prior. Returns the schedule to run.

    Over several processes the hit-or-sweep decision is rank 0's cache's,
    broadcast: per-rank caches can differ (rank 0 is the one writer),
    and ranks that took different paths would hang in the sweep's
    exchanges."""
    if explicit is not None:
        return explicit
    cached = registry.lookup(knob, device_fallback=device_fallback, **ctx)
    if _process_count() > 1:
        from tpu_mpi_tests_torch.tune import fleet

        try:
            if fleet.process_index() == 0:
                decision = {"hit": cached is not None, "value": cached}
            else:
                decision = None
            decision = fleet.bcast(decision, f"{knob}:resolve")
            cached = decision["value"] if decision["hit"] else None
        except fleet.FleetUnavailable:
            pass  # no transport: local resolution
    if cached is not None:
        (emit or registry.default_emit() or (lambda rec: None))(
            {"kind": "tune_hit", "knob": knob, "value": cached,
             "fingerprint": fingerprint(**ctx)}
        )
        return cached
    if not registry.tuning_enabled():
        if prior is not None:
            return prior
        return registry.space(knob).prior
    return sweep(knob, measure, candidates=candidates, budget_s=budget_s,
                 emit=emit, **ctx)
