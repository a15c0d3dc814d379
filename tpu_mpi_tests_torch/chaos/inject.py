"""Arm-time fault injection over the existing observability hooks (≅
``tpu_mpi_tests/chaos/inject.py``).

Design contract (README "Chaos & diagnosis"):

* **Zero cost when disarmed.** Arming rebinds extension points that
  already exist — the telemetry span hook slot
  (``instrument/telemetry._CHAOS_SPAN_HOOK``), the PhaseTimer hook list
  (:func:`~tpu_mpi_tests_torch.instrument.timers.add_phase_hook`), the
  serve loop's flood slot (``serve/loop._CHAOS_FLOOD``) and, for the
  uniform straggler, :func:`~tpu_mpi_tests_torch.instrument.timers.block`
  and ``block_stream`` themselves. A disarmed run installs nothing.
* **Decisions resolve at arm time, not per call.** ``arm()`` bakes the
  rank, op, phase and threshold choices into closures; the per-event
  hook does a prefix match and a counter bump. Faults whose rank does
  not match this process install nothing.
* **Deterministic.** Every fault fires on the Nth matching event of a
  deterministic trigger stream (span entries, phase boundaries, SLO
  window indices).
* **Audited.** Arming and firing emit ``kind: "chaos"`` records through
  the run's JSONL sink. ``tpumt-doctor`` ignores them: it convicts from
  the organic records alone.

On the card the OOM ballast is tensors on the run's device, so the
caching allocator's counters (``bytes_in_use``) climb; on the CPU it is
host tensors, counted by the memwatch's walk of the live host tensors.
Either way the pressure is read with
:func:`~tpu_mpi_tests_torch.instrument.memwatch._live_totals`.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Callable

from tpu_mpi_tests_torch.chaos.spec import FaultSpec, parse_chaos_spec

#: exit codes shaped like the real failure's: kill ≅ SIGKILL (137), oom ≅
#: SIGABRT from the allocator (134), the wedge's safety cap ≅ the
#: watchdog's own hard-exit code (9)
KILL_EXIT = 137
OOM_EXIT = 134
WEDGE_EXIT = 9

_ARMED: list[FaultSpec] = []
_EMIT: Callable[[dict], None] | None = None
#: the device the oom ballast lives on (None: the world's device)
_DEVICE = None
#: the oom fault's ballast: tensors on the run's device, so the pressure
#: the memwatch reads is real
_BALLAST: list = []
_ORIG_BLOCK = None
_PHASE_HOOK = None


def armed() -> list[FaultSpec]:
    """The faults armed in this process (empty when disarmed)."""
    return list(_ARMED)


def _emit_record(rec: dict) -> None:
    """Best-effort chaos audit record: the JSONL sink when the caller gave
    one, else the telemetry registry's sink. Never raises: a bookkeeping
    failure must not mask (or cause) the injected fault."""
    try:
        if _EMIT is not None:
            _EMIT(rec)
        else:
            from tpu_mpi_tests_torch.instrument import telemetry

            telemetry.emit(rec)
    except Exception:
        pass


def _fire_record(spec: FaultSpec, **extra) -> None:
    _emit_record({
        "kind": "chaos", "event": "fire", "fault": spec.fault,
        "chaos_rank": spec.rank, "spec": spec.raw, "t": time.time(),
        **extra,
    })


def _die(spec: FaultSpec, code: int, why: str) -> None:
    _fire_record(spec, exit_code=code)
    sys.stderr.write(f"CHAOS {spec.fault}: {why} — exiting "
                     f"{code} (injected by {spec.raw!r})\n")
    sys.stderr.flush()
    sys.stdout.flush()
    os._exit(code)


# ---------------------------------------------------------------------------
# per-fault hook builders (called once, at arm time)
# ---------------------------------------------------------------------------


def _span_hook_for(spans: list[FaultSpec]):
    """One dispatcher for every span-triggered fault on this rank.
    ``when`` is "enter" (before the span's clock starts: kill and wedge
    land here, so the span never closes) or "exit" (after the span
    recorded: the op-scoped straggler sleeps here, outside the measured
    window, so the culprit's spans stay fast while its late arrival
    inflates every sibling's next collective)."""
    counts = [0] * len(spans)
    slowed = [False] * len(spans)

    def hook(op: str, when: str) -> None:
        for i, spec in enumerate(spans):
            if spec.op and not op.startswith(spec.op):
                continue
            if spec.fault in ("kill", "wedge"):
                if when != "enter":
                    continue
                counts[i] += 1
                if counts[i] == spec.after:
                    if spec.fault == "kill":
                        _die(spec, KILL_EXIT,
                             f"killed at entry of span {op!r} "
                             f"#{counts[i]}")
                    _wedge(spec, f"span {op!r} #{counts[i]}", op=op)
            elif spec.fault == "straggler":
                if when != "exit":
                    continue
                counts[i] += 1
                if counts[i] >= spec.after:
                    if not slowed[i]:
                        slowed[i] = True
                        _fire_record(spec, op=op)
                    time.sleep(spec.delay_ms / 1e3)

    return hook


def _wedge(spec: FaultSpec, where: str, op: str | None = None) -> None:
    """A wedged dispatch: the op registers itself in the flight recorder
    (``note_dispatch``, mirrored to the JSONL as ``kind: "dispatch"``
    with telemetry on) and never completes. The hang watchdog
    (``--deadline``) is what ends the process; ``stall_s`` is only a
    safety cap for a run armed without one."""
    from tpu_mpi_tests_torch.instrument import telemetry

    telemetry.note_dispatch(
        f"chaos:wedge {where}", op=op or f"chaos:{spec.phase or '?'}"
    )
    _fire_record(spec, where=where)
    sys.stderr.write(f"CHAOS wedge: stalling at {where} (injected by "
                     f"{spec.raw!r}; the watchdog should fire)\n")
    sys.stderr.flush()
    deadline = time.monotonic() + spec.stall_s
    while time.monotonic() < deadline:
        time.sleep(0.1)
    _die(spec, WEDGE_EXIT,
         f"stall cap {spec.stall_s:g}s reached with no watchdog")


def _phase_hook_for(phased: list[FaultSpec]):
    """Dispatcher for phase-triggered faults (kill and wedge on phase
    entry; the oom ballast at every boundary). Runs inside
    ``timers._fire_phase_hooks``, outside the measured window."""
    counts = [0] * len(phased)

    def hook(name: str, event: str) -> None:
        for i, spec in enumerate(phased):
            if spec.phase and name != spec.phase:
                continue
            if event != "begin":
                continue  # one trigger a boundary, every class
            counts[i] += 1
            if spec.fault in ("kill", "wedge"):
                if counts[i] == spec.after:
                    if spec.fault == "kill":
                        _die(spec, KILL_EXIT,
                             f"killed at entry of phase {name!r} "
                             f"#{counts[i]}")
                    _wedge(spec, f"phase {name!r} #{counts[i]}")
            elif spec.fault == "oom" and counts[i] >= spec.after:
                _grow_ballast(spec, name)

    return hook


def _ballast_device():
    if _DEVICE is not None:
        return _DEVICE
    from tpu_mpi_tests_torch.comm import dist

    return dist.world().device


def _grow_ballast(spec: FaultSpec, phase: str) -> None:
    """One OOM-ramp step: allocate ``step_mb`` of live tensors on the
    run's device (the allocator's counters climb on the card, the host
    walk counts them on the CPU), then die once the live pressure crosses
    ``frac`` of the limit: the card's reported limit where the spec left
    ``limit_mb`` at its default, else ``limit_mb``."""
    import torch

    from tpu_mpi_tests_torch.instrument import memwatch

    device = _ballast_device()
    _BALLAST.append(torch.ones(spec.step_mb * (1 << 20) // 4,
                               dtype=torch.float32, device=device))
    limit = spec.limit_mb * (1 << 20)
    if "limit_mb" not in spec.explicit:
        # only the default defers to the card's limit: an explicit
        # limit_mb is a promise about how far the ramp goes
        hw = [s["bytes_limit"]
              for s in memwatch.device_memory_stats(device).values()
              if "bytes_limit" in s]
        if hw:
            limit = max(hw)
    totals = memwatch._live_totals(device)
    live = totals[1] if totals is not None else 0
    if live >= spec.frac * limit:
        _die(spec, OOM_EXIT,
             f"live bytes {live} crossed {spec.frac:g} of limit "
             f"{limit} during phase {phase!r}")


def _flood_hook_for(spec: FaultSpec):
    """Serve-loop flood: a one-shot burst at the ``after``-th SLO window
    boundary (the window index is the trigger stream, deterministic under
    wall and fake clocks alike)."""
    fired = [False]

    def hook(window_index: int) -> int:
        if fired[0] or window_index != spec.after:
            return 0
        fired[0] = True
        _fire_record(spec, window_index=window_index)
        return spec.burst

    return hook


def _wrap_block(spec: FaultSpec) -> None:
    """Uniform straggler: wrap ``timers.block`` and
    ``timers.block_stream``, the sync points every measured phase and
    span passes through (``comm_span`` and the specs look them up at call
    time), so the delay lands inside the measured windows and the rank
    reads as a uniformly slow device. One count over both. Restored by
    :func:`disarm`."""
    global _ORIG_BLOCK
    from tpu_mpi_tests_torch.instrument import timers

    if _ORIG_BLOCK is not None:
        return  # already wrapped (one uniform straggler is enough)
    _ORIG_BLOCK = (timers.block, timers.block_stream)
    count = [0]
    slowed = [False]

    def slowed_down(orig):
        def slow(*trees):
            count[0] += 1
            if count[0] >= spec.after:
                if not slowed[0]:
                    slowed[0] = True
                    _fire_record(spec)
                time.sleep(spec.delay_ms / 1e3)
            return orig(*trees)

        return slow

    timers.block = slowed_down(_ORIG_BLOCK[0])
    timers.block_stream = slowed_down(_ORIG_BLOCK[1])


# ---------------------------------------------------------------------------
# arm / disarm
# ---------------------------------------------------------------------------


def arm(specs: list[FaultSpec], rank: int,
        emit: Callable[[dict], None] | None = None,
        device=None) -> list[FaultSpec]:
    """Install the faults of ``specs`` that target ``rank``; the oom
    ballast goes on ``device`` (default: the world's device). Returns the
    installed subset (empty when nothing targets this rank: the process
    then runs with no chaos state). Re-arming disarms first."""
    global _EMIT, _PHASE_HOOK, _DEVICE
    disarm()
    mine = [s for s in specs if s.rank == rank]
    if not mine:
        return []
    _EMIT = emit
    _DEVICE = device
    _ARMED.extend(mine)

    span_faults = [s for s in mine
                   if s.op and s.fault in ("kill", "wedge", "straggler")]
    if span_faults:
        from tpu_mpi_tests_torch.instrument import telemetry

        telemetry._CHAOS_SPAN_HOOK = _span_hook_for(span_faults)

    phase_faults = [s for s in mine
                    if (s.fault in ("kill", "wedge") and s.phase)
                    or s.fault == "oom"]
    if phase_faults:
        from tpu_mpi_tests_torch.instrument import timers

        _PHASE_HOOK = _phase_hook_for(phase_faults)
        timers.add_phase_hook(_PHASE_HOOK)

    for s in mine:
        if s.fault == "straggler" and not s.op:
            _wrap_block(s)
        elif s.fault == "flood":
            from tpu_mpi_tests_torch.serve import loop as serve_loop

            serve_loop._CHAOS_FLOOD = _flood_hook_for(s)

    for s in mine:
        _emit_record({
            "kind": "chaos", "event": "armed", "fault": s.fault,
            "chaos_rank": s.rank, "spec": s.raw, "t": time.time(),
        })
    return mine


def arm_from_spec(text: str, rank: int,
                  emit: Callable[[dict], None] | None = None,
                  device=None) -> list[FaultSpec]:
    """Parse and arm in one step (the driver's entry point). Raises
    :class:`ValueError` on a malformed spec."""
    return arm(parse_chaos_spec(text), rank, emit=emit, device=device)


def disarm() -> None:
    """Uninstall every hook and drop the ballast: the process is back to
    the disarmed configuration."""
    global _EMIT, _ORIG_BLOCK, _PHASE_HOOK, _DEVICE
    _ARMED.clear()
    _BALLAST.clear()
    _EMIT = None
    _DEVICE = None
    from tpu_mpi_tests_torch.instrument import telemetry, timers
    from tpu_mpi_tests_torch.serve import loop as serve_loop

    telemetry._CHAOS_SPAN_HOOK = None
    if _PHASE_HOOK is not None:
        timers.remove_phase_hook(_PHASE_HOOK)
        _PHASE_HOOK = None
    if _ORIG_BLOCK is not None:
        timers.block, timers.block_stream = _ORIG_BLOCK
        _ORIG_BLOCK = None
    serve_loop._CHAOS_FLOOD = None
