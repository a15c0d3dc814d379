"""Fault-spec grammar of the chaos layer (stdlib-only; a copy of
``tpu_mpi_tests/chaos/spec.py``: the same classes, keys, defaults,
``describe()`` text and error messages).

A chaos spec is a comma list of faults, each ``class[:key=value]*``::

    kill:rank=1:op=halo_exchange:after=3
    straggler:rank=1:delay_ms=40
    wedge:op=halo_exchange:after=2
    oom:step_mb=16:limit_mb=64:frac=0.8
    flood:burst=300:after=1

Classes and their trigger points (``chaos/inject.py`` arms them; README
"Chaos & diagnosis" documents the conviction signals):

* ``kill`` — the target rank hard-exits at the ``after``-th matching
  trigger: entry of a telemetry span (``op=`` prefix match, so the span
  never closes — dead mid-collective from every sibling's point of
  view) or entry of a PhaseTimer phase (``phase=``).
* ``straggler`` — the target rank is artificially slowed. With ``op=``
  the delay lands at span *exit* (after the measured window closes), so
  the rank arrives late at the NEXT collective — the siblings' spans
  inflate while the culprit's stay fast. Without ``op=`` the delay wraps
  :func:`tpu_mpi_tests_torch.instrument.timers.block` — the sync point
  every measured phase passes through — so every phase on the rank
  uniformly slows (a slow device or host).
* ``wedge`` — at the matching trigger the rank records a dispatch note
  (:func:`~tpu_mpi_tests_torch.instrument.telemetry.note_dispatch`) and
  then never completes: the op is "in flight" forever, which is what the
  hang watchdog exists to catch (run with ``--deadline``).
* ``oom`` — ballast tensors on the run's device grow ``step_mb`` at every
  PhaseTimer phase boundary (optionally scoped by ``phase=``) until the
  live pressure crosses ``frac`` of the limit, then the rank dies the
  way an OOM-killed allocator does. An explicit ``limit_mb`` always
  wins; only the default defers to the card's reported limit (the
  default 256 MB on the CPU, which reports none).
* ``flood`` — the serve loop receives a burst of ``burst`` synthetic
  arrivals at the ``after``-th SLO window boundary, driving shed and
  queue depth through the bound.

Every field is parsed once here; ``arm()`` bakes the decisions into
closures, so nothing re-reads env vars or re-parses specs per call.
"""

from __future__ import annotations

from dataclasses import dataclass, field

#: the fault classes the layer injects (and the diagnosis classes
#: ``tpumt-doctor`` convicts them as — see FINDING_FOR)
FAULT_CLASSES = ("kill", "straggler", "wedge", "oom", "flood")

#: injection class -> the ``tpumt-doctor`` finding class that convicts
#: it (the chaos-smoke contract: inject X, doctor must name
#: FINDING_FOR[X] with the injected rank)
FINDING_FOR = {
    "kill": "missing_rank",
    "straggler": "straggler",
    "wedge": "wedge",
    "oom": "oom",
    "flood": "shed_storm",
}

_INT_KEYS = ("rank", "after", "step_mb", "limit_mb", "burst", "seed")
_FLOAT_KEYS = ("delay_ms", "frac", "stall_s")
_STR_KEYS = ("op", "phase")

#: the keys each fault class actually consumes (inject.py's arm-time
#: routing). A key outside this set is rejected up front: accepting
#: ``straggler:phase=X`` while arming a uniform straggler would inject
#: something other than what the spec claims — the same silent-no-op
#: failure mode the grammar exists to prevent.
_CLASS_KEYS = {
    "kill": frozenset({"rank", "op", "phase", "after", "seed"}),
    "wedge": frozenset({"rank", "op", "phase", "after", "stall_s",
                        "seed"}),
    "straggler": frozenset({"rank", "op", "after", "delay_ms", "seed"}),
    "oom": frozenset({"rank", "phase", "after", "step_mb", "limit_mb",
                      "frac", "seed"}),
    "flood": frozenset({"rank", "after", "burst", "seed"}),
}


@dataclass
class FaultSpec:
    """One parsed fault. Defaults are deliberately mild enough for CI
    fake-device runs and documented in the grammar above."""

    fault: str
    rank: int = 0
    op: str | None = None          # span-op prefix trigger
    phase: str | None = None       # PhaseTimer phase-name trigger
    after: int = 1                 # fire on the Nth matching trigger
    delay_ms: float = 200.0        # straggler: delay per event
    step_mb: int = 16              # oom: ballast per phase boundary
    limit_mb: int = 256            # oom: limit when the backend has none
    frac: float = 0.8              # oom: die at frac * limit
    burst: int = 200               # flood: synthetic arrivals injected
    stall_s: float = 120.0         # wedge: safety cap if no watchdog
    seed: int = 0                  # reserved for randomized faults
    raw: str = field(default="", compare=False)
    #: keys the user gave explicitly — a default and an explicit value
    #: must be distinguishable where behavior branches on it (an
    #: explicit oom limit_mb overrides the device-reported limit)
    explicit: frozenset = field(default_factory=frozenset,
                                compare=False)

    def describe(self) -> str:
        parts = [self.fault, f"rank={self.rank}"]
        if self.op:
            parts.append(f"op={self.op}")
        if self.phase:
            parts.append(f"phase={self.phase}")
        parts.append(f"after={self.after}")
        if self.fault == "straggler":
            parts.append(f"delay_ms={self.delay_ms:g}")
        if self.fault == "oom":
            parts.append(f"step_mb={self.step_mb}")
            parts.append(f"limit_mb={self.limit_mb}")
            parts.append(f"frac={self.frac:g}")
        if self.fault == "flood":
            parts.append(f"burst={self.burst}")
        return ":".join(parts)


def parse_chaos_spec(text: str) -> list[FaultSpec]:
    """Parse a ``--chaos`` / ``TPU_MPI_CHAOS`` value. Raises
    :class:`ValueError` with the offending token and the grammar — a
    malformed fault spec must fail the run up front, not silently
    inject nothing."""
    specs: list[FaultSpec] = []
    for token in text.split(","):
        token = token.strip()
        if not token:
            continue
        parts = token.split(":")
        fault = parts[0].strip()
        if fault not in FAULT_CLASSES:
            raise ValueError(
                f"unknown fault class {fault!r} in {token!r}; expected "
                f"one of {','.join(FAULT_CLASSES)} "
                f"(grammar: class[:key=value]*)"
            )
        spec = FaultSpec(fault=fault, raw=token)
        seen: set[str] = set()
        for kv in parts[1:]:
            if "=" not in kv:
                raise ValueError(
                    f"malformed field {kv!r} in {token!r}; expected "
                    f"key=value"
                )
            key, val = (s.strip() for s in kv.split("=", 1))
            if key in (_INT_KEYS + _FLOAT_KEYS + _STR_KEYS) \
                    and key not in _CLASS_KEYS[fault]:
                raise ValueError(
                    f"{key!r} does not apply to {fault!r} in {token!r}; "
                    f"{fault} takes {','.join(sorted(_CLASS_KEYS[fault]))}"
                )
            if key in seen:
                raise ValueError(
                    f"duplicate key {key!r} in {token!r}: last-wins "
                    f"would arm something other than what the spec "
                    f"appears to say"
                )
            seen.add(key)
            try:
                if key in _INT_KEYS:
                    setattr(spec, key, int(val))
                elif key in _FLOAT_KEYS:
                    setattr(spec, key, float(val))
                elif key in _STR_KEYS:
                    setattr(spec, key, val)
                else:
                    raise ValueError(
                        f"unknown field {key!r} in {token!r}; valid: "
                        f"{','.join(_INT_KEYS + _FLOAT_KEYS + _STR_KEYS)}"
                    )
            except ValueError as e:
                if "unknown field" in str(e):
                    raise
                raise ValueError(
                    f"bad value {val!r} for {key!r} in {token!r}"
                ) from None
        spec.explicit = frozenset(seen)
        _validate(spec)
        specs.append(spec)
    if not specs:
        raise ValueError("empty chaos spec")
    return specs


def _validate(spec: FaultSpec) -> None:
    if spec.after < 1:
        raise ValueError(f"after must be >= 1 in {spec.raw!r}")
    if spec.rank < 0:
        raise ValueError(f"rank must be >= 0 in {spec.raw!r}")
    if spec.fault in ("kill", "wedge") and not (spec.op or spec.phase):
        raise ValueError(
            f"{spec.fault} needs an op= or phase= trigger in {spec.raw!r}"
        )
    if spec.op and spec.phase:
        raise ValueError(
            f"op= and phase= are mutually exclusive in {spec.raw!r}"
        )
    if spec.fault == "straggler" and spec.delay_ms <= 0:
        raise ValueError(f"delay_ms must be positive in {spec.raw!r}")
    if spec.fault == "oom":
        if spec.step_mb < 1 or spec.limit_mb < 1:
            raise ValueError(
                f"step_mb/limit_mb must be >= 1 in {spec.raw!r}"
            )
        if not (0.0 < spec.frac <= 1.0):
            raise ValueError(f"frac must be in (0, 1] in {spec.raw!r}")
    if spec.fault == "flood" and spec.burst < 1:
        raise ValueError(f"burst must be >= 1 in {spec.raw!r}")
    if spec.fault == "wedge" and spec.stall_s <= 0:
        # a zero/negative cap hard-exits 9 the instant the wedge
        # lands, so the watchdog under test never gets to fire
        raise ValueError(f"stall_s must be positive in {spec.raw!r}")
