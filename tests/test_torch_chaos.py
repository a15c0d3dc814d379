"""The port's chaos layer in process (``tpu_mpi_tests_torch/chaos``),
held against the JAX package's:

* the grammar: the same specs parse to the same fields and
  ``describe()`` text as the JAX ``parse_chaos_spec``, and the same
  malformed specs raise the same messages (the JAX test's cases);
* arm and disarm: disarm restores every slot, re-arming is idempotent, a
  rank that does not match installs nothing;
* the hooks: the op straggler sleeps outside the span's window, the op
  prefix filter, the uniform straggler wrapping ``timers.block``, the
  flood firing once at its window, shedding through the port's serve
  loop and never inflating a closed population, the oom limit's
  precedence; the watchdog's dump is the JSONL's tail;
* containment: no module of the port but ``drivers/_common.py`` imports
  the chaos package.

The end-to-end legs (subprocesses, two real processes) are in
``tests/test_torch_chaos_legs.py``.
"""

import ast
import re
import time
from dataclasses import asdict
from pathlib import Path

import pytest
import torch

from tpu_mpi_tests.chaos import spec as jspec
from tpu_mpi_tests.instrument import diagnose
from tpu_mpi_tests_torch.chaos import inject
from tpu_mpi_tests_torch.chaos.spec import (
    FAULT_CLASSES,
    FINDING_FOR,
    parse_chaos_spec,
)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _disarmed():
    yield
    inject.disarm()


# ---------------------------------------------------------------------------
# grammar parity
# ---------------------------------------------------------------------------

GOOD_SPECS = [
    "kill:rank=1:op=halo_exchange:after=3",
    "straggler:rank=1:delay_ms=40, oom:step_mb=8:frac=0.5",
    "straggler:rank=1:delay_ms=25",
    "kill:rank=1:phase=kernel:after=10",
    "wedge:op=halo_exchange:after=3:stall_s=60",
    "wedge:rank=1:phase=kernel:after=3:stall_s=60",
    "oom:step_mb=8:limit_mb=48:frac=0.8",
    "oom:step_mb=4096",
    "flood:burst=300:after=1",
    "flood:rank=2:burst=4000:after=1:seed=3",
    "straggler:rank=0:op=halo:delay_ms=60:after=2",
    "kill:rank=1:op=x,straggler:rank=1,flood:rank=1,oom:rank=1",
]

BAD_SPECS = [
    "boom", "kill", "wedge", "kill:rank=x", "oom:frac=2",
    "oom:frac=0", "wedge:op=a:phase=b", "kill:op=a:after=0",
    "straggler:delay_ms=0", "flood:burst=0", "kill:op=a:nope=1",
    "straggler:phase=copyIn:delay_ms=40", "oom:op=daxpy",
    "flood:phase=kernel:burst=10", "kill:op=a:delay_ms=5",
    "kill:rank=1:op=x:rank=0", "wedge:op=a:stall_s=0", "",
    "oom:step_mb=0", "kill:op=a:rank=-1", "kill:op=a:junk",
]


def _fields(s):
    d = asdict(s)
    d["explicit"] = sorted(s.explicit)
    return d


def test_every_fault_class_has_a_finding_class():
    assert FAULT_CLASSES == jspec.FAULT_CLASSES
    assert FINDING_FOR == jspec.FINDING_FOR
    assert set(FINDING_FOR.values()) <= set(diagnose.FINDING_CLASSES)


@pytest.mark.parametrize("text", GOOD_SPECS)
def test_specs_parse_as_in_jax(text):
    got = parse_chaos_spec(text)
    want = jspec.parse_chaos_spec(text)
    assert [_fields(s) for s in got] == [_fields(s) for s in want]
    assert [s.describe() for s in got] == [s.describe() for s in want]


@pytest.mark.parametrize("bad", BAD_SPECS)
def test_malformed_specs_raise_the_jax_message(bad):
    with pytest.raises(ValueError) as want:
        jspec.parse_chaos_spec(bad)
    with pytest.raises(ValueError) as got:
        parse_chaos_spec(bad)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# arm / disarm
# ---------------------------------------------------------------------------


def _slots():
    from tpu_mpi_tests_torch.instrument import telemetry, timers
    from tpu_mpi_tests_torch.serve import loop as serve_loop

    return (telemetry._CHAOS_SPAN_HOOK, serve_loop._CHAOS_FLOOD,
            timers.block, list(timers._PHASE_HOOKS))


def test_non_matching_rank_installs_nothing():
    before = _slots()
    specs = parse_chaos_spec(
        "kill:rank=1:op=x,straggler:rank=1,flood:rank=1,oom:rank=1")
    assert inject.arm(specs, rank=0) == []
    assert _slots() == before
    assert before[0] is None and before[1] is None
    assert inject.armed() == []


def test_arm_installs_and_disarm_restores():
    from tpu_mpi_tests_torch.instrument import timers

    before = _slots()
    mine = inject.arm(parse_chaos_spec(
        "straggler:rank=0:op=halo,flood:rank=0,straggler:rank=0,"
        "oom:rank=0"), rank=0, device="cpu")
    assert len(mine) == 4
    hook, flood, block, hooks = _slots()
    assert hook is not None and flood is not None
    assert block is not before[2]  # the uniform straggler's wrap
    assert inject._PHASE_HOOK in timers._PHASE_HOOKS
    inject.disarm()
    assert _slots() == before
    assert inject._PHASE_HOOK is None and inject._BALLAST == []


def test_rearm_is_idempotent():
    before = _slots()
    specs = parse_chaos_spec("straggler:rank=0,oom:rank=0")
    inject.arm(specs, rank=0, device="cpu")
    inject.arm(specs, rank=0, device="cpu")  # no double wrap or hook
    from tpu_mpi_tests_torch.instrument import timers

    assert timers._PHASE_HOOKS.count(inject._PHASE_HOOK) == 1
    inject.disarm()
    assert _slots() == before


def test_arm_audits_each_fault():
    recs = []
    inject.arm(parse_chaos_spec("flood:burst=5,straggler:rank=3"),
               rank=0, emit=recs.append)
    assert [(r["kind"], r["event"], r["fault"]) for r in recs] == [
        ("chaos", "armed", "flood")]


# ---------------------------------------------------------------------------
# hooks
# ---------------------------------------------------------------------------


def test_op_straggler_sleeps_outside_the_measured_window():
    from tpu_mpi_tests_torch.instrument import telemetry

    recs = []
    telemetry.enable(sink=recs.append)
    try:
        inject.arm(parse_chaos_spec(
            "straggler:rank=0:op=halo:delay_ms=60:after=2"), rank=0)
        t0 = time.perf_counter()
        with telemetry.comm_span("halo_exchange"):
            pass
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        with telemetry.comm_span("halo_exchange"):
            pass
        second = time.perf_counter() - t0
    finally:
        telemetry.disable()
        inject.disarm()
    spans = [r for r in recs if r.get("kind") == "span"]
    assert len(spans) == 2
    assert first < 0.05 and second >= 0.055
    assert all(r["seconds"] < 0.05 for r in spans)
    fires = [r for r in recs
             if r.get("kind") == "chaos" and r.get("event") == "fire"]
    assert len(fires) == 1


def test_span_hook_is_read_only_while_spans_record():
    from tpu_mpi_tests_torch.instrument import telemetry

    calls = []
    telemetry._CHAOS_SPAN_HOOK = lambda op, when: calls.append((op, when))
    try:
        with telemetry.comm_span("halo_exchange"):  # telemetry off
            pass
        telemetry.enable(sink=None)
        with telemetry.comm_span("halo_exchange"):
            pass
    finally:
        telemetry.disable()
        telemetry._CHAOS_SPAN_HOOK = None
    assert calls == [("halo_exchange", "enter"), ("halo_exchange", "exit")]


def test_op_prefix_filter():
    from tpu_mpi_tests_torch.instrument import telemetry

    telemetry.enable(sink=None)
    try:
        inject.arm(parse_chaos_spec(
            "straggler:rank=0:op=halo:delay_ms=80"), rank=0)
        t0 = time.perf_counter()
        with telemetry.comm_span("allreduce"):
            pass
        assert time.perf_counter() - t0 < 0.05
    finally:
        telemetry.disable()
        inject.disarm()


def test_uniform_straggler_wraps_block():
    from tpu_mpi_tests_torch.instrument import timers

    inject.arm(parse_chaos_spec(
        "straggler:rank=0:delay_ms=50:after=2"), rank=0)
    try:
        x = torch.ones(4)
        t0 = time.perf_counter()
        assert timers.block(x) is x
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        # a phase's own wait goes through the wrap too
        timers.PhaseTimer().timed("kernel", lambda: x)
        second = time.perf_counter() - t0
    finally:
        inject.disarm()
    assert first < 0.04 and second >= 0.045


def test_flood_hook_fires_once_at_its_window():
    inject.arm(parse_chaos_spec("flood:burst=37:after=2"), rank=0)
    from tpu_mpi_tests_torch.serve import loop as serve_loop

    hook = serve_loop._CHAOS_FLOOD
    assert [hook(1), hook(2), hook(2), hook(3)] == [0, 37, 0, 0]


class FakeClock:
    t = 0.0

    def clock(self):
        return self.t

    def sleep(self, dt):
        self.t += dt


def test_flood_sheds_through_the_serve_loop():
    from tpu_mpi_tests_torch.serve.arrival import OpenLoopPoisson
    from tpu_mpi_tests_torch.serve.loop import ServeLoop
    from tpu_mpi_tests_torch.serve.workloads import parse_workload_table

    clk = FakeClock()
    classes = parse_workload_table("daxpy:128:float32")
    recs = []
    inject.arm(parse_chaos_spec("flood:burst=100:after=1"), rank=0)
    loop = ServeLoop(
        classes, {classes[0].key: lambda n: None},
        OpenLoopPoisson(5.0, seed=0), duration_s=6.0, window_s=2.0,
        max_queue=16, sink=recs.append, clock=clk.clock, wall=clk.clock,
        sleep=clk.sleep)
    (summary,) = loop.run()
    assert summary["shed"] >= 80  # a burst of 100 into a 16-deep queue
    assert any(w["shed"] > 0 for w in recs if w.get("event") == "window")


def test_flood_never_inflates_a_closed_population():
    from tpu_mpi_tests_torch.serve.arrival import ClosedLoop
    from tpu_mpi_tests_torch.serve.loop import ServeLoop
    from tpu_mpi_tests_torch.serve.workloads import parse_workload_table

    clk = FakeClock()
    classes = parse_workload_table("daxpy:128:float32")
    arrival = ClosedLoop(2)
    fed = []
    orig = arrival.on_complete
    arrival.on_complete = lambda n, now: (fed.append(n), orig(n, now))

    def handler(n):
        clk.t += 0.005 * n

    inject.arm(parse_chaos_spec("flood:burst=10:after=1"), rank=0)
    loop = ServeLoop(
        classes, {classes[0].key: handler}, arrival, duration_s=6.0,
        window_s=2.0, max_queue=32, clock=clk.clock, wall=clk.clock,
        sleep=clk.sleep)
    (summary,) = loop.run()
    assert summary["requests"] > 10
    assert sum(fed) == summary["requests"] - 10


@pytest.mark.parametrize("explicit,card_limit,dies", [
    (True, 32 << 30, True),    # explicit 8 MB wins over the card's 32 GB
    (False, 32 << 30, False),  # the default defers to the card's limit
    (False, None, False),      # no card limit: the default 256 MB
])
def test_oom_limit_precedence(monkeypatch, explicit, card_limit, dies):
    from tpu_mpi_tests_torch.instrument import memwatch

    monkeypatch.setattr(
        memwatch, "device_memory_stats",
        lambda device=None: ({"0": {"bytes_limit": card_limit}}
                             if card_limit else {}))
    monkeypatch.setattr(memwatch, "_live_totals",
                        lambda device=None: (1, 10 << 20))
    died = []
    monkeypatch.setattr(inject, "_die",
                        lambda spec, code, why: died.append(code))
    text = "oom:step_mb=1:frac=0.8" + (":limit_mb=8" if explicit else "")
    (s,) = parse_chaos_spec(text)
    inject._grow_ballast(s, "kernel")
    assert inject._BALLAST[-1].numel() == (1 << 20) // 4
    inject._BALLAST.clear()
    assert died == ([inject.OOM_EXIT] if dies else [])


def test_oom_ballast_grows_the_cpu_live_total():
    from tpu_mpi_tests_torch.instrument import memwatch

    inject.arm(parse_chaos_spec("oom:step_mb=4:limit_mb=4096"), rank=0,
               device="cpu")
    before = memwatch._live_totals("cpu")[1]
    inject._PHASE_HOOK("kernel", "begin")
    inject._PHASE_HOOK("kernel", "end")  # one step a boundary
    inject._PHASE_HOOK("kernel", "begin")
    assert memwatch._live_totals("cpu")[1] - before >= 8 << 20
    assert len(inject._BALLAST) == 2


def test_exit_codes_match_jax():
    from tpu_mpi_tests.chaos import inject as jinject

    assert (inject.KILL_EXIT, inject.OOM_EXIT, inject.WEDGE_EXIT) == (
        jinject.KILL_EXIT, jinject.OOM_EXIT, jinject.WEDGE_EXIT)


# ---------------------------------------------------------------------------
# flight recorder: the watchdog's dump is the JSONL's tail
# ---------------------------------------------------------------------------


def test_watchdog_dump_is_exactly_the_jsonl_tail():
    from tpu_mpi_tests_torch.instrument import telemetry
    from tpu_mpi_tests_torch.instrument.watchdog import DUMP_EVENTS, Watchdog

    telemetry.registry().reset()
    recs = []
    telemetry.enable(sink=recs.append)
    try:
        for i in range(20):
            with telemetry.comm_span(f"op{i:02d}"):
                pass
        telemetry.note_dispatch("wedged-dma", op="rdma_ring")
        captured = []
        Watchdog(1.0, "t", _on_timeout=captured.append)._fire()
    finally:
        telemetry.disable()
    (msg,) = captured
    m = re.search(r"comm ops \(newest last\):\n((?:\s+.*\n)+?)"
                  r"\s+(?:memory at fire:|aborting)", msg)
    assert m, msg
    lines = [ln.strip() for ln in m.group(1).strip().splitlines()]
    assert len(lines) == DUMP_EVENTS
    stream = [r.get("op") if r["kind"] == "span" else r.get("note")
              for r in recs if r.get("kind") in ("span", "dispatch")]
    assert [ln.split()[0] for ln in lines] == stream[-DUMP_EVENTS:]
    ages = [float(re.search(r"([\d.]+)s ago$", ln).group(1))
            for ln in lines]
    assert ages == sorted(ages, reverse=True)


# ---------------------------------------------------------------------------
# containment
# ---------------------------------------------------------------------------


def _imports_chaos(path: Path) -> bool:
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module] + [f"{node.module}.{a.name}"
                                     for a in node.names]
        if any(n == "tpu_mpi_tests_torch.chaos"
               or n.startswith("tpu_mpi_tests_torch.chaos.") for n in names):
            return True
    return False


PORT = REPO / "tpu_mpi_tests_torch"


@pytest.mark.parametrize(
    "path", [p for p in sorted(PORT.rglob("*.py"))
             if p.parent.name != "chaos"],
    ids=lambda p: str(p.relative_to(REPO)))
def test_only_the_arm_point_imports_chaos(path):
    rel = path.relative_to(PORT).as_posix()
    assert _imports_chaos(path) == (rel == "drivers/_common.py")
