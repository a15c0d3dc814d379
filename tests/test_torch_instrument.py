"""The port's instrument spine (``tpu_mpi_tests_torch/instrument/``) held
against the JAX package's, on the CPU.

* ``stencil2d --telemetry --memwatch --jsonl --trace-out`` at the JAX
  test's size (``tests/test_telemetry.py``): the port's run and the JAX
  driver's (one fake device, in a subprocess) give the same sequence of
  ``span`` ops with the same payload bytes, and the port's records carry
  the JAX records' fields (RECORDS.md) but the version fields;
* the JAX package's stdlib consumers (``tpumt-report``, ``tpumt-trace``,
  ``tpumt-doctor``, anatomy) read the port's JSONL, and the port's copy
  of the timeline merge gives the JAX merge's trace events;
* a disabled span and an unarmed ``--debug-nans`` add nothing; armed,
  a NaN stops the run naming the op;
* the watchdog (as ``tests/test_watchdog.py`` holds the JAX one), its
  fire in a subprocess, and ``run_guarded``'s refusals;
* the manifest, topo, clock_sync, mem and compile records at world 1.
"""

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from tpu_mpi_tests.instrument import aggregate as jagg
from tpu_mpi_tests.instrument import anatomy as janatomy
from tpu_mpi_tests.instrument import diagnose as jdiag
from tpu_mpi_tests.instrument import timeline as jtimeline
from tpu_mpi_tests_torch.comm import collectives as C
from tpu_mpi_tests_torch.comm import halo as H
from tpu_mpi_tests_torch.comm import ring as TR
from tpu_mpi_tests_torch.drivers import _common, daxpy, stencil2d
from tpu_mpi_tests_torch.instrument import costs, manifest, memwatch, nans
from tpu_mpi_tests_torch.instrument import telemetry as T
from tpu_mpi_tests_torch.instrument import timeline, timers
from tpu_mpi_tests_torch.instrument import watchdog as WD
from tpu_mpi_tests_torch.kernels import hand
from tpu_mpi_tests_torch.utils import TpuMtError

REPO = Path(__file__).resolve().parents[1]
#: the JAX test's stencil2d run (tests/test_telemetry.py)
STENCIL_ARGS = ["--n-local", "32", "--n-other", "64", "--n-iter", "2",
                "--n-warmup", "1", "--dtype", "float32", "--only", "1:0"]
FLAGS = ["--telemetry", "--memwatch", "--mem-interval", "0.05"]
#: the fields only the JAX package's manifest has
VERSION_FIELDS = {"jax", "jaxlib", "libtpu"}


def _records(path) -> list[dict]:
    return [json.loads(ln) for ln in Path(path).read_text().splitlines()]


@pytest.fixture
def fresh(monkeypatch):
    """A fresh telemetry registry, as tests/test_telemetry.py's."""
    reg = T.Telemetry()
    monkeypatch.setattr(T, "_TELEMETRY", reg)
    costs.reset()
    yield reg
    costs.reset()


@pytest.fixture(scope="module")
def stencil_runs(tmp_path_factory):
    """The port's and the JAX driver's stencil2d JSONL and traces, with
    the spine's flags on, at one rank and one fake device."""
    d = tmp_path_factory.mktemp("spine")
    port_jl, port_tr = d / "port.jsonl", d / "port.trace.json"
    jax_jl, jax_tr = d / "jax.jsonl", d / "jax.trace.json"
    jax = subprocess.run(
        [sys.executable, "-m", "tpu_mpi_tests.drivers.stencil2d",
         "--fake-devices", "1", *STENCIL_ARGS, *FLAGS, "--jsonl",
         str(jax_jl), "--trace-out", str(jax_tr)],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert jax.returncode == 0, jax.stdout + jax.stderr
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = stencil2d.main(["--device", "cpu", *STENCIL_ARGS, *FLAGS,
                             "--jsonl", str(port_jl), "--trace-out",
                             str(port_tr), "--deadline", "600"])
    assert rc == 0, buf.getvalue()
    return {"port": _records(port_jl), "jax": _records(jax_jl),
            "port_jl": str(port_jl), "jax_jl": str(jax_jl),
            "port_trace": port_tr, "out": buf.getvalue(),
            "jax_out": jax.stdout}


def _spans(recs):
    return [(r["op"], r["nbytes"]) for r in recs if r["kind"] == "span"]


def test_stencil2d_spans_match_the_jax_driver(stencil_runs):
    port, jax = stencil_runs["port"], stencil_runs["jax"]
    assert _spans(port) == _spans(jax)
    assert ("halo_exchange", 0) in _spans(port)
    # the manifest first, then topo and clock_sync
    assert [r["kind"] for r in port[:3]] == ["manifest", "topo",
                                             "clock_sync"]
    spans = [r for r in port if r["kind"] == "span"]
    assert all(r["seconds"] > 0 and r["t_end"] >= r["t_start"]
               and "rank" in r for r in spans)
    # seq numbers per op, from 0, as the JAX registry's
    assert [r["seq"] for r in spans if r["op"] == "halo_exchange"] == \
        [r["seq"] for r in jax if r["kind"] == "span"
         and r["op"] == "halo_exchange"]
    out = stencil_runs["out"]
    assert "MANIFEST cpu" in out
    assert "TELEMETRY halo_exchange :" in out
    assert f"TRACE {stencil_runs['port_trace']}: " in out
    # the registry was disabled when the reporter closed
    assert not T.registry().enabled


@pytest.mark.parametrize("kind", ["manifest", "topo", "clock_sync", "span",
                                  "mem", "telemetry_summary"])
def test_records_carry_the_jax_fields(stencil_runs, kind):
    port = [r for r in stencil_runs["port"] if r["kind"] == kind]
    jax = [r for r in stencil_runs["jax"] if r["kind"] == kind]
    assert port and jax
    if kind == "mem":
        # the same events; each port record has its JAX twin's fields
        # (census-only on the CPU in both)
        by_event = {}
        for r in jax:
            by_event.setdefault(r["event"], set()).update(r)
        assert {r["event"] for r in port} >= {"start", "final", "phase"}
        for r in port:
            missing = by_event[r["event"]] - set(r) - {"census"}
            assert not missing, (r["event"], missing)
            assert "devices" not in r and "bytes_in_use" not in r
        return
    if kind == "topo":
        # the port's is the declared-flat record (no probed host layout,
        # no link classes)
        assert [set(r) for r in port] == [{"kind", "world", "topology",
                                           "declared"}]
        assert port[0]["declared"] == "flat" and "link_classes" not in jax[0]
        return
    # per op where records have one; the JAX spans also carry its
    # compile probe's cost model, and the port probes no comm op
    want = {}
    for r in jax:
        want.setdefault(r.get("op"), set()).update(r)
    for r in port:
        missing = want[r.get("op")] - set(r) - VERSION_FIELDS - {
            "cost_bytes", "cost_flops", "model_gbps", "model_gflops",
            "roofline_frac"}
        assert not missing, missing
    if kind == "manifest":
        assert port[0]["platform"] == "cpu"
        assert port[0]["device_kinds"] == ["cpu"]
        assert port[0]["torch"] == torch.__version__
        assert port[0]["memory_stats_available"] is False


def test_jax_consumers_render_the_port_jsonl(stencil_runs, capsys):
    files = {"port": stencil_runs["port_jl"], "jax": stencil_runs["jax_jl"]}
    ops = {}
    for who, f in files.items():
        assert jagg.main([f]) == 0
        out = capsys.readouterr().out
        ops[who] = sorted(ln.split(" mean=")[0] for ln in out.splitlines()
                          if ln.startswith("OP "))
        assert jdiag.main([f]) == 0
        assert "DOCTOR OK" in capsys.readouterr().out
    # the same OP table rows (op, ranks, ops, bytes), timings aside
    assert ops["port"] == ops["jax"] and ops["port"]
    streams = jtimeline.rank_streams([files["port"]])
    assert streams[0][0] == 0 and streams[0][1] == 0.0
    janatomy.anatomize(streams)
    assert janatomy.traffic_matrix(streams) == {}


def test_port_timeline_is_the_jax_merge(stencil_runs, tmp_path):
    files = [stencil_runs["port_jl"]]
    doc = timeline.chrome_trace(files)
    jdoc = jtimeline.chrome_trace(files)
    # the JAX merge adds tpumt-doctor's FINDING markers, which the port's
    # copy leaves out; this healthy run has none
    assert not [e for e in jdoc["traceEvents"] if e.get("cat") == "finding"]
    assert doc == jdoc
    assert timeline.placed_events(doc) > 0
    # the trace the reporter wrote on close is this merge
    written = json.loads(Path(stencil_runs["port_trace"]).read_text())
    assert written["traceEvents"] == doc["traceEvents"]
    assert any(e["ph"] == "C" for e in doc["traceEvents"])  # mem counters
    n = jtimeline.write_trace(files, str(tmp_path / "j.json"))
    assert n == timeline.write_trace(files, str(tmp_path / "p.json"))


def test_disabled_span_and_unarmed_nans_add_nothing(fresh, monkeypatch):
    calls = []
    monkeypatch.setattr(timers, "block", lambda *t: calls.append(t))
    real_isnan = torch.isnan
    monkeypatch.setattr(torch, "isnan",
                        lambda t: calls.append(t) or real_isnan(t))
    assert not fresh.armed
    z = torch.arange(36.0).reshape(6, 6)
    x = torch.ones(8)
    assert T.span_call("op", lambda a: a + 1, x).tolist() == [2.0] * 8
    H.halo_exchange(z, axis=0, periodic=True)
    C.allreduce_sum(x[None].clone())
    hand.daxpy(2.0, x, x)
    assert calls == [] and fresh.counters() == {}
    # armed: a finite result passes, checked once a wrapper
    nans.arm(True)
    try:
        assert fresh.armed and not fresh.enabled
        hand.daxpy(2.0, x, x)
        assert len(calls) == 1
    finally:
        nans.arm(False)
    assert not fresh.armed


def test_driver_launch_counts_unchanged_by_the_flags(tmp_path, capsys):
    argv = ["--device", "cpu", *STENCIL_ARGS, "--kernel", "hand",
            "--iterate-tier", "blocks", "--iterate-steps", "2"]
    counts = []
    for extra in ([], [*FLAGS, "--debug-nans", "--jsonl",
                       str(tmp_path / "x.jsonl")], []):
        hand.reset_launch_counts()
        assert stencil2d.main(argv + extra) == 0
        counts.append((hand.launch_counts(), hand.route_counts()))
    capsys.readouterr()
    assert counts[0] == counts[1] == counts[2]


@pytest.mark.parametrize("where", ["halo_exchange", "stencil2d_iterate",
                                   "allreduce"])
def test_debug_nans_stops_at_the_op(fresh, where):
    z = torch.zeros(12, 10)
    z[5, 5] = float("nan")
    nans.arm(True)
    try:
        with pytest.raises(FloatingPointError, match=where):
            if where == "halo_exchange":
                H.halo_exchange(z, axis=0, periodic=True)
            elif where == "stencil2d_iterate":
                hand.stencil2d_iterate(z, 0.1, dim=0, steps=1)
            else:
                C.allreduce_sum(z[5:6].clone())
    finally:
        nans.arm(False)


def test_run_guarded_arms_nans_and_refuses_the_live_plane():
    parser = _common.base_parser("x")
    armed = _common.run_guarded(lambda a: T.registry().check_nans,
                                parser.parse_args(["--debug-nans"]))
    assert armed is True and not T.registry().check_nans
    assert _common.run_guarded(lambda a: T.registry().check_nans,
                               parser.parse_args([])) is False
    with pytest.raises(TpuMtError, match=r"queue 1 item #18b"):
        daxpy.main(["--device", "cpu", "--metrics-port", "9000"])


# ------------------------------------------------------------ watchdog


def _fire(wd_phase: str, seconds: float = 0.05) -> str:
    fired = threading.Event()
    msgs = []

    def on_timeout(msg):
        msgs.append(msg)
        fired.set()

    wd = WD.Watchdog(seconds, wd_phase, _on_timeout=on_timeout).start()
    assert fired.wait(timeout=5.0)
    wd.cancel()
    return msgs[0]


def test_deadline_noop_and_in_time():
    with WD.deadline(None):
        pass
    with WD.deadline(0):
        pass
    with WD.deadline(30, "fast-phase"):
        time.sleep(0.01)
    time.sleep(0.05)


def test_watchdog_fires_and_attributes_the_history(fresh):
    for i in range(12):
        WD.note_comm_op(f"op_number_{i}(world=8)")
    msg = _fire("hung-ring")
    assert "hung-ring" in msg and "hung collective" in msg
    for i in range(4, 12):
        assert f"op_number_{i}(world=8)" in msg
    assert msg.index("op_number_4") < msg.index("op_number_11")
    assert "s ago" in msg and "dispatched" in msg
    assert WD.last_comm_op().startswith("op_number_11(world=8)")


def test_watchdog_fire_emits_its_records(fresh):
    records = []
    fresh.enable(sink=records.append)
    msg = _fire("allgather")
    wd = [r for r in records if r["kind"] == "watchdog"]
    assert len(wd) == 1 and wd[0]["phase"] == "allgather"
    mem = [r for r in records if r["kind"] == "mem"]
    assert mem and mem[0]["event"] == "watchdog" and "census" in mem[0]
    assert "memory at fire" in msg and "LIVE census" in msg


def test_rdma_exchange_notes_its_launch(fresh):
    assert WD.last_comm_op() is None
    z = torch.arange(96.0).reshape(12, 8)
    H.halo_exchange(z, axis=0, periodic=True, staging="pallas")
    assert "ring_halo(axis=0, n_bnd=2, periodic=True, world=1" in \
        WD.last_comm_op()
    C.all_gather_rdma(torch.ones(4))
    assert WD.last_comm_op().startswith("ring_allgather(world=1")


def _flight_notes(fn) -> list[str]:
    """The flight-recorder notes ``fn()`` adds."""
    before = len(T.flight_events())
    fn()
    return [e.note_text() for e in T.flight_events()[before:]]


#: every peer-store launch site of the port, with the notes one call adds
PEER_SITES = {
    "halo_exchange_rdma": (lambda: H.halo_exchange(
        torch.arange(96.0).reshape(12, 8), axis=0, periodic=True,
        staging="pallas"), ["ring_halo(axis=0, n_bnd=2"]),
    "all_gather_rdma": (lambda: C.all_gather_rdma(torch.ones(4)),
                        ["ring_allgather(world=1"]),
    "allreduce_rdma": (lambda: C.allreduce_rdma(torch.ones(1, 4)),
                       ["ring_allreduce(world=1"]),
    "allreduce_oneshot": (lambda: C.allreduce_oneshot(torch.ones(1, 4)),
                          ["oneshot_allreduce(world=1"]),
    "iterate_rdma": (lambda: H.iterate_hand_fn(
        4, 0.1, axis=0, steps=2, periodic=True, rdma=True)(
            torch.ones(24, 8), 3), ["ring_halo(axis=0, n_bnd=4"] * 3),
    "iterate_fused": (lambda: H.iterate_fused_rdma_fn(
        4, 0.1, axis=0, steps=2, periodic=True)(torch.ones(24, 8), 3),
        ["stencil2d_fused_rdma(steps=2"] * 3),
    "ring_fused": (lambda: TR.ring_attention_fn(1, flash=True,
                                                tier="fused")(
        *(torch.ones(16, 8) for _ in range(3))),
        ["fused_ring_attention(world=1"]),
}


@pytest.mark.parametrize("site", sorted(PEER_SITES))
def test_one_flight_note_per_peer_store_launch(fresh, site):
    """A peer-store launch is noted once for the hang dump: at the comm
    wrapper, or a step at a chained loop, never again in the kernel's
    wrapper; with telemetry off nothing reaches a sink."""
    fn, want = PEER_SITES[site]
    notes = _flight_notes(fn)
    assert len(notes) == len(want), notes
    assert all(n.startswith(w) for n, w in zip(notes, want)), notes
    assert fresh.counters() == {}


@pytest.mark.parametrize("driver,argv", [
    ("daxpy", ["--n", "4096", "--iters", "8"]),
    ("stencil2d", [*STENCIL_ARGS, "--kernel", "hand", "--iterate-tier",
                   "blocks", "--iterate-steps", "2"]),
    ("stencil1d", ["--n-global", "4096"]),
    ("heat2d", ["--mesh", "1,1", "--nx-local", "16", "--ny-local", "12",
                "--n-steps", "8"]),
    ("stencil2d_grid", ["--mesh", "1,1", "--nx-local", "16",
                        "--ny-local", "24", "--n-iter", "4",
                        "--n-warmup", "2"]),
    ("collbench", ["--collectives", "allgather", "--sizes-kib", "4",
                   "--n-iter", "10"]),
    ("attnbench", ["--tiers", "flash", "--seq-len", "64", "--head-dim",
                   "16", "--n-iter", "10"]),
])
def test_compile_probe_builds_nothing_without_telemetry(
        monkeypatch, capsys, driver, argv):
    """A flagless run builds none of the probe's operands (a second field
    of the run's size at full width); ``--telemetry`` probes."""
    import importlib

    mod = importlib.import_module(f"tpu_mpi_tests_torch.drivers.{driver}")
    built = []
    real = costs.compile_probe

    def spy(fn, make_args, *a, **k):
        def counted():
            built.append(1)
            return make_args()
        return real(fn, counted, *a, **k)

    monkeypatch.setattr(costs, "compile_probe", spy)
    costs.reset()
    try:
        assert mod.main(["--device", "cpu", *argv]) == 0
        assert built == []
        assert mod.main(["--device", "cpu", *argv, "--telemetry"]) == 0
        assert built
    finally:
        T.disable()
        costs.reset()
    capsys.readouterr()


def test_watchdog_cancel_and_idle_aware():
    fired = threading.Event()
    WD.Watchdog(0.05, "p", _on_timeout=lambda m: fired.set()).start() \
        .cancel()
    time.sleep(0.15)
    assert not fired.is_set()
    wd = WD.IdleAwareWatchdog(0.1, "serve",
                              _on_timeout=lambda m: fired.set())
    with wd.active("batch"):
        time.sleep(0.01)
    time.sleep(0.25)  # idle longer than the deadline: nothing fires
    assert not fired.is_set()
    wd.arm("wedged")
    assert fired.wait(timeout=5.0)
    wd.disarm()


WEDGED = r"""
import sys, time
from tpu_mpi_tests_torch.instrument import watchdog as WD
WD.note_comm_op("ring_halo(axis=0, world=2)")
with WD.deadline(0.3, "exchange"):
    time.sleep(30)
print("UNREACHED")
"""


def test_watchdog_hard_exits_a_wedged_process():
    p = subprocess.run([sys.executable, "-c", WEDGED], cwd=REPO,
                       capture_output=True, text=True, timeout=60)
    assert p.returncode == 9
    assert "UNREACHED" not in p.stdout
    assert "WATCHDOG: phase 'exchange' exceeded 0.3s" in p.stderr
    assert "ring_halo(axis=0, world=2)" in p.stderr


def test_driver_deadline_fires_in_a_subprocess(tmp_path):
    jl = tmp_path / "w.jsonl"
    p = subprocess.run(
        [sys.executable, "-m", "tpu_mpi_tests_torch.drivers.stencil2d",
         "--device", "cpu", *STENCIL_ARGS, "--n-iter", "100000",
         "--telemetry", "--jsonl", str(jl), "--deadline", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert p.returncode == 9, p.stdout + p.stderr
    assert "WATCHDOG: phase 'driver' exceeded 2.0s" in p.stderr
    assert "halo_exchange" in p.stderr  # the flight recorder's spans
    kinds = [r["kind"] for r in _records(jl)]
    assert kinds[0] == "manifest" and "watchdog" in kinds


# ------------------------------------------------------- records at w=1


def _records_md_fields(kind: str) -> set:
    """The fields RECORDS.md lists for ``kind`` (its generated table)."""
    import re

    for line in (REPO / "RECORDS.md").read_text().splitlines():
        if line.startswith(f"| `{kind}` |"):
            return set(re.findall(r"`(\w+)`", line.split("|")[3]))
    raise AssertionError(f"RECORDS.md has no {kind} row")


@pytest.mark.parametrize("kind", ["watchdog", "compile", "dispatch"])
def test_spine_records_carry_the_records_md_fields(fresh, kind):
    records = []
    fresh.enable(sink=records.append)
    if kind == "watchdog":
        _fire("phase")
    elif kind == "compile":
        costs.compile_probe(lambda a: a + 1, lambda: (torch.ones(2),),
                            label="op", flops=2, bytes_accessed=24)
    else:
        WD.note_comm_op("ring_halo(axis=0, world=2)")
    (rec,) = [r for r in records if r["kind"] == kind]
    assert not _records_md_fields(kind) - set(rec)


def test_manifest_topo_clock_sync_at_world1():
    m = manifest.run_manifest("cpu", argv=["x"], extra_field=1)
    assert m["kind"] == "manifest" and m["argv"] == ["x"]
    assert m["process_count"] == 1 and m["global_device_count"] == 1
    assert m["extra_field"] == 1 and "hosts" not in m
    assert all(k.startswith(manifest.ENV_PREFIXES) for k in m["env"])
    assert manifest.manifest_banner(m).startswith("MANIFEST cpux1 (cpu)")
    assert manifest.topo_record() == {"kind": "topo", "world": 1,
                                      "topology": "flat",
                                      "declared": "flat"}
    cs = manifest.clock_sync_record()
    assert cs["offset_s"] == 0.0 and cs["method"] == "single_process"
    assert isinstance(cs["run_sync_us"], int)


def test_memwatch_on_the_cpu_is_census_only():
    keep = torch.zeros(1000, 3)
    assert memwatch.device_memory_stats("cpu") == {}
    rec = memwatch.mem_record(event="x", top_k=4, device="cpu")
    assert "devices" not in rec and "bytes_in_use" not in rec
    assert rec["census"]["count"] >= 1 and rec["live_bytes"] >= keep.nbytes
    assert any(e["key"] == "1000x3·float32" for e in rec["census"]["top"])
    recs = []
    w = memwatch.MemWatch(recs.append, interval_s=0.02, device="cpu").start()
    t = timers.PhaseTimer()
    for _ in range(3):
        with t.phase("work"):
            pass
    w.stop()
    w.stop()  # idempotent
    assert [r["event"] for r in recs] == ["start", "phase", "final"]
    assert timers._PHASE_HOOKS == []


def test_compile_probe_and_cost_fields(fresh):
    def no_operands():
        raise AssertionError("operands built with telemetry off")

    # telemetry off: no call, and the operands are never built
    assert costs.compile_probe(lambda a: a * 2, no_operands,
                               label="x") is None
    records = []
    fresh.enable(sink=records.append)
    info = costs.compile_probe(lambda a: a * 2, lambda: (torch.ones(4),),
                               label="dbl", flops=4, bytes_accessed=32,
                               dtype="float32")
    assert info["compile_s"] >= 0 and info["bytes_accessed"] == 32.0
    rec = [r for r in records if r["kind"] == "compile"][0]
    assert rec["phase"] == "dbl" and rec["t_end"] >= rec["t_start"]
    assert costs.compile_probe(lambda a: a, lambda: (torch.ones(4),),
                               label="dbl") is info  # one probe a shape
    with T.comm_span("dbl", nbytes=32) as s:
        s.result = torch.ones(1)
    span = [r for r in records if r["kind"] == "span"][0]
    assert span["cost_bytes"] == 32.0 and span["cost_flops"] == 4.0
    assert "roofline_frac" not in span  # no peak on the CPU
    assert costs.PEAK_HBM_GBPS == {"NVIDIA H100 80GB HBM3": 3350.0}


def test_make_reporter_notes_and_proc_suffix(tmp_path, capsys):
    args = _common.base_parser("x").parse_args(
        ["--device", "cpu", "--trace-out", str(tmp_path / "t.json"),
         "--memwatch"])
    rep = _common.make_reporter(args)
    rep.close()
    out = capsys.readouterr().out
    assert "--trace-out needs --jsonl" in out
    assert "--memwatch needs --jsonl" in out
    from tpu_mpi_tests_torch.instrument.report import Reporter

    r = Reporter(rank=0, size=1, jsonl_path=str(tmp_path / "o.jsonl"),
                 proc_index=1, proc_count=2)
    assert r.jsonl_path.endswith("o.p1.jsonl")
