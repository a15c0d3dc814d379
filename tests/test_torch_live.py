"""The live plane of the port (``serve/histogram.py``,
``instrument/metrics.py``, ``instrument/export.py`` and the
``--metrics-port`` wiring) held against the JAX package's.

* ``LatencyHistogram``: the same percentiles, mean and buckets as the JAX
  histogram for the same samples (exact: the same arithmetic).
* The registry: one recorded stream of span, mem, overlap, route, decode,
  time, tune and health records (and a stream a port run wrote) fed to
  both registries under the same clocks gives byte-equal
  ``render_openmetrics`` text; the rolling windows, the ``tune_stale``
  rule, ``CommWaitWatch``, ``PhaseProgress`` (hooked into the port's
  ``timers``) and the heartbeat record likewise.
* The exporter on port 0 serves that text at ``/metrics``; neither the
  exporter's threads nor the heartbeat's call into torch.
* The wiring: every driver and spec runs armed; an armed run's JSONL has
  the heartbeat trail and the ``time`` progress records, which the JAX
  package's ``tpumt-top`` (``instrument/live.py``, reused) follows and
  ``tpumt-report`` counts once; a disarmed run writes what a build
  without the live modules writes.
"""

import contextlib
import importlib
import io
import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from tpu_mpi_tests.instrument import aggregate as jagg
from tpu_mpi_tests.instrument import export as JX
from tpu_mpi_tests.instrument import live as jlive
from tpu_mpi_tests.instrument import metrics as JMx
from tpu_mpi_tests.serve import histogram as JH
from tpu_mpi_tests_torch.drivers import _common
from tpu_mpi_tests_torch.instrument import export as X
from tpu_mpi_tests_torch.instrument import metrics as Mx
from tpu_mpi_tests_torch.instrument import timers
from tpu_mpi_tests_torch.instrument.report import Reporter
from tpu_mpi_tests_torch.serve import histogram as H

REPO = Path(__file__).resolve().parent.parent


# --------------------------------------------------------------- histogram


def _samples(seed):
    rng = np.random.default_rng(seed)
    s = list(rng.lognormal(-7.0, 2.5, size=400))
    # under- and overflow, exact bucket edges, invalid values
    return s + [0.0, 5e-7, 1e-6, 1e-3, 1e3, 5e3, float("nan"), -1.0]


@pytest.mark.parametrize("seed", range(4))
def test_histogram_percentiles_are_the_jax_ones(seed):
    mine, theirs = H.LatencyHistogram(), JH.LatencyHistogram()
    for s in _samples(seed):
        mine.record(s)
        theirs.record(s)
    assert mine.counts == theirs.counts and mine.count == theirs.count
    for q in (0.0, 1.0, 25.0, 50.0, 90.0, 95.0, 99.0, 99.9, 100.0):
        assert mine.percentile(q) == theirs.percentile(q)
    assert mine.percentiles_ms() == theirs.percentiles_ms()
    assert mine.mean() == theirs.mean()
    mine.reset()
    assert mine.count == 0 and mine.percentile(50) is None
    assert mine.percentiles_ms() == {}


def test_rolling_windows_expire_as_jax():
    now = [0.0]
    mine = Mx.RollingHistogram(window_s=6.0, slots=3, clock=lambda: now[0])
    theirs = JMx.RollingHistogram(window_s=6.0, slots=3,
                                  clock=lambda: now[0])
    rng = np.random.default_rng(1)
    for step in range(40):
        now[0] = step * 0.7
        v = float(rng.lognormal(-5, 1))
        mine.record(v)
        theirs.record(v)
        a, b = mine.merged(), theirs.merged()
        assert (a.counts, a.count, a.total_s) == (b.counts, b.count,
                                                  b.total_s)
        assert a.percentile(99) == b.percentile(99)


# -------------------------------------------------------- the record stream


def _stream(seed):
    """A recorded stream of every kind the registry reads, with a tuned
    schedule whose GB/s sags (the tune_stale rule fires once)."""
    rng = np.random.default_rng(seed)
    recs = [{"kind": "manifest", "process_index": 0},
            {"kind": "tune_hit", "knob": "coll_variant/allreduce",
             "value": "rdma"},
            {"kind": "tune_result", "knob": "halo/staging",
             "value": "device"}]
    for i in range(8 * Mx.STALE_SAMPLES):
        sag = 0.5 if i >= 4 * Mx.STALE_SAMPLES else 1.0
        secs = float(rng.lognormal(-8, 0.3))
        span = {"kind": "span", "op": ("allreduce", "halo_exchange")[i % 2],
                "nbytes": int(rng.integers(1, 1 << 22)), "seconds": secs,
                "gbps": round(sag * float(rng.uniform(90, 100)), 6),
                "roofline_frac": round(sag * 0.8, 4), "world": 2,
                "axis": "shard", "seq": i // 2}
        if i % 3 == 0:
            span["link"] = ("inter_host", "intra_host")[i % 2]
        if i % 5 == 0:
            span["async"] = True
        recs.append(span)
    recs += [
        {"kind": "mem", "rank": 0, "bytes_in_use": 3 << 20,
         "peak_bytes_in_use": 4 << 20, "live_bytes": 1 << 20},
        {"kind": "mem", "event": "final", "live_bytes": 2048},
        {"kind": "overlap", "op": "halo_exchange", "overlap_frac": 0.25,
         "drain_s": 0.002},
        {"kind": "route", "op": "moe", "overflow_pct": 12.5,
         "occupancy_pct": 80.0, "imbalance": 1.25, "routed": 112,
         "dropped": 16},
        {"kind": "decode", "collective": "allreduce", "batch": 8,
         "heads": 8192, "us_per_op": float(rng.uniform(20, 60))},
        {"kind": "decode", "collective": "allgather", "batch": 1,
         "heads": 8192, "us_per_op": 33.0},
        {"kind": "time", "event": "progress", "phase": "kernel",
         "seconds": 0.5, "count": 3},
        {"kind": "time", "phase": "kernel", "seconds": 1.25, "count": 9},
        {"kind": "health", "event": "heartbeat", "seq": 1},
        {"kind": "health", "event": "straggler", "rank": 1},
        {"kind": "watchdog", "phase": "x"},
        {"kind": "finding", "class": "skew"},
        {"kind": "control", "event": "swap"},
        {"kind": "serve", "event": "window", "class": "decode:8",
         "arrivals": 10, "requests": 9, "errors": 1, "shed": 0,
         "queue_max": 3, "p50_ms": 1.5, "p99_ms": 4.0,
         "qd_p99_ms": 2.0, "svc_p99_ms": 1.0},
        {"kind": "serve", "event": "quarantine", "class": "decode:8"},
        {"kind": "bogus"}, {"no": "kind"}, "not a record",
    ]
    return recs


def _fed(cls, records, **kw):
    reg = cls(wall=lambda: 1000.0, clock=lambda: 50.0, **kw)
    for rec in records:
        reg.observe(rec)
    return reg


@pytest.mark.parametrize("seed", range(3))
def test_same_stream_renders_byte_equal(seed):
    recs = _stream(seed)
    mine, theirs = _fed(Mx.MetricsRegistry, recs), \
        _fed(JMx.MetricsRegistry, recs)
    text = X.render_openmetrics(mine)
    assert text == JX.render_openmetrics(theirs)
    # the tune_stale rule fired once an op, absorbed by the sinkless
    # registry
    assert 'tpumt_health_events_total{event="tune_stale"} 2' in text
    assert 'tpumt_span_link_bytes_total{link="inter_host"}' in text
    assert 'tpumt_decode_us_per_op{key="allreduce:8x8192"}' in text
    assert text.endswith("# EOF\n")
    assert list(mine.health_events) == list(theirs.health_events)


def test_series_cap_and_never_raises_as_jax():
    recs = [{"kind": "span", "op": f"op{i}", "seconds": 0.001}
            for i in range(40)]
    mine = _fed(Mx.MetricsRegistry, recs, max_series=16)
    theirs = _fed(JMx.MetricsRegistry, recs, max_series=16)
    assert X.render_openmetrics(mine) == JX.render_openmetrics(theirs)
    assert mine.value("tpumt_series_dropped") > 0
    mine.observe({"kind": "span", "seconds": object()})  # no raise


def test_health_sink_and_listeners(tmp_path):
    sunk, heard = [], []
    reg = Mx.MetricsRegistry(health_sink=sunk.append)
    reg.add_health_listener(heard.append)
    reg.add_health_listener(lambda rec: 1 / 0)  # swallowed
    for rec in _stream(0):
        reg.observe(rec)
    # the fired records went to the sink (they come back through the tee)
    assert [r["event"] for r in sunk] == ["tune_stale"] * 2
    assert [r["event"] for r in heard] == ["straggler"]


def test_comm_wait_watch_matches_jax():
    mine, theirs = Mx.MetricsRegistry(), JMx.MetricsRegistry()
    watches = [Mx.CommWaitWatch(mine), JMx.CommWaitWatch(theirs)]
    for w in watches:
        w.expected = 2
        w.clock_sync(0, {"spread_s": 1e-4})
        w.clock_sync(1, {"spread_s": 2e-4})
    rng = np.random.default_rng(3)
    for seq in range(12):
        for rank, offset in ((0, 0.0), (1, 0.5)):
            t0 = 100.0 + seq + offset + float(rng.uniform(0, 0.01))
            rec = {"kind": "span", "op": "allreduce", "axis": "shard",
                   "seq": seq, "world": 2, "t_start": t0,
                   "t_end": t0 + 0.003}
            for w in watches:
                w.span(rank, rec, offset)
    assert X.render_openmetrics(mine) == JX.render_openmetrics(theirs)
    assert mine.value("tpumt_comm_wait_frac", (("op", "allreduce"),)) > 0


def test_phase_progress_through_the_port_timers():
    """PhaseProgress on the port's phase hooks gives the records the JAX
    PhaseProgress gives for the same begin/end calls and clocks."""
    now = [0.0]
    recs_p, recs_j = [], []
    mine = Mx.PhaseProgress(recs_p.append, interval_s=0.0,
                            clock=lambda: now[0], wall=lambda: 10 + now[0])
    theirs = JMx.PhaseProgress(recs_j.append, interval_s=0.0,
                               clock=lambda: now[0],
                               wall=lambda: 10 + now[0])
    mine.start()
    try:
        t = timers.PhaseTimer()
        for i, name in enumerate(("a", "b", "a")):
            theirs(name, "begin")
            now[0] += 0.5
            with t.phase(name):
                now[0] += 0.25
            now[0] += 0.5
            theirs(name, "end")
            now[0] += 1.0
    finally:
        mine.stop()
    theirs.stop()
    assert mine not in timers._PHASE_HOOKS
    assert [r["phase"] for r in recs_p] == ["a", "b", "a", "a", "b"]
    assert [{k: r[k] for k in ("kind", "event", "phase", "count")}
            for r in recs_p] == [
        {k: r[k] for k in ("kind", "event", "phase", "count")}
        for r in recs_j]


def test_heartbeat_record_is_the_jax_one():
    recs = _stream(1) + [{"kind": "serve", "event": "window", "class": "c",
                          "queue_depth": 4}]
    mine = _fed(Mx.MetricsRegistry, recs)
    theirs = _fed(JMx.MetricsRegistry, recs)
    a = X.Heartbeat(mine, lambda r: None)._record(final=True)
    b = JX.Heartbeat(theirs, lambda r: None)._record(final=True)
    assert a == b
    # every record with a kind, and the two tune_stale records the
    # registry fired and absorbed
    assert a["records"] == 2 + len([r for r in recs if isinstance(r, dict)
                                    and isinstance(r.get("kind"), str)])
    assert {"p50_ms", "p99_ms", "hbm_bytes_in_use", "queue_depth"} <= set(a)


def test_heartbeat_thread_trail_and_final_marker():
    got = []
    hb = X.Heartbeat(Mx.MetricsRegistry(), got.append, interval_s=0.05)
    hb.start()
    time.sleep(0.3)
    hb.stop()
    assert len(got) >= 3 and got[-1].get("final") is True
    assert [r["seq"] for r in got] == list(range(1, len(got) + 1))
    X.Heartbeat(Mx.MetricsRegistry(), lambda r: 1 / 0)._emit()  # swallowed


# ---------------------------------------------------------------- exporter


def _get(port, path="/metrics"):
    return urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                  timeout=10)


def test_exporter_serves_the_exposition_on_port_0():
    reg = _fed(Mx.MetricsRegistry, _stream(2))
    exp = X.MetricsExporter(reg, 0, host="127.0.0.1").start()
    try:
        assert exp.port > 0
        with _get(exp.port) as r:
            body = r.read().decode()
            assert r.headers["Content-Type"] == X.CONTENT_TYPE \
                == JX.CONTENT_TYPE
        assert body == X.render_openmetrics(reg)
        with _get(exp.port, "/") as r:
            assert r.read().decode() == body
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(exp.port, "/nope")
        assert e.value.code == 404
    finally:
        exp.stop()
    exp.stop()  # idempotent


def test_live_threads_never_call_into_torch():
    """The exporter's threads (the server's and one a request) and the
    heartbeat's read only the registry: no torch function runs on them
    (a profile hook on every thread they start sees every call)."""
    calls, lock = [], threading.Lock()
    main = threading.get_ident()

    def prof(frame, event, arg):
        if threading.get_ident() == main:
            return
        if event == "call":
            mod = frame.f_globals.get("__name__", "")
        elif event == "c_call":
            mod = getattr(arg, "__module__", None) or ""
        else:
            return
        with lock:
            calls.append(mod)

    reg = Mx.MetricsRegistry()
    rep = Reporter(stream=io.StringIO())
    rep.attach_metrics(reg)
    for rec in _stream(0):
        if isinstance(rec, dict):
            rep.jsonl(rec)
    threading.setprofile(prof)
    try:
        exp = X.MetricsExporter(reg, 0, host="127.0.0.1").start()
        hb = X.Heartbeat(reg, rep.jsonl, interval_s=0.02).start()
        for _ in range(3):
            with _get(exp.port) as r:
                assert r.read().decode().endswith("# EOF\n")
        time.sleep(0.1)
        hb.stop()
        exp.stop()
    finally:
        threading.setprofile(None)
    assert calls
    assert not [m for m in calls if m.startswith("torch")], \
        sorted({m for m in calls if m.startswith("torch")})
    assert any(m == "tpu_mpi_tests_torch.instrument.export" for m in calls)


# ------------------------------------------------------------- the reporter


def test_reporter_tee_without_and_with_a_file(tmp_path):
    reg = Mx.MetricsRegistry()
    rep = Reporter(stream=io.StringIO())
    rep.attach_metrics(reg)
    assert rep.metrics is reg
    rep.line("x", {"kind": "span", "op": "a", "seconds": 0.5})
    assert reg.value("tpumt_spans", (("op", "a"),)) == 1
    rep2 = Reporter(stream=io.StringIO(), jsonl_path=str(tmp_path / "o.jsonl"))
    rep2.attach_metrics(reg)
    order = []
    rep2.attach_live(SimpleNamespace(stop=lambda: order.append("hb")),
                     SimpleNamespace(stop=lambda: 1 / 0),
                     SimpleNamespace(stop=lambda: rep2.jsonl(
                         {"kind": "health", "event": "heartbeat",
                          "final": True})))
    rep2.jsonl({"kind": "span", "op": "a", "seconds": 0.5})
    rep2.close()
    assert order == ["hb"]
    kinds = [json.loads(ln)["kind"] for ln in
             (tmp_path / "o.jsonl").read_text().splitlines()]
    assert kinds == ["span", "health"]  # the final record before close
    assert reg.value("tpumt_spans", (("op", "a"),)) == 2


def test_arm_metrics_stamps_the_process_index(tmp_path):
    """A spec that needs no mesh reports as rank 0 in every process: the
    live trail carries the process's own rank (and only rank 0, or every
    rank with --metrics-all-ranks, serves)."""
    rep = Reporter(rank=0, size=1, jsonl_path=str(tmp_path / "o.jsonl"),
                   proc_index=1, proc_count=2, stream=io.StringIO())
    _common._arm_metrics(SimpleNamespace(
        metrics_port=9000, metrics_interval=5.0, metrics_all_ranks=False),
        rep)
    assert rep.metrics is not None
    assert not any(isinstance(o, X.MetricsExporter) for o in rep._live)
    rep.close()
    recs = [json.loads(ln) for ln in
            Path(rep.jsonl_path).read_text().splitlines()]
    hb = [r for r in recs if r["kind"] == "health"]
    assert hb and all(r["rank"] == 1 for r in hb)
    assert rep.stream.getvalue() == ""
    # disarmed: nothing attached
    rep = Reporter(stream=io.StringIO())
    _common._arm_metrics(SimpleNamespace(metrics_port=None), rep)
    assert rep.metrics is None and rep._live == []


# ------------------------------------------------------------- the drivers


#: every entry point of the port that builds a reporter, at a small size
ARMED_RUNS = [
    ("drivers.daxpy", ["--n", "4096", "--iters", "3"]),
    ("drivers.mpi_daxpy", ["--n-total", "4096"]),
    ("drivers.mpi_daxpy_nvtx", ["--n-per-node", "4096"]),
    ("drivers.gather_inplace", ["--n-per-rank", "1024"]),
    ("drivers.envprobe", []),
    ("drivers.stencil1d", ["--n-global", "4096"]),
    ("drivers.stencil2d", ["--n-local", "16", "--n-other", "32",
                           "--n-iter", "2", "--n-warmup", "1"]),
    ("drivers.heat2d", ["--mesh", "1,1", "--nx-local", "16", "--ny-local",
                        "12", "--n-steps", "8"]),
    ("drivers.stencil2d_grid", ["--mesh", "1,1", "--nx-local", "16",
                                "--ny-local", "24", "--n-iter", "2",
                                "--n-warmup", "1"]),
    ("drivers.collbench", ["--collectives", "allgather", "--sizes-kib", "4",
                           "--n-iter", "10"]),
    ("drivers.attnbench", ["--tiers", "flash", "--seq-len", "64",
                           "--head-dim", "16", "--n-iter", "10"]),
    ("workloads.moe", ["--tokens", "64", "--d-model", "8", "--iters", "2"]),
    ("workloads.embedding", ["--vocab", "128", "--d-model", "8", "--batch",
                             "16", "--iters", "2"]),
    ("workloads.decode", ["--batches", "1", "--heads", "8", "--n-iter",
                          "20"]),
]


@pytest.mark.parametrize("module,argv", ARMED_RUNS, ids=lambda v: str(v))
def test_every_entry_point_runs_armed(tmp_path, module, argv):
    mod = importlib.import_module(f"tpu_mpi_tests_torch.{module}")
    jl = tmp_path / "m.jsonl"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(["--device", "cpu", *argv, "--metrics-port", "0",
                       "--metrics-interval", "0.05", "--jsonl", str(jl)])
    out = buf.getvalue()
    assert rc == 0, out
    assert re.search(r"METRICS rank 0: OpenMetrics at "
                     r"http://0\.0\.0\.0:\d+/metrics", out)
    recs = [json.loads(ln) for ln in jl.read_text().splitlines()]
    hb = [r for r in recs if r["kind"] == "health"
          and r["event"] == "heartbeat"]
    assert hb and hb[-1].get("final") is True and hb[-1]["rank"] == 0
    assert hb[-1]["records"] >= len(recs) - len(hb) - 1
    # the live threads are gone with the reporter
    assert not [t for t in threading.enumerate()
                if t.name in ("tpumt-heartbeat", "tpumt-metrics")]


@pytest.fixture(scope="module")
def armed_daxpy(tmp_path_factory):
    jl = tmp_path_factory.mktemp("armed") / "m.jsonl"
    from tpu_mpi_tests_torch.workloads import daxpy

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = daxpy.main(["--device", "cpu", "--n", "4096", "--iters", "3",
                         "--metrics-port", "0", "--metrics-interval",
                         "0.05", "--telemetry", "--jsonl", str(jl)])
    assert rc == 0
    return jl


def test_tpumt_top_follows_an_armed_port_run(armed_daxpy, capsys):
    """The JAX dashboard reads the port's live trail: its heartbeat
    panel shows rank 0's final beat, and one frame renders it."""
    dash = jlive.Dashboard()
    for ln in armed_daxpy.read_text().splitlines():
        dash.feed(json.loads(ln), str(armed_daxpy))
    assert dash.heartbeat[0]["final"] is True
    assert jlive.main([str(armed_daxpy)]) == 0
    frame = capsys.readouterr().out
    assert "tpumt-top" in frame and "BEAT" in frame


def test_armed_run_reports_each_phase_once(armed_daxpy):
    """Progress snapshots are not counted as phases by tpumt-report."""
    recs = [json.loads(ln) for ln in armed_daxpy.read_text().splitlines()]
    prog = [r for r in recs if r["kind"] == "time"
            and r.get("event") == "progress"]
    assert {r["phase"] for r in prog} >= {"copyInput", "kernel",
                                          "copyOutput"}
    s = jagg.summarize([str(armed_daxpy)])
    assert s["phases"]["kernel"]["count"] == 1
    # the same stream in both registries renders byte-equal
    mine = _fed(Mx.MetricsRegistry, recs)
    theirs = _fed(JMx.MetricsRegistry, recs)
    assert X.render_openmetrics(mine) == JX.render_openmetrics(theirs)
    assert mine.value("tpumt_phase_seconds", (("phase", "kernel"),)) > 0


BLOCKED = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name in ("tpu_mpi_tests_torch.instrument.metrics",
                    "tpu_mpi_tests_torch.instrument.export",
                    "tpu_mpi_tests_torch.serve",
                    "tpu_mpi_tests_torch.serve.histogram"):
            raise ImportError("live plane removed")
sys.meta_path.insert(0, Block())
from tpu_mpi_tests_torch.workloads.daxpy import main
sys.exit(main(sys.argv[1:]))
"""


def test_disarmed_run_is_a_build_without_the_live_plane(tmp_path):
    """Without --metrics-port the live modules are never imported: the
    run's output and JSONL, numbers masked, are those of a build where
    they cannot be imported."""
    plain = BLOCKED.replace("sys.meta_path.insert(0, Block())", "")
    outs, lines = [], []
    for code, name in ((BLOCKED, "a"), (plain, "b")):
        jl = tmp_path / f"{name}.jsonl"
        r = subprocess.run(
            [sys.executable, "-c", code, "--device", "cpu", "--n", "4096",
             "--iters", "3", "--telemetry", "--jsonl", str(jl)],
            cwd=REPO, capture_output=True, text=True, timeout=300,
            env={**os.environ, "PYTHONPATH": str(REPO)},
            # at low priority: timed tests share the host
            preexec_fn=lambda: os.nice(10))
        assert r.returncode == 0, r.stderr[-2000:]
        outs.append(r.stdout)
        lines.append(jl.read_text().splitlines())
    mask = re.compile(r"[0-9][0-9.e+-]*")

    def masked(text_lines):
        return [mask.sub("#", ln) for ln in text_lines
                if not ln.startswith("MANIFEST")
                and '"kind": "manifest"' not in ln]

    assert masked(outs[0].splitlines()) == masked(outs[1].splitlines())
    assert masked(lines[0]) == masked(lines[1])
    assert not [ln for ln in lines[1] if '"health"' in ln
                or '"progress"' in ln]
    assert "METRICS" not in outs[1]
