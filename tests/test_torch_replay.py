"""Traffic record and replay of the port (``serve/replay.py``), held
against the JAX package's: the same ``tpumt-traffic`` artifact, version
1, and the same fingerprint. An artifact saved by either package loads
in the other under the same identity, both refuse the same bad
artifacts with the same reasons, ``ReplayArrivals`` reproduces the same
schedule and class keys, and a port replay under a fake clock emits the
JAX loop's records for the same artifact, byte for byte.
"""

from __future__ import annotations

import json

import pytest

from tpu_mpi_tests.instrument import aggregate as jagg
from tpu_mpi_tests.serve import loop as JL
from tpu_mpi_tests.serve import replay as JR
from tpu_mpi_tests.serve import workloads as JW
from tpu_mpi_tests_torch.serve import arrival as A
from tpu_mpi_tests_torch.serve import loop as L
from tpu_mpi_tests_torch.serve import replay as R
from tpu_mpi_tests_torch.serve import workloads as W

EVENTS = [(0.0, "a:1:f32"), (0.25, "b:2:f32"), (0.25, "a:1:f32"),
          (1.5, "a:1:f32")]

#: event streams and durations the fingerprints are compared on
STREAMS = {
    "basic": (EVENTS, 2.0),
    "empty": ([], 0.0),
    "jittered": ([(t + 4e-8, k) for t, k in EVENTS], 2.0),
    "shifted": ([(1e-6, "a:1:f32")] + EVENTS[1:], 2.0),
    "long": ([(i * 0.0137, f"c{i % 3}:8:bfloat16") for i in range(500)],
             7.5),
}


def test_format_constants_equal_jax():
    assert (R.TRAFFIC_FORMAT, R.TRAFFIC_VERSION) == \
        (JR.TRAFFIC_FORMAT, JR.TRAFFIC_VERSION) == ("tpumt-traffic", 1)
    assert issubclass(R.TrafficFormatError, ValueError)


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_fingerprint_equals_jax(name):
    events, duration = STREAMS[name]
    assert R.traffic_fingerprint(events, duration) == \
        JR.traffic_fingerprint(events, duration)


def test_fingerprint_stable_and_sensitive():
    fp = R.traffic_fingerprint(EVENTS, 2.0)
    assert fp == R.traffic_fingerprint(STREAMS["jittered"][0], 2.0)
    assert fp != R.traffic_fingerprint(STREAMS["shifted"][0], 2.0)
    assert fp != R.traffic_fingerprint(EVENTS[:-1], 2.0)
    assert fp != R.traffic_fingerprint(EVENTS, 3.0)


def _artifact(pkg, events=EVENTS, duration=2.0):
    rec = pkg.TrafficRecorder(arrival="poisson", load="rate=40/s")
    for t, k in events:
        rec.add(t, k)
    return rec.finalize(duration)


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_artifacts_cross_load(tmp_path, name):
    """Saved by either package, loaded by both: the same document and
    fingerprint (the files themselves byte-equal)."""
    events, duration = STREAMS[name]
    mine, theirs = _artifact(R, events, duration), _artifact(JR, events,
                                                             duration)
    assert mine == theirs
    p_mine, p_theirs = tmp_path / "mine.json", tmp_path / "theirs.json"
    R.save_traffic(str(p_mine), mine)
    JR.save_traffic(str(p_theirs), theirs)
    assert p_mine.read_bytes() == p_theirs.read_bytes()
    for p in (p_mine, p_theirs):
        a, b = R.load_traffic(str(p)), JR.load_traffic(str(p))
        assert a == b and a["fingerprint"] == mine["fingerprint"]


def _bad_docs():
    art = _artifact(R)
    return {
        "not json": "{not json",
        "wrong format": {"format": "something-else", "version": 1},
        "not a dict": [1, 2],
        "version": {**art, "version": R.TRAFFIC_VERSION + 1},
        "short event": {**art, "events": [[0.0], [1.0, "k"]]},
        "string time": {**art, "events": [["x", "k"]]},
        "count": {**art, "count": art["count"] + 1},
        "not monotone": {**art, "events": [[1.0, "a:1:f32"],
                                           [0.5, "a:1:f32"]], "count": 2},
        "tampered": {**art, "events": [[t, "b:2:f32"]
                                       for t, _ in art["events"]]},
        "fingerprint": {**art, "fingerprint": "0" * 16},
    }


@pytest.mark.parametrize("case", sorted(_bad_docs()) + ["missing"])
def test_both_refuse_the_same_bad_artifacts(tmp_path, case):
    p = tmp_path / "t.json"
    if case != "missing":
        doc = _bad_docs()[case]
        p.write_text(doc if isinstance(doc, str) else json.dumps(doc))
    with pytest.raises(R.TrafficFormatError) as mine:
        R.load_traffic(str(p))
    with pytest.raises(JR.TrafficFormatError) as theirs:
        JR.load_traffic(str(p))
    assert str(mine.value) == str(theirs.value)


def test_replay_arrivals_equal_jax():
    """The same call sequence on both packages' ``ReplayArrivals`` gives
    the same answers."""
    art = _artifact(R)
    mine, theirs = R.ReplayArrivals(art), JR.ReplayArrivals(art)

    def script(r):
        out = [r.take_due(100.0), r.next_event()]
        r.start(10.0)
        out += [r.next_event(), r.take_due(10.3),
                [r.draw_class() for _ in range(3)],
                r.take_due(100.0, limit=11.0), r.next_event(),
                r.take_due(100.0), r.draw_class(), r.next_event(),
                r.draw_class()]
        r.on_complete(3, 12.0)
        r.start(0.0)
        out += [r.take_due(0.0), r.draw_class(), r.duration_s,
                r.fingerprint, r.classes]
        return out

    assert script(mine) == script(theirs)
    assert script(R.ReplayArrivals(art))[4] == ["a:1:f32", "b:2:f32",
                                                "a:1:f32"]


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def clock(self):
        return self.t

    def sleep(self, dt):
        self.t += dt


TABLE = "daxpy:128:float32:3,allreduce:64:float32:1"


def _loop_run(loop_mod, wl_mod, arrival, recorder=None, duration=6.0):
    clk = FakeClock()
    classes = wl_mod.parse_workload_table(TABLE)
    records = []

    def handler(n):
        clk.t += 0.001 * n

    loop = loop_mod.ServeLoop(
        classes, {c.key: handler for c in classes}, arrival,
        duration_s=duration, max_batch=8, window_s=2.0, seed=5,
        sink=records.append, recorder=recorder,
        clock=clk.clock, wall=clk.clock, sleep=clk.sleep)
    return records, loop.run()


def test_port_replay_equals_jax_replay():
    """Record a Poisson run in the port, replay the artifact in both
    loops: the record streams are byte-equal, the recorded per-class load
    is served, and a re-recording during the replay reproduces the
    artifact's fingerprint in either package."""
    rec = R.TrafficRecorder(arrival="poisson", load="test")
    _, rec_sum = _loop_run(L, W, A.OpenLoopPoisson(40.0, seed=5),
                           recorder=rec)
    art = rec.finalize(6.0)
    assert art["count"] == sum(s["arrivals"] for s in rec_sum)
    rerec, jrerec = (R.TrafficRecorder(arrival="replay", load="test"),
                     JR.TrafficRecorder(arrival="replay", load="test"))
    r1, s1 = _loop_run(L, W, R.ReplayArrivals(art), recorder=rerec)
    r2, s2 = _loop_run(JL, JW, JR.ReplayArrivals(art), recorder=jrerec)
    assert json.dumps(r1) == json.dumps(r2)
    assert {s["class"]: s["arrivals"] for s in s1} == art["classes"]
    assert rerec.finalize(6.0)["fingerprint"] == art["fingerprint"] == \
        jrerec.finalize(6.0)["fingerprint"]


def test_two_port_replays_diff_clean_in_the_jax_report(tmp_path):
    """``tpumt-report --diff`` (the JAX package's) between two fake-clock
    port replays exits 0; a degraded copy trips the gate."""
    rec = R.TrafficRecorder(arrival="poisson", load="test")
    _loop_run(L, W, A.OpenLoopPoisson(40.0, seed=5), recorder=rec)
    art = rec.finalize(6.0)

    def run_file(name, degrade=1.0):
        records, _ = _loop_run(L, W, R.ReplayArrivals(art))
        recs = [{"kind": "manifest", "process_index": 0,
                 "process_count": 1},
                {"kind": "traffic", "event": "replay",
                 "fingerprint": art["fingerprint"],
                 "count": art["count"], "duration_s": 6.0, "rank": 0}]
        for r in records:
            if degrade != 1.0 and r.get("kind") == "serve":
                r = {**r, **{k: r[k] * degrade for k in
                             ("p50_ms", "p95_ms", "p99_ms",
                              "qd_p99_ms", "svc_p99_ms") if k in r}}
            recs.append({**r, "rank": 0})
        p = tmp_path / name
        p.write_text("".join(json.dumps(r) + "\n" for r in recs))
        return str(p)

    a, b = run_file("a.jsonl"), run_file("b.jsonl")
    assert jagg.main(["--diff", a, b]) == 0
    assert jagg.main(["--diff", a, run_file("bad.jsonl", 10.0)]) == 1
