"""The port's online re-tune controller (``tune/controller.py``) held
against the JAX package's, and the ``coll/dispatch_depth`` knob.

* Under the same fake handlers, stale latches and clocks, both
  controllers emit the same ``tune_swap`` records (the real sweep engine
  picks the same winner), the same no-ops for classes without
  ``tune_info`` and for ops outside a handler, and the same bounded
  retries around a rebuild that raises.
* The port's ``decode`` handler re-swept over ``torch``, ``rdma`` and
  ``oneshot`` on the CPU (the hand kernels' plain versions) and swapped
  through ``registry.resolve``; the records render in the JAX
  ``tpumt-report`` CONTROL table, and the JAX ``tpumt-doctor`` exonerates
  the answered latch and convicts an unanswered one.
* ``coll/dispatch_depth`` resolves explicit > cached > prior with the
  device-only fallback, and ``collbench --tune`` on the CPU persists a
  winner.
"""

from __future__ import annotations

import json
import time

import pytest

from tpu_mpi_tests.instrument import aggregate as jagg
from tpu_mpi_tests.instrument import metrics as JMx
from tpu_mpi_tests.instrument.diagnose import diagnose_files
from tpu_mpi_tests.tune import controller as JCtl
from tpu_mpi_tests.tune import registry as jreg
from tpu_mpi_tests_torch.comm import collectives as C
from tpu_mpi_tests_torch.drivers import _common, collbench
from tpu_mpi_tests_torch.instrument import metrics as Mx
from tpu_mpi_tests_torch.tune import cache as tcache
from tpu_mpi_tests_torch.tune import controller as Ctl
from tpu_mpi_tests_torch.tune import priors
from tpu_mpi_tests_torch.tune import registry as treg
from tpu_mpi_tests_torch.tune.fingerprint import (
    device_fingerprint,
    fingerprint,
)

#: (the port's modules, the JAX package's)
PKGS = {"port": (Ctl, treg, Mx), "jax": (JCtl, jreg, JMx)}


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    monkeypatch.delenv("TPU_MPI_TUNE_CACHE", raising=False)
    treg.deconfigure()
    jreg.deconfigure()
    yield
    treg.deconfigure()
    jreg.deconfigure()


def _span(op, gbps):
    return {"kind": "span", "op": op, "nbytes": 1 << 20, "seconds": 0.01,
            "gbps": gbps}


def _latch_stale(reg, mx, op, base=10.0, sagged=1.0):
    """A tuned knob goes live, the op baselines at ``base`` GB/s, then a
    full rolling window sags to ``sagged``: the watch latches."""
    reg.observe({"kind": "tune_hit", "knob": "demo/knob", "value": 1})
    for _ in range(mx.STALE_SAMPLES):
        reg.observe(_span(op, base))
    for _ in range(mx.STALE_SAMPLES):
        reg.observe(_span(op, sagged))


def _teed(mx, records):
    """A registry whose health sink mirrors the reporter's wiring: the
    fired record lands in ``records`` and tees back through observe
    (which delivers it to the controller's latch)."""
    reg = mx.MetricsRegistry(wall=lambda: 50.0)
    reg.set_health_sink(lambda rec: (records.append(rec), reg.observe(rec)))
    return reg


class _FakeHandlers:
    """A rebuildable handler whose speed is keyed on the resolved
    candidate (the degraded-winner shape the controller exists for)."""

    def __init__(self, tr, timing, default):
        self.tr = tr
        self.timing = dict(timing)
        self.default = default
        self.built = []

    def build(self, value=None):
        eff = value if value is not None else self.tr.resolve(
            "demo/knob", prior=self.default)
        self.built.append(eff)
        cost = self.timing[eff]

        def step(k: int):
            time.sleep(cost * k)

        step.tune_info = {"knob": "demo/knob", "ctx": {},
                          "candidates": tuple(self.timing),
                          "rebuild": self.build}
        return step


def _closed_loop(pkg, tmp_path):
    """One latch → one re-sweep → one swap, under an injected clock and
    wall; returns (control records, tune candidates, the swapped build,
    resolution after, a re-latch after the reset fired)."""
    ctl_mod, tr, mx = PKGS[pkg]
    tr.configure(cache_path=str(tmp_path / f"{pkg}.json"), enabled=True)
    records = []
    reg = _teed(mx, records)
    fake = _FakeHandlers(tr, {"slow": 0.01, "fast": 0.0}, "slow")
    handlers = {"daxpy:64:float32": fake.build()}
    ctl = ctl_mod.TuneController(reg, handlers, sink=records.append,
                                 line=lambda s: None, budget_s=30.0,
                                 clock=lambda: 7.0, wall=lambda: 8.0)
    op = "serve:daxpy:64:float32"
    _latch_stale(reg, mx, op)
    old_step = handlers["daxpy:64:float32"]
    n = ctl.window_boundary(1000.0)
    control = [r for r in records if r.get("kind") == "control"]
    tunes = [r["candidate"] for r in records if r.get("kind") == "tune"]
    swapped = handlers["daxpy:64:float32"] is not old_step
    after = tr.resolve("demo/knob", prior="slow")
    _latch_stale(reg, mx, op, base=8.0, sagged=1.0)
    relatched = len([r for r in records if r.get("event") == "tune_stale"])
    tr.deconfigure()
    return {"swaps": n, "control": control, "tunes": tunes,
            "swapped": swapped, "built": fake.built[-1], "after": after,
            "relatched": relatched, "ctl_swaps": ctl.swaps}


def test_controller_closes_the_loop_as_jax_does(tmp_path):
    mine = _closed_loop("port", tmp_path)
    theirs = _closed_loop("jax", tmp_path)
    assert mine == theirs
    swap = mine["control"][0]
    assert mine["swaps"] == 1 and len(mine["control"]) == 1
    assert (swap["event"], swap["class"], swap["knob"], swap["old"],
            swap["new"], swap["t"], swap["resweep_s"]) == \
        ("tune_swap", "daxpy:64:float32", "demo/knob", "slow", "fast",
         1000.0, 0.0)
    assert sorted(mine["tunes"]) == ["fast", "slow"]
    assert mine["swapped"] and mine["built"] == mine["after"] == "fast"
    assert mine["relatched"] == 2  # the latch was reset after the swap


def test_controller_constants_equal_jax():
    assert Ctl.PROBE_REQUESTS == JCtl.PROBE_REQUESTS
    assert Ctl.RETUNE_RETRIES == JCtl.RETUNE_RETRIES


def _noop_case(pkg, tmp_path, op, with_info):
    ctl_mod, tr, mx = PKGS[pkg]
    tr.configure(cache_path=str(tmp_path / f"{pkg}.json"), enabled=True)
    records = []
    reg = _teed(mx, records)
    if with_info:
        step = _FakeHandlers(tr, {"a": 0.0}, "a").build()
    else:
        def step(k):
            return None
    handlers = {"daxpy:64:float32": step}
    ctl = ctl_mod.TuneController(reg, handlers, sink=records.append,
                                 line=lambda s: None)
    _latch_stale(reg, mx, op)
    n = ctl.window_boundary(1.0)
    tr.deconfigure()
    return (n, [r for r in records if r.get("kind") in ("control",
                                                         "tune")],
            handlers["daxpy:64:float32"] is step)


@pytest.mark.parametrize("op,with_info", [
    ("serve:daxpy:64:float32", False),  # no tune_info: never re-tuned
    ("halo_exchange", True),            # an op inside a handler
    ("serve:nosuch:1:float32", True)])  # a class the loop does not serve
def test_controller_noops_equal_jax(tmp_path, op, with_info):
    mine = _noop_case("port", tmp_path, op, with_info)
    assert mine == _noop_case("jax", tmp_path, op, with_info)
    assert mine == (0, [], True)


def _failing(pkg, tmp_path):
    ctl_mod, tr, mx = PKGS[pkg]
    tr.configure(cache_path=str(tmp_path / f"{pkg}.json"), enabled=True)
    lines = []
    reg = _teed(mx, [])

    def exploding(value=None):
        raise RuntimeError("rebuild blew up")

    def step(k):
        return None

    step.tune_info = {"knob": "demo/knob", "ctx": {},
                      "candidates": ("a", "b"), "rebuild": exploding}
    handlers = {"daxpy:64:float32": step}
    ctl = ctl_mod.TuneController(reg, handlers, sink=lambda r: None,
                                 line=lines.append)
    op = "serve:daxpy:64:float32"
    _latch_stale(reg, mx, op)
    counts = [ctl.window_boundary(t) for t in (1.0, 2.0, 3.0, 4.0)]
    errors = [len([ln for ln in lines if "RETUNE ERROR" in ln])]
    # retries spent: the watch was reset, so a fresh sag latches again
    # and gets the full retry budget
    _latch_stale(reg, mx, op, base=5.0, sagged=0.5)
    counts += [ctl.window_boundary(t) for t in (5.0, 6.0, 7.0, 8.0)]
    errors.append(len([ln for ln in lines if "RETUNE ERROR" in ln]))
    tr.deconfigure()
    return counts, errors, lines, handlers["daxpy:64:float32"] is step


def test_controller_survives_failing_rebuild_as_jax_does(tmp_path):
    mine = _failing("port", tmp_path)
    assert mine == _failing("jax", tmp_path)
    counts, errors, lines, kept = mine
    assert counts == [0] * 8 and errors == [3, 6] and kept
    assert lines[0] == ("RETUNE ERROR daxpy:64:float32: RuntimeError: "
                        "rebuild blew up")


def test_metrics_reset_stale_rebaselines():
    fired = []
    reg = Mx.MetricsRegistry(health_sink=fired.append)
    _latch_stale(reg, Mx, "serve:x")
    for _ in range(Mx.STALE_SAMPLES):
        reg.observe(_span("serve:x", 0.5))
    assert len(fired) == 1  # latched: more sag does not re-fire
    reg.reset_stale("serve:x")
    _latch_stale(reg, Mx, "serve:x", base=5.0, sagged=0.5)
    assert len(fired) == 2


# ---------------------------------------------------------------------------
# the decode handler re-tuned on the CPU
# ---------------------------------------------------------------------------


def _stale_rec(op, t):
    return {"kind": "health", "event": "tune_stale", "op": op,
            "signal": "gbps", "baseline": 10.0, "rolling": 1.0,
            "sag_pct": 90.0, "threshold_pct": 15.0, "n": 8,
            "knobs": ["coll_variant/allreduce"], "t": t}


def test_decode_handler_retuned_and_read_by_the_jax_tools(tmp_path,
                                                         capsys):
    """A stale latch for the decode class: the controller re-sweeps the
    three variants (each a rebuilt, warmed handler timed over a probe
    batch), persists the winner, rebuilds through ``registry.resolve``
    and writes one ``tune_swap``. The JSONL of the latches and the swap
    renders in the JAX report's CONTROL table; the JAX doctor exonerates
    the answered op and convicts the other."""
    import torch

    treg.configure(cache_path=str(tmp_path / "t.json"), enabled=True)
    records, lines = [], []
    reg = Mx.MetricsRegistry()
    reg.set_health_sink(lambda rec: (records.append(rec), reg.observe(rec)))
    step = _common.workload_factory("decode")(torch.device("cpu"), (4, 8),
                                              "float32")
    key = "decode:4x8:float32"
    handlers = {key: step, "daxpy:64:float32": lambda n: None}
    ctl = Ctl.TuneController(reg, handlers, sink=records.append,
                             line=lines.append, budget_s=30.0)
    reg.emit_health(_stale_rec(f"serve:{key}", 100.0))
    reg.emit_health(_stale_rec("serve:daxpy:64:float32", 100.0))
    assert ctl.window_boundary(101.0) == 1
    new = handlers[key]
    assert new is not step
    swap = [r for r in records if r.get("kind") == "control"][0]
    assert (swap["class"], swap["knob"], swap["old"]) == \
        (key, "coll_variant/allreduce", "torch")
    assert swap["new"] in ("torch", "rdma", "oneshot")
    assert new.tune_info["variant"] == swap["new"]
    assert sorted(r["candidate"] for r in records
                  if r.get("kind") == "tune") == ["oneshot", "rdma",
                                                  "torch"]
    assert treg.lookup("coll_variant/allreduce", device_fallback=False,
                       **step.tune_info["ctx"]) == swap["new"]
    new(3)
    assert torch.equal(new.state["x"], torch.ones(32))
    assert lines[-1].startswith(f"RETUNE {key}: coll_variant/allreduce "
                                f"'torch' -> ")
    f = tmp_path / "run.jsonl"
    recs = [{"kind": "manifest", "process_index": 0, "process_count": 1}]
    recs += [{**r, "rank": 0} for r in records]
    recs += [{"kind": "span", "op": "x", "seconds": 0.01, "world": 1,
              "t_start": 200.0, "t_end": 200.01},
             {"kind": "telemetry_summary", "op": "x", "rank": 0,
              "t": 201.0}]
    f.write_text("".join(json.dumps(r) + "\n" for r in recs))
    assert jagg.main([str(f)]) == 0
    out = capsys.readouterr().out
    row = [ln for ln in out.splitlines() if ln.startswith("CONTROL")]
    assert row and f"tune_swap {key}" in row[0] and "n=1" in row[0], out
    findings = diagnose_files([str(f)])
    assert [(x["class"], x["last_op"]) for x in findings] == [
        ("stale_schedule", "serve:daxpy:64:float32")]


# ---------------------------------------------------------------------------
# coll/dispatch_depth
# ---------------------------------------------------------------------------

CTX = {"dtype": "float32", "n": 4096, "world": 1}


def test_dispatch_depth_precedence(tmp_path):
    """explicit > cached (the full fingerprint, then the device-only one)
    > prior; a malformed cached value gives the prior."""
    assert C.resolve_dispatch_depth(None, **CTX) == \
        priors.COLL_DISPATCH_DEPTH == 1
    cache = treg.configure(cache_path=str(tmp_path / "t.json"))
    cache.store("coll/dispatch_depth", device_fingerprint(), 4)
    assert C.resolve_dispatch_depth(None, **CTX) == 4  # device fallback
    cache.store("coll/dispatch_depth", fingerprint(**CTX), 2)
    assert C.resolve_dispatch_depth(None, **CTX) == 2  # the full key
    assert C.resolve_dispatch_depth(8, **CTX) == 8     # explicit
    assert C.resolve_dispatch_depth(None, dtype="bfloat16", n=64,
                                    world=1) == 4
    cache.store("coll/dispatch_depth", fingerprint(**CTX), "deep")
    assert C.resolve_dispatch_depth(None, **CTX) == 1  # malformed
    cache.store("coll/dispatch_depth", fingerprint(**CTX), 0)
    assert C.resolve_dispatch_depth(None, **CTX) == 1  # at least 1
    assert "coll/dispatch_depth" in treg.spaces()
    assert treg.space("coll/dispatch_depth") is C.COLL_DISPATCH_SPACE


def test_collbench_tune_persists_a_dispatch_depth(tmp_path, capsys):
    path = str(tmp_path / "t.json")
    assert collbench.main(["--device", "cpu", "--collectives", "allreduce",
                           "--sizes-kib", "4,64", "--n-iter", "20",
                           "--tune", "--tune-cache", path,
                           "--tune-budget", "30"]) == 0
    out = capsys.readouterr().out
    assert "TUNE coll/dispatch_depth winner=" in out, out
    treg.deconfigure()
    cache = tcache.ScheduleCache.load(path)
    ctx = {"dtype": "float32", "bytes": 4096, "world": 1}
    winner = cache.lookup("coll/dispatch_depth", fingerprint(**ctx))
    assert winner in (1, 2, 4, 8)
    # stored under the device-only key too: every chained site resolves it
    assert cache.lookup("coll/dispatch_depth", device_fingerprint()) \
        == winner
    treg.configure(cache_path=path)
    assert _common.workload_factory("halo")(
        __import__("torch").device("cpu"), (4096,), "float32").depth \
        == winner
    # a second --tune run hits the cache instead of sweeping again
    assert collbench.main(["--device", "cpu", "--collectives", "allreduce",
                           "--sizes-kib", "4", "--n-iter", "20",
                           "--tune", "--tune-cache", path]) == 0
    out = capsys.readouterr().out
    assert "TUNE coll/dispatch_depth cache-hit" in out, out
