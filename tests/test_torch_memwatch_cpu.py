"""The port's memwatch on the CPU: growth records from the live host
tensors, as the JAX memwatch writes them from its live-array walk.

A phase loop that grows what it holds writes one ``mem`` phase record at
the phase's first exit and one more at every exit whose live bytes grew
by more than 1 %, each with ``live_count``/``live_bytes``; the JAX
memwatch over the same loop with jax arrays writes the same number of
records. A ramp that dies without its final record is what the JAX
``tpumt-doctor`` convicts as ``oom``.
"""

import jax.numpy as jnp
import numpy as np
import torch

from tpu_mpi_tests.instrument import diagnose
from tpu_mpi_tests.instrument import memwatch as jmem
from tpu_mpi_tests.instrument import timers as jtimers
from tpu_mpi_tests_torch.instrument import memwatch
from tpu_mpi_tests_torch.instrument import timers

#: growth steps of the loop, 4 MiB of float32 each
GROWTHS = 6
GROWTH_ELEMS = 1 << 20


def _grow_torch(n_steps, step_elems):
    held = []
    t = timers.PhaseTimer()
    for _ in range(n_steps):
        with t.phase("grow"):
            held.append(torch.ones(step_elems))
    return held


def _grow_jax(n_steps, step_elems):
    held = []
    t = jtimers.PhaseTimer()
    for _ in range(n_steps):
        with t.phase("grow"):
            held.append(jnp.ones((step_elems,), jnp.float32).block_until_ready())
    return held


def _phase_recs(recs):
    return [r for r in recs if r.get("event") == "phase"]


def test_cpu_live_totals_walk_the_host_tensors():
    keep = torch.zeros(1000, 3)
    count, nbytes = memwatch._live_totals("cpu")
    c = memwatch.census(4, "cpu")
    assert count == c["count"] and nbytes == c["bytes"]
    assert nbytes >= keep.nbytes
    del keep


def test_phase_loop_writes_a_record_at_each_growth():
    recs = []
    w = memwatch.MemWatch(recs.append, device="cpu").start()
    try:
        held = _grow_torch(GROWTHS, GROWTH_ELEMS)
    finally:
        w.stop()
    phases = _phase_recs(recs)
    assert len(phases) == GROWTHS
    live = [r["live_bytes"] for r in phases]
    assert all(b - a >= GROWTH_ELEMS * 4 for a, b in zip(live, live[1:]))
    assert all("live_count" in r and "bytes_in_use" not in r
               for r in phases)
    assert "census" in phases[0] and "census" not in phases[1]

    # the JAX memwatch over the same loop with jax arrays
    jrecs = []
    jw = jmem.MemWatch(jrecs.append, interval_s=10.0).start()
    try:
        jheld = _grow_jax(GROWTHS, GROWTH_ELEMS)
    finally:
        jw.stop()
    jphases = _phase_recs(jrecs)
    assert len(jphases) == len(phases)
    jlive = [r["live_bytes"] for r in jphases]
    assert np.all(np.diff(jlive) >= GROWTH_ELEMS * 4)
    del held, jheld


def test_a_steady_loop_writes_one_phase_record():
    recs = []
    held = [torch.ones(GROWTH_ELEMS)]
    w = memwatch.MemWatch(recs.append, device="cpu").start()
    t = timers.PhaseTimer()
    for _ in range(5):
        with t.phase("steady"):
            held[0].add_(1.0)
    w.stop()
    assert [r["event"] for r in recs] == ["start", "phase", "final"]


def test_doctor_convicts_oom_from_a_dying_cpu_ramp(tmp_path):
    """A ramp that never reaches its final record (the process died):
    the JAX doctor reads the port's records and names ``oom`` on rank 0
    (the census-only fallback: growth ≥ 3× and still climbing)."""
    import json

    base = memwatch._live_totals("cpu")[1]
    step = max(GROWTH_ELEMS * 4, base // 2) // 4
    path = tmp_path / "ramp.jsonl"
    recs = []
    w = memwatch.MemWatch(lambda r: recs.append({**r, "rank": 0}),
                          device="cpu").start()
    try:
        held = _grow_torch(8, step)
    finally:
        # no stop(): the run died before its final record
        timers.remove_phase_hook(w._on_phase)
    with open(path, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
    assert "final" not in {r["event"] for r in recs}
    (f,) = diagnose.diagnose_files([str(path)])
    assert (f["class"], f["rank"]) == ("oom", 0)
    del held
