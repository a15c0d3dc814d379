"""The schedule plane over gloo worlds of 2 and 4 ranks (CPU), held
against the JAX package.

One world per size is spawned for the file (``tests/torch_dist_workers.py``,
suite ``tune``). In it: ``fleet.bcast``; a fleet sweep whose stubbed
per-rank measures differ, after which every rank applies rank 0's winner;
the budget cut and the cache-hit decision broadcast from rank 0; the one
cache writer; ``stencil2d --iterate-tier auto --tune`` (rank 0 sweeps
the tiers, every rank runs the winner), its cache-hit rerun and the
explicit winner; and a broadcast rank 0 never answers. The JAX driver
runs at ``--fake-devices w`` in one subprocess per world, tuned and at the
port's winner; the runs are compared on their outputs (the tiers' gates
and error norms), never on timings, since each package's winner is its
own clock's.
"""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

import torch_dist_workers as W

WORLDS = (2, 4)
REPO = Path(__file__).resolve().parents[1]
#: the eigen gate's float64 error norms of two runs of one tier agree to
#: well inside the gate (3.5e-14 at these sizes)
rel_tol = 1e-15

JAX_DRIVER = r"""
import contextlib, io, os, sys
os.nice(10)
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_cpu_multi_thread_eigen=false")
w, out, winner = int(sys.argv[1]), sys.argv[2], sys.argv[3]
argv = sys.argv[4:]
from tpu_mpi_tests.drivers import stencil2d
for case, extra in (("tuned", ["--iterate-tier", "auto", "--tune",
                               "--tune-cache",
                               os.path.join(out, "jax_tune.json")]),
                    ("winner", ["--iterate-tier", winner])):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = stencil2d.main(["--fake-devices", str(w)] + argv + extra)
    with open(os.path.join(out, case + ".txt"), "w") as f:
        f.write(f"RC {rc}\n" + buf.getvalue())
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per world: (port out dir, JAX out dir, every rank's results)."""
    out = {}
    for w in WORLDS:
        d = W.spawn("tune", w, tmp_path_factory.mktemp(f"tune{w}"))
        res = [json.loads(Path(d, f"tune_results.r{r}.txt").read_text())
               for r in range(w)]
        out[w] = (d, res)
    procs = {}
    for w in WORLDS:
        jd = str(tmp_path_factory.mktemp(f"tune_jax{w}"))
        winner = W.tune_winner(W.read_text(out[w][0], "tune_sweep", 0))
        procs[w] = (jd, subprocess.Popen(
            [sys.executable, "-c", JAX_DRIVER, str(w), jd, winner,
             *W.TUNE_DRIVER_ARGV], cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    for w, (jd, proc) in procs.items():
        text, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, text
        out[w] = (out[w][0], jd, out[w][1])
    return out


def _rel(text):
    return float(re.search(r"ITER ERR rel=([\d.e+-]+)", text).group(1))


@pytest.mark.parametrize("w", WORLDS)
def test_fleet_bcast_reaches_every_rank(runs, w):
    _, _, res = runs[w]
    for r, rr in enumerate(res):
        assert rr["count"] == [w, r]
        assert rr["bcast"] == {"from": 0, "v": [1, 2]}


@pytest.mark.parametrize("w", WORLDS)
def test_fleet_sweep_every_rank_applies_rank0s_winner(runs, w):
    out, _, res = runs[w]
    rank0 = min(W.TUNE_TIMINGS, key=W.TUNE_TIMINGS.get)
    mine = min(W.TUNE_TIMINGS, key=lambda c: 10.0 - W.TUNE_TIMINGS[c])
    assert rank0 != mine
    result = res[0]["records"][-1]
    assert result["kind"] == "tune_result" and result["value"] == rank0
    assert [r["kind"] for r in res[0]["records"]] == ["tune"] * 4 + [
        "tune_result"]
    for r, rr in enumerate(res):
        assert rr["winner"] == rank0
        assert rr["read_only"] == (r != 0)
        if r:  # rank 0 alone emits the per-candidate records
            assert rr["records"] == [result]
    # rank 0 alone writes its cache
    doc = json.loads(Path(out, "tc.r0.json").read_text())
    assert {e["value"] for e in doc["entries"].values()
            if e["knob"] == "demo/fleet"} == {rank0}
    assert not any(Path(out, f"tc.r{r}.json").exists() for r in range(1, w))


@pytest.mark.parametrize("w", WORLDS)
def test_fleet_budget_and_hit_decisions_are_rank0s(runs, w):
    _, _, res = runs[w]
    rank0 = min(W.TUNE_TIMINGS, key=W.TUNE_TIMINGS.get)
    skips = [r for r in res[0]["budget_records"]
             if r.get("skipped") == "budget"]
    assert [r["candidate"] for r in skips] == ["x", "y"]
    for rr in res:
        assert rr["budget_winner"] == "p" and rr["budget_measured"] == ["p"]
        assert rr["budget_records"][-1]["skipped"] == 2
        # only rank 0's cache holds the winner: every rank takes the hit
        assert rr["hit"] == rank0 and rr["hit_measured"] == []
        assert [r["kind"] for r in rr["hit_records"]] == ["tune_hit"]


@pytest.mark.parametrize("w", WORLDS)
def test_fleet_timeout_names_the_tag(runs, w):
    _, _, res = runs[w]
    for rr in res[1:]:
        assert "fleet broadcast 'lonely'" in rr["timeout"]
        assert "TPU_MPI_FLEET_TIMEOUT_S" in rr["timeout"]
    assert res[0]["timeout"] == 0  # rank 0 posts and returns its own


@pytest.mark.parametrize("w", WORLDS)
def test_stencil2d_tuned_tier_on_every_rank_against_jax(runs, w):
    out, jd, _ = runs[w]
    texts = {case: [W.read_text(out, case, r) for r in range(w)]
             for case in ("tune_sweep", "tune_hit", "tune_explicit")}
    winner = W.tune_winner(texts["tune_sweep"][0])
    for case, ranks in texts.items():
        for text in ranks:
            assert text.startswith("RC 0\n") and "FAIL" not in text, text
            assert W.tune_winner(text) == winner
            assert "ITER BITWISE fused==chained over 3 calls: OK" in text
    # the sweep on rank 0, its result on every rank; then a pure hit
    assert f"TUNE stencil/tier resolved -> {winner} (sweep; blocks=" in \
        texts["tune_sweep"][0]
    for text in texts["tune_sweep"]:
        assert f'TUNE stencil/tier winner="{winner}"' in text
    for text in texts["tune_hit"]:
        assert f'TUNE stencil/tier cache-hit value="{winner}"' in text
        assert "winner=" not in text
    assert Path(out, "drv.r0.json").exists()
    assert not any(Path(out, f"drv.r{r}.json").exists()
                   for r in range(1, w))
    # the tuned run's field is the explicit tier's: the same error norm
    # on every rank of every run
    rels = {_rel(t) for ranks in texts.values() for t in ranks}
    assert len(rels) == 1, rels
    # and the JAX driver's at the same tier, within the gate's precision
    jax_winner = Path(jd, "winner.txt").read_text()
    assert jax_winner.startswith("RC 0\n") and \
        f"ITER tier={winner} steps=2 n={24 * w}x16 world={w}" in jax_winner
    assert abs(_rel(jax_winner) - rels.pop()) <= rel_tol
    jax_tuned = Path(jd, "tuned.txt").read_text()
    assert jax_tuned.startswith("RC 0\n") and \
        "TUNE stencil/tier winner=" in jax_tuned
    for text in (jax_winner, jax_tuned):
        assert "ITER BITWISE fused==chained over 3 calls: OK" in text


#: the knobs rank 0 sweeps in the spawned world's knob runs (collbench
#: --tune prices the dispatch window's depth too)
FLEET_KNOBS = ("coll/dispatch_depth", "coll_variant/allgather",
               "coll_variant/allreduce", "ring/pipeline_depth", "ring/tier",
               "daxpy/chunk")


@pytest.mark.parametrize("w", WORLDS)
def test_knob_owners_rank0_sweeps_every_rank_applies(runs, w):
    d, _, res = runs[w]
    for case in ("knobs_coll", "knobs_attn", "knobs_daxpy"):
        for r in range(w):
            text = W.read_text(d, case, r)
            assert text.startswith("RC 0\n"), text
    recs = {r: [json.loads(ln) for ln in
                Path(d, f"knobs.p{r}.jsonl").read_text().splitlines()]
            for r in range(w)}
    winners = {r: {rec["knob"]: rec["value"] for rec in recs[r]
                   if rec["kind"] == "tune_result"} for r in range(w)}
    for r in range(w):
        # every rank applied the same broadcast winner of every knob
        assert set(winners[r]) == set(FLEET_KNOBS)
        assert winners[r] == winners[0]
        # only rank 0 measured
        measured = [rec for rec in recs[r] if rec["kind"] == "tune"]
        assert bool(measured) == (r == 0)
        # a ring depth above the world is declined with its reason (the
        # ring clamps the depth) and never wins
        depth = {rec["candidate"]: rec for rec in measured
                 if rec["knob"] == "ring/pipeline_depth"}
        if r == 0:
            assert set(depth) == {1, 2, 4}
            for cand, rec in depth.items():
                assert (rec["seconds"] is None) == (cand > w), rec
                if cand > w:
                    assert f"clamps the depth to the world ({w})" in \
                        rec["error"]
        assert winners[r]["ring/pipeline_depth"] <= w
        # each rank's file, three runs, each opened by its own manifest,
        # topo and clock_sync (the barrier-echo handshake)
        kinds = [rec["kind"] for rec in recs[r]]
        assert kinds.count("manifest") == 3
        syncs = [rec for rec in recs[r] if rec["kind"] == "clock_sync"]
        assert len(syncs) == 3
        assert all(rec["method"] == "barrier_echo" and rec["rank"] == r
                   and rec["process_count"] == w for rec in syncs)
        # collbench's auto rows ran the winners, on every rank
        rows = [rec for rec in recs[r] if rec["kind"] == "coll"]
        assert [rec["collective"] for rec in rows] == [
            b if winners[0][f"coll_variant/{b}"] == "torch"
            else f"{b}_{winners[0][f'coll_variant/{b}']}"
            for b in ("allgather", "allreduce")]
        assert all(rec["auto"] for rec in rows)
        # the daxpy checksum is the one application's, whatever the chunk
        assert "SUM = 524800.000000" in W.read_text(d, "knobs_daxpy", r)
    # the one cache writer
    assert [rr["knobs_cache_written"] for rr in res] == [True] + [False] * (
        w - 1)
