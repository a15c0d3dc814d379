"""The serving-era workloads of the port on the CPU, held against the JAX
package: MoE token routing (``comm/moe.py``), the sharded embedding
(``comm/embedding.py``) and the three specs ``moe``, ``embedding`` and
``decode`` with the runner's ``WORKLOAD`` row.

World 1 runs in this process; worlds 2 and 4 are one gloo world each for
the file (``tests/torch_dist_workers.py``, suite ``serving``), every case
run inside it. The JAX side runs on w of this process's fake devices.

Pairs and tolerances (all exact: routing copies and scales
integer-valued tokens, lookups copy rows, the scatter sums integer-valued
rows, the decode check sums rows of small integers):

* ``route_tokens`` (both ``moe/combine`` variants, float32, float64 and
  bfloat16, with and without overflow) against JAX ``route_reference``
  and against JAX ``route_tokens`` on the same inputs (its demand matrix
  too);
* the lookup (``take`` and ``onehot``) and ``EMBED_ITERS`` chained
  scatter-adds against the JAX functions and the dense reference;
* the specs' lines against the JAX spec's regular expressions (the
  ``DECODE`` pattern string is the JAX one, character for character),
  their ``route``/``embed``/``decode``/``workload`` records read by the
  JAX package's ``tpumt-report``, and ``--tune`` runs whose rank 0 sweeps
  and whose every rank runs the broadcast winner.
"""

import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_dist_workers as W
from tpu_mpi_tests.comm import embedding as JE
from tpu_mpi_tests.comm import moe as JM
from tpu_mpi_tests.comm.mesh import make_mesh
from tpu_mpi_tests.instrument import aggregate as jagg
from tpu_mpi_tests.workloads import decode as jdecode
from tpu_mpi_tests_torch.comm import embedding as E
from tpu_mpi_tests_torch.comm import moe as M
from tpu_mpi_tests_torch.drivers import collbench
from tpu_mpi_tests_torch.tune import registry as treg
from tpu_mpi_tests_torch.tune.fingerprint import fingerprint
from tpu_mpi_tests_torch.workloads import decode, embedding, moe, runner

WORLDS = (1, 2, 4)
#: the JAX spec tests' line patterns (tests/test_workloads.py), with the
#: world and token count left open
ROUTE_RE = (r"ROUTE moe: world=(\d+) capacity=(\d+) tokens=(\d+) "
            r"routed=(\d+) dropped=(\d+) overflow=([\d.]+)% "
            r"occupancy=([\d.]+)% imbalance=([\d.]+)")
EMBED_LOOKUP_RE = r"EMBED lookup: variant=(take|onehot) us_per_op=[\d.]+"
EMBED_SCATTER_RE = r"EMBED scatter: us_per_op=[\d.]+"
WORKLOAD_RE = {
    "moe": r"WORKLOAD moe: us_per_step=[\d.e+-]+ us",
    "embedding": r"WORKLOAD embedding: lookup_us_per_op=[\d.e+-]+ us",
    "decode": r"WORKLOAD decode: allreduce_us_per_op=[\d.e+-]+ us",
}
SPECS = ("moe", "embedding", "decode")


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The serving suite's output directory per world (world 1 in this
    process)."""
    out = {1: str(tmp_path_factory.mktemp("serving1"))}
    W.suite_serving(0, 1, out[1])
    treg.deconfigure()
    for w in WORLDS[1:]:
        out[w] = W.spawn("serving", w, tmp_path_factory.mktemp(f"serving{w}"))
    return out


def _mesh(w):
    return make_mesh({"shard": w}, devices=jax.devices()[:w])


def _jdtype(name):
    return {"float32": jnp.float32, "float64": jnp.float64,
            "bfloat16": jnp.bfloat16}[name]


def _f64(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float64))


def _text(d, case, rank=0):
    text = W.read_text(d, case, rank)
    assert text.startswith("RC 0\n"), text
    return text


def _records(d, case, w):
    files = [str(Path(d, f"{case}.jsonl"))] if w == 1 else [
        str(Path(d, f"{case}.p{r}.jsonl")) for r in range(w)]
    return files, [json.loads(line) for f in files
                   for line in Path(f).read_text().splitlines()]


# --------------------------------------------------------------- routing


@pytest.mark.parametrize("case", W.MOE_CASES, ids=lambda c: c[0])
@pytest.mark.parametrize("w", WORLDS)
def test_route_tokens_matches_jax(worlds, w, case):
    name, combine, dt = case[0], case[6], case[7]
    x, dest, cap = W.moe_inputs(case, w)
    got = W.join(worlds[w], f"moe_{name}", w)
    ref = JM.route_reference(x, dest, w, cap)
    np.testing.assert_array_equal(got, ref)
    mesh = _mesh(w)
    xs = jax.device_put(jnp.asarray(x, _jdtype(dt)),
                        NamedSharding(mesh, P("shard", None)))
    ds = jax.device_put(jnp.asarray(dest), NamedSharding(mesh, P("shard")))
    jy, jstats = JM.route_tokens(xs, ds, mesh, cap, combine=combine)
    np.testing.assert_array_equal(got, _f64(jy))
    for r in range(w):
        np.testing.assert_array_equal(
            W.load_rank(worlds[w], f"moe_{name}_counts", r), jstats.counts)
    stats = M.RouteStats(world=w, capacity=cap, counts=jstats.counts)
    assert stats.record(op="moe") == jstats.record(op="moe")


def test_route_stats_and_payload_model_are_the_jax_ones():
    counts = np.array([[5, 1, 0], [2, 2, 2], [0, 7, 1]], np.int64)
    for cap in (1, 2, 5):
        assert M.RouteStats(3, cap, counts).record(combine="x") == \
            JM.RouteStats(3, cap, counts).record(combine="x")
    x = torch.zeros((8, 6), dtype=torch.bfloat16)
    jx = jnp.zeros((8, 6), jnp.bfloat16)
    for w, cap, comb in ((1, 3, "alltoall"), (2, 4, "allgather"),
                         (4, 1, "alltoall"), (4, 2, "allgather")):
        assert M.route_payload_bytes(x, w, cap, comb) == \
            JM.route_payload_bytes(jx, w, cap, comb)


def test_route_refuses_a_zero_capacity():
    with pytest.raises(ValueError, match="capacity must be positive"):
        M.route_tokens(torch.ones((4, 2)), torch.zeros(4, dtype=torch.int32),
                       0)


# ------------------------------------------------------------- embedding


@pytest.mark.parametrize("case", W.EMBED_CASES, ids=lambda c: c[0])
@pytest.mark.parametrize("w", WORLDS)
def test_embedding_matches_jax(worlds, w, case):
    name, variant, dt = case[0], case[5], case[6]
    table, ids, upd = W.embed_inputs(case)
    mesh = _mesh(w)
    jdt = _jdtype(dt)
    tabs = jax.device_put(jnp.asarray(table, jdt),
                          NamedSharding(mesh, P("shard", None)))
    idr = jax.device_put(jnp.asarray(ids), NamedSharding(mesh, P()))
    jrows = _f64(JE.embedding_lookup(tabs, idr, mesh, variant=variant))
    np.testing.assert_array_equal(jrows, table[ids])
    for r in range(w):  # replicated on every rank
        np.testing.assert_array_equal(
            W.load_rank(worlds[w], f"embed_{name}_lookup", r), jrows)
    ids_s = jax.device_put(jnp.asarray(ids), NamedSharding(mesh, P("shard")))
    upd_s = jax.device_put(jnp.asarray(upd, jdt),
                           NamedSharding(mesh, P("shard", None)))
    jt = tabs
    for _ in range(W.EMBED_ITERS):
        jt = JE.embedding_scatter_add(jt, ids_s, upd_s, mesh)
    ref = table.copy()
    np.add.at(ref, ids, upd * W.EMBED_ITERS)
    got = W.join(worlds[w], f"embed_{name}_table", w)
    np.testing.assert_array_equal(_f64(jt), ref)
    np.testing.assert_array_equal(got, ref)


def test_scatter_add_accumulates_duplicates_as_jax():
    """Every id hits row 5: the duplicates accumulate (the JAX test's
    case at world 1)."""
    tab = torch.zeros((64, 4))
    ptr = tab.data_ptr()
    tab = E.embedding_scatter_add(tab, torch.full((8,), 5),
                                  torch.ones((8, 4)))
    # in place, as the JAX function donates its table
    assert tab.data_ptr() == ptr and float(tab[5, 0]) == 8.0
    assert float(tab.sum()) == 32.0


@pytest.mark.parametrize("knob,resolve,jresolve,ctx,other", [
    ("moe/combine", M.resolve_combine, JM.resolve_combine,
     dict(dtype="float32", n=64, world=1), "allgather"),
    ("embedding/lookup", E.resolve_lookup, JE.resolve_lookup,
     dict(dtype="float32", n=64, bytes=24, world=1), "onehot"),
])
def test_variant_precedence_explicit_cached_prior(tmp_path, knob, resolve,
                                                  jresolve, ctx, other):
    """explicit > cached > prior, a malformed cached value giving the
    prior (the JAX resolution); the priors are the JAX ones."""
    prior = treg.space(knob).prior
    assert prior == jresolve(None, **ctx) == resolve(None, **ctx)
    cache = treg.configure(cache_path=str(tmp_path / "c.json"))
    try:
        cache.store(knob, fingerprint(**ctx), other)
        assert resolve(None, **ctx) == other
        assert resolve(prior, **ctx) == prior
        cache.store(knob, fingerprint(**ctx), "bogus")
        assert resolve(None, **ctx) == prior
    finally:
        treg.deconfigure()


# ------------------------------------------------------------ the specs


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("w", WORLDS)
def test_spec_lines_parse_with_the_jax_patterns(worlds, w, spec):
    d = worlds[w]
    text = _text(d, spec)
    assert re.search(WORKLOAD_RE[spec], text), text
    if spec == "moe":
        m = re.search(ROUTE_RE, text)
        assert m and int(m.group(1)) == w and int(m.group(3)) == 128
        assert int(m.group(4)) + int(m.group(5)) == 128
    elif spec == "embedding":
        assert re.search(EMBED_LOOKUP_RE, text)
        assert re.search(EMBED_SCATTER_RE, text)
    else:
        rows = re.findall(jdecode.DECODE_LINE_RE, text)
        assert [(r[0], r[2]) for r in rows] == [
            (c, b) for c in ("allreduce", "allgather") for b in ("1", "4")]
        assert all(r[1] == "torch" and r[3] == "8" for r in rows)
        assert "GB/s" not in text
    # every rank runs the spec; rank 0 alone prints the ROUTE/EMBED
    # lines and the banner, each rank its own DECODE rows
    for r in range(1, w):
        other = _text(d, spec, r)
        assert re.search(WORKLOAD_RE[spec], other)
        assert ("ROUTE" in other) is False and ("EMBED" in other) is False


def test_decode_pattern_is_the_jax_one():
    assert decode.DECODE_LINE_RE == jdecode.DECODE_LINE_RE
    assert decode.DECODE_COLLS == jdecode.DECODE_COLLS


@pytest.mark.parametrize("w", WORLDS)
def test_spec_records_render_in_the_jax_report(worlds, w, capsys):
    d = worlds[w]
    files = []
    for spec in SPECS:
        f, recs = _records(d, spec, w)
        files += f
        rows = [r for r in recs if r["kind"] == "workload"]
        assert len(rows) == w and {r["workload"] for r in rows} == {spec}
        assert all(r["higher_better"] is False and r["unit"] == "us"
                   and r["world"] == w for r in rows)
        if spec == "moe":
            assert [r for r in recs if r["kind"] == "route"]
        if spec == "decode":
            dec = [r for r in recs if r["kind"] == "decode"]
            assert len(dec) == 4 * w and all(r["variant"] == "torch"
                                             for r in dec)
    s = jagg.summarize(files)
    assert list(s["route"]) == ["moe"] and s["route"]["moe"]["world"] == w
    assert len(s["decode"]) == 4
    assert {k.split(":")[0] for k in s["workload"]} == set(SPECS)
    assert jagg.main(files) == 0
    out = capsys.readouterr().out
    for tag in ("ROUTE moe: calls=", "DECODE allreduce", "WORKLOAD moe",
                "WORKLOAD embedding", "WORKLOAD decode"):
        assert tag in out, out


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("w", WORLDS)
def test_spec_tune_rank0_sweeps_every_rank_runs_the_winner(worlds, w,
                                                           spec):
    """``--tune``: one ``tune_result`` a knob and payload on rank 0
    (every candidate measured), the same winners on every rank, and the
    rows run what won."""
    d = worlds[w]
    case = f"{spec}_tune"
    _, recs = _records(d, case, w)
    by_rank = {}
    for r in recs:
        if r["kind"] in ("tune_result", "tune_hit"):
            by_rank.setdefault(r["rank"], []).append((r["knob"],
                                                      r["value"]))
    results = [r for r in recs if r["kind"] == "tune_result"]
    knobs = {"moe": {"moe/combine"}, "embedding": {"embedding/lookup"},
             "decode": {"coll_variant/allreduce",
                        "coll_variant/allgather"}}[spec]
    assert {r["knob"] for r in results} == knobs
    assert all(r["measured"] == len(treg.space(r["knob"]).candidates)
               for r in results if r["rank"] == 0)
    assert len(by_rank) == w
    assert all(v == by_rank[0] for v in by_rank.values())
    text = _text(d, case)
    assert re.search(WORKLOAD_RE[spec], text)
    if spec == "decode":
        rows = re.findall(jdecode.DECODE_LINE_RE, text)
        won = [v for k, v in by_rank[0]]
        assert [r[1] for r in rows] == won
    elif spec == "embedding":
        assert f"variant={by_rank[0][0][1]}" in text


# -------------------------------------------------- the runner, in process


def test_bench_row_only_after_a_passing_verify(monkeypatch, capsys,
                                               tmp_path):
    argv = ["--device", "cpu", "--batches", "1", "--heads", "8",
            "--n-iter", "20", "--colls", "allreduce", "--jsonl",
            str(tmp_path / "d.jsonl")]
    assert decode.main(argv) == 0
    out = capsys.readouterr().out
    assert re.search(WORKLOAD_RE["decode"], out)
    (row,) = [json.loads(line) for line in
              (tmp_path / "d.jsonl").read_text().splitlines()
              if '"workload"' in line]
    assert row["metric"] == "allreduce_us_per_op" and row["world"] == 1
    assert row["batch"] == 1 and row["heads"] == 8 and row["nbytes"] == 32
    monkeypatch.setattr(decode.DecodeSpec, "verify", lambda *a: 1)
    assert decode.main(argv[:-2]) == 1
    assert "WORKLOAD" not in capsys.readouterr().out


def test_spec_errors_exit_cleanly(capsys):
    assert decode.main(["--device", "cpu", "--colls", "nope",
                        "--n-iter", "20"]) == 2
    assert "ERROR unknown decode collective" in capsys.readouterr().out
    for mod, argv in ((moe, ["--tokens", "0"]),
                      (embedding, ["--batch", "0"]),
                      (decode, ["--batches", "0"]),
                      (decode, ["--n-iter", "5"])):
        with pytest.raises(SystemExit) as e:
            mod.main(["--device", "cpu", *argv])
        assert e.value.code == 2


def test_decode_declines_a_cached_variant_it_cannot_run(monkeypatch, capsys,
                                                        tmp_path):
    """A cached ``rdma`` winner that cannot run at a payload runs the
    library tier with the JAX NOTE (``using torch`` where the JAX spec
    says ``using xla``)."""
    path = str(tmp_path / "c.json")
    cache = treg.configure(cache_path=path)
    cache.store("coll_variant/allreduce",
                fingerprint(dtype="float32", bytes=32, world=1), "rdma")
    cache.save()
    treg.deconfigure()
    real = collbench.variant_refusal
    monkeypatch.setattr(collbench, "variant_refusal", lambda name, n, w: (
        "ring chunking" if name == "allreduce_rdma" else real(name, n, w)))
    assert decode.main(["--device", "cpu", "--batches", "1", "--heads", "8",
                        "--n-iter", "20", "--colls", "allreduce",
                        "--tune-cache", path]) == 0
    out = capsys.readouterr().out
    assert "TUNE coll_variant/allreduce cache-hit value=\"rdma\"" in out
    assert "NOTE decode allreduce: cached rdma variant infeasible at 32 B " \
        "(ring chunking); using torch" in out
    assert "DECODE allreduce[torch] batch=1" in out


#: the JAX serve driver's refusal of a world of several processes
SERVE_REFUSAL = (
    "ERROR serve mode is single-process only: batch composition depends "
    "on arrival/service timing and would diverge across ranks "
    "mid-collective (run one process, fake or real devices)")


@pytest.mark.parametrize("w", WORLDS)
def test_serve_driver_refuses_a_world_of_several_processes(worlds, w):
    """The serve driver serves at world 1; on every rank of a gloo world
    of 2 or 4 it prints the JAX driver's ERROR line and exits 2."""
    for rank in range(w):
        text = W.read_text(worlds[w], "serve", rank)
        if w == 1:
            assert text.startswith("RC 0\n"), text
            assert "SERVE daxpy:64:float32: offered=" in text
        else:
            assert text == f"RC 2\n{SERVE_REFUSAL}\n", text


def test_every_spec_registered_with_its_spaces():
    sp = treg.spaces()
    assert sp["moe/combine"].candidates == ("alltoall", "allgather")
    assert sp["embedding/lookup"].candidates == ("take", "onehot")
    assert runner.main(["--list"]) == 0
