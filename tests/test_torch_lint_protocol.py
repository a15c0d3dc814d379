"""The port's linter against runtime streams and the JAX package's record
contract.

* ``--conform`` on the CPU: one gloo world of two ranks (spawned for the
  file, ``tests/torch_dist_workers.py`` suite ``conform``) runs stencil2d
  and collbench with ``--telemetry --jsonl``; each driver's two rank
  streams conform to the automaton compiled from the port's tree, and a
  copy of rank 1's stream cut before its last collective span convicts
  TPM1705. The whole tree's automaton takes a dynamically named span as a
  wildcard, so a swapped op convicts against a tight two-collective tree
  (the shape of the JAX package's own conformance tests).
* The records table: for every record kind both packages produce, every
  field a JAX producer writes, a port producer writes too.
"""

import json
import shutil
from pathlib import Path

import pytest

import torch_dist_workers as W
from tpu_mpi_tests_torch.analysis import cli
from tpu_mpi_tests_torch.analysis.core import collect_project
from tpu_mpi_tests_torch.analysis.protocol import (
    ScheduleAutomaton,
    conform_paths,
)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "tpu_mpi_tests_torch"
DRIVERS = ("stencil2d", "collbench")


@pytest.fixture(autouse=True)
def _hermetic_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_MPI_LINT_CACHE", str(tmp_path / "_lc.json"))


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    out = Path(W.spawn("conform", 2, tmp_path_factory.mktemp("conform")))
    for drv in DRIVERS:
        for rank in (0, 1):
            text = W.read_text(str(out), drv, rank)
            assert text.startswith("RC 0"), text[-2000:]
    return out


@pytest.fixture(scope="module")
def port_project(tmp_path_factory):
    cache = str(tmp_path_factory.mktemp("lc") / "cache.json")
    return collect_project([str(PORT)], cache_path=cache), cache


def _records(path: Path) -> list[dict]:
    return [json.loads(line) for line in path.read_text().splitlines()]


def _write(path: Path, recs: list[dict]) -> str:
    path.write_text("".join(json.dumps(r) + "\n" for r in recs))
    return str(path)


@pytest.mark.parametrize("drv", DRIVERS)
def test_world2_streams_conform_to_the_port_tree(world2, port_project,
                                                 drv):
    proj, _cache = port_project
    auto = ScheduleAutomaton(proj)
    for rank in (0, 1):
        recs = _records(world2 / f"{drv}.p{rank}.jsonl")
        assert recs[0]["kind"] == "manifest"
        assert recs[0]["process_index"] == rank
        spans = [r for r in recs if r["kind"] == "span"]
        assert spans and all("seq" in r for r in spans)
        assert any(r["op"] in auto.modeled_ops for r in spans)
    # the base path expands to both rank files
    findings, notes = conform_paths([str(world2 / f"{drv}.jsonl")], proj)
    assert findings == [], findings
    assert not any("insufficient stamps" in n or "no span" in n
                   for n in notes), notes


@pytest.mark.parametrize("drv", DRIVERS)
def test_stream_cut_before_its_last_collective_convicts_tpm1705(
        world2, port_project, tmp_path, drv):
    proj, _cache = port_project
    modeled = ScheduleAutomaton(proj).modeled_ops
    shutil.copy(world2 / f"{drv}.p0.jsonl", tmp_path / f"{drv}.p0.jsonl")
    recs = _records(world2 / f"{drv}.p1.jsonl")
    last = max(i for i, r in enumerate(recs)
               if r["kind"] == "span" and r["op"] in modeled)
    _write(tmp_path / f"{drv}.p1.jsonl", recs[:last])
    findings, _notes = conform_paths([str(tmp_path / f"{drv}.jsonl")],
                                     proj)
    assert [f.code for f in findings] == ["TPM1705"], findings
    f = findings[0]
    assert f.path.endswith(f"{drv}.p1.jsonl")
    assert "rank 1" in f.message and "sibling rank 0" in f.message
    assert f"op={recs[last]['op']!r}" in f.message


def test_cli_conform_exit_codes_on_the_world2_streams(world2, port_project,
                                                      tmp_path, capsys):
    _proj, cache = port_project
    base = str(world2 / "stencil2d.jsonl")
    assert cli.main(["--conform", base, "--conform-tree", str(PORT),
                     "--cache", cache]) == 0
    capsys.readouterr()
    shutil.copy(world2 / "stencil2d.p0.jsonl", tmp_path / "s.p0.jsonl")
    recs = _records(world2 / "stencil2d.p1.jsonl")
    last = max(i for i, r in enumerate(recs) if r["kind"] == "span")
    _write(tmp_path / "s.p1.jsonl", recs[:last])
    assert cli.main(["--conform", str(tmp_path / "s.jsonl"),
                     "--conform-tree", str(PORT), "--cache", cache]) == 1
    assert "TPM1705" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# a tight two-collective tree: the swapped and truncated shapes
# ---------------------------------------------------------------------------

PAIR = [("allreduce", "shard"), ("reduce_scatter", "shard")]


def _pair_tree(tmp_path: Path) -> str:
    """``allreduce`` then ``reduce_scatter``, once each, under their
    spans: the tightest automaton a stream can leave."""
    pkg = tmp_path / "duo"
    pkg.mkdir()
    (pkg / "__init__.py").write_text('"""A two-collective schedule."""\n')
    (pkg / "pair.py").write_text(
        "import torch.distributed as dist\n"
        "\n"
        "from tpu_mpi_tests_torch.instrument.telemetry import comm_span\n"
        "\n"
        "\n"
        "def pair(x, out):\n"
        '    with comm_span("allreduce", axis_name="shard"):\n'
        "        dist.all_reduce(x)\n"
        '    with comm_span("reduce_scatter", axis_name="shard"):\n'
        "        dist.reduce_scatter_tensor(out, x)\n"
        "    return out\n"
    )
    return str(tmp_path / "duo")


def _stream(path: Path, rank: int, events, seq: bool = True) -> str:
    recs = [{"kind": "manifest", "process_index": rank,
             "process_count": 2}]
    counters: dict = {}
    for op, axis in events:
        rec = {"kind": "span", "op": op, "axis": axis, "seconds": 0.001}
        if seq:
            rec["seq"] = counters.get((op, axis), 0)
            counters[(op, axis)] = rec["seq"] + 1
        recs.append(rec)
    return _write(path, recs)


def test_pair_streams_conform(tmp_path):
    proj = collect_project([_pair_tree(tmp_path)])
    s0 = _stream(tmp_path / "s.p0.jsonl", 0, PAIR)
    s1 = _stream(tmp_path / "s.p1.jsonl", 1, PAIR)
    assert conform_paths([s0, s1], proj) == ([], [])


def test_swapped_op_convicts_tpm1704(tmp_path):
    proj = collect_project([_pair_tree(tmp_path)])
    s0 = _stream(tmp_path / "s.p0.jsonl", 0, PAIR[::-1])
    findings, _notes = conform_paths([s0], proj)
    assert [f.code for f in findings] == ["TPM1704"], findings
    assert "after 0 matched event" in findings[0].message
    assert "op='reduce_scatter'" in findings[0].message
    assert "allreduce" in findings[0].message  # the expected next op


def test_truncated_pair_stream_convicts_tpm1705(tmp_path):
    proj = collect_project([_pair_tree(tmp_path)])
    s0 = _stream(tmp_path / "s.p0.jsonl", 0, PAIR)
    s1 = _stream(tmp_path / "s.p1.jsonl", 1, PAIR[:1])
    findings, _notes = conform_paths([s0, s1], proj)
    assert [f.code for f in findings] == ["TPM1705"], findings
    assert "op='reduce_scatter'" in findings[0].message


def test_stream_without_seq_stamps_is_a_note_never_a_finding(tmp_path,
                                                             capsys):
    tree = _pair_tree(tmp_path)
    s0 = _stream(tmp_path / "s.p0.jsonl", 0, PAIR[::-1], seq=False)
    assert cli.main(["--conform", s0, "--conform-tree", tree,
                     "--no-cache"]) == 0
    assert "insufficient stamps" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the records contract against the JAX package
# ---------------------------------------------------------------------------

#: fields a JAX producer writes that the port's producers do not, each
#: with its reason: (kind, field) -> why
RECORD_EXCEPTIONS = {
    ("manifest", "jax"): "the JAX version; the port records torch's",
    ("manifest", "jaxlib"): "the jaxlib version; the port records CUDA's",
    ("manifest", "libtpu"): "the TPU runtime's version: no TPU here",
}


def test_port_producers_write_every_field_the_jax_producers_write():
    from tpu_mpi_tests.analysis.records import collect as jax_collect
    from tpu_mpi_tests_torch.analysis.records import collect

    jax_kinds, jax_stamps = jax_collect(
        [str(REPO / "tpu_mpi_tests"), str(REPO / "tpu")], REPO)
    kinds, stamps = collect([str(PORT)], REPO)
    assert jax_stamps["fields"] <= stamps["fields"]
    shared = set(jax_kinds) & set(kinds)
    assert {"span", "mem", "manifest", "clock_sync", "tune",
            "tune_result", "health"} <= shared
    missing = {
        (k, field) for k in shared
        for field in jax_kinds[k]["fields"] - kinds[k]["fields"]
        - stamps["fields"]
    }
    assert missing == set(RECORD_EXCEPTIONS), missing
    # the memwatch fields the port writes through a helper count
    assert {"devices", "bytes_in_use", "peak_bytes_in_use"} <= \
        kinds["mem"]["fields"]


def test_records_cli_prints_the_table_and_writes_only_where_asked(
        tmp_path, capsys):
    from tpu_mpi_tests_torch.analysis import records

    before = (REPO / "RECORDS.md").read_text()
    assert records.main([str(PORT)]) == 0
    out = capsys.readouterr().out
    assert "| `span` |" in out and "| `mem` |" in out
    assert records.main([str(PORT), "-o", str(tmp_path / "t.md")]) == 0
    assert (tmp_path / "t.md").read_text() == out
    assert (REPO / "RECORDS.md").read_text() == before
