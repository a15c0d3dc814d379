"""The port's linter (``tpu_mpi_tests_torch/analysis/``) held to its golden
fixtures, to the JAX package's linter on the JAX fixtures that are
framework-neutral, to seeded mutants of the port's own tree, and to the
port's lint gate: the port lints itself clean.

The fixtures live in ``tpu_mpi_tests_torch/analysis/fixtures/``: a
recursive walk skips them (deliberately bad code must not fail the gate),
and these tests lint them by name. A bad fixture marks each finding it
must raise with an ``# expect: TPMxxx`` comment on the finding's line.
"""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from tpu_mpi_tests_torch.analysis import cli
from tpu_mpi_tests_torch.analysis.core import lint_paths, rule_table

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tpu_mpi_tests_torch" / "analysis" / "fixtures"
JAX_FIXTURES = REPO / "tpu_mpi_tests" / "analysis" / "fixtures"

#: the single-file families' fixture stems
FILE_FAMILIES = ["tpm1", "tpm210", "tpm302", "tpm6", "tpm7", "tpm8",
                 "tpm10", "tpm1102", "tpm1301", "tpm14"]
#: the whole-program families: mini package trees, the hazard and the
#: helper it reaches in different files
TREE_FAMILIES = ["tpm4", "tpm11", "tpm16", "tpm17"]
#: the engine family has a bad and a good fixture only: its findings are
#: about the suppression comments themselves
ENGINE_FAMILY = "tpm9"
#: the TPM4xx trees' stdlib-only entry point
TREE_ENTRIES = {"tpm4": {"app.cli": "app.cli"}}

_EXPECT = re.compile(r"#\s*expect:\s*([A-Z0-9, ]+)")


@pytest.fixture(autouse=True)
def _hermetic_cache(tmp_path, monkeypatch):
    """The CLI caches by default: keep it off the user's cache."""
    monkeypatch.setenv("TPU_MPI_LINT_CACHE", str(tmp_path / "_lc.json"))


def fixture_path(stem: str, variant: str) -> Path:
    tree = FIXTURES / f"{stem}_{variant}"
    return tree if tree.is_dir() else FIXTURES / f"{stem}_{variant}.py"


def lint_fixture(stem: str, variant: str):
    return lint_paths([str(fixture_path(stem, variant))],
                      entry_modules=TREE_ENTRIES.get(stem))


def _rel(path, root: Path) -> str:
    p = Path(path).resolve()
    return p.name if root.is_file() else p.relative_to(root).as_posix()


def expected(root: Path) -> set:
    """``(file, line, code)`` of every ``# expect:`` marker under
    ``root``."""
    files = [root] if root.is_file() else sorted(root.rglob("*.py"))
    out = set()
    for f in files:
        for i, line in enumerate(f.read_text().splitlines(), start=1):
            m = _EXPECT.search(line)
            if m:
                out.update((_rel(f, root), i, c.strip())
                           for c in m.group(1).split(",") if c.strip())
    return out


def found(findings, root: Path) -> set:
    return {(_rel(f.path, root), f.line, f.code) for f in findings}


ALL_BAD = FILE_FAMILIES + TREE_FAMILIES + [ENGINE_FAMILY]


@pytest.mark.parametrize("stem", ALL_BAD)
def test_bad_fixture_convicts_exactly_its_codes_at_its_lines(stem):
    root = fixture_path(stem, "bad")
    want = expected(root)
    assert want, f"{root} marks no expected finding"
    assert found(lint_fixture(stem, "bad"), root) == want


@pytest.mark.parametrize("stem", ALL_BAD)
def test_good_fixture_is_clean(stem):
    assert lint_fixture(stem, "good") == []


@pytest.mark.parametrize("stem", FILE_FAMILIES + TREE_FAMILIES)
def test_suppressed_fixture_is_clean_and_uses_its_suppressions(stem):
    """Clean, with no TPM900 (every suppression silenced a finding) and
    no TPM901; each suppression carries its reason in a comment."""
    root = fixture_path(stem, "suppressed")
    files = [root] if root.is_file() else sorted(root.rglob("*.py"))
    text = "".join(f.read_text() for f in files)
    assert "tpumt: ignore[" in text
    assert lint_fixture(stem, "suppressed") == []


def test_every_carried_code_has_a_bad_fixture():
    """Every code the port registers is convicted by some bad fixture,
    except the --conform-only pair (their own tests), TPM601 (the
    fallback, below) and TPM902 (a parse error, below)."""
    convicted = set()
    for stem in ALL_BAD:
        convicted |= {c for _f, _l, c in expected(fixture_path(stem, "bad"))}
    codes = {code for code, _summary in rule_table()}
    assert codes - convicted == {"TPM1704", "TPM1705", "TPM601",
                                 "TPM902"}


def test_families_not_carried_leave_their_codes_unused():
    codes = {code for code, _summary in rule_table()}
    for gone in ("TPM201", "TPM202", "TPM301", "TPM501", "TPM502",
                 "TPM1201"):
        assert gone not in codes


def test_tpm601_fallback_fires_only_without_a_resolved_thread(tmp_path):
    """The lexical TPM601 speaks only where thread discovery resolved
    nothing (a spawn target it cannot name)."""
    (tmp_path / "dyn.py").write_text(
        "import threading\n"
        "\n"
        "\n"
        "class Sink:\n"
        "    def __init__(self, path, hooks):\n"
        "        self._f = open(path, 'a')\n"
        "        self._hooks = hooks\n"
        "\n"
        "    def arm(self, i):\n"
        "        threading.Timer(1.0, self._hooks[i]).start()\n"
        "\n"
        "    def record(self, line):\n"
        "        self._f.write(line)\n"
    )
    got = lint_paths([str(tmp_path)])
    assert [(f.code, f.line) for f in got] == [("TPM601", 13)]


def test_unparsable_and_missing_paths_are_findings(tmp_path):
    (tmp_path / "broken.py").write_text("def f(:\n")
    got = lint_paths([str(tmp_path / "broken.py"),
                      str(tmp_path / "absent")])
    assert [f.code for f in got] == ["TPM902", "TPM902"]


def test_origins_match_by_whole_components(tmp_path):
    """A call into the JAX package is no port collective, and
    ``tpu_mpi_tests_torch.tune`` is the exempt tuner home where
    ``tpu_mpi_tests.tune`` is not."""
    (tmp_path / "other.py").write_text(
        "from tpu_mpi_tests.comm.collectives import allreduce_sum\n"
        "\n"
        "\n"
        "def f(x, rank):\n"
        "    if rank == 0:\n"
        "        x = allreduce_sum(x)\n"
        "    return x\n"
    )
    (tmp_path / "mine.py").write_text(
        "from tpu_mpi_tests_torch.comm.collectives import allreduce_sum\n"
        "\n"
        "\n"
        "def f(x, rank):\n"
        "    if rank == 0:\n"
        "        x = allreduce_sum(x)\n"
        "    return x\n"
    )
    got = lint_paths([str(tmp_path)])
    assert [(Path(f.path).name, f.code) for f in got] == [
        ("mine.py", "TPM1101")]


# ---------------------------------------------------------------------------
# parity with the JAX linter on the framework-neutral JAX fixtures
# ---------------------------------------------------------------------------

#: JAX fixtures that name neither jax nor the JAX package: both linters
#: read them as they are (threading, schedule constants, the record
#: contract, the engine)
NEUTRAL = ["tpm6_bad.py", "tpm6_good.py", "tpm6_suppressed.py",
           "tpm7_bad.py", "tpm7_suppressed.py", "tpm9_unused.py",
           "tpm14_bad.py", "tpm14_good.py", "tpm14_suppressed.py",
           "tpm16_bad", "tpm16_good", "tpm16_suppressed"]
#: JAX fixtures that name no jax but import the JAX package's comm,
#: chaos, telemetry or tune modules: the port's linter reads them with
#: ``tpu_mpi_tests`` re-anchored to ``tpu_mpi_tests_torch`` (its origins
#: match by whole components, so the JAX package's modules are not its)
REANCHORED = ["tpm10_bad.py", "tpm10_good.py", "tpm10_suppressed.py",
              "tpm1102_bad.py", "tpm1102_good.py", "tpm1102_suppressed.py",
              "tpm7_good.py", "tpm1_factory_bad.py", "tpm8_suppressed.py"]
#: the rest, and why they are not neutral
NOT_NEUTRAL = {
    "tpm1_bad.py": "times a jax.numpy dispatch",
    "tpm1_good.py": "syncs with jax's block_until_ready",
    "tpm1_suppressed.py": "times a jax.numpy dispatch",
    "tpm2_bad.py": "TPM2xx (jax traces) is not carried",
    "tpm2_good.py": "TPM2xx (jax traces) is not carried",
    "tpm2_suppressed.py": "TPM2xx (jax traces) is not carried",
    "tpm3_bad.py": "jnp.asarray sinks; TPM301 is not carried",
    "tpm3_good.py": "jnp.asarray sinks; TPM301 is not carried",
    "tpm3_suppressed.py": "jnp.asarray sinks; TPM301 is not carried",
    "tpm4_bad": "its hazard is a module-level `import jax`",
    "tpm4_good": "its helper imports jax",
    "tpm4_suppressed": "its helper imports jax",
    "tpm5_bad.py": "TPM5xx (mesh axes) is not carried",
    "tpm5_good.py": "TPM5xx (mesh axes) is not carried",
    "tpm5_suppressed.py": "TPM5xx (mesh axes) is not carried",
    "tpm8_bad.py": "syncs with jax.block_until_ready",
    "tpm8_good.py": "syncs with jax.block_until_ready",
    "tpm11_bad": "reads the rank through jax.process_index",
    "tpm11_good": "reads the rank through jax.process_index",
    "tpm11_suppressed": "reads the rank through jax.process_index",
    "tpm11_truthy_bad.py": "reads the rank through jax.process_index",
    "tpm12_bad": "TPM12xx (donate_argnums) is not carried",
    "tpm12_good": "TPM12xx (donate_argnums) is not carried",
    "tpm12_suppressed": "TPM12xx (donate_argnums) is not carried",
    "tpm1301_bad.py": "replicates with jax's broadcast_one_to_all",
    "tpm1301_good.py": "replicates with jax's broadcast_one_to_all",
    "tpm1301_suppressed.py": "reads the rank through jax.process_index",
    "tpm17_bad": "reads the rank through jax.process_index",
    "tpm17_good": "its wrappers are the JAX package's",
    "tpm17_suppressed": "reads the rank through jax.process_index",
}


def test_parity_lists_every_jax_fixture():
    names = {p.name for p in JAX_FIXTURES.iterdir()
             if p.suffix == ".py" or p.is_dir()}
    names.discard("__pycache__")
    listed = set(NEUTRAL) | set(REANCHORED) | set(NOT_NEUTRAL)
    assert names == listed
    for name in NEUTRAL:
        p = JAX_FIXTURES / name
        files = [p] if p.is_file() else sorted(p.rglob("*.py"))
        text = "".join(f.read_text() for f in files)
        assert "jax" not in text and "tpu_mpi_tests" not in text, name


def _jax_findings(path: Path) -> set:
    from tpu_mpi_tests.analysis.core import lint_paths as jax_lint

    return found(jax_lint([str(path)]), path)


@pytest.mark.parametrize("name", NEUTRAL)
def test_parity_on_neutral_jax_fixtures(name):
    path = JAX_FIXTURES / name
    assert found(lint_paths([str(path)]), path) == _jax_findings(path)


def _reanchor(src: Path, dst: Path) -> Path:
    def sub(text):
        return re.sub(r"\btpu_mpi_tests\b", "tpu_mpi_tests_torch", text)

    if src.is_file():
        dst.write_text(sub(src.read_text()))
        return dst
    shutil.copytree(src, dst)
    for f in dst.rglob("*.py"):
        f.write_text(sub(f.read_text()))
    return dst


@pytest.mark.parametrize("name", REANCHORED)
def test_parity_on_reanchored_jax_fixtures(name, tmp_path):
    src = JAX_FIXTURES / name
    assert "jax" not in (src.read_text() if src.is_file() else "".join(
        f.read_text() for f in src.rglob("*.py")))
    dst = _reanchor(src, tmp_path / name)
    assert found(lint_paths([str(dst)]), dst) == _jax_findings(src)


# ---------------------------------------------------------------------------
# the port lints itself clean; seeded mutants of its tree convict
# ---------------------------------------------------------------------------


def gate_scope(root: Path) -> list[str]:
    """The lint gate's scope under ``root``: the package, chip_smoke.py,
    gpu/, the port's tests and their gloo workers."""
    tests = sorted((root / "tests").glob("test_torch_*.py"))
    return [str(p) for p in [root / "tpu_mpi_tests_torch",
                             root / "chip_smoke.py", root / "gpu",
                             *tests, root / "tests" / "torch_dist_workers.py"]]


@pytest.fixture(scope="module")
def port_copy(tmp_path_factory):
    """A copy of the gate's scope, linted once cold into a cache: the gate
    itself (zero findings), and the warm start of every mutant run, which
    re-analyzes only the file it edits."""
    root = tmp_path_factory.mktemp("port")
    shutil.copytree(REPO / "tpu_mpi_tests_torch",
                    root / "tpu_mpi_tests_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copytree(REPO / "gpu", root / "gpu",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "tests").mkdir()
    for p in gate_scope(REPO):
        p = Path(p)
        if p.is_file():
            shutil.copyfile(p, root / p.relative_to(REPO))
    cache = str(root / "lint_cache.json")
    stats: dict = {}
    # one job: a forked pool in a process that holds torch's threads can
    # deadlock
    gate = lint_paths(gate_scope(root), cache_path=cache, stats=stats)
    return root, cache, gate, stats


def test_port_lints_itself_clean(port_copy):
    _root, _cache, gate, stats = port_copy
    assert stats["files"] > 150
    assert gate == [], "\n".join(f.format() for f in gate)


def _mutate(root: Path, rel: str, old: str, new: str, cache: str):
    p = root / rel
    src = p.read_text()
    assert src.count(old) == 1, f"{rel} changed shape — update the mutant"
    p.write_text(src.replace(old, new))
    try:
        return lint_paths([str(root / "tpu_mpi_tests_torch")],
                          cache_path=cache)
    finally:
        p.write_text(src)


def test_mutant_rank_guarded_fleet_open_convicts_tpm1701(port_copy):
    root, cache, _gate, _stats = port_copy
    old = ('        fleet.bcast({"knob": knob, "n": len(candidates)}, '
           'f"{knob}:open")\n')
    new = ('        if fleet.process_index() == 0:\n'
           '            fleet.bcast({"knob": knob, "n": len(candidates)}, '
           'f"{knob}:open")\n')
    got = _mutate(root, "tpu_mpi_tests_torch/tune/sweep.py", old, new,
                  cache)
    assert [(Path(f.path).name, f.code) for f in got] == [
        ("sweep.py", "TPM1701")], got


def test_mutant_reporter_lock_stripped_convicts_tpm1601(port_copy):
    root, cache, _gate, _stats = port_copy
    rel = "tpu_mpi_tests_torch/instrument/report.py"
    src = (root / rel).read_text()
    n = src.count("with self._jsonl_lock:")
    assert n == 2, "the reporter's JSONL lock changed shape"
    p = root / rel
    p.write_text(src.replace("with self._jsonl_lock:", "if True:"))
    try:
        got = lint_paths([str(root / "tpu_mpi_tests_torch")],
                         cache_path=cache)
    finally:
        p.write_text(src)
    assert got and {f.code for f in got} == {"TPM1601"}, got
    assert all(f.path.endswith("report.py") for f in got), got
    assert any("_jsonl_file" in f.message for f in got), got


def test_mutant_sync_in_overlap_region_convicts_tpm801(port_copy):
    root, cache, _gate, _stats = port_copy
    old = "        t1 = time.perf_counter()\n        h.done(ev)\n"
    new = ("        torch.cuda.synchronize()\n"
           "        t1 = time.perf_counter()\n        h.done(ev)\n")
    got = _mutate(root, "tpu_mpi_tests_torch/comm/halo.py", old, new, cache)
    assert [(Path(f.path).name, f.code) for f in got] == [
        ("halo.py", "TPM801")], got


def test_mutant_unsynced_kernel_timing_convicts_tpm101(port_copy):
    root, cache, _gate, _stats = port_copy
    rel = "tpu_mpi_tests_torch/kernels/daxpy.py"
    src = (root / rel).read_text()
    extra = ("\n\nimport time as _time\n"
             "from tpu_mpi_tests_torch.kernels import hand as _hand\n"
             "\n\n"
             "def _timed_daxpy(a, x, y):\n"
             "    t0 = _time.perf_counter()\n"
             "    out = _hand.daxpy(a, x, y)\n"
             "    return out, _time.perf_counter() - t0\n")
    (root / rel).write_text(src + extra)
    try:
        got = lint_paths([str(root / "tpu_mpi_tests_torch")],
                         cache_path=cache)
    finally:
        (root / rel).write_text(src)
    assert [(Path(f.path).name, f.code) for f in got] == [
        ("daxpy.py", "TPM101")], got


def test_mutant_stencil2d_agreement_back_in_its_try_convicts_tpm1703(
        port_copy):
    root, cache, _gate, _stats = port_copy
    old = ("        same = bool(np.array_equal(za, zb))\n"
           "    except ValueError as e:\n"
           "        skipped = e\n"
           "    # the agreement is a reduction over ranks: every rank "
           "enters it, one\n"
           "    # whose runners raised too (a skip votes no failure)\n"
           "    agree = _all_ranks_agree(same or skipped is not None)\n")
    new = ("        same = bool(np.array_equal(za, zb))\n"
           "        agree = _all_ranks_agree(same)\n"
           "    except ValueError as e:\n"
           "        skipped = e\n"
           "        agree = True\n")
    got = _mutate(root, "tpu_mpi_tests_torch/drivers/stencil2d.py", old,
                  new, cache)
    assert [(Path(f.path).name, f.code) for f in got] == [
        ("stencil2d.py", "TPM1703")], got


def test_shared_cache_path_never_replays_the_other_linters_entries(
        tmp_path):
    """``$TPU_MPI_LINT_CACHE`` may be shared: each engine's salt names it,
    so an entry the JAX linter wrote reads as cold here (and a warm
    entry of this linter replays)."""
    from tpu_mpi_tests.analysis.core import lint_paths as jax_lint

    tree = str(fixture_path("tpm16", "bad"))
    cache = str(tmp_path / "shared.json")
    cold, warm, after_jax = {}, {}, {}
    first = lint_paths([tree], cache_path=cache, stats=cold)
    assert lint_paths([tree], cache_path=cache, stats=warm) == first
    assert warm["cache_hits"] == warm["files"] > 0
    jax_lint([tree], cache_path=cache)
    assert lint_paths([tree], cache_path=cache, stats=after_jax) == first
    assert after_jax["cache_hits"] == 0
    assert after_jax["analyzed"] == after_jax["files"]


# ---------------------------------------------------------------------------
# the CLI, and its stdlib-only contract
# ---------------------------------------------------------------------------


def test_cli_exit_codes_and_formats(capsys):
    bad = str(fixture_path("tpm17", "bad"))
    assert cli.main(["--no-cache", str(fixture_path("tpm17", "good"))]) == 0
    capsys.readouterr()
    assert cli.main(["--no-cache", "--format", "json", bad]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert {f["code"] for f in doc["findings"]} == {
        "TPM1701", "TPM1702", "TPM1703"}
    assert cli.main(["--no-cache", "--format", "sarif", bad]) == 1
    doc = json.loads(capsys.readouterr().out)
    driver = doc["runs"][0]["tool"]["driver"]
    assert driver["name"] == cli.PROG
    assert {"TPM1704", "TPM1705"} <= {r["id"] for r in driver["rules"]}
    assert cli.main(["--list-rules"]) == 0
    assert "TPM302" in capsys.readouterr().out


def test_cli_select_and_ignore(capsys):
    bad = str(fixture_path("tpm1", "bad"))
    assert cli.main(["--no-cache", "--select", "TPM102", bad]) == 1
    assert "TPM101" not in capsys.readouterr().out
    assert cli.main(["--no-cache", "--ignore", "TPM1", bad]) == 0


_BLOCKER = """
import sys


class _Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("torch", "jax", "triton",
                                  "tpu_mpi_tests"):
            raise ImportError("blocked: " + name)


sys.meta_path.insert(0, _Blocker())
from tpu_mpi_tests_torch.analysis import cli, records

rc = cli.main(["--no-cache", sys.argv[1]])
rc2 = cli.main(["--no-cache", "--conform", sys.argv[2],
                "--conform-tree", sys.argv[1]])
records.main([sys.argv[4], "-o", sys.argv[3]])
bad = [m for m in sys.modules
       if m.split(".")[0] in ("torch", "jax", "tpu_mpi_tests")]
print("RC", rc, rc2, "MODULES", bad)
"""


def test_runs_where_torch_and_jax_cannot_be_imported(tmp_path):
    """The analysis imports neither torch, jax nor the JAX package: a
    blocker on ``sys.meta_path`` makes each import raise, and the lint,
    a conformance replay and the records table still run."""
    stream = tmp_path / "s.jsonl"
    stream.write_text(
        json.dumps({"kind": "manifest", "process_index": 0}) + "\n"
        + json.dumps({"kind": "span", "op": "allreduce", "axis": "shard",
                      "seq": 0, "seconds": 0.001}) + "\n")
    r = subprocess.run(
        [sys.executable, "-c", _BLOCKER, str(fixture_path("tpm17", "bad")),
         str(stream), str(tmp_path / "records.md"),
         str(REPO / "tpu_mpi_tests_torch")],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "RC 1 0 MODULES []" in r.stdout, (r.stdout, r.stderr)
    assert "TPM1701" in r.stdout
    assert "| `span` |" in (tmp_path / "records.md").read_text()
