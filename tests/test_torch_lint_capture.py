"""The port's capture-purity family (TPM210,
``tpu_mpi_tests_torch/analysis/rules/capture_purity.py``): its golden
fixtures convict, pass and stay suppressed as the other families' do,
and the rule finds exactly the bodies a CUDA graph captures — a
``with torch.cuda.graph(...)`` block and the ``run`` that
``instrument.timers.chain_rate`` captures unless it is given
``graph=False`` — with code under an ``_under_capture()`` test exempt.
The chained call sites of the port lint clean under it."""

import re
from pathlib import Path

import pytest

from tpu_mpi_tests_torch.analysis.core import lint_paths, rule_table

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tpu_mpi_tests_torch" / "analysis" / "fixtures"
_EXPECT = re.compile(r"#\s*expect:\s*([A-Z0-9, ]+)")

#: the files that hand a run to chain_rate or capture a graph
CHAINED_SITES = [
    "tpu_mpi_tests_torch/bench.py",
    "tpu_mpi_tests_torch/microbench.py",
    "tpu_mpi_tests_torch/drivers/attnbench.py",
    "tpu_mpi_tests_torch/drivers/collbench.py",
    "tpu_mpi_tests_torch/drivers/stencil2d.py",
    "tpu_mpi_tests_torch/workloads/decode.py",
    "tpu_mpi_tests_torch/tune/sweep.py",
    "tpu_mpi_tests_torch/instrument/timers.py",
    "chip_smoke.py",
]


def _codes(source: str, tmp_path, name="m.py"):
    path = tmp_path / name
    path.write_text(source)
    return [(f.line, f.code) for f in lint_paths([str(path)],
                                                 select=["TPM210"])]


def test_tpm210_is_registered_and_tpm201_is_not():
    codes = dict(rule_table())
    assert "TPM210" in codes and "CUDA graph" in codes["TPM210"]
    assert "TPM201" not in codes and "TPM202" not in codes


@pytest.mark.parametrize("variant", ["bad", "good", "suppressed"])
def test_fixture(variant):
    path = FIXTURES / f"tpm210_{variant}.py"
    got = {(f.line, f.code) for f in lint_paths([str(path)])}
    want = set()
    for i, line in enumerate(path.read_text().splitlines(), start=1):
        m = _EXPECT.search(line)
        if m:
            want |= {(i, c.strip()) for c in m.group(1).split(",")}
    if variant == "bad":
        assert want and got == want
    else:
        assert not want and got == set()
    if variant == "suppressed":
        assert "tpumt: ignore[TPM210]" in path.read_text()


CHAIN = '''\
from tpu_mpi_tests_torch.instrument.timers import chain_rate


def site(step, x):
    def run(y, n):
        for _ in range(n):
            y = step(y)
        print(n)
        return y

    return chain_rate(run, x{kw})
'''


@pytest.mark.parametrize("kw, want", [
    ("", [(8, "TPM210")]),
    (", graph=None", [(8, "TPM210")]),
    (", graph=True", [(8, "TPM210")]),
    (", graph=False", []),
    (", repeats=3, graph=False", []),
])
def test_graph_false_is_the_only_way_out(kw, want, tmp_path):
    assert _codes(CHAIN.format(kw=kw), tmp_path) == want


def test_run_resolves_to_its_own_scope(tmp_path):
    """A ``run`` def elsewhere in the file is not the one captured; the
    last def before the call in the innermost scope is."""
    src = (
        "from tpu_mpi_tests_torch.instrument.timers import chain_rate\n"
        "\n"
        "\n"
        "def run(y, n):\n"
        "    return y.cpu()\n"
        "\n"
        "\n"
        "def site(step, x):\n"
        "    def run(y, n):\n"
        "        return step(y)\n"
        "\n"
        "    return chain_rate(run, x)\n"
        "\n"
        "\n"
        "def outer(x):\n"
        "    return chain_rate(run, x)\n"
    )
    assert _codes(src, tmp_path) == [(5, "TPM210")]


def test_under_capture_guard_exempts(tmp_path):
    src = (
        "import torch\n"
        "\n"
        "from tpu_mpi_tests_torch.instrument.telemetry import "
        "_under_capture\n"
        "\n"
        "\n"
        "def site(g, step, x):\n"
        "    with torch.cuda.graph(g):\n"
        "        y = step(x)\n"
        "        if not _under_capture():\n"
        "            torch.cuda.synchronize()\n"
        "        if torch.cuda.is_current_stream_capturing():\n"
        "            pass\n"
        "        else:\n"
        "            y.item()\n"
        "        y.tolist()\n"
        "    return y\n"
    )
    assert _codes(src, tmp_path) == [(15, "TPM210")]


def test_factory_and_lambda_bodies(tmp_path):
    src = (
        "import time\n"
        "\n"
        "from tpu_mpi_tests_torch.instrument.timers import chain_rate\n"
        "\n"
        "\n"
        "def make(step):\n"
        "    def loop(y, n):\n"
        "        time.time()\n"
        "        return step(y)\n"
        "\n"
        "    return loop\n"
        "\n"
        "\n"
        "def site(step, x, peer):\n"
        "    chain_rate(make(step), x)\n"
        "    chain_rate(lambda y, n: step(y, peer.next_epoch()), x)\n"
        "    return chain_rate(run=lambda y, n: y.cpu(), state=x)\n"
    )
    assert _codes(src, tmp_path) == [(8, "TPM210"), (16, "TPM210"),
                                     (17, "TPM210")]


def test_the_chained_sites_lint_clean():
    assert lint_paths([str(REPO / p) for p in CHAINED_SITES],
                      select=["TPM210"]) == []
