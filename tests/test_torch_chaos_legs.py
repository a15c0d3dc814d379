"""The port's chaos legs end to end on the CPU, each convicted by the JAX
``tpumt-doctor`` (``tpu_mpi_tests.instrument.diagnose --expect``) from
the port's JSONL: wedge ``wedge:0`` (the watchdog's dump the JSONL's
tail), oom ``oom:0``, flood ``shed_storm:0`` and ``queue_ramp:0``, and
over two real processes (gloo, the native launcher) kill
``missing_rank:1`` and straggler ``straggler:1``. A disarmed run is the
run of a build that cannot import ``tpu_mpi_tests_torch.chaos``: the
same masked stdout and record kinds, no ``chaos`` record, and no
finding.

The shapes are the JAX package's chaos legs (``make chaos-smoke``) but
for the queue ramp, whose requests are 4 Mi elements: the port's CPU
handler drains the JAX leg's 1 Mi requests before three SLO windows of
backlog build up.
"""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from tpu_mpi_tests.instrument import diagnose
from tpu_mpi_tests_torch.chaos import inject

REPO = Path(__file__).resolve().parent.parent
LAUNCHER = REPO / "native" / "tpumt_run"

#: the kill leg's survivor leaves through os._exit: it must not wait in
#: the process group's shutdown for the rank chaos killed
FAST_EXIT_DAXPY = (
    "import sys, os\n"
    "from tpu_mpi_tests_torch.workloads.daxpy import main\n"
    "rc = main(sys.argv[1:])\n"
    "sys.stdout.flush(); sys.stderr.flush()\n"
    "os._exit(rc)\n"
)

#: a run that cannot import the chaos package
BLOCKED_DAXPY = (
    "import sys\n"
    "class Block:\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.startswith('tpu_mpi_tests_torch.chaos'):\n"
    "            raise ImportError('chaos layer removed')\n"
    "sys.meta_path.insert(0, Block())\n"
    "from tpu_mpi_tests_torch.workloads.daxpy import main\n"
    "sys.exit(main(sys.argv[1:]))\n"
)
PLAIN_DAXPY = (
    "import sys\n"
    "from tpu_mpi_tests_torch.workloads.daxpy import main\n"
    "sys.exit(main(sys.argv[1:]))\n"
)

#: the JAX dump pattern: the watchdog's comm ops, oldest first
DUMP_RE = re.compile(r"comm ops \(newest last\):\n((?:\s+.*\n)+?)"
                     r"\s+(?:memory at fire:|aborting)")


def _env(chaos=None):
    env = dict(os.environ)
    env.pop("TPU_MPI_CHAOS", None)
    # one thread a process: the test workers share the machine
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = str(REPO) + (
        ":" + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    if chaos is not None:
        env["TPU_MPI_CHAOS"] = chaos
    return env


def _run(code_or_module, args, chaos=None, timeout=240):
    if "\n" in code_or_module:
        cmd = [sys.executable, "-c", code_or_module, *args]
    else:
        cmd = [sys.executable, "-m", code_or_module, *args]
    return subprocess.run(cmd, cwd=REPO, env=_env(chaos),
                          capture_output=True, text=True, timeout=timeout)


def _expect(path, want):
    """The JAX doctor's CLI, ``--expect CLASS:RANK``: exactly one
    finding, of that class, on that rank."""
    assert diagnose.main([str(path), "--expect", want]) == 0


def _dump_matches_tail(stderr, jsonl):
    m = DUMP_RE.search(stderr)
    assert m, stderr
    dumped = [ln.strip().split()[0]
              for ln in m.group(1).strip().splitlines()]
    recs = [json.loads(ln) for ln in open(jsonl)]
    stream = [x.get("op") if x["kind"] == "span" else x.get("note")
              for x in recs if x.get("kind") in ("span", "dispatch")]
    assert dumped == [s.split()[0] for s in stream[-len(dumped):]]


def test_disarmed_run_is_a_run_without_the_chaos_layer(tmp_path):
    outs, kinds = [], []
    for code, name in ((BLOCKED_DAXPY, "a"), (PLAIN_DAXPY, "b")):
        jsonl = tmp_path / f"{name}.jsonl"
        r = _run(code, ["--device", "cpu", "--n", "4096", "--iters", "3",
                        "--telemetry", "--memwatch", "--jsonl", str(jsonl)])
        assert r.returncode == 0, r.stderr[-2000:]
        outs.append(r.stdout)
        kinds.append([json.loads(ln).get("kind") for ln in open(jsonl)])
    mask = re.compile(r"[0-9][0-9.e+-]*")

    def masked(s):
        return [mask.sub("#", ln) for ln in s.splitlines()
                if not ln.startswith("MANIFEST")]  # the git sha varies

    assert masked(outs[0]) == masked(outs[1])
    assert kinds[0] == kinds[1]
    assert "chaos" not in kinds[1]
    # a clean run: the doctor finds nothing
    assert diagnose.diagnose_files([str(tmp_path / "b.jsonl")]) == []


def test_wedge_leg(tmp_path):
    jsonl = tmp_path / "wedge.jsonl"
    r = _run("tpu_mpi_tests_torch.drivers.stencil1d",
             ["--device", "cpu", "--n-global", "65536", "--overlap", "1",
              "--overlap-iters", "12", "--telemetry", "--deadline", "5",
              "--jsonl", str(jsonl)],
             chaos="wedge:op=halo_exchange:after=3:stall_s=60")
    assert r.returncode == inject.WEDGE_EXIT, (r.stdout, r.stderr[-2000:])
    assert "WATCHDOG" in r.stderr and "chaos:wedge" in r.stderr
    _expect(jsonl, "wedge:0")
    _dump_matches_tail(r.stderr, jsonl)
    fires = [json.loads(ln) for ln in open(jsonl)]
    assert [x["event"] for x in fires if x["kind"] == "chaos"] == [
        "armed", "fire"]


def test_oom_leg(tmp_path):
    jsonl = tmp_path / "oom.jsonl"
    r = _run("tpu_mpi_tests_torch.drivers.daxpy",
             ["--device", "cpu", "--n", "1048576", "--iters", "20",
              "--telemetry", "--memwatch", "--mem-interval", "0.05",
              "--jsonl", str(jsonl)],
             chaos="oom:step_mb=8:limit_mb=48:frac=0.8")
    assert r.returncode == inject.OOM_EXIT, r.stderr[-2000:]
    _expect(jsonl, "oom:0")
    ramp = [json.loads(ln) for ln in open(jsonl)]
    live = [x["live_bytes"] for x in ramp
            if x["kind"] == "mem" and x.get("phase") == "kernel"]
    assert len(live) >= 2 and live == sorted(live)


def test_bad_spec_fails_fast(tmp_path):
    r = _run("tpu_mpi_tests_torch.drivers.daxpy",
             ["--device", "cpu", "--n", "4096"], chaos="explode:rank=1")
    assert r.returncode == 2
    assert "ERROR bad --chaos spec" in r.stdout


def test_op_fault_without_telemetry_notes_it(tmp_path):
    r = _run("tpu_mpi_tests_torch.drivers.daxpy",
             ["--device", "cpu", "--n", "4096",
              "--chaos", "straggler:op=halo:delay_ms=1"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "CHAOS armed: straggler:rank=0:op=halo:after=1:delay_ms=1" \
        in r.stdout
    assert "--telemetry is off; it will never fire" in r.stdout


def test_flood_shed_storm_leg(tmp_path):
    jsonl = tmp_path / "flood.jsonl"
    r = _run("tpu_mpi_tests_torch.drivers.serve",
             ["--device", "cpu", "--duration", "3", "--arrival", "poisson",
              "--rate", "20", "--seed", "7", "--report-interval", "1",
              "--max-queue", "32", "--workloads", "daxpy:4096:float32",
              "--telemetry", "--jsonl", str(jsonl)],
             chaos="flood:burst=300:after=1")
    assert r.returncode == 1, r.stderr[-2000:]
    _expect(jsonl, "shed_storm:0")


def test_flood_queue_ramp_leg(tmp_path):
    jsonl = tmp_path / "ramp.jsonl"
    r = _run("tpu_mpi_tests_torch.drivers.serve",
             ["--device", "cpu", "--duration", "2", "--arrival", "poisson",
              "--rate", "20", "--seed", "7", "--report-interval", "0.5",
              "--max-queue", "100000", "--max-batch", "2", "--workloads",
              "daxpy:4194304:float32", "--jsonl", str(jsonl)],
             chaos="flood:burst=1000:after=1")
    assert r.returncode == 0, r.stderr[-2000:]
    _expect(jsonl, "queue_ramp:0")
    sm = [json.loads(ln) for ln in open(jsonl)]
    sm = [x for x in sm if x.get("kind") == "serve"
          and x.get("event") == "summary"]
    assert sm and all(x["shed"] == 0 for x in sm)


@pytest.mark.skipif(shutil.which("g++") is None,
                    reason="no C++ toolchain for native/tpumt_run")
class TestTwoProcesses:
    """Kill and straggler over two real processes (a gloo world started
    by the native launcher)."""

    @pytest.fixture(scope="class")
    def tpumt_run(self):
        subprocess.run(["make", "-C", str(REPO / "native"), "tpumt_run"],
                       capture_output=True, check=True, timeout=120)
        return str(LAUNCHER)

    def _launch(self, tpumt_run, *cmd, chaos, out_prefix, timeout=240):
        proc = subprocess.Popen(
            [tpumt_run, "-n", "2", "-o", str(out_prefix), "--", *cmd],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=REPO, env=_env(chaos), start_new_session=True)
        try:
            proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, 9)
            proc.communicate()
            pytest.fail("launcher timed out")
        return proc.returncode

    def test_kill_leg(self, tpumt_run, tmp_path):
        jsonl = tmp_path / "kill.jsonl"
        rc = self._launch(
            tpumt_run, sys.executable, "-c", FAST_EXIT_DAXPY,
            "--device", "cpu", "--n", "4194304", "--iters", "40",
            "--telemetry", "--memwatch", "--mem-interval", "0.05",
            "--jsonl", str(jsonl),
            chaos="kill:rank=1:phase=kernel:after=10",
            out_prefix=tmp_path / "kill-out-")
        assert rc == inject.KILL_EXIT
        _expect(jsonl, "missing_rank:1")
        (f,) = diagnose.diagnose_files([str(jsonl)])
        assert f["phase"] == "kernel"
        dead = [json.loads(ln) for ln in open(tmp_path / "kill.p1.jsonl")]
        fire = [x for x in dead if x["kind"] == "chaos"
                and x["event"] == "fire"]
        assert fire and fire[0]["rank"] == 1 and fire[0]["exit_code"] == 137

    def test_straggler_leg(self, tpumt_run, tmp_path):
        jsonl = tmp_path / "strag.jsonl"
        rc = self._launch(
            tpumt_run, sys.executable, "-m",
            "tpu_mpi_tests_torch.drivers.daxpy",
            "--device", "cpu", "--n", "1048576", "--iters", "40",
            "--telemetry", "--memwatch", "--mem-interval", "0.05",
            "--jsonl", str(jsonl), chaos="straggler:rank=1:delay_ms=25",
            out_prefix=tmp_path / "strag-out-")
        assert rc == 0
        _expect(jsonl, "straggler:1")
        out0 = (tmp_path / "strag-out-0.txt").read_text()
        assert "CHAOS armed" not in out0  # rank 0 installs nothing
