"""The DAXPY slice of the port against the JAX package, on the CPU.

Inputs come from seeded numpy and go through both packages:

* the streaming kernels' plain versions (``hand.daxpy_ref``,
  ``stream_scale_ref``, ``stream_sum3_ref``) against ``daxpy_pallas``,
  ``stream_scale_pallas`` and ``stream_sum3_pallas`` in interpret mode,
  as ``tests/test_pallas.py`` runs them, and the wrappers (which take the
  plain version for a CPU tensor) out of place and in place. Tolerance:
  exact for scale and sum3 in every dtype, for daxpy in bfloat16 and for
  daxpy at a power-of-two ``a`` (every driver gate runs a = 2). For a
  general ``a`` in float32/float64, XLA on the CPU contracts ``a·x + y``
  into one FMA while the plain version rounds the product first (as the
  CUDA kernel does under ``-fmad=false``), so the two may differ by the
  product's rounding: ``|diff| <= eps · (|a·x| + |result|)``;
* the ``kernels/daxpy.py`` helpers against the JAX ones, exactly;
* the five DAXPY entry points with ``--device cpu``: their lines parse
  under the regexes of ``tests/test_drivers_daxpy.py``, their gates pass
  (and fail when the result is broken), and ``mpi_daxpy``'s per-rank
  ``SUM`` lines equal the JAX driver's on its 8 fake devices;
* the instrument, spaces, collectives and workload-registry pieces they
  run on.
"""

import io
import json
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_mpi_tests.kernels.daxpy as jkd
from tpu_mpi_tests.drivers import daxpy as jdaxpy
from tpu_mpi_tests.drivers import mpi_daxpy as jmpi_daxpy
from tpu_mpi_tests.instrument.report import Reporter as JaxReporter
from tpu_mpi_tests.instrument.timers import PhaseTimer as JaxPhaseTimer
from tpu_mpi_tests.kernels import pallas_kernels as PK
from tpu_mpi_tests_torch import workloads
from tpu_mpi_tests_torch.arrays.spaces import (
    Space,
    ensure_device,
    meminfo,
    place,
)
from tpu_mpi_tests_torch.comm import collectives as C
from tpu_mpi_tests_torch.comm.mesh import device_report, ranks_per_device
from tpu_mpi_tests_torch.convert import array_from_jax
from tpu_mpi_tests_torch.drivers import (
    daxpy,
    envprobe,
    gather_inplace,
    mpi_daxpy,
    mpi_daxpy_nvtx,
)
from tpu_mpi_tests_torch.instrument.report import Reporter
from tpu_mpi_tests_torch.instrument.timers import PhaseTimer, dispatch_rate
from tpu_mpi_tests_torch.instrument.trace import ProfilerGate, trace_range
from tpu_mpi_tests_torch.kernels import daxpy as kd
from tpu_mpi_tests_torch.kernels import hand
from tpu_mpi_tests_torch.utils import TpuMtError
from tpu_mpi_tests_torch.workloads import runner

CPU = ["--device", "cpu"]
DTYPES = {"float64": np.float64, "float32": np.float32,
          "bfloat16": jnp.bfloat16}
TORCH_DTYPES = {"float64": torch.float64, "float32": torch.float32,
                "bfloat16": torch.bfloat16}


def sample(seed, n, dtype):
    a = np.random.default_rng(seed).normal(size=n)
    return a.astype(np.float32).astype(DTYPES[dtype])


def to_np(t):
    return t.double().numpy()


def pallas(name, a, ops, inplace):
    fn = getattr(PK, f"{name}_pallas")
    j = [jnp.asarray(o) for o in ops]
    args = j if name == "stream_sum3" else [a, *j]
    return np.asarray(fn(*args, interpret=True, inplace=inplace),
                      np.float64)


def port(name, a, ops, inplace):
    """The wrapper (the plain version, on CPU tensors), out of place or
    writing into a copy of its last operand, and the plain version."""
    t = [array_from_jax(o) for o in ops]
    args = t if name == "stream_sum3" else [a, *t]
    want = getattr(hand, f"{name}_ref")(*args)
    if inplace:
        tgt = args[-1].clone()
        got = getattr(hand, name)(*args[:-1], tgt, out=tgt)
        assert got is tgt
    else:
        got = getattr(hand, name)(*args)
    assert torch.equal(got, want)
    return to_np(got)


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
@pytest.mark.parametrize("inplace", [False, True])
def test_stream_plain_versions_match_pallas(dtype, inplace):
    n = 384  # the Pallas kernels' n % 128 == 0 rule
    w, x, y = (sample(s, n, dtype) for s in (1, 2, 3))
    for name, ops in (("daxpy", (x, y)), ("stream_scale", (x,)),
                      ("stream_sum3", (w, x, y))):
        for a in (2.0, 0.25, 0.37, 1e-7, 1.0 + 1e-9):
            got = port(name, a, ops, inplace)
            want = pallas(name, a, ops, inplace)
            exact = (name != "daxpy" or dtype == "bfloat16"
                     or a in (2.0, 0.25))
            if exact:
                np.testing.assert_array_equal(got, want, err_msg=name)
            else:
                eps = float(np.finfo(DTYPES[dtype]).eps)
                ax = np.abs(float(np.asarray(a, DTYPES[dtype]))
                            * x.astype(np.float64))
                assert np.all(np.abs(got - want)
                              <= eps * (ax + np.abs(want))), (name, a)


def test_stream_wrappers_ragged_and_checked_on_cpu():
    """Any n works (the 128-multiple rule was the TPU's lane width); a
    partial overlap of out and an operand is refused; CPU calls never
    count as launches."""
    x = torch.arange(1.0, 8.0)
    y = -x
    before = hand.launch_counts()
    assert torch.equal(hand.daxpy(2.0, x, y), x)
    assert torch.equal(hand.stream_sum3(x, x, y), x)
    assert torch.equal(hand.stream_scale(0.5, x, out=x),
                       torch.arange(1.0, 8.0) / 2)
    buf = torch.zeros(12)
    with pytest.raises(ValueError, match="overlaps"):
        hand.daxpy(2.0, buf[:6], buf[6:], out=buf[3:9])
    with pytest.raises(ValueError, match="shape"):
        hand.daxpy(2.0, buf[:6], buf[:5])
    with pytest.raises(ValueError, match="unsupported device"):
        hand.stream_scale(2.0, torch.empty(4, device="meta"))
    assert hand.launch_counts() == before


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
def test_daxpy_helpers_match_jax(dtype):
    n = 1000
    td, jd = TORCH_DTYPES[dtype], DTYPES[dtype]
    for got, want in zip(kd.init_xy(n, td), jkd.init_xy(n, jd)):
        np.testing.assert_array_equal(to_np(got),
                                      np.asarray(want, np.float64))
    for got, want in zip(kd.init_xy_scaled(n, td),
                         jkd.init_xy_scaled_jax(n, jd)):
        np.testing.assert_array_equal(to_np(got),
                                      np.asarray(want, np.float64))
    if dtype != "bfloat16":
        for fn in ("init_xy_np", "init_xy_scaled_np"):
            for got, want in zip(getattr(kd, fn)(n, jd),
                                 getattr(jkd, fn)(n, jd)):
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)
    assert kd.daxpy_bytes(n, td) == jkd.daxpy_bytes(n, jd)
    # the torch tier at a = 2 is exact, like the XLA op
    jx, jy = jkd.init_xy(n, jd)
    x, y = kd.init_xy(n, td)
    np.testing.assert_array_equal(
        to_np(kd.daxpy(2.0, x, y)),
        np.asarray(jkd.daxpy(jnp.asarray(2.0, jd), jx, jy), np.float64))


def test_expected_checksums_match_jax():
    for n in (1, 1024, 48 << 20):
        assert kd.expected_checksum(n) == jkd.expected_checksum(n)
        assert kd.expected_checksum_scaled(n) == \
            jkd.expected_checksum_scaled(n)


SUM_RE = r"(\d+)/(\d+) SUM = ([\d.]+)"


def test_daxpy_driver_lines_match_jax(capsys):
    assert jdaxpy.main(["--dtype", "float64"]) == 0
    want = capsys.readouterr().out
    assert daxpy.main(CPU + ["--dtype", "float64"]) == 0
    got = capsys.readouterr().out
    assert re.findall(SUM_RE, got) == re.findall(SUM_RE, want) \
        == [("0", "1", "524800.000000")]
    phases = re.compile(r"TIME (\w+) : [\d.]+")
    assert phases.findall(got) == phases.findall(want) == [
        "copyInput", "kernel", "copyOutput"]


def test_daxpy_driver_options_and_gates(capsys):
    assert daxpy.main(CPU + ["--n", "37", "--iters", "3",
                             "--print-elements", "--verbose"]) == 0
    out = capsys.readouterr().out
    assert "1.000000\n" in out and "37.000000\n" in out
    assert re.search(r"TIME kernel : [\d.]+ count=3 ", out)
    # at a != 2 the reference's checksum (hardwired to its init) fails,
    # in the JAX driver and in the port alike
    assert jdaxpy.main(["--a", "3.0"]) == 1
    want = capsys.readouterr().out
    assert daxpy.main(CPU + ["--a", "3.0"]) == 1
    got = capsys.readouterr().out
    assert "CHECKSUM FAIL" in got and "CHECKSUM FAIL" in want
    assert re.findall(SUM_RE, got) == re.findall(SUM_RE, want)


def test_daxpy_driver_element_gate_fails_on_a_wrong_element(
        monkeypatch, capsys):
    def broken(a, x, y):
        out = torch.add(y, x, alpha=a)
        out[5] += 1
        return out

    monkeypatch.setattr(kd, "daxpy", broken)
    assert daxpy.main(CPU + ["--n", "64"]) == 1
    assert "ELEMENT FAIL: 1/64 mismatches, first at [5]" in \
        capsys.readouterr().out


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_mpi_daxpy_sums_match_jax_8_devices(capsys, dtype):
    """8 logical ranks on the one device give the per-rank SUM lines the
    JAX driver prints on its 8 fake devices."""
    assert jmpi_daxpy.main(["--n-total", "8192", "--dtype", dtype]) == 0
    want = re.findall(SUM_RE, capsys.readouterr().out)
    assert mpi_daxpy.main(CPU + ["--n-total", "8192", "--ranks", "8",
                                 "--dtype", dtype]) == 0
    out = capsys.readouterr().out
    assert re.findall(SUM_RE, out) == want and len(want) == 8
    assert "8 logical ranks over 1 devices (8 ranks/device)" in out
    assert "MEMORY_PER_CORE is not set" in out


def test_mpi_daxpy_oversubscription_and_meminfo(capsys, monkeypatch):
    monkeypatch.setenv("MEMORY_PER_CORE", "2048")
    rc = mpi_daxpy.main(CPU + ["--n-total", "131072", "--ranks", "32",
                               "--dtype", "float64", "--verbose"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "MEMORY_PER_CORE=2048" in out
    sums = re.findall(r"(\d+)/32 SUM = ([\d.]+)", out)
    n = 131072 // 32
    assert len(sums) == 32 and all(float(v) == n * (n + 1) / 2
                                   for _, v in sums)
    assert len(re.findall(r"MEMINFO (d_x|d_y|m_x|m_y): kind=host", out)) \
        == 4
    with pytest.raises(TpuMtError, match="not evenly divisible"):
        mpi_daxpy.main(CPU + ["--n-total", "100", "--ranks", "3"])


@pytest.mark.parametrize("space", ["device", "managed"])
@pytest.mark.parametrize("init", ["host", "device"])
def test_mpi_daxpy_nvtx_phases_lines_and_gates(capsys, tmp_path, space,
                                               init):
    jl = tmp_path / "run.jsonl"
    rc = mpi_daxpy_nvtx.main(CPU + [
        "--n-per-node", "65536", "--dtype", "float64", "--barrier",
        "--space", space, "--init", init, "--jsonl", str(jl)])
    out = capsys.readouterr().out
    assert rc == 0, out
    n = 65536
    assert out.count("SUM = ") == 2  # 1 local + 1 ALLSUM
    assert f"0/1 SUM = {(n + 1) / 2:f}" in out
    assert f"0/1 ALLSUM = {(n + 1) / 2:f}" in out
    for phase in ("total", "kernel", "barrier", "gather"):
        assert re.search(rf"TIME {phase} : [\d.]+", out)
    assert "1 nodes, 1 ranks, 65536 elements each, total 65536" in out
    assert "FAIL" not in out
    recs = [json.loads(line) for line in jl.read_text().splitlines()]
    assert {r["phase"] for r in recs if r["kind"] == "time"} == {
        "total", "kernel", "barrier", "gather"}


def test_mpi_daxpy_nvtx_float32_and_no_warmup(capsys):
    assert mpi_daxpy_nvtx.main(CPU + ["--n-per-node", "65536", "--dtype",
                                      "float32", "--no-warmup"]) == 0
    assert "TIME barrier" not in capsys.readouterr().out


@pytest.mark.parametrize("init", ["host", "device"])
def test_mpi_daxpy_nvtx_gather_parity_gate_fails(monkeypatch, capsys,
                                                 init):
    monkeypatch.setattr(C, "all_gather_inplace", torch.zeros_like)
    rc = mpi_daxpy_nvtx.main(CPU + ["--n-per-node", "4096", "--init", init])
    out = capsys.readouterr().out
    assert rc == 1
    assert "GATHER PARITY FAIL" in out and "CHECKSUM FAIL" in out


def test_mpi_daxpy_nvtx_profile_dir_writes_a_trace(capsys, tmp_path):
    assert mpi_daxpy_nvtx.main(CPU + ["--n-per-node", "4096",
                                      "--profile-dir", str(tmp_path)]) == 0
    capsys.readouterr()
    (trace,) = tmp_path.glob("trace_*.json")
    names = {e.get("name") for e in json.loads(trace.read_text())[
        "traceEvents"]}
    assert {"daxpy", "mpiAllGather", "allSum"} <= names


def test_gather_inplace_parity(capsys):
    rc = gather_inplace.main(CPU + ["--n-per-rank", "2048", "--dtype",
                                    "float64"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "0/1 lsum=2048.0 asum=2048.0" in out
    assert "PARITY FAIL" not in out
    # --rdma gathers through the ring all-gather's plain version here
    assert gather_inplace.main(CPU + ["--n-per-rank", "2048", "--dtype",
                                      "float64", "--rdma"]) == 0
    assert capsys.readouterr().out == "0/1 lsum=2048.0 asum=2048.0\n"


def test_envprobe(capsys, monkeypatch):
    monkeypatch.setenv("MEMORY_PER_CORE", "1024")
    assert envprobe.main(CPU + ["--verbose"]) == 0
    out = capsys.readouterr().out
    assert "0/1 MEMORY_PER_CORE=1024" in out
    assert "0/1 device 0 (cpu) sees MEMORY_PER_CORE=1024" in out
    monkeypatch.delenv("MEMORY_PER_CORE")
    assert envprobe.main(CPU) == 0
    assert "MEMORY_PER_CORE=<not set>" in capsys.readouterr().out


def test_daxpy_entry_points_asked_for_cuda_raise(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (daxpy.main, mpi_daxpy.main, mpi_daxpy_nvtx.main,
                 gather_inplace.main, envprobe.main):
        with pytest.raises(TpuMtError, match="cuda"):
            main([])
    assert capsys.readouterr().out == ""


def _fill(timer):
    """The same phase history into a JAX and a port PhaseTimer."""
    for name, secs in (("copyInput", [0.25]), ("kernel", [0.5, 0.125]),
                       ("copyOutput", [0.0625])):
        for s in secs:
            timer.seconds[name] += s
            timer.counts[name] += 1
            timer.mins[name] = min(timer.mins.get(name, s), s)
            timer.maxs[name] = max(timer.maxs.get(name, s), s)
            timer.t_starts.setdefault(name, 100.0)
            timer.t_ends[name] = 101.0
            timer.mono_starts.setdefault(name, 5.0)
            timer.mono_ends[name] = 6.0


def test_time_lines_match_jax(tmp_path):
    """The port's TIME lines and time records are the JAX Reporter's."""
    outs, recs = [], []
    for rep_cls, timer_cls in ((JaxReporter, JaxPhaseTimer),
                               (Reporter, PhaseTimer)):
        timer = timer_cls()
        _fill(timer)
        assert timer.wall_span("kernel") == (100.0, 101.0)
        assert timer.wall_span("never") == (None, None)
        buf = io.StringIO()
        jl = tmp_path / f"{rep_cls.__module__}.jsonl"
        with rep_cls(rank=0, size=1, stream=buf,
                     jsonl_path=str(jl)) as rep:
            rep.time_lines(timer)
            rep.time_lines(timer, stats=True)
            rep.time_line("gather", 0.5, 10.0, 10.5)
        outs.append(buf.getvalue())
        recs.append([json.loads(line) for line in
                     jl.read_text().splitlines()])
    assert outs[0] == outs[1]
    assert "TIME kernel : 0.625000 count=2 mean=3.125000e-01" in outs[1]
    assert recs[0] == recs[1]


def test_phase_timer_and_dispatch_rate_on_cpu():
    timer = PhaseTimer()
    with timer.phase("kernel"):
        pass
    t0, t1 = timer.wall_span("kernel")
    assert t0 <= t1 and timer.counts["kernel"] == 1
    assert timer.lines() == [f"TIME kernel : {timer.seconds['kernel']:0.6f}"]
    x = torch.ones(64)
    assert dispatch_rate(lambda v: v * 2, x, n_iter=20, n_base=5) > 0


def test_trace_range_and_profiler_gate_on_cpu(tmp_path):
    with ProfilerGate(str(tmp_path)) as gate:
        assert gate.active
        with trace_range("copyInput"):
            torch.ones(8).sum()
    assert not gate.active
    (trace,) = tmp_path.glob("trace_*.json")
    assert "copyInput" in trace.read_text()
    with ProfilerGate(None) as idle:  # no dir: a no-op
        assert not idle.active


def test_spaces_on_cpu():
    cpu = torch.device("cpu")
    assert Space.parse("Managed") is Space.MANAGED
    assert Space.parse(Space.HOST) is Space.HOST
    with pytest.raises(TpuMtError, match="unknown space"):
        Space.parse("unified")
    h = np.arange(6, dtype=np.float64)
    for space in Space:
        t = place(h, space, cpu)
        assert t.device == cpu and t.tolist() == h.tolist()
        assert ensure_device(t, cpu) is t
    assert meminfo(place(h, "device", cpu)) == (
        "kind=host devices=[cpu] nbytes=48 dtype=float64 shape=(6,)")
    assert meminfo([1]) == "host(python:list)"


def test_collectives_world1():
    x = torch.arange(1.0, 13.0, dtype=torch.float64)
    np.testing.assert_array_equal(C.per_rank_sums(x, groups_per_shard=3),
                                  [10.0, 26.0, 42.0])
    g = C.all_gather(x)
    assert torch.equal(g, x) and g.data_ptr() != x.data_ptr()
    buf = x.clone()
    ptr = buf.data_ptr()
    buf = C.all_gather_inplace(buf)  # the gathered buffer is the input
    assert buf.data_ptr() == ptr and torch.equal(buf, x)
    assert torch.equal(C.shard_1d(np.arange(3.0), "cpu"),
                       torch.arange(3.0, dtype=torch.float64))
    C.barrier(torch.device("cpu"))
    with pytest.raises(TpuMtError):
        C.per_rank_sums(x, groups_per_shard=5)
    assert ranks_per_device(None) == ranks_per_device(1) == 1
    assert ranks_per_device(4) == 4
    report = device_report(torch.device("cpu"), verbose=True)
    assert report.splitlines() == [
        "0/1 processes, 1 local / 1 global devices, platform=cpu, "
        "kinds=['cpu']", "  device 0: cpu"]


def test_workload_registry_and_umbrella_cli(capsys):
    assert workloads.spec_names() == ("daxpy", "stencil1d")
    assert workloads.get_spec("daxpy") is daxpy.SPEC
    with pytest.raises(KeyError, match="registered: daxpy,stencil1d"):
        workloads.get_spec("moe")
    assert runner.main(["--list"]) == 0
    assert capsys.readouterr().out == "daxpy\nstencil1d\n"
    assert runner.main(["daxpy", "--device", "cpu", "--n", "16"]) == 0
    assert "0/1 SUM = 136.000000" in capsys.readouterr().out
    assert runner.main(["moe"]) == 2
