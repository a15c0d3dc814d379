"""``gpu/trace_summary.py`` (device time in a ``torch.profiler`` trace)
on a hand-made trace, and the grid drivers' ``--profile-dir`` writing the
trace it reads (on the CPU a trace holds no device event)."""

import importlib.util
import json
from pathlib import Path

import pytest

from tpu_mpi_tests_torch.drivers import heat2d, stencil2d_grid

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def summary():
    spec = importlib.util.spec_from_file_location(
        "trace_summary", REPO / "gpu" / "trace_summary.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_union_idle_share_and_groups(summary, tmp_path):
    events = [
        {"ph": "X", "cat": "kernel", "name": "ncclDevKernel_SendRecv",
         "ts": 0, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "heat2d_regs<float, 4, 16>",
         "ts": 50, "dur": 100},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD",
         "ts": 200, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "unpack_ghosts_seam",
         "ts": 390, "dur": 10},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0,
         "dur": 5000},
    ]
    path = tmp_path / "trace_7.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = summary.summarize(str(path))
    assert got["window_ms"] == pytest.approx(0.4)
    assert got["busy_ms"] == pytest.approx(0.18)  # 0-150, 200-220, 390-400
    assert got["idle_share"] == pytest.approx(0.55)
    assert got["kernel_ms_by_group"] == pytest.approx(
        {"heat2d": 0.1, "nccl": 0.1, "other": 0.02, "pack": 0.01})
    assert got["device_events"] == 4
    assert summary.main([str(tmp_path)]) == 0
    assert summary.main([str(tmp_path / "none")]) == 1


def test_overlap_of_two_streams(summary, tmp_path):
    """The device time in which kernels of two or more streams ran at
    once: a comm stream's copies beside a compute stream's kernels, a
    third stream's, and back-to-back kernels (touching, not
    overlapping)."""
    def kernel(stream, ts, dur, name="k"):
        return {"ph": "X", "cat": "kernel", "name": name, "ts": ts,
                "dur": dur, "tid": stream, "args": {"stream": stream}}

    events = [
        kernel(7, 0, 100), kernel(7, 100, 50),   # compute, back to back
        kernel(29, 90, 20), kernel(29, 140, 30),  # comm: 90-110, 140-170
        kernel(31, 95, 5),                        # a third stream
        kernel(7, 300, 10), kernel(29, 310, 10),  # touching only
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD", "ts": 400,
         "dur": 10, "tid": 40},                   # no args: its lane
        kernel(7, 405, 10),
    ]
    path = tmp_path / "trace_9.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = summary.summarize(str(path))
    # 90-110 and 140-150 (comm beside compute), 405-410 (copy beside a
    # kernel); the third stream adds no time inside 90-110
    assert got["overlap_ms"] == pytest.approx(0.035)
    assert got["streams"] == 4
    one = [kernel(7, 0, 100), kernel(7, 50, 100)]  # one stream: never
    path.write_text(json.dumps({"traceEvents": one}))
    assert summary.summarize(str(path))["overlap_ms"] == 0.0
    assert summary.overlap_us([]) == 0.0


@pytest.mark.parametrize("module,argv", [
    (heat2d, ["--nx-local", "16", "--ny-local", "12", "--n-steps", "12",
              "--halo-steps", "3"]),
    (stencil2d_grid, ["--nx-local", "16", "--ny-local", "24", "--n-iter",
                      "3", "--n-warmup", "1"]),
])
def test_grid_drivers_write_a_trace(summary, tmp_path, capsys, module,
                                    argv):
    rc = module.main(["--device", "cpu", "--kernel", "hand", "--mesh", "1,1",
                      "--dtype", "float64", "--profile-dir", str(tmp_path)]
                     + argv)
    assert rc == 0, capsys.readouterr().out
    (trace,) = tmp_path.glob("trace_*.json")
    got = summary.summarize(str(trace))
    assert (got["device_events"], got["window_ms"], got["idle_share"]) \
        == (0, 0.0, None)
