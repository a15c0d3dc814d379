"""The port's overlap engine against the JAX package's, on the CPU, world 1.

The three split pipelines (``halo.overlap_jacobi_fns``,
``heat_overlap_fns``, ``grid_overlap_fns``), ``iterate_overlap_fn``, the
``OverlapRunner`` accounting and records, ``DispatchWindow``, the depth
resolutions, the drivers' ``--overlap`` modes and the bench's overlap
schedule. Inputs are made from a numpy seed; the port runs on the CPU
(the hand kernels' plain versions). The JAX side runs on a one-device
mesh (the drivers with ``jax.devices`` cut to the first device).

Pairs and tolerances:

* depth 1 against depth 2, and each pipeline against the port's own
  serial body (``iterate_fused_fn``, the torch heat runner at k=1, the
  torch ``step2d_fn``): bit for bit in float64, float32 and bfloat16 —
  the same per-cell ops run in both schedules;
* ``iterate_overlap_fn`` against the port's ``iterate_hand_fn``: bit for
  bit in every dtype (its strips take the iterate kernel's arithmetic);
* against the JAX split functions and ``iterate_overlap_fn`` (Pallas
  interpreted), float64: rtol/atol 1e-13 — XLA contracts mul+add into
  FMAs on the CPU, eager torch does not (``tests/test_torch_heat2d.py``),
  and JAX's strips take ``stencil1d_5``'s arithmetic;
* the drivers' ``OVERLAP``, ``HEAT`` and ``GRID TEST`` lines against the
  JAX drivers' with the timings left out: depth, iterations and
  ``overlap_frac`` exactly (1.000 at depth 2, 0.000 at depth 1 on both),
  the gates' errors within 1e-13.
"""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tpu_mpi_tests.comm import collectives as JC
from tpu_mpi_tests.comm import halo as JH
from tpu_mpi_tests.drivers import heat2d as jax_heat2d
from tpu_mpi_tests.drivers import stencil2d_grid as jax_grid
from tpu_mpi_tests.instrument.timers import block as jblock
from tpu_mpi_tests.tune import registry as tr
from tpu_mpi_tests.workloads import stencil1d as jax_stencil1d
from tpu_mpi_tests_torch import bench
from tpu_mpi_tests_torch.tune import priors as tpriors
from tpu_mpi_tests_torch.comm import collectives as TC
from tpu_mpi_tests_torch.comm import halo as TH
from tpu_mpi_tests_torch.comm.mesh import MeshError, make_mesh
from tpu_mpi_tests_torch.drivers import heat2d, stencil1d, stencil2d_grid
from tpu_mpi_tests_torch.instrument import telemetry as TT
from tpu_mpi_tests_torch.instrument.report import Reporter
from tpu_mpi_tests_torch.instrument.timers import (PhaseTimer, block_stream,
                                                   stream_event)
from tpu_mpi_tests_torch.utils import TpuMtError

TOL = 1e-13
EPS, SCALE = 1e-2, 3.0
CX, CY = 0.1, 0.2
SX, SY = 1.5, 0.75
ROUNDS = 4
DTYPES = {"float64": torch.float64, "float32": torch.float32,
          "bfloat16": torch.bfloat16}
PIPELINES = ("jacobi", "jacobi_periodic", "heat", "grid")


@pytest.fixture(autouse=True)
def _untuned(monkeypatch):
    """The JAX side resolves against an empty schedule cache."""
    monkeypatch.delenv("TPU_MPI_TUNE_CACHE", raising=False)
    tr.deconfigure()
    yield
    tr.deconfigure()


@pytest.fixture(scope="module")
def mesh1():
    return Mesh(np.array(jax.devices()[:1]), ("shard",))


@pytest.fixture(scope="module")
def mesh11():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("x", "y"))


def field(seed, shape, dtype="float64") -> torch.Tensor:
    a = np.random.default_rng(seed).normal(size=shape)
    return torch.from_numpy(a).to(DTYPES[dtype])


def port_fns(name):
    """``(fns, input shape, serial body)`` of a port pipeline; the serial
    body maps (z, n_steps) to the result the pipeline must equal."""
    if name.startswith("jacobi"):
        per = name.endswith("periodic")
        return (TH.overlap_jacobi_fns(0, 2, SCALE, EPS, periodic=per), (70,),
                lambda z, n: TH.iterate_fused_fn(0, 2, SCALE, EPS,
                                                 periodic=per)(z, n))
    if name == "heat":
        return (TH.heat_overlap_fns(CX, CY), (14, 12),
                lambda z, n: TH.heat_step2d_fn(1, CX, CY)(z, n))
    return (TH.grid_overlap_fns(2, SX, SY), (16, 14),
            lambda z, n: TH.step2d_fn(2, SX, SY)(z))


def run_port(name, z, depth, timer=None):
    """The pipeline at ``depth``: ROUNDS ping-ponged steps, or one grid
    step (the grid step is idempotent on its field); returns (result,
    runner)."""
    fns, _, _ = port_fns(name)
    runner = TH.OverlapRunner("halo_exchange", depth=depth, timer=timer)
    if name == "grid":
        ex, cores = runner.step(fns[0], fns[1], z)
        return fns[2](ex, *cores), runner
    return TH.overlap_steps(runner, fns, z, ROUNDS), runner


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", PIPELINES)
def test_depths_bitwise_and_serial_body_bitwise(name, dtype):
    _, shape, serial = port_fns(name)
    z = field(10 + len(name), shape, dtype)
    d1, _ = run_port(name, z.clone(), 1)
    d2, _ = run_port(name, z.clone(), 2)
    ref = serial(z.clone(), ROUNDS)
    for a, b, c in zip(as_tuple(d1), as_tuple(d2), as_tuple(ref)):
        assert torch.equal(a, b)
        assert torch.equal(a, c)


def jax_pipeline(name, z, depth, mesh1, mesh11):
    """The JAX split functions under the JAX runner at ``depth``."""
    zj = jnp.asarray(z.numpy())
    if name.startswith("jacobi"):
        fns = JH.overlap_jacobi_fns(mesh1, "shard", 0, 1, 2, SCALE, EPS,
                                    periodic=name.endswith("periodic"))
    elif name == "heat":
        fns = JH.heat_overlap_fns(mesh11, "x", "y", CX, CY)
    else:
        fns = JH.grid_overlap_fns(mesh11, "x", "y", 2, SX, SY)
    ex_fn, core_fn, seam_fn = fns
    runner = JH.OverlapRunner("halo_exchange", depth=depth)
    if name == "grid":
        ex, cores = runner.step(ex_fn, core_fn, zj)
        return tuple(np.asarray(t) for t in jblock(seam_fn(ex, *cores)))
    for _ in range(ROUNDS):
        ex, zc = runner.step(ex_fn, core_fn, zj)
        zj = jblock(seam_fn(ex, zc))
    return (np.asarray(zj),)


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("name", PIPELINES)
def test_pipelines_match_jax_split_functions(name, depth, mesh1, mesh11):
    _, shape, _ = port_fns(name)
    z = field(20 + len(name), shape)
    want = jax_pipeline(name, z, depth, mesh1, mesh11)
    got, _ = run_port(name, z.clone(), depth)
    for g, w in zip(as_tuple(got), want):
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL)


ITERATE_CASES = [(ax, per) for ax in (0, 1) for per in (False, True)]


def iterate_field(axis, dtype="float64"):
    shape = (24, 16) if axis == 0 else (16, 24)
    return field(30 + axis, shape, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("axis,periodic", ITERATE_CASES)
def test_iterate_overlap_equals_iterate_hand_bitwise(axis, periodic, dtype):
    z = iterate_field(axis, dtype)
    a = TH.iterate_overlap_fn(2, EPS, axis=axis, periodic=periodic)(
        z.clone(), 5)
    b = TH.iterate_hand_fn(2, EPS, axis=axis, periodic=periodic)(
        z.clone(), 5)
    assert torch.equal(a, b)


@pytest.mark.parametrize("axis,periodic", ITERATE_CASES)
def test_iterate_overlap_matches_jax(axis, periodic, mesh1):
    z = iterate_field(axis)
    ovl = JH.iterate_overlap_fn(mesh1, "shard", 2, EPS, axis=axis,
                                interpret=True, periodic=periodic)
    want = np.asarray(ovl(jnp.asarray(z.numpy()), 5))
    got = TH.iterate_overlap_fn(2, EPS, axis=axis, periodic=periodic)(
        z.clone(), 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_iterate_overlap_refuses_deep_ghosts():
    with pytest.raises(TpuMtError, match="stencil radius"):
        TH.iterate_overlap_fn(4, EPS)
    with pytest.raises(TpuMtError, match="stencil radius"):
        TH.grid_overlap_fns(3, SX, SY)


def core_region(name, shape):
    """The cells a pipeline's core writes (a boolean mask per output)."""
    if name.startswith("jacobi"):
        m = np.zeros(shape, bool)
        m[4:shape[0] - 4] = True
        return (m,)
    if name == "heat":
        m = np.zeros(shape, bool)
        m[2:-2, 2:-2] = True
        return (m,)
    nxi, nyi = shape[0] - 4, shape[1] - 4
    mx, my = np.zeros((nxi, nyi), bool), np.zeros((nxi, nyi), bool)
    mx[2:nxi - 2] = True
    my[:, 2:nyi - 2] = True
    return mx, my


@pytest.mark.parametrize("name", ["jacobi", "heat", "grid"])
def test_cores_tap_no_ghost_and_write_only_their_region(name):
    """NaN ghosts leave the core's region bit for bit, and the core writes
    nothing outside its region of its own buffer."""
    fns, shape, _ = port_fns(name)
    z = field(40, shape)
    nb = 1 if name == "heat" else 2
    poisoned = z.clone()
    if name.startswith("jacobi"):
        poisoned[:nb] = poisoned[-nb:] = float("nan")
    else:
        poisoned[:nb] = poisoned[-nb:] = float("nan")
        poisoned[:, :nb] = poisoned[:, -nb:] = float("nan")
    clean = as_tuple(fns[1](z))
    sentinel = tuple(torch.full_like(t, 7.0) for t in clean)
    got = as_tuple(fns[1](poisoned, out=sentinel if name == "grid"
                          else sentinel[0]))
    for g, c, m in zip(got, clean, core_region(name, shape)):
        mask = torch.from_numpy(m)
        assert torch.equal(g[mask], c[mask])
        assert bool((g[~mask] == 7.0).all())


@pytest.mark.parametrize("name", PIPELINES)
def test_overlap_frac_discriminates(name):
    """Depth 1: exactly 0 (the exchange drains before the phase opens).
    Depth 2: > 0, the span open across the core's window; on the CPU no
    step ran on a stream."""
    _, shape, _ = port_fns(name)
    z = field(50, shape)
    _, r1 = run_port(name, z.clone(), 1)
    _, r2 = run_port(name, z.clone(), 2)
    assert r1.overlap_frac == 0.0 and r1.comm_s == 0.0
    assert r2.overlap_frac > 0.0 and r2.comm_s > 0.0
    assert r2.comm_stream is None and r2.streamed_steps == 0
    assert r1.steps == r2.steps == (1 if name == "grid" else ROUNDS)


def test_annotate_and_record_carry_the_jax_fields():
    timer = PhaseTimer()
    _, runner = run_port("heat", field(60, (14, 12)), 2, timer=timer)
    runner.annotate(timer)
    extras = timer.extras["overlap_interior"]
    assert extras == {"overlap_frac": runner.overlap_frac,
                      "comm_overlap_s": runner.overlap_s,
                      "overlap_depth": 2}
    jrunner = JH.OverlapRunner("halo_exchange", depth=2)
    assert runner.record("heat2d", dtype="float64").keys() \
        == jrunner.record("heat2d", dtype="float64").keys()
    assert runner.record()["op"] == "halo_exchange"


def test_time_lines_merge_extras_and_keep_the_stdout_shape(tmp_path, capsys):
    timer = PhaseTimer()
    with timer.phase("overlap_interior"):
        pass
    timer.annotate("overlap_interior", overlap_frac=0.5, overlap_depth=2)
    path = tmp_path / "t.jsonl"
    with Reporter(jsonl_path=str(path)) as rep:
        rep.time_lines(timer, stats=True)
    out = capsys.readouterr().out
    assert re.fullmatch(r"TIME overlap_interior : [\d.]+ count=1 mean=\S+ "
                        r"min=\S+ max=\S+\n", out)
    (rec,) = [json.loads(line) for line in path.read_text().splitlines()]
    assert rec["kind"] == "time" and rec["overlap_frac"] == 0.5
    assert rec["overlap_depth"] == 2


def run_jax(capsys, main, *argv):
    """A JAX driver on a mesh of the first CPU device only."""
    one = jax.devices()[:1]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "devices", lambda *a, **k: one)
        rc = main(list(argv))
    return rc, capsys.readouterr().out


def run_ours(capsys, main, *argv):
    rc = main(["--device", "cpu", *argv])
    return rc, capsys.readouterr().out


def overlap_lines(text):
    """The OVERLAP and NOTE lines with their rates left out."""
    return [re.sub(r" [\d.]+ it/s", "", line) for line in text.splitlines()
            if line.startswith(("OVERLAP", "NOTE"))]


STENCIL1D_ARGV = ["--n-global", "4096", "--dtype", "float64",
                  "--overlap-iters", "6"]


@pytest.mark.parametrize("overlap", ["1", "2"])
def test_stencil1d_overlap_lines_match_jax(capsys, tmp_path, overlap):
    jl = tmp_path / "s.jsonl"
    rc, ours = run_ours(capsys, stencil1d.main, *STENCIL1D_ARGV,
                        "--overlap", overlap, "--jsonl", str(jl))
    jrc, theirs = run_jax(capsys, jax_stencil1d.main, *STENCIL1D_ARGV,
                          "--overlap", overlap)
    assert rc == jrc == 0, ours + theirs
    assert overlap_lines(ours) == overlap_lines(theirs)
    assert re.search(r"^TIME overlap_interior : [\d.]+ count=6 ", ours,
                     re.M)
    recs = [json.loads(line) for line in jl.read_text().splitlines()]
    (time_rec,) = [r for r in recs if r["kind"] == "time"]
    (ov,) = [r for r in recs if r["kind"] == "overlap"]
    assert time_rec["overlap_depth"] == int(overlap)
    assert time_rec["overlap_frac"] == ov["overlap_frac"]
    assert ov["op"] == "halo" and ov["steps"] == 6 and ov["iters"] == 6
    assert (ov["overlap_frac"] > 0) == (overlap == "2")


def test_stencil1d_overlap_auto_runs_the_prior_with_a_note(capsys):
    rc, ours = run_ours(capsys, stencil1d.main, *STENCIL1D_ARGV,
                        "--overlap", "auto")
    jrc, theirs = run_jax(capsys, jax_stencil1d.main, *STENCIL1D_ARGV,
                          "--overlap", "auto")
    assert rc == jrc == 0
    assert overlap_lines(ours) == overlap_lines(theirs)
    assert "OVERLAP halo depth=1 " in ours


HEAT_ARGV = ["--mesh", "1,1", "--nx-local", "16", "--ny-local", "12",
             "--n-steps", "24", "--dtype", "float64"]
GRID_ARGV = ["--mesh", "1,1", "--nx-local", "16", "--ny-local", "24",
             "--n-iter", "4", "--n-warmup", "1", "--dtype", "float64"]


def gate(regex, text):
    return float(re.search(regex, text).group(1))


@pytest.mark.parametrize("overlap", ["1", "2"])
def test_heat2d_overlap_lines_match_jax(capsys, tmp_path, overlap):
    jl = tmp_path / "h.jsonl"
    rc, ours = run_ours(capsys, heat2d.main, *HEAT_ARGV, "--kernel", "torch",
                        "--overlap", overlap, "--jsonl", str(jl))
    jrc, theirs = run_jax(capsys, jax_heat2d.main, *HEAT_ARGV, "--kernel",
                          "xla", "--overlap", overlap)
    assert rc == jrc == 0, ours + theirs
    assert overlap_lines(ours) == overlap_lines(theirs)
    rel_re = r"HEAT ERR rel=([\d.e+-]+)"
    assert abs(gate(rel_re, ours) - gate(rel_re, theirs)) <= TOL
    recs = {r["kind"]: r for r in map(json.loads,
                                      jl.read_text().splitlines())}
    assert recs["heat"]["overlap"] == int(overlap)
    assert recs["overlap"]["op"] == "heat2d"
    assert recs["overlap"]["depth"] == int(overlap)


def test_heat2d_overlap_needs_the_torch_body(capsys):
    with pytest.raises(SystemExit) as e:
        heat2d.main(["--device", "cpu", "--overlap", "2", "--kernel",
                     "hand"])
    ours = capsys.readouterr().err.splitlines()[-1]
    with pytest.raises(SystemExit) as je:
        jax_heat2d.main(["--overlap", "2", "--kernel", "pallas"])
    theirs = capsys.readouterr().err.splitlines()[-1]
    assert e.value.code == je.value.code == 2
    assert ours.split(": error: ")[1] == theirs.split(": error: ")[1] \
        .replace("xla", "torch").replace("XLA", "torch")
    with pytest.raises(SystemExit):
        heat2d.main(["--device", "cpu", "--overlap", "2", "--halo-steps",
                     "2", "--n-steps", "24"])


@pytest.mark.parametrize("kernel,jax_kernel", [("torch", "xla"),
                                               ("hand", "pallas")])
def test_stencil2d_grid_overlap_lines_match_jax(capsys, kernel, jax_kernel):
    rc, ours = run_ours(capsys, stencil2d_grid.main, *GRID_ARGV,
                        "--kernel", kernel, "--overlap", "2")
    jrc, theirs = run_jax(capsys, jax_grid.main, *GRID_ARGV, "--kernel",
                          jax_kernel, "--overlap", "2")
    assert rc == jrc == 0, ours + theirs
    assert overlap_lines(ours) == [line.replace("xla", "torch") for line in
                                   overlap_lines(theirs)]
    for err in (r"err_dx=([\d.e+-]+)", r"err_dy=([\d.e+-]+)"):
        assert abs(gate(err, ours) - gate(err, theirs)) <= TOL * 200
    assert ("NOTE" in ours) == (kernel == "hand")


def test_resolve_overlap_depth_matches_jax(capsys):
    """Explicit values clamp as in the JAX package; ``None`` resolves
    through the schedule cache, and with none configured both packages
    give their prior, 1, without a NOTE."""
    for v in (1, 2, 3, 0, -1, "2", "x"):
        assert TH.resolve_overlap_depth(v) == JH.resolve_overlap_depth(v)
    assert capsys.readouterr().err == ""
    assert TH.resolve_overlap_depth(None) == JH.resolve_overlap_depth(None) \
        == tpriors.HALO_OVERLAP_DEPTH == 1
    assert capsys.readouterr().err == ""


def test_resolve_dispatch_depth_matches_jax():
    for v in (None, 1, 2, 4, 8, 0, -3, "4", "x"):
        assert TC.resolve_dispatch_depth(v) == JC.resolve_dispatch_depth(v)
    assert tpriors.COLL_DISPATCH_DEPTH == 1


def test_dispatch_window_depth1_is_the_per_call_path():
    win = TC.DispatchWindow(1)
    x = torch.ones(8)
    assert win.call("allreduce", lambda a: a, x, nbytes=32) is x
    assert not win._inflight
    assert TC.DispatchWindow().depth == 1


def test_dispatch_window_bounds_what_is_in_flight():
    x = torch.ones(8, dtype=torch.float64)
    direct = x.clone()
    for _ in range(7):
        direct.mul_(2.0)
    win = TC.DispatchWindow(3)
    for _ in range(7):
        y = win.call("scale", lambda a: a.mul_(2.0), x, nbytes=64)
        assert y is x
        assert len(win._inflight) <= 2  # at most depth − 1 after a call
    win.drain()
    assert not win._inflight
    win.drain()  # idempotent
    assert torch.equal(x, direct)


@pytest.mark.parametrize("staging", ["direct", "device"])
def test_halo_exchange_window_routing_equals_the_per_call_path(staging):
    z = field(70, (64, 6))
    plain = TH.halo_exchange(z.clone(), 0, 2, True, staging)
    with TC.DispatchWindow(2) as win:
        windowed = z.clone()
        for _ in range(3):
            windowed = TH.halo_exchange(windowed, 0, 2, True, staging,
                                        window=win)
        assert len(win._inflight) == 1
    assert not win._inflight
    assert torch.equal(plain, windowed) and not torch.equal(plain, z)


def test_async_span_and_span_call():
    h = TT.async_span("demo_op", nbytes=1000, axis_name="shard", world=8,
                      overlap_depth=2)
    x = torch.ones(4)
    h.done(x)
    end = h.mono_end
    h.done(x)  # idempotent
    assert h.closed and h.mono_end == end >= h.mono_start
    assert h.drain_s >= 0.0 and h.meta == {"overlap_depth": 2}
    assert TT.span_call("op", lambda a, b: a + b, 2, 3, nbytes=8) == 5
    assert block_stream(x) is x and stream_event(x) is None


@pytest.mark.parametrize("staging", ["pallas", "host"])
def test_engine_refuses_rdma_and_host_staging(staging):
    with pytest.raises(TpuMtError, match="overlap engine"):
        TH.overlap_jacobi_fns(0, 2, SCALE, EPS, staging=staging)


def test_device_staged_pipeline_equals_direct():
    z = field(80, (70,))
    fns = TH.overlap_jacobi_fns(0, 2, SCALE, EPS, periodic=True,
                                staging="device")
    got = TH.overlap_steps(TH.OverlapRunner("x", depth=2), fns, z.clone(),
                           ROUNDS)
    want, _ = run_port("jacobi_periodic", z.clone(), 2)
    assert torch.equal(got, want)


def test_sendrecv_start_needs_a_peer():
    with pytest.raises(MeshError, match="no peer"):
        make_mesh().sendrecv_start(torch.ones(2), torch.ones(2), True)


def test_bench_overlap_resolution_and_cpu_decline(capsys, monkeypatch):
    assert [bench.resolve_overlap(v) for v in (None, "1", "2", "5", "0")] \
        == [1, 1, 2, 2, 1]
    for var in [v for v in __import__("os").environ
                if v.startswith("TPU_MPI_BENCH_")]:
        monkeypatch.delenv(var)
    monkeypatch.setenv("TPU_MPI_BENCH_N", "64")
    monkeypatch.setenv("TPU_MPI_BENCH_OVERLAP", "2")
    monkeypatch.setenv("TPU_MPI_BENCH_STEPS", "1")
    monkeypatch.setenv("TPU_MPI_BENCH_SECOND_DTYPE", "none")
    monkeypatch.setenv("TPU_MPI_BENCH_ITERS_SHORT", "2")
    monkeypatch.setenv("TPU_MPI_BENCH_ITERS_LONG", "6")
    monkeypatch.setenv("TPU_MPI_BENCH_SAMPLES", "1")
    rec = bench.main(["--device", "cpu"])
    err = capsys.readouterr().err
    assert "NOTE overlap depth 2 not applicable (platform=cpu" in err
    assert rec["schedule"] == "dim1_world1_float32_ov1_blocks_h1x1"


def test_bench_overlap_schedule_equals_the_single_buffer():
    """What the card runs at _ov2: the overlap schedule on the bench's
    dim-1 single buffer, equal to the serialized one bit for bit."""
    run_o, z_o, blocks_o, dim_o = bench.build_schedule(
        "float32", n=64, steps=1, n_blocks=2, tier="blocks",
        device=torch.device("cpu"), overlap=True)
    run_s, z_s, blocks_s, dim_s = bench.build_schedule(
        "float32", n=64, steps=1, n_blocks=2, tier="blocks",
        device=torch.device("cpu"))
    assert (blocks_o, dim_o) == (blocks_s, dim_s) == (False, 1)
    assert torch.equal(run_o(z_o, 3), run_s(z_s, 3))
