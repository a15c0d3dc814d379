"""The schedule plane's driver options on the CPU (world 1), held against
the JAX drivers on one CPU device.

* ``stencil2d --fused``: ``halo.exchange_stencil_fused_fn`` equal to the
  JAX function on the same seeded input (float64, 1e-13, the port's
  stencil tolerance), and the driver's ``SKIP`` and ``fused`` lines;
* ``--debug-dump``: the ``DEBUG`` lines equal to the JAX driver's text;
* ``--managed``: the managed twins' ``TEST`` lines, and
  ``nbytes_report`` equal to the JAX function's text;
* ``--kernel auto`` / ``--iterate-tier auto`` (stencil2d, heat2d),
  ``--overlap auto`` (heat2d, stencil2d_grid, stencil1d) and
  ``--staging auto`` (stencil1d), each with a cache entry written under
  each package's own fingerprint: the same resolution in both (the JAX
  ``xla`` / ``pallas`` bodies are the port's ``torch`` / ``hand``);
* the bench's resolved schedule without a cache (the card's priors), with
  one (explicit variables still win), and under ``TPU_MPI_BENCH_TUNE``.
"""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_mpi_tests.arrays import spaces as JSP
from tpu_mpi_tests.arrays.domain import Domain2D as JaxDomain2D
from tpu_mpi_tests.comm import halo as JH
from tpu_mpi_tests.comm.collectives import shard_1d
from tpu_mpi_tests.comm.mesh import make_mesh
from tpu_mpi_tests.drivers import heat2d as jheat2d
from tpu_mpi_tests.drivers import stencil2d as jstencil2d
from tpu_mpi_tests.drivers import stencil2d_grid as jgrid
from tpu_mpi_tests.kernels import reductions as JR
from tpu_mpi_tests.kernels import stencil as JS
from tpu_mpi_tests.tune import fingerprint as jfp
from tpu_mpi_tests.tune import registry as jreg
from tpu_mpi_tests.tune.cache import ScheduleCache as JaxCache
from tpu_mpi_tests.workloads import stencil1d as jstencil1d
from tpu_mpi_tests_torch import bench
from tpu_mpi_tests_torch.arrays import spaces as TSP
from tpu_mpi_tests_torch.comm import halo as TH
from tpu_mpi_tests_torch.drivers import heat2d, stencil2d, stencil2d_grid
from tpu_mpi_tests_torch.drivers import stencil1d
from tpu_mpi_tests_torch.tune import cache as tcache
from tpu_mpi_tests_torch.tune import fingerprint as tfp
from tpu_mpi_tests_torch.tune import priors as tpriors
from tpu_mpi_tests_torch.tune import registry as treg

TOL = 1e-13
SMALL = ["--n-local", "32", "--n-other", "64", "--n-iter", "3",
         "--n-warmup", "2", "--dtype", "float64"]
ITER = ["--n-local", "24", "--n-other", "16", "--iterate-steps", "1",
        "--iterate-iters", "2", "--dtype", "float64"]
HEAT = ["--mesh", "1,1", "--nx-local", "16", "--ny-local", "12",
        "--n-steps", "24", "--dtype", "float64"]
GRID = ["--mesh", "1,1", "--nx-local", "16", "--ny-local", "24",
        "--n-iter", "4", "--dtype", "float64"]
S1D = ["--n-global", "4096", "--dtype", "float64"]


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    monkeypatch.delenv("TPU_MPI_TUNE_CACHE", raising=False)
    treg.deconfigure()
    jreg.deconfigure()
    yield
    treg.deconfigure()
    jreg.deconfigure()


@pytest.fixture(scope="module")
def mesh1():
    return make_mesh({"shard": 1}, devices=jax.devices()[:1])


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


def caches(tmp_path, knob, value, **ctx):
    """A cache file per package holding ``knob = value`` under its own
    fingerprint of ``ctx`` (no entry for ``value=None``); returns the two
    paths (port, JAX)."""
    tp, jp = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    tc, jc = tcache.ScheduleCache.load(tp), JaxCache.load(jp)
    if value is not None:
        tc.store(knob, tfp.fingerprint(**ctx), value)
        one = jax.devices()[:1]
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax, "devices", lambda *a, **k: one)
            jc.store(knob, jfp.fingerprint(**ctx), value)
    tc.save()
    jc.save()
    return tp, jp


def lines(text, *prefixes):
    return [ln for ln in text.splitlines() if ln.startswith(prefixes)]


# -------------------------------------------------------------- --fused


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("staged", [False, True])
def test_exchange_stencil_fused_fn_matches_jax(mesh1, axis, staged):
    shape = (20, 12) if axis == 0 else (12, 20)
    z = np.random.default_rng(7 + axis).normal(size=shape)
    jfn = JH.exchange_stencil_fused_fn(mesh1, "shard", axis, 2, 2, 3.0,
                                       staged=staged)
    want = np.asarray(jfn(shard_1d(jnp.asarray(z), mesh1, axis=axis)))
    got = TH.exchange_stencil_fused_fn(axis, 2, 3.0, staged=staged)(
        torch.from_numpy(z.copy()))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_fused_driver_matches_jax(capsys, tmp_path):
    jl = tmp_path / "f.jsonl"
    rc, ours = run_ours(capsys, stencil2d.main, *SMALL, "--fused",
                        "--jsonl", str(jl))
    jrc, theirs = run_jax(capsys, jstencil2d.main, *SMALL, "--fused")
    assert rc == jrc == 0, ours + theirs
    assert lines(ours, "SKIP") == lines(theirs, "SKIP") == [
        "SKIP dim:0, device, buf:1: --fused supports only "
        "DIRECT/DEVICE_STAGED exchanges"]
    fused = re.compile(r"TEST dim:(\d), device , buf:(\d); fused=")
    assert fused.findall(ours) == fused.findall(theirs) == [
        ("0", "0"), ("1", "1"), ("1", "0")]
    assert re.findall(r"ITER dim:\d, device , buf:\d; fused mean=", ours)
    # each fused leg's error norm is the derivative's, as JAX computes it
    recs = [json.loads(x) for x in jl.read_text().splitlines()]
    got = {(r["dim"], r["buf"]): r["err"] for r in recs
           if r.get("label") == "fused"}
    for (dim, buf), err in got.items():
        d = JaxDomain2D(n_local_deriv=32, n_global_other=64, n_shards=1,
                        dim=dim)
        f, df = JS.analytic_pairs()[f"2d_dim{dim}"]
        dz = JS.stencil1d_5(d.init_shard_jax(f, 0, jnp.float64), d.scale,
                            axis=dim)
        want = float(JR.err_norm(dz, d.interior_shard_jax(df, 0,
                                                          jnp.float64)))
        np.testing.assert_allclose(err, want, rtol=1e-9)


# --------------------------------------------------------- --debug-dump


def dumps(text):
    return re.findall(r"^DEBUG rank \d+ (?:lo|hi) ghost\+edge:\n\[\[.*?\]\]",
                      text, re.M | re.S)


@pytest.mark.parametrize("extra", [[], ["--fused"], ["--only", "1:0"]])
def test_debug_dump_matches_jax_text(capsys, extra):
    rc, ours = run_ours(capsys, stencil2d.main, *SMALL, "--debug-dump",
                        *extra)
    jrc, theirs = run_jax(capsys, jstencil2d.main, *SMALL, "--debug-dump",
                          *extra)
    assert rc == jrc == 0
    assert dumps(ours) == dumps(theirs)
    assert len(dumps(ours)) == 2 * (1 if extra == ["--only", "1:0"]
                                    else 3 if extra else 4)


# ------------------------------------------------------------ --managed


def test_managed_lines_match_jax(capsys):
    rc, ours = run_ours(capsys, stencil2d.main, *SMALL, "--managed")
    jrc, theirs = run_jax(capsys, jstencil2d.main, *SMALL, "--managed")
    assert rc == jrc == 0 and "FAIL" not in ours
    test = re.compile(r"^TEST dim:(\d), (\w+)\s*, buf:(\d); (allreduce=)?",
                      re.M)
    assert test.findall(ours) == test.findall(theirs)
    assert ("0", "managed", "1", "") in test.findall(ours)
    assert ("1", "managed", "0", "allreduce=") in test.findall(ours)
    assert "managed=True" in ours
    # each managed twin reports its allocation, in the JAX function's text
    mem = re.findall(r"^MEMINFO dim:\d, managed(?:, buf:\d)?: (.*)$", ours,
                     re.M)
    assert len(mem) == 6
    assert set(mem) <= {JSP.nbytes_report(np.zeros((36, 64))),
                        JSP.nbytes_report(np.zeros((32, 68))),
                        JSP.nbytes_report(np.zeros((32, 64)))}


@pytest.mark.parametrize("arrays", [
    [((4, 8), "float64")],
    [((1024, 1024), "float32"), ((3,), "float64")],
    [((2, 3, 4), "float32")] * 3,
    [],
])
def test_nbytes_report_text_is_jaxs(arrays):
    ours = [torch.zeros(s, dtype=getattr(torch, d)) for s, d in arrays]
    theirs = [np.zeros(s, dtype=d) for s, d in arrays]
    assert TSP.nbytes_report(*ours) == JSP.nbytes_report(*theirs)


# ------------------------------------------------------------ the autos


@pytest.mark.parametrize("cached", [None, "xla", "blocks", "rdma-fused"])
def test_stencil2d_kernel_and_tier_auto_match_jax(capsys, tmp_path, cached):
    tp, jp = caches(tmp_path, "stencil/tier", cached, dtype="float64",
                    n=24, world=1)
    argv = ITER + ["--iterate-tier", "auto", "--kernel", "auto",
                   "--only", "0:0"]
    rc, ours = run_ours(capsys, stencil2d.main, *argv, "--tune-cache", tp)
    jrc, theirs = run_jax(capsys, jstencil2d.main, *argv, "--tune-cache",
                          jp)
    assert rc == jrc == 0, ours + theirs
    want = cached or "blocks"
    assert lines(ours, "ITER tier=")[0].split(" world")[0] == \
        lines(theirs, "ITER tier=")[0].split(" world")[0] == \
        f"ITER tier={want} steps=1 n=24x16"
    body = {"xla": "torch"}.get(want, "hand")
    assert f"NOTE --kernel auto -> {body} (stencil/tier {want})" in ours
    assert (f"NOTE --kernel auto -> {'xla' if body == 'torch' else 'pallas'}"
            f" (stencil/tier {want})") in theirs
    assert lines(ours, "TUNE stencil/tier cache-hit") == \
        lines(theirs, "TUNE stencil/tier cache-hit")
    assert f"TUNE stencil/tier resolved -> {want} (" \
        f"{'cache' if cached else 'prior'}; blocks=" in ours


@pytest.mark.parametrize("cached", [None, "xla", "rdma-chained"])
def test_heat2d_kernel_auto_matches_jax(capsys, tmp_path, cached):
    tp, jp = caches(tmp_path, "stencil/tier", cached, dtype="float64",
                    n=16, world=1)
    rc, ours = run_ours(capsys, heat2d.main, *HEAT, "--kernel", "auto",
                        "--tune-cache", tp)
    jrc, theirs = run_jax(capsys, jheat2d.main, *HEAT, "--kernel", "auto",
                          "--tune-cache", jp)
    assert rc == jrc == 0, ours + theirs
    tmap = {"torch": "xla", "hand": "pallas"}
    ours_note = lines(ours, "NOTE --kernel auto")
    assert [re.sub(r"-> (\w+)", lambda m: "-> " + tmap[m.group(1)], n)
            for n in ours_note] == lines(theirs, "NOTE --kernel auto")
    assert len(ours_note) == 1
    assert "HEAT ERR rel=" in ours and "FAIL" not in ours


@pytest.mark.parametrize("cached", [None, 1, 2])
def test_overlap_auto_matches_jax(capsys, tmp_path, cached):
    runs = [
        (heat2d.main, jheat2d.main, HEAT, {"n": 16},
         ["--kernel", "torch", "--halo-steps", "1"],
         ["--kernel", "xla", "--halo-steps", "1"]),
        (stencil2d_grid.main, jgrid.main, GRID, {"n": 16},
         ["--kernel", "torch"], ["--kernel", "xla"]),
        (stencil1d.main, jstencil1d.main, S1D, {"n": 4096},
         ["--overlap-iters", "4"], ["--overlap-iters", "4"]),
    ]
    for i, (ours_main, jax_main, base, ctx, o_extra, j_extra) in \
            enumerate(runs):
        d = tmp_path / str(i)
        d.mkdir()
        tp, jp = caches(d, "halo/overlap", cached, dtype="float64",
                        world=1, **ctx)
        rc, ours = run_ours(capsys, ours_main, *base, *o_extra,
                            "--overlap", "auto", "--tune-cache", tp)
        jrc, theirs = run_jax(capsys, jax_main, *base, *j_extra,
                              "--overlap", "auto", "--tune-cache", jp)
        assert rc == jrc == 0, ours + theirs
        got = [ln for ln in lines(ours, "OVERLAP") if "resolved" in ln]
        assert got == [ln for ln in lines(theirs, "OVERLAP")
                       if "resolved" in ln]
        assert got and got[0].endswith(f"-> {cached or 1}")


@pytest.mark.parametrize("cached", [None, "device", "pallas", "host"])
def test_stencil1d_staging_auto_matches_jax(capsys, tmp_path, cached):
    ctx = TH._staging_context(torch.zeros(4096 + 4, dtype=torch.float64),
                              0, 1)
    tp, jp = caches(tmp_path, "halo/staging", cached, **ctx)
    rc, ours = run_ours(capsys, stencil1d.main, *S1D, "--staging", "auto",
                        "--tune-cache", tp)
    jrc, theirs = run_jax(capsys, jstencil1d.main, *S1D, "--staging",
                          "auto", "--tune-cache", jp)
    assert rc == jrc == 0, ours + theirs
    want = {"device": "device", "pallas": "pallas"}.get(cached, "direct")
    assert lines(ours, "TUNE halo/staging") == \
        lines(theirs, "TUNE halo/staging") == [
            f"TUNE halo/staging resolved -> {want}"]


# ------------------------------------------------------------ the bench


def _small_bench(monkeypatch, cache, **extra):
    for var in [v for v in __import__("os").environ
                if v.startswith("TPU_MPI_BENCH_")]:
        monkeypatch.delenv(var)
    for var, val in {"TPU_MPI_BENCH_N": "64",
                     "TPU_MPI_BENCH_ITERS_SHORT": "8",
                     "TPU_MPI_BENCH_ITERS_LONG": "40",
                     "TPU_MPI_BENCH_SAMPLES": "1",
                     "TPU_MPI_TUNE_CACHE": str(cache), **extra}.items():
        monkeypatch.setenv(var, val)


def schedule_notes(err):
    return lines(err, "SCHEDULE bench")


def test_bench_resolves_the_card_priors_without_a_cache(monkeypatch,
                                                        capsys, tmp_path):
    _small_bench(monkeypatch, tmp_path / "none.json")
    rec = bench.main(["--device", "cpu"])
    err = capsys.readouterr().err
    k = tpriors.BENCH_STEPS
    assert schedule_notes(err) == [
        f"SCHEDULE bench {dt}: tier={tpriors.STENCIL_TIER[dt]} (prior)"
        f" steps={k} (prior) blocks={tpriors.BENCH_BLOCKS[dt]} (prior) "
        f"overlap=1" for dt in ("float32", "bfloat16")]
    assert rec["steps"] == rec["bfloat16"]["steps"] == k
    assert rec["tier"] == tpriors.STENCIL_TIER["float32"]
    assert not (tmp_path / "none.json").exists()


def test_bench_resolves_a_cached_schedule_explicit_first(monkeypatch,
                                                         capsys, tmp_path):
    cache = tmp_path / "tune.json"
    c = tcache.ScheduleCache.load(str(cache))
    c.store("stencil/tier", tfp.fingerprint(dtype="float32", n=64,
                                            world=1), "rdma-chained")
    c.store("stencil/steps", tfp.fingerprint(n=64, world=1), 2)
    c.store("stencil/blocks", tfp.fingerprint(dtype="bfloat16", n=64,
                                              world=1), 2)
    c.save()
    _small_bench(monkeypatch, cache)
    rec = bench.main(["--device", "cpu"])
    notes = schedule_notes(capsys.readouterr().err)
    assert notes == [
        "SCHEDULE bench float32: tier=rdma-chained (cache) steps=2 "
        "(cache) blocks=0 (prior) overlap=1",
        "SCHEDULE bench bfloat16: tier=blocks (prior) steps=2 (cache) "
        "blocks=2 (cache) overlap=1"]
    assert rec["schedule"] == "dim1_world1_float32_ov1_rdma-chained_h1x1"
    assert rec["bfloat16"]["schedule"] == \
        "blocks2_dim0_world1_bfloat16_ov1_blocks_h1x1"
    # explicit variables win over the cache
    _small_bench(monkeypatch, cache, TPU_MPI_BENCH_TIER="xla",
                 TPU_MPI_BENCH_SECOND_DTYPE="none")
    rec = bench.main(["--device", "cpu"])
    assert schedule_notes(capsys.readouterr().err) == [
        "SCHEDULE bench float32: tier=xla (explicit) steps=1 (cache) "
        "blocks=0 (prior) overlap=1"]
    assert rec["schedule"] == "dim1_world1_float32_ov1_xla_h1x1"


def test_bench_tune_sweeps_on_a_miss_then_hits(monkeypatch, capsys,
                                               tmp_path):
    cache = tmp_path / "tune.json"
    _small_bench(monkeypatch, cache, TPU_MPI_BENCH_TUNE="1",
                 TPU_MPI_BENCH_SECOND_DTYPE="none")
    rec = bench.main(["--device", "cpu"])
    out, err = capsys.readouterr()
    assert len([ln for ln in out.splitlines() if ln.strip()]) == 1
    recs = [json.loads(ln) for ln in err.splitlines() if ln.startswith("{")]
    tier_recs = [r for r in recs if r["knob"] == "stencil/tier"]
    assert [r["candidate"] for r in tier_recs[:-1]] == list(
        TH.stencil_tier_candidates("float32"))
    winner = tier_recs[-1]["value"]
    assert tier_recs[-1]["kind"] == "tune_result" and rec["tier"] == winner
    (note,) = schedule_notes(err)
    assert f"tier={winner} (sweep)" in note
    if winner == "blocks":  # the block count is swept for that tier only
        assert any(r["knob"] == "stencil/blocks" for r in recs)
    doc = json.loads(cache.read_text())
    assert any(e["knob"] == "stencil/tier" and e["value"] == winner
               for e in doc["entries"].values())
    # the rerun on the same cache sweeps nothing
    rec2 = bench.main(["--device", "cpu"])
    err = capsys.readouterr().err
    assert not [ln for ln in err.splitlines() if ln.startswith("{")]
    assert f"tier={winner} (cache)" in schedule_notes(err)[0]
    assert rec2["schedule"] == rec["schedule"]
