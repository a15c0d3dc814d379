"""The port's entry points on ``--device cpu``, at small sizes.

``drivers.stencil2d``: its output parses under the regexes of
``tests/test_drivers_stencil2d.py``, its err-norm and eigen gates pass,
and its float64 error norms equal the ones the JAX package's functions
give for the same world=1 problem (the fields and derivatives are
bit-identical; the norms' sums run in another order, so rtol 1e-9).

``bench``: one JSON line with the root bench's keys, and its default
schedules (the JAX package's priors) held against the JAX runners they
mirror on the same state — float32 S=2 blocks and bfloat16 dim-1 at k=4,
the Pallas side in interpret mode. Tolerance: float32 rtol/atol 1e-6 (an
interpreted Pallas body may contract a mul+add into an FMA); bfloat16
one bf16 ulp of the field's magnitude per timestep run, since XLA may
keep an intermediate wider than bf16 and each step can carry that on.
"""

import io
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_mpi_tests.arrays.domain import Domain2D as JaxDomain2D
from tpu_mpi_tests.comm import halo as JH
from tpu_mpi_tests.comm.collectives import shard_1d
from tpu_mpi_tests.comm.mesh import make_mesh
from tpu_mpi_tests.instrument.report import Reporter as JaxReporter
from tpu_mpi_tests.kernels import reductions as JR
from tpu_mpi_tests.kernels import stencil as JS
from tpu_mpi_tests.tune import priors
from tpu_mpi_tests_torch import bench
from tpu_mpi_tests_torch.comm import halo as TH
from tpu_mpi_tests_torch.convert import array_from_jax, state_from_jax
from tpu_mpi_tests_torch.drivers import stencil2d
from tpu_mpi_tests_torch.instrument.report import Reporter
from tpu_mpi_tests_torch.utils import TpuMtError

SMALL = ["--device", "cpu", "--n-local", "32", "--n-other", "64",
         "--n-iter", "3", "--n-warmup", "2"]
DERIV_RE = (r"TEST dim:(\d), (device|managed)\s*, buf:(\d); ([\d.]+), "
            r"err=([\d.e+-]+)")
ITER_RE = (r"ITER dim:(\d), (device|managed)\s*, buf:(\d); exchange "
           r"mean=([\d.e+-]+), min=([\d.e+-]+), max=([\d.e+-]+)")
# the root bench's per-dtype keys (tests/test_entry_points.py); the
# hbm_* keys are left out on the CPU, as the root bench leaves them out
PER_DTYPE = {"value", "unit", "vs_baseline", "vs_f64_reference_roofline",
             "dtype", "samples", "schedule", "steps", "tier", "topology"}


@pytest.mark.parametrize("kernel", ["torch", "hand"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_stencil2d_matrix_parses_and_passes(capsys, kernel, dtype):
    rc = stencil2d.main(SMALL + ["--dtype", dtype, "--kernel", kernel])
    out = capsys.readouterr().out
    assert rc == 0, out
    deriv = re.findall(DERIV_RE, out)
    assert {(d, s, b) for d, s, b, _, _ in deriv} == {
        (d, "device", b) for d in "01" for b in "01"}
    assert len(deriv) == 4
    if dtype == "float64":
        assert all(float(e) < 1e-8 for *_, e in deriv)
    assert len(re.findall(r"allreduce=([\d.]+)", out)) == 2
    iters = re.findall(ITER_RE, out)
    assert len(iters) == 4
    for *_, mean, mn, mx in iters:
        assert float(mn) <= float(mean) <= float(mx)
    assert "FAIL" not in out


def test_stencil2d_err_norms_match_jax(tmp_path, capsys):
    jl = tmp_path / "out.jsonl"
    rc = stencil2d.main(SMALL + ["--dtype", "float64", "--jsonl", str(jl)])
    capsys.readouterr()
    assert rc == 0
    recs = [json.loads(line) for line in jl.read_text().splitlines()]
    got = {(r["dim"], r["buf"]): r["err"] for r in recs
           if r.get("kind") == "test" and r.get("label") is None}
    assert len(got) == 4
    for dim in (0, 1):
        d = JaxDomain2D(n_local_deriv=32, n_global_other=64, n_shards=1,
                        dim=dim)
        f, df = JS.analytic_pairs()[f"2d_dim{dim}"]
        dz = JS.stencil1d_5(d.init_shard_jax(f, 0, jnp.float64), d.scale,
                            axis=dim)
        want = float(JR.err_norm(dz, d.interior_shard_jax(df, 0,
                                                          jnp.float64)))
        for buf in (0, 1):
            np.testing.assert_allclose(got[(dim, buf)], want, rtol=1e-9)


def test_stencil2d_host_init_and_subset(capsys):
    rc = stencil2d.main(SMALL + ["--dtype", "float64", "--init", "host",
                                 "--only", "1:0"])
    out = capsys.readouterr().out
    assert rc == 0
    deriv = re.findall(DERIV_RE, out)
    assert [(d, b) for d, _, b, _, _ in deriv] == [("1", "0")]
    assert all(float(e) < 1e-8 for *_, e in deriv)


def test_stencil2d_tight_tol_fails(capsys):
    rc = stencil2d.main(SMALL + ["--dtype", "float32", "--tol", "1e-14"])
    out = capsys.readouterr().out
    assert rc == 1
    assert "ERR_NORM FAIL" in out


@pytest.mark.parametrize("tier,steps", [("blocks", 4), ("blocks", 1),
                                        ("xla", 1), ("auto", 2)])
def test_stencil2d_iterate_leg_eigen_gate(capsys, tier, steps):
    rc = stencil2d.main(
        ["--device", "cpu", "--n-local", "24", "--n-other", "16",
         "--dtype", "float64", "--iterate-tier", tier, "--iterate-steps",
         str(steps), "--iterate-only", "--iterate-iters", "3"])
    out = capsys.readouterr().out
    assert rc == 0, out
    want_tier = "blocks" if tier == "auto" else tier
    assert f"ITER tier={want_tier} steps={steps} n=24x16" in out
    rel = float(re.search(r"ITER ERR rel=([\d.e+-]+)", out).group(1))
    assert rel < 1e-12  # float64 gate, far inside the driver's own
    assert "TEST dim:" not in out  # --iterate-only skips the matrix
    assert "ITER BITWISE fused==chained over 3 calls: OK" in out
    assert "OVERLAP stencil2d_fused_rdma overlap_frac=" in out
    assert "NOTE" not in out


def test_stencil2d_rejects_unported_and_bad_arguments():
    for argv in (["--iterate-tier", "fused"], ["--iterate-only"],
                 ["--n-local", "3"], ["--n-iter", "0"],
                 ["--kernel", "pallas"]):
        with pytest.raises(SystemExit):
            stencil2d.main(["--device", "cpu"] + argv)


def _small_bench_env(monkeypatch, **extra):
    for var, val in {"TPU_MPI_BENCH_N": "64",
                     "TPU_MPI_BENCH_ITERS_SHORT": "8",
                     "TPU_MPI_BENCH_ITERS_LONG": "400",
                     "TPU_MPI_BENCH_SAMPLES": "2", **extra}.items():
        monkeypatch.setenv(var, val)


def test_bench_prints_one_json_line(monkeypatch, capsys):
    _small_bench_env(monkeypatch)
    bench.main(["--device", "cpu"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1, lines
    rec = json.loads(lines[0])
    assert rec["metric"] == "stencil2d_fullstep_8192_iters_per_s"
    assert set(rec) == {"metric"} | PER_DTYPE | {"bfloat16"}
    assert set(rec["bfloat16"]) == PER_DTYPE
    assert rec["schedule"] == "blocks2_dim0_world1_float32_ov1_blocks_h1x1"
    assert rec["bfloat16"]["schedule"] == \
        "dim1_world1_bfloat16_ov1_blocks_h1x1"
    for r in (rec, rec["bfloat16"]):
        assert r["tier"] == "blocks" and r["steps"] == 4
        assert r["topology"] == "h1x1" and r["unit"] == "iter/s"
        assert r["value"] > 0 and len(r["samples"]) == 2


def test_bench_xla_tier_and_rdma_refusal(monkeypatch, capsys):
    _small_bench_env(monkeypatch, TPU_MPI_BENCH_TIER="xla",
                     TPU_MPI_BENCH_SECOND_DTYPE="none")
    rec = bench.main(["--device", "cpu"])
    capsys.readouterr()
    assert rec["tier"] == "xla" and rec["steps"] == 1
    assert rec["schedule"] == "dim1_world1_float32_ov1_xla_h1x1"
    assert "bfloat16" not in rec
    monkeypatch.setenv("TPU_MPI_BENCH_TIER", "rdma-chained")
    rec = bench.main(["--device", "cpu"])
    capsys.readouterr()
    assert rec["schedule"] == "dim1_world1_float32_ov1_rdma-chained_h1x1"
    monkeypatch.setenv("TPU_MPI_BENCH_TIER", "rdma-fused")
    rec = bench.main(["--device", "cpu"])
    capsys.readouterr()
    assert rec["schedule"] == "dim0_world1_float32_ov1_rdma-fused_h1x1"
    monkeypatch.setenv("TPU_MPI_BENCH_TIER", "fused")
    with pytest.raises(TpuMtError, match="unknown stencil tier"):
        bench.main(["--device", "cpu"])


def test_bench_priors_are_the_jax_packages():
    assert TH.PRIOR_BLOCKS == priors.BENCH_BLOCKS
    assert TH.PRIOR_STEPS == priors.BENCH_STEPS
    assert TH.PRIOR_TIER == priors.STENCIL_TIER


def test_bench_f32_blocks_schedule_matches_jax():
    """The float32 default: S=2 resident blocks, dim 0, k=4."""
    n, steps, S = 32, 4, 2
    run_t, state_t, use_blocks, dim = bench.build_schedule(
        "float32", n=n, steps=steps, n_blocks=S, tier="blocks",
        device=torch.device("cpu"))
    assert use_blocks and dim == 0 and len(state_t) == S
    K = 2 * steps
    d = JaxDomain2D(n_local_deriv=n, n_global_other=n, n_shards=1, dim=0,
                    n_bnd=K)
    f, _ = JS.analytic_pairs()["2d_dim0"]
    zg = jnp.asarray(d.init_shard(f, 0, np.float32))
    se = 1e-6 * d.scale
    run_j = JH.iterate_pallas_blocks_fn(S, K, se, steps=steps,
                                        interpret=True)
    want = np.asarray(JH.merge_blocks(run_j(JH.split_blocks(zg, S, K), 3),
                                      K))
    st = state_from_jax(JH.split_blocks(zg, S, K))
    got = TH.merge_blocks(run_t(st, 3), K).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_bench_bf16_dim1_schedule_matches_jax():
    """The bfloat16 default: the dim-1 single buffer at k=4."""
    n, steps, n_iter = 32, 4, 2
    run_t, state_t, use_blocks, dim = bench.build_schedule(
        "bfloat16", n=n, steps=steps, n_blocks=0, tier="blocks",
        device=torch.device("cpu"))
    assert not use_blocks and dim == 1
    K = 2 * steps
    d = JaxDomain2D(n_local_deriv=n, n_global_other=n, n_shards=1, dim=1,
                    n_bnd=K)
    f, _ = JS.analytic_pairs()["2d_dim1"]
    zg = d.init_shard_jax(f, 0, jnp.bfloat16)
    assert tuple(state_t.shape) == zg.shape
    z0 = array_from_jax(zg)  # before the JAX runner donates ``zg``
    mesh = make_mesh({"shard": 1}, devices=jax.devices()[:1])
    run_j = JH.iterate_pallas_fn(mesh, "shard", K, 1e-6 * d.scale, axis=1,
                                 interpret=True, steps=steps)
    want = np.asarray(run_j(shard_1d(zg, mesh, axis=1), n_iter),
                      np.float64)
    got = run_t(z0, n_iter).double().numpy()
    tol = n_iter * steps * 2.0**-7 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_report_lines_match_jax():
    """The port's stable lines are the JAX Reporter's, character for
    character."""
    outs = []
    for cls in (JaxReporter, Reporter):
        buf = io.StringIO()
        with cls(rank=0, size=1, stream=buf) as rep:
            rep.sum_line(123.456)
            rep.test_line(1, "device", True, 0.25, 3.5e-9)
            rep.test_line(0, "device", 0, 0.125, 0.0,
                          extra_label="allreduce", show_err=False)
            rep.iter_line(0, "device", False, "exchange", 2e-5, 1e-5, 4e-5)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert outs[1].splitlines()[0] == "0/1 SUM = 123.456000"
