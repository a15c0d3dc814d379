"""The port's 1-D stencil driver (``drivers/stencil1d.py`` over
``workloads/stencil1d.py``) against the JAX driver on a one-device mesh,
on ``--device cpu`` at small ``--n-global``.

The two output lines parse under the regexes of
``tests/test_drivers_stencil.py`` (world 1 instead of 8), and the
``err_norm`` agrees with the JAX driver's: equal printed digits in
float64 (both within rounding of zero for a cubic), and within 25 % in
float32. There the stencil is exact for a cubic, so the norm is nothing
but the rounding errors of ~10⁵ points, and XLA contracts the jitted
stencil's mul+add pairs into FMAs, which moves each by up to one
product rounding (measured: 15.32 against 16.79). Outside ``jit`` the
JAX stencil on the same field equals the port's bit for bit, which is
held here too.
"""

import json
import re

import jax
import pytest

from tpu_mpi_tests.drivers import stencil1d as jax_stencil1d
from tpu_mpi_tests_torch import workloads
from tpu_mpi_tests_torch.drivers import stencil1d
from tpu_mpi_tests_torch.kernels import hand
from tpu_mpi_tests_torch.utils import TpuMtError

ERR_RE = r"(\d)/(\d) \[(\w+)\] err_norm = ([\d.]+)"
TIME_RE = r"(\d)/(\d) exchange time ([\d.]+)"


def run_port(capsys, *argv):
    rc = stencil1d.main(["--device", "cpu", *argv])
    return rc, capsys.readouterr().out


def run_jax(capsys, *argv):
    """The JAX driver on a mesh of the first CPU device only: its
    topology and its default mesh both come from ``jax.devices()``."""
    one = jax.devices()[:1]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "devices", lambda *a, **k: one)
        rc = jax_stencil1d.main(list(argv))
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("staging", ["direct", "device", "host"])
def test_lines_parse_under_the_jax_tests_regexes(capsys, staging):
    before = hand.launch_counts()
    rc, out = run_port(capsys, "--n-global", "4096", "--dtype", "float64",
                       "--staging", staging)
    assert rc == 0
    errs = re.findall(ERR_RE, out)
    assert len(errs) == 1 and errs[0][:3] == ("0", "1", "cpu")
    assert float(errs[0][3]) < 1e-6
    assert len(re.findall(TIME_RE, out)) == 1
    assert f"n_global=4096 world=1 n_local=4096 dtype=float64 " \
           f"staging={staging}" in out
    # no hand kernel lies under this driver (nor under the JAX one)
    assert hand.launch_counts() == before


@pytest.mark.parametrize("dtype,n", [("float64", 4096), ("float32", 65536)])
def test_err_norm_matches_the_jax_driver(capsys, dtype, n):
    argv = ("--n-global", str(n), "--dtype", dtype)
    rc_j, out_j = run_jax(capsys, *argv)
    if rc_j != 0 or "0/1 " not in out_j:
        pytest.fail(f"the JAX driver did not run on one device:\n{out_j}")
    rc_t, out_t = run_port(capsys, *argv)
    assert rc_t == 0
    ej = float(re.search(ERR_RE, out_j)[4])
    et = float(re.search(ERR_RE, out_t)[4])
    if dtype == "float64":
        assert ej == et == 0.0  # as printed: 8 decimals
    else:
        assert abs(et - ej) <= 0.25 * ej and ej > 0
    assert out_j.splitlines()[0] in out_t  # the same banner line


def test_derivative_equals_the_unjitted_jax_stencil_bit_for_bit():
    import jax.numpy as jnp
    import numpy as np
    import torch

    from tpu_mpi_tests.arrays.domain import Domain1D as JaxDomain1D
    from tpu_mpi_tests.kernels import stencil as JS
    from tpu_mpi_tests_torch.arrays.domain import Domain1D
    from tpu_mpi_tests_torch.comm import halo as TH
    from tpu_mpi_tests_torch.kernels.stencil import analytic_pairs

    n = 65536
    jd = JaxDomain1D(n_global=n, n_shards=1, n_bnd=2)
    td = Domain1D(n_global=n, n_shards=1, n_bnd=2)
    zj = jd.init_shard_jax(JS.analytic_pairs()["1d"][0], 0, jnp.float32)
    zt = td.init_shard_torch(analytic_pairs()["1d"][0], 0, torch.float32,
                             torch.device("cpu"))
    assert np.array_equal(np.asarray(zj), zt.numpy())
    want = np.asarray(JS.stencil1d_5(zj, scale=jd.scale, axis=0))
    got = TH.stencil_fn(0, td.scale)(TH.halo_exchange(zt, 0, 2))
    assert np.array_equal(got.numpy(), want)


def test_f32_gate_scales_and_tight_tol_fails(capsys):
    rc, _ = run_port(capsys, "--n-global", "65536", "--dtype", "float32")
    assert rc == 0
    rc, out = run_port(capsys, "--n-global", "65536", "--dtype", "float32",
                       "--tol", "1e-12")
    assert rc == 1 and "ERR_NORM FAIL" in out


def test_bfloat16_passes_its_gate(capsys):
    rc, out = run_port(capsys, "--n-global", "4096", "--dtype", "bfloat16")
    assert rc == 0 and "FAIL" not in out


def test_mi_units_and_jsonl(capsys, tmp_path):
    path = tmp_path / "s.jsonl"
    rc, out = run_port(capsys, "--n-global-mi", "1", "--dtype", "float64",
                       "--jsonl", str(path))
    assert rc == 0 and "n_global=1048576" in out
    kinds = [json.loads(ln)["kind"] for ln in path.read_text().splitlines()]
    assert "exchange1d" in kinds and "err_norm" in kinds


@pytest.mark.parametrize("argv,item", [
    (["--staging", "auto"], "TUNE halo/staging resolved -> direct"),
    (["--tune", "--staging", "auto"],
     "TUNE halo/staging resolved -> "),
], ids=["staging-auto", "tune"])
def test_unported_options_raise_naming_the_roadmap(argv, item, capsys,
                                                   tmp_path):
    """The options that once raised (the schedule plane is ported):
    ``--staging auto`` resolves the cache's winner, else DIRECT; under
    ``--tune`` a miss sweeps the staging candidates and stores one."""
    cache = tmp_path / "tune.json"
    rc = stencil1d.main(["--device", "cpu", "--n-global", "4096",
                         "--tune-cache", str(cache), *argv])
    out = capsys.readouterr().out
    assert rc == 0 and item in out and "FAIL" not in out
    assert cache.exists() == ("--tune" in argv)


def test_pallas_staging_runs_the_rdma_ring(capsys):
    """``--staging pallas`` exchanges through ``hand.ring_halo`` (at
    world=1 non-periodic it moves nothing, as the JAX ring does)."""
    rc, out = run_port(capsys, "--n-global", "4096", "--dtype", "float64",
                       "--staging", "pallas")
    assert rc == 0 and "0/1 exchange time" in out and "FAIL" not in out


def test_registered_as_a_workload_spec(capsys):
    assert "stencil1d" in workloads.spec_names()
    from tpu_mpi_tests_torch.workloads import runner

    assert runner.main(["stencil1d", "--device", "cpu", "--n-global",
                        "4096", "--dtype", "float64"]) == 0
    assert "err_norm" in capsys.readouterr().out


def test_defaults_to_the_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(TpuMtError, match="cuda"):
        stencil1d.main(["--n-global", "4096"])
