"""The port's heat mini-app against the JAX package's, on the CPU.

Pairs, on seeded numpy inputs: ``hand.heat2d_ref`` (the hand kernel's
plain version, which the wrapper runs on a CPU tensor) against the XLA
body of ``heat_step2d_fn`` on a 1×1 mesh and against ``heat2d_pallas``
in interpret mode with 16-row tiles (so several blocks, one ragged); the
port's ``heat_step2d_fn`` (exchange on both axes + update, 3 outer
bodies, both tiers) against JAX's; and the ``heat2d`` driver on
``--device cpu``.

Tolerances. bfloat16: bit-equal — both sides round every op to bf16.
float32 and float64: XLA on the CPU contracts ``mid + cx·d2x`` and
``… + cy·d2y`` into fused multiply-adds (the FMA form reproduces its
result exactly), which eager torch has no op to mirror; the port's plain
version stays op for op what the CUDA kernel does, so the two differ by
the FMAs' rounding: rtol/atol 1e-13 (f64) and 1e-6 (f32) on fields of
order 1.
"""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tpu_mpi_tests.comm import halo as JH
from tpu_mpi_tests.kernels.pallas_kernels import heat2d_pallas
from tpu_mpi_tests_torch.comm import halo as TH
from tpu_mpi_tests_torch.convert import array_from_jax
from tpu_mpi_tests_torch.drivers import heat2d
from tpu_mpi_tests_torch.kernels import hand
from tpu_mpi_tests_torch.utils import TpuMtError

DTYPES = {"float64": np.float64, "float32": np.float32,
          "bfloat16": jnp.bfloat16}
CX, CY = 0.1, 0.2
HEAT_ERR_RE = r"HEAT ERR rel=([\d.e+-]+)"
HEAT_RE = r"HEAT mesh:(\d+)x(\d+) n:(\d+)x(\d+); steps=(\d+) ([\d.]+) steps/s"


@pytest.fixture(scope="module")
def mesh11():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("x", "y"))


def field(seed, shape, dtype):
    a = np.random.default_rng(seed).normal(size=shape)
    return a.astype(np.float32).astype(DTYPES[dtype])


def assert_matches(got: torch.Tensor, want, dtype):
    got = got.double().numpy()
    want = np.asarray(want).astype(np.float64)
    assert got.shape == want.shape
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
    else:
        tol = 1e-13 if dtype == "float64" else 1e-6
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def exchanged(z, n_bnd):
    """``z`` after one periodic both-axis self-ring exchange: a further
    exchange leaves it as it is, so a JAX runner body on it is the bare
    update."""
    return TH.exchange2d(array_from_jax(z), n_bnd, periodic=True)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("steps", [1, 2])
def test_heat2d_ref_matches_xla_body(mesh11, dtype, steps):
    n_bnd = 2
    z = exchanged(field(1 + steps, (68, 52), dtype), n_bnd)
    run = JH.heat_step2d_fn(mesh11, "x", "y", n_bnd, CX, CY, steps=steps)
    want = run(jnp.asarray(z.double().numpy()).astype(DTYPES[dtype]), 1)
    assert_matches(hand.heat2d_ref(z, CX, CY, steps), want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("steps", [1, 2])
def test_heat2d_ref_matches_pallas(dtype, steps):
    z = field(3 + steps, (68, 52), dtype)
    want = heat2d_pallas(jnp.asarray(z), CX, CY, steps=steps, n_bnd=2,
                         interpret=True, tile_rows=16)
    got = hand.heat2d_ref(array_from_jax(z), CX, CY, steps)
    assert_matches(got, want, dtype)
    # on a CPU tensor the wrapper is its plain version, counted nowhere
    before = hand.heat2d.launches
    out = torch.empty_like(got)
    assert torch.equal(hand.heat2d(array_from_jax(z), CX, CY, steps,
                                   out=out), got)
    assert hand.heat2d.launches == before


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kernel", ["torch", "hand"])
def test_heat_step2d_fn_matches_jax(mesh11, dtype, kernel):
    n_bnd = steps = 2
    z = field(7, (64 + 2 * n_bnd, 48 + 2 * n_bnd), dtype)
    jax_kernel = "xla" if kernel == "torch" else "pallas"
    run_j = JH.heat_step2d_fn(mesh11, "x", "y", n_bnd, CX, CY, steps=steps,
                              kernel=jax_kernel, interpret=True)
    want = run_j(jnp.asarray(z), 3)
    run_t = TH.heat_step2d_fn(n_bnd, CX, CY, steps=steps, kernel=kernel)
    assert_matches(run_t(array_from_jax(z), 3), want, dtype)


def test_heat_step2d_fn_tiers_agree_bitwise():
    """Both port tiers run the same recurrence update for update."""
    z = torch.from_numpy(field(8, (40, 36), "float64"))
    a = TH.heat_step2d_fn(3, CX, CY, steps=3, kernel="torch")(z.clone(), 4)
    b = TH.heat_step2d_fn(3, CX, CY, steps=3, kernel="hand")(z.clone(), 4)
    assert torch.equal(a, b)


def test_heat_step2d_fn_rejects_bad_arguments():
    with pytest.raises(TpuMtError, match="ghost width"):
        TH.heat_step2d_fn(1, CX, CY, steps=2)
    with pytest.raises(TpuMtError, match="unknown kernel"):
        TH.heat_step2d_fn(1, CX, CY, kernel="pallas")
    with pytest.raises(ValueError):
        hand.heat2d(torch.zeros(8), CX, CY)


def run_driver(capsys, *argv):
    rc = heat2d.main(["--device", "cpu", "--mesh", "1,1", *argv])
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("kernel", ["torch", "hand"])
@pytest.mark.parametrize("halo_steps", [1, 3])
def test_driver_eigen_gate_f64(capsys, kernel, halo_steps):
    rc, out = run_driver(capsys, "--nx-local", "16", "--ny-local", "12",
                         "--n-steps", "48", "--halo-steps", str(halo_steps),
                         "--dtype", "float64", "--kernel", kernel)
    assert rc == 0, out
    assert re.search(HEAT_RE, out).groups()[:5] == ("1", "1", "16", "12",
                                                    "48")
    rel = float(re.search(HEAT_ERR_RE, out).group(1))
    assert rel < 1e-13  # roundoff-exact, as the JAX driver's f64 gate
    assert "exchange mean=" in out and "FAIL" not in out


def test_driver_f32_higher_mode_and_jsonl(capsys, tmp_path):
    jl = tmp_path / "heat.jsonl"
    rc, out = run_driver(capsys, "--nx-local", "8", "--ny-local", "16",
                         "--n-steps", "30", "--kx", "3", "--ky", "2",
                         "--kernel", "hand", "--jsonl", str(jl))
    assert rc == 0, out
    recs = [json.loads(line) for line in jl.read_text().splitlines()]
    kinds = [r["kind"] for r in recs]
    assert kinds == ["heat", "iter", "heat_err"]
    assert recs[0]["kernel"] == "hand" and recs[0]["steps"] == 30
    assert recs[1]["phase"] == "exchange"
    assert recs[2]["rel"] <= recs[2]["tol"]


def test_driver_unstable_dt_fails_gate(capsys):
    rc, out = run_driver(capsys, "--nx-local", "16", "--ny-local", "8",
                         "--n-steps", "200", "--dt", "1.0", "--dtype",
                         "float64", "--kernel", "hand")
    assert rc == 1
    assert "HEAT FAIL" in out


def test_driver_hand_tier_takes_any_width(capsys):
    """The JAX driver falls back to XLA past the Pallas body's VMEM width
    limit (``test_drivers_heat2d.py:183``); the hand kernel takes any
    width, so the port runs the hand path with no fallback NOTE."""
    rc, out = run_driver(capsys, "--nx-local", "16", "--ny-local", "23040",
                         "--n-steps", "2", "--kernel", "hand", "--dtype",
                         "float64")
    assert rc == 0, out
    assert "NOTE" not in out and "HEAT FAIL" not in out


def test_driver_refuses_multi_rank_grids_and_bad_arguments(capsys):
    # a grid the world does not multiply to: the JAX driver's ERROR line
    assert heat2d.main(["--device", "cpu", "--mesh", "2,4"]) == 2
    assert capsys.readouterr().out.splitlines()[-1] \
        == "ERROR --mesh 2,4 needs 8 devices, have 1"
    assert heat2d.main(["--device", "cpu", "--mesh", "1,x"]) == 2
    assert "ERROR" in capsys.readouterr().out
    for argv in (["--n-steps", "50", "--halo-steps", "4"],
                 ["--kernel", "pallas"], ["--nx-local", "2",
                                          "--halo-steps", "1"]):
        with pytest.raises(SystemExit):
            heat2d.main(["--device", "cpu"] + argv)
