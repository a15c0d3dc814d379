"""The port's 2-D process-grid step against the JAX package's, on the CPU.

Pairs, on seeded numpy inputs: ``hand.dual_dim_step`` (on a CPU tensor,
its plain version) against ``dual_dim_step_pallas`` in interpret mode;
the port's ``step2d_fn`` (both tiers) against JAX's ``step2d_fn`` on a
1×1 mesh; ``state_from_jax`` carrying a 1×1-grid field across; and the
``stencil2d_grid`` driver on ``--device cpu``.

Tolerances. Against the Pallas body: those of the JAX package's own
``test_dual_dim_step_pallas_matches_xla`` (``tests/test_pallas.py:1008``)
— derivatives atol 1e-5, residual 1e-3 relative (the Pallas body sums
per-block partials spread over a tile) — and bit-equal derivatives in
bfloat16, where both sides round every op. Against JAX's ``step2d_fn``
(the XLA tier): the port repeats the tap order, but XLA on the CPU
contracts mul+add pairs of the compiled step into fused multiply-adds,
which eager torch has no op to mirror — rtol/atol 1e-13 (f64) and 1e-6
(f32) on the derivatives; the residual, a sum in another order too, to
rtol 1e-13 (f64) and 1e-5 (f32). (Outside a compiled program, XLA's
``dual_dim_step`` equals the port's bit for bit,
``tests/test_torch_kernels.py``.)
"""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpu_mpi_tests.comm import halo as JH
from tpu_mpi_tests.kernels.pallas_kernels import dual_dim_step_pallas
from tpu_mpi_tests_torch.comm import halo as TH
from tpu_mpi_tests_torch.comm.mesh import MeshError, make_grid
from tpu_mpi_tests_torch.convert import array_from_jax, state_from_jax
from tpu_mpi_tests_torch.drivers import _common, stencil2d_grid
from tpu_mpi_tests_torch.kernels import hand
from tpu_mpi_tests_torch.utils import TpuMtError

DTYPES = {"float64": np.float64, "float32": np.float32,
          "bfloat16": jnp.bfloat16}
SX, SY = 1.5, 0.75
GRID_RE = (r"GRID TEST px:(\d) py:(\d); ([\d.]+), err_dx=([\d.e+-]+), "
           r"err_dy=([\d.e+-]+)")


@pytest.fixture(scope="module")
def mesh11():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("x", "y"))


def field(seed, shape, dtype):
    a = np.random.default_rng(seed).normal(size=shape)
    return a.astype(np.float32).astype(DTYPES[dtype])


def wide(t: torch.Tensor) -> np.ndarray:
    return t.double().numpy()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("tile_rows", [None, 16])
def test_dual_dim_step_matches_pallas(dtype, tile_rows):
    z = field(31, (4 + 2 * 2 + 66, 52 + 2 * 2), dtype)
    ax, ay, ar = dual_dim_step_pallas(jnp.asarray(z), 2, SX, SY,
                                      interpret=True, tile_rows=tile_rows)
    before = hand.dual_dim_step.launches
    bx, by, br = hand.dual_dim_step(array_from_jax(z), 2, SX, SY)
    assert hand.dual_dim_step.launches == before  # CPU: the plain version
    assert bx.dtype == by.dtype == br.dtype == array_from_jax(z).dtype
    ax, ay = np.asarray(ax, np.float64), np.asarray(ay, np.float64)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(wide(bx), ax)
        np.testing.assert_array_equal(wide(by), ay)
    else:
        np.testing.assert_allclose(wide(bx), ax, atol=1e-5)
        np.testing.assert_allclose(wide(by), ay, atol=1e-5)
    assert abs(float(br) - float(ar)) <= 1e-3 * max(1.0, abs(float(ar)))


def test_dual_dim_step_rejects_bad_arguments():
    with pytest.raises(ValueError, match="n_bnd"):
        hand.dual_dim_step(torch.zeros(9, 9), 3, SX, SY)
    with pytest.raises(ValueError, match=">= 5"):
        hand.dual_dim_step(torch.zeros(4, 9), 2, SX, SY)
    with pytest.raises(ValueError, match="unsupported device"):
        hand.dual_dim_step(torch.empty(9, 9, device="meta"), 2, SX, SY)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("kernel", ["torch", "hand"])
def test_step2d_fn_matches_jax(mesh11, dtype, kernel):
    z = field(5, (40, 28), dtype)
    jx, jy, jr = JH.step2d_fn(mesh11, "x", "y", 2, SX, SY)(jnp.asarray(z))
    tx, ty, tr = TH.step2d_fn(2, SX, SY, kernel=kernel)(array_from_jax(z))
    tol = 1e-13 if dtype == "float64" else 1e-6
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=tol,
                               atol=tol)
    assert tr.dim() == 0
    rtol = 1e-13 if dtype == "float64" else 1e-5
    np.testing.assert_allclose(float(tr), float(jr), rtol=rtol)


def test_step2d_fn_pallas_tier_matches_hand(mesh11):
    z = field(6, (44, 36), "float32")
    jx, jy, jr = JH.step2d_fn(mesh11, "x", "y", 2, SX, SY, kernel="pallas",
                              interpret=True)(jnp.asarray(z))
    tx, ty, tr = TH.step2d_fn(2, SX, SY, kernel="hand")(array_from_jax(z))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5)
    assert abs(float(tr) - float(jr)) <= 1e-3 * abs(float(jr))
    with pytest.raises(TpuMtError, match="unknown kernel"):
        TH.step2d_fn(2, SX, SY, kernel="pallas")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_state_from_jax_round_trips_a_grid_field(mesh11, dtype):
    z = field(2, (12, 10), dtype)
    zs = jax.device_put(jnp.asarray(z), NamedSharding(mesh11, P("x", "y")))
    t = state_from_jax(zs)
    assert isinstance(t, torch.Tensor) and t.shape == (12, 10)
    assert str(t.dtype).split(".")[1] == np.dtype(DTYPES[dtype]).name
    np.testing.assert_array_equal(wide(t), np.asarray(zs, np.float64))
    back = jnp.asarray(wide(t)).astype(DTYPES[dtype])
    np.testing.assert_array_equal(np.asarray(back), np.asarray(zs))


def test_parse_grid_mesh_is_the_jax_packages(capsys):
    from tpu_mpi_tests.drivers._common import parse_grid_mesh as jax_parse

    for spec, n_dev in ((None, 1), (None, 8), ("1,1", 1), ("2,4", 8),
                        ("3,5", 8), ("0,1", 1), ("a,b", 1)):
        assert _common.parse_grid_mesh(spec, n_dev) == jax_parse(spec, n_dev)
        assert capsys.readouterr().out.count("ERROR") in (0, 2)


def test_check_grid_refuses_multi_rank():
    """A grid of more ranks than the world raises in ``make_grid`` (the
    drivers resolve ``--mesh`` first, through ``parse_grid_mesh``); the
    1×1 grid is two self-rings."""
    grid = make_grid(1, 1)
    assert (grid.px, grid.py, grid.rx, grid.ry, grid.size) == (1, 1, 0, 0, 1)
    assert (grid.x.size, grid.y.size, grid.x.members, grid.y.members) \
        == (1, 1, (0,), (0,))
    for px, py in ((2, 4), (1, 2), (3, 1), (0, 1)):
        with pytest.raises(MeshError, match="the world has 1"):
            make_grid(px, py)


def run_ok(capsys, *argv):
    rc = stencil2d_grid.main(["--device", "cpu", "--mesh", "1,1",
                              "--nx-local", "16", "--ny-local", "24",
                              "--n-iter", "4", "--n-warmup", "2", *argv])
    out = capsys.readouterr().out
    assert rc == 0, out
    m = re.search(GRID_RE, out)
    assert m, out
    return m, out


@pytest.mark.parametrize("kernel", ["torch", "hand"])
def test_driver_f64_gates(capsys, kernel):
    m, out = run_ok(capsys, "--dtype", "float64", "--kernel", kernel)
    assert (m.group(1), m.group(2)) == ("1", "1")
    assert float(m.group(4)) < 1e-8 and float(m.group(5)) < 1e-8
    assert "step mean=" in out and "FAIL" not in out


def test_driver_f32_and_jsonl(capsys, tmp_path):
    jl = tmp_path / "grid.jsonl"
    run_ok(capsys, "--kernel", "hand", "--jsonl", str(jl))
    recs = [json.loads(line) for line in jl.read_text().splitlines()]
    assert [r["kind"] for r in recs] == ["manifest", "topo", "clock_sync",
                                         "grid_test", "iter"]
    recs = recs[3:]
    assert recs[0]["kernel"] == "hand" and np.isfinite(recs[0]["residual"])


def test_driver_tight_tol_fails_and_bad_meshes(capsys):
    rc = stencil2d_grid.main(["--device", "cpu", "--nx-local", "16",
                              "--ny-local", "24", "--n-iter", "2",
                              "--tol", "1e-20"])
    assert rc == 1
    assert "ERR_NORM FAIL grid" in capsys.readouterr().out
    # a grid the world does not multiply to: the JAX driver's ERROR line
    assert stencil2d_grid.main(["--device", "cpu", "--mesh", "2,4"]) == 2
    assert capsys.readouterr().out.splitlines()[-1] \
        == "ERROR --mesh 2,4 needs 8 devices, have 1"
    assert stencil2d_grid.main(["--device", "cpu", "--mesh", "3"]) == 2
    for argv in (["--nx-local", "4"], ["--kernel", "pallas"]):
        with pytest.raises(SystemExit):
            stencil2d_grid.main(["--device", "cpu"] + argv)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("tile_rows", [None, 16])
def test_dual_dim_step_lean_matches_pallas(dtype, tile_rows):
    """The lean (difference-form) body's plain version against the Pallas
    kernel's ``lean=True`` body in interpret mode: the tolerances of the
    raw body's test above (bit-equal derivatives in bfloat16, where both
    sides round every op and fold the scale into the taps the same
    way). The bfloat16 residual is held to two bf16 ulps
    (``hand.RESIDUAL_RTOL``; the JAX test allows 0.02): the Pallas body
    rounds each row block's partial to bf16 and sums those in bf16, the
    port rounds its one float32 sum once."""
    z = field(32, (4 + 2 * 2 + 66, 52 + 2 * 2), dtype)
    ax, ay, ar = dual_dim_step_pallas(jnp.asarray(z), 2, SX, SY,
                                      interpret=True, tile_rows=tile_rows,
                                      lean=True)
    zt = array_from_jax(z)
    before = hand.dual_dim_step.launches
    bx, by, br = hand.dual_dim_step(zt, 2, SX, SY, lean=True)
    assert hand.dual_dim_step.launches == before
    assert bx.dtype == by.dtype == br.dtype == zt.dtype
    ax, ay = np.asarray(ax, np.float64), np.asarray(ay, np.float64)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(wide(bx), ax)
        np.testing.assert_array_equal(wide(by), ay)
    else:
        np.testing.assert_allclose(wide(bx), ax, atol=1e-5)
        np.testing.assert_allclose(wide(by), ay, atol=1e-5)
    rtol = (hand.RESIDUAL_RTOL[torch.bfloat16] if dtype == "bfloat16"
            else 1e-3)
    assert abs(float(br) - float(ar)) <= rtol * max(1.0, abs(float(ar)))
    rx, ry, rr = hand.dual_dim_step_ref(zt, 2, SX, SY, lean=True)
    assert torch.equal(rx, bx) and torch.equal(ry, by) and rr == br


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_lean_default_is_off_and_bodies_differ_by_association(dtype):
    """``lean=None`` resolves through the copy of the JAX package's
    ``_DUAL_DIM_LEAN_DEFAULT`` (both False), so no existing path changes;
    the lean body's values differ from the raw body's by rounding only."""
    from tpu_mpi_tests.kernels import pallas_kernels as PK

    assert hand._DUAL_DIM_LEAN_DEFAULT == PK._DUAL_DIM_LEAN_DEFAULT
    zt = array_from_jax(field(33, (30, 41), dtype))
    raw = hand.dual_dim_step(zt, 2, SX, SY)
    for got, want in zip(hand.dual_dim_step(zt, 2, SX, SY, lean=None), raw):
        assert torch.equal(got, want)
    lean = hand.dual_dim_step(zt, 2, SX, SY, lean=True)
    tol = 1e-12 if dtype == "float64" else 1e-5
    for got, want in zip(lean, raw):
        np.testing.assert_allclose(wide(got), wide(want), rtol=tol,
                                   atol=tol)
    assert not torch.equal(lean[0], raw[0])
