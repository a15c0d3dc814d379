"""The port's copy of the domain layouts against the JAX package's.

The numpy layouts are copies, so shapes, coordinates and ``init_shard``
must be bit-identical. The device-init helpers compute as the JAX
helpers do — in the target dtype, op by op, in the same order, with
Python scalars rounded to the dtype first, the index vector built as
``jnp.arange`` builds it and ``x³`` as the multiplications XLA lowers it
to — so they are bit-identical too, in float64, float32 and bfloat16
(0 ulps).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_mpi_tests.arrays import domain as JD
from tpu_mpi_tests.kernels.stencil import analytic_pairs as jax_pairs
from tpu_mpi_tests_torch.arrays import domain as TD
from tpu_mpi_tests_torch.kernels.stencil import analytic_pairs as torch_pairs
from tpu_mpi_tests_torch.utils import TpuMtError

GEOMS = [dict(n_local_deriv=12, n_global_other=20, n_shards=3, n_bnd=2),
         dict(n_local_deriv=8, n_global_other=6, n_shards=1, n_bnd=8)]


DTYPES = [(jnp.float64, torch.float64), (jnp.float32, torch.float32),
          (jnp.bfloat16, torch.bfloat16)]


def assert_bits_equal(got: torch.Tensor, want):
    """Equal values in the same dtype (bfloat16 compared widened, which
    is exact)."""
    want = np.asarray(want)
    assert str(got.dtype).split(".")[1] == want.dtype.name
    np.testing.assert_array_equal(got.double().numpy(),
                                  want.astype(np.float64))


@pytest.mark.parametrize("geom", GEOMS)
@pytest.mark.parametrize("dim", [0, 1])
def test_domain2d_layout_and_init_shard_identical(geom, dim):
    jd, td = JD.Domain2D(dim=dim, **geom), TD.Domain2D(dim=dim, **geom)
    for prop in ("n_global_deriv", "delta", "scale", "local_shape",
                 "ghosted_shape", "global_ghosted_shape",
                 "global_interior_shape"):
        assert getattr(td, prop) == getattr(jd, prop), prop
    f, df = jax_pairs()[f"2d_dim{dim}"]
    for r in range(geom["n_shards"]):
        np.testing.assert_array_equal(td.init_shard(f, r),
                                      jd.init_shard(f, r))
        np.testing.assert_array_equal(td.interior_shard(df, r),
                                      jd.interior_shard(df, r))
    zg = jd.init_global(f)
    np.testing.assert_array_equal(td.init_global(f), zg)
    np.testing.assert_array_equal(td.strip_ghosts_global(zg),
                                  jd.strip_ghosts_global(zg))
    np.testing.assert_array_equal(td.interior_global(df),
                                  jd.interior_global(df))


def test_domain1d_layout_identical():
    jd = JD.Domain1D(n_global=24, n_shards=4)
    td = TD.Domain1D(n_global=24, n_shards=4)
    f, _ = jax_pairs()["1d"]
    for prop in ("n_local", "delta", "scale", "n_ghosted"):
        assert getattr(td, prop) == getattr(jd, prop), prop
    zg = jd.init_global(f)
    np.testing.assert_array_equal(td.init_global(f), zg)
    np.testing.assert_array_equal(td.strip_ghosts_global(zg),
                                  jd.strip_ghosts_global(zg))
    tf, tdf = torch_pairs()["1d"]
    _, df = jax_pairs()["1d"]
    for r in range(4):
        for jdt, tdt in DTYPES:
            assert_bits_equal(td.init_shard_torch(tf, r, tdt, "cpu"),
                              jd.init_shard_jax(f, r, jdt))
            assert_bits_equal(td.interior_shard_torch(tdf, r, tdt, "cpu"),
                              jd.interior_shard_jax(df, r, jdt))
    with pytest.raises(TpuMtError):
        TD.Domain1D(n_global=10, n_shards=4)


@pytest.mark.parametrize("dim", [0, 1])
def test_init_shard_torch_against_jax_helpers(dim):
    # the first geometry has 3 shards (edge and middle ranks); the wide
    # one has coordinates past 256, where a bfloat16 iota rounds
    for geom in (GEOMS[0], dict(n_local_deriv=300, n_global_other=280,
                                n_shards=2, n_bnd=2)):
        jd = JD.Domain2D(dim=dim, **geom)
        td = TD.Domain2D(dim=dim, **geom)
        f, df = jax_pairs()[f"2d_dim{dim}"]
        tf, tdf = torch_pairs()[f"2d_dim{dim}"]
        for r in range(geom["n_shards"]):
            for jdt, tdt in DTYPES:
                assert_bits_equal(td.init_shard_torch(tf, r, tdt, "cpu"),
                                  jd.init_shard_jax(f, r, jdt))
                assert_bits_equal(
                    td.interior_shard_torch(tdf, r, tdt, "cpu"),
                    jd.interior_shard_jax(df, r, jdt))
