"""The port's copy of the domain layouts against the JAX package's.

The numpy layouts are copies, so shapes, coordinates and ``init_shard``
must be bit-identical. The device-init helpers differ by design: the
JAX helpers compute in the target dtype (every op rounded to float32),
the port's compute in float64 and cast once. So the port equals the JAX
helper run in float64 exactly, its float32 field lies within one ulp of
that value cast to float32 (it is the correctly rounded value), and it
lies a few float32 ulps from the JAX helper run in float32 — at most 8,
from the handful of float32 roundings in ``x³ + y²`` and the coordinates.
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


def ulps(got, want, dtype):
    """|got − want| in units of ``dtype``'s spacing at ``want``."""
    want_d = np.asarray(want, np.float64)
    sp = np.spacing(np.abs(want_d).astype(dtype)).astype(np.float64)
    return np.abs(np.asarray(got, np.float64) - want_d) / sp


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
    tf, _ = torch_pairs()["1d"]
    for r in range(4):
        got = td.init_shard_torch(tf, r, torch.float64, "cpu").numpy()
        want = np.asarray(jd.init_shard_jax(f, r, jnp.float64))
        assert ulps(got, want, np.float64).max() <= 1
        np.testing.assert_array_equal(got == 0, want == 0)
    with pytest.raises(TpuMtError):
        TD.Domain1D(n_global=10, n_shards=4)


@pytest.mark.parametrize("dim", [0, 1])
def test_init_shard_torch_against_jax_helpers(dim):
    geom = GEOMS[0]
    jd, td = JD.Domain2D(dim=dim, **geom), TD.Domain2D(dim=dim, **geom)
    f, df = jax_pairs()[f"2d_dim{dim}"]
    tf, tdf = torch_pairs()[f"2d_dim{dim}"]
    for r in range(geom["n_shards"]):
        j64 = np.asarray(jd.init_shard_jax(f, r, jnp.float64))
        j32 = np.asarray(jd.init_shard_jax(f, r, jnp.float32))
        t64 = td.init_shard_torch(tf, r, torch.float64, "cpu").numpy()
        t32 = td.init_shard_torch(tf, r, torch.float32, "cpu").numpy()
        assert ulps(t64, j64, np.float64).max() <= 1
        assert ulps(t32, j64.astype(np.float32), np.float32).max() <= 1
        assert ulps(t32, j32, np.float32).max() <= 8
        # the layout: interior ghosts are zero exactly where JAX's are
        np.testing.assert_array_equal(t64 == 0, j64 == 0)
        i64 = np.asarray(jd.interior_shard_jax(df, r, jnp.float64))
        got = td.interior_shard_torch(tdf, r, torch.float64, "cpu").numpy()
        assert ulps(got, i64, np.float64).max() <= 1
