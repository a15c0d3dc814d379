"""The port's world=1 halo exchange and hot-loop runners against the JAX
package's, on a 1-device mesh, periodic and not.

Pairs: ``halo_exchange`` (every staging mode), ``iterate_fused_fn``
(torch ops vs XLA), ``iterate_hand_fn`` vs ``iterate_pallas_fn`` and
``iterate_hand_blocks_fn`` vs ``iterate_pallas_blocks_fn`` (S=2), the
Pallas side in interpret mode; plus ``split_blocks``/``merge_blocks``.
Tolerance: float64 within 1e-13 — the port repeats the JAX op order and
the remaining difference is XLA contracting a mul+add into an FMA.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_mpi_tests.comm import halo as JH
from tpu_mpi_tests.comm.collectives import shard_1d
from tpu_mpi_tests.comm.mesh import make_mesh
from tpu_mpi_tests_torch.comm import halo as TH
from tpu_mpi_tests_torch.utils import TpuMtError

TOL = 1e-13


@pytest.fixture(scope="module")
def mesh1():
    return make_mesh({"shard": 1}, devices=jax.devices()[:1])


def field(seed, shape):
    return np.random.default_rng(seed).normal(size=shape)


def on_mesh(z, mesh, axis):
    return shard_1d(jnp.asarray(z), mesh, axis=axis)


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("staging", ["direct", "device", "host"])
def test_halo_exchange_matches(mesh1, axis, periodic, staging):
    z = field(1 + axis, (14, 11) if axis == 0 else (11, 14))
    want = np.asarray(JH.halo_exchange(on_mesh(z, mesh1, axis), mesh1,
                                       axis=axis, n_bnd=2,
                                       periodic=periodic, staging=staging))
    got = TH.halo_exchange(torch.from_numpy(z.copy()), axis=axis, n_bnd=2,
                           periodic=periodic, staging=staging)
    np.testing.assert_array_equal(got.numpy(), want)


def test_staging_rejects_unported_modes():
    with pytest.raises(TpuMtError, match="ROADMAP"):
        TH.Staging.parse("pallas")
    with pytest.raises(TpuMtError):
        TH.Staging.parse("bogus")


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("periodic", [False, True])
def test_iterate_fused_fn_matches(mesh1, axis, periodic):
    z = field(3, (20, 12) if axis == 0 else (12, 20))
    run_j = JH.iterate_fused_fn(mesh1, "shard", axis, 2, 2, 4.0, 1e-2,
                                periodic=periodic)
    want = np.asarray(run_j(on_mesh(z, mesh1, axis), 5))
    run_t = TH.iterate_fused_fn(axis, 2, 4.0, 1e-2, periodic=periodic)
    got = run_t(torch.from_numpy(z.copy()), 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("steps", [1, 2])
@pytest.mark.parametrize("periodic", [False, True])
def test_iterate_hand_fn_matches_pallas(mesh1, axis, steps, periodic):
    K = 2 * steps
    z = field(4 + steps, (24 + 2 * K, 10) if axis == 0 else (10, 24 + 2 * K))
    run_j = JH.iterate_pallas_fn(mesh1, "shard", K, 0.05, axis=axis,
                                 interpret=True, steps=steps,
                                 periodic=periodic)
    want = np.asarray(run_j(on_mesh(z, mesh1, axis), 3))
    run_t = TH.iterate_hand_fn(K, 0.05, axis=axis, steps=steps,
                               periodic=periodic)
    got = run_t(torch.from_numpy(z.copy()), 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("steps", [1, 2])
def test_iterate_hand_blocks_fn_matches_pallas(periodic, steps):
    K, S = 2 * steps, 2
    z = field(8 + steps, (2 * 12 + 2 * K, 10))
    st_j = JH.split_blocks(jnp.asarray(z), S, K)
    run_j = JH.iterate_pallas_blocks_fn(S, K, 0.05, steps=steps,
                                        interpret=True, periodic=periodic)
    want = np.asarray(JH.merge_blocks(run_j(st_j, 3), K))
    run_t = TH.iterate_hand_blocks_fn(S, K, 0.05, steps=steps,
                                      periodic=periodic)
    got_blocks = run_t(TH.split_blocks(torch.from_numpy(z), S, K), 3)
    assert len(got_blocks) == S
    got = TH.merge_blocks(got_blocks, K)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_split_merge_round_trip():
    K, S = 4, 4
    z = field(11, (4 * 6 + 2 * K, 7))
    blocks = TH.split_blocks(torch.from_numpy(z), S, K)
    for b_t, b_j in zip(blocks, JH.split_blocks(jnp.asarray(z), S, K)):
        np.testing.assert_array_equal(b_t.numpy(), np.asarray(b_j))
    # blocks are separate tensors: writing one's ghosts leaves the others
    blocks[1][0:K] = -1.0
    np.testing.assert_array_equal(blocks[0].numpy(), z[0:6 + 2 * K])
    blocks = TH.split_blocks(torch.from_numpy(z), S, K)
    np.testing.assert_array_equal(TH.merge_blocks(blocks, K).numpy(), z)
    with pytest.raises(TpuMtError):
        TH.split_blocks(torch.from_numpy(z), 5, K)


def test_runner_argument_checks():
    with pytest.raises(TpuMtError):
        TH.iterate_hand_fn(4, 0.1, steps=1)  # ghost width != steps·2
    with pytest.raises(TpuMtError):
        TH.iterate_hand_blocks_fn(1, 2, 0.1)
    with pytest.raises(TpuMtError, match="ROADMAP"):
        TH.check_tier("rdma-fused")
    assert TH.check_tier("blocks") == "blocks"


def test_stencil_fn_kernels_agree():
    z = torch.from_numpy(field(12, (16, 9)))
    a = TH.stencil_fn(0, 3.0, kernel="torch")(z)
    b = TH.stencil_fn(0, 3.0, kernel="hand")(z)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(TpuMtError):
        TH.stencil_fn(0, 3.0, kernel="pallas")
