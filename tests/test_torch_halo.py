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


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("n_bnd", [1, 2, 4])
def test_hand_staged_exchange_matches(mesh1, axis, periodic, n_bnd):
    """DEVICE_STAGED with ``kernel="hand"`` (on the CPU the pack/unpack
    kernels' plain versions) equals the JAX exchange and the port's
    DIRECT one bit for bit; non-periodic moves nothing."""
    z = field(21 + axis, (14, 11) if axis == 0 else (11, 14))
    want = np.asarray(JH.halo_exchange(on_mesh(z, mesh1, axis), mesh1,
                                       axis=axis, n_bnd=n_bnd,
                                       periodic=periodic, staging="device"))
    got = TH.halo_exchange(torch.from_numpy(z.copy()), axis=axis,
                           n_bnd=n_bnd, periodic=periodic, staging="device",
                           kernel="hand")
    np.testing.assert_array_equal(got.numpy(), want)
    direct = TH.halo_exchange(torch.from_numpy(z.copy()), axis=axis,
                              n_bnd=n_bnd, periodic=periodic)
    np.testing.assert_array_equal(got.numpy(), direct.numpy())
    if not periodic:
        np.testing.assert_array_equal(got.numpy(), z)


def test_hand_staging_on_tiny_extents_and_bad_kernel():
    """Below 3·n_bnd an edge overlaps the ghost the other edge lands in;
    the staged buffers make that harmless for both kernels."""
    z = torch.arange(5.0 * 3).reshape(5, 3)
    a = TH.exchange_shard(z.clone(), axis=0, n_bnd=2, periodic=True,
                          staged=True, kernel="hand")
    b = TH.exchange_shard(z.clone(), axis=0, n_bnd=2, periodic=True)
    assert torch.equal(a, b)
    with pytest.raises(TpuMtError, match="unknown kernel"):
        TH.halo_exchange(z, staging="device", kernel="pallas")
    with pytest.raises(ValueError, match="2-D"):
        TH.exchange_shard(torch.arange(12.0), n_bnd=2, periodic=True,
                          staged=True, kernel="hand")


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("periodic", [False, True])
def test_halo_payload_bytes_matches(axis, periodic):
    z = field(5, (14, 22))
    for dtype_j, dtype_t in ((jnp.float32, torch.float32),
                             (jnp.bfloat16, torch.bfloat16)):
        for world in (1, 4):
            want = JH.halo_payload_bytes(jnp.asarray(z, dtype_j), axis,
                                         world, 2, periodic)
            got = TH.halo_payload_bytes(torch.from_numpy(z).to(dtype_t),
                                        axis, world, 2, periodic)
            assert got == want


@pytest.mark.parametrize("periodic", [False, True])
def test_iterate_fused_fn_split_matches(mesh1, periodic):
    """``split=True``: in JAX an optimization barrier between exchange
    and stencil; in the port the same ops (nothing is fused in eager
    PyTorch). Both equal the JAX split run and the port's fused run."""
    z = field(6, (12, 20))
    run_j = JH.iterate_fused_fn(mesh1, "shard", 1, 2, 2, 4.0, 1e-2,
                                periodic=periodic, split=True)
    want = np.asarray(run_j(on_mesh(z, mesh1, 1), 5))
    got = TH.iterate_fused_fn(1, 2, 4.0, 1e-2, periodic=periodic,
                              split=True)(torch.from_numpy(z.copy()), 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    fused = TH.iterate_fused_fn(1, 2, 4.0, 1e-2, periodic=periodic)(
        torch.from_numpy(z.copy()), 5)
    assert torch.equal(got, fused)
