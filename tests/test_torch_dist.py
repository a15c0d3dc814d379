"""The port's multi-rank paths on gloo worlds of 2 and 4 ranks (CPU),
held against the JAX package on a 2- and 4-device mesh.

One world per size is spawned for the whole file
(``tests/torch_dist_workers.py``, suite ``dist``); every rank runs every
case there and saves its block, and each test here puts the blocks
together and compares them with the JAX function on
``make_mesh({"shard": w}, devices=jax.devices()[:w])``.

Pairs and tolerances:

* ``halo_exchange`` (DIRECT, DEVICE and HOST staging, and DEVICE through
  the hand pack/unpack kernels' plain versions), axes 0 and 1, 1-D and
  2-D, periodic or not: exact, as ``tests/test_halo.py`` (pure copies);
* ``iterate_fused_fn``, ``iterate_hand_fn`` and ``iterate_hand_blocks_fn``
  against ``iterate_fused_fn``, ``iterate_pallas_fn`` and
  ``iterate_pallas_blocks_fn`` (interpreted) on the same global problem:
  float64 within 1e-13, as ``tests/test_torch_halo.py`` (XLA on the CPU
  contracts a mul+add into an FMA; eager torch cannot);
* the collectives (``shard_1d``, ``all_gather``, ``all_gather_inplace``,
  ``allreduce_sum``, ``per_rank_sums``, ``per_rank_err_norms``,
  ``reduce_sum``, ``replicate``, ``shard_blocks``, ``device_init``):
  placements and gathers exact, sums within 1e-13 relative (another
  summation order);
* the ``stencil2d`` and ``stencil1d`` drivers at world 2 and 4: every gate
  passes on every rank, ``ITER BITWISE fused==chained`` appears;
* ``comm.dist``'s reading of the launchers' variables, and world=1 with
  no process group.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as W
from tpu_mpi_tests.comm import collectives as JC
from tpu_mpi_tests.comm import halo as JH
from tpu_mpi_tests.comm.mesh import make_mesh
from tpu_mpi_tests_torch.comm import dist, mesh as tmesh

WORLDS = (2, 4)
TOL = 1e-13


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each world's output directory (one spawn per size for the file)."""
    return {w: W.spawn("dist", w, tmp_path_factory.mktemp(f"dist{w}"))
            for w in WORLDS}


@pytest.fixture(scope="module")
def meshes():
    return {w: make_mesh({"shard": w}, devices=jax.devices()[:w])
            for w in WORLDS}


def sharded(a, mesh, axis=0):
    return JC.shard_1d(jnp.asarray(a), mesh, axis=axis)


@pytest.mark.parametrize("w", WORLDS)
def test_world_layout(runs, w):
    for r in range(w):
        got = json.loads(W.read_text(runs[w], "world", r))
        assert got == {"rank": r, "size": w, "backend": "gloo", "hosts": 1,
                       "ranks_per_host": w, "process_index": r,
                       "global_device_count": w}


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("case", [c for c in W.EXCHANGE_CASES
                                  if c[0] != "pallas"],
                         ids=lambda c: W.exchange_name(*c))
def test_halo_exchange_matches_jax(runs, meshes, w, case):
    st, ax, per, nd = case
    g = W.global_field(W.exchange_seed(*case), W.exchange_shape(w, ax, nd))
    want = np.asarray(JH.halo_exchange(sharded(g, meshes[w], ax), meshes[w],
                                       axis=ax, n_bnd=2, periodic=per,
                                       staging=st))
    np.testing.assert_array_equal(
        W.join(runs[w], W.exchange_name(*case), w, ax), want)
    if st == "device" and nd == 2:
        np.testing.assert_array_equal(
            W.join(runs[w], W.exchange_name("hand", ax, per, nd), w, ax),
            want)


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("ax,per", W.FUSED_CASES)
def test_iterate_fused_fn_matches_jax(runs, meshes, w, ax, per):
    g = W.global_field(7 + ax, (w * 16, 12) if ax == 0 else (12, w * 16))
    run = JH.iterate_fused_fn(meshes[w], "shard", ax, 2, 2, 4.0, 1e-2,
                              periodic=per)
    want = np.asarray(run(sharded(g, meshes[w], ax), 5))
    got = W.join(runs[w], f"fused_ax{ax}_p{int(per)}", w, ax)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("ax,steps,per", sorted({c[:3]
                                                 for c in W.HAND_CASES}))
def test_iterate_hand_fn_matches_pallas(runs, meshes, w, ax, steps, per):
    g = W.global_field(20 + steps, W.hand_shape(w, ax, steps))
    run = JH.iterate_pallas_fn(meshes[w], "shard", 2 * steps, W.SE, axis=ax,
                               interpret=True, steps=steps, periodic=per)
    want = np.asarray(run(sharded(g, meshes[w], ax), 3))
    got = W.join(runs[w], f"hand_ax{ax}_s{steps}_p{int(per)}", w, ax)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("S,per", W.SPLIT_CASES)
def test_iterate_hand_blocks_fn_matches_pallas(runs, meshes, w, S, per):
    K = 4
    g = W.global_field(30 + S, (w * (S * 6 + 2 * K), 12))
    m = meshes[w]
    run = JH.iterate_pallas_blocks_fn(S, K, W.SE, steps=2, interpret=True,
                                      mesh=m, axis_name="shard",
                                      periodic=per)
    st = JH.split_blocks(sharded(g, m), S, K, mesh=m)
    want = np.asarray(JH.merge_blocks(run(st, 3), K, mesh=m))
    got = W.join(runs[w], f"blocks_S{S}_p{int(per)}", w)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("w", WORLDS)
def test_placements_match_jax(runs, meshes, w):
    """shard_1d, shard_blocks, device_init: each rank holds its block."""
    g = W.global_field(40, (w * 6, 5))
    jax_blocks = [np.asarray(s.data) for s in sorted(
        sharded(g, meshes[w]).addressable_shards,
        key=lambda s: s.index[0].start)]
    for r in range(w):
        np.testing.assert_array_equal(W.load_rank(runs[w], "shard_1d", r),
                                      jax_blocks[r])
        np.testing.assert_array_equal(
            W.load_rank(runs[w], "shard_1d_ax1", r),
            W.block_of(W.global_field(41, (5, w * 6)), w, r, axis=1))
        np.testing.assert_array_equal(
            W.load_rank(runs[w], "shard_blocks", r), np.full((4, 3), r + 1.0))
        np.testing.assert_array_equal(
            W.load_rank(runs[w], "device_init", r), np.full(2, 10.0 * r))


@pytest.mark.parametrize("w", WORLDS)
def test_gathers_match_jax(runs, meshes, w):
    """all_gather (both axes) and all_gather_inplace: every rank holds
    the whole array, as JAX's replicated result."""
    g = W.global_field(40, (w * 6, 5))
    want = np.asarray(JC.all_gather(sharded(g, meshes[w]), meshes[w]))
    want_inplace = np.asarray(
        JC.all_gather_inplace(sharded(g, meshes[w]), meshes[w]))
    want_t = np.asarray(JC.all_gather(sharded(g.T.copy(), meshes[w], 1),
                                      meshes[w], axis=1))
    for r in range(w):
        np.testing.assert_array_equal(W.load_rank(runs[w], "all_gather", r),
                                      want)
        np.testing.assert_array_equal(
            W.load_rank(runs[w], "all_gather_inplace", r), want_inplace)
        np.testing.assert_array_equal(
            W.load_rank(runs[w], "all_gather_ax1", r), want_t)


@pytest.mark.parametrize("w", WORLDS)
def test_reductions_match_jax(runs, meshes, w):
    """allreduce_sum, per_rank_sums (1 and 2 groups), per_rank_err_norms,
    reduce_sum: every rank gets the JAX values (another summation order:
    1e-13 relative)."""
    m = meshes[w]
    rows = W.global_field(42, (w, 7))
    want_row = np.asarray(JC.allreduce_sum(sharded(rows, m), m))[0]
    g = W.global_field(40, (w * 6, 5))
    other = W.global_field(43, (w * 6, 5))
    want_sums = JC.per_rank_sums(sharded(g, m), m)
    want_sums2 = JC.per_rank_sums(sharded(g, m), m, groups_per_shard=2)
    want_err = JC.per_rank_err_norms(sharded(g, m), sharded(other, m), m)
    for r in range(w):
        np.testing.assert_allclose(
            W.load_rank(runs[w], "allreduce_sum", r)[0], want_row, rtol=TOL)
        np.testing.assert_allclose(
            W.load_rank(runs[w], "per_rank_sums", r), want_sums, rtol=TOL)
        np.testing.assert_allclose(
            W.load_rank(runs[w], "per_rank_sums_g2", r), want_sums2,
            rtol=TOL)
        np.testing.assert_allclose(
            W.load_rank(runs[w], "per_rank_err_norms", r), want_err,
            rtol=TOL)
        assert float(W.load_rank(runs[w], "reduce_sum", r)[0]) == \
            sum(0.25 * q + 1.0 for q in range(w))
        np.testing.assert_array_equal(W.load_rank(runs[w], "replicate", r),
                                      W.global_field(44, (3, 4)))


@pytest.mark.parametrize("w", WORLDS)
def test_stencil2d_driver_at_world(runs, w):
    for r in range(w):
        out = W.read_text(runs[w], "driver_stencil2d", r)
        assert out.startswith("RC 0\n"), out
        assert ("stencil2d: n_local=24" in out) == (r == 0)  # banner
        assert f"ITER tier=rdma-fused steps=2 n={24 * w}x16 world={w}" in out
        assert "ITER BITWISE fused==chained over 3 calls: OK" in out
        assert "OVERLAP stencil2d_fused_rdma overlap_frac=" in out
        assert "ITER FAIL" not in out and "ERR_NORM FAIL" not in out
        assert out.count("TEST dim:") == 6
        assert "NOTE" not in out


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("staging", ["direct", "device", "host"])
def test_stencil1d_driver_at_world(runs, w, staging):
    for r in range(w):
        out = W.read_text(runs[w], f"driver_stencil1d_{staging}", r)
        assert out.startswith("RC 0\n"), out
        assert f"{r}/{w} exchange time" in out
        assert f"{r}/{w} [cpu] err_norm = " in out
        assert "ERR_NORM FAIL" not in out


def test_launch_env_reads_torchrun_and_tpumt_run():
    assert dist.launch_env({}) is None
    assert dist.launch_env({"WORLD_SIZE": "4", "RANK": "2",
                            "LOCAL_RANK": "0", "MASTER_ADDR": "h",
                            "MASTER_PORT": "123"}) == {
        "rank": 2, "size": 4, "local_rank": 0, "init_method": "tcp://h:123"}
    # native/launcher.cc:114-116
    assert dist.launch_env({"JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": "1",
                            "JAX_COORDINATOR_ADDRESS": "localhost:4567"}) == {
        "rank": 1, "size": 2, "local_rank": None,
        "init_method": "tcp://localhost:4567"}
    # torchrun's variables win
    env = dist.launch_env({"WORLD_SIZE": "3", "JAX_NUM_PROCESSES": "2"})
    assert env["size"] == 3 and env["init_method"] == "tcp://localhost:29500"


def test_world1_has_no_process_group():
    """World=1 with no launcher variables: no group, the self-ring."""
    w = dist.init("cpu", environ={})
    assert (w.rank, w.size, w.backend, w.group) == (0, 1, None, None)
    ring = tmesh.make_mesh()
    assert (ring.left, ring.right) == (0, 0)
    assert ring.sends(True) == (True, True)
    assert ring.sends(False) == (False, False)
    assert ring.phys(False) == (1, 1)
    topo = tmesh.topology(torch.device("cpu"))
    assert (topo.process_index, topo.process_count,
            topo.global_device_count) == (0, 1, 1)
    assert tmesh.ranks_per_device(8) == 8


@pytest.mark.parametrize("rank,size,periodic,want", [
    (0, 4, False, (False, True)), (3, 4, False, (True, False)),
    (1, 4, False, (True, True)), (0, 4, True, (True, True)),
    (1, 2, False, (True, False))])
def test_ring_send_predicates(rank, size, periodic, want):
    """pallas_kernels.py:1775-1776: the ends of a non-periodic ring send
    (and receive) nothing across the wrap-around."""
    ring = tmesh.Ring(rank=rank, size=size)
    assert ring.sends(periodic) == want
    assert ring.phys(periodic) == tuple(int(not s) for s in want)
    assert (ring.left, ring.right) == ((rank - 1) % size, (rank + 1) % size)
