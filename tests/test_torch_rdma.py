"""The hand RDMA ring's paths on gloo worlds of 2 and 4 ranks (CPU): the
``pallas`` staging, the ``rdma-chained`` and ``rdma-fused`` tiers, and the
drivers' and bench's RDMA legs, held against the JAX package on a 2- and
4-device mesh; plus the world=1 plain versions and the wrappers' checks.

On the CPU the wrappers take their plain versions (``ring_halo_ref``,
``stencil2d_fused_rdma_ref``), which exchange over the gloo ring; the
kernels themselves run in ``tests/test_torch_gpu.py`` and
``chip_smoke.py``. One world per size is spawned for the file
(``tests/torch_dist_workers.py``, suite ``rdma``).

Pairs and tolerances:

* ``halo_exchange(staging="pallas")`` against the ppermute exchange
  (DIRECT) and, for 2-D shards, against the interpreted
  ``ring_halo_pallas`` (``test_ring_rdma_halo_matches_ppermute``,
  ``tests/test_pallas.py:355``): exact (copies);
* ``iterate_hand_fn(rdma=True)`` against ``iterate_pallas_fn(rdma=True)``
  interpreted (``test_iterate_rdma_matches_ppermute_tier``, :937): float64
  within 1e-13 (XLA contracts a mul+add into an FMA on the CPU);
* ``iterate_fused_rdma_fn`` against the port's chained tier:
  ``np.array_equal`` (the fused tier is the chain by construction,
  :1262-:1364); against the JAX fused tier: ``np.array_equal`` in
  bfloat16, and in float32 within 2e-6 absolute on values of order 1 —
  XLA on the CPU contracts the update's mul+add into an FMA, eager torch
  rounds the product (one float32 ulp per step at most).
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
from tpu_mpi_tests_torch.comm import halo as TH
from tpu_mpi_tests_torch.kernels import hand

WORLDS = (2, 4)
TOL = 1e-13


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return {w: W.spawn("rdma", w, tmp_path_factory.mktemp(f"rdma{w}"))
            for w in WORLDS}


@pytest.fixture(scope="module")
def meshes():
    return {w: make_mesh({"shard": w}, devices=jax.devices()[:w])
            for w in WORLDS}


def sharded(a, mesh, axis=0):
    return JC.shard_1d(jnp.asarray(a), mesh, axis=axis)


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("case", [c for c in W.EXCHANGE_CASES
                                  if c[0] == "pallas"],
                         ids=lambda c: W.exchange_name(*c))
def test_pallas_exchange_matches_ppermute(runs, meshes, w, case):
    _, ax, per, nd = case
    m = meshes[w]
    g = W.global_field(W.exchange_seed(*case), W.exchange_shape(w, ax, nd))
    got = W.join(runs[w], W.exchange_name(*case), w, ax)
    want = np.asarray(JH.halo_exchange(sharded(g, m, ax), m, axis=ax,
                                       n_bnd=2, periodic=per,
                                       staging="direct"))
    np.testing.assert_array_equal(got, want)
    if nd == 2:
        ring = JH._exchange_pallas_fn(m, "shard", ax, 2, 2, per,
                                      interpret=True)
        np.testing.assert_array_equal(got, np.asarray(ring(
            sharded(g, m, ax))))


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("ax,steps,per", sorted({c[:3]
                                                 for c in W.HAND_CASES}))
def test_rdma_chained_matches_pallas(runs, meshes, w, ax, steps, per):
    g = W.global_field(20 + steps, W.hand_shape(w, ax, steps))
    run = JH.iterate_pallas_fn(meshes[w], "shard", 2 * steps, W.SE, axis=ax,
                               interpret=True, steps=steps, periodic=per,
                               rdma=True)
    want = np.asarray(run(sharded(g, meshes[w], ax), 3))
    got = W.join(runs[w], f"rdma_ax{ax}_s{steps}_p{int(per)}", w, ax)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("i", range(len(W.FUSED_RDMA_CASES)),
                         ids=lambda i: "s{}-p{:d}-{}-n{}-t{}".format(
                             *W.FUSED_RDMA_CASES[i]))
def test_fused_rdma_equals_chained_and_jax(runs, meshes, w, i):
    steps, per, dt, nloc, tile = W.FUSED_RDMA_CASES[i]
    K = 2 * steps
    fused = W.join(runs[w], f"fused_rdma_{i}", w)
    assert np.array_equal(fused, W.join(runs[w], f"chained_rdma_{i}", w))
    g = W.global_field(50 + i, (w * (nloc + 2 * K), 32), dtype=np.float32)
    run = JH.iterate_fused_rdma_fn(meshes[w], "shard", K, 1e-2,
                                   interpret=True, steps=steps,
                                   periodic=per, tile_rows=tile)
    jdt = jnp.bfloat16 if dt == "bfloat16" else jnp.float32
    want = np.asarray(run(JC.shard_1d(jnp.asarray(g, jdt), meshes[w],
                                      axis=0), 3)).astype(np.float32)
    if dt == "bfloat16":
        assert np.array_equal(fused, want)
    else:
        np.testing.assert_allclose(fused, want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("w", WORLDS)
def test_peer_pairs_freed_with_their_results(runs, w):
    """A runner called on a fresh input takes one new pair, called on its
    own result reuses it, and the pair goes when the results go: the
    ring's allocations stay the same in number however often the fused
    and the chained runner run."""
    for r in range(w):
        counts = W.load_rank(runs[w], "pair_allocs", r).tolist()
        n0 = counts[0]
        assert counts[1:] == [n0 + 1, 1, n0] * 4, counts


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("tier", ["rdma-chained", "rdma-fused"])
def test_stencil2d_rdma_driver_at_world(runs, w, tier):
    for r in range(w):
        out = W.read_text(runs[w], f"driver_stencil2d_{tier}", r)
        assert out.startswith("RC 0\n"), out
        assert f"ITER tier={tier} steps=1 n={24 * w}x16 world={w}" in out
        assert "ITER BITWISE fused==chained over 3 calls: OK" in out
        assert "OVERLAP stencil2d_fused_rdma overlap_frac=" in out
        assert out.count("TEST dim:") == 6
        assert "FAIL" not in out and "NOTE" not in out


@pytest.mark.parametrize("w", WORLDS)
def test_stencil1d_pallas_staging_at_world(runs, w):
    for r in range(w):
        out = W.read_text(runs[w], "driver_stencil1d_pallas", r)
        assert out.startswith("RC 0\n"), out
        assert f"{r}/{w} exchange time" in out
        assert "ERR_NORM FAIL" not in out


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("tier,dim", [("rdma-chained", 1),
                                      ("rdma-fused", 0)])
def test_bench_rdma_tiers_at_world(runs, w, tier, dim):
    """The bench at world w: the schedule names the tier, the world and
    the host layout (the JSON line comes from rank 0 only)."""
    for r in range(w):
        text = W.read_text(runs[w], f"bench_{tier}", r)
        rec = json.loads(text.splitlines()[0][len("RC "):])
        assert rec["tier"] == tier
        assert rec["schedule"] == \
            f"dim{dim}_world{w}_float32_ov1_{tier}_h1x{w}"
        # the rate itself is a host-clock difference of two short CPU
        # runs: noise under load may void it (NaN), never the schedule
        assert rec["unit"] == "iter/s" and len(rec["samples"]) == 1
        printed = text.splitlines()[1:]
        assert (len(printed) == 1) == (r == 0)


@pytest.mark.parametrize("w", WORLDS)
def test_bench_refuses_n_not_dividing_world(runs, w):
    """A TPU_MPI_BENCH_N the world does not divide raises rather than
    timing a smaller domain than the row's name says."""
    for r in range(w):
        got = W.read_text(runs[w], "bench_n65", r)
        assert got == f"TPU_MPI_BENCH_N over the world: 65 not evenly " \
                      f"divisible by {w}", got


# ---------------------------------------------------------------------------
# world=1 and the wrappers' checks
# ---------------------------------------------------------------------------


def _mesh1():
    return make_mesh({"shard": 1}, devices=jax.devices()[:1])


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("n_bnd", [1, 2, 5])
def test_ring_halo_world1_matches_pallas_ring(axis, periodic, n_bnd):
    """The self-ring at world=1, extents under 3·n_bnd included: exact
    against the interpreted ring_halo_pallas."""
    m = _mesh1()
    for n in (2 * n_bnd, 3 * n_bnd - 1, 17):
        shape = (n, 6) if axis == 0 else (6, n)
        z = W.global_field(60 + n, shape)
        want = np.asarray(JH._exchange_pallas_fn(
            m, "shard", axis, 2, n_bnd, periodic, interpret=True)(
                sharded(z, m, axis)))
        got = hand.ring_halo(torch.from_numpy(z.copy()), axis=axis,
                             n_bnd=n_bnd, periodic=periodic)
        np.testing.assert_array_equal(got.numpy(), want)


def test_ring_halo_1d_column_and_checks():
    z = torch.arange(10.0)
    hand.ring_halo(z, n_bnd=2, periodic=True)
    assert z.tolist() == [6, 7, 2, 3, 4, 5, 6, 7, 2, 3]
    with pytest.raises(ValueError):
        hand.ring_halo(torch.zeros(3), n_bnd=2)  # no two bands
    with pytest.raises(ValueError):
        hand.ring_halo(torch.zeros(10), axis=1)
    with pytest.raises(ValueError):
        hand.ring_halo(torch.zeros(2, 3, 4))


@pytest.mark.parametrize("steps", [1, 2])
@pytest.mark.parametrize("periodic", [False, True])
def test_fused_rdma_world1_matches_jax(steps, periodic):
    """≅ ``test_fused_rdma_world1_pure_compute`` /
    ``_periodic_self_ring``: bfloat16, bitwise against the JAX fused tier
    on one device and against the port's chained tier."""
    K = 2 * steps
    m = _mesh1()
    z = W.global_field(70 + steps, (24 + 2 * K, 32), dtype=np.float32)
    run = JH.iterate_fused_rdma_fn(m, "shard", K, 1e-2, interpret=True,
                                   steps=steps, periodic=periodic)
    want = np.asarray(run(JC.shard_1d(jnp.asarray(z, jnp.bfloat16), m,
                                      axis=0), 2)).astype(np.float32)
    zt = torch.from_numpy(z).to(torch.bfloat16)
    fused = TH.iterate_fused_rdma_fn(K, 1e-2, steps=steps,
                                     periodic=periodic)(zt.clone(), 2)
    chained = TH.iterate_hand_fn(K, 1e-2, axis=0, steps=steps,
                                 periodic=periodic, rdma=True)(zt.clone(), 2)
    assert torch.equal(fused, chained)
    assert np.array_equal(fused.float().numpy(), want)


def test_fused_rdma_geometry_checks():
    """≅ ``test_fused_rdma_rejects_bad_geometry`` and
    ``_kernel_rejects_unblockable_height``."""
    from tpu_mpi_tests_torch.utils import TpuMtError

    with pytest.raises(TpuMtError, match="dim-0"):
        TH.iterate_fused_rdma_fn(2, 1e-2, axis=1)
    with pytest.raises(TpuMtError, match="deep halos"):
        TH.iterate_fused_rdma_fn(2, 1e-2, steps=2)
    with pytest.raises(ValueError, match="seam"):
        hand.stencil2d_fused_rdma(torch.zeros(34, 16), 1e-2, steps=4,
                                  local_only=True, tile_rows=8)
    with pytest.raises(ValueError, match="too small"):
        hand.stencil2d_fused_rdma(torch.zeros(16, 16), 1e-2, steps=4)
    assert hand.fused_block_rows(8208, 4, route="smem") == 57
    assert hand.fused_block_rows(8208, 4) == 0  # the launcher's block
    assert hand.fused_block_rows(40, 4, route="smem") == 40
    assert hand.fused_block_rows(112, 1, tile_rows=16) == 16


def test_fused_overlap_record_fields():
    rec = TH.fused_overlap_record("op", steps=3, fused_s=2.0, compute_s=1.5,
                                  world=2, dtype="float32")
    want = JH.fused_overlap_record("op", steps=3, fused_s=2.0, compute_s=1.5,
                                   world=2, dtype="float32")
    assert rec == want
    assert rec["overlap_frac"] == 0.75 and rec["drain_s"] == 0.5
