"""The routes of the port's ring halo and one-shot kernels, on the CPU.

The CUDA launchers of ``csrc/ring_halo.cu`` and ``csrc/oneshot.cu`` take
the route the wrapper names and refuse any other. The ring halo's rule
lives in ``hand.halo_route``: "vec16" (each thread moves 16-byte
vectors) when the array and both neighbours' copies start on 16 bytes,
the row pitch is whole 16-byte vectors and, along axis 1, so is a row's
band, and the extent holds 3·n_bnd (a smaller one is staged through one
CTA); else "scalar". The one-shot kernel takes the collectives' rule,
``hand.coll_route``, over the shard. Here: the route of each class of
alignment, pitch, band width and element size, on both axes and on the
staged extents; every ring-halo operand of ``chip_smoke.py``'s main
path and collbench's one-shot shards with the route each must take;
``hand.route_counts()`` listing both kernels and
``hand.reset_launch_counts()`` resetting them; the CPU wrappers (their
plain versions) counting no route; and the plain world that the card's
cross-wired ring-halo instances are held to
(``hand.ring_halo_world_ref``) against the JAX package's interpreted
``ring_halo_pallas`` on 2- and 4-device meshes. The card's own tests of
the routes are in ``tests/test_torch_gpu.py``; the plain versions are
held against the JAX package in ``tests/test_torch_rdma.py`` and
``tests/test_torch_collectives.py``.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_mpi_tests.comm import collectives as JC
from tpu_mpi_tests.comm import halo as JH
from tpu_mpi_tests.comm.mesh import make_mesh
from tpu_mpi_tests_torch.kernels import hand

F32, F64, BF16 = torch.float32, torch.float64, torch.bfloat16
REPO = Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def vec(dtype) -> int:
    """Elements of ``dtype`` in one 16-byte vector."""
    return hand.COLL_VEC_BYTES // torch.empty((), dtype=dtype).element_size()


# ---------------------------------------------------------------------------
# the ring halo's rule
# ---------------------------------------------------------------------------

HALO_CLASSES = [
    # dtype, shape, axis, n_bnd, route
    (F32, (40, 64), 0, 2, "vec16"),     # pitch 256 bytes
    (F32, (40, 45), 0, 2, "scalar"),    # pitch 180 bytes
    (F32, (40, 46), 0, 2, "scalar"),    # pitch 184 bytes
    (F64, (40, 2), 0, 1, "vec16"),      # one vector a row
    (F64, (40, 3), 0, 1, "scalar"),
    (BF16, (40, 8), 0, 3, "vec16"),     # any n_bnd along axis 0
    (BF16, (40, 12), 0, 3, "scalar"),   # pitch 24 bytes
    (F32, (45, 64), 1, 4, "vec16"),     # band 16 bytes
    (F32, (45, 64), 1, 8, "vec16"),     # band 32 bytes
    (F32, (45, 64), 1, 2, "scalar"),    # band 8 bytes
    (F32, (45, 66), 1, 4, "scalar"),    # pitch 264 bytes
    (BF16, (37, 96), 1, 8, "vec16"),
    (BF16, (37, 96), 1, 4, "scalar"),
    (F64, (45, 40), 1, 2, "vec16"),
    (F64, (45, 40), 1, 3, "scalar"),
    (F32, (6, 64), 0, 2, "vec16"),      # extent 3·n_bnd: not staged
    (F32, (5, 64), 0, 2, "scalar"),     # 3·n_bnd − 1: staged
    (F32, (4, 64), 0, 2, "scalar"),     # 2·n_bnd: staged
    (F32, (45, 24), 1, 8, "vec16"),
    (F32, (45, 23), 1, 8, "scalar"),    # staged (and odd pitch)
    (F32, (45, 16), 1, 8, "scalar"),    # 2·n_bnd: staged
    (F32, (1000,), 0, 2, "scalar"),     # a column: 4-byte pitch
    (F64, (1000,), 0, 2, "scalar"),
]


@pytest.mark.parametrize("dtype,shape,axis,n_bnd,route", HALO_CLASSES)
def test_halo_route_of_each_class(dtype, shape, axis, n_bnd, route):
    z = torch.zeros(shape, dtype=dtype)
    assert z.data_ptr() % hand.COLL_VEC_BYTES == 0
    assert hand.halo_route(z, axis, n_bnd) == route
    assert hand.halo_route(z, axis, n_bnd, z.data_ptr(),
                           z.data_ptr()) == route


@pytest.mark.parametrize("dtype", [BF16, F32, F64])
@pytest.mark.parametrize("axis", [0, 1])
def test_halo_route_needs_every_pointer_aligned(dtype, axis):
    """My array, the left neighbour's copy or the right one's off 16
    bytes: scalar. A view one element off 16 bytes of a vec16 geometry
    takes scalar too."""
    v = vec(dtype)
    item = 16 // v
    z = torch.zeros((40, 8 * v), dtype=dtype)
    n_bnd = v if axis == 1 else 2
    good = [4096, 1 << 40]
    assert hand.halo_route(z, axis, n_bnd, *good) == "vec16"
    for i in range(2):
        for bad in range(item, 16, item):
            ptrs = list(good)
            ptrs[i] += bad
            assert hand.halo_route(z, axis, n_bnd, *ptrs) == "scalar"
    base = torch.zeros(40 * 8 * v + 1, dtype=dtype)
    view = base[1:].view(40, 8 * v)
    assert hand.halo_route(view, axis, n_bnd) == "scalar"


@pytest.mark.parametrize("dtype", [BF16, F32, F64])
def test_halo_route_band_rule_by_itemsize(dtype):
    """Along axis 1 (a pitch of whole vectors, an extent that holds
    3·n_bnd): vec16 exactly when n_bnd · itemsize is a multiple of 16,
    for every n_bnd up to 16; along axis 0 the band is whole rows, so
    every n_bnd takes vec16."""
    item = torch.empty((), dtype=dtype).element_size()
    for n_bnd in range(1, 17):
        z1 = torch.zeros((7, 48 * vec(dtype)), dtype=dtype)
        want = "vec16" if n_bnd * item % 16 == 0 else "scalar"
        assert hand.halo_route(z1, 1, n_bnd) == want, n_bnd
        z0 = torch.zeros((3 * n_bnd, vec(dtype)), dtype=dtype)
        assert hand.halo_route(z0, 0, n_bnd) == "vec16", n_bnd


def test_halo_route_refuses_what_ring_halo_refuses():
    with pytest.raises(ValueError, match="no two bands"):
        hand.halo_route(torch.zeros(3), 0, 2)
    with pytest.raises(ValueError, match="axis 0"):
        hand.halo_route(torch.zeros(10), 1, 2)
    with pytest.raises(ValueError, match="1-D or 2-D"):
        hand.halo_route(torch.zeros(2, 3, 4), 0, 1)


def test_ring_halo_main_path_operands_take_their_route():
    """Every ring-halo operand of chip_smoke's main path, with the route
    it must take: the stencil2d --rdma dim-0 shard, the iterate leg and
    the bench's rdma-chained buffer in both dtypes on vec16; the dim-1
    shard (an 8-byte band a row) and stencil1d's column on scalar.
    Checked on meta tensors (the rule reads shapes, and an aligned
    address), without the memory."""
    want = {"stencil2d --rdma dim 0": "vec16",
            "stencil2d --rdma dim 1": "scalar",
            "stencil2d iterate leg": "vec16",
            "bench rdma-chained float32": "vec16",
            "bench rdma-chained bfloat16": "vec16",
            "stencil1d --staging pallas": "scalar"}
    S = _chip_smoke()
    assert {op[5] for op in S.RING_MAIN_PATH} == set(want)
    for shape, axis, n_bnd, dtype, route, leg in S.RING_MAIN_PATH:
        z = torch.empty(shape, dtype=getattr(torch, dtype), device="meta")
        assert route == want[leg], leg
        assert hand.halo_route(z, axis, n_bnd, 1 << 20, 1 << 21) == route, \
            leg
    assert S.ring_routes(("stencil2d --rdma dim 0", 4),
                         ("stencil2d --rdma dim 1", 3),
                         ("stencil2d iterate leg", 2)) == \
        {"vec16": 6, "scalar": 3}


# ---------------------------------------------------------------------------
# the one-shot kernel's routes: the collectives' rule over the shard
# ---------------------------------------------------------------------------

def test_oneshot_collbench_shards_take_vec16():
    """collbench's hand-tier shards (4 KiB to 16 MiB of float32) are
    fresh allocations of whole 16-byte vectors: vec16."""
    S = _chip_smoke()
    x = torch.empty(0, dtype=F32)
    for kib in S.COLLBENCH_SIZES_KIB:
        n = kib * 1024 // 4
        assert hand.coll_route(x, n, 1 << 20, 1 << 21) == "vec16", kib


@pytest.mark.parametrize("dtype", [BF16, F32, F64])
@pytest.mark.parametrize("n", [1, 7, 8, 1001, 1024, 4095, 4096])
def test_oneshot_route_by_length_and_alignment(dtype, n):
    item = torch.empty((), dtype=dtype).element_size()
    x = torch.zeros(n, dtype=dtype)
    want = "vec16" if n * item % 16 == 0 else "scalar"
    assert hand.coll_route(x, x.numel(), 4096, 8192) == want
    assert hand.coll_route(x, x.numel(), 4096, 8192 + item) == "scalar"


# ---------------------------------------------------------------------------
# the counts: route_counts, reset, the CPU path
# ---------------------------------------------------------------------------

def test_route_counts_lists_ring_halo_and_oneshot():
    hand.reset_launch_counts()
    counts = hand.route_counts()
    for name in ("ring_halo", "oneshot"):
        assert counts[name] == dict.fromkeys(hand.COLL_ROUTES, 0)
    hand.ring_halo.launches_by_route["vec16"] = 3
    hand.oneshot.launches_by_route["scalar"] = 4
    assert hand.route_counts()["ring_halo"]["vec16"] == 3
    assert hand.route_counts()["oneshot"]["scalar"] == 4
    hand.reset_launch_counts()
    assert hand.ring_halo.launches_by_route == \
        dict.fromkeys(hand.COLL_ROUTES, 0)
    assert hand.oneshot.launches_by_route == \
        dict.fromkeys(hand.COLL_ROUTES, 0)


@pytest.mark.parametrize("shape,axis,n_bnd", [((40, 64), 0, 2),
                                              ((45, 64), 1, 4),
                                              ((5, 64), 0, 2),
                                              ((1000,), 0, 2)])
@pytest.mark.parametrize("periodic", [True, False])
def test_cpu_ring_halo_is_the_plain_version_and_counts_no_route(
        shape, axis, n_bnd, periodic):
    hand.reset_launch_counts()
    z = torch.from_numpy(np.random.default_rng(5).normal(size=shape))
    want = hand.ring_halo_ref(z.clone(), axis, n_bnd, periodic)
    assert torch.equal(hand.ring_halo(z, axis, n_bnd, periodic), want)
    assert hand.ring_halo.launches == 0
    assert hand.route_counts()["ring_halo"] == \
        dict.fromkeys(hand.COLL_ROUTES, 0)


@pytest.mark.parametrize("n", [7, 1024])
@pytest.mark.parametrize("op", ["gather", "sum"])
def test_cpu_oneshot_is_the_plain_version_and_counts_no_route(n, op):
    hand.reset_launch_counts()
    x = torch.from_numpy(np.random.default_rng(n).normal(size=n))
    assert torch.equal(hand.oneshot(x, op), hand.oneshot_ref(x, op))
    assert hand.oneshot.launches == 0
    assert hand.route_counts()["oneshot"] == \
        dict.fromkeys(hand.COLL_ROUTES, 0)


# ---------------------------------------------------------------------------
# the cross-wired instances' plain world, against the JAX package
# ---------------------------------------------------------------------------

def test_ring_halo_world_of_one_is_the_self_ring():
    for periodic in (True, False):
        z = torch.from_numpy(np.random.default_rng(9).normal(size=(12, 5)))
        got = hand.ring_halo_world_ref([z], axis=0, n_bnd=3,
                                       periodic=periodic)[0]
        assert torch.equal(got, hand.ring_halo_ref(z.clone(), 0, 3,
                                                   periodic))


@pytest.mark.parametrize("w", [2, 4])
@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("axis,n_bnd,extent", [(0, 2, 9), (1, 3, 8)])
def test_ring_halo_world_ref_matches_the_jax_ring(w, periodic, axis, n_bnd,
                                                  extent):
    """The plain world of w ranks (the card's cross-wired ring halo is
    held to it) against the JAX package's interpreted ring_halo_pallas
    on a w-device mesh: exact. Extents 9 (n_bnd 2) and 8 (n_bnd 3: under
    3·n_bnd, staged)."""
    shape = (extent, 6) if axis == 0 else (6, extent)
    rng = np.random.default_rng(40 + w)
    shards = [rng.normal(size=shape) for _ in range(w)]
    mesh = make_mesh({"shard": w}, devices=jax.devices()[:w])
    glob = JC.shard_1d(jnp.asarray(np.concatenate(shards, axis=axis)), mesh,
                       axis=axis)
    ring = JH._exchange_pallas_fn(mesh, "shard", axis, 2, n_bnd, periodic,
                                  interpret=True)
    want = np.split(np.asarray(ring(glob)), w, axis=axis)
    got = hand.ring_halo_world_ref([torch.from_numpy(s) for s in shards],
                                   axis=axis, n_bnd=n_bnd, periodic=periodic)
    for g, e in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), e)
