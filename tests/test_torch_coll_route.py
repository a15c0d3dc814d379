"""The routes of the port's ring collectives, on the CPU.

The CUDA launchers of ``csrc/ring_collectives.cu`` take the route the
wrapper names and refuse any other; the rule lives in
``hand.coll_route``: "vec16" (each thread moves 16-byte vectors) when
the shard and every buffer of the launch start on 16 bytes and a region
(the all-gather) or chunk (the reduce-scatter) is a whole number of
16-byte vectors, else "scalar". Here: the route of each class of
alignment, length and element size, on real tensors and on bare
addresses; the code of each route and the refusal of an unknown one;
every main-path operand's class; ``hand.route_counts()`` listing the two
collective kernels beside the attention kernels, and the CPU wrappers
(their plain versions) counting no route. The card's own tests of the
routes are in ``tests/test_torch_gpu.py``; the plain versions are held
against the JAX package in ``tests/test_torch_collectives.py``.
"""

import pytest
import torch

from tpu_mpi_tests_torch.kernels import hand

F32, F64, BF16 = torch.float32, torch.float64, torch.bfloat16


# ---------------------------------------------------------------------------
# the rule
# ---------------------------------------------------------------------------

ROUTE_CLASSES = [
    # dtype, elements of the shard, elements of a region or chunk, element
    # offset of the shard's view, route
    (F32, 1024, 1024, 0, "vec16"),
    (F32, 4, 4, 0, "vec16"),  # one vector
    (F32, 1001, 1001, 0, "scalar"),  # 4004 bytes: not whole vectors
    (F32, 1024, 1022, 0, "scalar"),
    (F32, 1028, 1024, 4, "vec16"),  # 16 bytes off: still aligned
    (F32, 1028, 1024, 1, "scalar"),  # 4 bytes off
    (F32, 1028, 1024, 2, "scalar"),  # 8 bytes off
    (F64, 2, 2, 0, "vec16"),
    (F64, 1, 1, 0, "scalar"),
    (F64, 3003, 3003, 0, "scalar"),  # 24024 bytes: 1501.5 vectors
    (F64, 1026, 1024, 2, "vec16"),
    (F64, 1026, 1024, 1, "scalar"),
    (BF16, 8, 8, 0, "vec16"),
    (BF16, 4, 4, 0, "scalar"),  # 8 bytes
    (BF16, 1001, 1001, 0, "scalar"),
    (BF16, 1032, 1024, 8, "vec16"),
    (BF16, 1032, 1024, 4, "scalar"),
]


@pytest.mark.parametrize("dtype,n,region,off,route", ROUTE_CLASSES)
def test_coll_route_of_each_class(dtype, n, region, off, route):
    base = torch.zeros(n, dtype=dtype)
    assert base.data_ptr() % hand.COLL_VEC_BYTES == 0
    x = base[off:]
    out = torch.empty(4 * n, dtype=dtype)
    assert hand.coll_route(x, region, out.data_ptr()) == route
    assert route in hand.COLL_ROUTES


@pytest.mark.parametrize("bad", [1, 2, 4, 8, 12])
def test_coll_route_needs_every_pointer_aligned(bad):
    """Any buffer of the launch off 16 bytes (an output, a receive
    buffer, a peer's comm slot, the send buffer) takes the scalar
    route; the shard alone aligned is not enough."""
    x = torch.zeros(64, dtype=F32)
    good = [4096, 8192, 1 << 40]
    assert hand.coll_route(x, 64, *good) == "vec16"
    for i in range(len(good)):
        ptrs = list(good)
        ptrs[i] += bad
        assert hand.coll_route(x, 64, *ptrs) == "scalar"


@pytest.mark.parametrize("dtype,itemsize", [(BF16, 2), (F32, 4), (F64, 8)])
def test_coll_route_length_rule_by_itemsize(dtype, itemsize):
    """vec16 exactly when n · itemsize is a multiple of 16, for every n
    up to 64 elements."""
    x = torch.zeros(64, dtype=dtype)
    for n in range(1, 65):
        want = "vec16" if n * itemsize % 16 == 0 else "scalar"
        assert hand.coll_route(x, n) == want, n


def test_coll_route_codes_and_the_refusal_of_an_unknown_route():
    assert [hand.coll_route_code(r) for r in hand.COLL_ROUTES] == [0, 1]
    assert hand.COLL_ROUTES == ("scalar", "vec16")
    for bad in ("vec8", "VEC16", "", "wgmma"):
        with pytest.raises(ValueError, match="unknown collective route"):
            hand.coll_route_code(bad)


MAIN_OPERANDS = [
    # what, dtype, elements a region or chunk at world=1
    ("stencil2d --rdma allreduce row (2 MiB)", F32, 524288),
    ("gather_inplace --rdma (1 GiB)", F64, 134217728),
    ("collbench 4 KiB", F32, 1024),
    ("collbench 16 MiB", F32, 4194304),
]


@pytest.mark.parametrize("what,dtype,n", MAIN_OPERANDS,
                         ids=[m[0] for m in MAIN_OPERANDS])
def test_every_main_path_operand_is_whole_vectors(what, dtype, n):
    """The main paths' shards are fresh allocations (aligned) of whole
    16-byte vectors, so each takes vec16; checked by the length rule on
    an empty tensor of the dtype and an aligned address, without the
    memory."""
    x = torch.empty(0, dtype=dtype)
    itemsize = x.element_size()
    assert n * itemsize % hand.COLL_VEC_BYTES == 0, what
    assert hand.coll_route(x, n, 1 << 20) == "vec16", what


# ---------------------------------------------------------------------------
# the counts: route_counts, the CPU path
# ---------------------------------------------------------------------------

def test_route_counts_lists_the_ring_collectives():
    hand.reset_launch_counts()
    counts = hand.route_counts()
    for name in ("ring_allgather", "ring_reduce_scatter"):
        assert counts[name] == dict.fromkeys(hand.COLL_ROUTES, 0)
    for name in ("flash_attention_block", "fused_ring_attention"):
        assert counts[name] == dict.fromkeys(hand.FLASH_ROUTES, 0)


def test_reset_launch_counts_resets_the_collective_routes():
    hand.ring_allgather.launches_by_route["vec16"] = 5
    hand.ring_reduce_scatter.launches_by_route["scalar"] = 2
    hand.reset_launch_counts()
    assert hand.ring_allgather.launches_by_route == \
        dict.fromkeys(hand.COLL_ROUTES, 0)
    assert hand.ring_reduce_scatter.launches_by_route == \
        dict.fromkeys(hand.COLL_ROUTES, 0)


@pytest.mark.parametrize("k", [None, 2, 4])
@pytest.mark.parametrize("rows", [1024, 1001])
def test_cpu_wrappers_are_the_plain_version_and_count_no_route(k, rows):
    hand.reset_launch_counts()
    g = torch.Generator().manual_seed(rows + (k or 1))
    x = torch.randn((rows * (k or 1),), generator=g)
    assert torch.equal(hand.ring_allgather(x, self_ring=k),
                       hand.ring_allgather_ref(x, self_ring=k))
    for credits in (1, 2):
        assert torch.equal(
            hand.ring_reduce_scatter(x, credits, self_ring=k),
            hand.ring_reduce_scatter_ref(x, credits, self_ring=k))
    counts = hand.route_counts()
    assert counts["ring_allgather"] == dict.fromkeys(hand.COLL_ROUTES, 0)
    assert counts["ring_reduce_scatter"] == \
        dict.fromkeys(hand.COLL_ROUTES, 0)
    assert hand.ring_allgather.launches == 0
    assert hand.ring_reduce_scatter.launches == 0


# ---------------------------------------------------------------------------
# the A/B script's variants
# ---------------------------------------------------------------------------

def test_coll_ab_variants_edit_text_the_sources_hold():
    """Each variant of ``kernels/coll_ab.py`` replaces a line that its
    source holds exactly once, so a variant never builds the tree
    unchanged under another name."""
    from tpu_mpi_tests_torch.kernels import build, coll_ab

    assert set(coll_ab.VARIANTS) == {"base", "u1", "u2", "u8", "fence",
                                     "acqrel", "sys"}
    for name, edits in coll_ab.VARIANTS.items():
        for file, old, new in edits:
            text = (build.CSRC / file).read_text()
            assert text.count(old) == 1, (name, old)
            assert old != new and new not in text, name
