"""The routes of the port's halo staging copies, on the CPU.

The CUDA launchers of ``csrc/pack.cu`` (``pack_edges``, ``unpack_ghosts``)
take the route the wrapper names and refuse any other. The rule lives in
``hand.pack_route`` and is named after the word a thread moves: "vec16"
(16 bytes), then "vec8" (8 bytes), where the word is wider than an
element, the array and both band buffers start on a word, the row pitch
is whole words and, along axis 1, so is a row's band; else "scalar". Here:
the route of each class of element size, axis, band width and pitch;
each pointer off alignment in turn; pack's and unpack's band columns on
whole words wherever a vector route is named; every staged-exchange
operand of ``chip_smoke.py`` with the route it must take;
``pack_route`` refusing what ``pack_edges`` refuses;
``hand.route_counts()`` listing both kernels and
``hand.reset_launch_counts()`` resetting them; the CPU wrappers (their
plain versions) counting no route; and ``chip_smoke.band_sectors``, the
union of the 32-byte sectors the strided side touches, against a
brute-force set of every band byte's sector. The card's own tests of the
routes are in ``tests/test_torch_gpu.py``; the plain versions are held
against the JAX package in ``tests/test_torch_pack.py``.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_mpi_tests_torch.kernels import hand

F32, F64, BF16 = torch.float32, torch.float64, torch.bfloat16
REPO = Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def aligned(shape, dtype, offset=0):
    """A contiguous ``shape`` view ``offset`` elements past a 64-byte
    boundary."""
    item = torch.empty((), dtype=dtype).element_size()
    numel = int(np.prod(shape))
    buf = torch.zeros(numel + offset + 64, dtype=dtype)
    skip = (-buf.data_ptr() % 64) // item
    return buf[skip + offset:skip + offset + numel].view(shape)


def buffers(z, axis, n_bnd, offset=0):
    """The two band buffers of ``z``, the lo one ``offset`` elements off."""
    shape = list(z.shape)
    shape[axis] = n_bnd
    return (aligned(shape, z.dtype, offset).data_ptr(),
            aligned(shape, z.dtype).data_ptr())


# ---------------------------------------------------------------------------
# the rule
# ---------------------------------------------------------------------------

PACK_CLASSES = [
    # dtype, shape, axis, n_bnd, route
    (F32, (37, 64), 0, 2, "vec16"),     # pitch 256 bytes
    (F32, (37, 66), 0, 2, "vec8"),      # pitch 264: on 8 bytes, off 16
    (F32, (37, 201), 0, 2, "scalar"),   # pitch 804: off 8
    (F32, (37, 64), 0, 3, "vec16"),     # any n_bnd along axis 0
    (F32, (37, 66), 0, 1, "vec8"),
    (F32, (37, 64), 0, 8, "vec16"),
    (BF16, (37, 64), 0, 2, "vec16"),    # pitch 128
    (BF16, (37, 68), 0, 2, "vec8"),     # pitch 136
    (BF16, (37, 70), 0, 2, "scalar"),   # pitch 140
    (F64, (37, 64), 0, 1, "vec16"),
    (F64, (37, 65), 0, 1, "scalar"),    # pitch 520: an 8-byte word is
                                        # no wider than the element
    (F32, (45, 1028), 1, 1, "scalar"),  # band 4 bytes
    (F32, (45, 1028), 1, 2, "vec8"),    # band 8 bytes, pitch 4112
    (F32, (45, 1028), 1, 3, "scalar"),  # band 12 bytes
    (F32, (45, 1028), 1, 4, "vec16"),   # band 16 bytes
    (F32, (45, 1028), 1, 8, "vec16"),   # band 32 bytes
    (F32, (45, 1026), 1, 2, "vec8"),    # pitch 4104: off 16
    (F32, (45, 1026), 1, 4, "vec8"),    # 16-byte band, 8-byte pitch
    (F32, (45, 1027), 1, 2, "scalar"),  # odd width: seams off 8 bytes
    (F32, (45, 8196), 1, 2, "vec8"),    # the splitfused field's width
    (BF16, (45, 1028), 1, 2, "scalar"),  # band 4 bytes
    (BF16, (45, 1028), 1, 4, "vec8"),   # pitch 2056: off 16
    (BF16, (45, 1028), 1, 8, "vec8"),
    (BF16, (45, 1024), 1, 8, "vec16"),
    (BF16, (45, 1024), 1, 3, "scalar"),
    (F64, (45, 1028), 1, 1, "scalar"),  # band 8 bytes: not wider
    (F64, (45, 1028), 1, 2, "vec16"),
    (F64, (45, 1028), 1, 3, "scalar"),
    (F64, (45, 1028), 1, 8, "vec16"),
    (F64, (45, 1027), 1, 2, "scalar"),
    (F32, (1, 1028), 1, 2, "vec8"),     # one row: seams 0 and 1
    (F32, (2, 1028), 1, 8, "vec16"),
    (F32, (45, 4), 1, 2, "vec8"),       # extent 2·n_bnd
    (F32, (4, 64), 0, 2, "vec16"),
]


@pytest.mark.parametrize("dtype,shape,axis,n_bnd,route", PACK_CLASSES)
def test_pack_route_by_class(dtype, shape, axis, n_bnd, route):
    z = aligned(shape, dtype)
    assert hand.pack_route(z, axis, n_bnd) == route
    ptrs = buffers(z, axis, n_bnd)
    assert hand.pack_route(z, axis, n_bnd, *ptrs) == route


@pytest.mark.parametrize("which", ["z", "lo", "hi"])
@pytest.mark.parametrize("dtype,off_bytes,route", [
    (F32, 4, "scalar"), (F32, 8, "vec8"), (F32, 16, "vec16"),
    (F32, 24, "vec8"), (BF16, 2, "scalar"), (BF16, 8, "vec8"),
    (F64, 8, "scalar"), (F64, 32, "vec16")])
@pytest.mark.parametrize("axis", [0, 1])
def test_each_pointer_off_alignment_in_turn(which, dtype, off_bytes, route,
                                            axis):
    """An operand whose every word test passes at 16 bytes (pitch 256
    bytes, a 16-byte band along axis 1) takes the route its pointers
    allow, whichever of the three is off."""
    item = torch.empty((), dtype=dtype).element_size()
    n_bnd = 16 // item
    shape = (40, 256 // item)
    off = off_bytes // item
    z = aligned(shape, dtype, off if which == "z" else 0)
    lo, hi = buffers(z, axis, n_bnd)
    lo += off_bytes if which == "lo" else 0
    hi += off_bytes if which == "hi" else 0
    assert hand.pack_route(z, axis, n_bnd, lo, hi) == route


def test_routes_are_named_after_their_word():
    assert hand.PACK_ROUTES == ("scalar", "vec8", "vec16")
    z = aligned((8, 16), F32)
    assert [hand.pack_route(z, 0, 2, p, 0) for p in (4, 8, 16)] == \
        ["scalar", "vec8", "vec16"]


@pytest.mark.parametrize("dtype", [BF16, F32, F64])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("n_bnd", [1, 2, 3, 8])
def test_vector_routes_put_every_band_on_whole_words(dtype, axis, n_bnd):
    """Wherever a vector route is named, each band's first byte — pack's
    edges (columns b and n−2b) and unpack's ghosts (0 and n−b) — and its
    length lie on whole words in every row: the band columns follow from
    the pitch and the band, so pack and unpack take one route."""
    item = torch.empty((), dtype=dtype).element_size()
    seen = set()
    for width in range(2 * n_bnd, 2 * n_bnd + 40):
        for off in (0, 1, 2, 4):
            shape = (5, width) if axis == 1 else (2 * n_bnd + 1, width)
            z = aligned(shape, dtype, off)
            route = hand.pack_route(z, axis, n_bnd)
            seen.add(route)
            if route == "scalar":
                continue
            word = {"vec8": 8, "vec16": 16}[route]
            assert word > item
            n = shape[axis]
            for start in (n_bnd, n - 2 * n_bnd, 0, n - n_bnd):
                rows = range(shape[0]) if axis == 1 else [start]
                cols = [start] if axis == 1 else [0]
                for r in rows:
                    for c in cols:
                        at = z.data_ptr() + (r * width + c) * item
                        assert at % word == 0
                run = n_bnd * item if axis == 1 else n_bnd * width * item
                assert run % word == 0
    vectors = axis == 0 or any(n_bnd * item % w == 0 for w in (8, 16)
                               if w > item)
    assert bool(seen - {"scalar"}) == vectors


@pytest.mark.parametrize("staged", range(3))
def test_staged_exchange_operands_take_their_routes(staged):
    """chip_smoke.py's staged-exchange operands (float32, n_bnd 2), on
    fresh allocations: vec16 along axis 0, vec8 along axis 1."""
    cs = _chip_smoke()
    shape, axis = cs.STAGED_CASES[staged]
    z = torch.empty(shape, device="meta")  # no memory; data_ptr() is 0
    route = hand.pack_route(z, axis, 2, 512, 1024)
    assert route == {0: "vec16", 1: "vec8"}[axis] == cs.STAGED_ROUTES[axis]
    assert cs.STAGED_WORLD2 == ((cs.REF_N_OTHER, cs.REF_N_LOCAL + 4), 1, 2)
    assert hand.pack_route(torch.empty(cs.STAGED_WORLD2[0], device="meta"),
                           1, 2, 512, 1024) == "vec8"


def test_pack_route_refuses_what_pack_edges_refuses():
    z = torch.zeros(3, 8)
    for args, err, match in (((z, 0, 2), ValueError, "bands"),
                             ((z, 1, 0), ValueError, "n_bnd"),
                             ((z, 2, 1), ValueError, "axis"),
                             ((torch.zeros(10), 0, 2), ValueError, "2-D")):
        with pytest.raises(err, match=match):
            hand.pack_edges(*args)
        with pytest.raises(err, match=match):
            hand.pack_route(*args)
    with pytest.raises(ValueError, match="contiguous"):
        hand.pack_route(torch.zeros(8, 12).T, 0, 2)
    with pytest.raises(TypeError, match="bytes"):
        hand.pack_route(torch.zeros(8, 8, dtype=torch.uint8), 0, 2)


# ---------------------------------------------------------------------------
# the counts: route_counts, reset, the CPU path
# ---------------------------------------------------------------------------

def test_route_counts_lists_pack_and_unpack():
    hand.reset_launch_counts()
    counts = hand.route_counts()
    for name in ("pack_edges", "unpack_ghosts"):
        assert counts[name] == dict.fromkeys(hand.PACK_ROUTES, 0)
    hand.pack_edges.launches_by_route["vec8"] = 3
    hand.unpack_ghosts.launches_by_route["vec16"] = 4
    assert hand.route_counts()["pack_edges"]["vec8"] == 3
    assert hand.route_counts()["unpack_ghosts"]["vec16"] == 4
    hand.reset_launch_counts()
    for fn in (hand.pack_edges, hand.unpack_ghosts):
        assert fn.launches_by_route == dict.fromkeys(hand.PACK_ROUTES, 0)


@pytest.mark.parametrize("dtype", [BF16, F32, F64])
@pytest.mark.parametrize("shape,axis,n_bnd", [((40, 64), 0, 2),
                                              ((45, 1028), 1, 2),
                                              ((45, 1027), 1, 3),
                                              ((1, 1028), 1, 8)])
def test_cpu_wrappers_are_the_plain_version_and_count_no_route(
        dtype, shape, axis, n_bnd):
    hand.reset_launch_counts()
    g = torch.Generator().manual_seed(shape[1] + n_bnd)
    z = torch.randn(shape, generator=g).to(dtype)
    lo, hi = hand.pack_edges(z, axis, n_bnd)
    wlo, whi = hand.pack_edges_ref(z, axis, n_bnd)
    assert torch.equal(lo, wlo) and torch.equal(hi, whi)
    got = hand.unpack_ghosts(z.clone(), hi, lo, axis, n_bnd)
    assert torch.equal(got, hand.unpack_ghosts_ref(z.clone(), hi, lo, axis,
                                                   n_bnd))
    assert hand.pack_edges.launches == hand.unpack_ghosts.launches == 0
    counts = hand.route_counts()
    for name in ("pack_edges", "unpack_ghosts"):
        assert counts[name] == dict.fromkeys(hand.PACK_ROUTES, 0)


# ---------------------------------------------------------------------------
# the bound: the union of the sectors the strided side touches
# ---------------------------------------------------------------------------

def brute_sectors(shape, axis, n_bnd, itemsize, starts):
    """Bytes of the 32-byte sectors that hold any byte of the bands."""
    n0, n1 = shape
    sectors = set()
    for start in starts:
        for r in range(n0):
            for c in range(n1):
                if (c if axis == 1 else r) in range(start, start + n_bnd):
                    at = (r * n1 + c) * itemsize
                    sectors.update(range(at // 32,
                                         (at + itemsize - 1) // 32 + 1))
    return 32 * len(sectors)


@pytest.mark.parametrize("shape", [(37, 201), (16, 1028), (9, 1027)])
@pytest.mark.parametrize("itemsize", [4, 2, 8])
@pytest.mark.parametrize("n_bnd", [1, 2, 3, 8])
def test_band_sectors_is_the_union_of_sectors(shape, itemsize, n_bnd):
    cs = _chip_smoke()
    n1 = shape[1]
    for starts in ((n_bnd, n1 - 2 * n_bnd), (0, n1 - n_bnd)):
        assert cs.band_sectors(shape, 1, n_bnd, itemsize, starts) == \
            brute_sectors(shape, 1, n_bnd, itemsize, starts)


@pytest.mark.parametrize("itemsize", [4, 2, 8])
def test_band_sectors_along_axis_0_is_the_bands_bytes(itemsize):
    cs = _chip_smoke()
    shape = (12, 64 // itemsize * 3)
    assert cs.band_sectors(shape, 0, 2, itemsize, (2, 8)) == \
        brute_sectors(shape, 0, 2, itemsize, (2, 8)) == \
        2 * 2 * shape[1] * itemsize


def test_band_sectors_at_the_stencil2d_dim1_shard():
    """524288×1028 f32, n_bnd 2: 24 MiB a side (a seam's two bands share
    a sector at every other row), where counting each band's own sectors
    gave 32 MiB."""
    cs = _chip_smoke()
    for starts in ((2, 1024), (0, 1026)):
        assert cs.band_sectors((524288, 1028), 1, 2, 4, starts) == 24 << 20
