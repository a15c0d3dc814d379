"""The routes of the port's streaming kernels, on the CPU.

The CUDA launchers of ``csrc/streams.cu`` (``daxpy``, ``stream_scale``,
``stream_sum3``) take the route the wrapper names and refuse any other.
The rule lives in ``hand.stream_route``, with the names of
``hand.COLL_ROUTES``: "vec16" where every data pointer of the launch
(its operands and ``out``) starts on 16 bytes, whatever n (the ragged
tail runs element by element in the same launch); else "scalar". Here:
the route of each element size with each pointer off 16 bytes in turn,
``out`` absent or an operand, n of 0, 1, a pack minus one and ragged;
``hand.route_counts()`` listing the three kernels and
``hand.reset_launch_counts()`` resetting them; the CPU wrappers (their
plain versions) counting no route; ``chip_smoke.py``'s launch schedule of
the ceiling fit, its per-route check of a path and the group edges the
card's checks cross; and the A/B tool's variants and the ptxas reader. The card's own tests of the routes are in
``tests/test_torch_gpu.py``; the plain versions are held against the JAX
package in ``tests/test_torch_daxpy.py``.
"""

import importlib.util
import re
from pathlib import Path

import pytest
import torch

from tpu_mpi_tests_torch import microbench
from tpu_mpi_tests_torch.kernels import build, hand, stream_ab

F32, F64, BF16 = torch.float32, torch.float64, torch.bfloat16
STREAMS = ("daxpy", "stream_scale", "stream_sum3")
REPO = Path(__file__).resolve().parent.parent
STREAMS_CU = REPO / "tpu_mpi_tests_torch" / "kernels" / "csrc" / "streams.cu"


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def aligned(n, dtype, off_bytes=0):
    """A 1-D ``n``-element view ``off_bytes`` past a 64-byte boundary."""
    item = torch.empty((), dtype=dtype).element_size()
    buf = torch.zeros(n + 64, dtype=dtype)
    skip = (-buf.data_ptr() % 64) // item + off_bytes // item
    return buf[skip:skip + n]


def operands(name, n, dtype, off=None, off_bytes=0):
    """The operands of ``name`` (w, x, y / x, y / x), operand ``off`` of
    them ``off_bytes`` past 16 bytes."""
    k = {"daxpy": 2, "stream_scale": 1, "stream_sum3": 3}[name]
    return tuple(aligned(n, dtype, off_bytes if i == off else 0)
                 for i in range(k))


# ---------------------------------------------------------------------------
# the rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", STREAMS)
@pytest.mark.parametrize("dtype", [BF16, F32, F64])
@pytest.mark.parametrize("n", ["zero", "one", "pack-1", "ragged"])
@pytest.mark.parametrize("out", ["none", "operand", "fresh"])
def test_stream_route_on_16_bytes_is_vec16(name, dtype, n, out):
    """Every pointer on 16 bytes: vec16 at any n, ``out`` absent (a fresh
    allocation), the last operand (in place) or its own buffer."""
    pack = 16 // torch.empty((), dtype=dtype).element_size()
    n = {"zero": 0, "one": 1, "pack-1": pack - 1, "ragged": 1000003}[n]
    ops = operands(name, n, dtype)
    dst = {"none": None, "operand": ops[-1], "fresh": aligned(n, dtype)}[out]
    assert hand.stream_route(*ops, dst) == "vec16"


@pytest.mark.parametrize("name,which", [
    (name, which) for name, k in (("daxpy", 2), ("stream_scale", 1),
                                  ("stream_sum3", 3))
    for which in (*range(k), "out")])
@pytest.mark.parametrize("dtype", [BF16, F32, F64])
def test_each_pointer_off_16_bytes_in_turn_is_scalar(name, which, dtype):
    """One pointer an element (or 8 bytes) past 16 and the launch is
    scalar, whichever it is; the others stay on 16 bytes."""
    item = torch.empty((), dtype=dtype).element_size()
    for off_bytes in sorted({item, 8}):
        ops = operands(name, 4099, dtype,
                       off=None if which == "out" else which,
                       off_bytes=off_bytes)
        out = aligned(4099, dtype, off_bytes if which == "out" else 0)
        assert hand.stream_route(*ops, out) == "scalar"
        assert hand.stream_route(*ops, None) == (
            "vec16" if which == "out" else "scalar")


@pytest.mark.parametrize("off_bytes,route", [(0, "vec16"), (16, "vec16"),
                                             (32, "vec16"), (8, "scalar"),
                                             (4, "scalar"), (2, "scalar")])
def test_stream_route_is_the_pointers_16_byte_rule(off_bytes, route):
    x = aligned(100, BF16, off_bytes)
    assert hand.stream_route(x) == route
    assert hand.stream_route(x, x, x, x) == route
    assert hand.COLL_ROUTES == ("scalar", "vec16")
    assert hand.coll_route_code(route) == hand.COLL_ROUTES.index(route)


# ---------------------------------------------------------------------------
# the counts: route_counts, reset, the CPU path
# ---------------------------------------------------------------------------

def test_route_counts_lists_the_streaming_kernels():
    hand.reset_launch_counts()
    counts = hand.route_counts()
    for name in STREAMS:
        assert counts[name] == dict.fromkeys(hand.COLL_ROUTES, 0)
    hand.daxpy.launches_by_route["vec16"] = 3
    hand.stream_scale.launches_by_route["scalar"] = 2
    hand.stream_sum3.launches_by_route["vec16"] = 5
    counts = hand.route_counts()
    assert counts["daxpy"]["vec16"] == 3
    assert counts["stream_scale"]["scalar"] == 2
    assert counts["stream_sum3"]["vec16"] == 5
    hand.reset_launch_counts()
    for name in STREAMS:
        fn = getattr(hand, name)
        assert fn.launches == 0
        assert fn.launches_by_route == dict.fromkeys(hand.COLL_ROUTES, 0)


@pytest.mark.parametrize("dtype", [BF16, F32, F64])
@pytest.mark.parametrize("n,off_bytes", [(0, 0), (1, 0), (7, 0),
                                         (1000003, 0), (1000003, 8)])
@pytest.mark.parametrize("inplace", [False, True])
def test_cpu_wrappers_are_the_plain_version_and_count_no_route(
        dtype, n, off_bytes, inplace):
    hand.reset_launch_counts()
    g = torch.Generator().manual_seed(n + off_bytes)
    w, x, y = (aligned(n, dtype, off_bytes).copy_(
        torch.rand(n, generator=g).to(dtype)) for _ in range(3))
    for name, ops in (("daxpy", (x, y)), ("stream_scale", (x,)),
                      ("stream_sum3", (w, x, y))):
        fn, ref = getattr(hand, name), getattr(hand, f"{name}_ref")
        args = ops if name == "stream_sum3" else (1.0 + 1e-3, *ops)
        want = ref(*args)
        if inplace:
            tgt = args[-1].clone()
            got = fn(*args[:-1], tgt, out=tgt)
            assert got.data_ptr() == tgt.data_ptr()
        else:
            got = fn(*args)
        assert torch.equal(got, want), name
    for name in STREAMS:
        assert getattr(hand, name).launches == 0
        assert hand.route_counts()[name] == dict.fromkeys(hand.COLL_ROUTES,
                                                          0)


def test_stream_group_is_the_sources_unroll_times_threads():
    """``hand.STREAM_GROUP_PACKS`` is ``csrc/streams.cu``'s group, kUnroll
    × kThreads packs, and the route codes are ``COLL_ROUTES``'s order."""
    text = STREAMS_CU.read_text()
    threads = int(re.search(r"constexpr int kThreads = (\d+);", text)[1])
    unroll = int(re.search(r"constexpr int kUnroll = (\d+);", text)[1])
    assert hand.STREAM_GROUP_PACKS == unroll * threads
    assert "enum StreamRoute : int { kStreamScalar = 0, kStreamVec16 = 1 };" \
        in text


# ---------------------------------------------------------------------------
# chip_smoke.py: the ceiling fit's schedule, the per-route check
# ---------------------------------------------------------------------------

def test_ceiling_fit_launches_three_pairs_of_each_kernel():
    cs = _chip_smoke()
    want = microbench.CEILING_PAIRS * 1201
    assert microbench.CEILING_PAIRS == 3
    assert cs.microbench_launches()["ceiling"] == {
        "daxpy": want, "stream_scale": want, "stream_sum3": 0}
    for path in ("roofline2", "roofline2 large"):
        got = cs.one_card_launches()[path]
        assert got["daxpy"] == got["stream_scale"] == want == 3603


def test_check_stream_routes_wants_every_launch_on_vec16():
    cs = _chip_smoke()
    zero = dict.fromkeys(hand.COLL_ROUTES, 0)
    cs.ROUTE_COUNTS["p"] = {"daxpy": zero | {"vec16": 5},
                            "stream_scale": zero | {"vec16": 2},
                            "stream_sum3": dict(zero)}
    cs.check_stream_routes("p", {"daxpy": 5, "stream_scale": 2})
    with pytest.raises(cs.SmokeFailure, match="daxpy"):
        cs.check_stream_routes("p", {"daxpy": 4, "stream_scale": 2})
    cs.ROUTE_COUNTS["p"]["stream_scale"] = zero | {"vec16": 1, "scalar": 1}
    with pytest.raises(cs.SmokeFailure, match="stream_scale"):
        cs.check_stream_routes("p", {"daxpy": 5, "stream_scale": 2})


def test_stream_queued_fit_is_one_pass_over_the_difference():
    cs = _chip_smoke()
    rows = {"daxpy": [{"queued_ms": 0.27}],
            "stream_scale": [{"queued_ms": 0.18}]}
    assert cs.stream_queued_fit(rows) == pytest.approx(
        4 * (1 << 26) / 1e6 / 0.09)
    rows["stream_scale"][0]["queued_ms"] = 0.3
    assert cs.stream_queued_fit(rows) != cs.stream_queued_fit(rows)  # NaN


@pytest.mark.parametrize("mangled,name", [
    ("_ZN5tpumt12_GLOBAL__N_119stream_vec16_kernelIfNS0_5DaxpyIfEEEEvT0_"
     "PKT_S7_S7_PS5_x", "stream_vec16_kernel<float, Daxpy>"),
    ("_ZN5tpumt12_GLOBAL__N_120stream_scalar_kernelI13__nv_bfloat16NS0_"
     "4Sum3IS2_EEEEvT0_PKT_S8_S8_PS6_x", "stream_scalar_kernel<bf16, Sum3>"),
    ("_ZN5tpumt12_GLOBAL__N_119stream_vec16_kernelIdNS0_5ScaleIdEEEEvT0_"
     "PKT_S7_S7_PS5_x", "stream_vec16_kernel<double, Scale>")])
def test_stream_instances_are_named(mangled, name, monkeypatch):
    assert stream_ab.kernel_name(mangled) == name
    assert stream_ab.kernel_name("flat_copy_kernel") == "flat_copy_kernel"
    log = (f"ptxas info    : Compiling entry function '{mangled}' for "
           f"'sm_90a'\nptxas info    : Used 40 registers\n"
           f"    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           f"loads\n")
    monkeypatch.setitem(build.BUILD_LOGS, "streams", log)
    assert build.ptxas_summary("streams", stream_ab.kernel_name) == {
        name: {"registers": 40, "stack": 0, "spill_stores": 0,
               "spill_loads": 0}}


# ---------------------------------------------------------------------------
# the A/B tool's variants
# ---------------------------------------------------------------------------

def test_stream_ab_variants_patch_one_line_each():
    """Every variant's edits find their text once in ``csrc/streams.cu``
    and apply in turn; the designs the A/B lost to live only in those
    patches, and the tree keeps the choices its source note names."""
    text = STREAMS_CU.read_text()
    assert set(stream_ab.VARIANTS) == {"base", "u1", "u2", "u4", "u8",
                                       "flat", "resident", "cs", "bulk",
                                       "t128", "t512"}
    for name, edits in stream_ab.VARIANTS.items():
        patched = text
        for file, old, new in edits:
            assert file == "streams.cu"
            assert text.count(old) == 1, (name, old)
            assert patched.count(old) == 1, (name, old)
            patched = patched.replace(old, new)
            assert new in patched
    for line in ("constexpr int kThreads = 256;",
                 "constexpr int kUnroll = 1;"):
        assert line in text
    for gone in ("kBulk", "__ldcs", "__stcs", "coll_resident_ctas",
                 "occupancy.cuh"):
        assert gone not in text
    assert any("stream_bulk_kernel" in new
               for _, _, new in stream_ab.VARIANTS["bulk"])


@pytest.mark.parametrize("dtype,pack", [(BF16, 8), (F32, 4), (F64, 2)])
def test_stream_edges_cross_a_group(dtype, pack):
    """One pack, a group ± 1 pack, and two groups ± 1 element: the last
    group one pack short with a tail of a pack less one, and two whole
    groups with a tail of one element on a third CTA."""
    cs = _chip_smoke()
    group = hand.STREAM_GROUP_PACKS * pack
    edges = cs.stream_edges(dtype)
    assert edges == (pack, group - pack, group + pack, 2 * group - 1,
                     2 * group + 1)
    short, over = edges[3:]
    assert (short // pack, short % pack) == (2 * group // pack - 1,
                                             pack - 1)
    assert (over // pack, over % pack) == (2 * group // pack, 1)
    assert -(-over // group) == 3
