"""Chained timing as CUDA graph replays (``instrument/timers.chain_rate``),
on the CPU: the CPU path (host clocks) returns what it returned before
the card's graph path was added, ``graph=True`` on CPU state raises, the
arithmetic that corrects the launch counts after replays gives the
counts of the same chain run eagerly, the census that holds the captured
graphs' kernel nodes against the counted launches convicts a launch that
is counted but not recorded, a span waits for its result's
stream and never for the whole device, and the pieces the captured
bodies lean on (the NaN check inert under capture, the runners' flags
filled on the device, the card's schedule-cache field) behave. The
graph path itself runs on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``'s ``CHAIN`` phase)."""

import dataclasses
import math
import time

import pytest
import torch

from tpu_mpi_tests_torch.comm import halo as TH
from tpu_mpi_tests_torch.comm import mesh
from tpu_mpi_tests_torch.instrument import nans, telemetry, timers
from tpu_mpi_tests_torch.kernels import hand


def _counting_run(calls):
    def run(state, n):
        calls.append(n)
        for _ in range(n):
            state = state * 1.5 + 1.0
        return state

    return run


def _old_chain_rate(run, state, n_short, n_long, repeats):
    """The CPU path as it was before the graph path: host clocks around
    blocked runs, the finite minimum over repeats."""
    state = timers.block(run(state, 3))
    best = float("nan")
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        state = timers.block(run(state, n_short))
        t_short = time.perf_counter() - t0
        t0 = time.perf_counter()
        state = timers.block(run(state, n_long))
        t_long = time.perf_counter() - t0
        delta = t_long - t_short
        if delta > 0:
            per = delta / (n_long - n_short)
            if best != best or per < best:
                best = per
    return best, state


@pytest.mark.parametrize("graph", [None, False])
@pytest.mark.parametrize("n_short, n_long, repeats", [
    (2, 9, 1), (5, 40, 3), (1, 2, 2)])
def test_cpu_path_returns_what_it_did(graph, n_short, n_long, repeats):
    x = torch.linspace(-1.0, 1.0, 17, dtype=torch.float64)
    calls = []
    sec, got = timers.chain_rate(_counting_run(calls), x.clone(),
                                 n_short=n_short, n_long=n_long,
                                 repeats=repeats, graph=graph)
    old_calls = []
    _, want = _old_chain_rate(_counting_run(old_calls), x.clone(), n_short,
                              n_long, repeats)
    assert torch.equal(got, want)
    assert calls == old_calls == [3] + [n_short, n_long] * repeats
    assert math.isnan(sec) or sec > 0


def test_cpu_path_times_on_the_host_clock():
    def run(state, n):
        time.sleep(2e-3 * n)
        return state + n

    sec, state = timers.chain_rate(run, torch.zeros(2), n_short=1,
                                   n_long=6, repeats=2)
    assert 1.5e-3 < sec < 0.1
    assert state.tolist() == [3.0 + 2 * 7] * 2


def test_cpu_path_nan_when_no_pair_differences():
    def run(state, n):
        time.sleep(0.03 if n == 4 else 0.0)  # the short run is the slow one
        return state

    sec, _ = timers.chain_rate(run, torch.zeros(1), n_short=4, n_long=8,
                               repeats=2)
    assert math.isnan(sec)


@pytest.mark.parametrize("state", [torch.zeros(3),
                                   (torch.zeros(2), torch.ones(2)),
                                   [torch.zeros(1)]])
def test_graph_true_on_the_cpu_raises_before_any_run(state):
    calls = []
    with pytest.raises(ValueError, match="on the card"):
        timers.chain_rate(lambda s, n: calls.append(n) or s, state,
                          graph=True)
    assert calls == []


def _fake_wrapper_chain(n_short, n_long, repeats, graph):
    """A stand-in for hand wrappers: each body iteration launches "a"
    twice on route "x" and "b" once on route "y", counted where its
    Python runs. Eagerly every run counts; under the graph path only the
    warm run and the captures run Python, and the replays are added by
    :func:`timers.replayed_counts`. Returns the final counts."""
    counts = {"a": 0, "a/x": 0, "b": 0, "b/y": 0}

    def run(n):
        for _ in range(n):
            counts["a"] += 2
            counts["a/x"] += 2
            counts["b"] += 1
            counts["b/y"] += 1

    run(3)  # warm
    if not graph:
        for _ in range(repeats):
            run(n_short)
            run(n_long)
        return counts
    before = dict(counts)
    run(n_short)  # capture of the short graph
    run(n_long)  # capture of the long graph
    return timers.replayed_counts(before, dict(counts), repeats)


@pytest.mark.parametrize("n_short, n_long", [(1, 2), (10, 110), (7, 7)])
@pytest.mark.parametrize("repeats", [1, 2, 3])
def test_replayed_counts_equal_the_eager_chain(n_short, n_long, repeats):
    eager = _fake_wrapper_chain(n_short, n_long, repeats, graph=False)
    graph = _fake_wrapper_chain(n_short, n_long, repeats, graph=True)
    assert graph == eager
    assert eager["a"] == 2 * (3 + repeats * (n_short + n_long))


def test_replayed_counts_is_pure():
    before = {"k": 5, "k/r": 4}
    captured = {"k": 9, "k/r": 6}
    assert timers.replayed_counts(before, captured, 3) == {"k": 17,
                                                           "k/r": 10}
    assert before == {"k": 5, "k/r": 4} and captured == {"k": 9, "k/r": 6}
    # a key the capture added counts from 0
    assert timers.replayed_counts({}, {"new": 2}, 4) == {"new": 8}


def _mangled(ident, anon="_GLOBAL__N__2f0d1c5a_12_ring_halo_cu_9bd5a1fb"):
    """A kernel's mangled name as nvcc gives it: namespace tpumt, an
    anonymous namespace of the source, the identifier, template args."""
    ns = f"{len(anon)}{anon}" if anon else ""
    return f"_ZN5tpumt{ns}{len(ident)}{ident}ILi4EfEEvPKT0_"


@pytest.mark.parametrize("name, ident", [
    (_mangled("ring_halo_kernel"), "ring_halo_kernel"),
    (_mangled("iterate_regs_dim0", anon=""), "iterate_regs_dim0"),
    (_mangled("oneshot_kernel", anon="_GLOBAL__N_1"), "oneshot_kernel"),
    ("_ZN2at6native29vectorized_elementwise_kernelILi4EEEvi", None),
    ("_ZN5tpumt", None),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", None),
    ("triton_poi_fused_add_0", None),
])
def test_kernel_identifier(name, ident):
    assert timers.kernel_identifier(name) == ident


def test_kernels_table_names_every_cuda_kernel_and_wrapper():
    """``hand.KERNELS`` holds each ``__global__`` of the CUDA sources
    and nothing else, and every wrapper owns one of them."""
    import pathlib
    import re

    csrc = pathlib.Path(hand.__file__).parent / "csrc"
    text = "\n".join(p.read_text() for p in sorted(csrc.glob("*.cu*")))
    found = set(re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\((?:[^()]|\([^()]*\))*"
        r"\)\s*)?(\w+)\s*\(", text))
    assert found == set(hand.KERNELS)
    owners = {w for ws in hand.KERNELS.values() for w in ws}
    assert owners == set(hand.WRAPPERS)


def _snap(**counts):
    snap = dict.fromkeys(hand.WRAPPERS, 0)
    snap.update(counts)
    return snap


@pytest.mark.parametrize("counted, kernels", [
    ({}, []),
    ({}, ["_ZN2at6native18elementwise_kernelILi128EEEvi"]),
    ({"ring_halo": 2, "stencil2d_iterate": 2},
     ["ring_halo_kernel", "iterate_regs_dim1"] * 2),
    # a kernel a launch runs beside its own counts nothing
    ({"dual_dim_step": 1}, ["dual_regs_kernel", "reduce_kernel"]),
    # wrappers that share kernels are held in sum
    ({"daxpy": 1, "stream_sum3": 2},
     ["stream_vec16_kernel", "stream_scalar_kernel", "stream_vec16_kernel"]),
    ({"ring_allgather": 1, "ring_reduce_scatter": 1},
     ["coll_copy_kernel", "coll_copy_kernel"]),
])
def test_check_graph_launches_accepts_what_was_counted(counted, kernels):
    names = [k if k.startswith("_Z") else _mangled(k) for k in kernels]
    timers.check_graph_launches(_snap(), _snap(**counted), names)
    # the same from counts already standing
    timers.check_graph_launches(
        _snap(ring_halo=5), _snap(**{**counted, "ring_halo": 5 + counted.get(
            "ring_halo", 0)}), names)


@pytest.mark.parametrize("counted, kernels, match", [
    # counted, not recorded: launched on a stream outside the capture
    ({"ring_halo": 2}, ["ring_halo_kernel"], "ring_halo: 2 counted, 1"),
    ({"oneshot": 1}, [], "oneshot: 1 counted, 0"),
    # recorded, not counted
    ({}, ["heat2d_regs"], "heat2d: 0 counted, 1"),
    # a group's sum off
    ({"daxpy": 2}, ["stream_vec16_kernel"],
     "daxpy\\+stream_scale\\+stream_sum3: 2 counted, 1"),
    # a port kernel no wrapper names
    ({}, ["new_kernel"], "no wrapper names"),
])
def test_check_graph_launches_raises_on_a_difference(counted, kernels,
                                                     match):
    with pytest.raises(RuntimeError, match=match):
        timers.check_graph_launches(_snap(), _snap(**counted),
                                    [_mangled(k) for k in kernels])


def test_launch_snapshot_round_trip():
    hand.reset_launch_counts()
    snap = timers.launch_snapshot()
    assert set(snap) >= {"ring_halo", "ring_halo/vec16", "oneshot/scalar",
                         "fused_ring_attention/tf32x3"}
    assert not any(snap.values())
    try:
        changed = {k: i for i, k in enumerate(snap)}
        timers.restore_launches(changed)
        assert timers.launch_snapshot() == changed
        assert hand.launch_counts()["ring_halo"] == changed["ring_halo"]
        assert hand.route_counts()["oneshot"]["scalar"] == \
            changed["oneshot/scalar"]
    finally:
        hand.reset_launch_counts()


def test_map_tree_keeps_structure():
    a = (torch.zeros(2), [torch.ones(1), "tag"])
    b = timers._map_tree(lambda t: t + 1, a)
    assert isinstance(b, tuple) and isinstance(b[1], list)
    assert b[0].tolist() == [1.0, 1.0] and b[1][0].tolist() == [2.0]
    assert b[1][1] == "tag"
    dst = (torch.zeros(2), [torch.zeros(1), "tag"])
    timers._map_tree(lambda d, s: d.copy_(s), dst, b)
    assert dst[0].tolist() == [1.0, 1.0] and dst[1][0].tolist() == [2.0]


def test_comm_span_waits_on_the_result_stream_never_the_device(
        monkeypatch):
    """The span's wait is ``timers.block_stream`` (looked up at call
    time, so the chaos straggler's wrap still lands in it), never
    ``timers.block`` nor ``torch.cuda.synchronize``."""
    waited = []

    def no_sync(*a, **k):
        raise AssertionError("comm_span reached torch.cuda.synchronize")

    def no_block(*trees):
        raise AssertionError("comm_span waited device-wide (timers.block)")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    monkeypatch.setattr(timers, "block", no_block)
    monkeypatch.setattr(timers, "block_stream",
                        lambda *t: waited.append(t) or t[0])
    recs = []
    telemetry.enable(sink=recs.append)
    try:
        out = torch.arange(4.0)
        with telemetry.comm_span("halo_exchange", nbytes=16) as span:
            span.result = out
        with telemetry.comm_span("allreduce"):
            pass  # no result: nothing to wait for
    finally:
        telemetry.disable()
    assert len(waited) == 1 and waited[0][0] is out
    assert [r["op"] for r in recs if r.get("kind") == "span"] == [
        "halo_exchange", "allreduce"]


def test_block_stream_waits_on_an_event_not_the_device(monkeypatch):
    """On a card tensor ``block_stream`` records an event on the current
    stream and waits for that event alone."""
    events = []

    class FakeEvent:
        def __init__(self):
            self.calls = []
            events.append(self)

        def record(self, stream):
            self.calls.append(("record", stream))

        def synchronize(self):
            self.calls.append(("synchronize",))

    def no_sync(*a, **k):
        raise AssertionError("block_stream reached torch.cuda.synchronize")

    monkeypatch.setattr(timers, "_cuda_device",
                        lambda tree: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: "stream")
    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    x = torch.zeros(2)
    assert timers.block_stream(x) is x
    assert [e.calls for e in events] == [[("record", "stream"),
                                          ("synchronize",)]]


def test_uniform_straggler_wraps_block_stream_and_is_restored():
    from tpu_mpi_tests_torch.chaos import inject
    from tpu_mpi_tests_torch.chaos.spec import parse_chaos_spec

    before = (timers.block, timers.block_stream)
    inject.arm(parse_chaos_spec("straggler:rank=0:delay_ms=40:after=1"),
               rank=0)
    try:
        assert timers.block_stream is not before[1]
        assert timers.block is not before[0]
        x = torch.ones(2)
        t0 = time.perf_counter()
        assert timers.block_stream(x) is x
        assert time.perf_counter() - t0 >= 0.035
    finally:
        inject.disarm()
    assert (timers.block, timers.block_stream) == before


def test_nan_check_is_inert_under_capture(monkeypatch):
    bad = torch.tensor([1.0, float("nan")])
    nans.arm(True)
    try:
        with pytest.raises(FloatingPointError, match="probe"):
            nans.check("probe", bad)
        monkeypatch.setattr(nans, "_under_capture", lambda: True)
        assert nans.check("probe", bad) is bad
    finally:
        nans.arm(False)


@pytest.mark.parametrize("size, rank", [(2, 0), (2, 1), (4, 0), (4, 2),
                                        (4, 3)])
@pytest.mark.parametrize("side", [(True, True), (True, False),
                                  (False, True)])
def test_dynamic_flags_are_filled_on_the_device(size, rank, side):
    """A non-periodic ring over ranks gives the runners dynamic flags:
    filled in place (no host copy, so a captured body can make them),
    equal to the ring's physical sides."""
    ring = mesh.Ring(rank, size)
    got = TH._phys_kwargs(ring, False, torch.device("cpu"), side)["phys"]
    lo, hi = ring.phys(False)
    assert got.dtype == torch.int32
    assert got.tolist() == [lo if side[0] else 0, hi if side[1] else 0]


def test_card_fingerprint_names_graph_chains(monkeypatch):
    from tpu_mpi_tests_torch.tune import fingerprint as tfp

    fields = dict(tfp.device_fields())
    assert "chain" not in fields  # the CPU's chains are host clocks
    real = mesh.topology

    def on_card(device):
        return dataclasses.replace(real(device), platform="gpu",
                                   device_kinds=("NVIDIA H100 80GB HBM3",))

    monkeypatch.setattr(mesh, "topology", on_card)
    card = dict(tfp.device_fields())
    assert card["chain"] == "graph" and card["stack"] == "torch"
    assert tfp.fingerprint(dtype="float32", n=8192, world=1) != \
        tfp.compose({k: v for k, v in card.items() if k != "chain"},
                    dtype="float32", n=8192, world=1)



@pytest.mark.parametrize("world", [1, 4])
def test_a_pair_over_ranks_reads_as_the_slowest_rank(monkeypatch, world):
    """Over several ranks a timed pair's difference is the largest of the
    ranks' (one MAX all-reduce, so every rank keeps one reading); on one
    rank it is the rank's own, with no collective."""
    import torch.distributed as tdist

    monkeypatch.setattr(tdist, "is_initialized", lambda: True)
    monkeypatch.setattr(tdist, "get_world_size", lambda group=None: world)
    calls = []

    def all_reduce(x, op=None):
        calls.append(op)
        x.fill_(max(float(x), 7.5e-4))

    monkeypatch.setattr(tdist, "all_reduce", all_reduce)
    got = timers._slowest_rank(2.5e-4, torch.device("cpu"))
    if world == 1:
        assert got == 2.5e-4 and calls == []
    else:
        assert got == 7.5e-4 and calls == [tdist.ReduceOp.MAX]


@pytest.mark.parametrize("world", [1, 4])
def test_align_ranks_runs_a_scratch_copy_uncounted(monkeypatch, world):
    """Over several ranks the graph path runs the body once more, eagerly,
    on a copy of the start (every rank then waits for the others'
    captures in the body's own communication): the start is untouched
    and the launch counts stay the chain's. On one rank it runs
    nothing."""
    import torch.distributed as tdist

    monkeypatch.setattr(tdist, "is_initialized", lambda: True)
    monkeypatch.setattr(tdist, "get_world_size", lambda group=None: world)
    wrapper = hand.WRAPPERS["ring_halo"]
    hand.reset_launch_counts()
    wrapper.launches = 5
    start = (torch.arange(6.0), torch.ones(2))
    seen = []

    def run(state, n):
        seen.append((state[0].data_ptr(), n))
        wrapper.launches += n
        return tuple(t.mul_(2.0) for t in state)

    try:
        timers._align_ranks(run, start)
        assert start[0].tolist() == list(range(6))
        assert start[1].tolist() == [1.0, 1.0]
        assert wrapper.launches == 5
        if world == 1:
            assert seen == []
        else:
            assert len(seen) == 1 and seen[0][1] == 3
            assert seen[0][0] != start[0].data_ptr()
    finally:
        hand.reset_launch_counts()
