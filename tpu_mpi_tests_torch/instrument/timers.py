"""Sync-honest timers (≅ ``tpu_mpi_tests/instrument/timers.py``).

CUDA launches return before the device finishes, so every host-clock
reading here waits for the device first (:func:`block`), and
:func:`chain_rate` times chained runs on the card as replays of CUDA
graphs between CUDA events (the counterpart of the JAX package's
device-side ``fori_loop``: the host never gaps the chain).
:func:`block` waits for every stream of the device; :func:`block_stream`
waits for one stream only, so a wait on a core computing beside an
exchange in flight on another stream does not swallow the exchange.
"""

from __future__ import annotations

import ctypes
import functools
import time
from collections import Counter, defaultdict
from contextlib import contextmanager

import torch

#: phase-boundary observers (``hook(name, "begin"|"end")``, ≅ the JAX
#: ``_PHASE_HOOKS``): the memory watcher (``instrument/memwatch.py``)
#: snapshots the allocator here. An empty-list check when none is added;
#: hooks run outside the timed window (before the start read, after the
#: end read), so an observer's cost is never charged to the phase.
_PHASE_HOOKS: list = []


def add_phase_hook(hook) -> None:
    if hook not in _PHASE_HOOKS:
        _PHASE_HOOKS.append(hook)


def remove_phase_hook(hook) -> None:
    try:
        _PHASE_HOOKS.remove(hook)
    except ValueError:
        pass


def _fire_phase_hooks(name: str, event: str) -> None:
    for hook in list(_PHASE_HOOKS):
        try:
            hook(name, event)
        except Exception:
            pass  # an observer never fails the measured phase


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for t in tree:
            yield from _tensors(t)


def _cuda_device(tree):
    for t in _tensors(tree):
        if t.device.type == "cuda":
            return t.device
    return None


def block(*trees):
    """Wait until the device has finished the work producing ``trees``
    (tensors, or tuples/lists of them) and return them unchanged."""
    for tree in trees:
        dev = _cuda_device(tree)
        if dev is not None:
            torch.cuda.synchronize(dev)
    return trees[0] if len(trees) == 1 else trees


def stream_event(*trees):
    """A CUDA event recorded on the current stream of the trees' device
    after the work queued there so far, or None when no tree holds a
    card tensor."""
    dev = None
    for tree in trees:
        dev = dev or _cuda_device(tree)
    if dev is None:
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(dev))
    return ev


def block_stream(*trees):
    """Wait until the current stream has finished the work queued on it
    so far, and return ``trees`` unchanged: an event recorded there, then
    ``event.synchronize()``. Unlike :func:`block` it leaves work on the
    device's other streams (an exchange in flight, NCCL's) running."""
    ev = stream_event(*trees)
    if ev is not None:
        ev.synchronize()
    return trees[0] if len(trees) == 1 else trees


def dispatch_rate(f, *args, n_iter: int = 2000, n_base: int = 200
                  ) -> float:
    """Mean seconds per call of ``f(*args)`` under asynchronous launch
    (≅ ``timers.py:125``): ``n_base`` then ``n_base + n_iter``
    independent calls, each batch timed on the host clock and ended by
    one wait for the last result (the card runs a stream's launches in
    order, so the last one's completion proves the batch drained); the
    difference cancels the fixed launch ramp and wait. For ops that do
    not chain shape-preservingly; the first call (untimed) warms up."""
    block(f(*args))

    def run(n):
        t0 = time.perf_counter()
        r = None
        for _ in range(n):
            r = f(*args)
        block(r)
        return time.perf_counter() - t0

    t_base = run(n_base)
    t_full = run(n_base + n_iter)
    return max(t_full - t_base, 1e-12) / n_iter


def chain_rate(run, state, n_short: int = 100, n_long: int = 2100,
               repeats: int = 1, graph: "bool | None" = None):
    """Seconds per iteration of a chained loop (≅ ``timers.py:149``).

    ``run(state, n)`` runs ``n`` data-dependent iterations and returns the
    new state. Two run lengths are differenced to cancel the fixed cost.
    Returns ``(seconds_per_iter, final_state)``; NaN when the delta is
    non-positive. ``repeats`` > 1 measures the pair that many times and
    returns the finite minimum (contention only inflates; NaN only when
    every repeat is invalid).

    ``graph`` (None: on for state on the card, off on the CPU): after
    the eager warm run, ``run(state, n_short)`` and ``run(<its output>,
    n_long)`` are captured into two CUDA graphs and replayed between
    three CUDA events, so the difference is the device time of the
    chained launches alone, as the JAX package's device-side loop gives
    (:func:`_graph_chain`). A capture that fails raises. ``graph=False``
    brackets the Python loop of launches with the events instead (the
    time then includes any time the device waited for the host): for a
    body that waits on the host or reads to it, which cannot be
    captured. On the CPU the runs are timed on the host clock;
    ``graph=True`` there raises ``ValueError``."""
    dev = _cuda_device(state)
    if graph is None:
        graph = dev is not None
    elif graph and dev is None:
        raise ValueError("chain_rate(graph=True) captures CUDA graphs: "
                         "the state must hold a tensor on the card")
    state = block(run(state, 3))  # warm: builds kernels, fills caches
    if graph:
        return _graph_chain(run, state, n_short, n_long, repeats, dev)
    best = float("nan")
    for _ in range(max(1, repeats)):
        if dev is not None:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            with torch.cuda.device(dev):
                ev[0].record()
                state = run(state, n_short)
                ev[1].record()
                state = run(state, n_long)
                ev[2].record()
            ev[2].synchronize()
            t_short = ev[0].elapsed_time(ev[1]) / 1e3
            t_long = ev[1].elapsed_time(ev[2]) / 1e3
        else:
            t0 = time.perf_counter()
            state = block(run(state, n_short))
            t_short = time.perf_counter() - t0
            t0 = time.perf_counter()
            state = block(run(state, n_long))
            t_long = time.perf_counter() - t0
        best = _better(best, t_long - t_short, n_long - n_short)
    return best, state


def _better(best: float, delta: float, n: int) -> float:
    """The lesser of ``best`` and a pair's seconds per iteration, its
    long run's time less its short run's (``delta``) over the ``n``
    iterations between them; a non-positive delta is no reading
    (``best`` stays, NaN or not)."""
    if delta > 0:
        per = delta / n
        if best != best or per < best:  # best is NaN or worse
            return per
    return best


def _map_tree(fn, *trees):
    """``fn`` over the tensors of ``trees`` (tensors, or tuples/lists of
    them, all of one structure), the structure kept; other leaves pass
    through from the first tree."""
    head = trees[0]
    if isinstance(head, torch.Tensor):
        return fn(*trees)
    if isinstance(head, (tuple, list)):
        return type(head)(_map_tree(fn, *parts) for parts in zip(*trees))
    return head


@contextmanager
def _capturing(g, pool, stream):
    """Capture the enclosed launches on ``stream`` into the CUDA graph
    ``g`` (memory from ``pool``). Unlike ``torch.cuda.graph`` it neither
    synchronises the device nor empties the allocator's cache first.
    Only the capturing thread's unsafe calls invalidate the capture
    (``thread_local``): a watcher thread reading the allocator does
    not."""
    with torch.cuda.stream(stream):
        g.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            yield
        except BaseException:
            _end_capture_quietly(g)
            raise
        g.capture_end()


def _end_capture_quietly(g) -> None:
    """End a capture whose body raised, so that the body's error, not
    the invalidated capture's, is the one raised."""
    try:
        g.capture_end()
    except RuntimeError:
        pass  # the capture was invalidated by the body's own error


def launch_snapshot() -> dict[str, int]:
    """Every hand kernel wrapper's launch counts, flat: ``name`` → its
    launches, ``name/route`` → its launches on that route
    (``kernels.hand.WRAPPERS``)."""
    from tpu_mpi_tests_torch.kernels import hand

    out = {}
    for name, fn in hand.WRAPPERS.items():
        out[name] = fn.launches
        for route, n in getattr(fn, "launches_by_route", {}).items():
            out[f"{name}/{route}"] = n
    return out


def restore_launches(counts: dict[str, int]) -> None:
    """Set every wrapper's counts from a :func:`launch_snapshot`."""
    from tpu_mpi_tests_torch.kernels import hand

    for name, fn in hand.WRAPPERS.items():
        fn.launches = counts[name]
        if hasattr(fn, "launches_by_route"):
            fn.launches_by_route = {
                route: counts[f"{name}/{route}"]
                for route in fn.launches_by_route}


def replayed_counts(before: dict[str, int], captured: dict[str, int],
                    replays: int) -> dict[str, int]:
    """The launch counts after ``replays`` replays of graphs whose
    capture moved the counts from ``before`` to ``captured``. A wrapper
    counts where its Python runs, so a capture counts the launches it
    records (the card runs none) and a replay, which calls no Python,
    counts none: each captured launch is taken back and counted once a
    replay. The result is what the same chain run eagerly counts, once
    :func:`check_graph_launches` has found every captured launch in the
    graphs."""
    return {k: before.get(k, 0) + replays * (n - before.get(k, 0))
            for k, n in captured.items()}


def kernel_identifier(name: str) -> "str | None":
    """The identifier that a mangled kernel name of the port's CUDA
    sources ends in, below namespace ``tpumt`` and any anonymous one
    (``_ZN5tpumt12_GLOBAL__N_116ring_halo_kernelI...`` →
    ``ring_halo_kernel``); None for any other kernel (torch's, NCCL's)."""
    if not name.startswith("_ZN"):
        return None
    parts, i = [], 3
    while i < len(name) and name[i].isdigit():
        j = i
        while j < len(name) and name[j].isdigit():
            j += 1
        n = int(name[i:j])
        parts.append(name[j:j + n])
        i = j + n
    return parts[-1] if len(parts) > 1 and parts[0] == "tpumt" else None


def _kernel_groups() -> dict[str, tuple[str, ...]]:
    """Each hand wrapper → its group: the wrappers joined to it by a
    kernel they share (``kernels.hand.KERNELS``), sorted."""
    from tpu_mpi_tests_torch.kernels import hand

    group = {name: {name} for name in hand.WRAPPERS}
    for owners in hand.KERNELS.values():
        joined = set().union(*(group[w] for w in owners)) if owners else ()
        for w in joined:
            group[w] = joined
    return {w: tuple(sorted(g)) for w, g in group.items()}


def check_graph_launches(before: dict[str, int], captured: dict[str, int],
                         names) -> None:
    """Raise ``RuntimeError`` unless the kernel nodes of captured graphs
    (``names``, their mangled names) hold the hand kernels' launches that
    the capture counted (:func:`launch_snapshot` ``before`` and
    ``captured``): per group of wrappers that share kernels
    (:func:`_kernel_groups`), as many nodes of the group's kernels as its
    counted launches. A launch that was counted but not recorded (one on
    a stream outside the capture runs once, eagerly) or recorded but not
    counted fails; so does a node of a port kernel that no wrapper names
    in ``kernels.hand.KERNELS``."""
    from tpu_mpi_tests_torch.kernels import hand

    groups = _kernel_groups()
    counted, nodes = Counter(), Counter()
    for w in hand.WRAPPERS:
        if captured[w] != before.get(w, 0):
            counted[groups[w]] += captured[w] - before.get(w, 0)
    for name in names:
        ident = kernel_identifier(name)
        if ident is None:
            continue
        if ident not in hand.KERNELS:
            raise RuntimeError(f"a captured graph runs the port's kernel "
                               f"{ident} ({name}), which no wrapper names "
                               f"in kernels.hand.KERNELS")
        if hand.KERNELS[ident]:
            nodes[groups[hand.KERNELS[ident][0]]] += 1
    if counted != nodes:
        diff = ", ".join(
            f"{'+'.join(g)}: {counted[g]} counted, {nodes[g]} in the graphs"
            for g in sorted(set(counted) | set(nodes))
            if counted[g] != nodes[g])
        raise RuntimeError(f"the captured graphs do not hold the launches "
                           f"the capture counted ({diff})")


class _KernelNodeParams(ctypes.Structure):
    """``CUDA_KERNEL_NODE_PARAMS_v2`` (``cuda.h``)."""
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared", ctypes.c_uint),
                ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


#: ``CUgraphNodeType`` values (``cuda.h``)
_CU_NODE_KERNEL, _CU_NODE_GRAPH = 0, 4


@functools.lru_cache(maxsize=None)
def _libcuda():
    """The CUDA driver library (loaded already, by torch), with the
    signatures of the calls made here."""
    cuda = ctypes.CDLL("libcuda.so.1")
    p, cp = ctypes.c_void_p, ctypes.POINTER
    for fn, args in (
            ("cuGraphUpload", [p, p]),
            ("cuGraphGetNodes", [p, p, cp(ctypes.c_size_t)]),
            ("cuGraphNodeGetType", [p, cp(ctypes.c_int)]),
            ("cuGraphKernelNodeGetParams_v2", [p, cp(_KernelNodeParams)]),
            ("cuGraphChildGraphNodeGetGraph", [p, cp(p)]),
            ("cuFuncGetName", [cp(ctypes.c_char_p), p]),
            ("cuKernelGetName", [cp(ctypes.c_char_p), p])):
        getattr(cuda, fn).argtypes = args
        getattr(cuda, fn).restype = ctypes.c_int
    return cuda


def _cu(rc: int, call: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{call} failed (CUresult {rc})")


def graph_kernel_names(graph: int) -> list[str]:
    """The mangled names of the kernel nodes of the CUDA graph ``graph``
    (a ``CUgraph`` handle) and of its child graphs, one a node; ``""``
    for a node whose name the driver does not give, which then counts
    as no port kernel's (so a port kernel among such nodes fails
    :func:`check_graph_launches`)."""
    cuda = _libcuda()
    n = ctypes.c_size_t(0)
    _cu(cuda.cuGraphGetNodes(graph, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    if n.value:
        _cu(cuda.cuGraphGetNodes(graph, nodes, ctypes.byref(n)),
            "cuGraphGetNodes")
    names = []
    for node in nodes:
        kind = ctypes.c_int()
        _cu(cuda.cuGraphNodeGetType(node, ctypes.byref(kind)),
            "cuGraphNodeGetType")
        if kind.value == _CU_NODE_GRAPH:
            child = ctypes.c_void_p()
            _cu(cuda.cuGraphChildGraphNodeGetGraph(node, ctypes.byref(child)),
                "cuGraphChildGraphNodeGetGraph")
            names += graph_kernel_names(child.value)
        elif kind.value == _CU_NODE_KERNEL:
            prm = _KernelNodeParams()
            _cu(cuda.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(prm)),
                "cuGraphKernelNodeGetParams")
            name = ctypes.c_char_p()
            if not ((prm.func and cuda.cuFuncGetName(
                    ctypes.byref(name), prm.func) == 0) or
                    (prm.kern and cuda.cuKernelGetName(
                        ctypes.byref(name), prm.kern) == 0)):
                name.value = b""
            names.append(name.value.decode())
    return names


#: the stall (ms) queued before a timed pair of replays, so the host has
#: enqueued both before the card reaches the first event: the window
#: then holds the replays' device time alone
GRAPH_STALL_MS = 1.0
#: the stall over several ranks, where the host also queues the ranks'
#: alignment (:func:`_align_ranks`, an eager run) behind it
GRAPH_STALL_MS_OVER_RANKS = 10.0


def _upload(graphs, stream) -> None:
    """Upload each instantiated graph to the card on ``stream`` (the
    driver's ``cuGraphUpload``), so that no replay in a timed window
    pays its first launch's upload."""
    for g in graphs:
        _cu(_libcuda().cuGraphUpload(g.raw_cuda_graph_exec(),
                                     stream.cuda_stream), "cuGraphUpload")


def _world() -> int:
    """The ranks of the default process group (1 when there is none)."""
    import torch.distributed as tdist

    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_world_size()
    return 1


def _slowest_rank(delta: float, dev) -> float:
    """Over several ranks, the largest of the ranks' pair differences
    (one all-reduce, outside the timed window), so every rank keeps the
    same reading: a rank whose short run started before a peer's waits
    for it inside that run, which lowers only its own difference; the
    rank that started last waited for none. One rank: ``delta``."""
    if _world() == 1:
        return delta
    import torch.distributed as tdist

    x = torch.tensor([delta], dtype=torch.float64, device=dev)
    tdist.all_reduce(x, op=tdist.ReduceOp.MAX)
    return float(x.item())


def _align_ranks(run, state) -> None:
    """Over several ranks, an untimed eager ``run`` on a scratch copy of
    the start, queued after a repeat's stall and before its first event:
    a body that communicates leaves it on every rank at once, so no
    rank's short replay waits out another rank's capture or longer stall
    (the stall counts clock cycles, and an idle card runs slower ones).
    No host wait: the replays queue behind it. Its launches go uncounted
    (the counts stay the chain's). One rank: nothing."""
    if _world() == 1:
        return
    counts = launch_snapshot()
    run(_map_tree(lambda t: t.clone(), state), 3)
    restore_launches(counts)


def _graph_chain(run, state, n_short, n_long, repeats, dev):
    """:func:`chain_rate`'s card path, after the warm run: capture
    ``run(state, n_short)`` and ``run(<its output>, n_long)`` into two
    graphs on a capture stream, upload both, then replay the pair
    between three events ``repeats`` times, each pair queued behind a
    short stall (:data:`GRAPH_STALL_MS`) so no host latency lands in the
    window, and over several ranks behind a longer one
    (:data:`GRAPH_STALL_MS_OVER_RANKS`) and an alignment
    (:func:`_align_ranks`), each pair read as the slowest rank's
    (:func:`_slowest_rank`). Before each repeat but the first, outside
    the timed window, the long graph's output is copied into the short
    graph's input, so the chain goes on from where it stopped, as the
    eager chain does: the final state equals the eager chain's bit for
    bit. It is returned as a copy, and the graphs and their memory pool
    are released before the return. Before any replay, the graphs'
    kernel nodes are held against the launches the capture counted
    (:func:`check_graph_launches`, which raises on a difference); the
    counts are then corrected to what the card ran
    (:func:`replayed_counts`)."""
    repeats = max(1, repeats)
    before = launch_snapshot()
    with torch.cuda.device(dev):
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        pool = torch.cuda.graph_pool_handle()
        g_short, g_long = (torch.cuda.CUDAGraph(keep_graph=True)
                           for _ in range(2))
        with _capturing(g_short, pool, stream):
            mid = run(state, n_short)
        with _capturing(g_long, pool, stream):
            out = run(mid, n_long)
        captured = launch_snapshot()
        check_graph_launches(before, captured, [
            name for g in (g_short, g_long)
            for name in graph_kernel_names(g.raw_cuda_graph())])
        for g in (g_short, g_long):
            g.instantiate()
        current = torch.cuda.current_stream(dev)
        _upload((g_short, g_long), current)
        khz = getattr(torch.cuda.get_device_properties(dev), "clock_rate",
                      1.98e6)
        stall_ms = (GRAPH_STALL_MS if _world() == 1
                    else GRAPH_STALL_MS_OVER_RANKS)
        best = float("nan")
        for i in range(repeats):
            if i:
                _map_tree(lambda dst, src: dst.copy_(src), state, out)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            torch.cuda._sleep(int(stall_ms * khz))
            _align_ranks(run, state)
            ev[0].record()
            g_short.replay()
            ev[1].record()
            g_long.replay()
            ev[2].record()
            ev[2].synchronize()
            delta = (ev[1].elapsed_time(ev[2])
                     - ev[0].elapsed_time(ev[1])) / 1e3
            best = _better(best, _slowest_rank(delta, dev), n_long - n_short)
        final = _map_tree(lambda t: t.clone(), out)
        current.synchronize()
        del mid, out, g_short, g_long
    restore_launches(replayed_counts(before, captured, repeats))
    from tpu_mpi_tests_torch.instrument import nans

    return best, nans.check("chain_rate", final)


class PhaseTimer:
    """Accumulating named phase timers (≅ the JAX ``PhaseTimer``; the
    per-iteration ``clock_gettime`` loop of ``mpi_stencil2d_gt.cc:511-526``).
    The first ``skip_first`` entries into each phase are timed but not
    accumulated (the ``i >= n_warmup`` guard, ``:521-526``)."""

    def __init__(self, skip_first: int = 0):
        self.seconds: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.mins: dict[str, float] = {}
        self.maxs: dict[str, float] = {}
        # wall-clock (Unix) and monotonic bounds of each phase's
        # lifetime, first entry's start to last exit's end, warmup
        # entries included
        self.t_starts: dict[str, float] = {}
        self.t_ends: dict[str, float] = {}
        self.mono_starts: dict[str, float] = {}
        self.mono_ends: dict[str, float] = {}
        self._entries: dict[str, int] = defaultdict(int)
        self.skip_first = skip_first
        #: extra fields per phase for its JSONL ``time`` record
        #: (:meth:`annotate`)
        self.extras: dict[str, dict] = {}

    @contextmanager
    def phase(self, name: str):
        """Time a phase (the caller waits for earlier queued work)."""
        if _PHASE_HOOKS:
            _fire_phase_hooks(name, "begin")
        t0_wall = time.time()
        t0 = time.perf_counter()
        yield
        t1 = time.perf_counter()
        if _PHASE_HOOKS:
            _fire_phase_hooks(name, "end")
        dt = t1 - t0
        self.t_starts.setdefault(name, t0_wall)
        self.t_ends[name] = t0_wall + dt
        self.mono_starts.setdefault(name, t0)
        self.mono_ends[name] = t1
        self._entries[name] += 1
        if self._entries[name] > self.skip_first:
            self.seconds[name] += dt
            self.counts[name] += 1
            self.mins[name] = min(self.mins.get(name, dt), dt)
            self.maxs[name] = max(self.maxs.get(name, dt), dt)

    def timed(self, name: str, fn, *args, **kwargs):
        """Run ``fn`` and wait for its result inside the phase bracket."""
        with self.phase(name):
            out = block(fn(*args, **kwargs))
        return out

    def mean(self, name: str) -> float:
        c = self.counts[name]
        return self.seconds[name] / c if c else 0.0

    def annotate(self, name: str, **fields) -> None:
        """Attach extra fields to a phase's JSONL ``time`` record (the
        overlap engine's ``overlap_frac``, ≅ the JAX ``annotate``).
        ``Reporter.time_lines`` merges them; the stdout ``TIME`` line
        keeps the reference's shape."""
        self.extras.setdefault(name, {}).update(fields)

    def wall_span(self, name: str) -> tuple[float | None, float | None]:
        """Wall-clock ``(t_start, t_end)`` of the phase's lifetime, or
        ``(None, None)`` if it was never entered."""
        return self.t_starts.get(name), self.t_ends.get(name)

    def lines(self, prefix: str = "TIME", stats: bool = False) -> list[str]:
        """One ``TIME <phase> : <s>`` line per accumulated phase (≅
        ``mpi_daxpy_nvtx.cc:333-340``); ``stats`` appends
        count/mean/min/max after the reference-shaped prefix."""
        out = []
        for name in self.seconds:
            line = f"{prefix} {name} : {self.seconds[name]:0.6f}"
            if stats:
                line += (
                    f" count={self.counts[name]} mean={self.mean(name):e}"
                    f" min={self.mins.get(name, 0.0):e}"
                    f" max={self.maxs.get(name, 0.0):e}"
                )
            out.append(line)
        return out
