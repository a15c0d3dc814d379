"""Sync-honest timers (≅ ``tpu_mpi_tests/instrument/timers.py``).

CUDA launches return before the device finishes, so every host-clock
reading here waits for the device first (:func:`block`), and
:func:`chain_rate` times chained runs with CUDA events on the card.
:func:`block` waits for every stream of the device; :func:`block_stream`
waits for one stream only, so a wait on a core computing beside an
exchange in flight on another stream does not swallow the exchange.
"""

from __future__ import annotations

import time
from collections import defaultdict
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
               repeats: int = 1):
    """Seconds per iteration of a chained loop (≅ ``timers.py:149``).

    ``run(state, n)`` runs ``n`` data-dependent iterations and returns the
    new state. Two run lengths are differenced to cancel the fixed cost;
    on the card each run is bracketed by CUDA events, so the difference is
    device-timeline seconds (and includes any time the device waited for
    the host to enqueue the Python loop's launches). Returns
    ``(seconds_per_iter, final_state)``; NaN when the delta is
    non-positive. ``repeats`` > 1 measures the pair that many times and
    returns the finite minimum (contention only inflates; NaN only when
    every repeat is invalid)."""
    state = block(run(state, 3))  # warm: builds kernels, fills caches
    dev = _cuda_device(state)
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
        delta = t_long - t_short
        if delta > 0:
            per = delta / (n_long - n_short)
            if best != best or per < best:  # best is NaN or worse
                best = per
    return best, state


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
