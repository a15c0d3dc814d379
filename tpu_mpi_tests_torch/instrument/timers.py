"""Sync-honest timers (≅ ``tpu_mpi_tests/instrument/timers.py``).

CUDA launches return before the device finishes, so every host-clock
reading here waits for the device first (:func:`block`), and
:func:`chain_rate` times chained runs with CUDA events on the card.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import torch


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


def chain_rate(run, state, n_short: int = 100, n_long: int = 2100):
    """Seconds per iteration of a chained loop (≅ ``timers.py:149``).

    ``run(state, n)`` runs ``n`` data-dependent iterations and returns the
    new state. Two run lengths are differenced to cancel the fixed cost;
    on the card each run is bracketed by CUDA events, so the difference is
    device-timeline seconds (and includes any time the device waited for
    the host to enqueue the Python loop's launches). Returns
    ``(seconds_per_iter, final_state)``; NaN when the delta is
    non-positive."""
    state = block(run(state, 3))  # warm: builds kernels, fills caches
    dev = _cuda_device(state)
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
    if delta <= 0:
        return float("nan"), state
    return delta / (n_long - n_short), state


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
        self._entries: dict[str, int] = defaultdict(int)
        self.skip_first = skip_first

    @contextmanager
    def phase(self, name: str):
        """Time a phase (the caller waits for earlier queued work)."""
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
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
