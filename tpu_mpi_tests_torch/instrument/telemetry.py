"""The overlap engine's span primitives (≅ the part of
``tpu_mpi_tests/instrument/telemetry.py`` the engine and the dispatch
window call): :class:`AsyncSpan`, :func:`async_span` and
:func:`span_call`.

Recording span events (the ``span`` JSONL records, the counters, the
sinks) is ROADMAP queue 1 item 18 and is not here: these are inert, as
the JAX package's are while telemetry is off. What they do keep is what
the engine measures with: an async span's host-clock bounds
(``mono_start``, ``mono_end``) and its ``drain_s``.
"""

from __future__ import annotations

import time

import torch

from tpu_mpi_tests_torch.instrument.timers import block_stream


class AsyncSpan:
    """Dispatch-window span handle: opened when a comm op is posted,
    closed by :meth:`done`, which waits for the op (the drain point).

    The window runs from the post to the observed completion, so it is
    wider than the op's device time: it covers whatever ran alongside
    while the op was in flight. ``drain_s`` is the time :meth:`done`
    spent waiting: ~0 when the op finished under the work beside it,
    large when that work finished first and the op was not hidden."""

    __slots__ = ("op", "nbytes", "axis_name", "world", "meta", "t0_wall",
                 "mono_start", "mono_end", "drain_s", "closed")

    def __init__(self, op: str, nbytes: int = 0,
                 axis_name: "str | None" = None, world: int = 1, **meta):
        self.op = op
        self.nbytes = int(nbytes)
        self.axis_name = axis_name
        self.world = world
        self.meta = meta
        self.closed = False
        self.t0_wall = time.time()
        self.mono_start = time.perf_counter()
        self.mono_end = self.mono_start
        self.drain_s = 0.0

    def done(self, result=None) -> None:
        """Wait for ``result`` and close the span; idempotent. ``result``
        is a ``torch.cuda.Event`` recorded after the op (it is
        synchronized), or the op's tensors (the current stream's work is
        waited for); None closes without a wait (the CPU, where the op
        completed when it returned)."""
        if self.closed:
            return
        self.closed = True
        if result is not None:
            t_wait = time.perf_counter()
            if isinstance(result, torch.cuda.Event):
                result.synchronize()
            else:
                block_stream(result)
            self.drain_s = time.perf_counter() - t_wait
        self.mono_end = time.perf_counter()


def async_span(op: str, nbytes: int = 0, axis_name: "str | None" = None,
               world: int = 1, **meta) -> AsyncSpan:
    """Open a dispatch-window span (:class:`AsyncSpan`): the op is posted
    now, the caller computes beside it, ``handle.done(...)`` drains it."""
    return AsyncSpan(op, nbytes=nbytes, axis_name=axis_name, world=world,
                     **meta)


def span_call(op: str, fn, *args, nbytes: int = 0,
              axis_name: "str | None" = None, world: int = 1, **meta):
    """``fn(*args)``, the per-call span's path with telemetry off (≅
    ``span_call``): the op runs and its result is returned; no span is
    recorded (queue 1 item 18)."""
    del op, nbytes, axis_name, world, meta
    return fn(*args)
