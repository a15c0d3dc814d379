"""First-call cost capture and the analytic cost model (≅
``tpu_mpi_tests/instrument/costs.py``).

The JAX module times ``fn.lower(*args).compile()`` and reads XLA's
``cost_analysis()``. Nothing is compiled per shape here, and no compiler
reports a cost, so:

* :func:`compile_probe` times the FIRST call of a driver's step (it runs
  ``fn(*args)`` once and waits for it): what a fresh process pays before
  its steady state, the kernels' build or the load of the built
  library included (``kernels/build.py`` builds at first use). It writes
  the JAX ``compile`` record (RECORDS.md) on the wall clock, so the
  trace draws a compile track. The caller passes arguments that one
  more call may consume (a copy of state an op updates in place).
* the flops and bytes are the caller's analytic counts of one call
  (``flops=``, ``bytes_accessed=``): each input read once and each
  output written once, the counts ``PERF.md``'s bounds use.

The latest probe per label is kept, and this module registers as the
telemetry layer's cost provider: a later span whose ``op`` is a probed
label gains ``cost_bytes``, ``cost_flops``, ``model_gbps`` and, where
the card's peak is known (:data:`PEAK_HBM_GBPS`), ``roofline_frac``.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable

from tpu_mpi_tests_torch.instrument import telemetry as _telemetry

#: published peak memory bandwidth per card name, GB/s (the roofline
#: denominator); ``TPU_MPI_PEAK_GBPS`` overrides it
PEAK_HBM_GBPS = {
    "NVIDIA H100 80GB HBM3": 3350.0,
}

_LOCK = threading.Lock()
#: label -> latest probe info; a label probed at more than one shape is
#: "ambiguous" and attaches nothing to spans (a span cannot say which
#: shape it ran at)
_REGISTRY: dict[str, dict[str, Any]] = {}
#: (label, shapes) already probed
_PROBED: set = set()


def peak_gbps(device=None) -> float | None:
    """The card's peak GB/s: ``TPU_MPI_PEAK_GBPS`` first, else
    :data:`PEAK_HBM_GBPS` by the card's name; None on the CPU or an
    unlisted card (consumers then leave roofline fractions out)."""
    env = os.environ.get("TPU_MPI_PEAK_GBPS")
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    try:
        import torch

        if device is None:
            if not torch.cuda.is_initialized():
                return None
            device = torch.cuda.current_device()
        elif torch.device(device).type != "cuda":
            return None
        name = torch.cuda.get_device_name(device)
    except Exception:
        return None
    return PEAK_HBM_GBPS.get(name)


def _shape_key(a) -> tuple:
    shape = getattr(a, "shape", None)
    dtype = getattr(a, "dtype", None)
    if shape is None and dtype is None:
        return (type(a).__name__,)
    return (tuple(shape or ()), str(dtype))


def _fingerprint(**ctx) -> str | None:
    try:
        from tpu_mpi_tests_torch.tune.fingerprint import fingerprint

        return fingerprint(**ctx)
    except Exception:
        return None


def _device_of(args):
    from tpu_mpi_tests_torch.instrument.timers import _cuda_device

    return _cuda_device(list(args))


def compile_probe(fn: Callable, make_args: Callable[[], tuple],
                  label: str, phase: str | None = None,
                  emit: Callable[[dict], None] | None = None,
                  flops: float | None = None,
                  bytes_accessed: float | None = None,
                  **ctx) -> dict[str, Any] | None:
    """Time ``fn(*make_args())``'s first call and record it with the
    analytic cost. A no-op (returning None) unless span telemetry is on:
    the probe costs a real call, and its operands (often a field of the
    run's size) are built by ``make_args`` only then. Deduplicated per
    (label, argument shapes and dtypes). ``phase`` names the PhaseTimer
    phase or span op whose time this fn's runs land in (default
    ``label``); ``ctx`` feeds the schedule fingerprint. Never raises."""
    if not _telemetry.registry().enabled:
        return None
    args = make_args()
    key = (label,) + tuple(_shape_key(a) for a in args)
    with _LOCK:
        if key in _PROBED:
            return _REGISTRY.get(label)
        second_shape = any(k[0] == label for k in _PROBED)
        _PROBED.add(key)
    try:
        from tpu_mpi_tests_torch.instrument.timers import block

        t0_wall = time.time()
        t0 = time.perf_counter()
        block(fn(*args))
        t1 = time.perf_counter()
        dt = t1 - t0
        info: dict[str, Any] = {
            "label": label,
            "compile_s": dt,
            "flops": None if flops is None else float(flops),
            "bytes_accessed": (None if bytes_accessed is None
                               else float(bytes_accessed)),
            "fingerprint": _fingerprint(**ctx),
        }
        peak = peak_gbps(_device_of(args))
        if peak:
            info["peak_gbps"] = peak
        if second_shape:
            info["ambiguous"] = True
        with _LOCK:
            _REGISTRY[label] = info
        _telemetry.set_cost_provider(cost_fields)
        (emit or _telemetry.emit)({
            "kind": "compile", "phase": phase or label, "seconds": dt,
            "t_start": t0_wall, "t_end": t0_wall + dt, "mono_start": t0,
            "mono_end": t1, **info})
        return info
    except Exception:
        return None


def cost_info(label: str) -> dict[str, Any] | None:
    """The latest probe of ``label`` (None when never probed)."""
    with _LOCK:
        return _REGISTRY.get(label)


def cost_fields(op: str, seconds: float | None) -> dict[str, Any]:
    """Span fields for a measured run of the probed op ``op``: the
    analytic flops and bytes, the rates they imply over ``seconds`` and
    the roofline fraction where a peak is known; ``{}`` for unknown or
    ambiguous ops and invalid seconds."""
    info = cost_info(op)
    if not info or info.get("ambiguous") or not seconds or seconds <= 0:
        return {}
    out: dict[str, Any] = {}
    cb = info.get("bytes_accessed")
    cf = info.get("flops")
    if cb:
        out["cost_bytes"] = cb
        out["model_gbps"] = cb / seconds / 1e9
        peak = info.get("peak_gbps")
        if peak:
            out["roofline_frac"] = cb / seconds / 1e9 / peak
    if cf:
        out["cost_flops"] = cf
        out["model_gflops"] = cf / seconds / 1e9
    return out


def reset() -> None:
    """Drop all probe state (tests)."""
    with _LOCK:
        _REGISTRY.clear()
        _PROBED.clear()
