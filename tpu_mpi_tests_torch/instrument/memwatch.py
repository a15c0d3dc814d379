"""Device-memory watermarks and a census of what holds the memory (≅
``tpu_mpi_tests/instrument/memwatch.py``):

* :func:`device_memory_stats` — the caching allocator's counters of
  the card (``torch.cuda.memory_stats_as_nested_dict``, unflattened:
  ``allocated_bytes.all.current`` and ``.peak``) as the JAX fields
  ``bytes_in_use`` and
  ``peak_bytes_in_use``, and the card's capacity
  (``torch.cuda.mem_get_info``, read once per card) as ``bytes_limit``.
  ``{}`` on the CPU, and every consumer degrades (no watermark fields,
  never zeros; the live totals come from a walk of the host tensors).
* :func:`census` — what holds the memory, bucketed, top-K by bytes. On
  the card it counts the allocator's live blocks
  (``torch.cuda.memory_snapshot()``: every ``active_allocated`` block,
  keyed by its size, ``"<bytes>B·block"``): an allocation rounded up to
  the allocator's block, not a tensor (views share a block). On the CPU
  it counts the tensors the process holds, found by one walk of the
  garbage collector's objects, keyed ``"<shape>·<dtype>"`` and counted
  once per storage. Either is a walk, so it is taken only where the JAX
  census is (the start, the end, a phase's first exit, a watchdog
  fire), never by the sampler.
* :class:`MemWatch` — what ``--memwatch`` arms: a low-rate sampler
  thread (allocator counters only) plus the PhaseTimer hooks, emitting
  ``kind: "mem"`` records on the wall clock so they land on the merged
  timeline.

Nothing here waits for the device: allocator counters and snapshots are
host-side state, so the watchdog may call them while a stream hangs.
"""

from __future__ import annotations

import gc
import threading
import time
import warnings
from typing import Any, Callable

import torch

#: the fields every consumer reads
STATS_FIELDS = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")

#: default census depth (the watchdog dump's contract is 8)
CENSUS_TOP_K = 8

#: default sampler period: the sampler draws a counter track, it does
#: not profile allocation churn
SAMPLE_INTERVAL_S = 0.5

#: card index -> total bytes (mem_get_info asks the driver: once a card)
_LIMITS: dict[int, int] = {}


def _card_index(device) -> "int | None":
    if device is None:
        if not torch.cuda.is_initialized():
            return None
        return torch.cuda.current_device()
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return device.index if device.index is not None \
        else torch.cuda.current_device()


def _limit(idx: int) -> "int | None":
    if idx not in _LIMITS:
        try:
            _LIMITS[idx] = int(torch.cuda.mem_get_info(idx)[1])
        except Exception:
            return None
    return _LIMITS[idx]


def _allocator(idx: int) -> dict:
    """The allocator's ``all``-pool counters of card ``idx``: bytes
    allocated and blocks active, current and peak."""
    s = torch.cuda.memory_stats_as_nested_dict(idx)
    return {"bytes": s["allocated_bytes"]["all"],
            "blocks": s["active"]["all"]}


def device_memory_stats(device=None, query_limit: bool = True
                        ) -> dict[str, dict[str, int]]:
    """``{card: {bytes_in_use, peak_bytes_in_use, bytes_limit}}`` of
    ``device`` (default: the current card once CUDA is initialised);
    ``{}`` on the CPU. ``query_limit=False`` reads only a limit already
    known (the watchdog's path: no driver query). Never raises."""
    try:
        idx = _card_index(device)
        if idx is None:
            return {}
        b = _allocator(idx)["bytes"]
    except Exception:
        return {}
    out = {"bytes_in_use": int(b["current"]),
           "peak_bytes_in_use": int(b["peak"])}
    limit = _limit(idx) if query_limit else _LIMITS.get(idx)
    if limit is not None:
        out["bytes_limit"] = limit
    return {str(idx): out}


def _card_census(idx: int):
    buckets: dict[str, list[int]] = {}
    for seg in torch.cuda.memory_snapshot():
        if seg.get("device", idx) != idx:
            continue
        for b in seg.get("blocks", ()):
            if b.get("state") != "active_allocated":
                continue
            size = int(b.get("size", 0))
            e = buckets.setdefault(f"{size}B·block", [0, 0])
            e[0] += 1
            e[1] += size
    return buckets


def _host_tensors():
    """(tensor, storage bytes) of every CPU tensor the process holds, one
    a storage, found by one walk of the garbage collector's objects."""
    seen: set = set()
    with warnings.catch_warnings():
        # isinstance on some deprecated torch objects warns
        warnings.simplefilter("ignore")
        tensors = [o for o in gc.get_objects()
                   if isinstance(o, torch.Tensor)]
    for obj in tensors:
        try:
            if obj.device.type != "cpu":
                continue
            storage = obj.untyped_storage()
            key_ptr = storage.data_ptr()
            if key_ptr in seen:
                continue
            seen.add(key_ptr)
            nbytes = int(storage.nbytes())
        except Exception:
            continue
        yield obj, nbytes


def _host_census():
    buckets: dict[str, list[int]] = {}
    for obj, nbytes in _host_tensors():
        key = "x".join(str(s) for s in obj.shape) or "scalar"
        key = f"{key}·{str(obj.dtype).removeprefix('torch.')}"
        e = buckets.setdefault(key, [0, 0])
        e[0] += 1
        e[1] += nbytes
    return buckets


def census(top_k: int = CENSUS_TOP_K, device=None) -> dict[str, Any] | None:
    """``{"count": N, "bytes": B, "top": [{key, count, bytes}, ...]}``
    (see the module docstring for what is counted); None when the walk
    fails."""
    try:
        idx = _card_index(device)
        buckets = _card_census(idx) if idx is not None else _host_census()
    except Exception:
        return None
    top = sorted(buckets.items(), key=lambda kv: -kv[1][1])[:max(top_k, 0)]
    return {
        "count": sum(c for c, _ in buckets.values()),
        "bytes": sum(b for _, b in buckets.values()),
        "top": [{"key": k, "count": c, "bytes": b} for k, (c, b) in top],
    }


def _live_totals(device=None) -> "tuple[int, int] | None":
    """(blocks, bytes) live in the card's allocator, from its counters
    (no walk); on the CPU (tensors, bytes) of the live host tensors, the
    census walk without its buckets (≅ the JAX ``_live_totals``: the
    growth signal of a backend with no allocator counters). None when
    neither can be read."""
    try:
        idx = _card_index(device)
        if idx is None:
            count = total = 0
            for _obj, nbytes in _host_tensors():
                count += 1
                total += nbytes
            return count, total
        a = _allocator(idx)
    except Exception:
        return None
    return int(a["blocks"]["current"]), int(a["bytes"]["current"])


def _device_fields(rec: dict, devices: dict) -> None:
    rec["devices"] = devices
    rec["bytes_in_use"] = sum(d.get("bytes_in_use", 0)
                              for d in devices.values())
    rec["peak_bytes_in_use"] = max(d.get("peak_bytes_in_use", 0)
                                   for d in devices.values())


def mem_record(event: str = "sample", phase: str | None = None,
               top_k: int = 0, t_start: float | None = None,
               t_end: float | None = None, device=None,
               query_limit: bool = True) -> dict[str, Any]:
    """One ``kind: "mem"`` record: the wall time ``t``, the card's
    watermarks where it has them, the live totals, and (``top_k`` > 0)
    the census. On the CPU: no ``devices`` or ``bytes_in_use`` keys, the
    live totals those of the host walk (the census's, when one is
    taken)."""
    rec: dict[str, Any] = {"kind": "mem", "event": event, "t": time.time()}
    if phase is not None:
        rec["phase"] = phase
    if t_start is not None:
        rec["t_start"] = t_start
    if t_end is not None:
        rec["t_end"] = t_end
    devices = device_memory_stats(device, query_limit=query_limit)
    if devices:
        _device_fields(rec, devices)
    c = census(top_k, device) if top_k > 0 else None
    if c is not None:
        rec["census"] = c
    # the CPU's totals are a walk: take the census's when it walked
    totals = (c["count"], c["bytes"]) if c is not None and not devices \
        else _live_totals(device)
    if totals is not None:
        rec["live_count"], rec["live_bytes"] = totals
    return rec


def watermark_lines(top_k: int = CENSUS_TOP_K, device=None) -> list[str]:
    """Human dump for a watchdog fire: the card's watermarks (the limit
    only if already known) and the top census buckets. Never raises."""
    lines: list[str] = []
    try:
        for dev, s in sorted(device_memory_stats(
                device, query_limit=False).items()):
            lines.append(" ".join([f"HBM dev{dev}:"] + [
                f"{k}={s[k]}" for k in STATS_FIELDS if k in s]))
    except Exception:
        pass
    c = census(top_k, device)
    if c is not None:
        lines.append(f"LIVE census: {c['count']} buffers, {c['bytes']} bytes")
        for e in c["top"]:
            lines.append(f"LIVE {e['key']}: n={e['count']} bytes={e['bytes']}")
    return lines


class MemWatch:
    """Run-long memory recorder: a daemon sampler thread plus PhaseTimer
    hooks, both emitting ``kind: "mem"`` records through ``sink`` (≅ the
    JAX ``MemWatch``).

    Records: ``event: "start"`` (with census) at :meth:`start`;
    ``event: "sample"`` every ``interval_s`` on the card (allocator
    counters, no census; the CPU has none to sample); ``event: "phase"``
    at a phase's first exit (with census) and again whenever that phase
    raised the peak watermark by more than 1% (on the CPU, which has no
    watermark: the live host bytes, as the JAX hook's live-array walk),
    with the in-use delta and the peak's rise across the body, and the
    live totals on every one; ``event: "final"`` (census) at
    :meth:`stop`. ``sink`` serialises its own writes (the reporter's
    ``jsonl`` does): the sampler and the phase hooks emit concurrently."""

    def __init__(self, sink: Callable[[dict], None],
                 interval_s: float = SAMPLE_INTERVAL_S,
                 top_k: int = CENSUS_TOP_K, device=None):
        self._sink = sink
        self._interval = max(float(interval_s), 0.02)
        self._top_k = top_k
        self._device = device
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        self._has_device_stats = False
        # phase -> {t0, devices at entry, emitted, last peak}
        self._phase_state: dict[str, dict[str, Any]] = {}

    def start(self) -> "MemWatch":
        from tpu_mpi_tests_torch.instrument import timers

        self._has_device_stats = bool(device_memory_stats(self._device))
        timers.add_phase_hook(self._on_phase)
        self._emit(mem_record(event="start", top_k=self._top_k,
                              device=self._device))
        if self._has_device_stats:
            self._thread = threading.Thread(
                target=self._run, name="tpumt-memwatch", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        """Idempotent: stop the sampler, detach the hook, emit the final
        record."""
        if self._stop.is_set():
            return
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        from tpu_mpi_tests_torch.instrument import timers

        timers.remove_phase_hook(self._on_phase)
        self._emit(mem_record(event="final", top_k=self._top_k,
                              device=self._device))

    def _emit(self, rec: dict) -> None:
        try:
            self._sink(rec)
        except Exception:
            pass  # observability never fails the run

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            self._emit(mem_record(event="sample", device=self._device))

    def _on_phase(self, name: str, event: str) -> None:
        if event == "begin":
            with self._lock:
                st = self._phase_state.setdefault(name, {})
                st["t0"] = time.time()
                if self._has_device_stats:
                    st["devices"] = device_memory_stats(self._device)
            return
        if event != "end":
            return
        # the cheap signal first: a hot-loop phase pays this every
        # iteration, and most exits emit nothing
        now = time.time()
        devices = (device_memory_stats(self._device)
                   if self._has_device_stats else {})
        if devices:
            peak = max(d.get("peak_bytes_in_use", 0)
                       for d in devices.values())
            totals = None
        else:
            # no watermark: the live host bytes are the growth signal
            totals = _live_totals(self._device)
            peak = totals[1] if totals is not None else 0
        with self._lock:
            st = self._phase_state.setdefault(name, {})
            first = not st.get("emitted")
            grew = peak > st.get("last_peak", 0) * 1.01
            if not (first or grew):
                return
            st["emitted"] = True
            st["last_peak"] = peak
            t_start = st.get("t0", now)
            begin = st.get("devices") or {}
        rec: dict[str, Any] = {"kind": "mem", "event": "phase",
                               "phase": name, "t": now, "t_start": t_start,
                               "t_end": now}
        if devices:
            _device_fields(rec, devices)
            if begin:
                rec["delta_bytes"] = rec["bytes_in_use"] - sum(
                    d.get("bytes_in_use", 0) for d in begin.values())
                rec["peak_delta"] = peak - max(
                    d.get("peak_bytes_in_use", 0) for d in begin.values())
            totals = _live_totals(self._device)
        if first:
            c = census(self._top_k, self._device)
            if c is not None:
                rec["census"] = c
        if totals is not None:
            rec["live_count"], rec["live_bytes"] = totals
        self._emit(rec)
