"""Shared driver plumbing (≅ ``tpu_mpi_tests/drivers/_common.py``): the
argument parser every driver starts from (the schedule plane's
``--tune``, ``--tune-cache``, ``--tune-pack`` and ``--tune-budget``, the
instrument spine's ``--telemetry``, ``--memwatch``, ``--mem-interval``,
``--trace-out``, ``--deadline`` and ``--debug-nans``), :func:`run_guarded`
(the watchdog and the NaN checks around a driver's body), the reporter
with its observability wiring (:func:`make_reporter`, the live plane's
``--metrics-port``, ``--metrics-interval`` and ``--metrics-all-ranks``
included, and the chaos layer's one arm point, ``--chaos``),
``--kernel auto``'s resolution, the dtype map and the process-grid spec.

The serve-mode workload-handler registry (:func:`register_workload`,
:func:`workload_factory`) lives here too, as in the JAX module.

Two JAX flags have no analogue and are not offered: ``--fake-devices``
(ranks are processes, started by a launcher) and ``--compile-cache``
(nothing is compiled per shape; the kernels are built once, at first
use)."""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from tpu_mpi_tests_torch.device import DEVICES
from tpu_mpi_tests_torch.instrument.report import Reporter

# ---------------------------------------------------------------------------
# Workload-handler registry (serve mode)
# ---------------------------------------------------------------------------

#: name -> factory ``(device, shape, dtype) -> step_fn`` (the JAX
#: factory takes the mesh where this one takes the device: a rank's world
#: is the process group); ``step_fn(n)`` executes ``n`` coalesced requests
#: against persistent state and returns only after the device has
#: finished (``timers.block``), so serve-mode latency reads are
#: sync-honest by contract, not by caller discipline
_WORKLOAD_FACTORIES: dict = {}


def register_workload(name: str, factory):
    """Register a serve-mode workload handler under ``name`` (≅ JAX
    ``register_workload``). Drivers and specs register the step their
    benchmark already exercises at import time; idempotent per name (a
    test runner may import a module twice); returns the factory so it can
    be used as a decorator."""
    _WORKLOAD_FACTORIES.setdefault(name, factory)
    return factory


def workload_names() -> tuple:
    _import_workload_owners()
    return tuple(sorted(_WORKLOAD_FACTORIES))


def workload_factory(name: str):
    """The registered factory for ``name``. Imports the owning modules on
    demand, so a lookup never depends on who imported what first."""
    _import_workload_owners()
    try:
        return _WORKLOAD_FACTORIES[name]
    except KeyError:
        raise KeyError(
            f"no workload handler {name!r}; registered: "
            f"{','.join(sorted(_WORKLOAD_FACTORIES))}"
        ) from None


def _import_workload_owners() -> None:
    """Import every module that registers a handler: the workload specs
    register theirs (``daxpy``, ``halo``, ``moe``, ``decode``,
    ``embedding``) through ``register_spec``; attnbench (``attn``) and
    collbench (``allreduce``) register directly."""
    import tpu_mpi_tests_torch.drivers.attnbench  # noqa: F401
    import tpu_mpi_tests_torch.drivers.collbench  # noqa: F401
    from tpu_mpi_tests_torch import workloads

    workloads.load_specs()


TORCH_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "bfloat16": torch.bfloat16,
}


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=description,
        epilog="The JAX drivers' --fake-devices and --compile-cache have "
        "no analogue here: ranks are processes (started by torchrun or "
        "the native launcher), and nothing is compiled per shape (the "
        "kernels are built once, at first use).")
    p.add_argument(
        "--device",
        default="cuda",
        choices=DEVICES,
        help="where to run: the GPU (default; raises when none is "
        "present) or, only when asked, the CPU with the kernels' plain "
        "torch versions",
    )
    p.add_argument(
        "--dtype",
        default="float32",
        choices=list(TORCH_DTYPES),
        help="element type; the reference is float64 (MPI_DOUBLE)",
    )
    p.add_argument(
        "--jsonl",
        default=None,
        help="append JSONL records here (runs over several processes "
        "suffix the path per process: out.jsonl -> out.p<i>.jsonl; merge "
        "with tpumt-report)",
    )
    p.add_argument(
        "--telemetry",
        action="store_true",
        help="record a span (op/bytes/axis/seconds/GB/s) for every comm "
        "wrapper call into the JSONL sink plus cumulative per-op counters "
        "(instrument/telemetry.py); spans wait for their op on the card, "
        "so leave this off for pure-throughput timing runs",
    )
    p.add_argument(
        "--memwatch",
        action="store_true",
        help="record the card's allocator watermarks and a census of what "
        "holds the memory as kind:'mem' JSONL records "
        "(instrument/memwatch.py): a low-rate sampler thread plus "
        "per-phase snapshots; needs --jsonl. On the CPU: the live host "
        "tensors, no sampler",
    )
    p.add_argument(
        "--mem-interval",
        type=float,
        default=0.5,
        metavar="S",
        help="memwatch sampler period in seconds (default 0.5)",
    )
    p.add_argument(
        "--trace-out",
        default=None,
        metavar="TRACE.json",
        help="on driver exit, merge the --jsonl record stream(s) into "
        "Chrome trace-event JSON here (rank 0 only; one track per rank, "
        "clock offsets applied); open in Perfetto/chrome://tracing",
    )
    p.add_argument(
        "--deadline",
        type=float,
        default=None,
        metavar="S",
        help="hang watchdog: dump the recent comm ops and the memory "
        "state, then hard-exit, if the driver exceeds S seconds "
        "(instrument/watchdog.py)",
    )
    p.add_argument(
        "--debug-nans",
        action="store_true",
        help="stop at the first NaN: every hand-kernel and comm wrapper "
        "checks its output and raises FloatingPointError naming the op "
        "(instrument/nans.py); off, nothing is checked",
    )
    p.add_argument(
        "--metrics-port", type=int, default=None, metavar="PORT",
        help="arm the live observability plane: tee every JSONL record "
        "into a metrics registry, write kind:'health' heartbeats and "
        "per-phase progress records, and serve the registry as "
        "OpenMetrics at http://0.0.0.0:PORT/metrics (rank 0; 0 binds a "
        "free port). Off by default: nothing is imported or installed",
    )
    p.add_argument(
        "--metrics-interval", type=float, default=1.0, metavar="S",
        help="heartbeat and progress-snapshot period in seconds (default "
        "1.0; needs --metrics-port)",
    )
    p.add_argument(
        "--metrics-all-ranks", action="store_true",
        help="serve /metrics on every rank, rank r at PORT + r (default: "
        "rank 0 only; needs --metrics-port)",
    )
    p.add_argument(
        "--profile-dir",
        default=None,
        help="capture a torch.profiler trace (Chrome format) into this "
        "dir (≅ nsys -c cudaProfilerApi)",
    )
    p.add_argument(
        "--chaos",
        default=None,
        metavar="SPEC",
        help="arm deterministic fault injection ($TPU_MPI_CHAOS when "
        "absent): comma list of class[:key=value]* faults — kill / "
        "straggler / wedge / oom / flood, e.g. "
        "'kill:rank=1:op=halo_exchange:after=3' (grammar in README "
        "'Chaos & diagnosis'); a disarmed run installs no chaos state",
    )
    p.add_argument(
        "--verbose", action="store_true", help="extra per-device reporting"
    )
    p.add_argument(
        "--tune",
        action="store_true",
        help="arm the measured autotuner: a knob with no cache entry for "
        "this configuration runs a candidate sweep on the device and "
        "stores the winner; without it cached winners still apply and a "
        "miss takes the shipped prior (tune/priors.py)",
    )
    p.add_argument(
        "--tune-cache",
        default=None,
        metavar="PATH",
        help="schedule cache file (default: $TPU_MPI_TUNE_CACHE, else "
        "~/.cache/tpumt/tune.json); a corrupt or stale file gives the "
        "priors",
    )
    p.add_argument(
        "--tune-pack",
        default=None,
        metavar="PACK",
        help="preload a schedule pack (python -m "
        "tpu_mpi_tests_torch.tune.pack) into the in-memory cache before "
        "any knob resolves; fingerprints still decide which entries "
        "apply, and a corrupt pack degrades to empty",
    )
    p.add_argument(
        "--tune-budget",
        type=float,
        default=60.0,
        metavar="S",
        help="wall-clock budget of a sweep in seconds: the prior is always "
        "measured, later candidates are dropped (and reported as skipped) "
        "once it is spent (default 60)",
    )
    return p


#: the numpy dtype host arrays are built in; numpy has no bfloat16, so a
#: bfloat16 run builds them in float32 and :func:`host_tensor` rounds
NUMPY_DTYPES = {
    "float32": np.float32,
    "float64": np.float64,
    "bfloat16": np.float32,
}


def torch_dtype(args) -> torch.dtype:
    return TORCH_DTYPES[args.dtype]


def numpy_dtype(args):
    return NUMPY_DTYPES[args.dtype]


def host_tensor(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A host numpy array as a CPU tensor of ``dtype`` (shared memory
    when the dtypes agree)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def run_guarded(run, args) -> int:
    """Run a driver body under the optional hang watchdog
    (``--deadline``) and the optional NaN checks (``--debug-nans``,
    disarmed again when the body returns); without a deadline the comm
    wrappers' flight notes, which only its dump reads, are dropped."""
    from tpu_mpi_tests_torch.instrument import nans, telemetry
    from tpu_mpi_tests_torch.instrument.watchdog import deadline

    nans.arm(getattr(args, "debug_nans", False))
    # the flight recorder's one reader is the --deadline watchdog's dump
    telemetry.record_flight(bool(getattr(args, "deadline", None)))
    try:
        with deadline(getattr(args, "deadline", None), "driver"):
            return run(args)
    finally:
        nans.arm(False)
        telemetry.record_flight(True)


def make_reporter(args, rank: "int | None" = None,
                  size: "int | None" = None,
                  manifest_extra: "dict | None" = None) -> Reporter:
    """The run's reporter with the observability wiring (≅ JAX
    ``make_reporter``). ``rank`` and
    ``size`` default to this process's place in the world
    (``comm.dist``); drivers emulating logical ranks in one process pass
    their own. ``manifest_extra`` is driver-known run identity merged into
    the manifest record (the serve driver's replayed traffic
    fingerprint, count and path). Called after the world is joined.

    * the JSONL path is suffixed per process when there are several;
    * ``--metrics-port``: the live plane (:func:`_arm_metrics`), armed
      first so the records below already feed it;
    * with a sink (``--jsonl``) or ``--telemetry``: the ``manifest``
      record first, then ``topo``, then (with a sink) ``clock_sync``,
      whose ``run_sync_us`` names the run for the ``--trace-out`` merge;
    * ``--telemetry``: the rank-0 ``MANIFEST`` banner, the registry on
      with this reporter's JSONL as its sink; closing the reporter writes
      the per-op ``TELEMETRY`` lines and disables it;
    * ``--memwatch`` (with ``--jsonl``): a running ``MemWatch``, stopped
      at close;
    * the schedule cache and its records (``setup_tuning``);
    * ``--chaos`` / ``$TPU_MPI_CHAOS``: the faults aimed at this process
      (:func:`_arm_chaos`), armed last."""
    from tpu_mpi_tests_torch.comm import dist

    w = dist.world()
    trace_out = getattr(args, "trace_out", None)
    if trace_out and not args.jsonl:
        print("NOTE --trace-out needs --jsonl (the trace is merged from "
              "the JSONL record stream); no trace will be written")
        trace_out = None
    rep = Reporter(rank=w.rank if rank is None else rank,
                   size=w.size if size is None else size,
                   jsonl_path=args.jsonl, proc_index=w.rank,
                   proc_count=w.size, trace_out=trace_out)
    _arm_metrics(args, rep)
    telemetry_on = getattr(args, "telemetry", False)
    if rep.jsonl_path or telemetry_on:
        from tpu_mpi_tests_torch.instrument.manifest import (
            clock_sync_record,
            manifest_banner,
            run_manifest,
            topo_record,
        )

        m = run_manifest(w.device, **(manifest_extra or {}))
        rep.jsonl(m)
        rep.jsonl(topo_record())
        if rep.jsonl_path:
            cs = clock_sync_record()
            rep.jsonl(cs)
            rep.run_sync_us = cs.get("run_sync_us")
        if telemetry_on:
            rep.banner(manifest_banner(m))
    if telemetry_on:
        from tpu_mpi_tests_torch.instrument import telemetry as T

        T.enable(sink=lambda rec: rep.jsonl({**rec, "rank": rep.rank}))
        rep.attach_telemetry()
    if getattr(args, "memwatch", False):
        if rep.jsonl_path:
            from tpu_mpi_tests_torch.instrument.memwatch import MemWatch

            rep.attach_memwatch(MemWatch(
                sink=lambda rec: rep.jsonl({**rec, "rank": rep.rank}),
                interval_s=getattr(args, "mem_interval", 0.5),
                device=w.device).start())
        else:
            print("NOTE --memwatch needs --jsonl (mem records stream to "
                  "the JSONL sink); no memory records will be written")
    setup_tuning(args)
    _attach_tune_sink(rep)
    _arm_chaos(args, rep, w)
    return rep


def _arm_chaos(args, rep: Reporter, w) -> None:
    """The chaos layer's one arm point (≅ JAX ``_arm_chaos``; nothing
    else in the package imports it): with ``--chaos`` or
    ``$TPU_MPI_CHAOS`` set, install the faults aimed at this process and
    audit them to the JSONL sink. Without a spec nothing is imported and
    nothing is installed. Faults are aimed, and their records stamped, by
    the process's own rank (``w.rank``), not ``rep.rank``: a spec that
    needs no mesh reports as rank 0 in every process."""
    spec_text = getattr(args, "chaos", None) or os.environ.get(
        "TPU_MPI_CHAOS")
    if not spec_text:
        return
    from tpu_mpi_tests_torch import chaos

    proc = w.rank
    try:
        mine = chaos.arm_from_spec(
            spec_text, rank=proc,
            emit=lambda rec: rep.jsonl({**rec, "rank": proc}),
            device=w.device)
    except ValueError as e:
        print(f"ERROR bad --chaos spec: {e}")
        raise SystemExit(2) from None
    for s in mine:
        rep.line(f"CHAOS armed: {s.describe()}")
        if s.op and not getattr(args, "telemetry", False):
            rep.line(f"NOTE chaos fault {s.raw!r} triggers on telemetry "
                     f"spans but --telemetry is off; it will never fire")


def _arm_metrics(args, rep: Reporter) -> None:
    """The live plane's one arm point (≅ JAX ``_arm_metrics``): with
    ``--metrics-port`` set, tee the reporter's records into a
    :class:`~tpu_mpi_tests_torch.instrument.metrics.MetricsRegistry`,
    start the heartbeat thread and the per-phase progress hook, and (rank
    0, or every rank with ``--metrics-all-ranks``, each at ``port +
    rank``) serve the registry as OpenMetrics. Without the flag nothing
    is imported and nothing is installed, so a disarmed run writes what
    it wrote before the plane existed. The heartbeat and the exporter
    read only the registry: neither touches the card."""
    port = getattr(args, "metrics_port", None)
    if port is None:
        return
    from tpu_mpi_tests_torch.instrument.export import (
        Heartbeat,
        MetricsExporter,
    )
    from tpu_mpi_tests_torch.instrument.metrics import (
        MetricsRegistry,
        PhaseProgress,
    )

    def sink(rec):
        # the process's own rank, not rep.rank: a spec that needs no mesh
        # reports as rank 0 in every process, and the heartbeat trail
        # tells the ranks' liveness apart
        rep.jsonl({**rec, "rank": rep.proc_index})

    interval = getattr(args, "metrics_interval", 1.0)
    reg = MetricsRegistry(health_sink=sink)
    rep.attach_metrics(reg)
    rep.attach_live(
        PhaseProgress(sink, interval_s=interval).start(),
        Heartbeat(reg, sink, interval_s=interval).start(),
    )
    all_ranks = getattr(args, "metrics_all_ranks", False)
    if rep.proc_index == 0 or all_ranks:
        bind = int(port) + (rep.proc_index if all_ranks and port else 0)
        try:
            exporter = MetricsExporter(reg, bind).start()
        except OSError as e:
            rep.line(f"METRICS ERROR: cannot bind port {bind}: {e}")
        else:
            rep.attach_live(exporter)
            rep.line(f"METRICS rank {rep.proc_index}: OpenMetrics at "
                     f"http://0.0.0.0:{exporter.port}/metrics")


def setup_tuning(args) -> None:
    """Configure the schedule cache for this run (≅ JAX
    ``_common.py:541-610``). It loads when the run asked for tuning
    (``--tune`` / ``--tune-cache`` / ``--tune-pack``) or the cache file
    exists; otherwise the registry is left unconfigured and every knob
    resolves to its prior. A ``--tune-pack`` is absorbed into the
    in-memory cache (newer measurement wins). Called after the world is
    joined, so every rank but 0 gets a read-only cache."""
    from tpu_mpi_tests_torch.tune import cache as tc
    from tpu_mpi_tests_torch.tune import registry as tr

    tr.deconfigure()
    path = getattr(args, "tune_cache", None) or tc.default_cache_path()
    pack_path = getattr(args, "tune_pack", None)
    wants = (getattr(args, "tune", False)
             or getattr(args, "tune_cache", None) or pack_path)
    if not wants and not os.path.exists(path):
        return
    cache = tr.configure(
        cache_path=path,
        enabled=getattr(args, "tune", False),
        budget_s=getattr(args, "tune_budget", None),
    )
    if pack_path:
        from tpu_mpi_tests_torch.tune import pack as tp

        doc = tp.load_pack(pack_path)
        if not doc["entries"]:
            print(f"NOTE --tune-pack {pack_path}: empty or unreadable "
                  f"pack; resolving from the local cache/priors")
        else:
            n = tp.absorb(cache, doc)
            print(f"TUNE PACK {pack_path}: {n} of "
                  f"{len(doc['entries'])} schedule entries preloaded")
        _check_pack_topology(pack_path, doc)


def _check_pack_topology(pack_path: str, doc: dict) -> None:
    """NOTE a ``--tune-pack`` measured on another topology (≅ JAX
    ``_check_pack_topology``): its entries can never resolve here."""
    from tpu_mpi_tests_torch.tune import pack as tp
    from tpu_mpi_tests_torch.tune.fingerprint import topology_label

    packed = tp.provenance(doc.get("entries") or {}).get("topologies") or []
    live = topology_label()
    if packed and live not in packed:
        decline_note(
            f"--tune-pack {pack_path}: pack topology {','.join(packed)} "
            f"does not match this run's {live}; its schedule entries will "
            f"not resolve here"
        )


def _attach_tune_sink(rep: Reporter) -> None:
    """Point the sweep records at this run's reporter (≅ JAX
    ``_attach_tune_sink``): every ``tune`` / ``tune_result`` /
    ``tune_hit`` record goes to the JSONL stream, stamped with the
    process's rank, and winners and hits get a ``TUNE`` line."""
    from tpu_mpi_tests_torch.tune import registry as tr

    tr.mark_fleet_rank()
    if tr.configured_cache() is None:
        return

    def emit(rec):
        rep.jsonl({**rec, "rank": rep.proc_index})
        kind = rec.get("kind")
        if kind == "tune_result":
            sec = rec.get("seconds")
            rep.line(
                f"TUNE {rec['knob']} winner={json.dumps(rec['value'])} "
                f"seconds={'-' if sec is None else f'{sec:.6g}'} "
                f"measured={rec.get('measured', 0)} "
                f"skipped={rec.get('skipped', 0)}"
            )
        elif kind == "tune_hit":
            rep.line(
                f"TUNE {rec['knob']} cache-hit "
                f"value={json.dumps(rec['value'])}"
            )

    tr.set_emit(emit)


def resolve_kernel_auto(dtype: str, n: int, world: int, rep) -> str:
    """``--kernel auto`` (≅ JAX ``resolve_kernel_auto``): the
    ``stencil/tier`` resolution mapped onto a driver's update body — the
    ``xla`` tier keeps the torch-op body (``torch``), every hand tier
    maps to the hand kernel (``hand``). The resolution is NOTE'd."""
    from tpu_mpi_tests_torch.comm.halo import resolve_stencil_tier

    tier = resolve_stencil_tier(None, dtype=dtype, n=n, world=world)
    kernel = "torch" if tier == "xla" else "hand"
    rep.line(f"NOTE --kernel auto -> {kernel} (stencil/tier {tier})")
    return kernel


def decline_note(msg: str) -> None:
    """Print a schedule-decline ``NOTE`` to stderr, flushed (the JAX
    package's ``decline_note``): a requested schedule cannot run here and
    another runs instead. Callers pass the message without the prefix."""
    print(f"NOTE {msg}", file=sys.stderr, flush=True)


def parse_choice_list(spec: str, valid, what: str = "entries"):
    """Split a comma list and validate each entry against ``valid``.
    Returns the list, or None after printing an ERROR line (a copy of the
    JAX package's ``parse_choice_list``)."""
    names = [s.strip() for s in spec.split(",") if s.strip()]
    bad = [n for n in names if n not in valid]
    if bad or not names:
        print(f"ERROR unknown {what} {bad or [spec]}; "
              f"valid: {','.join(valid)}")
        return None
    return names


def parse_grid_mesh(spec: "str | None", n_dev: int):
    """Resolve a 'PX,PY' process-grid spec (or auto-factor ``n_dev`` into
    the squarest grid when None) → ``(px, py)``. Returns None after
    printing an ERROR line when the spec is malformed, non-positive, or
    does not multiply to the device count (a copy of the JAX package's
    ``parse_grid_mesh``)."""
    if spec:
        try:
            px, py = (int(v) for v in spec.split(","))
        except ValueError:
            print(f"ERROR --mesh must be 'PX,PY', got {spec!r}")
            return None
        if px < 1 or py < 1:
            print(f"ERROR --mesh factors must be positive, got {px},{py}")
            return None
    else:
        px = 1
        for cand in range(int(n_dev**0.5), 0, -1):
            if n_dev % cand == 0:
                px = cand
                break
        py = n_dev // px
    if px * py != n_dev:
        print(f"ERROR --mesh {px},{py} needs {px * py} devices, "
              f"have {n_dev}")
        return None
    return px, py
