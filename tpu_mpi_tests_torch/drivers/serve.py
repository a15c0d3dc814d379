"""Serving mode: steady-state traffic against one process's warmed
handlers on its card (≅ ``tpu_mpi_tests/drivers/serve.py``,
``tpumt-serve``).

Every other driver is a one-shot benchmark; this one is a long-running
service loop (``serve/``) that keeps one process, its handlers' state on
the card and the warmed schedule cache alive, generates requests via an
arrival process (open-loop Poisson or closed-loop at a target
concurrency), draws each request from a mixed workload table
(``--workloads``: the registered handlers of ``drivers/_common.py`` —
daxpy step, stencil1d halo step, ring-attention block, small-payload
allreduce, MoE routing, decode allreduce, embedding lookup), coalesces
compatible requests into batches, and records per-request latency into
bounded-memory histograms. Each handler waits for the card before it
returns, so a latency is a completed request.

Output per workload class (the JAX driver's line + ``kind: "serve"``
JSONL)::

    SERVE <class>: offered=<hz>/s achieved=<hz>/s n=<done> err=<e> \
shed=<s> p50=<ms>ms p95=<ms>ms p99=<ms>ms qmax=<depth>

The JAX package's ``tpumt-report`` renders the merged records as the SLO
table and ``--diff`` gates the percentiles; with ``--telemetry
--trace-out`` every batch appears as a ``serve:<class>`` request span on
the timeline (a span waits for the whole device, so time SLO rows with
``--telemetry`` off). Which kernels serve is the schedule cache's choice:
a ``halo/staging`` winner of ``pallas`` sends the ``halo`` class through
the hand ring-halo kernel, a ``coll_variant/allreduce`` winner of
``rdma`` or ``oneshot`` the ``decode`` class through the hand ring or
one-shot collective kernels; the priors (``direct``, ``torch``) launch
no hand kernel.

Every flag of the JAX driver is here, ``--chaos`` included: a ``flood``
fault (``--chaos flood:burst=300:after=1``) arms through the serve loop's
``_CHAOS_FLOOD`` slot and bursts synthetic arrivals into the queue at an
SLO window boundary; ``--record`` keeps them in the artifact.

One process, one card: batch composition depends on real-time
arrival/service interleaving, which would diverge across ranks and
deadlock collectives, so a world of several processes prints the JAX
driver's ERROR line and exits 2 (the JAX run is one process, which may
span fake devices).
"""

from __future__ import annotations

import sys

from tpu_mpi_tests_torch.drivers import _common

# the SERVE line's parse pattern, next to its format string (the
# collbench COLL_LINE_RE idiom): the JAX driver's line, field for field
SERVE_LINE_RE = (
    r"SERVE ([\w:.]+): offered=([\d.e+-]+)/s achieved=([\d.e+-]+)/s "
    r"n=(\d+) err=(\d+) shed=(\d+) p50=([\d.e+-]+|-)ms "
    r"p95=([\d.e+-]+|-)ms p99=([\d.e+-]+|-)ms qmax=(\d+)"
)


def run(args) -> int:
    from tpu_mpi_tests_torch.comm.mesh import bootstrap, topology
    from tpu_mpi_tests_torch.instrument.watchdog import IdleAwareWatchdog
    from tpu_mpi_tests_torch.serve.arrival import ClosedLoop, OpenLoopPoisson
    from tpu_mpi_tests_torch.serve.loop import ServeLoop
    from tpu_mpi_tests_torch.serve.workloads import parse_workload_table
    from tpu_mpi_tests_torch.tune import registry as tr
    from tpu_mpi_tests_torch.utils import TpuMtError

    device = bootstrap(args.device)
    topo = topology(device)
    if topo.process_count > 1:
        print("ERROR serve mode is single-process only: batch "
              "composition depends on arrival/service timing and would "
              "diverge across ranks mid-collective (run one process, "
              "fake or real devices)")
        return 2
    world = topo.global_device_count

    try:
        classes = parse_workload_table(args.workloads)
    except ValueError as e:
        print(f"ERROR {e}")
        return 2

    # --replay: load + validate the traffic artifact BEFORE any handler
    # or reporter work — a refused artifact is a visible NOTE + exit 2
    # (never a crash, never a silent partial replay), and an accepted
    # one stamps its fingerprint into the run manifest so the JSONL is
    # self-describing about what traffic drove it
    replay_artifact = None
    manifest_extra = None
    if args.replay:
        from tpu_mpi_tests_torch.serve.replay import (
            TrafficFormatError,
            load_traffic,
        )

        try:
            replay_artifact = load_traffic(args.replay)
        except TrafficFormatError as e:
            print(f"NOTE traffic artifact refused: {e}")
            return 2
        unknown = sorted(set(replay_artifact.get("classes") or ())
                         - {c.key for c in classes})
        if unknown:
            print(f"NOTE replay traffic names workload classes absent "
                  f"from --workloads: {', '.join(unknown)} (re-run "
                  f"with the recording's workload table)")
            return 2
        if args.duration != replay_artifact["duration_s"]:
            print(f"NOTE --replay pins --duration to the artifact's "
                  f"{replay_artifact['duration_s']:g}s (byte-identical "
                  f"replay needs the recorded horizon)")
        args.duration = float(replay_artifact["duration_s"])
        manifest_extra = {
            "traffic_fingerprint": replay_artifact["fingerprint"],
            "traffic_count": replay_artifact["count"],
            "traffic_path": args.replay,
        }

    rep = _common.make_reporter(args, rank=topo.process_index,
                                size=world, manifest_extra=manifest_extra)
    with rep:
        if args.retune and rep.metrics is None:
            # --retune without --metrics-port: attach a sink-only
            # registry NOW, before the handlers warm — their tune_hit
            # records are what arm the stale watch, so the tee must be
            # live before the first resolution flows (no exporter, no
            # heartbeat threads: just the record tee)
            from tpu_mpi_tests_torch.instrument.metrics import (
                MetricsRegistry,
            )

            rep.attach_metrics(MetricsRegistry(
                health_sink=lambda rec: rep.jsonl(
                    {**rec, "rank": rep.proc_index})))
        if replay_artifact is not None:
            load = (f"replay={args.replay} "
                    f"fingerprint={replay_artifact['fingerprint']}")
            arrival_name = "replay"
        elif args.arrival == "poisson":
            load = f"rate={args.rate:g}/s"
            arrival_name = args.arrival
        else:
            load = f"concurrency={args.concurrency}"
            arrival_name = args.arrival
        rep.banner(
            f"serve: arrival={arrival_name} {load} "
            f"duration={args.duration:g}s world={world} "
            f"max_batch={args.max_batch} seed={args.seed} "
            f"classes={','.join(c.key for c in classes)}"
        )

        # warm-cache preload: knob owners imported, schedule cache
        # fingerprints resolved BEFORE traffic opens — no first request
        # pays a cold resolution inside its measured latency
        warm = tr.preload()
        if tr.configured_cache() is not None:
            rep.banner(f"serve: tune preload resolved {len(warm)} "
                       f"schedule knobs")

        # build + warm one persistent handler per workload class (each
        # factory runs one step — serve latency then measures the steady
        # state, not the first call)
        handlers = {}
        for cls in classes:
            try:
                factory = _common.workload_factory(cls.workload)
                handlers[cls.key] = factory(device, cls.shape, cls.dtype)
            except (TpuMtError, ValueError, KeyError) as e:
                rep.line(f"ERROR workload {cls.key}: {e}")
                return 2
        rep.banner(f"serve: {len(handlers)} handlers warmed, "
                   f"opening traffic")

        if replay_artifact is not None:
            from tpu_mpi_tests_torch.serve.replay import ReplayArrivals

            arrival = ReplayArrivals(replay_artifact)
        elif args.arrival == "poisson":
            arrival = OpenLoopPoisson(args.rate, seed=args.seed)
        else:
            arrival = ClosedLoop(args.concurrency)
        recorder = None
        if args.record:
            from tpu_mpi_tests_torch.serve.replay import TrafficRecorder

            recorder = TrafficRecorder(arrival=args.arrival, load=load)
        wd = (IdleAwareWatchdog(args.batch_deadline, "serve")
              if args.batch_deadline else None)
        loop = ServeLoop(
            classes, handlers, arrival,
            duration_s=args.duration,
            max_batch=args.max_batch,
            window_s=args.report_interval,
            max_queue=args.max_queue,
            seed=args.seed,
            sink=lambda rec: rep.jsonl({**rec, "rank": rep.rank}),
            watchdog=wd,
            quarantine_after=args.quarantine_after,
            recorder=recorder,
        )
        if args.retune:
            # the closed loop: tune_stale (metrics tee, attached above
            # before the handlers warmed) → bounded between-windows
            # re-sweep → hot swap via registry.resolve → kind:"control"
            # tune_swap records (tune/controller.py). The stale watch
            # reads span GB/s, so telemetry must be on. Bound to the
            # LOOP's handler dict (the loop copies the caller's) so a
            # hot swap lands in the dict batches dispatch from.
            from tpu_mpi_tests_torch.tune.controller import TuneController

            if not args.telemetry:
                rep.line("NOTE --retune needs --telemetry (tune_stale "
                         "watches span GB/s); the controller will "
                         "never fire")
            loop.controller = TuneController(
                rep.metrics, loop.handlers,
                sink=lambda rec: rep.jsonl({**rec, "rank": rep.rank}),
                line=rep.line,
                budget_s=args.batch_deadline or args.tune_budget,
                watchdog=wd,
            )
        summaries = loop.run()

        if recorder is not None:
            from tpu_mpi_tests_torch.serve.replay import save_traffic

            artifact = recorder.finalize(args.duration)
            save_traffic(args.record, artifact)
            rep.jsonl({
                "kind": "traffic", "event": "record", "rank": rep.rank,
                "path": args.record,
                "fingerprint": artifact["fingerprint"],
                "count": artifact["count"],
                "duration_s": artifact["duration_s"],
                "classes": artifact["classes"],
                "version": artifact["version"],
            })
            rep.line(
                f"SERVE TRAFFIC recorded: path={args.record} "
                f"fingerprint={artifact['fingerprint']} "
                f"count={artifact['count']}"
            )
        if replay_artifact is not None:
            rep.jsonl({
                "kind": "traffic", "event": "replay", "rank": rep.rank,
                "path": args.replay,
                "fingerprint": replay_artifact["fingerprint"],
                "count": replay_artifact["count"],
                "duration_s": replay_artifact["duration_s"],
                "classes": replay_artifact["classes"],
                "version": replay_artifact["version"],
            })
            rep.line(
                f"SERVE TRAFFIC replayed: path={args.replay} "
                f"fingerprint={replay_artifact['fingerprint']} "
                f"count={replay_artifact['count']}"
            )

        rc = 0
        for rec in summaries:
            def ms(field, rec=rec):
                v = rec.get(field)
                return "-" if v is None else format(v, ".4g")

            quar = (f" quarantines={rec['quarantines']} "
                    f"quar_s={rec['quarantine_s']:.4g}"
                    if rec.get("quarantines") else "")
            rep.line(
                f"SERVE {rec['class']}: "
                f"offered={rec['offered_hz']:.4g}/s "
                f"achieved={rec['achieved_hz']:.4g}/s "
                f"n={rec['requests']} err={rec['errors']} "
                f"shed={rec['shed']} p50={ms('p50_ms')}ms "
                f"p95={ms('p95_ms')}ms p99={ms('p99_ms')}ms "
                f"qmax={rec['queue_max']}{quar}"
            )
            if rec.get("quarantines"):
                # graceful degradation worked as designed: the dead
                # class was isolated and accounted instead of failing
                # the whole run — surface it loudly, and forgive
                # exactly the errors/sheds the quarantine accounts
                # for (the triggering streaks + quarantine-dropped
                # load). Failures OUTSIDE those episodes still rc-1:
                # one recovered quarantine is not amnesty for a class
                # that kept failing afterwards.
                rep.line(
                    f"SERVE QUARANTINE {rec['class']}: "
                    f"{rec['quarantines']} episode(s), "
                    f"{rec['quarantine_s']:.4g}s quarantined "
                    f"(err={rec['errors']} shed={rec['shed']} "
                    f"survived by the other classes)"
                )
                if (rec["errors"] > rec.get("quar_errors", 0)
                        or rec["shed"] > rec.get("quar_shed", 0)):
                    rc = 1
                continue
            if rec["errors"] or rec["shed"]:
                rc = 1
            if rec["arrivals"] and not rec["requests"]:
                rep.line(f"SERVE FAIL {rec['class']}: {rec['arrivals']} "
                         f"arrivals, zero completed")
                rc = 1
        if not sum(r["requests"] for r in summaries):
            rep.line("SERVE FAIL: no requests completed (duration too "
                     "short for the configured rate?)")
            rc = 1
        return rc


def main(argv=None) -> int:
    from tpu_mpi_tests_torch.serve.workloads import DEFAULT_TABLE

    p = _common.base_parser(__doc__)
    p.epilog += (
        " The JAX driver promotes --dtype to float64 when a workload "
        "class asks for it (jnp truncates to float32 otherwise); torch "
        "takes a float64 class as it is, so no flag changes here.")
    p.add_argument(
        "--duration", type=float, default=10.0, metavar="S",
        help="traffic window in seconds (the queue drains afterwards); "
        "serving runs are open-ended by design — pair long runs with "
        "--memwatch to watch HBM over hours",
    )
    p.add_argument(
        "--arrival", default="poisson", choices=["poisson", "closed"],
        help="arrival process: 'poisson' = open loop at --rate (latency "
        "includes queue wait from the scheduled arrival — coordinated "
        "omission impossible); 'closed' = fixed population of "
        "--concurrency clients, each re-issuing on completion",
    )
    p.add_argument(
        "--rate", type=float, default=20.0, metavar="HZ",
        help="open-loop offered rate, requests/second (default 20)",
    )
    p.add_argument(
        "--concurrency", type=int, default=4, metavar="N",
        help="closed-loop client population (default 4)",
    )
    p.add_argument(
        "--workloads", default=DEFAULT_TABLE, metavar="TABLE",
        help="comma list of name[:shape[:dtype[:weight]]] entries "
        "(shape dims 'x'-separated, e.g. attn:256x64:bfloat16:2); "
        "handlers: daxpy (vector step), halo (stencil1d exchange), "
        "attn (ring-attention block), allreduce (small-payload "
        "collective), moe (tokensxd_model capacity-bucketed routing), "
        "decode (batchxheads latency-bound allreduce), embedding "
        f"(vocabxbatchxd_model sharded lookup). Default: {DEFAULT_TABLE}",
    )
    p.add_argument(
        "--seed", type=int, default=0,
        help="RNG seed for the arrival schedule and workload mix "
        "(deterministic request sequences across runs)",
    )
    p.add_argument(
        "--max-batch", type=int, default=8, metavar="N",
        help="coalescing cap: at most N compatible (same shape x dtype "
        "x op) queued requests execute as one batch (default 8)",
    )
    p.add_argument(
        "--max-queue", type=int, default=10000, metavar="N",
        help="queue bound: arrivals beyond N waiting requests are shed "
        "and counted in the SLO table (default 10000)",
    )
    p.add_argument(
        "--report-interval", type=float, default=5.0, metavar="S",
        help="SLO window length: per-class kind:'serve' records emit "
        "every S seconds plus one run summary (default 5); the "
        "cross-window spread is the --diff noise band",
    )
    p.add_argument(
        "--quarantine-after", type=int, default=None, metavar="N",
        help="graceful degradation: a class whose handler fails N "
        "consecutive batches is quarantined (arrivals shed, backlog "
        "dropped, the other classes keep serving) and probed for "
        "recovery at each window boundary; quarantine/recovery time "
        "lands in the SLO table instead of the whole run exiting 1 "
        "(closed-loop note: requests shed during quarantine thin the "
        "client population like any shed). Default: off",
    )
    p.add_argument(
        "--retune", action="store_true",
        help="online closed-loop tuning: when a class's achieved GB/s "
        "sags below its tuned winner's baseline (the tune_stale health "
        "latch of the metrics tee), run a bounded re-sweep "
        "of that class's knob between SLO windows and hot-swap the "
        "schedule, emitting kind:'control' tune_swap records "
        "(tune/controller.py). Needs --telemetry; the re-sweep "
        "budget is --batch-deadline (else --tune-budget). Classes "
        "without a tune_info recipe are never re-tuned",
    )
    p.add_argument(
        "--record", default=None, metavar="PATH",
        help="capture this run's offered traffic (arrival times + class "
        "keys, chaos injections included) as a versioned portable "
        "artifact with a traffic fingerprint; replay it with --replay "
        "for identical-traffic A/B runs (serve/replay.py)",
    )
    p.add_argument(
        "--replay", default=None, metavar="PATH",
        help="drive the loop with a recorded traffic artifact instead "
        "of a synthetic arrival process: the recorded (time, class) "
        "stream is reproduced byte-identically, --duration is pinned "
        "to the recording's horizon, and the traffic fingerprint lands "
        "in the manifest so tpumt-report --diff can refuse cross-"
        "traffic comparisons; corrupt or version-mismatched artifacts "
        "are refused with a NOTE (exit 2)",
    )
    p.add_argument(
        "--batch-deadline", type=float, default=None, metavar="S",
        help="idle-aware watchdog: hard-exit if one BATCH exceeds S "
        "seconds (armed only around active dispatch — idle gaps "
        "between arrivals never fire it); distinct from --deadline, "
        "which bounds the whole run",
    )
    args = p.parse_args(argv)
    if args.duration <= 0:
        p.error("--duration must be positive")
    if args.rate <= 0:
        p.error("--rate must be positive")
    if args.concurrency < 1:
        p.error("--concurrency must be >= 1")
    if args.max_batch < 1:
        p.error("--max-batch must be >= 1")
    if args.report_interval <= 0:
        p.error("--report-interval must be positive")
    if args.max_queue < 1:
        p.error("--max-queue must be >= 1")
    if args.quarantine_after is not None and args.quarantine_after < 1:
        p.error("--quarantine-after must be >= 1 (omit to disable)")
    if args.record and args.replay:
        p.error("--record and --replay are mutually exclusive (replaying "
                "a recording while re-recording it would fork the "
                "traffic identity)")
    if args.batch_deadline is not None and args.batch_deadline <= 0:
        # a negative Timer fires immediately: the first batch would die
        # with a bogus "hung collective" diagnosis
        p.error("--batch-deadline must be positive (omit to disable)")
    if args.arrival == "closed" and args.concurrency > args.max_queue:
        # a shed closed-loop client is never re-armed (re-arming a
        # request the full queue just rejected would spin) — the
        # population would silently decay below what the flag promised
        p.error("--concurrency must be <= --max-queue for closed-loop "
                "arrivals (shed clients leave the population for good)")
    return _common.run_guarded(run, args)


if __name__ == "__main__":
    sys.exit(main())
