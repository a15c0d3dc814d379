"""The generic workload runner: one flow for every spec (≅
``tpu_mpi_tests/workloads/runner.py``).

Arg parsing through the shared ``base_parser``, the device (the card
unless ``--device cpu``), the reporter, and the ``build → step →
verify`` hook sequence under a ProfilerGate with a shared PhaseTimer;
the reporter carries the observability wiring (``--telemetry``,
``--memwatch``, ``--trace-out``) and configures the schedule cache
(``--tune``, ``--tune-cache``, ``--tune-pack``, ``--tune-budget``), and
the body runs under ``run_guarded`` (``--deadline``, ``--debug-nans``).
A spec whose ``bench`` returns a row gets a ``WORKLOAD <name>:
<metric>=<value> <unit>`` line and a ``kind: "workload"`` record, written
only after its verify passed; a hook's :class:`SpecError` is a clean exit
with its code.

``main(argv)`` is the umbrella CLI (``python -m
tpu_mpi_tests_torch.workloads <name> ...``); each spec module also
exposes its own ``make_main``-built entry point.
"""

from __future__ import annotations

import sys

from tpu_mpi_tests_torch.drivers import _common
from tpu_mpi_tests_torch.workloads.spec import (
    RunContext,
    SpecError,
    WorkloadSpec,
)


def run_body(spec: WorkloadSpec, args) -> int:
    """The driver body: reporter + hook sequence + bench row."""
    from tpu_mpi_tests_torch.comm.mesh import bootstrap, topology
    from tpu_mpi_tests_torch.instrument.timers import PhaseTimer
    from tpu_mpi_tests_torch.instrument.trace import ProfilerGate

    device = bootstrap(args.device)
    topo = topology(device)
    # a spec that needs no mesh runs on this rank's device alone and
    # reports as a world of one, as the JAX runner does
    rank, size = ((topo.process_index, topo.global_device_count)
                  if spec.needs_mesh else (0, 1))
    with _common.make_reporter(args, rank=rank, size=size) as rep:
        ctx = RunContext(spec=spec, args=args, rep=rep, topo=topo,
                         device=device, timer=PhaseTimer())
        try:
            with ProfilerGate(args.profile_dir):
                state = spec.build(ctx)
                state = spec.step(ctx, state)
            rc = int(spec.verify(ctx, state) or 0)
        except SpecError as e:
            return e.rc  # the hook printed its ERROR line already
        # no bench row after a failed verify: a wrong result must not
        # give a valid-looking headline number
        if rc == 0:
            row = spec.bench(ctx, state)
            if row:
                _emit_bench_row(ctx, row)
        return rc


def _emit_bench_row(ctx: RunContext, row: dict) -> None:
    """One ``WORKLOAD`` line and its ``kind: "workload"`` record (≅ JAX
    ``_emit_bench_row``); the record carries ``higher_better`` so a
    comparison knows the direction of a regression."""
    metric = row["metric"]
    value = float(row["value"])
    unit = row.get("unit", "")
    rec = {
        "kind": "workload",
        "workload": ctx.spec.name,
        "metric": metric,
        "value": value,
        "unit": unit,
        "higher_better": bool(row.get("higher_better", True)),
        "dtype": ctx.args.dtype,
        "world": ctx.world,
    }
    for k, v in row.items():
        if k not in ("metric", "value", "unit", "higher_better"):
            rec[k] = v
    ctx.rep.line(
        f"WORKLOAD {ctx.spec.name}: {metric}={value:.6g}"
        f"{' ' + unit if unit else ''}",
        rec,
    )


def make_main(spec: WorkloadSpec):
    """Build a driver-shaped ``main(argv) -> int`` for one spec."""

    def main(argv=None) -> int:
        p = _common.base_parser(spec.title or spec.name)
        spec.add_args(p)
        args = p.parse_args(argv)
        spec.check_args(p, args)
        return _common.run_guarded(lambda a: run_body(spec, a), args)

    main.__doc__ = spec.title
    return main


def main(argv=None) -> int:
    """Umbrella CLI: ``<spec> [spec args...]`` or ``--list``."""
    from tpu_mpi_tests_torch import workloads

    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("--list", "-l"):
        for name in workloads.spec_names():
            print(name)
        return 0
    if argv[0] in ("--help", "-h"):
        print("usage: python -m tpu_mpi_tests_torch.workloads <spec> "
              "[args...] | --list")
        print("specs:", ", ".join(workloads.spec_names()))
        return 0
    name, rest = argv[0], argv[1:]
    try:
        spec = workloads.get_spec(name)
    except KeyError as e:
        print(f"ERROR {e.args[0]}", file=sys.stderr)
        return 2
    return make_main(spec)(rest)
