"""The serving plane (≅ ``tpu_mpi_tests/serve/``): steady-state traffic
against one process's warmed handlers on its card.

Four small pure-Python pieces — arrival processes (``arrival.py``), a
weighted workload table (``workloads.py``), a class-compatible batcher
(``batcher.py``) and bounded-memory latency histograms (``histogram.py``,
which the live metrics registry builds its rolling windows from) —
around one single-threaded loop (``loop.py``), plus traffic record and
replay (``replay.py``). The device work is supplied by the
workload-handler registry in ``drivers/_common.py``; the observability
rides the telemetry/JSONL spine (``kind: "serve"`` records →
``tpumt-report``'s SLO table, batch spans → ``tpumt-trace``). Entry
point: ``python -m tpu_mpi_tests_torch.drivers.serve``.
"""

# lazy re-exports (PEP 562): every module here but the loop's run is
# stdlib-only and stays importable without torch
_EXPORTS = {
    "OpenLoopPoisson": "arrival",
    "ClosedLoop": "arrival",
    "coalesce": "batcher",
    "LatencyHistogram": "histogram",
    "ServeLoop": "loop",
    "Request": "loop",
    "WorkloadClass": "workloads",
    "WorkloadMix": "workloads",
    "parse_workload_table": "workloads",
    "DEFAULT_TABLE": "workloads",
}
__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        mod = importlib.import_module(
            f"tpu_mpi_tests_torch.serve.{_EXPORTS[name]}"
        )
        return getattr(mod, name)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}"
    )
