"""Instrumentation (≅ ``tpu_mpi_tests/instrument/``): sync-honest timers
and their phase hooks (``timers.py``), the stable report lines and the
JSONL sink (``report.py``), trace ranges with profiler capture
(``trace.py``), and the instrument spine: comm spans, counters and the
flight recorder (``telemetry.py``), the run manifest and clock sync
(``manifest.py``), memory watermarks and census (``memwatch.py``), the
hang watchdog (``watchdog.py``), first-call costs with the analytic cost
model (``costs.py``), the NaN checks (``nans.py``), the cross-rank
trace merge (``timeline.py``) and the live plane armed by
``--metrics-port``: the metrics registry fed from the reporter's records
(``metrics.py``) and its OpenMetrics exporter and heartbeat
(``export.py``)."""
