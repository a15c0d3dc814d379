"""Instrumentation: sync-honest timers (``timers.py``), the stable
report lines (``report.py``), and trace ranges with profiler capture
(``trace.py``)."""
