"""Instrumentation: sync-honest timers (``timers.py``) and the stable
report lines (``report.py``)."""
