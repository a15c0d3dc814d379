"""Chaos layer: deterministic, flag-driven fault injection (≅
``tpu_mpi_tests/chaos``).

``--chaos <spec>`` / ``TPU_MPI_CHAOS`` arms seeded, deterministic faults
(killed rank, straggler, wedged dispatch, OOM ramp, serve flood) inside
the observability spine's existing hooks, and the JAX package's
stdlib-only ``tpumt-doctor`` (``tpu_mpi_tests/instrument/diagnose.py``)
must then convict the right failure class on the right rank from the
organic records of the port's JSONL alone (README "Chaos & diagnosis").

Containment: nothing in the package reaches into this one but the one
arm point, ``drivers/_common.make_reporter``, and a disarmed run installs
no chaos state — its hot paths run the code of a build without this
package.

Re-exports resolve lazily (PEP 562): ``spec`` is stdlib-only, while
``inject`` touches telemetry and timers when it arms.
"""

from __future__ import annotations

_EXPORTS = {
    "FaultSpec": "spec",
    "FAULT_CLASSES": "spec",
    "FINDING_FOR": "spec",
    "parse_chaos_spec": "spec",
    "arm": "inject",
    "arm_from_spec": "inject",
    "armed": "inject",
    "disarm": "inject",
}
__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        mod = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
