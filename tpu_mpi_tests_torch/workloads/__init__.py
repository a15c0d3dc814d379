"""Declarative workload specs (≅ ``tpu_mpi_tests/workloads/__init__.py``).

A spec holds what is particular to a pillar — its flags, the
``build → step → verify`` hooks, an optional bench row — and the generic
runner (:mod:`~tpu_mpi_tests_torch.workloads.runner`) supplies the
parser, device, reporter and phase timer. The port has one spec so far,
``daxpy``; serve-mode registration waits for ``serve/`` (ROADMAP queue 1
item 19).
"""

from __future__ import annotations

from typing import TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover
    from tpu_mpi_tests_torch.workloads.spec import WorkloadSpec

_SPECS: dict[str, "WorkloadSpec"] = {}


def register_spec(spec: "WorkloadSpec") -> "WorkloadSpec":
    """Register a workload spec (idempotent per name: spec modules may be
    imported more than once under a test runner)."""
    return _SPECS.setdefault(spec.name, spec)


def load_specs() -> None:
    """Import every spec module (their ``register_spec`` calls run now)."""
    import tpu_mpi_tests_torch.workloads.daxpy  # noqa: F401


def spec_names() -> tuple[str, ...]:
    load_specs()
    return tuple(sorted(_SPECS))


def get_spec(name: str) -> "WorkloadSpec":
    load_specs()
    try:
        return _SPECS[name]
    except KeyError:
        raise KeyError(
            f"no workload spec {name!r}; registered: "
            f"{','.join(sorted(_SPECS))}"
        ) from None
