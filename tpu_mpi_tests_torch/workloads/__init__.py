"""Declarative workload specs (≅ ``tpu_mpi_tests/workloads/__init__.py``).

A spec holds what is particular to a pillar — its flags, the
``build → step → verify`` hooks, an optional bench row — and the generic
runner (:mod:`~tpu_mpi_tests_torch.workloads.runner`) supplies the
parser, device, reporter, phase timer and the ``WORKLOAD`` bench row.
The port has the JAX package's five specs: ``daxpy``, ``stencil1d``,
``moe``, ``embedding`` and ``decode``. Registering a spec also registers
its serve-mode handler (``drivers/_common.py`` workload registry, under
``spec.serve_name``: ``stencil1d``'s is the ``halo`` class), so a pillar
is a serving workload class the moment it exists.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover
    from tpu_mpi_tests_torch.workloads.spec import WorkloadSpec

_SPECS: dict[str, "WorkloadSpec"] = {}


def register_spec(spec: "WorkloadSpec") -> "WorkloadSpec":
    """Register a workload spec (idempotent per name: spec modules may be
    imported more than once under a test runner). A spec with a
    ``serve_factory`` lands in the driver workload registry under
    ``spec.serve_name`` (≅ JAX ``register_spec``)."""
    existing = _SPECS.get(spec.name)
    if existing is not None:
        return existing
    _SPECS[spec.name] = spec
    factory = spec.serve_factory
    if factory is not None:
        from tpu_mpi_tests_torch.drivers import _common

        _common.register_workload(spec.serve_name, factory)
    return spec


def load_specs() -> None:
    """Import every spec module (their ``register_spec`` calls run now)."""
    import tpu_mpi_tests_torch.workloads.daxpy  # noqa: F401
    import tpu_mpi_tests_torch.workloads.decode  # noqa: F401
    import tpu_mpi_tests_torch.workloads.embedding  # noqa: F401
    import tpu_mpi_tests_torch.workloads.moe  # noqa: F401
    import tpu_mpi_tests_torch.workloads.stencil1d  # noqa: F401


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
