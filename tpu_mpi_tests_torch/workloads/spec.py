"""The workload-spec contract and the per-run context it executes in (≅
``tpu_mpi_tests/workloads/spec.py``).

``build`` sets up state, ``step`` is the measured body (it owns its phase
timing via ``ctx.phase``), ``verify`` is the analytic gate and ``bench``
the stable row — the JAX contract, one process per rank. A hook raises
:class:`SpecError` for a configuration error it has already printed. A
spec's ``serve_factory`` is its serve-mode handler, registered under
``serve_name`` in the ``drivers/_common.py`` workload registry when the
spec is (``workloads.register_spec``).
"""

from __future__ import annotations

import dataclasses
from contextlib import contextmanager
from typing import Any

import torch


class SpecError(Exception):
    """Raised by a spec hook for a user-input or configuration error that
    the runner turns into a clean nonzero exit; the hook prints its own
    ERROR line first (the driver convention: no traceback for a bad
    flag)."""

    def __init__(self, rc: int = 2):
        super().__init__(rc)
        self.rc = rc


@dataclasses.dataclass
class RunContext:
    """Everything a spec hook may need, built once per run by the runner:
    parsed args, the Reporter, the topology, the run's device, and a
    shared PhaseTimer whose lines the spec decides to emit."""

    spec: "WorkloadSpec"
    args: Any
    rep: Any
    topo: Any
    device: torch.device
    timer: Any

    @property
    def world(self) -> int:
        """The number of ranks (processes, one card each)."""
        return self.topo.global_device_count if self.topo else 1

    def dtype(self) -> torch.dtype:
        """The run's torch dtype."""
        from tpu_mpi_tests_torch.drivers import _common

        return _common.torch_dtype(self.args)

    @contextmanager
    def phase(self, name: str):
        """One timed phase: a trace range of the phase's name and a
        PhaseTimer phase (the body waits for its own device work)."""
        from tpu_mpi_tests_torch.instrument.trace import trace_range

        with trace_range(name), self.timer.phase(name):
            yield


class WorkloadSpec:
    """Base class: override the hooks; attributes steer the runner.

    ``name`` is the spec/driver identity (``python -m
    tpu_mpi_tests_torch.workloads <name>``); ``needs_mesh=False``: the
    spec runs on this rank's device alone, at any world, and reports as
    rank 0 of 1 (as the JAX spec on one of several devices)."""

    name: str = "?"
    title: str = ""
    needs_mesh: bool = True

    def add_args(self, p) -> None:
        """Spec-specific flags on top of the shared ``base_parser``."""

    def check_args(self, p, args) -> None:
        """Validate; call ``p.error(...)`` on bad values (exit 2)."""

    def build(self, ctx: RunContext):
        """Initialise state; returns the object threaded through
        ``step``/``verify``."""
        raise NotImplementedError

    def step(self, ctx: RunContext, state):
        """The measured body; must end with the device synchronised."""
        raise NotImplementedError

    def verify(self, ctx: RunContext, state) -> int:
        """Analytic gate: print FAIL lines and return nonzero on a
        mismatch, 0 on pass."""
        raise NotImplementedError

    def bytes_model(self, ctx: RunContext, state) -> "int | None":
        """Nominal comm payload bytes of one step (an annotation, not a
        bandwidth claim; the serving specs' ``bench`` rows carry it as
        ``nbytes``); None when the comm wrappers annotate their own
        spans."""
        return None

    def bench(self, ctx: RunContext, state) -> "dict | None":
        """The stable bench row: ``{"metric", "value", "unit",
        "higher_better", ...extras}`` or None for no row (``daxpy`` and
        ``stencil1d`` keep their own lines, as in the JAX package). The
        runner prints it as ``WORKLOAD <name>: <metric>=<value> <unit>``
        with a ``kind: "workload"`` record, after a verify that
        passed."""
        return None

    # -- serve mode ------------------------------------------------------
    @property
    def serve_name(self) -> str:
        return self.name

    #: ``(device, shape, dtype) -> step_fn(n)`` or None; registered into
    #: the ``drivers/_common.py`` workload registry by ``register_spec``
    serve_factory = None
