"""The workload-spec contract and the per-run context it executes in (≅
``tpu_mpi_tests/workloads/spec.py``).

``build`` sets up state, ``step`` is the measured body (it owns its phase
timing via ``ctx.phase``) and ``verify`` is the analytic gate — the JAX
contract, on one device. The JAX spec's ``bench`` row, ``SpecError`` and
``serve_factory`` come with the first ported spec that uses them.
"""

from __future__ import annotations

import dataclasses
from contextlib import contextmanager
from typing import Any

import torch


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
