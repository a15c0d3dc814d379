"""Shared AST helpers for the rule modules: re-exported from
:mod:`tpu_mpi_tests_torch.analysis.core`, where the facts extractor
(``analysis/program.py``) can use them without importing the rule
registry."""

from tpu_mpi_tests_torch.analysis.core import (  # noqa: F401
    call_name,
    device_callables,
    is_device_call,
    walk_calls,
)
