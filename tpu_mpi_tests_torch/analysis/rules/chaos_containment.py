"""TPM10xx: chaos containment (≅ the JAX package's rule).

A fault-injection hook left reachable from a hot path is a shipped bug:
one forgotten ``chaos.arm(...)`` or a stray ``from tpu_mpi_tests_torch
import chaos`` in a driver and a production run can kill ranks, wedge
launches or flood its own serve queue. The port arms faults in exactly
ONE place: ``drivers/_common.make_reporter`` (``_arm_chaos``) resolves
``--chaos`` / ``$TPU_MPI_CHAOS`` once at reporter construction. ANY
import of ``tpu_mpi_tests_torch.chaos`` (module-level or lazy:
reachability is the hazard, not import timing) or call into a chaos
alias outside the sanctioned homes is a finding.

Sanctioned homes, exempt by construction: modules under
``tpu_mpi_tests_torch.chaos``, the arm-point module
``tpu_mpi_tests_torch.drivers._common``, and test modules.
"""

from __future__ import annotations

import ast
from typing import Iterator

from tpu_mpi_tests_torch.analysis.core import FileContext, is_test_file, under

CHAOS_PKG = "tpu_mpi_tests_torch.chaos"

#: the one production module allowed to import the chaos layer
SANCTIONED_MODULES = {"tpu_mpi_tests_torch.drivers._common"}


def _exempt(module: str) -> bool:
    if under(module, (CHAOS_PKG,)):
        return True
    if module in SANCTIONED_MODULES:
        return True
    return is_test_file(module.rsplit(".", 1)[-1])


def _is_chaos(target: str) -> bool:
    return under(target, (CHAOS_PKG,))


class ChaosContainment:
    name = "chaos-containment"
    scope = "file"
    codes = {
        "TPM1001": "chaos fault injection reachable outside "
                   "tpu_mpi_tests_torch/chaos/ and the sanctioned "
                   "arm-point (drivers/_common.make_reporter)",
    }

    def check(self, ctx: FileContext) -> Iterator[tuple]:
        if _exempt(ctx.module):
            return
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if _is_chaos(a.name):
                        yield self._hit(node, f"import {a.name}")
            elif isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                if node.level:
                    continue  # relative: resolved below via calls
                if _is_chaos(mod):
                    yield self._hit(node, f"from {mod} import ...")
                elif mod == "tpu_mpi_tests_torch" and any(
                    a.name == "chaos" for a in node.names
                ):
                    yield self._hit(
                        node, "from tpu_mpi_tests_torch import chaos"
                    )
            elif isinstance(node, ast.Call):
                resolved = ctx.imports.resolve(node.func)
                if resolved and _is_chaos(resolved):
                    yield self._hit(node, f"call to {resolved}")

    def _hit(self, node: ast.AST, what: str) -> tuple:
        return (
            node.lineno, node.col_offset, "TPM1001",
            f"{what} — a fault-injection hook reachable from "
            f"production code is a shipped bug; faults arm ONLY "
            f"through --chaos/$TPU_MPI_CHAOS in drivers/_common."
            f"make_reporter (_arm_chaos)",
        )
