"""TPM7xx: schedule-constant hygiene (≅ the JAX package's rule).

A hand-pinned tile/block/staging constant freezes ONE machine's measured
optimum for every topology. The port's autotuner
(``tpu_mpi_tests_torch/tune/``) owns those values as cold-start priors
behind a persistent per-fingerprint schedule cache; this rule keeps the
door shut: a numeric schedule constant assigned at module level OUTSIDE
the tuner's modules is a finding. A knob declares its candidate space
(:func:`~tpu_mpi_tests_torch.tune.registry.declare_space`) and resolves
through the cache (explicit > cached > prior), not re-pin.

Sanctioned homes, exempt by construction:

* modules under ``tpu_mpi_tests_torch.tune`` (matched by whole dotted
  components: the JAX package's ``tpu_mpi_tests.tune`` is not one);
* assignments whose value routes through ``declare_space(...)``.

A compiled-in CUDA geometry (a tile that a ``csrc/`` template takes as a
constant, a register budget the kernel source fixes) is not a knob the
tuner could move: it carries the inline suppression with its reason.

Heuristic scope: ALL-CAPS module-level names containing a schedule
keyword (TILE/BLOCK/STEP/STAGING/SCHEDULE/CREDIT/MEASURED/K_GROUP/
DEPTH/OVERLAP) whose value carries a numeric literal. Inside the
workload specs (``tpu_mpi_tests_torch.workloads``) the keyword set is
extended with the serving-era knob vocabulary (CAPACITY/LOOKUP/COMBINE/
ROUTE/EXPERT/FANOUT), scoped there because those words are overloaded
elsewhere.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

from tpu_mpi_tests_torch.analysis.core import FileContext, last_attr, under

#: module-name prefix of the sanctioned schedule-constant home
TUNE_PREFIX = "tpu_mpi_tests_torch.tune"

#: module-name prefix that opts into the EXTENDED keyword set: workload
#: specs carry the serving-era knob vocabulary, and their schedule
#: constants are exempt only via declare_space
WORKLOADS_PREFIX = "tpu_mpi_tests_torch.workloads"

_CONST_NAME = re.compile(r"^_?[A-Z][A-Z0-9_]*$")
_SCHEDULE_WORD = re.compile(
    r"(TILE|BLOCK|STEP|STAGING|SCHEDULE|CREDIT|MEASURED|K_GROUP|KGROUP"
    r"|DEPTH|OVERLAP)"  # the pipeline knobs are schedules too
)
_SPEC_SCHEDULE_WORD = re.compile(
    # the serving-era knob vocabulary, in scope only inside
    # tpu_mpi_tests_torch.workloads (overloaded meanings elsewhere)
    r"(TILE|BLOCK|STEP|STAGING|SCHEDULE|CREDIT|MEASURED|K_GROUP|KGROUP"
    r"|DEPTH|OVERLAP|CAPACITY|LOOKUP|COMBINE|ROUTE|EXPERT|FANOUT)"
)


def _has_numeric_literal(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Constant) and isinstance(
            sub.value, (int, float)
        ) and not isinstance(sub.value, bool):
            return True
    return False


def _routes_through_registry(node: ast.AST) -> bool:
    """True when the assigned value contains a ``declare_space`` call —
    numerics inside a space declaration are candidates being registered,
    which is exactly the sanctioned alternative to pinning."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call) and last_attr(sub.func) == (
            "declare_space"
        ):
            return True
    return False


class ScheduleConstants:
    name = "schedule-constants"
    scope = "file"
    codes = {
        "TPM701": "hand-pinned numeric schedule constant outside the "
                  "tuner's registry/resolver modules "
                  "(tpu_mpi_tests_torch/tune/)",
    }

    def check(self, ctx: FileContext) -> Iterator[tuple]:
        if under(ctx.module, (TUNE_PREFIX,)):
            return
        word = (_SPEC_SCHEDULE_WORD
                if under(ctx.module, (WORKLOADS_PREFIX,))
                else _SCHEDULE_WORD)
        for stmt in ctx.tree.body:
            if isinstance(stmt, ast.Assign):
                targets, value = stmt.targets, stmt.value
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                targets, value = [stmt.target], stmt.value
            else:
                continue
            names = [
                t.id for t in targets
                if isinstance(t, ast.Name)
                and _CONST_NAME.match(t.id)
                and word.search(t.id)
            ]
            if not names:
                continue
            if not _has_numeric_literal(value):
                continue
            if _routes_through_registry(value):
                continue
            yield (
                stmt.lineno, stmt.col_offset, "TPM701",
                f"hand-pinned schedule constant {names[0]!r} — one "
                f"machine's optimum frozen for every topology; move the "
                f"value into tune/priors.py, declare the candidate "
                f"space with tune.declare_space where the knob lives, "
                f"and resolve through the schedule cache (explicit > "
                f"cached > prior)",
            )
