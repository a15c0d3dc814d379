"""TPM1301 — rank-guarded binding consumed without a broadcast (≅ the
JAX package's rule).

Rank 0 computes something (a tune-sweep winner, a batch plan) inside a
rank guard, and then EVERY rank acts on the name::

    if dist.get_rank() == 0:
        winner = sweep(space)       # only rank 0 has the real value
    else:
        winner = None               # placeholder, not a value
    apply_schedule(winner)          # ranks now disagree

Nothing deadlocks immediately, which makes this worse than TPM1101: the
ranks silently run different schedules. The SPMD-honest shape routes
the value through a replicating call first (the curated
:data:`tpu_mpi_tests_torch.analysis.program.BROADCAST_CALLS`:
``fleet.bcast``, ``dist.broadcast``, ``broadcast_object_list``,
``all_gather_object``).

Detection, over the per-function CFG facts: a name bound on exactly one
side of a rank-dependent ``if`` (a ``= None`` placeholder on the other
side does not count as a binding), not bound before the branch, whose
first read along the OTHER path is not a direct argument of a
broadcast-class call. Anchored at that read.
"""

from __future__ import annotations

from typing import Iterator

from tpu_mpi_tests_torch.analysis.core import ProjectContext
from tpu_mpi_tests_torch.analysis.program import BROADCAST_CALLS


class BroadcastConsistency:
    name = "broadcast-consistency"
    scope = "project"
    codes = {
        "TPM1301": "value bound only on a rank-guarded path is read on "
                   "the unguarded path without passing through a "
                   "broadcast-class collective",
    }

    def check_project(self, proj: ProjectContext) -> Iterator[tuple]:
        for ff in proj.facts:
            for fn in ff["functions"]:
                for ri in fn["rank_ifs"]:
                    for name, line, col, call in ri["unbcast"]:
                        if call in BROADCAST_CALLS:
                            continue
                        yield (
                            ff["path"], line, col, "TPM1301",
                            f"'{name}' is bound only on the "
                            f"rank-guarded path of the branch at line "
                            f"{ri['line']} but read here on the path "
                            f"the other ranks take — they see a stale "
                            f"or placeholder value and the ranks "
                            f"diverge; replicate it first "
                            f"(fleet.bcast/dist.broadcast/"
                            f"broadcast_object_list) or compute it on "
                            f"every rank",
                        )
