"""TPM1102 — rank-guarded early exit before a collective (≅ the JAX
package's rule).

The other half of the SPMD-deadlock family, and the documented TPM1101
false negative of a lexical branch comparison:

    if rank != 0:
        return x            # every non-zero rank leaves here
    total = allreduce_sum(x, mesh)   # rank 0 waits forever

The lexical engine compared the two branch bodies' event sequences, and
both were collective-free — the ``return`` made the *rest of the
function* unreachable for most ranks, but statements after the branch
were not part of either branch's summary. With the CFG
(:mod:`tpu_mpi_tests_torch.analysis.cfg`) an exit is an edge: each path's
event sequence now runs to the function exit, so the path that leaves
early is visibly missing every collective the continuing path still
dispatches (interprocedurally, through the project summaries).

Fires when exactly one side of a rank-dependent ``if`` terminates the
function (``return``/``raise``/``break``/``continue`` — no fallthrough
to the join) and the two paths' collective sequences differ.
Symmetric-exit and no-exit divergences stay TPM1101
(``rules/collective_divergence``); every divergent ``if`` carries
exactly one code.
"""

from __future__ import annotations

from typing import Iterator

from tpu_mpi_tests_torch.analysis.core import ProjectContext


def _render(seq: list[str]) -> str:
    return "[" + (", ".join(seq) if seq else "—") + "]"


class EarlyExitDivergence:
    name = "early-exit-divergence"
    scope = "project"
    codes = {
        "TPM1102": "rank-guarded early exit skips a collective the "
                   "continuing ranks still enter — the SPMD deadlock "
                   "shape the lexical engine could not see",
    }

    def check_project(self, proj: ProjectContext) -> Iterator[tuple]:
        idx = proj.index
        for ff in proj.facts:
            for fn in ff["functions"]:
                for ri in fn["rank_ifs"]:
                    if ri["then_exits"] == ri["else_exits"]:
                        continue  # symmetric: TPM1101's shape
                    a = idx.collective_seq(ri["then"], ff["module"])
                    b = idx.collective_seq(ri["orelse"], ff["module"])
                    if a == b:
                        continue
                    exiting, staying = (
                        ("guarded", b) if ri["then_exits"]
                        else ("unguarded", a)
                    )
                    yield (
                        ff["path"], ri["line"], ri["col"], "TPM1102",
                        f"rank-dependent branch exits the function "
                        f"early on its {exiting} path while the "
                        f"continuing ranks dispatch "
                        f"{_render(staying)} — the ranks that left "
                        f"never enter the collective and the mesh "
                        f"deadlocks; run the collective on every rank "
                        f"before the rank-guarded exit (or suppress "
                        f"with a why-comment for a sanctioned "
                        f"single-process site)",
                    )
