"""TPM11xx — collective divergence under rank-dependent control flow (≅
the JAX package's rule).

The classic SPMD deadlock: a collective is reachable from a branch only
*some* ranks take (``if dist.get_rank() == 0: dist.all_reduce(t)``). The
ranks that enter the collective wait forever for the ranks that never
will — nothing errors, the pod just stops, and the only post-mortem is
a watchdog dump (PAPER §2's halo pillar and §3's ``MPI_IN_PLACE``
probes are instruments for catching exactly this *after* the fact; this
rule catches it at lint time). With the whole-program summaries the
check is interprocedural: a rank-guarded branch that calls a helper
whose call graph dispatches a collective diverges just the same.

Detection (conservative by design): for every ``if`` whose test is
rank-dependent — a ``process_index()`` call, a comparison against a
rank-named variable/attribute, or a truthiness test like
``if not rank:`` / a tested local aliasing ``process_index()`` —
flatten each *path's* event sequence (computed to function exit over
the CFG, so branches that ``return`` early carry only what they
actually run) into the collective ops its execution dispatches (call
targets expanded through the project summaries) and compare. Equal
sequences (usually both empty: rank-0-only *printing* is everywhere
and fine) pass; any difference is a finding anchored at the ``if``.
Branches where exactly one side exits the function early belong to
TPM1102 (``rules/early_exit_divergence``) — this rule skips them so
every divergent ``if`` carries exactly one code.

Sanctioned rank-0-only sites (a single-process tune sweep, a rank-0
report/trace merge) carry the standard inline suppression with a
why-comment — the allowlist is explicit in the code it blesses, not
hidden in the rule.
"""

from __future__ import annotations

from typing import Iterator

from tpu_mpi_tests_torch.analysis.core import ProjectContext


def _render(seq: list[str]) -> str:
    return "[" + (", ".join(seq) if seq else "—") + "]"


class CollectiveDivergence:
    name = "collective-divergence"
    scope = "project"
    codes = {
        "TPM1101": "collective dispatch reachable from a rank-dependent "
                   "branch whose paths dispatch different collective "
                   "sequences — the SPMD deadlock shape",
    }

    def check_project(self, proj: ProjectContext) -> Iterator[tuple]:
        idx = proj.index
        for ff in proj.facts:
            for fn in ff["functions"]:
                for ri in fn["rank_ifs"]:
                    if ri["then_exits"] != ri["else_exits"]:
                        continue  # the early-exit shape: TPM1102's
                    a = idx.collective_seq(ri["then"], ff["module"])
                    b = idx.collective_seq(ri["orelse"], ff["module"])
                    if a == b:
                        continue
                    yield (
                        ff["path"], ri["line"], ri["col"], "TPM1101",
                        f"rank-dependent branch dispatches diverging "
                        f"collective sequences: {_render(a)} on the "
                        f"guarded path vs {_render(b)} on the other — "
                        f"ranks that skip a collective the rest enter "
                        f"deadlock the mesh; hoist the collective out "
                        f"of the rank branch (or suppress with a "
                        f"why-comment for a sanctioned single-process "
                        f"rank-0-only site)",
                    )
