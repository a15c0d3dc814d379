"""TPM17xx — collective-protocol verification (≅ the JAX package's rule).

The hazard this family encodes is the composed one TPM1101/TPM1102
cannot see: each rank-guarded branch can look locally symmetric while
the *whole-program* schedule — assembled across functions, broadcast
wrappers, loops, and exception paths — still diverges per rank. On a
pod that is not a crash; it is one rank parked in a collective its
partners never enter, a silent fleet-wide hang (the `MPI_Waitall`
wedge the reference suite exists to catch).

The heavy lifting lives in :mod:`tpu_mpi_tests_torch.analysis.protocol`:
every function's ``proto`` event tree is summarized bottom-up into a
regular collective schedule, composed through the project call graph,
and checked pairwise over rank-feasible paths. This module is the thin
rule adapter: it owns the code table (TPM1704/TPM1705 are listed here
so ``--list-rules`` and the SARIF metadata stay the
single source of truth, but they are only ever *emitted* by the
``--conform`` replay — a static run cannot produce them).
"""

from tpu_mpi_tests_torch.analysis.core import ProjectContext


class ScheduleProtocol:
    name = "schedule-protocol"
    scope = "project"
    codes = {
        "TPM1701": "rank-divergent whole-program collective schedule "
                   "(divergence assembled across functions or through "
                   "broadcast wrappers / rank-returning helpers)",
        "TPM1702": "rank-dependent loop bound encloses a collective "
                   "(divergent trip counts deadlock the fleet)",
        "TPM1703": "collective reachable under an exception path whose "
                   "surviving handler skips the partner op",
        "TPM1704": "runtime (op, axis) stream no static schedule path "
                   "generates (--conform only: stale model or "
                   "dynamic-dispatch blind spot)",
        "TPM1705": "rank stream ends with a statically mandatory "
                   "collective un-emitted while a sibling emitted it "
                   "(--conform only: static twin of missing_rank)",
    }

    def check_project(self, proj: ProjectContext):
        from tpu_mpi_tests_torch.analysis.protocol import ProtocolIndex

        yield from ProtocolIndex(proj).check_all()
