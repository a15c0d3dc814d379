"""TPM1xx: sync-honest timing (≅ the JAX package's rule).

CUDA launches are asynchronous, so a ``perf_counter`` pair around a
kernel launch or a torch op on a card tensor times the *launch*, not the
work: the time lands on whichever later operation waits for the stream.
The port's honest brackets are ``torch.cuda.synchronize``, an event's
``synchronize()``, a host read (``.item()``, ``.cpu()``), the port's
``timers.block`` / ``block_stream``, and the helpers that embed them
(``comm_span``, ``span_call``, ``PhaseTimer.timed``, ``chain_rate``,
``dispatch_rate``, ``host_value``): a monotonic-clock pair whose timed
region launches device work without any of them is dishonest timing.

Two rules share the region detector
(:func:`tpu_mpi_tests_torch.analysis.program.iter_timed_regions`):

* **TPM101** (file scope): the region itself launches device work (a
  call into ``torch`` or the port's ``kernels``/``comm`` layers).
* **TPM102** (project scope): the region launches *through a helper*,
  one whose whole-program summary launches device work and never syncs.
"""

from __future__ import annotations

import ast
from typing import Iterator

from tpu_mpi_tests_torch.analysis.core import (
    FileContext,
    ProjectContext,
    last_attr,
)
from tpu_mpi_tests_torch.analysis.program import (
    SYNC_NAMES,
    iter_timed_regions,
)
from tpu_mpi_tests_torch.analysis.rules import _util


class SyncHonesty:
    name = "sync-honesty"
    scope = "file"
    codes = {
        "TPM101": "monotonic-clock pair times a device launch with no "
                  "host sync (synchronize/block/comm_span) in the "
                  "region",
    }

    def check(self, ctx: FileContext) -> Iterator[tuple]:
        local_device = _util.device_callables(ctx)
        for region in iter_timed_regions(ctx):
            yield from self._check_region(ctx, region, local_device)

    def _check_region(self, ctx, region, local_device):
        dispatches: list[ast.Call] = []
        for stmt in region:
            for call in _util.walk_calls(stmt):
                if last_attr(call.func) in SYNC_NAMES:
                    return  # region synchronizes; timing is honest
                if _util.is_device_call(ctx, call, local_device):
                    dispatches.append(call)
        for call in dispatches[:1]:
            yield (
                call.lineno, call.col_offset, "TPM101",
                f"timed region launches "
                f"'{_util.call_name(call.func)}' without a host sync "
                f"— an asynchronous launch makes this a launch-time "
                f"measurement; wait with torch.cuda.synchronize()/"
                f"timers.block() or use comm_span/PhaseTimer.timed",
            )


class InterprocSyncHonesty:
    name = "sync-honesty-interproc"
    scope = "project"
    codes = {
        "TPM102": "timed region calls a helper whose call graph "
                  "launches device work with no host sync "
                  "(interprocedural TPM101)",
    }

    def check_project(self, proj: ProjectContext) -> Iterator[tuple]:
        idx = proj.index
        for ff in proj.facts:
            for region in ff["timed_regions"]:
                for target, line, col in region["calls"]:
                    funcs = idx.resolve_funcs(target, ff["module"])
                    if not funcs:
                        continue
                    if any(idx.dispatches(fn) and not idx.syncs(fn)
                           for fn in funcs):
                        short = target.rsplit(".", 1)[-1]
                        yield (
                            ff["path"], line, col, "TPM102",
                            f"timed region calls '{short}' whose call "
                            f"graph launches device work and never "
                            f"syncs — the clock pair measures its "
                            f"launches, not its work; sync inside "
                            f"the region (torch.cuda.synchronize/"
                            f"block/comm_span) or inside the helper",
                        )
                        break  # one finding per region, like TPM101
