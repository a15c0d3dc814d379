"""TPM8xx: overlap-region sync discipline (≅ the JAX package's rule).

A host sync lexically inside a declared overlap region, between a
prefetch (``h = async_span(...)`` opening a dispatch-window span,
or ``win = DispatchWindow(...)``) and its consume point
(``h.done(...)``, ``h.wait(...)``, ``win.drain()``), silently
re-serializes the pipeline: results stay identical, it/s regresses and
``overlap_frac`` quietly drops toward 0. The syncs are torch's: a
``.synchronize()`` (``torch.cuda``, an ``Event`` or a ``Stream``), a
host read (``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``) and the
port's ``timers.block`` / ``timers.block_stream``. ``wait_stream`` and
``Event.wait`` order the device and are not syncs.

One sync inside the region is DELIBERATE by design: the overlapped
interior compute must block under its phase bracket, since that is the
window the exchange hides beneath. The engine (``comm/halo.py``
``OverlapRunner.step``: ``block_stream`` waits for the core's own stream
only) carries the sanctioned inline suppression with its reason.

Detection (lexical, per function scope): an assignment whose value
calls a prefetch source opens a region for that handle name; the first
consume call on the name closes it; a sync call at a line strictly
inside an open region is a TPM801 finding.

**TPM802** (project scope) is the interprocedural escape: a helper
*returns* its handle (the summaries track ``returns_handle``
transitively) and the caller assigns it to a name it never reads again,
so nobody will ever close it.
"""

from __future__ import annotations

import ast
from typing import Iterator

from tpu_mpi_tests_torch.analysis.core import (
    FileContext,
    ProjectContext,
    attr_parts,
    last_attr,
)

#: call targets that open an overlap region when bound to a name
PREFETCH_NAMES = {"async_span", "DispatchWindow"}
#: handle methods that consume (close) the region
CONSUME_ATTRS = {"done", "wait", "drain"}
#: method spellings of a host sync
SYNC_LAST_ATTRS = {"synchronize", "item", "tolist", "cpu", "numpy"}
#: function spellings of a host sync (final name: the port's timers and
#: a same-file helper of the same name are the same hazard)
SYNC_FUNCS = {"block", "block_stream", "synchronize"}


def _is_prefetch(call: ast.Call, ctx: FileContext) -> bool:
    resolved = ctx.imports.resolve(call.func) or ""
    return resolved.rsplit(".", 1)[-1] in PREFETCH_NAMES


def _is_sync(call: ast.Call, ctx: FileContext) -> bool:
    func = call.func
    if isinstance(func, ast.Attribute) and func.attr in SYNC_LAST_ATTRS:
        return True
    resolved = ctx.imports.resolve(func) or ""
    return resolved.rsplit(".", 1)[-1] in SYNC_FUNCS


class OverlapRegionSync:
    name = "overlap-regions"
    scope = "file"
    codes = {
        "TPM801": "sync call inside a declared overlap region (between "
                  "a prefetch and its consume point) — "
                  "re-serializes the pipeline",
    }

    def check(self, ctx: FileContext) -> Iterator[tuple]:
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from self._check_scope(ctx, node)

    def _check_scope(self, ctx: FileContext, fn) -> Iterator[tuple]:
        """Line-ordered event scan of ONE function body (nested defs get
        their own scan — their lines must not leak region state)."""
        events: list[tuple[int, str, object]] = []
        nested: set[int] = set()
        for sub in ast.walk(fn):
            if sub is not fn and isinstance(
                sub, (ast.FunctionDef, ast.AsyncFunctionDef)
            ):
                for inner in ast.walk(sub):
                    nested.add(id(inner))
        for sub in ast.walk(fn):
            if id(sub) in nested:
                continue
            if isinstance(sub, ast.Assign) and isinstance(
                sub.value, ast.Call
            ) and _is_prefetch(sub.value, ctx):
                for t in sub.targets:
                    if isinstance(t, ast.Name):
                        events.append((sub.lineno, "open", t.id))
            elif isinstance(sub, ast.Call):
                func = sub.func
                if (
                    isinstance(func, ast.Attribute)
                    and func.attr in CONSUME_ATTRS
                    and isinstance(func.value, ast.Name)
                ):
                    events.append((sub.lineno, "close", func.value.id))
                elif _is_sync(sub, ctx):
                    parts = attr_parts(func)
                    events.append(
                        (sub.lineno, "sync",
                         (sub, ".".join(parts) if parts
                         else last_attr(func) or "sync"))
                    )
        events.sort(key=lambda e: e[0])
        open_regions: dict[str, int] = {}
        for line, kind, payload in events:
            if kind == "open":
                open_regions[payload] = line
            elif kind == "close":
                open_regions.pop(payload, None)
            elif open_regions:
                call, name = payload
                handle, at = next(iter(open_regions.items()))
                yield (
                    call.lineno, call.col_offset, "TPM801",
                    f"'{name}(...)' syncs inside the overlap region "
                    f"opened by '{handle}' at line {at} — the in-flight "
                    f"comm serializes against it and overlap_frac "
                    f"silently drops to 0; move the sync after the "
                    f"handle's done()/drain(), or suppress with a "
                    f"why-comment if this sync IS the overlapped "
                    f"compute phase",
                )


class EscapedAsyncHandle:
    name = "overlap-regions-escape"
    scope = "project"
    codes = {
        "TPM802": "async dispatch handle (async_span/DispatchWindow) "
                  "returned to a caller that never consumes it — the "
                  "span stays open to process exit",
    }

    def check_project(self, proj: ProjectContext) -> Iterator[tuple]:
        idx = proj.index
        for ff in proj.facts:
            for fn in ff["functions"]:
                for name, target, line, col in fn["handle_drops"]:
                    funcs = idx.resolve_funcs(target, ff["module"])
                    if not funcs:
                        continue
                    if any(idx.returns_handle(g) for g in funcs):
                        short = target.rsplit(".", 1)[-1]
                        yield (
                            ff["path"], line, col, "TPM802",
                            f"'{name}' holds the async handle "
                            f"returned by '{short}' but is never read "
                            f"again — no one will done()/wait() it, so "
                            f"the dispatch-window span stays open to "
                            f"process exit and its op drops out of the "
                            f"overlap accounting; consume the handle "
                            f"or drain it through a DispatchWindow",
                        )
