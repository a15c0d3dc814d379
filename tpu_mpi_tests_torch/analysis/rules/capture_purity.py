"""TPM210: capture purity, the port's own TPM2xx code (after the JAX
package's TPM201 trace purity; a code of its own, since the hazard is
CUDA graph capture, not a JAX trace).

The bug class: a body captured into a CUDA graph runs its Python ONCE,
at capture; a replay runs only the recorded launches. A host wait or a
host read inside it (``torch.cuda.synchronize``, an event's or stream's
``synchronize()``, the port's ``timers.block`` / ``block_stream``,
``.item()``, ``.cpu()``, ``.tolist()``) is illegal while the stream
captures and fails the capture. A host value baked into a launch
argument is replayed as it was: ``PeerRing.next_epoch()`` (an RDMA
epoch from the host) would hand every replay the capture's epoch, a
silent race. ``time.*`` reads, ``print`` and Reporter records happen
once, at capture, and never per replay, so they fabricate or lose what
they claim to record.

A captured body is the block of a ``with torch.cuda.graph(...)``, or a
function handed as ``run`` to ``chain_rate`` (which captures it on the
card) without ``graph=False``: a def of this file named there, a
lambda, or the def a local factory called there returns. Code under an
``if`` that tests ``_under_capture()`` (or
``torch.cuda.is_current_stream_capturing()``) knows it may be captured
and is exempt.
"""

from __future__ import annotations

import ast
from typing import Iterator

from tpu_mpi_tests_torch.analysis.core import FileContext, last_attr
from tpu_mpi_tests_torch.analysis.rules import _util

TIME_FNS = {
    "time.time", "time.perf_counter", "time.monotonic",
    "time.perf_counter_ns", "time.monotonic_ns", "time.time_ns",
}
#: method spellings of a host wait or a host read
HOST_ATTRS = {"synchronize", "item", "cpu", "tolist"}
#: function spellings of a host wait (the port's timers)
HOST_FUNCS = {"block", "block_stream"}
#: Reporter record methods (instrument/report.py), on a receiver that
#: looks like a reporter (``rep``/``reporter``)
REPORTER_METHODS = {
    "line", "jsonl", "banner", "sum_line", "time_line", "test_line",
    "iter_line", "exchange_line", "time_lines",
}
GUARD_MARKERS = ("under_capture", "is_current_stream_capturing")


def _is_guard(test: ast.AST) -> bool:
    return any(
        any(m in (last_attr(n) or "") for m in GUARD_MARKERS)
        for n in ast.walk(test) if isinstance(n, (ast.Attribute, ast.Name)))


_DEF = (ast.FunctionDef, ast.AsyncFunctionDef)


def _scope_defs(scope: ast.AST) -> Iterator[ast.AST]:
    """The defs made in ``scope``'s own body (inside its loops and
    branches, not inside a nested def)."""
    stack = list(ast.iter_child_nodes(scope))
    while stack:
        n = stack.pop()
        if isinstance(n, _DEF):
            yield n
        elif not isinstance(n, (ast.Lambda, ast.ClassDef)):
            stack.extend(ast.iter_child_nodes(n))


def _resolve_def(chain: list[ast.AST], name: str, line: int):
    """The def ``name`` refers to at ``line``: the last one made before
    it in the innermost enclosing scope that makes one (``chain``, from
    the module inward)."""
    for scope in reversed(chain):
        found = [d for d in _scope_defs(scope)
                 if d.name == name and d.lineno < line]
        if found:
            return max(found, key=lambda d: d.lineno)
    return None


def _scopes(tree: ast.Module) -> Iterator[tuple[ast.AST, list[ast.AST]]]:
    """Every node with its enclosing scopes (the module, then each
    enclosing def, outermost first)."""
    stack: list[tuple[ast.AST, list[ast.AST]]] = [(tree, [tree])]
    while stack:
        node, chain = stack.pop()
        yield node, chain
        inner = chain + [node] if isinstance(node, _DEF) else chain
        stack.extend((c, inner) for c in ast.iter_child_nodes(node))


def _returned_defs(fn: ast.AST) -> list[ast.AST]:
    """The defs nested in ``fn`` that it returns by name."""
    nested = {n.name: n for n in _scope_defs(fn)}
    return [nested[r.value.id] for r in ast.walk(fn)
            if isinstance(r, ast.Return) and isinstance(r.value, ast.Name)
            and r.value.id in nested]


def _graph_off(call: ast.Call) -> bool:
    return any(k.arg == "graph" and isinstance(k.value, ast.Constant)
               and k.value.value is False for k in call.keywords)


def _run_arg(call: ast.Call) -> "ast.AST | None":
    for k in call.keywords:
        if k.arg == "run":
            return k.value
    return call.args[0] if call.args else None


class CapturePurity:
    name = "capture-purity"
    scope = "file"
    codes = {
        "TPM210": "host wait, host read, host epoch, time read, print or "
                  "Reporter record inside a body captured into a CUDA "
                  "graph (torch.cuda.graph, chain_rate's run) without an "
                  "_under_capture() guard",
    }

    def check(self, ctx: FileContext) -> Iterator[tuple]:
        seen: set[tuple[int, int]] = set()
        for body, where in self._captured(ctx):
            guards = [(n.lineno, n.end_lineno or n.lineno)
                      for n in ast.walk(body)
                      if isinstance(n, ast.If) and _is_guard(n.test)]
            for call in _util.walk_calls(body):
                if any(lo <= call.lineno <= hi for lo, hi in guards):
                    continue
                what = self._effect(ctx, call)
                key = (call.lineno, call.col_offset)
                if what and key not in seen:
                    seen.add(key)
                    yield (call.lineno, call.col_offset, "TPM210",
                           f"{what} inside {where}: a captured body's "
                           f"Python runs once, at capture, and a replay "
                           f"runs only its launches — a host wait fails "
                           f"the capture, a host value is replayed "
                           f"stale; move it out, guard it with "
                           f"_under_capture(), or pass graph=False with "
                           f"the reason")

    def _captured(self, ctx: FileContext):
        """``(node, description)`` of every captured body in the file."""
        for node, chain in _scopes(ctx.tree):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    expr = item.context_expr
                    if isinstance(expr, ast.Call) and (
                            ctx.imports.resolve(expr.func) or ""
                    ).endswith("cuda.graph"):
                        yield (ast.Module(body=node.body, type_ignores=[]),
                               f"the torch.cuda.graph block at line "
                               f"{node.lineno}")
            elif isinstance(node, ast.Call) and last_attr(
                    node.func) == "chain_rate" and not _graph_off(node):
                run = _run_arg(node)
                where = f"the run chain_rate captures at line {node.lineno}"
                if isinstance(run, ast.Lambda):
                    yield run, where
                elif isinstance(run, ast.Name):
                    d = _resolve_def(chain, run.id, node.lineno)
                    if d is not None:
                        yield d, where
                elif isinstance(run, ast.Call) and isinstance(
                        run.func, ast.Name):
                    factory = _resolve_def(chain, run.func.id, node.lineno)
                    for d in (_returned_defs(factory) if factory else ()):
                        yield d, where

    def _effect(self, ctx: FileContext, call: ast.Call) -> "str | None":
        func = call.func
        if isinstance(func, ast.Name) and func.id == "print":
            return "print(...)"
        name = last_attr(func)
        if isinstance(func, ast.Attribute):
            if name in HOST_ATTRS:
                return f"'.{name}()'"
            if name == "next_epoch":
                return "a host epoch ('.next_epoch()')"
            recv = func.value
            if (name in REPORTER_METHODS and isinstance(recv, ast.Name)
                    and recv.id in ("rep", "reporter")):
                return f"a Reporter record ('{recv.id}.{name}')"
        resolved = ctx.imports.resolve(func) or ""
        if resolved in TIME_FNS:
            return f"a host clock read ('{resolved}')"
        if resolved.rsplit(".", 1)[-1] in HOST_FUNCS:
            return f"a host wait ('{resolved.rsplit('.', 1)[-1]}')"
        if name == "next_epoch":
            return "a host epoch ('next_epoch()')"
        return None
