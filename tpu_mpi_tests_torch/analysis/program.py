"""The port's whole-program layer (≅ ``tpu_mpi_tests/analysis/program.py``).

:func:`extract_facts` distills each parsed file into a JSON-serializable
*facts* record: module-level imports (the TPM4xx graph edges), the timed
regions TPM102 judges, and one bottom-up summary per function:

* **dispatches**: the body (own scope, nested defs excluded) calls into
  torch or the port's comm/kernels layers, or a local launching callable;
* **syncs**: it calls a host-side wait (:data:`SYNC_NAMES`:
  ``torch.cuda.synchronize``, ``Event``/``Stream.synchronize``,
  ``.item()``, ``timers.block``, ``dist.barrier``, ...);
* **events**: the ordered sequence of collective calls and outgoing
  calls (the call-graph edges plus the TPM11xx comparison alphabet);
* **returns_handle**: it returns an ``async_span`` or ``DispatchWindow``
  handle (directly or through another returning helper);
* **rank_ifs**: branches guarded by rank-dependent control flow
  (``dist.get_rank()``, ``process_index()``, ``rank == 0``, truthiness
  tests like ``if not rank:``, and locals aliasing a rank call) with each
  *path's* event sequence computed over the function's control-flow
  graph (:mod:`tpu_mpi_tests_torch.analysis.cfg`): a ``return`` or
  ``raise`` inside a branch truncates that path (the TPM1101/TPM1102
  split), plus the names bound on exactly one side and their first read
  on the other path (the TPM1301 input);
* **proto**: the structured event tree the protocol layer compiles into
  schedule automata (TPM17xx, ``--conform``);

and per file the **record contract**: the JSONL record schemas its dict
literals *produce* (keyed by their constant ``kind``; fields a same-file
helper stores into the record it is handed count too) and the record
fields its functions *consume* (the TPM14xx input and the port's
``analysis.records`` table).

:class:`ProjectIndex` is the project-scope view: a module symbol table
over every linted file's facts plus memoized transitive resolution
(call-graph closure). Facts round-trip through JSON unchanged, which is
what lets the analysis cache skip parse + summary for unchanged files
while the project pass still sees the whole program.

Known limits: resolution is name-based. Dynamic dispatch, method calls
through objects, ``*args`` forwarding and handles stored into containers
are invisible to the summaries; the rules built on top are conservative
accordingly. Torch has no ``donate_argnums``, so the JAX package's
donation facts (TPM12xx) have no counterpart here, and process groups
are objects, not named mesh axes, so neither have its axis facts
(TPM5xx).

Stdlib-only by contract, like the rest of the analysis package.
"""

from __future__ import annotations

import ast
from typing import Iterator

from tpu_mpi_tests_torch.analysis import cfg as cfg_mod
from tpu_mpi_tests_torch.analysis.core import (
    FileContext,
    device_callables,
    is_device_call,
    last_attr,
    own_nodes as _own_nodes,
    stmt_lists,
    under,
    walk_calls,
)

# ---------------------------------------------------------------------------
# shared vocabularies (the sync-honesty constants live here so both the
# file-scope rule and the facts extractor read ONE definition without
# the extractor importing the rule registry)

#: clock reads that start/stop a timing region
CLOCKS = {"time.perf_counter", "time.monotonic"}

#: call targets (final component) that wait on the host for device work
#: before the clock is read again: torch's (``torch.cuda.synchronize``,
#: ``Event.synchronize``, ``Stream.synchronize``, and the reads that copy
#: a card tensor to the host: ``.item()``, ``.tolist()``, ``.cpu()``,
#: ``.numpy()``), the port's timers (``block``, ``block_stream``: an
#: event on the current stream, then its ``synchronize()``) and the
#: helpers that embed the discipline (``host_value``, ``chain_rate``,
#: ``dispatch_rate``, ``comm_span``, ``span_call``, ``timed``), and
#: ``dist.barrier``. ``wait_stream``, ``Event.wait`` and
#: ``record_stream`` order the device without waiting on the host: they
#: are not here.
SYNC_NAMES = {
    "synchronize", "item", "tolist", "cpu", "numpy",
    "block", "block_stream", "host_value", "chain_rate", "dispatch_rate",
    "comm_span", "span_call", "timed", "barrier",
}

#: the replicating collectives: they make a rank-local value the same on
#: every rank (TPM1301's allowlist, the taint killer, and the protocol
#: layer's broadcast-class events, which TPM1101's alphabet leaves out):
#: ``torch.distributed``'s ``broadcast``, ``broadcast_object_list`` and
#: ``all_gather_object``, and the port's ``tune/fleet.bcast``
BROADCAST_CALLS = {
    "bcast", "broadcast", "broadcast_object_list", "all_gather_object",
}

#: final-name vocabulary of collective calls for the TPM11xx divergence
#: alphabet: ``torch.distributed``'s collectives plus the port's comm
#: wrappers (every one of them enters an operation ALL ranks of the
#: group must enter together). The replicating ones are
#: :data:`BROADCAST_CALLS`.
COLLECTIVE_CALLS = {
    # torch.distributed
    "all_reduce", "all_gather", "all_gather_into_tensor",
    "reduce_scatter_tensor", "all_to_all_single", "barrier",
    "batch_isend_irecv",
    # comm/collectives.py
    "all_gather_inplace", "all_gather_rdma", "all_gather_oneshot",
    "allreduce_sum", "allreduce_unrecorded", "allreduce_rdma",
    "allreduce_oneshot", "reduce_scatter_sum", "reduce_sum",
    "per_rank_sums", "per_rank_err_norms", "gather_blocks",
    # comm/mesh.py (Ring.sendrecv, Mesh2Level.psum), comm/halo.py
    "sendrecv", "sendrecv_start", "psum", "halo_exchange",
    # comm/ring.py, comm/alltoall.py
    "ring_pass", "ring_attention", "ulysses_attention", "seq_to_heads",
    "heads_to_seq",
    # comm/moe.py, comm/embedding.py
    "route_tokens", "embedding_lookup", "embedding_scatter_add",
}

#: origins a resolved collective call must come from (by whole dotted
#: components): a local helper that happens to share a name resolves
#: through its own summary instead
COLLECTIVE_ORIGINS = ("torch.distributed", "tpu_mpi_tests_torch")

#: calls that mint an async dispatch handle (TPM8xx): a telemetry
#: ``async_span`` and the comm layer's ``DispatchWindow``
HANDLE_SOURCES = {"async_span", "DispatchWindow"}

#: names whose mention in an `if` test makes the branch rank-dependent
RANK_NAMES = {"rank", "proc", "proc_index", "process_index", "pidx",
              "rank_id"}
#: rank names too ambiguous for the TRUTHINESS widening: `proc` is
#: commonly a subprocess handle, and `if not self.proc:` is a liveness
#: check, not a rank test; these still match in comparisons
#: (`proc == 0`), never as bare mentions
AMBIGUOUS_RANK_NAMES = {"proc"}
#: call targets (final component) in an `if` test that read the rank:
#: ``dist.get_rank()`` and ``tune/fleet.process_index()``
RANK_CALLS = {"get_rank", "process_index"}

#: telemetry span emitters: a call to one of these with a CONSTANT first
#: argument is a statically-known runtime ``(op, axis)`` event, the
#: alphabet ``kind:"span"`` records carry, so the protocol layer derives
#: its schedule automaton from the emitters themselves. A dynamic first
#: argument (``self.op``, f-strings) is recorded with ``op=None``: a span
#: whose name the static model cannot know.
SPAN_EMITTERS = {"comm_span", "span_call", "async_span"}

#: the package whose span emitters and collectives the facts trust
PORT_PKG = "tpu_mpi_tests_torch"

# summary-expansion recursion bound, not a device schedule knob — there
# is nothing to tune and no topology it varies with
_MAX_DEPTH = 16  # tpumt: ignore[TPM701]


# ---------------------------------------------------------------------------
# small walkers


def _walk_functions_cls(
    tree: ast.Module,
) -> list[tuple[str, ast.AST, str]]:
    """``(qualname, node, enclosing_class_qual)`` for every def, in
    document order — nested defs and methods get dotted qualnames
    (``outer.inner``, ``Cls.meth``); the class qual is ``""`` for
    plain/nested functions (the lockset layer needs to know which
    ``self`` an access belongs to)."""
    out: list[tuple[str, ast.AST, str]] = []

    def visit(node: ast.AST, prefix: str, cls: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{prefix}{child.name}"
                out.append((q, child, cls))
                visit(child, q + ".", "")
            elif isinstance(child, ast.ClassDef):
                visit(child, f"{prefix}{child.name}.",
                      f"{prefix}{child.name}")
            else:
                visit(child, prefix, cls)

    visit(tree, "", "")
    return out


def _walk_functions(
    tree: ast.Module,
) -> list[tuple[str, ast.AST]]:
    """``(qualname, node)`` for every def, in document order."""
    return [(q, n) for q, n, _cls in _walk_functions_cls(tree)]


def canon_target(ctx: FileContext, func: ast.AST) -> str | None:
    """Canonical dotted target of a call: import origins substituted and
    relative imports resolved against the file's module, so the project
    index can look the name up. None for non-name-rooted calls."""
    resolved = ctx.imports.resolve(func)
    if not resolved:
        return None
    if resolved.startswith("."):
        resolved = _resolve_relative(
            resolved, ctx.module, ctx.path.endswith("__init__.py")
        )
    return resolved


def _is_collective(canon: str | None, last: str | None) -> bool:
    if not canon or last not in COLLECTIVE_CALLS:
        return False
    return under(canon, COLLECTIVE_ORIGINS)


def _is_broadcast(canon: str | None, last: str | None) -> bool:
    return bool(canon) and last in BROADCAST_CALLS \
        and under(canon, COLLECTIVE_ORIGINS)


# ---------------------------------------------------------------------------
# module-level imports (the TPM4xx graph edges; hoisted from
# rules/import_hygiene so facts extraction owns the single definition)


def _resolve_relative(module: str, current: str, is_pkg: bool) -> str:
    """``.foo``/``..foo`` against the importing module's package."""
    level = len(module) - len(module.lstrip("."))
    name = module[level:]
    parts = current.split(".") if current else []
    if not is_pkg:
        parts = parts[:-1]
    if level > 1:
        parts = parts[: len(parts) - (level - 1)]
    return ".".join(parts + ([name] if name else []))


def _catches_import_error(stmt: ast.Try) -> bool:
    for h in stmt.handlers:
        if h.type is None:
            return True  # bare except
        types = h.type.elts if isinstance(h.type, ast.Tuple) else [h.type]
        for t in types:
            name = getattr(t, "id", None) or getattr(t, "attr", None)
            if name in ("ImportError", "ModuleNotFoundError",
                        "Exception", "BaseException"):
                return True
    return False


def module_level_imports(
    ctx: FileContext,
) -> list[list]:
    """``[line, module, from_names]`` for every import executed at module
    import time: top-level statements plus those nested in module-level
    ``if``/``try`` (conditional imports still run), but nothing inside a
    function or class body (lazy by construction), nothing under an
    ``if TYPE_CHECKING:`` guard (never runs), and nothing in a
    ``try: ... except ImportError:`` body (the canonical safe optional
    import — handler bodies are still scanned)."""
    out: list[list] = []
    is_pkg = ctx.path.endswith("__init__.py")

    def scan(stmts):
        for stmt in stmts:
            if isinstance(stmt, ast.Import):
                for a in stmt.names:
                    out.append([stmt.lineno, a.name, []])
            elif isinstance(stmt, ast.ImportFrom):
                mod = ("." * stmt.level) + (stmt.module or "")
                if mod.startswith("."):
                    mod = _resolve_relative(mod, ctx.module, is_pkg)
                out.append([stmt.lineno, mod,
                            [a.name for a in stmt.names]])
            elif isinstance(stmt, ast.If):
                if any(
                    isinstance(n, (ast.Name, ast.Attribute))
                    and (getattr(n, "id", None) == "TYPE_CHECKING"
                         or getattr(n, "attr", None) == "TYPE_CHECKING")
                    for n in ast.walk(stmt.test)
                ):
                    continue
                scan(stmt.body)
                scan(stmt.orelse)
            elif isinstance(stmt, ast.Try):
                if not _catches_import_error(stmt):
                    scan(stmt.body)
                scan(stmt.orelse)
                scan(stmt.finalbody)
                for h in stmt.handlers:
                    scan(h.body)
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                scan(stmt.body)

    scan(ctx.tree.body)
    return out


# ---------------------------------------------------------------------------
# timed regions (the TPM1xx detector, shared with rules/sync_honesty)


def _clock_assign(ctx: FileContext, stmt: ast.stmt) -> str | None:
    """``t0 = time.perf_counter()`` → ``"t0"``; else None."""
    if not (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
            and isinstance(stmt.targets[0], ast.Name)
            and isinstance(stmt.value, ast.Call)):
        return None
    if ctx.imports.resolve(stmt.value.func) in CLOCKS:
        return stmt.targets[0].id
    return None


def _uses_in_sub(stmt: ast.stmt, name: str) -> bool:
    """Does the statement read the clock delta (``... - t0``)?"""
    for n in ast.walk(stmt):
        if isinstance(n, ast.BinOp) and isinstance(n.op, ast.Sub):
            for side in (n.left, n.right):
                if isinstance(side, ast.Name) and side.id == name:
                    return True
    return False


def _rebinds(stmt: ast.stmt, name: str) -> bool:
    if isinstance(stmt, ast.Assign):
        return any(isinstance(t, ast.Name) and t.id == name
                   for t in stmt.targets)
    return False


def iter_timed_regions(ctx: FileContext) -> Iterator[list[ast.stmt]]:
    """Every clock-pair region in the file: the statements between a
    ``t0 = perf_counter()`` assignment and the first read of its delta
    (``... - t0``), inclusive. A rebind of the clock name before any
    delta read abandons the region (clock restarted)."""
    for stmts in stmt_lists(ctx.tree):
        for i, stmt in enumerate(stmts):
            t = _clock_assign(ctx, stmt)
            if not t:
                continue
            region: list[ast.stmt] = []
            for j in range(i + 1, len(stmts)):
                region.append(stmts[j])
                if _uses_in_sub(stmts[j], t):
                    yield region
                    break
                if _rebinds(stmts[j], t):
                    break  # clock restarted before any delta read


# ---------------------------------------------------------------------------
# facts extraction


def _rank_dependent(test: ast.AST,
                    extra_names: frozenset | set = frozenset()) -> bool:
    """Is this `if` test a function of the process rank? Conservative:
    a ``process_index()`` call anywhere in it, a comparison whose side
    is a rank-named variable/attribute (``rank == 0``,
    ``topo.process_index != 0``), or a bare truthiness mention
    (``if not rank:``, ``if rank:``) of an UNAMBIGUOUS rank name. The
    lexical engine only matched Compare sides, which is how
    ``if not rank:`` shipped as a documented TPM1101 false negative;
    the ambiguous names (``proc`` — usually a subprocess handle) keep
    the comparison-only behavior so liveness checks don't convict.
    ``extra_names`` carries the function's local ``process_index()``
    aliases."""
    cmp_names = RANK_NAMES | set(extra_names)
    truthy_names = cmp_names - AMBIGUOUS_RANK_NAMES
    for n in ast.walk(test):
        if isinstance(n, ast.Call):
            if (last_attr(n.func) or "") in RANK_CALLS:
                return True
        elif isinstance(n, ast.Compare):
            for side in [n.left] + list(n.comparators):
                name = None
                if isinstance(side, ast.Name):
                    name = side.id
                elif isinstance(side, ast.Attribute):
                    name = side.attr
                if name in cmp_names:
                    return True
        elif isinstance(n, ast.Name):
            if n.id in truthy_names and isinstance(n.ctx, ast.Load):
                return True
        elif isinstance(n, ast.Attribute):
            if n.attr in truthy_names:
                return True
    return False


def _rank_aliases(node: ast.AST) -> set[str]:
    """Local names that hold the process rank: assigned from a
    ``get_rank()``-class call (``r = dist.get_rank()``, the
    walrus form included) or pure aliases of a rank name (``r = rank``).
    Document-order scan, so alias chains resolve."""
    out: set[str] = set()

    def value_is_rank(v: ast.AST) -> bool:
        # DIRECT forms only: `r = rank`, `r = topo.process_index`,
        # `r = dist.get_rank()`. A rank call merely nested in the
        # value (`rep = Reporter(proc_index=process_index())`) must NOT
        # taint the whole assigned object as a rank.
        if isinstance(v, ast.Name):
            return v.id in RANK_NAMES or v.id in out
        if isinstance(v, ast.Attribute):
            return v.attr in RANK_NAMES
        if isinstance(v, ast.Call):
            return (last_attr(v.func) or "") in RANK_CALLS
        return False

    for n in _own_nodes(node):
        if isinstance(n, ast.Assign) and value_is_rank(n.value):
            out.update(t.id for t in n.targets
                       if isinstance(t, ast.Name))
        elif isinstance(n, ast.AnnAssign) and n.value is not None \
                and isinstance(n.target, ast.Name) \
                and value_is_rank(n.value):
            out.add(n.target.id)
        elif isinstance(n, ast.NamedExpr) and value_is_rank(n.value):
            if isinstance(n.target, ast.Name):
                out.add(n.target.id)
    return out


def _unit_nodes(unit: ast.AST) -> Iterator[ast.AST]:
    """The unit (a simple statement or a test/iter expression) plus its
    own-scope subtree."""
    yield unit
    yield from _own_nodes(unit)


# ---------------------------------------------------------------------------
# protocol facts: the structured event tree the schedule
# automaton and the TPM17xx checks are compiled from


def _const_str(node: ast.AST | None) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _taint_sources(ctx: FileContext, node: ast.AST) -> dict[str, str]:
    """Local name → canonical call target it was assigned from — the
    return-value taint channel (``mode = pick_mode()`` where
    ``pick_mode`` turns out to be rank-returning assembles a
    rank-divergent branch no lexical rank test reveals). A name EVER
    rebound from a broadcast-class call is dropped entirely: the sweep's
    ``go = fleet.bcast(go, ...)`` replication is exactly what makes the
    value rank-invariant again."""
    out: dict[str, str] = {}
    killed: set[str] = set()
    for n in _own_nodes(node):
        if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call):
            canon = canon_target(ctx, n.value.func)
            last = last_attr(n.value.func) or ""
            for t in n.targets:
                if not isinstance(t, ast.Name):
                    continue
                if last in BROADCAST_CALLS:
                    killed.add(t.id)
                elif canon:
                    out[t.id] = canon
    for name in killed:
        out.pop(name, None)
    return out


def _test_taints(ctx: FileContext, expr: ast.AST,
                 sources: dict[str, str]) -> list[str]:
    """Canonical targets whose return value feeds this test: calls made
    inside it plus the assigned-from targets of names it reads. Judged
    rank-returning (or not) at project time, where the callee summaries
    exist."""
    canons: set[str] = set()
    for n in _unit_nodes(expr):
        if isinstance(n, ast.Call):
            c = canon_target(ctx, n.func)
            if c:
                canons.add(c)
        elif isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load):
            c = sources.get(n.id)
            if c:
                canons.add(c)
    return sorted(canons)[:8]


def _returns_rank(node: ast.AST, aliases: set[str]) -> bool:
    """Does the function return the process rank? DIRECT forms only
    (mirrors ``_rank_aliases``): ``return rank``, ``return self.rank``,
    ``return dist.get_rank()``. A rank merely nested in a returned
    constructor call does not make the whole object a rank."""
    names = RANK_NAMES | aliases
    for n in _own_nodes(node):
        if not isinstance(n, ast.Return) or n.value is None:
            continue
        v = n.value
        if isinstance(v, ast.Name) and v.id in names:
            return True
        if isinstance(v, ast.Attribute) and v.attr in RANK_NAMES:
            return True
        if isinstance(v, ast.Call) and (last_attr(v.func) or "") \
                in RANK_CALLS:
            return True
    return False


def _terminates(stmts: list[ast.stmt]) -> bool:
    """Does this straight-line statement list always leave the enclosing
    block (return/raise/break/continue on every path)? Conservative:
    only the shapes that matter for branch-summary truncation."""
    for s in stmts:
        if isinstance(s, (ast.Return, ast.Raise, ast.Break,
                          ast.Continue)):
            return True
        if isinstance(s, ast.If) and s.orelse and _terminates(s.body) \
                and _terminates(s.orelse):
            return True
        if isinstance(s, (ast.With, ast.AsyncWith)) \
                and _terminates(s.body):
            return True
    return False


def _proto_tree(ctx: FileContext, node: ast.AST, aliases: set[str],
                sources: dict[str, str]) -> list:
    """The function body as a structured event tree — the
    ``proto`` fact. Node shapes (JSON lists, cache-stable):

    * ``["coll", op, canon, line, core]`` — a lexical collective call
      (``core`` 1 for the TPM11xx alphabet, 0 for broadcast-class
      replication points, which TPM1101 deliberately cannot see);
    * ``["span", op|None, axis|None, line]`` — a telemetry span
      emitter: the runtime event a ``kind:"span"`` record witnesses
      (``op None`` = dynamically named);
    * ``["call", canon, line]`` — a resolvable outgoing call;
    * ``["loop", line, rank, taints, body]`` — ``for``/``while`` with
      the bound's rank-dependence (lexical bit + taint candidates);
    * ``["alt", line, col, rank, taints, then, orelse]`` — a branch;
    * ``["try", line, body, [[terminates, handler_body], ...]]``;
    * ``["exit", line]`` — return/raise/break/continue.
    """

    def classify(call: ast.Call) -> list | None:
        last = last_attr(call.func)
        canon = canon_target(ctx, call.func) or ""
        if last in SPAN_EMITTERS and under(canon, (PORT_PKG,)):
            axis = None
            for kw in call.keywords:
                if kw.arg == "axis_name":
                    axis = _const_str(kw.value)
            op = _const_str(call.args[0]) if call.args else None
            return ["span", op, axis, call.lineno]
        if last == "call" and len(call.args) >= 2 \
                and _const_str(call.args[0]) is not None:
            # DispatchWindow.call(op, fn, *args): dispatch + drain emit
            # spans under that constant op name
            return ["span", _const_str(call.args[0]), None, call.lineno]
        if _is_collective(canon, last):
            return ["coll", last, canon, call.lineno, 1]
        if _is_broadcast(canon, last):
            return ["coll", last, canon, call.lineno, 0]
        if canon:
            return ["call", canon, call.lineno]
        return None

    def expr_events(expr: ast.AST | None) -> list:
        if expr is None:
            return []
        out = []
        for n in _unit_nodes(expr):
            if isinstance(n, ast.Call):
                ev = classify(n)
                if ev is not None:
                    out.append(ev)
        return out

    def loop_node(s, bound: ast.AST, body: list[ast.stmt]) -> list:
        rk = 1 if _rank_dependent(bound, aliases) else 0
        taints = [] if rk else _test_taints(ctx, bound, sources)
        return ["loop", s.lineno, rk, taints, walk(body)]

    def walk(stmts: list[ast.stmt]) -> list:
        out: list = []
        for s in stmts:
            if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
                continue
            if isinstance(s, ast.If):
                out.extend(expr_events(s.test))
                rk = 1 if _rank_dependent(s.test, aliases) else 0
                taints = [] if rk else _test_taints(ctx, s.test, sources)
                out.append(["alt", s.lineno, s.col_offset, rk, taints,
                            walk(s.body), walk(s.orelse)])
            elif isinstance(s, (ast.For, ast.AsyncFor)):
                out.extend(expr_events(s.iter))
                out.append(loop_node(s, s.iter, s.body))
                out.extend(walk(s.orelse))
            elif isinstance(s, ast.While):
                out.extend(expr_events(s.test))
                out.append(loop_node(s, s.test, s.body))
                out.extend(walk(s.orelse))
            elif isinstance(s, (ast.With, ast.AsyncWith)):
                for item in s.items:
                    out.extend(expr_events(item.context_expr))
                out.extend(walk(s.body))
            elif isinstance(s, ast.Try):
                body = walk(s.body) + walk(s.orelse)
                handlers = [
                    [1 if _terminates(h.body) else 0, walk(h.body)]
                    for h in s.handlers
                ]
                out.append(["try", s.lineno, body, handlers])
                out.extend(walk(s.finalbody))
            elif isinstance(s, (ast.Return, ast.Raise)):
                out.extend(expr_events(getattr(s, "value", None)
                                       or getattr(s, "exc", None)))
                out.append(["exit", s.lineno])
            elif isinstance(s, (ast.Break, ast.Continue)):
                out.append(["exit", s.lineno])
            else:
                out.extend(expr_events(s))
        return out

    return walk(list(getattr(node, "body", [])))


def _path_events(ctx: FileContext, graph: cfg_mod.CFG,
                 entry: cfg_mod.Block) -> list:
    """Ordered ``["coll", op]`` / ``["call", target]`` events along the
    forward paths from ``entry`` to the function exit (loops unrolled
    once). Unlike the old lexical branch events, a path that ``return``s
    early simply does not contain the events after the join."""
    ev: list = []
    for block in graph.reachable(entry):
        for unit in block.units:
            for n in _unit_nodes(unit):
                if not isinstance(n, ast.Call):
                    continue
                canon = canon_target(ctx, n.func)
                last = last_attr(n.func)
                if _is_collective(canon, last):
                    ev.append(["coll", last])
                elif canon:
                    ev.append(["call", canon])
    return ev


def _real_bound(stmts: list[ast.stmt]) -> set[str]:
    """Names meaningfully bound in a branch body (own scope): every
    Store target except pure ``= None`` placeholders — ``winner = None``
    on the unguarded side is the *absence* of a value, which is exactly
    what TPM1301 needs to see through. Per STORE SITE, not per name: a
    name that is None-initialized and then really bound in the same
    branch (``winner = None`` … ``winner = fallback()``) is bound."""
    none_targets: set[int] = set()
    real: set[str] = set()
    for s in stmts:
        for n in _unit_nodes(s):
            if isinstance(n, ast.Assign) and isinstance(
                n.value, ast.Constant
            ) and n.value.value is None:
                none_targets.update(
                    id(t) for t in n.targets
                    if isinstance(t, ast.Name)
                )
            elif isinstance(n, ast.AnnAssign) and isinstance(
                n.value, ast.Constant
            ) and n.value.value is None and isinstance(
                n.target, ast.Name
            ):
                # `winner: T = None` — the annotated placeholder form
                none_targets.add(id(n.target))
    for s in stmts:
        for n in _unit_nodes(s):
            if isinstance(n, ast.Name) and isinstance(
                n.ctx, ast.Store
            ) and id(n) not in none_targets:
                real.add(n.id)
    return real


def _first_reads(graph: cfg_mod.CFG, entry: cfg_mod.Block,
                 names: set[str],
                 exclude: set[int] = frozenset()) -> list[list]:
    """First Load of each name along the forward paths from ``entry``:
    ``[name, line, col, enclosing_call]`` where ``enclosing_call`` is
    the final attr of the call the name is a DIRECT argument of (the
    broadcast-allowlist witness), or None. Blocks in ``exclude`` (the
    exclusive regions of OTHER rank guards — a read there only runs on
    some ranks, usually the same rank-0 that bound the value) are not
    scanned. A rebind of the name ON THE SCANNED PATH before any read
    (``plan = load_cached(...)`` on every rank) kills the one-sided
    value — reads after it see the rebound value and are safe."""
    out: dict[str, list] = {}
    dead: set[str] = set()
    for block in graph.reachable(entry):
        if block.idx in exclude:
            continue
        for unit in block.units:
            callmap: dict[int, str | None] = {}
            for n in _unit_nodes(unit):
                if not isinstance(n, ast.Call):
                    continue
                target = last_attr(n.func)
                for a in list(n.args) + [
                    kw.value for kw in n.keywords
                ]:
                    if isinstance(a, ast.Name):
                        callmap[id(a)] = target
            # loads first (an RHS read in `plan = f(plan)` happens
            # before the rebind), then stores kill the name — except
            # `= None` placeholder stores (the unguarded arm's
            # `winner = None` is the absence the rule exists to see)
            none_ids: set[int] = set()
            aug_ids: set[int] = set()
            for n in _unit_nodes(unit):
                if isinstance(n, ast.Assign) and isinstance(
                    n.value, ast.Constant
                ) and n.value.value is None:
                    none_ids.update(id(t) for t in n.targets)
                elif isinstance(n, ast.AnnAssign) and isinstance(
                    n.value, ast.Constant
                ) and n.value.value is None:
                    none_ids.add(id(n.target))
                elif isinstance(n, ast.AugAssign):
                    # `w += 1` READS the old value (its target has
                    # Store ctx only): a read site, never a kill
                    aug_ids.add(id(n.target))
            for n in _unit_nodes(unit):
                is_aug_read = id(n) in aug_ids
                if isinstance(n, ast.Name) and (
                    isinstance(n.ctx, ast.Load) or is_aug_read
                ) and n.id in names and n.id not in out \
                        and n.id not in dead:
                    out[n.id] = [n.id, n.lineno, n.col_offset,
                                 callmap.get(id(n))]
            for n in _unit_nodes(unit):
                if isinstance(n, ast.Name) and isinstance(
                    n.ctx, ast.Store
                ) and n.id in names and id(n) not in none_ids \
                        and id(n) not in aug_ids:
                    dead.add(n.id)
    return sorted(out.values())


def _rank_if_facts(ctx: FileContext, node: ast.AST,
                   graph: cfg_mod.CFG | None = None) -> list[dict]:
    """Every rank-dependent ``if`` in the function as a flow-sensitive
    fact: path-to-exit event sequences, early-exit bits, and the
    one-side-bound names with their first unguarded-path read."""
    aliases = _rank_aliases(node)
    if graph is None:
        graph = cfg_mod.build(node)
    # pre-branch stores, with the `= None` placeholder filter applied
    # per site (a `winner = None` BEFORE the rank guard is the same
    # absence-of-a-value as one in the else arm)
    none_targets: set[int] = set()
    for n in _own_nodes(node):
        if isinstance(n, ast.Assign) and isinstance(
            n.value, ast.Constant
        ) and n.value.value is None:
            none_targets.update(id(t) for t in n.targets)
        elif isinstance(n, ast.AnnAssign) and isinstance(
            n.value, ast.Constant
        ) and n.value.value is None:
            none_targets.add(id(n.target))
    before_lines: list[tuple[int, str]] = [
        (n.lineno, n.id) for n in _own_nodes(node)
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store)
        and id(n) not in none_targets
    ]
    # every-rank bindings that exist before any branch runs: ALL
    # parameter kinds (a kwonly/vararg/kwarg refreshed under a rank
    # guard is still bound everywhere) and imported names (a module
    # alias monkeypatched on rank 0 exists on every rank regardless)
    a = node.args
    always_bound = {p.arg for p in (a.posonlyargs + a.args
                                    + a.kwonlyargs)}
    for va in (a.vararg, a.kwarg):
        if va is not None:
            always_bound.add(va.arg)
    always_bound |= set(ctx.imports.modules) | set(ctx.imports.names)
    rank_branches = [
        br for br in graph.branches
        if _rank_dependent(br.node.test, aliases)
    ]
    # blocks exclusively inside SOME rank guard: a read there executes
    # only on the ranks that take that guard — reading a rank-0-bound
    # value under another rank-0 test is the idiomatic rank-0-only
    # reporter shape, not a divergence (conservative: a mismatched
    # guard rank is a false negative, never a false positive)
    gated_per_branch: dict[int, set[int]] = {}
    gated_all: set[int] = set()
    for br in rank_branches:
        rt = {b.idx for b in graph.reachable(br.then_entry)}
        re_ = {b.idx for b in graph.reachable(br.else_entry)}
        exc = (rt - re_) | (re_ - rt)
        gated_per_branch[id(br)] = exc
        gated_all |= exc

    out: list[dict] = []
    for br in rank_branches:
        s = br.node
        bound_then = _real_bound(s.body)
        bound_else = _real_bound(s.orelse)
        bound_before = set(always_bound) | {
            name for line, name in before_lines if line < s.lineno
        }
        only_then = bound_then - bound_else - bound_before
        only_else = bound_else - bound_then - bound_before
        other_gated = gated_all - gated_per_branch[id(br)]
        unbcast: list[list] = []
        if only_then:
            unbcast.extend(
                _first_reads(graph, br.else_entry, only_then,
                             exclude=other_gated)
            )
        if only_else:
            unbcast.extend(
                _first_reads(graph, br.then_entry, only_else,
                             exclude=other_gated)
            )
        out.append({
            "line": s.lineno, "col": s.col_offset,
            "then": _path_events(ctx, graph, br.then_entry),
            "orelse": _path_events(ctx, graph, br.else_entry),
            "then_exits": br.then_exits,
            "else_exits": br.else_exits,
            "unbcast": sorted(unbcast),
        })
    return out


def _function_facts(ctx: FileContext, qual: str, node: ast.AST,
                    local_device: set[str],
                    graph: cfg_mod.CFG | None = None) -> dict:
    params = [a.arg for a in (node.args.posonlyargs + node.args.args)]
    aliases = _rank_aliases(node)
    dispatches = syncs = returns_handle = False
    events: list = []
    return_targets: list[str] = []
    handle_names: set[str] = set()
    assigned_calls: list[list] = []
    loads = {
        n.id for n in ast.walk(node)
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)
    }

    for n in _own_nodes(node):
        if isinstance(n, ast.Call):
            canon = canon_target(ctx, n.func)
            last = last_attr(n.func)
            if last in SYNC_NAMES:
                syncs = True
            if is_device_call(ctx, n, local_device):
                dispatches = True
            if _is_collective(canon, last):
                events.append(["coll", last])
            elif canon:
                events.append(["call", canon])
        elif isinstance(n, ast.Assign) and isinstance(n.value, ast.Call):
            canon = canon_target(ctx, n.value.func)
            tnames = [t.id for t in n.targets if isinstance(t, ast.Name)]
            if not canon:
                continue
            if canon.rsplit(".", 1)[-1] in HANDLE_SOURCES:
                handle_names.update(tnames)
            else:
                for t in tnames:
                    assigned_calls.append(
                        [t, canon, n.lineno, n.col_offset]
                    )
        elif isinstance(n, ast.Return) and n.value is not None:
            v = n.value
            if isinstance(v, ast.Call):
                canon = canon_target(ctx, v.func)
                if canon and canon.rsplit(".", 1)[-1] in HANDLE_SOURCES:
                    returns_handle = True
                elif canon:
                    return_targets.append(canon)
            elif isinstance(v, ast.Name) and v.id in handle_names:
                returns_handle = True

    return {
        "name": qual,
        "line": node.lineno,
        "params": params,
        "dispatches": dispatches,
        "syncs": syncs,
        "events": events,
        "returns_handle": returns_handle,
        "return_targets": return_targets,
        "rank_ifs": _rank_if_facts(ctx, node, graph),
        # unconsumed call-result handles: assigned, then never read —
        # the TPM802 candidates (a name loaded ANYWHERE in the def,
        # nested closures included, counts as consumed)
        "handle_drops": [a for a in assigned_calls if a[0] not in loads],
        # the structured event tree (loops, branches, try
        # blocks, span emitters) the protocol layer compiles into the
        # schedule automaton, plus the return-value rank taint bit
        "proto": _proto_tree(ctx, node, aliases,
                             _taint_sources(ctx, node)),
        "rank_ret": _returns_rank(node, aliases),
    }


def _timed_region_facts(ctx: FileContext,
                        local_device: set[str]) -> list[dict]:
    """Regions TPM101 cannot judge alone: no sync, no DIRECT dispatch —
    but outgoing calls whose summaries may dispatch (TPM102's input)."""
    out: list[dict] = []
    for region in iter_timed_regions(ctx):
        calls: list[list] = []
        has_sync = has_direct = False
        for stmt in region:
            for call in walk_calls(stmt):
                if last_attr(call.func) in SYNC_NAMES:
                    has_sync = True
                    break
                if is_device_call(ctx, call, local_device):
                    has_direct = True
                    continue
                canon = canon_target(ctx, call.func)
                if canon:
                    calls.append([canon, call.lineno, call.col_offset])
            if has_sync:
                break
        if not has_sync and not has_direct and calls:
            out.append({"calls": calls})
    return out


# ---------------------------------------------------------------------------
# record-contract facts (TPM14xx / the records table)


#: sink chokepoints a record dict flows through verbatim — the
#: Reporter's JSONL writer and the telemetry registry's raw emit
SINK_CALLS = {"jsonl", "emit"}


def _record_producer_facts(
    ctx: FileContext,
) -> tuple[list[list], list[list]]:
    """``(schemas, stamps)`` — every JSONL record schema the file
    produces plus the envelope fields its sink wrappers stamp on.

    A *schema* is a dict literal / ``dict(...)`` call carrying a
    constant-string ``kind``, as ``[kind, event, fields, open, line]``.
    Fields include constant subscript stores on the name the dict was
    assigned to (``rec["phase"] = ...`` — the memwatch build-up idiom).
    ``open`` marks schemas with dynamic parts — a ``**spread``, a
    non-constant key/subscript, or a later ``.update()`` on the name
    (the ``CommEvent.record`` meta idiom) — which the field check must
    not judge.

    A *stamp* is ``[fields, line]`` from a dict literal that has a
    ``**spread`` but NO ``kind`` of its own and is passed directly into
    a ``jsonl``/``emit`` sink call — the
    ``rep.jsonl({**rec, "rank": rep.proc_index})`` envelope idiom:
    every record flowing through the wrapper gains those fields, so
    they are available on every kind.

    The name-linked idioms (build-up stores, ``.update()``) resolve
    PER SCOPE — module level, or one function's own nodes: two
    functions both calling their local record ``rec`` must not bleed
    fields or open-ness into each other's kinds.

    A record handed to a same-file helper by a bare call
    (``_device_fields(rec, devices)``, the memwatch idiom) gains the
    constant subscript stores the helper makes on that parameter; a
    dynamic store there opens the schema."""
    schemas: list[list] = []
    stamps: list[list] = []
    functions = _walk_functions(ctx.tree)
    helpers = _helper_stores(functions)
    scopes = [list(_own_nodes(ctx.tree))] + [
        list(_own_nodes(fn)) for _qual, fn in functions
    ]
    for nodes in scopes:
        s, st = _scope_producer_facts(nodes, helpers)
        schemas.extend(s)
        stamps.extend(st)
    schemas.sort(key=lambda r: (r[0], r[1] or "", r[4]))
    stamps.sort(key=lambda r: r[1])
    return schemas, stamps


def _helper_stores(
    functions: list[tuple[str, ast.AST]],
) -> dict[str, dict[int, tuple[set[str], bool]]]:
    """Top-level function name → positional parameter index →
    ``(constant fields stored into it, any dynamic store)``, for the
    functions that store subscripts into a parameter."""
    out: dict[str, dict[int, tuple[set[str], bool]]] = {}
    for qual, fn in functions:
        if "." in qual:
            continue
        params = {a.arg: i for i, a in enumerate(
            fn.args.posonlyargs + fn.args.args)}
        per: dict[int, tuple[set[str], bool]] = {}
        for n in _own_nodes(fn):
            if not (isinstance(n, ast.Subscript)
                    and isinstance(n.ctx, ast.Store)
                    and isinstance(n.value, ast.Name)
                    and n.value.id in params):
                continue
            fields, dyn = per.setdefault(params[n.value.id], (set(), False))
            if isinstance(n.slice, ast.Constant) and isinstance(
                n.slice.value, str
            ):
                fields.add(n.slice.value)
            else:
                per[params[n.value.id]] = (fields, True)
        if per:
            out[qual] = per
    return out


def _scope_producer_facts(
    nodes: list[ast.AST],
    helpers: dict[str, dict[int, tuple[set[str], bool]]] | None = None,
) -> tuple[list[list], list[list]]:
    updated: set[str] = set()
    sub_stores: dict[str, set[str]] = {}
    dyn_stores: set[str] = set()
    dict_targets: dict[int, list[str]] = {}
    sink_args: set[int] = set()
    for n in nodes:
        if isinstance(n, ast.Call):
            if isinstance(n.func, ast.Name) and n.func.id in (helpers
                                                              or {}):
                for i, a in enumerate(n.args):
                    stored = helpers[n.func.id].get(i)
                    if stored is None or not isinstance(a, ast.Name):
                        continue
                    sub_stores.setdefault(a.id, set()).update(stored[0])
                    if stored[1]:
                        dyn_stores.add(a.id)
            if isinstance(n.func, ast.Attribute) \
                    and n.func.attr == "update" \
                    and isinstance(n.func.value, ast.Name):
                updated.add(n.func.value.id)
            if (last_attr(n.func) or "") in SINK_CALLS:
                sink_args.update(id(a) for a in n.args)
        elif isinstance(n, ast.Assign) and isinstance(
            n.value, ast.Dict
        ):
            dict_targets[id(n.value)] = [
                t.id for t in n.targets if isinstance(t, ast.Name)
            ]
        elif isinstance(n, ast.AnnAssign) and isinstance(
            n.value, ast.Dict
        ) and isinstance(n.target, ast.Name):
            # `rec: dict[str, Any] = {...}` — the annotated form of
            # the same build-up idiom
            dict_targets[id(n.value)] = [n.target.id]
        elif isinstance(n, ast.Subscript) and isinstance(
            n.ctx, ast.Store
        ) and isinstance(n.value, ast.Name):
            if isinstance(n.slice, ast.Constant) and isinstance(
                n.slice.value, str
            ):
                sub_stores.setdefault(n.value.id, set()).add(
                    n.slice.value
                )
            else:
                dyn_stores.add(n.value.id)

    schemas: list[list] = []
    stamps: list[list] = []
    for n in nodes:
        kind = event = None
        fields: set[str] = set()
        open_ = has_spread = False
        if isinstance(n, ast.Dict):
            for k, v in zip(n.keys, n.values):
                if k is None:  # **spread
                    open_ = has_spread = True
                    continue
                if not (isinstance(k, ast.Constant)
                        and isinstance(k.value, str)):
                    open_ = True
                    continue
                fields.add(k.value)
                if isinstance(v, ast.Constant) and isinstance(
                    v.value, str
                ):
                    if k.value == "kind":
                        kind = v.value
                    elif k.value == "event":
                        event = v.value
            for t in dict_targets.get(id(n), ()):
                fields.update(sub_stores.get(t, ()))
                if t in updated or t in dyn_stores:
                    open_ = True
        elif isinstance(n, ast.Call) and last_attr(n.func) == "dict":
            for kw in n.keywords:
                if kw.arg is None:  # **spread
                    open_ = has_spread = True
                    continue
                fields.add(kw.arg)
                if isinstance(kw.value, ast.Constant) and isinstance(
                    kw.value.value, str
                ):
                    if kw.arg == "kind":
                        kind = kw.value.value
                    elif kw.arg == "event":
                        event = kw.value.value
        else:
            continue
        if kind is not None:
            schemas.append([kind, event, sorted(fields - {"kind"}),
                            open_, n.lineno])
        elif has_spread and "kind" not in fields and fields \
                and id(n) in sink_args:
            stamps.append([sorted(fields), n.lineno])
    return schemas, stamps


def _kind_access_var(n: ast.AST) -> str | None:
    """``X.get("kind")`` / ``X["kind"]`` → ``"X"``; else None."""
    if isinstance(n, ast.Call) and isinstance(
        n.func, ast.Attribute
    ) and n.func.attr == "get" and isinstance(
        n.func.value, ast.Name
    ) and n.args and isinstance(n.args[0], ast.Constant) \
            and n.args[0].value == "kind":
        return n.func.value.id
    if isinstance(n, ast.Subscript) and isinstance(
        n.value, ast.Name
    ) and isinstance(n.slice, ast.Constant) \
            and n.slice.value == "kind":
        return n.value.id
    return None


_KIND_CMP_OPS = (ast.Eq, ast.NotEq, ast.In, ast.NotIn)


def _field_access(n: ast.AST) -> tuple[str, str] | None:
    """``X.get("field", ...)`` / ``X["field"]`` (Load) →
    ``(var, field)``; else None."""
    if isinstance(n, ast.Call) and isinstance(
        n.func, ast.Attribute
    ) and n.func.attr == "get" and isinstance(
        n.func.value, ast.Name
    ) and n.args and isinstance(n.args[0], ast.Constant) \
            and isinstance(n.args[0].value, str):
        return n.func.value.id, n.args[0].value
    if isinstance(n, ast.Subscript) and isinstance(
        n.value, ast.Name
    ) and isinstance(n.slice, ast.Constant) and isinstance(
        n.slice.value, str
    ) and isinstance(n.ctx, ast.Load):
        return n.value.id, n.slice.value
    return None


def _kind_compares(expr: ast.AST, alias: dict[str, str]) -> list:
    """Every kind test inside an expression:
    ``(recvar, consts, positive)`` — ``rec.get("kind") == "span"``,
    ``kind in ("a", "b")`` through a ``kind = rec.get("kind")`` alias,
    and the negative forms (``!=`` / ``not in``)."""
    out: list = []
    for n in ast.walk(expr):
        if not isinstance(n, ast.Compare) or len(n.ops) != 1:
            continue
        op = n.ops[0]
        if not isinstance(op, _KIND_CMP_OPS):
            continue
        recvar = None
        consts: list[str] = []
        for side in [n.left] + list(n.comparators):
            rv = _kind_access_var(side)
            if rv:
                recvar = rv
            elif isinstance(side, ast.Name) and side.id in alias:
                recvar = alias[side.id]
            elif isinstance(side, ast.Constant) and isinstance(
                side.value, str
            ):
                consts.append(side.value)
            elif isinstance(side, (ast.Tuple, ast.List, ast.Set)):
                consts.extend(
                    e.value for e in side.elts
                    if isinstance(e, ast.Constant)
                    and isinstance(e.value, str)
                )
        if recvar and consts:
            positive = isinstance(op, (ast.Eq, ast.In))
            out.append((recvar, consts, positive, n.lineno))
    return out


def _record_consumer_facts(
    ctx: FileContext,
    graphs: dict[int, cfg_mod.CFG] | None = None,
) -> list[dict]:
    """Per function: each record variable whose ``kind`` the function
    tests against string constants (directly, or through a
    ``kind = rec.get("kind")`` alias — the dominant consumer idiom) and
    the constant fields it reads off that variable, *flow-sensitively
    attributed* over the CFG:

    * a read in the blocks exclusively reachable from a kind test's
      TRUE edge (its ``elif`` arm, say) belongs to exactly the kinds
      that test established — the big per-kind dispatch loops judge
      each arm against its own schema, not the union;
    * a read exclusively on the FALSE side of a positive test (the
      ``else:`` of ``if h.get("kind") == "finding":``) is governed by
      an unknown complement schema and is skipped — negative tests
      (``!= "span"``) govern their false side instead;
    * a read in shared code (before the dispatch, after the join, or
      inside a comprehension the statement CFG cannot split) falls back
      to the union of every kind the function tested.

    Output: ``{"var", "kinds", "line", "groups": [{"kinds", "fields"}]}``
    where an empty group ``kinds`` means the union fallback.
    """
    out: list[dict] = []
    for _qual, fn in _walk_functions(ctx.tree):
        nodes = list(_own_nodes(fn))
        alias: dict[str, str] = {}
        for n in nodes:
            if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                    and isinstance(n.targets[0], ast.Name):
                rv = _kind_access_var(n.value)
                if rv:
                    alias[n.targets[0].id] = rv

        all_kinds: dict[str, set[str]] = {}
        klines: dict[str, int] = {}
        for recvar, consts, _pos, line in _kind_compares(fn, alias):
            all_kinds.setdefault(recvar, set()).update(consts)
            klines.setdefault(recvar, line)
        if not all_kinds:
            continue

        graph = (graphs or {}).get(id(fn)) or cfg_mod.build(fn)
        # var -> block idx -> governing kinds (positive regions); and
        # var -> block idxs whose schema is an unknown complement
        governed: dict[str, dict[int, set[str]]] = {}
        skipped: dict[str, set[int]] = {}
        # test-expression units attribute their own reads to their own
        # positive kinds (`elif kind == "serve" and rec.get("event")..`)
        test_kinds: dict[int, dict[str, set[str]]] = {}
        for br in graph.branches:
            cmps = _kind_compares(br.node.test, alias)
            if not cmps:
                continue
            reach_then = {b.idx for b in graph.reachable(br.then_entry)}
            reach_else = {b.idx for b in graph.reachable(br.else_entry)}
            exc_then = reach_then - reach_else
            exc_else = reach_else - reach_then
            for recvar, consts, positive, _line in cmps:
                gov_region, skip_region = (
                    (exc_then, exc_else) if positive
                    else (exc_else, exc_then)
                )
                gv = governed.setdefault(recvar, {})
                for idx in gov_region:
                    gv.setdefault(idx, set()).update(consts)
                skipped.setdefault(recvar, set()).update(skip_region)
                if positive:
                    test_kinds.setdefault(id(br.node.test), {}) \
                        .setdefault(recvar, set()).update(consts)

        # group reads: frozenset of governing kinds (empty = union)
        groups: dict[str, dict[frozenset, dict[str, list]]] = {
            v: {} for v in all_kinds
        }
        for block in graph.blocks:
            for unit in block.units:
                tk = test_kinds.get(id(unit), {})
                for n in _unit_nodes(unit):
                    acc = _field_access(n)
                    if not acc:
                        continue
                    var, fname = acc
                    if var not in all_kinds or fname == "kind":
                        continue
                    if var in tk:
                        key = frozenset(tk[var])
                    else:
                        gov = governed.get(var, {}).get(block.idx)
                        if gov:
                            key = frozenset(gov)
                        elif block.idx in skipped.get(var, ()):
                            continue  # unknown complement schema
                        else:
                            key = frozenset()  # union fallback
                    groups[var].setdefault(key, {}).setdefault(
                        fname, [fname, n.lineno, n.col_offset]
                    )
        for var in sorted(all_kinds):
            out.append({
                "var": var,
                "kinds": sorted(all_kinds[var]),
                "line": klines[var],
                "groups": [
                    {"kinds": sorted(key),
                     "fields": sorted(fields.values())}
                    for key, fields in sorted(
                        groups[var].items(),
                        key=lambda kv: sorted(kv[0]),
                    )
                    if fields
                ],
            })
    return out


def extract_facts(ctx: FileContext) -> dict:
    """The file's whole-program facts record — pure data, JSON-stable
    (cold extraction and a cache round-trip produce identical project
    findings)."""
    from tpu_mpi_tests_torch.analysis.locks import extract_race_facts

    local_device = device_callables(ctx)
    rec_produced, rec_stamps = _record_producer_facts(ctx)
    # one CFG per function, shared by the rank-branch, record-consumer,
    # and lockset passes (they walk the same function list)
    functions_cls = _walk_functions_cls(ctx.tree)
    graphs = {id(node): cfg_mod.build(node)
              for _qual, node, _cls in functions_cls}
    races, fn_locks = extract_race_facts(
        ctx, functions_cls, graphs,
        resolve=lambda func: canon_target(ctx, func),
    )
    out_functions = []
    for qual, node, _cls in functions_cls:
        fn = _function_facts(ctx, qual, node, local_device,
                             graphs[id(node)])
        fn["locks"] = fn_locks.get(id(node), {})
        out_functions.append(fn)
    return {
        "path": ctx.path,
        "module": ctx.module,
        "mod_imports": module_level_imports(ctx),
        "timed_regions": _timed_region_facts(ctx, local_device),
        "rec_produced": rec_produced,
        "rec_stamps": rec_stamps,
        "rec_consumed": _record_consumer_facts(ctx, graphs),
        "races": races,
        "functions": out_functions,
    }


# ---------------------------------------------------------------------------
# project index


class ProjectIndex:
    """Module symbol table + call graph over the linted facts, with
    memoized transitive resolution of the per-function summaries."""

    def __init__(self, facts_list: list[dict]):
        self.facts = facts_list
        self.functions: dict[str, list[dict]] = {}
        self._fn_module: dict[int, str] = {}
        self._fn_by_module: dict[str, list[tuple[str, dict]]] = {}
        for ff in facts_list:
            for fn in ff["functions"]:
                key = f'{ff["module"]}.{fn["name"]}' if ff["module"] \
                    else fn["name"]
                self.functions.setdefault(key, []).append(fn)
                self._fn_module[id(fn)] = ff["module"]
                self._fn_by_module.setdefault(
                    ff["module"], []
                ).append((fn["name"], fn))
        self._memo: dict[tuple, bool] = {}

    # -- resolution --------------------------------------------------------

    def resolve_funcs(self, target: str | None,
                      module: str) -> list[dict]:
        """Facts for a canonical call target seen from ``module``: an
        exact module-qualified match first, then (for bare names) any
        same-module nested def with that final name — bare calls to
        closures are common in driver bodies and skipping them would
        blind every interprocedural family to the dominant local-helper
        idiom."""
        if not target:
            return []
        if "." in target:
            return self.functions.get(target, [])
        exact = self.functions.get(
            f"{module}.{target}" if module else target, []
        )
        if exact:
            return exact
        suffix = f".{target}"
        return [fn for name, fn in self._fn_by_module.get(module, [])
                if name.endswith(suffix)]

    def _module_of(self, fn: dict) -> str:
        return self._fn_module.get(id(fn), "")

    # -- transitive summaries ---------------------------------------------

    def _trans(self, fn: dict, key: str, direct) -> bool:
        memo_key = (key, id(fn))
        if memo_key in self._memo:
            return self._memo[memo_key]
        self._memo[memo_key] = False  # cycle guard
        val = direct(fn)
        if not val:
            mod = self._module_of(fn)
            for kind, target in fn["events"]:
                if kind != "call":
                    continue
                if any(self._trans(g, key, direct)
                       for g in self.resolve_funcs(target, mod)):
                    val = True
                    break
        self._memo[memo_key] = val
        return val

    def dispatches(self, fn: dict) -> bool:
        """Does this function's call graph dispatch device work?"""
        return self._trans(
            fn, "disp",
            lambda f: f["dispatches"]
            or any(e[0] == "coll" for e in f["events"]),
        )

    def syncs(self, fn: dict) -> bool:
        """Does its call graph reach a block/comm_span-class sync?"""
        return self._trans(fn, "sync", lambda f: f["syncs"])

    def returns_handle(self, fn: dict) -> bool:
        """Does it return an async_span handle (directly or through a
        returning helper)?"""
        memo_key = ("handle", id(fn))
        if memo_key in self._memo:
            return self._memo[memo_key]
        self._memo[memo_key] = False
        val = fn["returns_handle"]
        if not val:
            mod = self._module_of(fn)
            for target in fn["return_targets"]:
                if any(self.returns_handle(g)
                       for g in self.resolve_funcs(target, mod)):
                    val = True
                    break
        self._memo[memo_key] = val
        return val

    # -- collective sequences (TPM11xx) ------------------------------------

    def collective_seq(self, events: list, module: str,
                       _depth: int = 0,
                       _stack: frozenset = frozenset()) -> list[str]:
        """Flatten an event list into the ordered collective-op sequence
        its execution dispatches, expanding calls through the summaries
        (first match per target; cycle- and depth-guarded)."""
        if _depth > _MAX_DEPTH:
            return []
        out: list[str] = []
        for kind, val in events:
            if kind == "coll":
                out.append(val)
                continue
            funcs = self.resolve_funcs(val, module)
            if not funcs:
                continue
            g = funcs[0]
            if id(g) in _stack:
                continue
            out.extend(self.collective_seq(
                g["events"], self._module_of(g), _depth + 1,
                _stack | {id(g)},
            ))
        return out
