"""Threading-plane fact extraction for the TPM16xx lockset race
analysis (≅ ``tpu_mpi_tests/analysis/locks.py``: threading is the same
in both packages).

This module turns one parsed file into the JSON-serializable raw
material of a classic lockset race detector (Eraser, Savage et al.
1997, made commit-time practical by RacerD, Blackshear et al. 2018):

* **thread-entry discovery** — callables escaping into
  ``threading.Thread(target=...)`` / ``threading.Timer(..., f)``,
  ``timers.add_phase_hook(...)`` registrations, hook-slot rebinds
  (``telemetry._CHAOS_SPAN_HOOK = ...``), ``http.server`` handler
  classes, and callables escaping into the constructor of a
  thread-spawning class (the ``MemWatch(sink=lambda rec:
  rep.jsonl(...))`` wiring shape);
* **lockset computation** — ``with self._lock:`` / ``with _LOCK:``
  regions resolved over the per-function CFG's
  :class:`~tpu_mpi_tests_torch.analysis.cfg.WithRegion` blocks, giving every
  statement (and therefore every access event and outgoing call) its
  lexically held-lock set; caller-side propagation (a helper called
  only under a lock inherits it) happens at project scope
  (``rules/races.py``) over the per-function summaries built here;
* **shared-state access events** — ``self.<attr>`` loads/stores (plus
  mutator-method calls through the attribute: ``self._f.write(...)``
  mutates the handle), module-global mutations, and cross-module
  attribute stores, each stamped with the held locks.

Everything here is *per file* and name-based. Known blind spots:
dynamic dispatch, locks
passed as arguments (they degrade to a ``"?"`` wildcard that is assumed
to protect — false negatives, never false positives), ``getattr``
dispatch, and cross-process state.

The old lexical TPM601 heuristic lives here too
(:func:`lexical_tpm601`): its findings are recorded as facts and
emitted by the project rule only for files where thread-entry
discovery resolved nothing — the single-file fallback.

Stdlib-only by contract, like the rest of the analysis package. Must
not import the rule registry (facts extraction is cache-side).
"""

from __future__ import annotations

import ast
import re
from typing import Callable, Iterator

from tpu_mpi_tests_torch.analysis import cfg as cfg_mod
from tpu_mpi_tests_torch.analysis.core import (
    FileContext,
    attr_parts,
    last_attr,
    own_nodes as _own_nodes,
)

# ---------------------------------------------------------------------------
# vocabularies

#: thread spawn points: the callable argument runs on a new thread
THREAD_SPAWNS = {"threading.Thread", "threading.Timer"}

#: lock factories and the lock *kind* TPM1602 needs (re-acquiring a
#: plain Lock self-deadlocks; an RLock re-enters by design)
LOCK_FACTORIES = {
    "threading.Lock": "lock",
    "threading.RLock": "rlock",
    "threading.Condition": "lock",
    "threading.Semaphore": "lock",
    "threading.BoundedSemaphore": "lock",
}

#: attributes assigned from these are synchronization/thread-safe
#: objects — their own method calls are internally serialized (Event,
#: Queue) or GIL-atomic by design (deque append/popleft), so they are
#: not shared-state access events
SYNC_FACTORIES = {
    "threading.Event", "queue.Queue", "queue.SimpleQueue",
    "queue.LifoQueue", "collections.deque", "deque",
}

#: http.server-style handler base classes: each request gets its own
#: thread, so every method of a subclass is a concurrent root — and a
#: SELF-concurrent one (many requests in flight at once)
HANDLER_BASES = {
    "http.server.BaseHTTPRequestHandler",
    "http.server.SimpleHTTPRequestHandler",
    "socketserver.BaseRequestHandler",
    "socketserver.StreamRequestHandler",
}

#: registrar call names whose argument becomes a hook root (invoked
#: from foreign frames — concurrent with real threads, though the
#: repo's phase hooks themselves fire on the thread running the phase)
HOOK_REGISTRARS = {"add_phase_hook"}

#: method calls through an attribute that MUTATE the receiver — the
#: ``self._f.write(...)`` access is a write on the ``_f`` slot's object
MUTATORS = {
    "write", "writelines", "flush", "close", "append", "appendleft",
    "extend", "add", "update", "pop", "popitem", "popleft", "remove",
    "discard", "clear", "insert", "setdefault", "sort", "reverse",
    "put", "put_nowait",
}

#: module-private ALL-CAPS rebind slots (the chaos/telemetry hook-slot
#: idiom): writes are judged by TPM1603's arm/disarm check, and their
#: reads/writes are excluded from the TPM1601 event stream so one
#: hazard carries one code
_SLOT_RE = re.compile(r"^_[A-Z][A-Z0-9_]*$")
_SLOT_WORDS = ("HOOK", "PROVIDER", "FLOOD", "EMIT", "SLOT", "CALLBACK")


def is_hook_slot(name: str) -> bool:
    return bool(_SLOT_RE.match(name)) and any(
        w in name for w in _SLOT_WORDS
    )


def _lockish(name: str) -> bool:
    return "lock" in name.lower() or name.lower() in ("mutex",)


# ---------------------------------------------------------------------------
# small walkers (own scope: nested def/lambda bodies excluded)


def _unit_nodes(unit: ast.AST) -> Iterator[ast.AST]:
    yield unit
    yield from _own_nodes(unit)


def _walk_classes(tree: ast.Module) -> list[tuple[str, ast.ClassDef]]:
    """``(qualname, node)`` for every class, nested ones under their
    enclosing def/class prefixes — mirrors ``program._walk_functions``
    so method quals and class quals line up."""
    out: list[tuple[str, ast.ClassDef]] = []

    def visit(node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                q = f"{prefix}{child.name}"
                out.append((q, child))
                visit(child, q + ".")
            elif isinstance(child, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                visit(child, f"{prefix}{child.name}.")
            else:
                visit(child, prefix)

    visit(tree, "")
    return out


# ---------------------------------------------------------------------------
# the extractor


class _RaceFacts:
    """One file's threading-plane facts, built in two passes: a class/
    module survey, then a per-function walk that stamps lock contexts
    on calls and access events."""

    def __init__(self, ctx: FileContext,
                 functions: list[tuple[str, ast.AST, str]],
                 graphs: dict[int, cfg_mod.CFG],
                 resolve: Callable[[ast.AST], str | None]):
        self.ctx = ctx
        self.functions = functions
        self.graphs = graphs
        self.resolve = resolve
        self.module = ctx.module

        #: cls qual -> {"bases", "methods", "data", "sync"}
        self.classes: dict[str, dict] = {}
        self.lock_defs: list[list] = []      # [owner, attr, kind]
        self.spawns: list[list] = []         # [kind, ref|None, line]
        self.handlers: list[str] = []        # handler class quals
        self.escapes: list[list] = []        # [call_target, ref, line]
        self.slot_writes: list[list] = []    # [mod, name, vkind, line,
        #                                       col, scope]
        self.slot_reads: list[list] = []     # [f"{mod}.{name}", line]
        #: keyed by node identity, NOT qualname — try/except and
        #: platform-variant files legitimately define the same qual
        #: twice, and each def keeps its own lock summary
        self.fn_locks: dict[int, dict] = {}

        self._survey_classes()
        self._survey_module()
        self._survey_globals()
        for qual, node, cls in functions:
            env = dict(self.module_env)
            env.update(self._type_env(_own_nodes(node)))
            self._scan_spawn_sites(node, cls, env)
            self.fn_locks[id(node)] = self._function_locks(
                qual, node, cls, env
            )
        self._scan_spawn_sites(self.ctx.tree, "", self.module_env,
                               module_level=True)

    # -- pass 1: classes / module ------------------------------------------

    def _survey_classes(self) -> None:
        all_classes = _walk_classes(self.ctx.tree)
        for qual, node in all_classes:
            bases: list[str] = []
            for b in node.bases:
                parts = attr_parts(b)
                if not parts:
                    continue
                origin = self.ctx.imports.origin(parts[0])
                if origin:
                    bases.append(".".join([origin] + parts[1:]))
                else:
                    # same-file base (possibly nested): prefer the
                    # defined class with that final name
                    local = [q for q, _n in all_classes
                             if q.rsplit(".", 1)[-1] == parts[-1]]
                    bases.append(
                        f"{self.module}.{local[0]}" if local
                        else ".".join(parts)
                    )
            self.classes[qual] = {
                "bases": bases, "methods": set(), "data": set(),
                "sync": set(),
            }
            if any(b in HANDLER_BASES for b in bases):
                self.handlers.append(qual)
        for qual, _node, cls in self.functions:
            if cls and cls in self.classes \
                    and qual.rsplit(".", 1)[0] == cls:
                self.classes[cls]["methods"].add(
                    qual.rsplit(".", 1)[-1]
                )
        # attribute survey: stores, lock/sync factory assignments
        for qual, node, cls in self.functions:
            if not cls or cls not in self.classes:
                continue
            info = self.classes[cls]
            for n in _own_nodes(node):
                targets: list[ast.AST] = []
                value = None
                if isinstance(n, ast.Assign):
                    targets, value = list(n.targets), n.value
                elif isinstance(n, (ast.AnnAssign, ast.AugAssign)):
                    targets, value = [n.target], n.value
                for t in targets:
                    if not (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"):
                        continue
                    info["data"].add(t.attr)
                    canon = self.resolve(value.func) if isinstance(
                        value, ast.Call
                    ) else None
                    if canon in LOCK_FACTORIES:
                        self.lock_defs.append([
                            f"{self.module}.{cls}", t.attr,
                            LOCK_FACTORIES[canon],
                        ])
                    elif canon in SYNC_FACTORIES:
                        info["sync"].add(t.attr)

    def _survey_module(self) -> None:
        self.module_assigned: set[str] = set()
        self.module_locks: dict[str, str] = {}  # name -> kind
        self.module_env: dict[str, str] = self._type_env(
            _own_nodes(self.ctx.tree)
        )
        for n in self.ctx.tree.body:
            targets: list[ast.AST] = []
            value = None
            if isinstance(n, ast.Assign):
                targets, value = list(n.targets), n.value
            elif isinstance(n, ast.AnnAssign):
                targets, value = [n.target], n.value
            for t in targets:
                if not isinstance(t, ast.Name):
                    continue
                self.module_assigned.add(t.id)
                canon = self.resolve(value.func) if isinstance(
                    value, ast.Call
                ) else None
                if canon in LOCK_FACTORIES:
                    kind = LOCK_FACTORIES[canon]
                    self.module_locks[t.id] = kind
                    # exported like the class locks, so TPM1602 can
                    # tell a module-scope Lock from an RLock
                    self.lock_defs.append([self.module, t.id, kind])
                if is_hook_slot(t.id):
                    self.slot_writes.append([
                        self.module, t.id, self._value_kind(value),
                        n.lineno, n.col_offset, "module",
                    ])

    def _survey_globals(self) -> None:
        """Names any function in the file mutates at module scope —
        the candidates whose reads become access events."""
        self.glob_written: set[str] = set()
        for _qual, node, _cls in self.functions:
            for n in _own_nodes(node):
                if isinstance(n, ast.Global):
                    self.glob_written.update(
                        x for x in n.names
                        if not is_hook_slot(x)
                    )
                elif isinstance(n, ast.Call) and isinstance(
                    n.func, ast.Attribute
                ) and n.func.attr in MUTATORS and isinstance(
                    n.func.value, ast.Name
                ) and n.func.value.id in self.module_assigned \
                        and not is_hook_slot(n.func.value.id):
                    self.glob_written.add(n.func.value.id)

    # -- helpers ------------------------------------------------------------

    def _type_env(self, nodes) -> dict[str, str]:
        """``x = ClassName(...)`` assignments: local-name → constructed
        class canon, so ``x.meth()`` calls and ``x.meth`` escapes
        resolve without a project-wide name hunt."""
        env: dict[str, str] = {}
        for n in nodes:
            if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                    and isinstance(n.targets[0], ast.Name) \
                    and isinstance(n.value, ast.Call):
                canon = self.resolve(n.value.func)
                if canon and canon.rsplit(".", 1)[-1][:1].isupper():
                    env[n.targets[0].id] = canon
        return env

    def _value_kind(self, value: ast.AST | None) -> str:
        if value is None:
            return "other"
        if isinstance(value, ast.Constant) and value.value is None:
            return "none"
        if isinstance(value, (ast.Call, ast.Lambda)):
            return "call"
        if isinstance(value, ast.Name) and self._local_def(value.id):
            return "func"
        return "other"

    def _local_def(self, name: str) -> str | None:
        """Same-file def whose final qual component is ``name`` (the
        deepest/first match) — how a bare ``sink`` argument resolves to
        the nested ``_arm_metrics.sink`` closure."""
        matches = [q for q, _n, _c in self.functions
                   if q.rsplit(".", 1)[-1] == name]
        return f"{self.module}.{matches[0]}" if matches else None

    def _call_target(self, func: ast.AST, cls: str,
                     env: dict[str, str]) -> str | None:
        parts = attr_parts(func)
        if not parts:
            return None
        if parts[0] == "self":
            if len(parts) == 2 and cls:
                return f"{self.module}.{cls}.{parts[1]}"
            return None
        if len(parts) == 2 and parts[0] in env:
            return f"{env[parts[0]]}.{parts[1]}"
        return self.resolve(func)

    def _callable_ref(self, v: ast.AST, cls: str,
                      env: dict[str, str]) -> list[str]:
        """Thread-target / escaped-callable references an argument can
        carry: a bound method, a local function, or (for a lambda) the
        targets its body calls."""
        if isinstance(v, ast.Lambda):
            out = []
            for n in ast.walk(v.body):
                if isinstance(n, ast.Call):
                    t = self._call_target(n.func, cls, env)
                    if t is None and isinstance(n.func, ast.Attribute):
                        t = f"?meth:{n.func.attr}"
                    if t:
                        out.append(t)
            return out
        parts = attr_parts(v)
        if parts and len(parts) == 2:
            if parts[0] == "self" and cls:
                return [f"{self.module}.{cls}.{parts[1]}"]
            if parts[0] in env:
                return [f"{env[parts[0]]}.{parts[1]}"]
            origin = self.ctx.imports.origin(parts[0])
            if origin:
                return [f"{origin}.{parts[1]}"]
            return [f"?meth:{parts[1]}"]
        if isinstance(v, ast.Name):
            local = self._local_def(v.id)
            if local:
                return [local]
        return []

    def _module_alias(self, name: str) -> str | None:
        """Local name → module canon, when the name IS a module (plain
        import alias, or a from-import of a submodule)."""
        if name in self.ctx.imports.modules:
            return self.ctx.imports.modules[name]
        if name in self.ctx.imports.names:
            mod, orig = self.ctx.imports.names[name]
            # `from pkg import mod as alias`: heuristically a module
            # when the original is lowercase (classes are CapWords,
            # functions rarely get rebound attributes)
            if orig[:1].islower():
                return f"{mod}.{orig}" if mod else orig
        return None

    # -- spawn / escape / slot discovery ------------------------------------

    def _scan_spawn_sites(self, root: ast.AST, cls: str,
                          env: dict[str, str],
                          module_level: bool = False) -> None:
        for n in _own_nodes(root):
            if isinstance(n, ast.Call):
                self._scan_call(n, cls, env)
            elif isinstance(n, ast.Assign):
                self._scan_assign_slots(n, cls,
                                        module_level=module_level)
            elif isinstance(n, ast.Attribute) and isinstance(
                n.ctx, ast.Load
            ) and isinstance(n.value, ast.Name):
                mod = self._module_alias(n.value.id)
                if mod and is_hook_slot(n.attr):
                    self.slot_reads.append([f"{mod}.{n.attr}",
                                            n.lineno])
            elif isinstance(n, ast.Name) and isinstance(
                n.ctx, ast.Load
            ) and is_hook_slot(n.id) and n.id in self.module_assigned:
                self.slot_reads.append([f"{self.module}.{n.id}",
                                        n.lineno])

    def _scan_call(self, n: ast.Call, cls: str,
                   env: dict[str, str]) -> None:
        canon = self.resolve(n.func) or ""
        # thread/timer spawns
        if canon in THREAD_SPAWNS:
            target = None
            if canon.endswith("Timer"):
                if len(n.args) > 1:
                    target = n.args[1]
            for kw in n.keywords:
                if kw.arg in ("target", "function"):
                    target = kw.value
            refs = self._callable_ref(target, cls, env) \
                if target is not None else []
            if refs:
                for r in refs:
                    self.spawns.append(["thread", r, n.lineno])
            else:
                self.spawns.append(["thread", None, n.lineno])
            return
        # hook registrations
        if (last_attr(n.func) or "") in HOOK_REGISTRARS and n.args:
            arg = n.args[0]
            if isinstance(arg, ast.Name) and arg.id == "self" and cls:
                refs = [f"{self.module}.{cls}.__call__"]
            else:
                refs = self._callable_ref(arg, cls, env)
            for r in refs or [None]:
                self.spawns.append(["hook", r, n.lineno])
            return
        # callable escapes into an arbitrary call (judged at project
        # scope: only calls landing in thread-spawning classes matter)
        tgt = self._call_target(n.func, cls, env)
        if not tgt:
            return
        for v in list(n.args) + [kw.value for kw in n.keywords]:
            for r in self._callable_ref(v, cls, env):
                self.escapes.append([tgt, r, n.lineno])

    def _scan_assign_slots(self, n: ast.Assign, cls: str,
                           module_level: bool = False) -> None:
        for t in n.targets:
            if isinstance(t, ast.Attribute) and isinstance(
                t.value, ast.Name
            ):
                mod = self._module_alias(t.value.id)
                if mod and is_hook_slot(t.attr):
                    # an import-time install is a declaration-shaped
                    # initializer, not the arm-time rebind TPM1603
                    # judges — record it as module scope
                    self.slot_writes.append([
                        mod, t.attr, self._value_kind(n.value),
                        n.lineno, n.col_offset,
                        "module" if module_level else "func",
                    ])
            elif isinstance(t, ast.Name) and is_hook_slot(t.id) \
                    and t.id in self.module_assigned and not cls \
                    and not module_level:
                # function-scope rebind of the module's own slot
                # (reached via a `global` declaration); module-scope
                # initializers were already recorded by _survey_module
                # as scope "module" — the slot's declaration, not a
                # rebind
                self.slot_writes.append([
                    self.module, t.id, self._value_kind(n.value),
                    n.lineno, n.col_offset, "func",
                ])

    # -- per-function lock facts --------------------------------------------

    def _lock_id(self, expr: ast.AST, cls: str, qual: str,
                 local_locks: set[str]) -> str | None:
        parts = attr_parts(expr)
        if not parts:
            return None
        if parts[0] == "self" and len(parts) == 2 and cls:
            attr = parts[1]
            known = any(
                o == f"{self.module}.{cls}" and a == attr
                for o, a, _k in self.lock_defs
            )
            if known or _lockish(attr):
                return f"{self.module}.{cls}::{attr}"
            return None
        if len(parts) == 1:
            name = parts[0]
            if name in self.module_locks:
                return f"{self.module}::{name}"
            if name in local_locks:
                return f"{self.module}.{qual}::{name}"
            if _lockish(name):
                return "?"
            return None
        # deeper chains / foreign receivers: a lock we cannot name —
        # the wildcard is assumed to protect (FN over FP)
        return "?" if _lockish(parts[-1]) else None

    def _function_locks(self, qual: str, node: ast.AST, cls: str,
                        env: dict[str, str]) -> dict:
        graph = self.graphs.get(id(node)) or cfg_mod.build(node)
        local_locks: set[str] = set()
        for n in _own_nodes(node):
            if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                    and isinstance(n.targets[0], ast.Name) \
                    and isinstance(n.value, ast.Call):
                canon = self.resolve(n.value.func)
                if canon in LOCK_FACTORIES:
                    name = n.targets[0].id
                    local_locks.add(name)
                    self.lock_defs.append([
                        f"{self.module}.{qual}", name,
                        LOCK_FACTORIES[canon],
                    ])
        glob_decls: set[str] = set()
        local_names: set[str] = set()
        for n in _own_nodes(node):
            if isinstance(n, ast.Global):
                glob_decls.update(n.names)
            elif isinstance(n, ast.Name) and isinstance(
                n.ctx, ast.Store
            ):
                local_names.add(n.id)
        a = node.args if hasattr(node, "args") else None
        if a is not None:
            local_names.update(p.arg for p in (
                a.posonlyargs + a.args + a.kwonlyargs
            ))
            for va in (a.vararg, a.kwarg):
                if va is not None:
                    local_names.add(va.arg)
        # a name assigned locally (no `global`) shadows the module
        # global — its loads are local reads, not shared-state events
        local_names -= glob_decls

        held_by_block: dict[int, set[str]] = {}
        regions: list[tuple[cfg_mod.WithRegion, list[str]]] = []
        for region in graph.with_regions:
            ids = []
            for item in region.node.items:
                lid = self._lock_id(item.context_expr, cls, qual,
                                    local_locks)
                if lid:
                    ids.append(lid)
            if not ids:
                continue
            regions.append((region, ids))
            for b in region.blocks:
                held_by_block.setdefault(b, set()).update(ids)

        acquires: list[list] = []
        for region, ids in regions:
            outer: set[str] = set()
            for other, oids in regions:
                if other is region:
                    continue
                if region.blocks < other.blocks:
                    outer.update(oids)
            for lid in ids:
                acquires.append([lid, region.node.lineno,
                                 region.node.col_offset,
                                 sorted(outer)])

        accesses: list[list] = []
        calls: list[list] = []
        for block in graph.blocks:
            held = sorted(held_by_block.get(block.idx, ()))
            for unit in block.units:
                self._scan_unit(unit, cls, qual, env, held,
                                glob_decls, local_names, accesses,
                                calls)
        return {
            "cls": cls,
            "acquires": acquires,
            "calls": calls,
            "accesses": accesses,
        }

    def _scan_unit(self, unit: ast.AST, cls: str, qual: str,
                   env: dict[str, str], held: list[str],
                   glob_decls: set[str], local_names: set[str],
                   accesses: list[list], calls: list[list]) -> None:
        nodes = list(_unit_nodes(unit))
        skip: set[int] = set()   # attribute nodes consumed by calls
        write_ids: set[int] = set()

        info = self.classes.get(cls, {"methods": set(), "data": set(),
                                      "sync": set()})

        def is_self_attr(x) -> bool:
            return (cls and isinstance(x, ast.Attribute)
                    and isinstance(x.value, ast.Name)
                    and x.value.id == "self")

        for n in nodes:
            if isinstance(n, ast.Call):
                tgt = self._call_target(n.func, cls, env)
                if tgt:
                    calls.append([tgt, n.lineno, n.col_offset, held])
                f = n.func
                if isinstance(f, ast.Attribute):
                    recv = f.value
                    if is_self_attr(f) and f.attr in info["methods"] \
                            and f.attr not in info["data"]:
                        skip.add(id(f))  # self.meth(...): a call edge
                    if is_self_attr(recv) and f.attr in MUTATORS:
                        write_ids.add(id(recv))
                    elif isinstance(recv, ast.Name) \
                            and f.attr in MUTATORS \
                            and recv.id in self.glob_written:
                        accesses.append(["w", "", recv.id, n.lineno,
                                         n.col_offset, held])
            elif isinstance(n, ast.Subscript) and isinstance(
                n.ctx, ast.Store
            ) and is_self_attr(n.value):
                write_ids.add(id(n.value))

        for n in nodes:
            if is_self_attr(n) and id(n) not in skip:
                attr = n.attr
                if attr in info["sync"]:
                    continue
                if attr in info["methods"] and attr not in info["data"]:
                    continue  # a method reference, not shared data
                if isinstance(n.ctx, (ast.Store, ast.Del)) \
                        or id(n) in write_ids:
                    rw = "w"
                else:
                    rw = "r"
                accesses.append([rw, cls, attr, n.lineno,
                                 n.col_offset, held])
            elif isinstance(n, ast.Name):
                if is_hook_slot(n.id):
                    continue  # TPM1603's domain
                if isinstance(n.ctx, ast.Store) and n.id in glob_decls:
                    accesses.append(["w", "", n.id, n.lineno,
                                     n.col_offset, held])
                elif isinstance(n.ctx, ast.Load) \
                        and n.id in self.glob_written \
                        and n.id not in local_names:
                    accesses.append(["r", "", n.id, n.lineno,
                                     n.col_offset, held])
            elif isinstance(n, ast.Attribute) and isinstance(
                n.ctx, ast.Store
            ) and isinstance(n.value, ast.Name):
                mod = self._module_alias(n.value.id)
                if mod and not is_hook_slot(n.attr):
                    accesses.append(["w", "@" + mod, n.attr, n.lineno,
                                     n.col_offset, held])

    # -- output -------------------------------------------------------------

    def file_facts(self) -> dict:
        return {
            "classes": sorted(
                [q, sorted(i["bases"]), sorted(i["sync"])]
                for q, i in self.classes.items()
            ),
            "lock_defs": sorted(self.lock_defs),
            "spawns": sorted(self.spawns,
                             key=lambda s: (s[2], s[0], s[1] or "")),
            "handlers": sorted(self.handlers),
            "escapes": sorted(self.escapes),
            "slot_writes": sorted(self.slot_writes,
                                  key=lambda s: (s[3], s[4])),
            "slot_reads": sorted(self.slot_reads),
            "tpm601": lexical_tpm601(self.ctx),
        }


def extract_race_facts(
    ctx: FileContext,
    functions: list[tuple[str, ast.AST, str]],
    graphs: dict[int, cfg_mod.CFG],
    resolve: Callable[[ast.AST], str | None],
) -> tuple[dict, dict[int, dict]]:
    """``(file_facts, per-function lock facts keyed by ``id(node)``)``
    for one parsed file."""
    rf = _RaceFacts(ctx, functions, graphs, resolve)
    return rf.file_facts(), rf.fn_locks


# ---------------------------------------------------------------------------
# the demoted lexical TPM601 heuristic, now a fact: emitted by
# the project concurrency rule ONLY for files where thread-entry
# discovery resolved nothing (no spawn target, no handler class) — the
# whole-program TPM1601 machinery owns every file it can model


_TPM601_EXEMPT_PARTS = {"stdout", "stderr", "stream", "sys"}


def _dotted(node: ast.AST) -> str | None:
    parts = attr_parts(node)
    return ".".join(parts) if parts else None


def _is_lockish_expr(expr: ast.AST, locks: set[str]) -> bool:
    name = _dotted(expr)
    if not name:
        return False
    last = name.rsplit(".", 1)[-1].lower()
    return name in locks or "lock" in last


def _own_stmt_calls(stmt):
    """Calls in the statement's header/expressions, excluding nested
    statement bodies (those get their own lock context)."""
    nested: set[int] = set()
    for field in ("body", "orelse", "finalbody"):
        for sub in getattr(stmt, field, None) or ():
            for n in ast.walk(sub):
                nested.add(id(n))
    for h in getattr(stmt, "handlers", ()):
        for sub in h.body:
            for n in ast.walk(sub):
                nested.add(id(n))
    for n in ast.walk(stmt):
        if isinstance(n, ast.Call) and id(n) not in nested:
            yield n


def _tpm601_walk(stmts, locks, open_names, held) -> Iterator[list]:
    for stmt in stmts:
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            inner_held = held or any(
                _is_lockish_expr(item.context_expr, locks)
                for item in stmt.items
            )
            yield from _tpm601_walk(stmt.body, locks, open_names,
                                    inner_held)
            continue
        for call in _own_stmt_calls(stmt):
            yield from _tpm601_check_write(call, open_names, held)
        for field in ("body", "orelse", "finalbody"):
            sub = getattr(stmt, field, None)
            if isinstance(sub, list):
                yield from _tpm601_walk(sub, locks, open_names, held)
        for h in getattr(stmt, "handlers", ()):
            yield from _tpm601_walk(h.body, locks, open_names, held)


def _tpm601_check_write(call, open_names, held) -> Iterator[list]:
    func = call.func
    if not (isinstance(func, ast.Attribute) and func.attr == "write"):
        return
    recv = func.value
    parts = attr_parts(recv)
    if parts and (parts[0] == "sys"
                  or any(p in _TPM601_EXEMPT_PARTS for p in parts)):
        return
    shared = isinstance(recv, ast.Attribute) or (
        isinstance(recv, ast.Name) and recv.id in open_names
    )
    if shared and not held:
        name = ".".join(parts) if parts else "<handle>"
        yield [
            call.lineno, call.col_offset,
            f"'{name}.write()' in a module that arms a "
            f"threading.Timer/Thread — concurrent writes interleave "
            f"records (the watchdog JSONL bug class); serialize one "
            f"write per record under `with <lock>:`",
        ]


def lexical_tpm601(ctx: FileContext) -> list[list]:
    """The lexical heuristic: ``.write()`` on a shared-looking
    handle, in a file that arms a Timer/Thread, outside ``with
    <lock>:``. Returns ``[line, col, message]`` rows."""
    spawns = False
    locks: set[str] = set()
    open_names: set[str] = set()
    for n in ast.walk(ctx.tree):
        if isinstance(n, ast.Call):
            resolved = ctx.imports.resolve(n.func) or ""
            if resolved in THREAD_SPAWNS:
                spawns = True
        if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call):
            resolved = ctx.imports.resolve(n.value.func) or ""
            for t in n.targets:
                name = _dotted(t)
                if not name:
                    continue
                if resolved in LOCK_FACTORIES:
                    locks.add(name)
                elif resolved in ("open", "io.open"):
                    open_names.add(name)
    if not spawns:
        return []
    return list(_tpm601_walk(ctx.tree.body, locks, open_names,
                             held=False))
