"""TPM16xx — interprocedural lockset race detection over the threading
plane (≅ the JAX package's rule; threading is the same in both).

Three concurrency shapes motivate this family: the watchdog/Reporter
JSONL interleave, the ``attach_metrics`` re-entrant-lock deadlock
shape, and the http.server per-connection ``wfile`` false positive of
the lexical TPM601. The analysis is classic lockset
(Eraser) made commit-time practical the RacerD way: no alias analysis,
no happens-before — just thread roots, may-happen-in-parallel sides,
and per-access held-lock sets, all conservative enough to gate CI.

**The MHP model.** Every function gets a set of *sides*: the concurrent
roots whose call graph reaches it (``threading.Thread``/``Timer``
targets, hook registrations, http.server handler methods, callables
escaping into a thread-spawning class's constructor) plus ``main`` when
it is reachable from non-thread code. Two accesses may happen in
parallel when their sides contain two *distinct* roots — with two
carve-outs: hook roots (phase hooks, chaos/telemetry slot hooks) run on
the thread that fires them, so hook×main and hook×hook pairs are NOT
parallel; and a single spawned thread is not parallel with itself,
except http.server handler roots, which serve one thread per connection
and therefore are.

**The verdicts.**

* **TPM1601** (data race): a write/write or read/write pair on one
  abstract location — ``Cls.attr`` (inheritance-merged) or a module
  global — from MHP-distinct sides whose effective locksets are
  disjoint. An access's effective lockset is its lexical ``with``
  region set plus the locks held at *every* call site reaching its
  function (intersection — the Eraser discipline), so a write inside
  ``Reporter.jsonl`` knows it holds ``_jsonl_lock`` even when reached
  through a wrapper. Constructors (``__init__`` et al.) are exempt:
  they run before the object escapes.
* **TPM1602** (re-entrant self-deadlock): a call made while holding a
  non-reentrant ``threading.Lock`` whose transitive callees re-acquire
  the same lock — the exact ``attach_metrics`` observe-outside-the-lock
  shape, now enforced instead of remembered. ``RLock`` re-entry is
  clean by design.
* **TPM1603** (hook-slot rebind): a function-scope rebind of a
  module-private ALL-CAPS hook slot (``telemetry._CHAOS_SPAN_HOOK``)
  to a live callable, in a file with no matching ``= None`` disarm,
  while some reader loads the slot — the chaos arm/disarm idiom is the
  sanctioned shape (``arm()`` installs, ``disarm()`` uninstalls).

Unknown locks (an attribute of a foreign object, a lock passed as an
argument) degrade to a wildcard that is assumed to protect — a false
negative, never a false positive. Test modules are exempt end to end:
tests spawn threads to exercise these layers, they are not contract
parties.
"""

from __future__ import annotations

from typing import Iterator

from tpu_mpi_tests_torch.analysis.core import ProjectContext, is_test_file

#: builtin-ish method names excluded from the unique-method fallback
#: resolution — `rec.get(...)`/`path.exists()` must never resolve to a
#: project class that happens to define the same name
_COMMON_METHODS = {
    "get", "items", "keys", "values", "update", "append", "pop",
    "add", "join", "split", "read", "readline", "readlines", "strip",
    "format", "copy", "setdefault", "extend", "sort", "remove",
    "clear", "close", "open", "encode", "decode", "count", "index",
    "insert", "search", "match", "group", "sub", "findall", "mkdir",
    "exists", "resolve", "unlink", "lower", "upper", "startswith",
    "endswith", "rstrip", "lstrip", "replace", "flush", "tell",
    "seek", "cancel", "start", "stop", "is_set", "set", "wait",
    "acquire", "release", "put", "send", "recv", "sum", "mean", "min",
    "max", "item", "reshape", "astype", "tolist", "touch", "rglob",
    "glob", "iterdir", "write", "main", "run", "check", "parse",
}

_INIT_METHODS = {"__init__", "__post_init__", "__new__"}

_MAX_REACH = 4000  # BFS node budget per root (runaway-graph backstop)


class _Root:
    __slots__ = ("rid", "kind", "label", "self_mhp")

    def __init__(self, rid: str, kind: str, label: str,
                 self_mhp: bool = False):
        self.rid = rid
        self.kind = kind  # "thread" | "hook"
        self.label = label
        self.self_mhp = self_mhp


def _mhp(a, b) -> bool:
    """May the two sides run in parallel? ``"main"`` or a _Root."""
    if a == "main" and b == "main":
        return False
    if a == "main" or b == "main":
        root = b if a == "main" else a
        return root.kind == "thread"  # hooks fire ON the main thread
    if a.rid == b.rid:
        return a.self_mhp  # one Timer/Thread is not parallel w/ itself
    if a.kind == "hook" and b.kind == "hook":
        return False  # two hooks still share the firing thread
    return True


class _Program:
    """The linted program's threading-plane view, built from facts."""

    def __init__(self, proj: ProjectContext):
        self.files = [ff for ff in proj.facts
                      if not is_test_file(ff["path"])
                      and "races" in ff]
        self.fn_key: dict[str, dict] = {}
        self.fn_file: dict[int, dict] = {}
        self.methods: dict[str, list[dict]] = {}  # last comp -> fns
        self.classes: dict[str, dict] = {}  # canon -> {bases, sync}
        self.lock_kind: dict[str, str] = {}
        for ff in self.files:
            mod = ff["module"]
            for cls_q, bases, sync in ff["races"]["classes"]:
                canon = f"{mod}.{cls_q}" if mod else cls_q
                self.classes[canon] = {"bases": bases, "sync": sync}
            for fn in ff["functions"]:
                if not fn.get("locks"):
                    continue
                key = f'{mod}.{fn["name"]}' if mod else fn["name"]
                self.fn_key.setdefault(key, fn)
                self.fn_file[id(fn)] = ff
                if fn["locks"].get("cls"):
                    self.methods.setdefault(
                        fn["name"].rsplit(".", 1)[-1], []
                    ).append(fn)
        for ff in self.files:
            for owner, attr, kind in ff["races"]["lock_defs"]:
                self.lock_kind[f"{self.canon_cls(owner)}::{attr}"] = kind
        self._canon_memo: dict[str, str] = {}
        self._resolved: dict[tuple, list[dict]] = {}

    # -- canonicalization ---------------------------------------------------

    def canon_cls(self, canon: str) -> str:
        """Climb to the topmost project-known ancestor so a subclass's
        ``self.phase`` and the base's are ONE abstract location."""
        seen = set()
        while canon in self.classes and canon not in seen:
            seen.add(canon)
            nxt = next((b for b in self.classes[canon]["bases"]
                        if b in self.classes), None)
            if nxt is None:
                break
            canon = nxt
        return canon

    def canon_lock(self, lid: str) -> str:
        if lid == "?" or "::" not in lid:
            return lid
        owner, attr = lid.split("::", 1)
        return f"{self.canon_cls(owner)}::{attr}"

    def sync_attrs(self, canon: str) -> set[str]:
        """Sync-object attrs merged over the (project-known) class
        chain — an Event defined by the base exempts subclass reads."""
        out: set[str] = set()
        cur, seen = canon, set()
        while cur in self.classes and cur not in seen:
            seen.add(cur)
            out.update(self.classes[cur]["sync"])
            cur = next((b for b in self.classes[cur]["bases"]
                        if b in self.classes), cur)
        return out

    # -- resolution ---------------------------------------------------------

    def resolve(self, target: str | None, module: str = "") -> list[dict]:
        key = (target, module)
        if key not in self._resolved:
            self._resolved[key] = self._resolve(target, module)
        return self._resolved[key]

    def _resolve(self, target: str | None, module: str) -> list[dict]:
        if not target:
            return []
        if target.startswith("?meth:"):
            return self._unique_method(target[6:])
        fn = self.fn_key.get(target)
        if fn is not None:
            return [fn]
        if "." in target:
            owner, meth = target.rsplit(".", 1)
            # inherited method: Cls.meth defined on an ancestor
            cur, seen = owner, set()
            while cur in self.classes and cur not in seen:
                seen.add(cur)
                nxt = next((b for b in self.classes[cur]["bases"]
                            if b in self.classes), None)
                if nxt is None:
                    break
                cur = nxt
                fn = self.fn_key.get(f"{cur}.{meth}")
                if fn is not None:
                    return [fn]
            # untyped receiver (`rep.jsonl`): unique project method
            return self._unique_method(meth)
        if module:
            fn = self.fn_key.get(f"{module}.{target}")
            if fn is not None:
                return [fn]
            suffix = f".{target}"
            hits = [f for k, f in self.fn_key.items()
                    if k.startswith(module + ".") and k.endswith(suffix)]
            if len(hits) == 1:
                return hits
        return []

    def _unique_method(self, meth: str) -> list[dict]:
        if meth in _COMMON_METHODS:
            return []
        hits = self.methods.get(meth, [])
        return hits if len(hits) == 1 else []

    def module_of(self, fn: dict) -> str:
        ff = self.fn_file.get(id(fn))
        return ff["module"] if ff else ""

    def path_of(self, fn: dict) -> str:
        ff = self.fn_file.get(id(fn))
        return ff["path"] if ff else "?"


class LocksetRaces:
    name = "races"
    scope = "project"
    codes = {
        "TPM1601": "unsynchronized shared-state access from "
                   "may-happen-in-parallel threads with disjoint "
                   "locksets (data race)",
        "TPM1602": "call made while holding a non-reentrant lock "
                   "whose callees re-acquire it (self-deadlock)",
        "TPM1603": "hook-slot rebind without the arm/disarm idiom "
                   "while a reader is live",
    }

    # -- entry --------------------------------------------------------------

    def check_project(self, proj: ProjectContext) -> Iterator[tuple]:
        prog = _Program(proj)
        if not prog.files:
            return
        roots = self._discover_roots(prog)
        reach = self._reach(prog, roots)
        main_set = self._main_reachable(prog, reach)
        inherited = self._inherited_locks(prog, roots)
        yield from self._races(prog, roots, reach, main_set, inherited)
        yield from self._deadlocks(prog, inherited)
        yield from self._slot_rebinds(prog)

    # -- thread-entry discovery ---------------------------------------------

    def _discover_roots(
        self, prog: _Program,
    ) -> dict[str, tuple[_Root, list[dict]]]:
        """root id -> (root, entry fns)."""
        out: dict[str, tuple[_Root, list[dict]]] = {}
        seen_entries: dict[str, set[int]] = {}

        def add(rid, kind, label, entries, self_mhp=False):
            if not entries:
                return
            if rid not in out:
                out[rid] = (_Root(rid, kind, label, self_mhp), [])
                seen_entries[rid] = set()
            _root, fns = out[rid]
            ids = seen_entries[rid]
            for e in entries:
                if id(e) not in ids:
                    ids.add(id(e))
                    fns.append(e)

        threaded: dict[str, str] = {}  # class canon -> "thread"|"hook"
        for ff in prog.files:
            mod = ff["module"]
            races = ff["races"]
            for kind, ref, line in races["spawns"]:
                for fn in prog.resolve(ref, mod):
                    cls = fn["locks"].get("cls")
                    if cls:
                        owner = prog.canon_cls(
                            f"{prog.module_of(fn)}.{cls}"
                        )
                        cur = threaded.get(owner)
                        if kind == "thread" or cur is None:
                            threaded[owner] = kind
                    add(f'{ff["path"]}:{line}:{ref}', kind, ref, [fn])
            for cls_q in races["handlers"]:
                canon = f"{mod}.{cls_q}" if mod else cls_q
                threaded[prog.canon_cls(canon)] = "thread"
                entries = [
                    fn for fn in ff["functions"]
                    if fn.get("locks", {}).get("cls") == cls_q
                ]
                add(f'{ff["path"]}:handler:{cls_q}', "thread",
                    f"{cls_q} (per-connection handler)", entries,
                    self_mhp=True)
        # callables escaping into a thread-spawning class's constructor
        # run on that class's thread (the MemWatch/Heartbeat sink shape)
        for ff in prog.files:
            mod = ff["module"]
            for tgt, ref, line in ff["races"]["escapes"]:
                canon = prog.canon_cls(tgt) if tgt in prog.classes \
                    else tgt
                kind = threaded.get(canon)
                if kind is None:
                    continue
                add(f'{ff["path"]}:{line}:{ref}', kind,
                    f"{ref} (escaped into {tgt})",
                    prog.resolve(ref, mod))
        return out

    # -- reachability -------------------------------------------------------

    def _callees(self, prog: _Program, fn: dict) -> list[dict]:
        mod = prog.module_of(fn)
        out = []
        for target, _l, _c, _h in fn["locks"].get("calls", ()):
            out.extend(prog.resolve(target, mod))
        return out

    def _reach(self, prog, roots) -> dict[int, list[_Root]]:
        """fn id -> roots whose call graph reaches it."""
        reach: dict[int, list[_Root]] = {}
        for root, entries in roots.values():
            seen: set[int] = set()
            stack = list(entries)
            while stack and len(seen) < _MAX_REACH:
                fn = stack.pop()
                if id(fn) in seen:
                    continue
                seen.add(id(fn))
                tags = reach.setdefault(id(fn), [])
                if root not in tags:
                    tags.append(root)
                stack.extend(self._callees(prog, fn))
        return reach

    def _main_reachable(self, prog, reach) -> set[int]:
        """Functions reachable from non-thread code: seeded by every
        function no root reaches, closed over call edges."""
        main: set[int] = set()
        stack = []
        for ff in prog.files:
            for fn in ff["functions"]:
                if fn.get("locks") and id(fn) not in reach:
                    main.add(id(fn))
                    stack.append(fn)
        while stack:
            fn = stack.pop()
            for g in self._callees(prog, fn):
                if id(g) not in main:
                    main.add(id(g))
                    stack.append(g)
        return main

    # -- lockset inheritance ------------------------------------------------

    def _inherited_locks(self, prog, roots) -> dict[int, frozenset]:
        """Locks held at EVERY known call site of a function
        (intersection, Eraser-style), so a helper called only under a
        lock judges its accesses as protected. Thread entries and
        escaped callables are pinned to the empty set — their foreign
        call sites hold nothing we can see."""
        sites: dict[int, list[tuple[dict, frozenset]]] = {}
        for ff in prog.files:
            mod = ff["module"]
            for fn in ff["functions"]:
                if not fn.get("locks"):
                    continue
                for target, _l, _c, held in fn["locks"]["calls"]:
                    hs = frozenset(prog.canon_lock(x) for x in held)
                    for g in prog.resolve(target, mod):
                        sites.setdefault(id(g), []).append((fn, hs))
        pinned: set[int] = set()
        for _root, entries in roots.values():
            pinned.update(id(e) for e in entries)
        for ff in prog.files:
            mod = ff["module"]
            for _tgt, ref, _line in ff["races"]["escapes"]:
                pinned.update(id(g) for g in prog.resolve(ref, mod))

        TOP = None
        inh: dict[int, frozenset | None] = {}
        for ff in prog.files:
            for fn in ff["functions"]:
                if not fn.get("locks"):
                    continue
                if id(fn) in pinned or id(fn) not in sites:
                    inh[id(fn)] = frozenset()
                else:
                    inh[id(fn)] = TOP
        for _pass in range(32):
            changed = False
            for fid, val in list(inh.items()):
                if fid in pinned or fid not in sites:
                    continue
                new: frozenset | None = TOP
                for caller, hs in sites[fid]:
                    ci = inh.get(id(caller), frozenset())
                    contrib = TOP if ci is TOP else hs | ci
                    if contrib is TOP:
                        continue
                    new = contrib if new is TOP else (new & contrib)
                if new != val:
                    inh[fid] = new
                    changed = True
            if not changed:
                break
        return {fid: (v if v is not None else frozenset())
                for fid, v in inh.items()}

    # -- TPM1601 ------------------------------------------------------------

    def _races(self, prog, roots, reach, main_set,
               inherited) -> Iterator[tuple]:
        events: dict[tuple, list] = {}
        for ff in prog.files:
            mod = ff["module"]
            for fn in ff["functions"]:
                lk = fn.get("locks")
                if not lk:
                    continue
                if fn["name"].rsplit(".", 1)[-1] in _INIT_METHODS:
                    continue  # runs before the object escapes
                sides: list = list(reach.get(id(fn), ()))
                if id(fn) in main_set:
                    sides.append("main")
                if not sides:
                    continue
                for rw, owner, name, line, col, held in lk["accesses"]:
                    if owner and not owner.startswith("@"):
                        canon = prog.canon_cls(f"{mod}.{owner}")
                        if name in prog.sync_attrs(canon):
                            continue
                        loc = (canon, name)
                    elif owner.startswith("@"):
                        loc = (owner[1:], name)
                    else:
                        loc = (mod, name)
                    locks = frozenset(
                        prog.canon_lock(x) for x in held
                    ) | inherited.get(id(fn), frozenset())
                    events.setdefault(loc, []).append(
                        (rw, fn, sides, locks, line, col, ff["path"])
                    )
        for loc in sorted(events, key=lambda L: (L[0], L[1])):
            evs = events[loc]
            pair = self._racy_pair(evs)
            if pair is None:
                continue
            anchor, other = pair  # anchor is always a write
            root = next((s for s in anchor[2] if s != "main"),
                        next((s for s in other[2] if s != "main"),
                             None))
            where = "a second thread running it" if other is anchor \
                else f"'{_fn_name(other[1])}'"
            yield (
                anchor[6], anchor[4], anchor[5], "TPM1601",
                f"unsynchronized access to {loc[0]}.{loc[1]}: "
                f"'{_fn_name(anchor[1])}' "
                f"({_lockstr(anchor[3])}) races {where} "
                f"({_lockstr(other[3])}) — both run concurrently "
                f"(e.g. via {root.label if root else 'a thread root'})"
                f" with no common lock; hold one shared lock on every "
                f"access, or suppress with a why-comment if ordering "
                f"makes it benign",
            )

    @staticmethod
    def _racy_pair(evs):
        """First (write, other) MHP pair with disjoint locksets, in a
        deterministic order: UNPROTECTED writes first (the anchor is
        where the missing lock goes), thread-side as the tiebreak,
        then line order."""
        def keyfn(e):
            thread_side = any(s != "main" for s in e[2])
            return (e[0] != "w", bool(e[3]), not thread_side,
                    e[6], e[4], e[5])

        ordered = sorted(evs, key=keyfn)
        for i, e1 in enumerate(ordered):
            for e2 in ordered[i:]:
                if e1[0] != "w" and e2[0] != "w":
                    continue
                if "?" in e1[3] or "?" in e2[3]:
                    continue
                if e1[3] & e2[3]:
                    continue
                if any(
                    _mhp(a, b)
                    for a in e1[2] for b in e2[2]
                ):
                    return (e1, e2) if e1[0] == "w" else (e2, e1)
        return None

    # -- TPM1602 ------------------------------------------------------------

    def _trans_acquires(self, prog, fn, memo, stack) -> frozenset:
        out, _clean = self._trans_acquires_ex(prog, fn, memo, stack)
        return out

    def _trans_acquires_ex(self, prog, fn, memo,
                           stack) -> tuple[frozenset, bool]:
        """``(locks, clean)``: clean results (no cycle truncation
        anywhere below) are memoized; a result computed with a cut
        back-edge is complete only for the TOP of the cycle, so caching
        it for an intermediate member would bake in an order-dependent
        false negative (code-review finding)."""
        if id(fn) in memo:
            return memo[id(fn)], True
        if id(fn) in stack:
            return frozenset(), False  # back-edge: truncated here
        stack = stack | {id(fn)}
        out = {
            prog.canon_lock(lid)
            for lid, _l, _c, _h in fn["locks"].get("acquires", ())
            if lid != "?"
        }
        clean = True
        for g in self._callees(prog, fn):
            sub, sub_clean = self._trans_acquires_ex(prog, g, memo,
                                                     stack)
            out |= sub
            clean = clean and sub_clean
        result = frozenset(out)
        if clean:
            memo[id(fn)] = result
        return result, clean

    def _deadlocks(self, prog, inherited) -> Iterator[tuple]:
        memo: dict[int, frozenset] = {}
        seen: set[tuple] = set()
        for ff in prog.files:
            mod = ff["module"]
            for fn in ff["functions"]:
                lk = fn.get("locks")
                if not lk:
                    continue
                inh = inherited.get(id(fn), frozenset())
                # direct nested re-acquire: `with L:` inside `with L:`
                for lid, line, col, outer in lk["acquires"]:
                    L = prog.canon_lock(lid)
                    held = {prog.canon_lock(x) for x in outer} | inh
                    if L in held and L != "?" \
                            and prog.lock_kind.get(L) == "lock":
                        key = (ff["path"], line, L)
                        if key not in seen:
                            seen.add(key)
                            yield (ff["path"], line, col, "TPM1602",
                                   f"re-acquiring non-reentrant lock "
                                   f"{L} already held here — "
                                   f"guaranteed self-deadlock; use an "
                                   f"RLock or restructure so the lock "
                                   f"is taken once")
                for target, line, col, held in lk["calls"]:
                    hs = {prog.canon_lock(x) for x in held} | inh
                    hs.discard("?")
                    if not hs:
                        continue
                    for g in prog.resolve(target, mod):
                        re_acq = hs & self._trans_acquires(
                            prog, g, memo, frozenset()
                        )
                        for L in sorted(re_acq):
                            if prog.lock_kind.get(L) != "lock":
                                continue
                            key = (ff["path"], line, L)
                            if key in seen:
                                continue
                            seen.add(key)
                            yield (
                                ff["path"], line, col, "TPM1602",
                                f"call to '{target}' while holding "
                                f"{L}: its call graph re-acquires the "
                                f"same non-reentrant lock — "
                                f"self-deadlock (the attach_metrics "
                                f"shape); move the call outside the "
                                f"locked region or make the lock an "
                                f"RLock",
                            )

    # -- TPM1603 ------------------------------------------------------------

    def _slot_rebinds(self, prog) -> Iterator[tuple]:
        read_slots = {
            slot
            for ff in prog.files
            for slot, _line in ff["races"]["slot_reads"]
        }
        for ff in prog.files:
            writes = ff["races"]["slot_writes"]
            disarmed = {
                (mod, name)
                for mod, name, vkind, _l, _c, scope in writes
                if scope == "func" and vkind == "none"
            }
            for mod, name, vkind, line, col, scope in writes:
                if scope != "func" or vkind not in ("call", "func"):
                    continue
                if (mod, name) in disarmed:
                    continue
                if f"{mod}.{name}" not in read_slots:
                    continue
                yield (
                    ff["path"], line, col, "TPM1603",
                    f"hook slot {mod}.{name} rebound to a live "
                    f"callable with no matching `= None` disarm in "
                    f"this file — a reader thread sees the stale hook "
                    f"forever (the chaos arm()/disarm() idiom is the "
                    f"sanctioned shape: install and uninstall in the "
                    f"same layer)",
                )


def _fn_name(fn: dict) -> str:
    return fn["name"]


def _lockstr(locks: frozenset) -> str:
    if not locks:
        return "no locks held"
    short = sorted(x.split("::")[-1] if "::" in x else x
                   for x in locks)
    return "holding " + ", ".join(short)
