"""The port's collective-protocol verifier (≅
``tpu_mpi_tests/analysis/protocol.py``).

Compiles the whole program into a **collective schedule automaton** and
checks it two ways:

* **statically** (:class:`ProtocolIndex`): every function's ``proto``
  event tree (:mod:`tpu_mpi_tests_torch.analysis.program`) is summarized
  bottom-up into a regular schedule (ordered collective/broadcast events
  with ``loop``/``alt``/``try`` structure, calls expanded through the
  project summaries). Rank-feasible path pairs must emit matching
  sequences:

  - **TPM1701**: rank-divergent whole-program schedule, through the
    broadcast-class events (``fleet.bcast``, ``dist.broadcast``, which
    TPM1101's alphabet leaves out) or a branch on the *return value* of
    a rank-returning function;
  - **TPM1702**: a loop whose trip count derives from a rank-dependent
    value encloses a collective;
  - **TPM1703**: a ``try`` whose body calls collectives has a
    non-exiting handler with a different collective sequence: the rank
    that catches skips its partner op while the rest block in it.

* **against reality** (:func:`conform_paths`, ``--conform``): the
  per-function trees are lowered into one NFA over runtime
  ``(op, axis)`` span events. The runtime alphabet comes from the
  telemetry emitters themselves (a ``comm_span("allreduce", ...)``
  inside a wrapper is the exact op its ``kind:"span"`` record carries).
  Dynamically-named spans become skippable wildcard edges; method calls
  that name resolution cannot see fall back to every project function
  with that final name. Replaying the port's ``seq``-stamped span
  streams (``instrument/telemetry.py``), one file a rank (the ``.p<i>``
  rank-set expansion), yields:

  - **TPM1704**: a runtime (op, axis) sequence no static path generates;
  - **TPM1705**: a rank's stream ends while a sibling emitted the
    statically-expected next collective.

  Streams with no ``seq`` stamps degrade to a visible NOTE, never a
  conviction.

The stream loader is the stdlib-only one of the port's trace merge
(:mod:`tpu_mpi_tests_torch.instrument.timeline`). Stdlib-only by
contract, like the rest of the analysis package.
"""

from __future__ import annotations

from pathlib import Path

from tpu_mpi_tests_torch.analysis.core import Finding, ProjectContext
from tpu_mpi_tests_torch.analysis.program import _MAX_DEPTH
from tpu_mpi_tests_torch.instrument.timeline import (
    expand_rank_files,
    load_with_lines,
)

#: hard ceilings keeping the summaries/NFA bounded on adversarial input
_MAX_SUMMARY_DEPTH = 4 * _MAX_DEPTH  # tpumt: ignore[TPM701]
_MAX_CHA_CANDIDATES = 12
_MAX_RESOLVE_ALTS = 6


def _flatten(seq: tuple, depth: int = 0, limit: int = 12) -> list[str]:
    """Human-renderable op list for a summary: loops as ``op*``,
    unresolved alternatives as ``(a|b)``."""
    out: list[str] = []
    if depth > 4:
        return ["…"]
    for el in seq:
        if len(out) >= limit:
            out.append("…")
            break
        if el[0] == "ev":
            out.append(el[1])
        elif el[0] == "loop":
            inner = _flatten(el[1], depth + 1, 4)
            out.append("(" + " ".join(inner) + ")*")
        elif el[0] == "alt":
            a = " ".join(_flatten(el[1], depth + 1, 4))
            b = " ".join(_flatten(el[2], depth + 1, 4))
            out.append(f"({a or '—'}|{b or '—'})")
        elif el[0] == "try":
            out.extend(_flatten(el[1], depth + 1, 4))
    return out


def _render(seq: tuple) -> str:
    ops = _flatten(_norm(seq))
    return "[" + (", ".join(ops) if ops else "—") + "]"


def _proj(seq: tuple, core: bool) -> tuple:
    """Normalize a summary: prune event-free structure (an ``alt`` with
    nothing on either side is control flow, not schedule), collapse
    alternatives whose projections agree, and — with ``core=True`` —
    keep only the TPM11xx core-collective alphabet, the guard that
    keeps a divergence already owned by TPM1101/1102 from
    double-convicting as TPM1701."""
    out: list = []
    for el in seq:
        if el[0] == "ev":
            if el[2] or not core:
                out.append(el)
        elif el[0] == "loop":
            sub = _proj(el[1], core)
            if sub:
                out.append(("loop", sub))
        elif el[0] == "alt":
            a, b = _proj(el[1], core), _proj(el[2], core)
            if a == b:
                out.extend(a)
            elif a or b:
                out.append(("alt", a, b))
        elif el[0] == "try":
            a = _proj(el[1], core)
            hs = tuple(_proj(h, core) for h in el[2])
            if all(h == a for h in hs):
                out.extend(a)
            elif a or any(hs):
                out.append(("try", a, hs))
    return tuple(out)


def _core_proj(seq: tuple) -> tuple:
    return _proj(seq, core=True)


def _norm(seq: tuple) -> tuple:
    return _proj(seq, core=False)


def _has_ev(seq: tuple) -> bool:
    for el in seq:
        if el[0] == "ev":
            return True
        if el[0] == "loop" and _has_ev(el[1]):
            return True
        if el[0] == "alt" and (_has_ev(el[1]) or _has_ev(el[2])):
            return True
        if el[0] == "try" and (_has_ev(el[1])
                               or any(_has_ev(h) for h in el[2])):
            return True
    return False


class ProtocolIndex:
    """Whole-program schedule summaries + the TPM1701/1702/1703 checks.

    Each function's ``proto`` tree is summarized exactly once
    (memoized), findings recorded during that first walk — so a callee
    shared by many entry points is judged once, anchored in its own
    file. Branch summaries are composed with their *continuation* (the
    summary of everything after the branch, built right-to-left in one
    linear pass), which is what lets a rank-guarded early ``return``
    before a broadcast diverge even though both arms are locally
    event-free."""

    def __init__(self, proj: ProjectContext):
        self.index = proj.index
        self._path_of: dict[int, str] = {}
        self._fns: list[dict] = []
        for ff in proj.facts:
            for fn in ff["functions"]:
                self._path_of[id(fn)] = ff["path"]
                self._fns.append(fn)
        self._sum_memo: dict[int, tuple | None] = {}
        self._rank_memo: dict[int, bool] = {}
        self._depth = 0
        self.findings: list[tuple] = []

    # -- rank-returning taint ----------------------------------------------

    def rank_returning(self, fn: dict) -> bool:
        """Does this function return the process rank — directly
        (``return dist.get_rank()``) or through a returning helper?"""
        key = id(fn)
        if key in self._rank_memo:
            return self._rank_memo[key]
        self._rank_memo[key] = False  # cycle guard
        val = bool(fn.get("rank_ret"))
        if not val:
            mod = self.index._module_of(fn)
            for target in fn.get("return_targets") or []:
                if any(self.rank_returning(g)
                       for g in self.index.resolve_funcs(target, mod)):
                    val = True
                    break
        self._rank_memo[key] = val
        return val

    def _taint_hit(self, taints: list, module: str) -> str | None:
        for canon in taints or []:
            for g in self.index.resolve_funcs(canon, module):
                if self.rank_returning(g):
                    return canon
        return None

    # -- summaries ----------------------------------------------------------

    def fn_summary(self, fn: dict) -> tuple:
        key = id(fn)
        if key in self._sum_memo:
            return self._sum_memo[key] or ()
        self._sum_memo[key] = None  # in-progress: recursion reads ()
        seq = ()
        if self._depth <= _MAX_SUMMARY_DEPTH:
            self._depth += 1
            try:
                seq, _term = self._summ(fn.get("proto") or [], fn)
            finally:
                self._depth -= 1
        self._sum_memo[key] = seq
        return seq

    def _summ(self, nodes: list, fn: dict) -> tuple[tuple, bool]:
        mod = self.index._module_of(fn)
        cur: tuple = ()
        term = False
        for node in reversed(nodes):
            k = node[0]
            if k == "exit":
                cur, term = (), True
            elif k == "span":
                continue  # runtime-only alphabet: the NFA's, not ours
            elif k == "coll":
                _k, op, _canon, _line, core = node
                cur = (("ev", op, core),) + cur
            elif k == "call":
                funcs = self.index.resolve_funcs(node[1], mod)
                if funcs:
                    cur = self.fn_summary(funcs[0]) + cur
            elif k == "loop":
                _k, line, rk, taints, body = node
                bseq, _bt = self._summ(body, fn)
                tcanon = None if rk else self._taint_hit(taints, mod)
                if (rk or tcanon) and _has_ev(bseq):
                    self._emit_1702(fn, line, tcanon, bseq)
                if bseq:
                    cur = (("loop", bseq),) + cur
            elif k == "alt":
                _k, line, col, rk, taints, then, orelse = node
                tseq, tterm = self._summ(then, fn)
                eseq, eterm = self._summ(orelse, fn)
                full_t = tseq if tterm else tseq + cur
                full_e = eseq if eterm else eseq + cur
                ft = tterm or term
                fe = eterm or term
                tcanon = None if rk else self._taint_hit(taints, mod)
                if rk or tcanon:
                    self._check_alt(fn, line, col, rk, tcanon,
                                    full_t, full_e)
                if full_t == full_e and ft == fe:
                    cur, term = full_t, ft
                else:
                    cur, term = (("alt", full_t, full_e),), ft and fe
            elif k == "try":
                _k, line, body, handlers = node
                bseq, _bt = self._summ(body, fn)
                hsums = []
                for h_term, h_nodes in handlers:
                    hseq, hterm2 = self._summ(h_nodes, fn)
                    hsums.append((bool(h_term) or hterm2, hseq))
                self._check_try(fn, line, bseq, hsums)
                hseqs = tuple(h for _t, h in hsums)
                if all(h == bseq for h in hseqs):
                    cur = bseq + cur
                elif bseq or any(hseqs):
                    cur = (("try", bseq, hseqs),) + cur
        return cur, term

    # -- the static convictions --------------------------------------------

    def _emit(self, fn: dict, line: int, col: int, code: str,
              msg: str) -> None:
        self.findings.append(
            (self._path_of.get(id(fn), "?"), line, col, code, msg)
        )

    def _check_alt(self, fn: dict, line: int, col: int, rk: int,
                   tcanon: str | None, full_t: tuple,
                   full_e: tuple) -> None:
        full_t, full_e = _norm(full_t), _norm(full_e)
        if full_t == full_e:
            return
        if rk and _core_proj(full_t) != _core_proj(full_e):
            return  # TPM1101/TPM1102 own the core-alphabet divergence
        via = (
            f"branch tests the return value of {tcanon} (a "
            f"rank-returning function — the taint channel no lexical "
            f"rank test reveals)" if tcanon else
            "divergence is in the broadcast-class events TPM1101's "
            "alphabet deliberately excludes"
        )
        self._emit(
            fn, line, col, "TPM1701",
            f"rank-divergent whole-program schedule: the composed "
            f"schedule is {_render(full_t)} on the guarded path vs "
            f"{_render(full_e)} on the other — {via}; ranks that skip "
            f"a replication/collective point the rest enter hang the "
            f"fleet. Hoist the op out of the rank-dependent region "
            f"(or broadcast the deciding value first)",
        )

    def _emit_1702(self, fn: dict, line: int, tcanon: str | None,
                   bseq: tuple) -> None:
        via = (f"trip count tainted by {tcanon} (rank-returning)"
               if tcanon else "trip count is a function of the rank")
        self._emit(
            fn, line, 0, "TPM1702",
            f"rank-dependent loop bound encloses collective schedule "
            f"{_render(bseq)} — {via}; ranks agree on every op but "
            f"execute different trip counts, so some rank enters an "
            f"iteration its partners never will (the divergent-loop "
            f"deadlock). Derive the bound from a replicated value",
        )

    def _check_try(self, fn: dict, line: int, bseq: tuple,
                   hsums: list[tuple[bool, tuple]]) -> None:
        core_b = _core_proj(bseq)
        for h_term, hseq in hsums:
            if h_term:
                continue  # re-raise/return: the sanctioned abort shape
            core_h = _core_proj(hseq)
            if core_h == core_b or not (core_b or core_h):
                continue
            self._emit(
                fn, line, 0, "TPM1703",
                f"collective schedule {_render(bseq)} is reachable "
                f"under an exception path whose surviving handler "
                f"continues with {_render(hseq)} — the rank that "
                f"catches skips a partner op the other ranks block "
                f"in. Re-raise (or return) from the handler, or move "
                f"the collective out of the try body",
            )
            return  # one conviction per try statement

    # -- driver -------------------------------------------------------------

    def check_all(self) -> list[tuple]:
        for fn in self._fns:
            self.fn_summary(fn)
        self.findings.sort()
        return self.findings


# ---------------------------------------------------------------------------
# the runtime-facing NFA (``--conform``)


class ScheduleAutomaton:
    """One NFA over runtime ``(op, axis)`` span events for the whole
    program: every function contributes a shared fragment (call edges
    are ε-jumps into the callee fragment and back — context-insensitive
    returns over-approximate, which only ever makes the model MORE
    permissive, the safe direction for conformance). The union start
    state ε-reaches every function, so any entry point's schedule is in
    the language."""

    def __init__(self, proj: ProjectContext):
        self.index = proj.index
        self._eps: dict[int, set[int]] = {}
        self._edges: dict[int, list[tuple]] = {}
        self._frag: dict[int, tuple[int, int]] = {}
        self._n = 0
        self.modeled_ops: set[str] = set()
        # CHA fallback: final-name → candidate functions (method calls
        # through objects resolve by suffix, conformance-only)
        self._by_last: dict[str, list[dict]] = {}
        fns: list[dict] = []
        for ff in proj.facts:
            for fn in ff["functions"]:
                fns.append(fn)
                last = fn["name"].rsplit(".", 1)[-1]
                self._by_last.setdefault(last, []).append(fn)
        self._step_memo: dict[tuple, frozenset] = {}
        self.start = self._new()
        for fn in fns:
            en, _ex = self._fn_frag(fn)
            self._ep(self.start, en)

    # -- construction -------------------------------------------------------

    def _new(self) -> int:
        self._n += 1
        return self._n

    def _ep(self, a: int, b: int) -> None:
        self._eps.setdefault(a, set()).add(b)

    def _edge(self, a: int, op: str | None, axis: str | None,
              b: int) -> None:
        self._edges.setdefault(a, []).append((op, axis, b))

    def _fn_frag(self, fn: dict) -> tuple[int, int]:
        key = id(fn)
        if key in self._frag:
            return self._frag[key]
        en, ex = self._new(), self._new()
        self._frag[key] = (en, ex)  # pre-registered: recursion closes
        end = self._build(fn.get("proto") or [], en, fn, ex)
        self._ep(end, ex)
        return en, ex

    def _callees(self, canon: str, module: str) -> tuple[list[dict], bool]:
        funcs = self.index.resolve_funcs(canon, module)
        if funcs:
            return funcs[:_MAX_RESOLVE_ALTS], False
        last = canon.rsplit(".", 1)[-1]
        if "." in canon and last:
            cands = self._by_last.get(last, [])
            if 0 < len(cands) <= _MAX_CHA_CANDIDATES:
                return cands, True
        return [], False

    def _build(self, nodes: list, cur: int, fn: dict,
               fn_exit: int) -> int:
        mod = self.index._module_of(fn)
        for node in nodes:
            k = node[0]
            if k == "exit":
                self._ep(cur, fn_exit)
                cur = self._new()  # unreachable continuation
            elif k == "span":
                _k, op, axis, _line = node
                nxt = self._new()
                self._edge(cur, op, axis, nxt)
                if op is None:
                    # dynamically-named span: may also be projected out
                    # of the stream as unmodeled — make it skippable
                    self._ep(cur, nxt)
                else:
                    self.modeled_ops.add(op)
                cur = nxt
            elif k in ("coll", "call"):
                canon = node[2] if k == "coll" else node[1]
                funcs, via_cha = self._callees(canon or "", mod)
                nxt = self._new()
                if not funcs or via_cha:
                    # unresolved (torch.distributed calls emit no spans)
                    # or heuristic candidates: never mandatory
                    self._ep(cur, nxt)
                for g in funcs:
                    ge, gx = self._fn_frag(g)
                    self._ep(cur, ge)
                    self._ep(gx, nxt)
                cur = nxt
            elif k == "loop":
                body = node[4]
                en = self._new()
                self._ep(cur, en)
                end = self._build(body, en, fn, fn_exit)
                self._ep(end, en)  # next iteration
                nxt = self._new()
                self._ep(en, nxt)  # zero or n iterations
                cur = nxt
            elif k == "alt":
                then, orelse = node[5], node[6]
                nxt = self._new()
                for branch in (then, orelse):
                    bs = self._new()
                    self._ep(cur, bs)
                    be = self._build(branch, bs, fn, fn_exit)
                    self._ep(be, nxt)
                cur = nxt
            elif k == "try":
                body, handlers = node[2], node[3]
                bs = self._new()
                self._ep(cur, bs)
                be = self._build(body, bs, fn, fn_exit)
                nxt = self._new()
                self._ep(be, nxt)
                for _term, h_nodes in handlers:
                    hs = self._new()
                    self._ep(cur, hs)  # raise before any event
                    self._ep(be, hs)   # raise after the body's events
                    he = self._build(h_nodes, hs, fn, fn_exit)
                    self._ep(he, nxt)
                cur = nxt
        return cur

    # -- simulation ---------------------------------------------------------

    def closure(self, states: set[int]) -> frozenset:
        out = set(states)
        work = list(states)
        while work:
            s = work.pop()
            for t in self._eps.get(s, ()):
                if t not in out:
                    out.add(t)
                    work.append(t)
        return frozenset(out)

    def step(self, states: frozenset, op: str,
             axis: str | None) -> frozenset:
        # memoized: a stream repeats a few (op, axis) events thousands of
        # times, so the simulation revisits the same state sets
        key = (states, op, axis)
        got = self._step_memo.get(key)
        if got is None:
            got = self._step_memo[key] = self._step(states, op, axis)
        return got

    def _step(self, states: frozenset, op: str,
              axis: str | None) -> frozenset:
        out: set[int] = set()
        for s in states:
            for eop, eaxis, dst in self._edges.get(s, ()):
                if eop is not None and eop != op:
                    continue
                if eop is not None and eaxis is not None \
                        and axis is not None and eaxis != axis:
                    continue
                out.add(dst)
        return self.closure(out)

    def expected(self, states: frozenset) -> list[str]:
        ops = {eop for s in states
               for eop, _ax, _d in self._edges.get(s, ()) if eop}
        return sorted(ops)


# ---------------------------------------------------------------------------
# conformance replay (``--conform``)


class _Sim:
    __slots__ = ("rank", "path", "events", "ok", "final", "matched",
                 "last_line")

    def __init__(self, rank, path, events):
        self.rank = rank
        self.path = path
        self.events = events  # [(op, axis, line, seq)]
        self.ok = False
        self.final: frozenset = frozenset()
        self.matched = 0
        self.last_line = events[-1][2] if events else 1


def _newest_segment(
    records: list[tuple[int, dict]],
) -> list[tuple[int, dict]]:
    """An append-mode JSONL holds several runs back to back, each
    starting with its manifest: the newest run's ``(line, record)``
    pairs."""
    segments: list[list[tuple[int, dict]]] = [[]]
    for ln, rec in records:
        if rec.get("kind") == "manifest" and segments[-1]:
            segments.append([])
        segments[-1].append((ln, rec))
    return segments[-1]


def _stream_events(pairs, auto: ScheduleAutomaton):
    """(rank|None, span records, modeled events) for one file's newest
    run segment."""
    seg = _newest_segment(pairs)
    mrank = None
    for _ln, rec in seg:
        if rec.get("kind") == "manifest":
            mrank = rec.get("process_index")
            break
    spans = [(ln, r) for ln, r in seg
             if r.get("kind") == "span" and r.get("op")]
    events = [(r["op"], r.get("axis"), ln, r.get("seq"))
              for ln, r in spans if r["op"] in auto.modeled_ops]
    return mrank, spans, events


def _rank_from_name(path: str) -> int | None:
    stem = Path(path).name
    if ".p" in stem:
        tail = stem.rsplit(".p", 1)[1].split(".")[0]
        if tail.isdigit():
            return int(tail)
    return None


def conform_paths(jsonl_paths, proj: ProjectContext,
                  ) -> tuple[list[Finding], list[str]]:
    """Replay telemetry streams against the schedule automaton.

    Returns ``(findings, notes)``: TPM1704/TPM1705 findings anchored at
    ``<jsonl>:<line>`` plus the human NOTE lines (insufficient stamps,
    unmodeled ops skipped, asymmetries the automaton cannot convict).
    """
    auto = ScheduleAutomaton(proj)
    findings: list[Finding] = []
    notes: list[str] = []
    sims: list[_Sim] = []

    files = [str(p) for p in expand_rank_files([str(p)
                                                for p in jsonl_paths])]
    for idx, path in enumerate(files):
        pairs = load_with_lines(path, "tpu_mpi_tests_torch.analysis")
        mrank, spans, events = _stream_events(pairs, auto)
        named = _rank_from_name(path) if mrank is None else mrank
        rank = idx if named is None else named
        if not spans:
            notes.append(f"{path}: no span records in the newest run "
                         f"segment — nothing to conform")
            continue
        if not any("seq" in r for _ln, r in spans):
            notes.append(
                f"{path}: insufficient stamps — no span carries the "
                f"per-(op, axis) seq counter (pre-seq telemetry); "
                f"stream skipped, never convicted"
            )
            continue
        skipped = len(spans) - len(events)
        if skipped:
            notes.append(
                f"{path}: {skipped} span(s) with dynamically-named ops "
                f"outside the static model skipped"
            )
        sims.append(_Sim(rank, path, events))

    for sim in sims:
        states = auto.closure({auto.start})
        stuck = None
        for op, axis, ln, seq in sim.events:
            nxt = auto.step(states, op, axis)
            if not nxt:
                stuck = (op, axis, ln, seq)
                break
            states = nxt
            sim.matched += 1
        if stuck is not None:
            op, axis, ln, seq = stuck
            exp = auto.expected(states)
            findings.append(Finding(
                sim.path, ln, 0, "TPM1704",
                f"rank {sim.rank} emitted a collective sequence no "
                f"static path generates: after {sim.matched} matched "
                f"event(s), span op={op!r} axis={axis!r} seq={seq} "
                f"diverges from the schedule automaton (expected next: "
                f"{', '.join(exp[:6]) or 'none'}) — stale model or a "
                f"dynamic-dispatch blind spot; re-lint, or teach the "
                f"protocol layer the new dispatch shape",
            ))
        else:
            sim.ok = True
            sim.final = states

    oks = [s for s in sims if s.ok]
    for a in oks:
        for b in oks:
            if a is b or len(a.events) >= len(b.events):
                continue
            ea = [(op, ax) for op, ax, _ln, _sq in a.events]
            eb = [(op, ax) for op, ax, _ln, _sq in b.events]
            if eb[:len(ea)] != ea:
                i = next(j for j in range(len(ea))
                         if ea[j] != eb[j])
                notes.append(
                    f"{a.path}: rank {a.rank} and rank {b.rank} "
                    f"diverge mid-stream at event {i} "
                    f"({ea[i][0]} vs {eb[i][0]}) with both streams "
                    f"individually generable — runtime asymmetry is "
                    f"a runtime diagnosis, not a static conviction"
                )
                continue
            op, ax = eb[len(ea)]
            bln = b.events[len(ea)][2]
            exp = auto.expected(a.final)
            if op in exp:
                exp = [op] + [e for e in exp if e != op]
            if auto.step(a.final, op, ax):
                findings.append(Finding(
                    a.path, a.last_line, 0, "TPM1705",
                    f"rank {a.rank} stream ends after "
                    f"{len(ea)} event(s) with a statically mandatory "
                    f"collective un-emitted: sibling rank {b.rank} "
                    f"emitted op={op!r} axis={ax!r} next "
                    f"({b.path}:{bln}), and the automaton expects it "
                    f"from rank {a.rank}'s state "
                    f"({len(a.final)} state(s); expected next: "
                    f"{', '.join(exp[:6])}) — the "
                    f"static twin of a missing-rank diagnosis",
                ))
                break  # one conviction per short rank
            notes.append(
                f"{a.path}: rank {a.rank} stopped {len(eb) - len(ea)} "
                f"event(s) short of rank {b.rank}, but the automaton "
                f"cannot place {op!r} from its state — no conviction"
            )
    findings.sort()
    return findings, notes
