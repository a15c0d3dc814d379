"""Per-function control-flow graphs for the flow-sensitive analyses
(≅ ``tpu_mpi_tests/analysis/cfg.py``).

A lexical branch summary carries the events of an ``if``'s two statement
lists and nothing else, so a ``return`` inside a rank guard is
invisible: the events after the branch are attributed to both paths even
when one of them has already left the function (``if rank != 0:
return`` before a collective).

This module builds a small, conservative CFG per function body:

* **Blocks** hold straight-line *units* — simple statements plus the
  branch/loop test expressions — in document order. Compound statements
  (``if``/``for``/``while``/``with``/``try``/``match``) are decomposed
  into blocks and edges; nested ``def``/``lambda`` bodies are other
  scopes and contribute nothing.
* **Edges** model fallthrough, branch splits/joins, loop back-edges
  (marked, so forward traversals unroll each loop once), ``break`` /
  ``continue``, and ``return``/``raise`` exits to the synthetic exit
  block.
* **Branches** record, for every ``if``, the two path entry blocks and
  whether each side's straight-line flow *terminates* (cannot fall
  through to the join) — the "early exit" bit TPM1102 keys on.
* **With regions** record, for every ``with`` statement, the
  set of blocks its body occupies. A ``with`` opens a fresh block and
  closes into a fresh block, so region membership is whole-block — the
  lockset layer (:mod:`tpu_mpi_tests_torch.analysis.locks`) maps each
  statement's held-lock set straight off the blocks that contain it,
  nested regions unioning naturally.

Approximations: exception
edges are not modeled — ``except`` handler bodies fork from the block
*before* the ``try`` and rejoin after it, ``finally`` runs on the
fallthrough path only, and a ``raise`` always exits the function even
when an enclosing handler would catch it. Loop ``else`` clauses run on
the fallthrough path. These keep the graph linear in the function size
while staying truthful for the SPMD shapes the rules judge.

Stdlib-only by contract, like the rest of the analysis package.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field


class Block:
    """Straight-line code: ``units`` are simple statements and test/iter
    expressions, in document order; ``succs`` are ``(block, is_back)``
    edges."""

    __slots__ = ("idx", "units", "succs")

    def __init__(self, idx: int):
        self.idx = idx
        self.units: list[ast.AST] = []
        self.succs: list[tuple["Block", bool]] = []

    def __repr__(self) -> str:  # debug aid only
        return f"<Block {self.idx} units={len(self.units)} " \
               f"succs={[s.idx for s, _ in self.succs]}>"


@dataclass
class Branch:
    """One ``if`` statement as seen by the CFG: the path entry blocks
    plus the early-exit bits. ``else_entry`` is the join block when the
    ``if`` has no ``else``."""

    node: ast.If
    then_entry: Block
    else_entry: Block
    then_exits: bool
    else_exits: bool


@dataclass
class WithRegion:
    """One ``with`` statement: its ``withitem`` context expressions and
    the block indices its body occupies (nested compounds included)."""

    node: ast.With | ast.AsyncWith
    blocks: frozenset[int]


@dataclass
class CFG:
    entry: Block
    exit: Block
    blocks: list[Block] = field(default_factory=list)
    branches: list[Branch] = field(default_factory=list)
    with_regions: list[WithRegion] = field(default_factory=list)

    def reachable(self, start: Block) -> list[Block]:
        """Blocks reachable from ``start`` (inclusive) following FORWARD
        edges only — back edges are cut, so each loop contributes its
        body once. Returned in block-creation order, which tracks
        document order closely enough for stable event sequences."""
        seen: set[int] = set()
        stack = [start]
        while stack:
            b = stack.pop()
            if b.idx in seen:
                continue
            seen.add(b.idx)
            for s, back in b.succs:
                if not back and s.idx not in seen:
                    stack.append(s)
        return sorted(
            (b for b in self.blocks if b.idx in seen),
            key=lambda b: b.idx,
        )


class _Assembler:
    def __init__(self) -> None:
        self.blocks: list[Block] = []
        self.exit = self._new()
        self.cur: Block | None = self._new()
        self.entry = self.cur
        self.branches: list[Branch] = []
        self.with_regions: list[WithRegion] = []
        # innermost-first (header, after) targets for continue/break
        self.loops: list[tuple[Block, Block]] = []

    def _new(self) -> Block:
        b = Block(len(self.blocks))
        self.blocks.append(b)
        return b

    @staticmethod
    def _edge(a: Block, b: Block, back: bool = False) -> None:
        a.succs.append((b, back))

    def _live(self) -> Block:
        """Current block, reviving flow into an unreachable block after
        a terminator (dead code still gets parsed, never linked)."""
        if self.cur is None:
            self.cur = self._new()
        return self.cur

    # -- statement dispatch -------------------------------------------------

    def build_stmts(self, stmts: list[ast.stmt]) -> None:
        for s in stmts:
            self.stmt(s)

    def stmt(self, s: ast.stmt) -> None:
        if isinstance(s, ast.If):
            self._if(s)
        elif isinstance(s, (ast.For, ast.AsyncFor, ast.While)):
            self._loop(s)
        elif isinstance(s, (ast.With, ast.AsyncWith)):
            self._with(s)
        elif isinstance(s, ast.Try) or (
            hasattr(ast, "TryStar") and isinstance(s, ast.TryStar)
        ):
            self._try(s)
        elif isinstance(s, ast.Match):
            self._match(s)
        elif isinstance(s, (ast.Return, ast.Raise)):
            cur = self._live()
            cur.units.append(s)  # the value/exc expression still runs
            self._edge(cur, self.exit)
            self.cur = None
        elif isinstance(s, ast.Break):
            if self.loops:
                self._edge(self._live(), self.loops[-1][1])
                self.cur = None
        elif isinstance(s, ast.Continue):
            if self.loops:
                cur = self._live()
                self._edge(cur, self.loops[-1][0], back=True)
                # the loop eventually exits: post-loop code IS on this
                # path's way to the function exit (forward edge, so a
                # back-edge-cutting traversal still sees it)
                self._edge(cur, self.loops[-1][1])
                self.cur = None
        elif isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
            pass  # another scope; its body never runs here
        else:
            # Assign/Expr/ClassDef/Assert/... — straight-line units
            self._live().units.append(s)

    # -- compound statements ------------------------------------------------

    def _with(self, s: ast.With | ast.AsyncWith) -> None:
        # the context expressions evaluate BEFORE the region is entered
        # (a lock is not yet held while its name is being resolved)
        cur = self._live()
        for item in s.items:
            cur.units.append(item.context_expr)
        body_entry = self._new()
        self._edge(cur, body_entry)
        self.cur = body_entry
        start = body_entry.idx
        self.build_stmts(s.body)
        # every block registered while the body was being built belongs
        # to the region — nested compounds (branches, loops, inner
        # withs) allocate theirs inside this window, so membership is
        # closed under nesting by construction
        region = frozenset(range(start, len(self.blocks)))
        if self.cur is not None:
            # a body that fell through continues after the with; a body
            # that terminated (return/raise) must leave flow DEAD, or a
            # with-wrapped early exit would read as falling through and
            # the TPM1102/TPM1301 exit bits would miss it
            after = self._new()
            self._edge(self.cur, after)
            self.cur = after
        self.with_regions.append(WithRegion(node=s, blocks=region))

    def _if(self, s: ast.If) -> None:
        cond = self._live()
        cond.units.append(s.test)
        then_entry = self._new()
        self._edge(cond, then_entry)
        self.cur = then_entry
        self.build_stmts(s.body)
        then_end = self.cur
        else_entry = else_end = None
        if s.orelse:
            else_entry = self._new()
            self._edge(cond, else_entry)
            self.cur = else_entry
            self.build_stmts(s.orelse)
            else_end = self.cur
        join = self._new()
        if then_end is not None:
            self._edge(then_end, join)
        if s.orelse:
            if else_end is not None:
                self._edge(else_end, join)
        else:
            self._edge(cond, join)
        self.branches.append(Branch(
            node=s,
            then_entry=then_entry,
            else_entry=else_entry if else_entry is not None else join,
            then_exits=then_end is None,
            else_exits=bool(s.orelse) and else_end is None,
        ))
        self.cur = join

    def _loop(self, s: ast.For | ast.AsyncFor | ast.While) -> None:
        header = self._new()
        self._edge(self._live(), header)
        header.units.append(
            s.test if isinstance(s, ast.While) else s.iter
        )
        # the after-block must NUMBER after the body blocks (reachable()
        # orders events by block idx — an early idx would emit post-loop
        # events before the loop body's), but break targets need the
        # OBJECT now: allocate unregistered, register post-body
        after = Block(-1)
        self.loops.append((header, after))
        body_entry = self._new()
        self._edge(header, body_entry)
        self.cur = body_entry
        self.build_stmts(s.body)
        if self.cur is not None:
            self._edge(self.cur, header, back=True)
            # fall-through also reaches post-loop code on its way to
            # the exit: without this forward edge, a traversal from a
            # branch inside the body could never see the code after
            # the loop (the back edge is cut), missing exactly the
            # early-exit-in-loop deadlock shape
            self._edge(self.cur, after)
        self.loops.pop()
        after.idx = len(self.blocks)
        self.blocks.append(after)
        self._edge(header, after)  # zero-iteration / normal exit
        self.cur = after
        if s.orelse:  # runs on the fallthrough path (approximation)
            self.build_stmts(s.orelse)

    def _try(self, s) -> None:
        pre = self._live()
        self.build_stmts(s.body)
        if self.cur is not None and s.orelse:
            self.build_stmts(s.orelse)
        ends: list[Block] = []
        if self.cur is not None:
            ends.append(self.cur)
        for h in s.handlers:
            hb = self._new()
            # exceptions fork before the try body completes; forking
            # from the pre-try block is the conservative stand-in
            self._edge(pre, hb)
            self.cur = hb
            self.build_stmts(h.body)
            if self.cur is not None:
                ends.append(self.cur)
        join = self._new()
        for e in ends:
            self._edge(e, join)
        self.cur = join if ends else None
        if s.finalbody:
            # fallthrough-path approximation; a terminated try/except
            # still runs finally, so revive flow for it
            self._live()
            self.build_stmts(s.finalbody)

    def _match(self, s: ast.Match) -> None:
        cond = self._live()
        cond.units.append(s.subject)
        ends: list[Block] = []
        for case in s.cases:
            cb = self._new()
            self._edge(cond, cb)
            self.cur = cb
            self.build_stmts(case.body)
            if self.cur is not None:
                ends.append(self.cur)
        join = self._new()
        self._edge(cond, join)  # no case matched
        for e in ends:
            self._edge(e, join)
        self.cur = join


def build(node: ast.AST) -> CFG:
    """CFG over a function def's own body (nested defs excluded)."""
    b = _Assembler()
    b.build_stmts(node.body)
    if b.cur is not None:  # implicit return at the end of the body
        b._edge(b.cur, b.exit)
    return CFG(entry=b.entry, exit=b.exit, blocks=b.blocks,
               branches=b.branches, with_regions=b.with_regions)
