"""TPM6xx — cross-thread file-handle discipline (single-file fallback).

The bug class: the watchdog fires from a ``threading.Timer`` thread and
used to write its timeline record through the same JSONL handle the main
thread's spans stream to; an interleaved ``json.dump`` (many small
writes) corrupts both lines (``Reporter.jsonl`` is
single-write under a lock).

The lockset layer demoted this family: the flow- and lock-sensitive TPM16xx
analysis (``rules/races.py``) owns every file whose thread entries it
can resolve — there the lexical "a write without a lock in a file that
arms a Timer" heuristic would double-report (or contradict) the
lockset verdict. TPM601 now fires ONLY for files where thread-entry
discovery resolved *nothing* (a dynamic spawn target like
``Timer(s, callbacks[i])`` or an untyped/ambiguous bound method, no
handler classes) — the whole-program engine is blind there, and the
old heuristic is strictly better than silence. Resolution is judged at
PROJECT scope with the same machinery the race rule uses (a captured
``?meth:`` ref that no unique project method matches resolves to
nothing), and test modules always keep the lexical rule: the lockset
families exempt them, so the fallback is all the coverage they get.
The lexical detection itself lives in
:func:`tpu_mpi_tests_torch.analysis.locks.lexical_tpm601` and is cached as a
file fact, so warm runs replay it without re-parsing.
"""

from __future__ import annotations

from typing import Iterator

from tpu_mpi_tests_torch.analysis.core import ProjectContext


class UnlockedSharedWrite:
    name = "concurrency"
    scope = "project"
    codes = {
        "TPM601": "write() on a shared handle in a file that arms a "
                  "threading.Timer/Thread, without holding a lock "
                  "(fallback: fires only where TPM16xx thread-entry "
                  "discovery resolved nothing)",
    }

    def check_project(self, proj: ProjectContext) -> Iterator[tuple]:
        from tpu_mpi_tests_torch.analysis.rules.races import _Program

        prog = _Program(proj)
        modeled: set[str] = set()
        for ff in prog.files:
            races = ff["races"]
            ok = bool(races["handlers"])
            if not ok:
                for _kind, ref, _line in races["spawns"]:
                    if ref and prog.resolve(ref, ff["module"]):
                        ok = True
                        break
            if ok:
                modeled.add(ff["path"])
        for ff in proj.facts:
            races = ff.get("races")
            if not races or ff["path"] in modeled:
                continue  # the lockset engine models this file
            for line, col, msg in races.get("tpm601", ()):
                yield (ff["path"], line, col, "TPM601", msg)
