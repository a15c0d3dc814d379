"""TPM14xx — the JSONL record contract between producers and consumers
(≅ the JAX package's rule).

The port's observability spine is a few dozen JSONL record kinds emitted
from ``instrument``/``serve``/``chaos``/``workloads``/``tune`` producer
sites and read by the trace merge (``instrument/timeline.py``), the
metrics plane, the serve replay and ``chip_smoke.py``. A consumer
reading a field nobody emits just takes its ``.get`` default forever,
and a consumer filtering on a kind nobody produces renders an empty
table that *looks* like a quiet run.

Two codes over the extracted facts
(:mod:`tpu_mpi_tests_torch.analysis.program`):

* **TPM1401** — a consumer reads a constant field off a record variable
  whose tested kinds it established, and NO producer of the governing
  kinds emits that field (fields a same-file helper stores into the
  record count as emitted). The consumer facts are flow-sensitive: a
  read inside one arm of a per-kind dispatch chain is judged against
  that arm's kinds alone, a read exclusively on the complement side of a
  kind test is skipped, and only reads in shared code fall back to the
  union of every tested kind. Groups whose producers include an *open*
  schema (``**spread`` / ``.update()``) are skipped entirely.
* **TPM1402** — a consumer tests a record variable against a kind no
  producer in the linted program ever emits.

Test modules (``test_*.py``/``conftest.py``) are exempt on BOTH sides:
tests assert on records, they are not contract parties.
``python -m tpu_mpi_tests_torch.analysis.records`` renders the same
facts as the port's schema table.
"""

from __future__ import annotations

from typing import Iterator

from tpu_mpi_tests_torch.analysis.core import (
    ProjectContext,
    is_test_file as _is_test_file,
)


class RecordContract:
    name = "record-contract"
    scope = "project"
    codes = {
        "TPM1401": "record field consumed but never produced for any "
                   "of the kinds the consumer tested — the .get "
                   "default is served forever",
        "TPM1402": "record kind consumed but never produced anywhere "
                   "in the program — the consumer filters on records "
                   "that cannot exist",
    }

    def check_project(self, proj: ProjectContext) -> Iterator[tuple]:
        produced: dict[str, tuple[set, bool]] = {}
        stamped: set = set()
        for ff in proj.facts:
            if _is_test_file(ff["path"]):
                continue
            for kind, _event, fields, open_, _line in ff.get(
                "rec_produced", ()
            ):
                have, was_open = produced.get(kind, (set(), False))
                produced[kind] = (have | set(fields),
                                  was_open or bool(open_))
            for fields, _line in ff.get("rec_stamps", ()):
                # envelope fields ({**rec, "rank": ...} at a sink
                # wrapper) ride on EVERY kind that flows through
                stamped.update(fields)

        for ff in proj.facts:
            if _is_test_file(ff["path"]):
                continue
            for cons in ff.get("rec_consumed", ()):
                unknown = [k for k in cons["kinds"]
                           if k not in produced]
                for kind in unknown:
                    yield (
                        ff["path"], cons["line"], 0, "TPM1402",
                        f"'{cons['var']}' is filtered on kind "
                        f"'{kind}', which no producer in the linted "
                        f"program emits — either the kind was renamed "
                        f"out from under this consumer or the "
                        f"producer was never written; the records "
                        f"table lists the live kind set",
                    )
                if unknown:
                    continue  # field check needs a known schema union
                for group in cons["groups"]:
                    kinds = group["kinds"] or cons["kinds"]
                    if any(produced[k][1] for k in kinds):
                        continue  # an open schema produces anything
                    avail: set = set(stamped)
                    for k in kinds:
                        avail |= produced[k][0]
                    for fname, line, col in group["fields"]:
                        if fname in avail:
                            continue
                        klist = ", ".join(kinds)
                        yield (
                            ff["path"], line, col, "TPM1401",
                            f"'{cons['var']}' (kind {klist}) is read "
                            f"for field '{fname}', which no producer "
                            f"of "
                            f"{'that kind' if len(kinds) == 1 else 'those kinds'} "
                            f"emits — the read silently yields its "
                            f"default forever; fix the field name or "
                            f"emit it at the producer (the records "
                            f"table lists the live schemas)",
                        )
