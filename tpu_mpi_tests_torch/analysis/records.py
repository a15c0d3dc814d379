"""The port's JSONL record-kind table (≅
``tpu_mpi_tests/analysis/records.py``).

Extracts every producer schema (dict literals carrying a constant
``kind``, with the fields a same-file helper stores into them) and every
consumer access (``rec.get("...")``/subscripts in functions that test a
record's ``kind``) from the port's sources (the same facts the TPM14xx
record-contract rules judge) and renders them as one markdown table,
printed or written to the path ``-o`` names. It never writes the
repository's ``RECORDS.md``, which is the JAX package's table.

    python -m tpu_mpi_tests_torch.analysis.records [PATH ...] [-o OUT]

Pure stdlib: imports and runs where ``import torch`` raises.
"""

from __future__ import annotations

import argparse
import ast
import sys
from pathlib import Path

from tpu_mpi_tests_torch.analysis.core import (
    DEFAULT_ENTRY_MODULES,
    FileContext,
    is_test_file,
    iter_files,
)
from tpu_mpi_tests_torch.analysis.program import (
    _record_consumer_facts,
    _record_producer_facts,
)

#: consumer modules with console-script names (everything else renders
#: as its dotted module) — derived from the ONE module→script table the
#: TPM4xx roots already maintain, plus the in-process metrics plane
_CONSOLE = {
    **DEFAULT_ENTRY_MODULES,
    "tpu_mpi_tests_torch.instrument.metrics": "metrics-exporter",
    "tpu_mpi_tests_torch.instrument.timeline": "trace merge",
}

_HEADER = """\
# The port's JSONL record kinds

<!-- generated by `python -m tpu_mpi_tests_torch.analysis.records` -->

Every record the port's telemetry spine writes is one JSON object per
line with a string `kind`. This table is extracted from the port's
sources: **fields** is the union of every producer dict literal for the
kind (`+ dynamic` marks open schemas: `**spread`/`.update()` extras the
static pass cannot enumerate), **events** the constant `event` values
seen, **produced at** the emit sites, and **consumed by** the modules
that filter on the kind. The port's TPM14xx lint family enforces the
same contract: a field consumed but never produced is TPM1401, a kind
consumed but never emitted is TPM1402.
"""


def collect(
    paths: list[str], repo_root: Path,
) -> tuple[dict[str, dict], dict]:
    """``(kind -> {events, fields, open, producers, consumers},
    envelope-stamp info)`` over every non-test ``*.py`` under
    ``paths``."""
    kinds: dict[str, dict] = {}
    stamp_fields: set[str] = set()
    stamp_sites: list[str] = []

    def entry(kind: str) -> dict:
        return kinds.setdefault(kind, {
            "events": set(), "fields": set(), "open": False,
            "producers": [], "consumers": set(),
        })

    for f in iter_files(paths):
        if is_test_file(f):
            continue
        try:
            source = f.read_text()
            tree = ast.parse(source, filename=str(f))
        except (OSError, SyntaxError, ValueError):
            continue
        ctx = FileContext(str(f), source, tree)
        try:
            rel = str(f.resolve().relative_to(repo_root))
        except ValueError:
            rel = str(f)
        schemas, stamps = _record_producer_facts(ctx)
        for kind, event, fields, open_, line in schemas:
            e = entry(kind)
            if event:
                e["events"].add(event)
            e["fields"].update(fields)
            e["open"] = e["open"] or bool(open_)
            e["producers"].append(f"{rel}:{line}")
        for fields, line in stamps:
            stamp_fields.update(fields)
            stamp_sites.append(f"{rel}:{line}")
        for cons in _record_consumer_facts(ctx):
            label = _CONSOLE.get(ctx.module, ctx.module)
            for kind in cons["kinds"]:
                entry(kind)["consumers"].add(label)
    return kinds, {"fields": stamp_fields, "sites": stamp_sites}


def render(kinds: dict[str, dict], stamps: dict) -> str:
    lines = [_HEADER]
    if stamps["fields"]:
        fl = ", ".join(f"`{v}`" for v in sorted(stamps["fields"]))
        lines.append(
            f"**Envelope fields** (stamped onto every record at the "
            f"sink wrappers — `{{**rec, ...}}` into "
            f"`Reporter.jsonl`): {fl}.\n"
        )
    lines.append("| kind | events | fields | produced at | "
                 "consumed by |")
    lines.append("|---|---|---|---|---|")
    for kind in sorted(kinds):
        e = kinds[kind]
        events = ", ".join(f"`{v}`" for v in sorted(e["events"])) \
            or "—"
        fields = ", ".join(f"`{v}`" for v in sorted(e["fields"]))
        if e["open"]:
            fields = (fields + " " if fields else "") + "*+ dynamic*"
        if not fields:
            fields = "—"
        producers = "<br>".join(
            f"`{p}`" for p in sorted(e["producers"])
        ) or "*(none — consumed only)*"
        consumers = ", ".join(sorted(e["consumers"])) or "—"
        lines.append(f"| `{kind}` | {events} | {fields} | "
                     f"{producers} | {consumers} |")
    lines.append("")
    lines.append(f"{len(kinds)} record kinds.")
    return "\n".join(lines) + "\n"


def main(argv: list[str] | None = None) -> int:
    repo_root = Path(__file__).resolve().parents[2]
    ap = argparse.ArgumentParser(
        prog="python -m tpu_mpi_tests_torch.analysis.records",
        description="Print the port's JSONL record-kind schema table, "
        "from the producer/consumer facts of its sources (stdlib-only; "
        "runs without torch).",
    )
    ap.add_argument("paths", nargs="*", metavar="PATH",
                    help="source roots to scan (default: the "
                    "tpu_mpi_tests_torch package)")
    ap.add_argument("-o", "--output", default=None,
                    help="write the table to this file instead of "
                    "standard output")
    args = ap.parse_args(argv)
    paths = args.paths or [str(Path(__file__).resolve().parents[1])]
    content = render(*collect(paths, repo_root))
    if args.output is None:
        sys.stdout.write(content)
        return 0
    Path(args.output).write_text(content)
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
