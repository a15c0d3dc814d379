"""The port's linter CLI (≅ ``tpumt-lint``,
``tpu_mpi_tests/analysis/cli.py``):

    python -m tpu_mpi_tests_torch.analysis.cli tpu_mpi_tests_torch \
        chip_smoke.py gpu tests/test_torch_*.py tests/torch_dist_workers.py
    python -m tpu_mpi_tests_torch.analysis.cli --conform run.jsonl

Pure stdlib: imports and runs where ``import torch`` raises.
"""

from __future__ import annotations

import argparse
import json
import sys

from tpu_mpi_tests_torch.analysis.core import lint_paths, rule_table

#: the name the CLI reports under
PROG = "tpumt-lint-torch"

_EPILOG = """\
rule families (stable codes, the JAX linter's meanings):
  TPM1xx sync-honesty     timed device launch without a host sync
                          (torch.cuda.synchronize, Event.synchronize,
                          .item(), timers.block/block_stream, comm_span);
                          TPM102: through a helper, via the summaries
  TPM210 capture-purity   host wait/read, host epoch (next_epoch),
                          time read, print or Reporter record in a body
                          captured into a CUDA graph (torch.cuda.graph,
                          chain_rate's run without graph=False)
  TPM302 epoch-precision  time.time() onto a tensor at the default
                          float32 (128 s at today's epoch)
  TPM4xx import-hygiene   module-level `import torch` reachable from
                          the stdlib-only analysis.cli/analysis.records
  TPM6xx concurrency      unlocked cross-thread file-handle writes
                          (fallback where TPM16xx resolves no thread)
  TPM7xx schedule-consts  pinned schedule constants outside the tuner
                          (tpu_mpi_tests_torch/tune)
  TPM8xx overlap-regions  host syncs inside async_span/DispatchWindow
                          regions; TPM802: escaped handle never consumed
  TPM9xx engine           unused/malformed suppressions, parse errors
  TPM10xx chaos           fault injection outside chaos/ and the arm
                          point (drivers/_common.make_reporter)
  TPM11xx divergence      collective (torch.distributed or the comm
                          wrappers) reachable from a rank-dependent
                          branch (dist.get_rank(), process_index());
                          TPM1102: rank-guarded early exit before one
  TPM13xx broadcast       value bound on a rank-guarded path consumed
                          without fleet.bcast/dist.broadcast
  TPM14xx record-contract JSONL fields consumed but never produced
                          (TPM1401) / kinds consumed but never emitted
                          (TPM1402); helper-written fields count
  TPM16xx lockset races   disjoint-lockset data races (TPM1601),
                          non-reentrant self-deadlock (TPM1602),
                          hook-slot rebinds (TPM1603)
  TPM17xx schedule-protocol  whole-program collective schedule automata
                          (TPM1701-1703); `--conform <jsonl...>` replays
                          seq-stamped span streams: TPM1704 stream no
                          static path generates, TPM1705 rank stream
                          ending with a mandatory collective un-emitted
  not carried: TPM201 (the port has no traced functions), TPM301
  (torch's float32 default is documented), TPM5xx (process groups are
  objects, not named axes), TPM12xx (torch has no donate_argnums)

suppress one finding on its line (unused suppressions are themselves
findings):   TILE = 64  # tpumt: ignore[TPM701] (why, in a comment)

warm runs reuse the content-hash analysis cache (default
~/.cache/tpumt/lint_torch.json, $TPU_MPI_LINT_CACHE / --cache override,
--no-cache disables): unchanged files skip parse + summary entirely;
editing any analysis-package source invalidates every entry.
"""


def _sarif_doc(findings) -> dict:
    """SARIF 2.1.0, the minimal subset CI hosts render inline: one run,
    the full rule table as driver rules, one result per finding with a
    physical location (1-based column per the SARIF spec)."""
    return {
        "$schema": "https://json.schemastore.org/sarif-2.1.0.json",
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": PROG,
                "informationUri":
                    "https://github.com/bd4/gpu-mpi-tests",
                "rules": [
                    {"id": code,
                     "shortDescription": {"text": summary}}
                    for code, summary in rule_table()
                ],
            }},
            "results": [
                {"ruleId": f.code,
                 "level": "error",
                 "message": {"text": f.message},
                 "locations": [{"physicalLocation": {
                     "artifactLocation": {"uri": f.path},
                     "region": {"startLine": f.line,
                                "startColumn": f.col + 1},
                 }}]}
                for f in findings
            ],
        }],
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog=PROG,
        description="whole-program static analyzer for the PyTorch/CUDA "
        "port's correctness hazard classes (stdlib-only; runs without "
        "torch).",
        epilog=_EPILOG,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("paths", nargs="*", metavar="PATH",
                    help="files or directories to lint (directories "
                    "recurse over *.py, skipping fixtures/ and "
                    "__pycache__/)")
    ap.add_argument("--format", choices=("human", "json", "sarif"),
                    default="human", help="output format")
    ap.add_argument("--select", action="append", metavar="CODES",
                    help="only these codes/families (comma list; "
                    "TPM1, TPM1xx and TPM101 all work); repeatable")
    ap.add_argument("--ignore", action="append", metavar="CODES",
                    help="drop these codes/families (comma list); "
                    "repeatable")
    ap.add_argument("--entry-module", action="append", metavar="MOD",
                    help="override the TPM4xx stdlib-only entry-module "
                    "set (default: analysis.cli and analysis.records); "
                    "repeatable")
    ap.add_argument("--cache", metavar="PATH", default=None,
                    help="analysis-cache path (default "
                    "~/.cache/tpumt/lint_torch.json or "
                    "$TPU_MPI_LINT_CACHE)")
    ap.add_argument("--no-cache", action="store_true",
                    help="disable the content-hash analysis cache for "
                    "this run")
    ap.add_argument("--jobs", type=int, default=1, metavar="N",
                    help="parallelize per-file fact extraction over N "
                    "worker processes (default 1; warm-cache runs "
                    "re-parse zero files regardless of N)")
    ap.add_argument("--stats", action="store_true",
                    help="print files/analyzed/cache-hit counts plus "
                    "wall time and files/proc to stderr")
    ap.add_argument("--list-rules", action="store_true",
                    help="print every registered code and exit")
    ap.add_argument("--conform", action="store_true",
                    help="conformance mode: PATHs are telemetry JSONL "
                    "streams (`.p<i>` rank sets auto-expand), replayed "
                    "against the schedule automaton compiled from "
                    "--conform-tree; convicts TPM1704/TPM1705")
    ap.add_argument("--conform-tree", metavar="DIR", default=None,
                    help="source tree the schedule automaton is "
                    "compiled from in --conform mode (default: the "
                    "tpu_mpi_tests_torch package)")
    args = ap.parse_args(argv)

    if args.list_rules:
        for code, summary in rule_table():
            print(f"{code}  {summary}")
        return 0
    if not args.paths:
        ap.error("no paths given (try: tpu_mpi_tests_torch chip_smoke.py "
                 "gpu tests/test_torch_*.py tests/torch_dist_workers.py)")

    entry_modules = None
    if args.entry_module:
        entry_modules = {m: m for m in args.entry_module}
    cache_path = None
    if not args.no_cache:
        if args.cache:
            cache_path = args.cache
        else:
            from tpu_mpi_tests_torch.analysis.lintcache import (
                default_cache_path,
            )

            cache_path = default_cache_path()
    if args.jobs < 1:
        ap.error("--jobs must be >= 1")
    stats: dict = {}
    notes: list[str] = []
    if args.conform:
        from pathlib import Path

        from tpu_mpi_tests_torch.analysis import core as _core
        from tpu_mpi_tests_torch.analysis.core import collect_project
        from tpu_mpi_tests_torch.analysis.protocol import conform_paths

        # the automaton is compiled from source, the stream from
        # telemetry: PATHs here are JSONL files, not code
        tree = args.conform_tree or str(Path(_core.__file__).parents[1])
        proj = collect_project(
            [tree],
            entry_modules=entry_modules,
            cache_path=cache_path,
            stats=stats,
            jobs=args.jobs,
        )
        findings, notes = conform_paths(args.paths, proj)
    else:
        findings = lint_paths(
            args.paths,
            select=args.select,
            ignore=args.ignore,
            entry_modules=entry_modules,
            cache_path=cache_path,
            stats=stats,
            jobs=args.jobs,
        )
    for note in notes:
        print(f"{PROG}: NOTE: {note}", file=sys.stderr)
    if args.stats:
        analyzed = stats.get("analyzed", 0)
        jobs = stats.get("jobs", 1)
        per_proc = analyzed / jobs if jobs else analyzed
        print(
            f"{PROG} stats: files={stats.get('files', 0)} "
            f"analyzed={analyzed} "
            f"cache_hits={stats.get('cache_hits', 0)} "
            f"seconds={stats.get('seconds', 0.0):.3f} "
            f"jobs={jobs} files_per_proc={per_proc:.1f} "
            f"cache={cache_path or 'off'}",
            file=sys.stderr,
        )

    if args.format == "json":
        print(json.dumps(
            {"version": 1, "count": len(findings),
             "findings": [f.as_dict() for f in findings]},
            indent=2,
        ))
    elif args.format == "sarif":
        print(json.dumps(_sarif_doc(findings), indent=2))
    else:
        for f in findings:
            print(f.format())
        if findings:
            print(f"{PROG}: {len(findings)} finding"
                  f"{'s' if len(findings) != 1 else ''}",
                  file=sys.stderr)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
