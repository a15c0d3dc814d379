"""The port's lint engine (≅ ``tpu_mpi_tests/analysis/core.py``): file
walking, the rule registry, suppressions.

It parses each file once (``ast``), hands the tree to every file-scope
rule, extracts the file's serializable *facts* (module imports, function
summaries, record schemas, locksets:
:mod:`tpu_mpi_tests_torch.analysis.program`), hands the whole fact set to
the project-scope rules, then applies ``# tpumt: ignore[TPMxxx]``
suppression comments and reports any suppression that silenced nothing
(TPM900). File-scope findings and facts depend only on the file's bytes,
so both are cached under a content hash
(:mod:`tpu_mpi_tests_torch.analysis.lintcache`); the project pass runs
every time over the (possibly replayed) facts.

The vocabulary is torch's: device work is a call into ``torch`` or the
port's ``kernels``/``comm`` layers, and an origin matches a prefix by
whole dotted components (:func:`under`), so ``tpu_mpi_tests_torch`` never
matches a rule meant for ``tpu_mpi_tests`` or the other way round.

Stdlib only: the linter imports and runs where ``import torch`` (and
``import jax``) raise.
"""

from __future__ import annotations

import ast
import hashlib
import io
import re
import time
import tokenize
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, Iterator

#: the port's stdlib-only entry points, whose module-level import closure
#: must stay free of torch (the TPM4xx reachability roots; tests may
#: substitute their own set)
DEFAULT_ENTRY_MODULES = {
    "tpu_mpi_tests_torch.analysis.cli": "analysis.cli",
    "tpu_mpi_tests_torch.analysis.records": "analysis.records",
    # the rule modules load lazily at lint time (all_rules()), which the
    # static reachability walk cannot see: root them explicitly so an
    # eager torch import in a rule module is still caught
    "tpu_mpi_tests_torch.analysis.rules": "analysis.cli",
}

#: directory names never descended into on a recursive walk. ``fixtures``
#: keeps the rule golden files (deliberately-bad code under
#: ``analysis/fixtures/``) out of the self-clean gate; explicit file
#: arguments are always linted, which is how the golden tests reach them.
SKIP_DIRS = {"__pycache__", "fixtures", "node_modules"}

def is_test_file(path) -> bool:
    """Test modules are exempt from the contract-style rules (record
    contract, chaos containment): tests assert on the artifacts, they
    are not contract parties. Accepts a path OR a bare module
    component (``test_foo.py`` and ``test_foo`` both match)."""
    name = Path(str(path)).name
    stem = name[:-3] if name.endswith(".py") else name
    return stem.startswith("test_") or stem == "conftest"


_ENGINE_CODES = {
    "TPM900": "unused suppression: the silenced finding is gone",
    "TPM901": "malformed `# tpumt:` comment",
    "TPM902": "file cannot be read or parsed",
}


@dataclass(frozen=True, order=True)
class Finding:
    path: str
    line: int
    col: int
    code: str
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.code} " \
               f"{self.message}"

    def as_dict(self) -> dict:
        return {"path": self.path, "line": self.line, "col": self.col,
                "code": self.code, "message": self.message}


def attr_parts(node: ast.AST) -> list[str] | None:
    """``a.b.c`` → ``["a", "b", "c"]``; None when the chain's root is not
    a plain name (e.g. ``f(x).synchronize``)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        parts.reverse()
        return parts
    return None


def last_attr(node: ast.AST) -> str | None:
    """Final component of a call target (method/function name)."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


# ---------------------------------------------------------------------------
# shared AST heuristics (rules/_util re-exports them for the rule modules)


def under(dotted: str | None, prefixes) -> bool:
    """Is ``dotted`` one of ``prefixes`` or inside one of them, judged by
    whole dotted components (``torch.cuda`` is under ``torch``;
    ``tpu_mpi_tests_torch.comm`` is not under ``tpu_mpi_tests``)?"""
    if not dotted:
        return False
    return any(dotted == p or dotted.startswith(p + ".")
               for p in prefixes)


#: origins whose calls launch device work in the port: torch itself and
#: the port's kernel and communication layers
DEVICE_ORIGINS = ("torch", "tpu_mpi_tests_torch.kernels",
                  "tpu_mpi_tests_torch.comm")

#: modules under those origins that launch nothing: the kernels' nvcc
#: build and load step
HOST_ORIGINS = ("tpu_mpi_tests_torch.kernels.build",)

#: final names of calls under the device origins that run on the host
#: only: torch's device, dtype and stream handles, its allocator and
#: device queries, RNG seeding, and the port's launch counters
HOST_CALLS = {
    "device", "dtype", "finfo", "iinfo", "is_available", "device_count",
    "get_device_name", "get_device_properties", "get_device_capability",
    "current_device", "set_device", "manual_seed", "manual_seed_all",
    "Generator", "Event", "Stream", "current_stream", "stream",
    "no_grad", "inference_mode", "set_grad_enabled", "get_default_dtype",
    "set_default_dtype", "is_tensor", "is_floating_point", "empty_cache",
    "memory_allocated", "max_memory_allocated", "memory_reserved",
    "memory_stats", "mem_get_info", "reset_peak_memory_stats",
    "get_num_threads", "set_num_threads",
    "launch_counts", "reset_launch_counts", "route_counts",
    "alu_issue_rate",
}

#: the ``torch.distributed`` calls that launch device work (everything
#: else there, ``get_rank``, ``is_initialized``, the store, is host-side)
DIST_LAUNCHES = {
    "all_reduce", "all_gather", "all_gather_into_tensor", "reduce",
    "reduce_scatter", "reduce_scatter_tensor", "all_to_all",
    "all_to_all_single", "broadcast", "gather", "scatter", "send",
    "recv", "isend", "irecv", "batch_isend_irecv", "barrier",
}

#: origins whose return values are device-launching callables (the
#: iterate-function factories of the comm layer and the drivers)
FACTORY_ORIGINS = DEVICE_ORIGINS + ("tpu_mpi_tests_torch.drivers",)

#: launching-callable factories convicted BY NAME, whether or not the
#: import graph resolved their origin (aliased or dynamic imports): a
#: perf_counter pair timing the callable they return, with no sync, is a
#: TPM101 finding
FACTORY_NAMES = {"iterate_fused_rdma_fn"}


def walk_calls(node: ast.AST) -> Iterator[ast.Call]:
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            yield n


def device_callables(ctx: "FileContext") -> set[str]:
    """Local names that launch device work when called: names assigned
    from a call into the factory origins or to a factory by name."""
    out: set[str] = set()
    for n in ast.walk(ctx.tree):
        if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call):
            resolved = ctx.imports.resolve(n.value.func)
            if not (under(resolved, FACTORY_ORIGINS)
                    or last_attr(n.value.func) in FACTORY_NAMES):
                continue
            for t in n.targets:
                targets = t.elts if isinstance(
                    t, (ast.Tuple, ast.List)
                ) else [t]
                out.update(e.id for e in targets
                           if isinstance(e, ast.Name))
    return out


def is_device_call(ctx: "FileContext", call: ast.Call,
                   local_device: set[str]) -> bool:
    """Does this call plausibly launch (asynchronous) device work?"""
    parts = attr_parts(call.func)
    if not parts:
        return False
    if parts[0] in local_device and len(parts) == 1:
        return True
    resolved = ctx.imports.resolve(call.func)
    if not under(resolved, DEVICE_ORIGINS) or under(resolved,
                                                    HOST_ORIGINS):
        return False
    last = resolved.rsplit(".", 1)[-1]
    if under(resolved, ("torch.distributed",)):
        return last in DIST_LAUNCHES
    return last not in HOST_CALLS


_SCOPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def own_nodes(root: ast.AST) -> Iterator[ast.AST]:
    """In-order walk of ``root``'s subtree, skipping nested function and
    lambda bodies — "own scope": what executes when this code object
    runs, not what it merely defines. Shared by the facts extractor
    (program.py) and the lockset layer (locks.py) — one definition, so
    their scope semantics cannot diverge."""
    # an explicit stack, pre-order like the recursive walk: a recursive
    # generator pays a resume per level of depth for every node
    stack = [ast.iter_child_nodes(root)]
    while stack:
        for child in stack[-1]:
            if isinstance(child, _SCOPES):
                continue
            yield child
            stack.append(ast.iter_child_nodes(child))
            break
        else:
            stack.pop()


def stmt_lists(tree: ast.AST) -> Iterator[list[ast.stmt]]:
    """Every statement list in the tree (module/function/branch bodies)."""
    for n in ast.walk(tree):
        for field in ("body", "orelse", "finalbody"):
            stmts = getattr(n, field, None)
            if isinstance(stmts, list) and stmts and isinstance(
                stmts[0], ast.stmt
            ):
                yield stmts


def call_name(node: ast.AST) -> str:
    return last_attr(node) or "<call>"


# ---------------------------------------------------------------------------


class ImportMap:
    """Local-name → origin-module resolution for one file.

    Imports are collected from the WHOLE tree (drivers import torch inside
    ``run()`` by convention, and those bindings are what the rule
    heuristics need to resolve)."""

    def __init__(self) -> None:
        self.modules: dict[str, str] = {}  # alias -> dotted module
        self.names: dict[str, tuple[str, str]] = {}  # name -> (mod, orig)

    @classmethod
    def collect(cls, tree: ast.AST) -> "ImportMap":
        m = cls()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        m.modules[a.asname] = a.name
                    else:
                        root = a.name.split(".")[0]
                        m.modules.setdefault(root, root)
            elif isinstance(node, ast.ImportFrom):
                mod = ("." * node.level) + (node.module or "")
                for a in node.names:
                    m.names[a.asname or a.name] = (mod, a.name)
        return m

    def origin(self, root: str) -> str | None:
        """Dotted origin of a local name: the module it aliases, or
        ``module.original`` for a from-import; None if unknown."""
        if root in self.modules:
            return self.modules[root]
        if root in self.names:
            mod, orig = self.names[root]
            return f"{mod}.{orig}" if mod else orig
        return None

    def resolve(self, func: ast.AST) -> str | None:
        """Canonical dotted name of a call target with the root alias
        substituted by its import origin (``F.pad`` →
        ``torch.nn.functional.pad``). None for non-name roots."""
        parts = attr_parts(func)
        if not parts:
            return None
        origin = self.origin(parts[0])
        if origin:
            return ".".join([origin] + parts[1:])
        return ".".join(parts)


def module_name(path: str) -> str:
    """Importable dotted name of a file, anchored at the topmost enclosing
    directory that still has an ``__init__.py`` (so fixture mini-packages
    resolve relative to themselves, not the repo)."""
    p = Path(path).resolve()
    parts = [] if p.name == "__init__.py" else [p.stem]
    d = p.parent
    while (d / "__init__.py").exists():
        parts.insert(0, d.name)
        d = d.parent
    return ".".join(parts)


class FileContext:
    """One parsed file plus the lookups every rule shares."""

    def __init__(self, path: str, source: str, tree: ast.Module):
        self.path = path
        self.source = source
        self.tree = tree
        self.module = module_name(path)
        self.imports = ImportMap.collect(tree)


class ProjectContext:
    """The full linted file set as serializable per-file *facts*
    (:func:`tpu_mpi_tests_torch.analysis.program.extract_facts`) — project
    rules consume facts, never trees, so a warm-cache run hands them the
    identical view without re-parsing anything. Module names map to
    LISTS of facts: two linted roots can legitimately contain same-named
    modules (e.g. fixture mini-trees), and collapsing them to one would
    silently drop files from the reachability scan."""

    def __init__(self, facts: list[dict],
                 entry_modules: dict[str, str]):
        self.facts = facts
        self.entry_modules = entry_modules
        self.by_module: dict[str, list[dict]] = {}
        for ff in facts:
            if ff["module"]:
                self.by_module.setdefault(ff["module"], []).append(ff)
        self._index = None

    @property
    def index(self):
        """Lazily-built whole-program symbol table / call graph
        (:class:`tpu_mpi_tests_torch.analysis.program.ProjectIndex`)."""
        if self._index is None:
            from tpu_mpi_tests_torch.analysis.program import ProjectIndex

            self._index = ProjectIndex(self.facts)
        return self._index


_SUPPRESS_RE = re.compile(r"tpumt:\s*ignore\[([A-Za-z0-9_,\s]*)\]")


@dataclass
class Suppression:
    """One ``# tpumt: ignore[...]`` comment: the codes it silences, the
    physical lines it applies to (the comment's own line plus the first
    line of its logical statement — findings anchor to a multi-line
    call's first line, while the trailing comment often sits on the
    closing paren), and whether any finding consumed it."""

    codes: set[str]
    lines: set[int]
    comment_line: int
    used_codes: set[str] | None = None

    def __post_init__(self):
        if self.used_codes is None:
            self.used_codes = set()

    def as_dict(self) -> dict:
        return {"codes": sorted(self.codes), "lines": sorted(self.lines),
                "comment_line": self.comment_line}

    @classmethod
    def from_dict(cls, d: dict) -> "Suppression":
        return cls(set(d["codes"]), set(d["lines"]), d["comment_line"])


def collect_suppressions(
    source: str,
) -> tuple[list[Suppression], list[int]]:
    """``# tpumt: ignore[TPM101,TPM201]`` comments plus the lines of
    malformed ``# tpumt:`` comments. Tokenized, not regexed over raw
    lines, so string literals containing the marker (e.g. this linter's
    own tests) cannot false-match."""
    supps: list[Suppression] = []
    malformed: list[int] = []
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return supps, malformed
    _SKIP = (tokenize.NL, tokenize.NEWLINE, tokenize.COMMENT,
             tokenize.INDENT, tokenize.DEDENT, tokenize.ENCODING)
    logical_start: int | None = None
    for tok in tokens:
        if logical_start is None and tok.type not in _SKIP:
            logical_start = tok.start[0]
        if tok.type == tokenize.NEWLINE:
            logical_start = None
        if tok.type != tokenize.COMMENT or "tpumt:" not in tok.string:
            continue
        m = _SUPPRESS_RE.search(tok.string)
        codes = {c.strip().upper() for c in m.group(1).split(",")
                 if c.strip()} if m else set()
        if codes:
            lines = {tok.start[0]}
            if logical_start is not None:
                lines.add(logical_start)
            supps.append(Suppression(codes, lines, tok.start[0]))
        else:
            malformed.append(tok.start[0])
    return supps, malformed


class CodeFilter:
    """``--select``/``--ignore`` semantics: comma lists of codes or
    family prefixes (``TPM1``, ``TPM1xx``, ``TPM101`` all work)."""

    def __init__(self, select: Iterable[str] | None = None,
                 ignore: Iterable[str] | None = None):
        self.select = self._norm(select)
        self.ignore = self._norm(ignore)

    @staticmethod
    def _norm(values: Iterable[str] | None) -> list[str]:
        out: list[str] = []
        for v in values or ():
            for piece in v.split(","):
                piece = piece.strip().upper()
                if piece.endswith("XX"):
                    piece = piece[:-2]
                if piece:
                    out.append(piece)
        return out

    def selected(self, code: str) -> bool:
        if self.select and not any(code.startswith(p) for p in self.select):
            return False
        return not any(code.startswith(p) for p in self.ignore)


def replay_cache_entry(
    entry: dict, path: str,
) -> tuple[list[Finding], dict, list[Suppression], list[int]] | None:
    """Rebuild a cached file's analysis, or None — read as a miss — on
    ANY shape mismatch (a hand-edited/corrupted entry must degrade to a
    cold parse, never crash the run) or when the filesystem-derived
    module name changed out from under the cached facts: an added or
    removed ``__init__.py`` re-anchors :func:`module_name` without
    touching the file's bytes, and replaying facts under the stale name
    would make warm project findings diverge from a cold run."""
    try:
        facts = entry["facts"]
        if facts["module"] != module_name(path):
            return None
        findings = [
            Finding(d["path"], int(d["line"]), int(d["col"]),
                    d["code"], d["message"])
            for d in entry["findings"]
        ]
        supps = [Suppression.from_dict(s) for s in entry["supps"]]
        malformed = [int(x) for x in entry["malformed"]]
    except (TypeError, KeyError, ValueError, AttributeError):
        return None
    return findings, facts, supps, malformed


def all_rules() -> list:
    """The registered rule instances (imported lazily so ``--help`` and
    suppression parsing never load the rule modules)."""
    from tpu_mpi_tests_torch.analysis.rules import ALL_RULES

    return ALL_RULES


def rule_table() -> list[tuple[str, str]]:
    """``(code, summary)`` rows for every registered code, engine codes
    included — the ``--list-rules`` and SARIF source of truth."""
    rows: list[tuple[str, str]] = []
    for rule in all_rules():
        rows.extend(sorted(rule.codes.items()))
    rows.extend(sorted(_ENGINE_CODES.items()))
    return rows


def analyze_file(path: str, source: str | None = None,
                 digest: str | None = None) -> dict:
    """One file's full file-scope analysis as a serializable dict —
    the unit of work ``--jobs`` farms out to worker processes (and the
    sequential path runs inline, passing the ``source``/``digest`` the
    cache lookup already paid for). Shape:

    ``{"path", "digest", "entry": {findings, facts, supps, malformed}}``
    on success, or ``{"path", "error": [line, message]}`` when the file
    cannot be read or parsed (the caller turns that into TPM902)."""
    from tpu_mpi_tests_torch.analysis.program import extract_facts

    if source is None:
        try:
            source = Path(path).read_text()
        except OSError as e:
            return {"path": path, "unreadable": True,
                    "error": [1, f"cannot parse: {e}"]}
    if digest is None:
        digest = hashlib.sha256(source.encode()).hexdigest()
    try:
        tree = ast.parse(source, filename=path)
    except (SyntaxError, ValueError) as e:
        line = getattr(e, "lineno", None) or 1
        return {"path": path, "error": [line, f"cannot parse: {e}"]}
    ctx = FileContext(path, source, tree)
    findings: list[dict] = []
    for rule in all_rules():
        if rule.scope != "file":
            continue
        for line, col, code, msg in rule.check(ctx):
            findings.append(Finding(path, line, col, code,
                                    msg).as_dict())
    facts = extract_facts(ctx)
    supps, malformed = collect_suppressions(source)
    return {
        "path": path, "digest": digest,
        "entry": {
            "findings": findings,
            "facts": facts,
            "supps": [s.as_dict() for s in supps],
            "malformed": malformed,
        },
    }


def iter_files(paths: Iterable[str]) -> Iterator[Path]:
    seen: set[Path] = set()
    for p in paths:
        path = Path(p)
        if path.is_dir():
            for f in sorted(path.rglob("*.py")):
                rel = f.relative_to(path)
                if any(part in SKIP_DIRS or part.startswith(".")
                       for part in rel.parts[:-1]):
                    continue
                if f not in seen:
                    seen.add(f)
                    yield f
        elif path.is_file() and path.suffix == ".py":
            if path not in seen:
                seen.add(path)
                yield path


def _run_pool(miss_paths: list[str], jobs: int) -> list[dict]:
    """``analyze_file`` over a worker pool; degrades to sequential when
    the platform cannot fork/spawn (the lint must never fail because
    its parallelism did)."""
    try:
        import multiprocessing

        with multiprocessing.Pool(jobs) as pool:
            return pool.map(analyze_file, miss_paths)
    except (ImportError, OSError, RuntimeError):
        # RuntimeError: the spawn start method inside an unguarded
        # __main__ (Windows/macOS library callers) refuses to
        # bootstrap — degrade to sequential, never fail the lint
        return [analyze_file(p) for p in miss_paths]


def _gather(
    paths: Iterable[str], cache, jobs: int,
) -> tuple[set, list[dict],
           dict[str, tuple[list[Suppression], list[int]]], int, int, int]:
    """The per-file phase shared by :func:`lint_paths` and
    :func:`collect_project`: cache lookup, (possibly pooled) analysis
    of the misses, cache write-back. Returns ``(raw_findings,
    facts_list, suppressions, n_files, n_analyzed, n_hits)`` — the
    caller decides whether to run rules over the facts or hand them
    straight to the protocol layer."""
    raw: set[Finding] = set()
    facts_list: list[dict] = []
    suppressions: dict[str, tuple[list[Suppression], list[int]]] = {}
    n_files = n_analyzed = n_hits = 0

    # a missing or non-.py path is a broken gate, never a clean one: a
    # renamed directory in the lint gate's path list must fail loudly,
    # not lint nothing and exit 0
    for p in paths:
        path = Path(p)
        if not path.exists():
            raw.add(Finding(str(p), 1, 0, "TPM902",
                            "path does not exist — a lint gate over a "
                            "missing path would pass vacuously"))
        elif path.is_file() and path.suffix != ".py":
            raw.add(Finding(str(p), 1, 0, "TPM902",
                            "not a python file"))

    misses: list[str] = []
    # cache-miss sources the lookup already read, reused by the
    # sequential path (pool workers re-read — sending sources over the
    # pipe would cost more than the read)
    miss_src: dict[str, tuple[str, str]] = {}
    for f in iter_files(paths):
        path = str(f)
        n_files += 1
        if cache is not None:
            try:
                source = f.read_text()
            except OSError as e:
                n_files -= 1
                raw.add(Finding(path, 1, 0, "TPM902",
                                f"cannot parse: {e}"))
                continue
            digest = hashlib.sha256(source.encode()).hexdigest()
            entry = cache.get(path, digest)
            if entry is not None:
                replay = replay_cache_entry(entry, path)
                if replay is not None:
                    n_hits += 1
                    cached_findings, facts, supps, malformed = replay
                    raw.update(cached_findings)
                    facts_list.append(facts)
                    suppressions[path] = (supps, malformed)
                    continue
            miss_src[path] = (source, digest)
        misses.append(path)

    if jobs > 1 and len(misses) > 1:
        results = _run_pool(misses, jobs)
    else:
        results = [analyze_file(p, *miss_src.get(p, (None, None)))
                   for p in misses]

    for res in results:
        path = res["path"]
        if "error" in res:
            if res.get("unreadable"):
                # match the cached path (and the pre-jobs engine):
                # unreadable files never count toward `files`
                n_files -= 1
            line, msg = res["error"]
            raw.add(Finding(path, int(line), 0, "TPM902", msg))
            continue
        n_analyzed += 1
        entry = res["entry"]
        raw.update(
            Finding(d["path"], int(d["line"]), int(d["col"]),
                    d["code"], d["message"])
            for d in entry["findings"]
        )
        facts_list.append(entry["facts"])
        supps = [Suppression.from_dict(s) for s in entry["supps"]]
        suppressions[path] = (supps, list(entry["malformed"]))
        if cache is not None:
            cache.put(path, res["digest"], entry)

    return raw, facts_list, suppressions, n_files, n_analyzed, n_hits


def lint_paths(
    paths: Iterable[str],
    select: Iterable[str] | None = None,
    ignore: Iterable[str] | None = None,
    entry_modules: dict[str, str] | None = None,
    cache_path: str | None = None,
    stats: dict | None = None,
    jobs: int = 1,
) -> list[Finding]:
    """Lint files/directories; returns sorted, suppression-filtered
    findings (unused/malformed suppressions included as findings).

    ``cache_path`` enables the content-hash analysis cache
    (:mod:`tpu_mpi_tests_torch.analysis.lintcache`): unchanged files replay
    their cached file-scope findings + facts instead of re-parsing. The
    default (None) is uncached — library callers and tests stay
    hermetic; the CLI opts in.

    ``jobs`` parallelizes per-file analysis (parse + file rules + fact
    extraction) over a ``multiprocessing`` pool — the facts were made
    JSON-serializable for the cache, which is exactly what lets them
    cross a process boundary. Cache hits are resolved in the parent
    BEFORE dispatch, so a warm run re-parses zero files regardless of
    ``jobs``; the project pass always runs in the parent.

    ``stats``, when a dict, receives ``files``/``analyzed``/
    ``cache_hits``/``seconds``/``jobs`` counts."""
    t0 = time.monotonic()
    code_filter = CodeFilter(select, ignore)

    cache = None
    if cache_path:
        from tpu_mpi_tests_torch.analysis.lintcache import LintCache

        cache = LintCache(cache_path)

    (raw, facts_list, suppressions,
     n_files, n_analyzed, n_hits) = _gather(paths, cache, jobs)

    proj = ProjectContext(facts_list, entry_modules or DEFAULT_ENTRY_MODULES)
    for rule in all_rules():
        if rule.scope != "project":
            continue
        for path, line, col, code, msg in rule.check_project(proj):
            raw.add(Finding(path, line, col, code, msg))

    findings: list[Finding] = []
    for fd in raw:
        if not code_filter.selected(fd.code):
            continue
        matched = False
        for supp in suppressions.get(fd.path, ((), ()))[0]:
            if fd.line in supp.lines and fd.code in supp.codes:
                supp.used_codes.add(fd.code)
                matched = True
        if not matched:
            findings.append(fd)

    for path, (supps, malformed) in suppressions.items():
        for supp in supps:
            for code in sorted(supp.codes - supp.used_codes):
                if not (code_filter.selected(code)
                        and code_filter.selected("TPM900")):
                    continue
                findings.append(Finding(
                    path, supp.comment_line, 0, "TPM900",
                    f"unused suppression for {code} — the finding it "
                    f"silenced is gone; remove the comment",
                ))
        for line in malformed:
            if code_filter.selected("TPM901"):
                findings.append(Finding(
                    path, line, 0, "TPM901",
                    "malformed tpumt comment — expected "
                    "`# tpumt: ignore[TPM101]` (comma-list of codes)",
                ))

    if cache is not None:
        cache.save()
    if stats is not None:
        stats.update(files=n_files, analyzed=n_analyzed,
                     cache_hits=n_hits,
                     seconds=round(time.monotonic() - t0, 3),
                     jobs=jobs)
    findings.sort()
    return findings


def collect_project(
    paths: Iterable[str],
    entry_modules: dict[str, str] | None = None,
    cache_path: str | None = None,
    stats: dict | None = None,
    jobs: int = 1,
) -> ProjectContext:
    """The whole-program facts view WITHOUT running any rules — the
    ``--conform`` entry point. Shares :func:`_gather` with
    :func:`lint_paths`, so a warm cache replays every file's facts
    (``analyzed == 0`` in ``stats``) and the conformance pass rebuilds
    its schedule automata without re-parsing a single file."""
    t0 = time.monotonic()
    cache = None
    if cache_path:
        from tpu_mpi_tests_torch.analysis.lintcache import LintCache

        cache = LintCache(cache_path)
    (_raw, facts_list, _supps,
     n_files, n_analyzed, n_hits) = _gather(paths, cache, jobs)
    if cache is not None:
        cache.save()
    if stats is not None:
        stats.update(files=n_files, analyzed=n_analyzed,
                     cache_hits=n_hits,
                     seconds=round(time.monotonic() - t0, 3),
                     jobs=jobs)
    return ProjectContext(facts_list,
                          entry_modules or DEFAULT_ENTRY_MODULES)
