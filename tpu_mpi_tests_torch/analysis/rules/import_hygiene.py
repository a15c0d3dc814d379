"""TPM4xx: import hygiene for the port's stdlib-only entry points.

``python -m tpu_mpi_tests_torch.analysis.cli`` and ``.records`` must
import and run where ``import torch`` raises (a login node, a CI runner
with no accelerator stack). A single eager ``import torch`` anywhere in
their module-level import closure breaks them at once. This rule walks
the module-level import graph from each entry module and flags any
module-level import of ``torch``, ``triton`` (which imports torch) or
``jax`` in the reachable set. Imports inside functions (the lazy idiom
every torch-touching module of the port uses) are exempt by
construction, as is the ``try: import torch / except ImportError:``
optional-import shape (imports in the *handler* still fire).

The graph edges come from the per-file facts (``facts["mod_imports"]``),
so a warm-cache run walks the identical graph without re-parsing.
"""

from __future__ import annotations

from typing import Iterator

from tpu_mpi_tests_torch.analysis.core import ProjectContext, under

#: top-level packages a stdlib-only entry must not import at module level
FORBIDDEN = ("torch", "triton", "jax")


def _parents(module: str) -> list[str]:
    parts = module.split(".")
    return [".".join(parts[:i]) for i in range(1, len(parts))]


class ImportHygiene:
    name = "import-hygiene"
    scope = "project"
    codes = {
        "TPM401": "module-level `import torch` (or triton/jax) "
                  "reachable from a stdlib-only entry point "
                  "(analysis.cli/analysis.records must import without "
                  "torch)",
    }

    def check_project(self, proj: ProjectContext) -> Iterator[tuple]:
        mods = proj.by_module  # module name -> [facts, ...]
        # BFS over the module-level import graph; chain[m] remembers one
        # path back to the entry point for the finding message. Every
        # facts record sharing a module name contributes edges and is
        # scanned: duplicate names across linted roots must widen the
        # reachable set, never silently drop a file from it.
        chain: dict[str, list[str]] = {}
        queue: list[str] = []
        for entry in proj.entry_modules:
            for m in _parents(entry) + [entry]:
                if m in mods and m not in chain:
                    chain[m] = [entry] if m == entry else [entry, m]
                    queue.append(m)
        while queue:
            cur = queue.pop(0)
            for ff in mods[cur]:
                for _line, target, names in ff["mod_imports"]:
                    edges = [target] + [f"{target}.{n}" for n in names]
                    for t in edges:
                        for m in _parents(t) + [t]:
                            if m in mods and m not in chain:
                                chain[m] = chain[cur] + [m]
                                queue.append(m)

        for m in sorted(chain):
            for ff in mods[m]:
                for line, target, _names in ff["mod_imports"]:
                    if under(target, FORBIDDEN):
                        entry = chain[m][0]
                        script = proj.entry_modules.get(entry, entry)
                        via = " -> ".join(chain[m])
                        yield (
                            ff["path"], line, 0, "TPM401",
                            f"module-level import of '{target}' breaks "
                            f"the stdlib-only guarantee of {script} "
                            f"(import chain: {via}) — import it "
                            f"lazily inside the function that needs it",
                        )
