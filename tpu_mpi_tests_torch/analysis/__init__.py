"""The port's static analysis (≅ ``tpu_mpi_tests/analysis/``): a
stdlib-only whole-program linter with torch's sync, rank and collective
vocabulary.

It encodes the host-side hazard classes of the port (sync-dishonest
timing around asynchronous CUDA launches, collectives reachable from
rank-dependent control flow, unlocked cross-thread JSONL writes, record
fields consumed but never produced, eager ``import torch`` in its own
stdlib-only entry points, pinned schedule constants) as AST rules with
the JAX linter's stable ``TPMxxx`` codes. The port lints itself clean:

    python -m tpu_mpi_tests_torch.analysis.cli tpu_mpi_tests_torch \
        chip_smoke.py gpu tests/test_torch_*.py tests/torch_dist_workers.py

Pure stdlib (``ast`` + ``tokenize``): the linter imports and runs where
``import torch`` and ``import jax`` raise.
"""

# lazy re-exports (PEP 562): nothing here imports anything at module load
# beyond the stdlib, and the rule modules only load when the linter runs
_EXPORTS = {
    "Finding": "core",
    "lint_paths": "core",
    "all_rules": "core",
}
__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        mod = importlib.import_module(
            f"tpu_mpi_tests_torch.analysis.{_EXPORTS[name]}"
        )
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
