"""1-D 5-point stencil with halo exchange and error-norm gate (≅
``tpu_mpi_tests/drivers/stencil1d.py``, ``mpi_stencil_gt.cc``).

The driver body lives in the workload spec
(:mod:`tpu_mpi_tests_torch.workloads.stencil1d`); this module is the
entry point ``python -m tpu_mpi_tests_torch.drivers.stencil1d``.
"""

from __future__ import annotations

import sys

from tpu_mpi_tests_torch.workloads.stencil1d import SPEC, main  # noqa: F401


def run(args) -> int:
    """The driver body (the spec runner's flow) on parsed ``args``."""
    from tpu_mpi_tests_torch.workloads.runner import run_body

    return run_body(SPEC, args)


if __name__ == "__main__":
    sys.exit(main())
