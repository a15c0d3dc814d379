"""Single-device DAXPY with checksum verification (≅
``tpu_mpi_tests/drivers/daxpy.py``).

≅ ``daxpy.cu`` / ``daxpy_nvtx.cu``. The driver body lives in the workload
spec (:mod:`tpu_mpi_tests_torch.workloads.daxpy`); this module is the
entry point: ``python -m tpu_mpi_tests_torch.drivers.daxpy``. The card is
the default device; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import sys

from tpu_mpi_tests_torch.workloads.daxpy import SPEC, main  # noqa: F401


if __name__ == "__main__":
    sys.exit(main())
