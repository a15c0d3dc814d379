"""TPM10xx bad: fault injection reachable from production code."""

import tpu_mpi_tests_torch.chaos  # expect: TPM1001
from tpu_mpi_tests_torch import chaos  # expect: TPM1001
from tpu_mpi_tests_torch.chaos.inject import arm  # expect: TPM1001


def run(spec):
    arm(spec)  # expect: TPM1001
    chaos.disarm()  # expect: TPM1001
