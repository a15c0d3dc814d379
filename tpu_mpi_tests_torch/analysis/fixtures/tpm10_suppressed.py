"""TPM10xx suppressed: a fault drill harness outside the tests."""

# the drill's whole purpose is to fire a fault on purpose
from tpu_mpi_tests_torch.chaos.inject import arm  # tpumt: ignore[TPM1001]


def drill(spec):
    arm(spec)  # tpumt: ignore[TPM1001]
