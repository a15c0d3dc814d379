"""TPM1101 bad: only rank 0 enters the all-reduce (through a helper),
the other ranks never arrive."""

import torch.distributed as dist

from spmd.comms import global_sum
from tpu_mpi_tests_torch.tune import fleet


def step(t):
    if dist.get_rank() == 0:  # expect: TPM1101
        t = global_sum(t)
    return t


def step_alias(t):
    rank = fleet.process_index()
    if not rank:  # expect: TPM1101
        dist.barrier()
    return t
