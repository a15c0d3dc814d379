"""TPM1101 good: every rank reduces; only the report is rank 0's."""

import torch.distributed as dist

from spmd.comms import global_sum


def step(t):
    t = global_sum(t)
    if dist.get_rank() == 0:
        print("sum", float(t.sum()))
    return t
