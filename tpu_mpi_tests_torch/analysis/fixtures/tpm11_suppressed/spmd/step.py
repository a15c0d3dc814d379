"""TPM1101 suppressed: a rank-0-only tool run as a world of one."""

import torch.distributed as dist

from spmd.comms import global_sum


def step(t):
    # the single-process calibration: rank 0 is the whole world
    if dist.get_rank() == 0:  # tpumt: ignore[TPM1101]
        t = global_sum(t)
    return t
