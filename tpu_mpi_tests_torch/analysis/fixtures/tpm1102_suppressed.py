"""TPM1102 suppressed: a one-process tool where rank 0 is the world."""

import torch.distributed as dist


def single_process_sum(x):
    # run only by a world of one: no peer can be left in the reduction
    if dist.get_rank() != 0:  # tpumt: ignore[TPM1102]
        return x
    dist.all_reduce(x)
    return x
