"""TPM1102 bad: every non-zero rank leaves before the all-reduce, so
rank 0 waits in it forever."""

import torch.distributed as dist


def global_mean(x, world):
    if dist.get_rank() != 0:  # expect: TPM1102
        return x
    dist.all_reduce(x)
    return x / world
