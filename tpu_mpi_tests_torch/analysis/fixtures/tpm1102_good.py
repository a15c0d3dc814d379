"""TPM1102 good: every rank reduces before the rank-0-only report."""

import torch.distributed as dist


def global_mean(x, world):
    dist.all_reduce(x)
    if dist.get_rank() != 0:
        return x / world
    print("mean", float(x.sum()) / world)
    return x / world
