"""Helper whose call graph calls a collective: the divergence check must
see through this frame via the project summaries."""

import torch.distributed as dist


def global_sum(t):
    dist.all_reduce(t)
    return t
