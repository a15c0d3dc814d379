"""TPM1702 bad: the trip count is a function of the rank and the body
calls a collective."""

import torch.distributed as dist

from proto.comms import global_sum


def drain(t, n):
    for _ in range(n - dist.get_rank()):  # expect: TPM1702
        t = global_sum(t)
    return t
