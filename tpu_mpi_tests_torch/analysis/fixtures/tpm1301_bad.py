"""TPM1301 bad: rank 0's winner is used on every rank unreplicated."""

import torch.distributed as dist


def pick(space, measure):
    if dist.get_rank() == 0:
        winner = min(space, key=measure)
    else:
        winner = None
    return apply(winner)  # expect: TPM1301


def apply(choice):
    return choice
