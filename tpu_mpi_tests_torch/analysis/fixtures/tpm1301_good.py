"""TPM1301 good: the winner is replicated before any rank uses it."""

import torch.distributed as dist

from tpu_mpi_tests_torch.tune import fleet


def pick(space, measure):
    if fleet.process_index() == 0:
        winner = min(space, key=measure)
    else:
        winner = None
    winner = fleet.bcast(winner, "pick")
    return winner


def pick_gathered(space, measure, world):
    if dist.get_rank() == 0:
        winner = min(space, key=measure)
    else:
        winner = None
    got = [None] * world
    dist.all_gather_object(got, winner)
    return got[0]
