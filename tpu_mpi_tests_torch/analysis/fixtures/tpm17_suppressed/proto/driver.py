"""TPM17xx suppressed: a world-of-one tool."""

import torch.distributed as dist

from proto.comms import fanout


def open_sweep(value):
    # run only as a world of one: there is no peer to leave behind
    if dist.get_rank() == 0:  # tpumt: ignore[TPM1701]
        fanout(value, "sweep:open")
    return value
