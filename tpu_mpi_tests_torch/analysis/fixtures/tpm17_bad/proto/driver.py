"""TPM1701 bad: only rank 0 runs the broadcast handshake."""

import torch.distributed as dist

from proto.comms import fanout


def open_sweep(value):
    if dist.get_rank() == 0:  # expect: TPM1701
        fanout(value, "sweep:open")
    return value
