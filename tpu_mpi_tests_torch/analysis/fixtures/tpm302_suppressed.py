"""TPM302 suppressed: a coarse stamp where 128 s steps are enough."""

import time

import torch


def coarse_stamp():
    # an hour-scale bucket: float32's 128 s spacing is finer than needed
    return torch.tensor(time.time() / 3600.0)  # tpumt: ignore[TPM302]
