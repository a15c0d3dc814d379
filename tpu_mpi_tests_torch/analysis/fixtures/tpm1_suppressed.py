"""TPM1xx suppressed: the launch rate itself is what is measured."""

import time

import torch


def launch_rate(x, n):
    t0 = time.perf_counter()
    for _ in range(n):
        # the host's launch throughput is the quantity here: waiting for
        # the work would measure the kernels instead
        x = torch.add(x, 1.0)  # tpumt: ignore[TPM101]
    return n / (time.perf_counter() - t0)
