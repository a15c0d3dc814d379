"""TPM1xx good: every clock pair waits for the work it times."""

import time

import torch

from tpu_mpi_tests_torch.instrument.timers import block, block_stream
from tpu_mpi_tests_torch.kernels import hand


def timed_daxpy(a, x, y):
    t0 = time.perf_counter()
    out = block(hand.daxpy(a, x, y))
    seconds = time.perf_counter() - t0
    return out, seconds


def timed_matmul(a, b):
    t0 = time.perf_counter()
    c = torch.matmul(a, b)
    torch.cuda.synchronize()
    return c, time.perf_counter() - t0


def timed_norm(x):
    t0 = time.perf_counter()
    n = torch.linalg.norm(x).item()
    return n, time.perf_counter() - t0


def _scale(x):
    return block_stream(torch.mul(x, 2.0))


def timed_scale(x):
    t0 = time.perf_counter()
    out = _scale(x)
    return out, time.perf_counter() - t0


def timed_host_only(dev):
    # device queries and stream handles launch nothing
    t0 = time.perf_counter()
    name = torch.cuda.get_device_name(dev)
    stream = torch.cuda.current_stream(dev)
    return name, stream, time.perf_counter() - t0
