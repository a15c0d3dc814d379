"""TPM1xx bad: clock pairs that time CUDA launches, not the work."""

import time

import torch

from tpu_mpi_tests_torch.kernels import hand


def timed_daxpy(a, x, y):
    t0 = time.perf_counter()
    out = hand.daxpy(a, x, y)  # expect: TPM101
    seconds = time.perf_counter() - t0
    return out, seconds


def timed_matmul(a, b):
    t0 = time.perf_counter()
    c = torch.matmul(a, b)  # expect: TPM101
    return c, time.perf_counter() - t0


def _scale(x):
    return torch.mul(x, 2.0)


def timed_scale(x):
    t0 = time.perf_counter()
    out = _scale(x)  # expect: TPM102
    return out, time.perf_counter() - t0
