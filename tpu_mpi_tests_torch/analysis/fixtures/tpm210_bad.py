"""TPM210 bad: host waits, host reads, a host epoch, clock reads, prints
and Reporter records inside bodies captured into CUDA graphs."""

import time

import torch

from tpu_mpi_tests_torch.comm.peer import peer_ring
from tpu_mpi_tests_torch.instrument.timers import block, chain_rate


def chained(step, x, rep):
    def run(y, n):
        for _ in range(n):
            y = step(y)
            if y.sum().item() > 0:  # expect: TPM210
                print("positive")  # expect: TPM210
        rep.line("chained")  # expect: TPM210
        return y

    return chain_rate(run, x)


def make_loop(step):
    def loop(y, n):
        t0 = time.perf_counter()  # expect: TPM210
        for _ in range(n):
            y = block(step(y))  # expect: TPM210
        return y, t0

    return loop


def timed(step, x):
    return chain_rate(make_loop(step), x, n_short=2, n_long=6)


def epochs(kernel, z):
    return chain_rate(
        lambda y, n: kernel(y, peer_ring(y.device).next_epoch()),  # expect: TPM210
        z, graph=True)


def captured(kernel, z):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = kernel(z)
        torch.cuda.synchronize()  # expect: TPM210
        host = out.cpu()  # expect: TPM210
    return g, host
