"""TPM210 good: the captured bodies only launch; the host reads and the
clocks come after the replay, a body that must wait on the host is
chained with graph=False, and an _under_capture() guard exempts what it
covers."""

import time

import torch

from tpu_mpi_tests_torch.instrument.telemetry import _under_capture
from tpu_mpi_tests_torch.instrument.timers import block, chain_rate


def chained(step, x, rep):
    def run(y, n):
        for _ in range(n):
            y = step(y)
            if not _under_capture():
                print(y.sum().item())
        return y

    sec, y = chain_rate(run, x)
    rep.line(f"chained {sec} {y.sum().item()}")
    return y


def host_staged(step, x):
    def run(y, n):
        for _ in range(n):
            y = step(y.cpu()).to(x.device)
        return y

    # each step reads its operand to the host: no graph can hold it
    return chain_rate(run, x, graph=False)


def captured(kernel, z):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = kernel(z)
    t0 = time.perf_counter()
    g.replay()
    block(out)
    return out.cpu(), time.perf_counter() - t0
