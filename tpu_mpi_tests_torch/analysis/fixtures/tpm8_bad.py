"""TPM8xx bad: host syncs inside overlap regions, and an escaped
handle nobody closes."""

import torch

from tpu_mpi_tests_torch.comm.collectives import DispatchWindow
from tpu_mpi_tests_torch.instrument.telemetry import async_span


def pipelined_step(exchange_fn, core_fn, z):
    h = async_span("halo_exchange", nbytes=1024)
    ex = exchange_fn(z)
    out = core_fn(z)
    torch.cuda.synchronize()  # expect: TPM801
    h.done(ex)
    return ex, out


def chained(fn, x, n):
    win = DispatchWindow(4)
    for _ in range(n):
        x = win.call("allreduce", fn, x)
    total = x.sum().item()  # expect: TPM801
    win.drain()
    return x, total


def _open(op):
    return async_span(op, nbytes=0)


def leak(op):
    h = _open(op)  # expect: TPM802
    return op
