"""TPM8xx good: the syncs come after the consume point, the device-side
orderings (wait_stream, Event.wait) are no syncs, and every handle is
closed."""

import torch

from tpu_mpi_tests_torch.comm.collectives import DispatchWindow
from tpu_mpi_tests_torch.instrument.telemetry import async_span


def pipelined_step(exchange_fn, core_fn, z, comm, ev):
    h = async_span("halo_exchange", nbytes=1024)
    comm.wait_stream(torch.cuda.current_stream())
    ex = exchange_fn(z)
    out = core_fn(z)
    ev.wait()
    h.done(ex)
    torch.cuda.synchronize()
    return ex, out


def chained(fn, x, n):
    win = DispatchWindow(4)
    for _ in range(n):
        x = win.call("allreduce", fn, x)
    win.drain()
    return x, x.sum().item()


def _open(op):
    return async_span(op, nbytes=0)


def closed(op, x):
    h = _open(op)
    h.done(x)
    return x
