"""TPM8xx suppressed: the one sanctioned in-region sync, the overlapped
compute itself, which must finish under its phase bracket."""

from tpu_mpi_tests_torch.instrument.telemetry import async_span
from tpu_mpi_tests_torch.instrument.timers import block_stream


def pipelined_step(exchange_fn, core_fn, z):
    h = async_span("halo_exchange", nbytes=1024)
    ex = exchange_fn(z)
    # the overlapped interior compute IS the measured phase; block_stream
    # waits for the core's stream only, the exchange stays in flight
    out = block_stream(core_fn(z))  # tpumt: ignore[TPM801]
    h.done(ex)
    return ex, out
