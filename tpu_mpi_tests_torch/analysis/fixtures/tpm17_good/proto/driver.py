"""TPM17xx good: every rank runs the handshake."""

from proto.comms import fanout


def open_sweep(value):
    return fanout(value, "sweep:open")
