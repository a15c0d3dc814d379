"""TPM17xx suppressed: a raise here is the same on every rank."""

from proto.comms import global_sum


def reduce_or_skip(t):
    out = t
    # the only raiser is a backend without all_reduce: every rank's
    try:  # tpumt: ignore[TPM1703]
        out = global_sum(t)
    except RuntimeError:
        pass
    return out
