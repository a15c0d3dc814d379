"""TPM1703 bad: the rank that catches skips the partner op."""

from proto.comms import global_sum


def reduce_or_skip(t):
    out = t
    try:  # expect: TPM1703
        out = global_sum(t)
    except RuntimeError:
        pass
    return out
