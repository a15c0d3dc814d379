"""TPM17xx good: the trip count is replicated."""

from proto.comms import global_sum


def drain(t, n):
    for _ in range(n):
        t = global_sum(t)
    return t
