"""TPM17xx good: the verdict is local, the collective outside the try."""

from proto.comms import global_sum


def reduce_checked(t, check):
    ok = True
    try:
        check(t)
    except RuntimeError:
        ok = False
    global_sum(t)
    return ok
