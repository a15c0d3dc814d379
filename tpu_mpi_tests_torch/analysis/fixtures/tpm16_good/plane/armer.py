"""TPM16xx good: the arm/disarm pair."""

from plane import slots


def arm(trace):
    slots._SPAN_HOOK = _make(trace)


def disarm():
    slots._SPAN_HOOK = None


def _make(trace):
    def hook(op):
        trace.append(op)
    return hook
