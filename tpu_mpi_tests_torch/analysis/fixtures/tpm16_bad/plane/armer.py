"""TPM1603 bad: the slot is rebound to a live hook with no ``= None``
disarm anywhere in this file."""

from plane import slots


def arm(trace):
    slots._SPAN_HOOK = _make(trace)  # expect: TPM1603


def _make(trace):
    def hook(op):
        trace.append(op)
    return hook
