"""TPM16xx suppressed: a hook armed for the life of the process."""

from plane import slots


def arm(trace):
    # a process-lifetime tracer: nothing ever disarms it by design
    slots._SPAN_HOOK = _make(trace)  # tpumt: ignore[TPM1603]


def _make(trace):
    def hook(op):
        trace.append(op)
    return hook
