"""The span hook slot and its reader on the hot path."""

_SPAN_HOOK = None


def fire(op):
    hook = _SPAN_HOOK
    if hook is not None:
        hook(op)
