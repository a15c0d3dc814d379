"""``--debug-nans`` (≅ ``jax_debug_nans``, the JAX drivers' sanitizer
axis): once armed, every comm wrapper (through
:func:`~tpu_mpi_tests_torch.instrument.telemetry.span_call`) and every
hand-kernel wrapper of ``kernels/hand.py`` (:func:`checked`) checks its
output with ``torch.isnan(...).any()`` and raises ``FloatingPointError``
naming the op. The check reads a flag to the host, so it waits for the
op; unarmed, it is one attribute check and adds no launch. Under CUDA
graph capture it checks nothing (no host read is legal there); the
chain's final state is checked after the replays instead."""

from __future__ import annotations

import functools

import torch

from tpu_mpi_tests_torch.instrument.telemetry import (
    _under_capture,
    registry,
)


def arm(on: bool = True) -> None:
    """Arm (or disarm) the NaN checks for this process."""
    registry().set_check_nans(on)


def armed() -> bool:
    return registry().check_nans


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for t in out:
            yield from _tensors(t)


def check(op: str, out):
    """``out`` unchanged; raises ``FloatingPointError`` naming ``op``
    when armed and any floating tensor in ``out`` holds a NaN."""
    if not registry().check_nans or _under_capture():
        # a body captured into a CUDA graph cannot read to the host:
        # timers.chain_rate checks the replayed chain's final state
        return out
    for t in _tensors(out):
        if t.is_floating_point() and bool(torch.isnan(t).any()):
            raise FloatingPointError(
                f"--debug-nans: NaN in the output of {op} "
                f"(shape {tuple(t.shape)}, {t.dtype})")
    return out


def checked(fn):
    """Decorate a kernel wrapper: its result goes through :func:`check`
    under the wrapper's name. The wrapper's attributes (its launch
    counts) live on the decorated function, which is what the module
    name binds."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        if registry().check_nans:
            check(fn.__name__, out)
        return out

    return wrapper
