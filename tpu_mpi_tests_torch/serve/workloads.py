"""The mixed-workload table: what a serving run executes (≅
``tpu_mpi_tests/serve/workloads.py``, a copy of its grammar, its error
messages and its draw stream).

A server does not serve one shape but a *mix*, and the schedule-cache
fingerprint space (``tune/fingerprint.py`` keys on op × shape bucket ×
dtype) is only exercised when the traffic mixes classes. A workload table
is a weighted list of :class:`WorkloadClass` entries; every request draws
its class from the table under a seeded RNG, so a run's class sequence is
reproducible — and the same as the JAX package's for the same table and
seed.

Spec grammar (CLI ``--workloads``, comma-separated entries)::

    name[:shape[:dtype[:weight]]]

``shape`` is ``x``-separated dims (``256x64``); ``dtype``/``weight``
default to float32 / 1. Omitted fields fall back to the per-workload
defaults in :data:`DEFAULT_SHAPES`. The default table
(:data:`DEFAULT_TABLE`) exercises four handler families — daxpy step,
stencil1d halo step, ring-attention block, small-payload allreduce; the
serving-era classes (``moe`` token routing, ``decode`` collectives,
``embedding`` lookup, registered by their workload specs) join a mix by
naming them in the table (``moe:2048x64:float32:2``).

The handlers live with their drivers and specs (the
``drivers/_common.py`` workload registry); this module is the pure
(stdlib-only) table layer, shared by the loop and the tests.
"""

from __future__ import annotations

import random
from dataclasses import dataclass

#: the dtypes the driver layer accepts (mirrors ``base_parser --dtype``)
VALID_DTYPES = ("float32", "float64", "bfloat16")

#: per-workload default shapes (elements; attn is (L, head_dim), moe is
#: (tokens, d_model), decode is (batch, heads), embedding is
#: (vocab, batch, d_model))
DEFAULT_SHAPES = {
    "daxpy": (65536,),
    "halo": (65536,),
    "attn": (256, 64),
    "allreduce": (4096,),
    "moe": (2048, 64),
    "decode": (8, 16),
    "embedding": (65536, 256, 64),
}

#: the out-of-the-box mix: all four handler families, small shapes, with
#: weights skewed toward the cheap classes the way decode-heavy serving
#: traffic skews toward small-payload latency-bound ops
DEFAULT_TABLE = (
    "daxpy:65536:float32:4,halo:65536:float32:2,"
    "attn:256x64:float32:1,allreduce:4096:float32:3"
)


@dataclass(frozen=True)
class WorkloadClass:
    """One row of the workload table. ``key`` is the coalescing class:
    requests batch together iff their keys are equal (the batcher's
    never-across-dtype/shape rule is equality on this string)."""

    workload: str
    shape: tuple[int, ...]
    dtype: str = "float32"
    weight: float = 1.0

    @property
    def key(self) -> str:
        dims = "x".join(str(d) for d in self.shape)
        return f"{self.workload}:{dims}:{self.dtype}"

    @property
    def nbytes(self) -> int:
        """Nominal payload bytes of one request (shape × itemsize) — the
        span annotation, not a bandwidth claim."""
        n = 1
        for d in self.shape:
            n *= d
        item = 8 if self.dtype == "float64" else (
            2 if self.dtype == "bfloat16" else 4
        )
        return n * item


def parse_workload_table(spec: str) -> list[WorkloadClass]:
    """Parse a ``--workloads`` spec into classes. Raises ``ValueError``
    with a caller-printable message on malformed entries — the driver
    turns that into an ERROR line + exit 2, never a traceback."""
    classes: list[WorkloadClass] = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        name = parts[0]
        if name not in DEFAULT_SHAPES:
            raise ValueError(
                f"unknown workload {name!r}; valid: "
                f"{','.join(sorted(DEFAULT_SHAPES))}"
            )
        shape = DEFAULT_SHAPES[name]
        dtype = "float32"
        weight = 1.0
        try:
            if len(parts) > 1 and parts[1]:
                shape = tuple(int(d) for d in parts[1].split("x"))
            if len(parts) > 2 and parts[2]:
                dtype = parts[2]
            if len(parts) > 3 and parts[3]:
                weight = float(parts[3])
        except ValueError:
            raise ValueError(f"malformed workload entry {entry!r} "
                             f"(want name[:shape[:dtype[:weight]]])")
        if len(parts) > 4:
            raise ValueError(f"malformed workload entry {entry!r}: "
                             f"too many fields")
        if dtype not in VALID_DTYPES:
            raise ValueError(
                f"unknown dtype {dtype!r} in {entry!r}; valid: "
                f"{','.join(VALID_DTYPES)}"
            )
        if not shape or any(d < 1 for d in shape):
            raise ValueError(f"shape must be positive dims in {entry!r}")
        if not weight > 0:
            raise ValueError(f"weight must be positive in {entry!r}")
        classes.append(WorkloadClass(name, shape, dtype, weight))
    if not classes:
        raise ValueError(f"empty workload table {spec!r}")
    keys = [c.key for c in classes]
    dupes = {k for k in keys if keys.count(k) > 1}
    if dupes:
        raise ValueError(
            f"duplicate workload classes: {','.join(sorted(dupes))}"
        )
    return classes


class WorkloadMix:
    """Weighted class drawer under a seeded RNG stream (separate from
    the arrival-process stream, so changing the mix never perturbs the
    arrival schedule and vice versa)."""

    def __init__(self, classes: list[WorkloadClass], seed: int = 0):
        self.classes = list(classes)
        self._weights = [c.weight for c in self.classes]
        self._rng = random.Random(f"mix:{seed}")

    def draw(self) -> WorkloadClass:
        return self._rng.choices(self.classes, self._weights)[0]
