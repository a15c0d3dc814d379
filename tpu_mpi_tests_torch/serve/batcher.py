"""Request batching for the serving loop (≅
``tpu_mpi_tests/serve/batcher.py``, the same splits).

Dispatching one device call per request pays the host path of a launch
once a request; a serving loop therefore coalesces queued requests into
batches. The rule that makes coalescing *correct* is compatibility: two
requests share a batch iff they are the same workload class — same
handler, same shape, same dtype (equality on
:attr:`WorkloadClass.key <tpu_mpi_tests_torch.serve.workloads.
WorkloadClass.key>`). Crossing dtype or shape class would execute a
different program than either request asked for.

Scheduling is head-of-queue FIFO: the oldest waiting request picks the
class, then the batch greedily collects *later* same-class requests up
to ``max_batch``. Other classes keep their relative order, so a burst of
one class cannot starve another beyond its own service time.

Pure stdlib; requests are whatever objects carry a ``.cls`` with a
``.key`` (the loop's ``Request``).
"""

from __future__ import annotations


def coalesce(queue: list, max_batch: int) -> tuple[list, list]:
    """Pop one batch off ``queue``: the head request plus up to
    ``max_batch - 1`` later requests of the same class, order preserved
    on both sides. Returns ``(batch, remaining)``; an empty queue
    returns ``([], [])``."""
    if not queue:
        return [], []
    if max_batch < 1:
        max_batch = 1
    key = queue[0].cls.key
    batch: list = []
    rest: list = []
    for i, req in enumerate(queue):
        if req.cls.key == key:
            batch.append(req)
            if len(batch) == max_batch:
                # batch full: the remainder moves wholesale (a slice
                # copy, not a per-item key scan) — the loop calls this
                # per batch, so a deep queue must not cost a full walk
                rest.extend(queue[i + 1:])
                break
        else:
            rest.append(req)
    return batch, rest
