"""Fleet broadcast (≅ ``tpu_mpi_tests/tune/fleet.py``): replicate rank 0's
decisions to every process.

The rank-0-swept, broadcast-applied sweep (``tune/sweep.py``) needs one
primitive: a small JSON-serialisable value computed on process 0,
delivered verbatim to every process at a point every process reaches
together. :func:`bcast` is that primitive, consumed in one shape::

    if fleet.process_index() == 0:
        decision = ...          # only rank 0 computes the value
    else:
        decision = None         # a placeholder, not a value
    decision = bcast(decision, tag)   # now the same on every rank

The transport is the key-value store of the world's ``torch.distributed``
process group (the store its gloo host group, ``comm/dist.py``,
rendezvoused on; the analogue of the JAX package's coordination-service
store): rank 0 sets the payload under a sequence-numbered key, every
other rank waits for the key, at most ``TPU_MPI_FLEET_TIMEOUT_S``
seconds (default :data:`KV_TIMEOUT_S`), and then raises naming the tag.
Every process calls :func:`bcast` the same number of times in the same
order (the sweep guarantees it), so the per-process counters agree. A
run of one process is the identity. A run of several processes with no
process group raises :class:`FleetUnavailable`; callers then resolve
cached > prior without a sweep.
"""

from __future__ import annotations

import datetime
import itertools
import json
import os

#: the largest payload a decision may be (bytes of JSON, a 4-byte length
#: prefix included, as in the JAX package): schedule values are ints,
#: strings and flat dicts, so a decision that does not fit is a bug
MAX_PAYLOAD = 4096

#: how long a rank waits for rank 0's decision (seconds;
#: ``TPU_MPI_FLEET_TIMEOUT_S`` overrides): the ranks measure the same
#: candidates at once, so the wait is bounded by their skew
KV_TIMEOUT_S = 600.0

_SEQ = itertools.count()


class FleetUnavailable(RuntimeError):
    """No broadcast transport in this process: several processes and no
    process group."""


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The processes of the run: the process group's size, else the
    launcher's ``WORLD_SIZE`` (1 when neither says)."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1") or 1)


def _encode(obj) -> str:
    payload = json.dumps(obj)
    if len(payload.encode("utf-8")) > MAX_PAYLOAD - 4:
        raise ValueError(
            f"fleet broadcast payload of {len(payload.encode('utf-8'))} "
            f"bytes exceeds {MAX_PAYLOAD - 4} (schedule decisions are tiny "
            f"by the cache contract)"
        )
    return payload


def _store():
    import torch.distributed as dist

    if not dist.is_initialized():
        raise FleetUnavailable(
            "no fleet broadcast transport: several processes and no "
            "torch.distributed process group"
        )
    return dist.distributed_c10d._get_default_store()


def timeout_s() -> float:
    return float(os.environ.get("TPU_MPI_FLEET_TIMEOUT_S", KV_TIMEOUT_S))


def bcast(obj, tag: str = ""):
    """Replicate rank 0's JSON-serialisable ``obj`` to every process
    (the identity at one process). Raises ``ValueError`` for a payload
    over :data:`MAX_PAYLOAD` and ``TimeoutError`` naming ``tag`` when
    rank 0's value does not come within :func:`timeout_s`."""
    if process_count() <= 1:
        return obj
    store = _store()
    key = f"tpumt/tune/{tag}/{next(_SEQ)}"
    if process_index() == 0:
        payload = _encode(obj)
        store.set(key, payload)
        return json.loads(payload)
    wait_s = timeout_s()
    try:
        store.wait([key], datetime.timedelta(seconds=wait_s))
    except RuntimeError as e:  # the store's timeout (DistStoreError)
        raise TimeoutError(
            f"fleet broadcast {tag!r}: rank {process_index()} waited "
            f"{wait_s:g} s for rank 0's decision "
            f"(TPU_MPI_FLEET_TIMEOUT_S) ({e})"
        ) from None
    return json.loads(store.get(key).decode("utf-8"))
