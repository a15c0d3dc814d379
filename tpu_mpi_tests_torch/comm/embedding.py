"""Sharded embedding gather and scatter-add (≅
``tpu_mpi_tests/comm/embedding.py``), one process per rank.

A ``(vocab, d_model)`` table too large to replicate lives row-sharded
across the ranks (rank r holds rows ``[r·V_local, (r+1)·V_local)``); a
batch of token ids comes back as dense rows, and the training-side dual
pushes update rows into the owning shards:

* **lookup** — each rank resolves the ids in its row range (foreign ids
  contribute zeros) and one ``all_reduce`` (sum) assembles the
  replicated ``(B, d_model)`` rows;
* **scatter-add** — ids and updates arrive batch-sharded, an all-gather
  replicates them, and each rank adds only the rows it owns
  (``index_add_``; duplicate ids accumulate).

The local gather is a tunable schedule (``embedding/lookup``): ``take``
(a row gather, the prior) or ``onehot`` (a one-hot ``torch.matmul``),
keyed by dtype, vocabulary, batch and world. The JAX module computes
both with plain XLA ops (a gather or a matmul, ``psum``, ``all_gather``)
and no Pallas kernel, so torch ops and library collectives are the
faithful port. Lookups copy rows and the scatter sums integer-valued
rows, so both are exact in every dtype on integer-valued data.
"""

from __future__ import annotations

import torch
import torch.distributed as tdist

from tpu_mpi_tests_torch.comm import dist
from tpu_mpi_tests_torch.comm.collectives import _all_gather, _group_for
from tpu_mpi_tests_torch.comm.moe import dtype_name
from tpu_mpi_tests_torch.comm.topology import mesh_link_meta
from tpu_mpi_tests_torch.instrument.telemetry import armed, span_call
from tpu_mpi_tests_torch.tune import priors as _priors
from tpu_mpi_tests_torch.tune.registry import declare_space
from tpu_mpi_tests_torch.tune.registry import resolve as _tune_resolve

#: the local-gather schedule knob; prior "take" (a row gather)
EMBED_LOOKUP_SPACE = declare_space(
    "embedding/lookup",
    (_priors.EMBED_LOOKUP, "onehot"),
    describe="sharded embedding local gather: dynamic take vs one-hot "
             "matmul",
)


def resolve_lookup(explicit=None, **ctx) -> str:
    """Lookup variant: explicit > cached winner > prior ("take"), with
    no device-level fallback (the one-hot matmul is O(B·V_local): a
    small-vocabulary winner says nothing of a large shard). A malformed
    cached value gives the prior."""
    val = _tune_resolve(
        "embedding/lookup", explicit=explicit, prior=_priors.EMBED_LOOKUP,
        device_fallback=False, **ctx,
    )
    return val if val in ("take", "onehot") else _priors.EMBED_LOOKUP


def lookup_local(table: torch.Tensor, ids: torch.Tensor,
                 variant: str = "take") -> torch.Tensor:
    """This rank's partial rows (≅ the JAX lookup body before its
    ``psum``): ``table`` is this rank's ``(V_local, D)`` shard, ``ids``
    the replicated batch; rows owned elsewhere are zero."""
    w = dist.world()
    v_local = table.shape[0]
    local = ids.to(device=table.device, dtype=torch.int64) - w.rank * v_local
    ok = (local >= 0) & (local < v_local)
    if variant == "onehot":
        oh = local[:, None] == torch.arange(v_local,
                                            device=table.device)[None, :]
        return torch.matmul((oh & ok[:, None]).to(table.dtype), table)
    rows = table[local.clamp(0, v_local - 1)]
    return rows * ok[:, None].to(table.dtype)


def _lookup(table: torch.Tensor, ids: torch.Tensor,
            variant: str) -> torch.Tensor:
    rows = lookup_local(table, ids, variant)
    if dist.world().size > 1:
        tdist.all_reduce(rows, op=tdist.ReduceOp.SUM,
                         group=_group_for(rows))
    return rows


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor,
                     variant: "str | None" = None) -> torch.Tensor:
    """``table[ids]`` of the row-sharded table (≅ JAX
    ``embedding_lookup``): ``table`` is this rank's ``(V_local, D)``
    shard, ``ids`` the replicated id vector; returns the replicated
    ``(B, D)`` rows. An ``embedding_lookup`` span with the JAX payload
    model (the allreduce of partial rows, ``2(w−1)·B·D`` bytes over the
    ranks)."""
    world = dist.world().size
    variant = resolve_lookup(
        variant, dtype=dtype_name(table.dtype), n=table.shape[0] * world,
        bytes=int(ids.shape[0]), world=world,
    )
    row_bytes = int(ids.shape[0]) * int(table.shape[1]) \
        * table.element_size()
    return span_call(
        "embedding_lookup", _lookup, table, ids, variant,
        nbytes=2 * (world - 1) * row_bytes, axis_name="shard",
        world=world, variant=variant, **(mesh_link_meta() if armed() else {}),
    )


def _scatter_add(table: torch.Tensor, ids: torch.Tensor,
                 updates: torch.Tensor) -> torch.Tensor:
    w = dist.world()
    v_local = table.shape[0]
    ids_all = _all_gather(ids.to(device=table.device, dtype=torch.int64), 0)
    upd_all = _all_gather(updates, 0)
    local = ids_all - w.rank * v_local
    ok = (local >= 0) & (local < v_local)
    # only the rows this rank owns; foreign rows never touch the shard
    return table.index_add_(0, local[ok], upd_all[ok])


def embedding_scatter_add(table: torch.Tensor, ids: torch.Tensor,
                          updates: torch.Tensor) -> torch.Tensor:
    """Push batch-sharded update rows into the owning table shards (≅
    JAX ``embedding_scatter_add``): ``ids`` ``(B_local,)`` and
    ``updates`` ``(B_local, D)`` are this rank's blocks of the batch,
    ``table`` this rank's ``(V_local, D)`` shard, updated in place and
    returned (the JAX function donates it). Duplicate ids accumulate.
    Payload model: the id+update all-gather, ``(w−1)·(B·D·item + B·4)``
    bytes over the ranks."""
    world = dist.world().size
    batch = int(ids.shape[0]) * world
    nbytes = (world - 1) * (
        updates.numel() * updates.element_size() * world + batch * 4)
    return span_call(
        "embedding_scatter_add", _scatter_add, table, ids, updates,
        nbytes=nbytes, axis_name="shard", world=world, **(mesh_link_meta() if armed() else {}),
    )
