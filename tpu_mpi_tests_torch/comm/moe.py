"""MoE token routing: capacity-bucketed all-to-all dispatch and combine
(≅ ``tpu_mpi_tests/comm/moe.py``), one process per rank.

In a mixture-of-experts layer every rank holds a shard of the token
stream, each token names a destination expert (one expert per rank
here), and the layer is two variable-occupancy all-to-all hops: dispatch
the tokens to their experts, combine the processed tokens back to their
source positions. The collective's buffers are fixed: every (source,
expert) pair gets ``capacity`` slots, tokens beyond it are DROPPED (the
standard MoE overflow rule), and the drop accounting — occupancy,
overflow %, per-expert imbalance — is a measurement of its own
(``kind: "route"`` records).

Semantics (the JAX module's, held against :func:`route_reference`):

* token ``t`` of rank ``r`` with destination ``e`` is routed iff fewer
  than ``capacity`` earlier tokens of rank ``r`` (local order) named
  ``e``; routed tokens return as ``(e+1)·x`` when ``scale`` (the
  analytic expert), dropped tokens as zeros — exact in every dtype for
  integer-valued inputs;
* the dispatch buffer is ``(world, capacity, D)`` a rank; empty slots
  carry zeros and stay zero through the expert.

Each hop is ``torch.distributed.all_to_all_single`` over the world (NCCL
on the card, gloo on the CPU; the identity at world 1). The combine hop
is a tunable schedule (``moe/combine``): the inverse all-to-all (the
prior) or an all-gather of the processed buffers with a
local slot select. Like the JAX module, whose hops are XLA collectives,
this path has no hand kernel: it is library collectives and plain torch
ops.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.distributed as tdist

from tpu_mpi_tests_torch.comm import dist
from tpu_mpi_tests_torch.comm.collectives import _gather_into, _group_for
from tpu_mpi_tests_torch.comm.topology import mesh_link_meta
from tpu_mpi_tests_torch.instrument import telemetry
from tpu_mpi_tests_torch.instrument.telemetry import span_call
from tpu_mpi_tests_torch.tune import priors as _priors
from tpu_mpi_tests_torch.tune.registry import declare_space
from tpu_mpi_tests_torch.tune.registry import resolve as _tune_resolve

#: the combine-hop schedule knob; prior "alltoall" keeps untuned runs on
#: the symmetric dispatch/combine pair
MOE_COMBINE_SPACE = declare_space(
    "moe/combine",
    (_priors.MOE_COMBINE, "allgather"),
    describe="MoE combine hop: inverse all_to_all vs all_gather + "
             "local slot select",
)


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.bfloat16`` → ``"bfloat16"``: the schedule cache's dtype
    key, the JAX package's spelling."""
    return str(dtype).removeprefix("torch.")


def resolve_combine(explicit=None, **ctx) -> str:
    """Combine-hop variant: explicit > cached winner > prior, with no
    device-level fallback (the optimum is payload-sensitive: the
    allgather variant moves world× the bytes). A malformed cached value
    gives the prior."""
    val = _tune_resolve(
        "moe/combine", explicit=explicit, prior=_priors.MOE_COMBINE,
        device_fallback=False, **ctx,
    )
    return val if val in ("alltoall", "allgather") else _priors.MOE_COMBINE


@dataclasses.dataclass(frozen=True)
class RouteStats:
    """Host-side accounting of one routed step (the JAX class).

    ``counts[r, e]`` is rank ``r``'s demand for expert ``e`` (before
    drops); ``expert_load[e]`` the tokens expert ``e`` received (after
    the capacity cut). ``occupancy_pct`` is routed tokens over the total
    slot capacity (``world² · capacity``), ``imbalance`` the max/mean
    ratio of per-expert load (1.0 = balanced)."""

    world: int
    capacity: int
    counts: np.ndarray  # (world, world) int64

    @property
    def tokens(self) -> int:
        return int(self.counts.sum())

    @property
    def routed(self) -> int:
        return int(np.minimum(self.counts, self.capacity).sum())

    @property
    def dropped(self) -> int:
        return self.tokens - self.routed

    @property
    def overflow_pct(self) -> float:
        return 100.0 * self.dropped / self.tokens if self.tokens else 0.0

    @property
    def expert_load(self) -> np.ndarray:
        return np.minimum(self.counts, self.capacity).sum(axis=0)

    @property
    def occupancy_pct(self) -> float:
        cap_total = self.world * self.world * self.capacity
        return 100.0 * self.routed / cap_total if cap_total else 0.0

    @property
    def imbalance(self) -> float:
        load = self.expert_load.astype(np.float64)
        mean = load.mean() if load.size else 0.0
        return float(load.max() / mean) if mean > 0 else 1.0

    def record(self, op: str = "moe", **extra) -> dict:
        """The ``kind: "route"`` JSONL record."""
        return {
            "kind": "route",
            "op": op,
            "world": self.world,
            "capacity": self.capacity,
            "tokens": self.tokens,
            "routed": self.routed,
            "dropped": self.dropped,
            "overflow_pct": self.overflow_pct,
            "occupancy_pct": self.occupancy_pct,
            "imbalance": self.imbalance,
            "expert_load": [int(v) for v in self.expert_load],
            **extra,
        }


def _all_to_all(t: torch.Tensor) -> torch.Tensor:
    """Block ``i`` of ``t`` (split along dim 0 into world blocks) to rank
    ``i``; block ``j`` of the result came from rank ``j``."""
    if dist.world().size == 1:
        return t
    out = torch.empty_like(t)
    tdist.all_to_all_single(out, t.contiguous(), group=_group_for(t))
    return out


def _all_gather(t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` stacked along a new dim 0."""
    w = dist.world().size
    if w == 1:
        return t[None]
    out = torch.empty((w * t.shape[0],) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    return _gather_into(out, t).view((w,) + tuple(t.shape))


@functools.lru_cache(maxsize=None)
def moe_route_fn(capacity: int, combine: str = "alltoall",
                 scale: bool = True):
    """The routed step over the world's ranks (≅ JAX ``moe_route_fn``,
    built once per configuration): ``route(x, dest)`` on this rank's
    ``(T_local, D)`` tokens and their destinations returns ``(y,
    counts)``, the routed-and-processed tokens (dropped positions zero)
    and the ``(world, world)`` demand matrix (row = source rank), every
    rank's copy the same."""

    def route(x: torch.Tensor, dest: torch.Tensor):
        w = dist.world()
        world, rank = w.size, w.rank
        d_model = x.shape[1]
        dest = dest.to(device=x.device, dtype=torch.int64)
        oh = (dest[:, None] == torch.arange(world, device=x.device)[None, :])
        oh = oh.to(torch.int64)  # (T, w)
        # each token's place in its destination group (exclusive running
        # count): the capacity cut is per (source, destination)
        cum = torch.cumsum(oh, dim=0) - oh
        pos = torch.gather(cum, 1, dest[:, None])[:, 0]
        counts = oh.sum(dim=0)  # (w,) this rank's demand per expert
        keep = pos < capacity
        # destination-major buckets of `capacity` slots; an overflow
        # token goes to the spare row past the buckets, which is cut off
        slot = torch.where(keep, dest * capacity + pos,
                           torch.full_like(pos, world * capacity))
        send = torch.zeros((world * capacity + 1, d_model), dtype=x.dtype,
                           device=x.device)
        send[slot] = x
        send = send[:world * capacity].view(world, capacity, d_model)
        recv = _all_to_all(send)
        # the expert on this rank: (e+1)·x, exact on integer values, and
        # zero slots stay zero
        proc = recv * (rank + 1) if scale else recv
        if combine == "allgather":
            # every expert's processed buffer; my source slot is [:, rank]
            back = _all_gather(proc)[:, rank]
        else:
            back = _all_to_all(proc)
        flat = back.reshape(world * capacity, d_model)
        y = flat[torch.where(keep, slot, torch.zeros_like(slot))] \
            * keep[:, None].to(x.dtype)
        return y, _all_gather(counts)

    return route


def route_payload_bytes(x, world: int, capacity: int,
                        combine: str = "alltoall") -> int:
    """The span's payload model (aggregate over the ranks, the JAX
    convention): each all-to-all hop moves ``(w−1)/w`` of every rank's
    ``(w, capacity, D)`` buffer; the allgather combine receives the
    ``w−1`` foreign buffers whole."""
    d_model = int(x.shape[-1])
    item = x.element_size() if isinstance(x, torch.Tensor) else 4
    buf = world * capacity * d_model * item  # a rank's dispatch buffer
    dispatch = (world - 1) * buf  # w ranks × (w−1)/w × buf
    if combine == "allgather":
        return dispatch + world * (world - 1) * buf
    return 2 * dispatch


def route_tokens(x: torch.Tensor, dest: torch.Tensor, capacity: int,
                 combine: "str | None" = None, scale: bool = True,
                 op: str = "moe"):
    """One routed MoE step with accounting: dispatch → expert → combine
    (≅ JAX ``route_tokens``). ``x`` is this rank's ``(T_local, D)``
    block of the token stream, ``dest`` its destinations (values in
    ``[0, world)``), ``capacity`` the per-(source, expert) slot count.
    Returns ``(y, RouteStats)``, ``y`` shaped like ``x``. The call is an
    ``op`` telemetry span with the dispatch+combine payload model, and
    with telemetry on the accounting also goes to the sink as a ``kind:
    "route"`` record."""
    if capacity < 1:
        raise ValueError(f"capacity must be positive, got {capacity}")
    world = dist.world().size
    combine = resolve_combine(
        combine, dtype=dtype_name(x.dtype), n=x.shape[0] * world,
        world=world,
    )
    y, counts = span_call(
        op, moe_route_fn(int(capacity), combine, scale), x, dest,
        nbytes=route_payload_bytes(x, world, capacity, combine),
        axis_name="shard", world=world, combine=combine,
        capacity=int(capacity), **(mesh_link_meta() if telemetry.armed() else {}),
    )
    stats = RouteStats(world=world, capacity=int(capacity),
                       counts=counts.cpu().numpy().astype(np.int64))
    telemetry.emit(stats.record(op=op, combine=combine))
    return y, stats


def route_reference(x, dest, world: int, capacity: int,
                    scale: bool = True) -> np.ndarray:
    """Dense host reference of the routed step (numpy; the JAX
    function): the same first-``capacity``-per-(source, destination)
    drop rule in local shard order, dropped tokens zero, routed tokens
    ``(e+1)·x``."""
    x = np.asarray(x)
    dest = np.asarray(dest)
    t_local = x.shape[0] // world
    y = np.zeros_like(x)
    for r in range(world):
        taken = np.zeros(world, np.int64)
        for t in range(r * t_local, (r + 1) * t_local):
            e = int(dest[t])
            if taken[e] < capacity:
                taken[e] += 1
                y[t] = x[t] * (e + 1) if scale else x[t]
    return y
