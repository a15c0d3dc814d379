"""A/B timing of the peer-store kernels' vec16 route (the ring
collectives, the one-shot kernel, the ring halo) under other unroll
depths and counts, for the card:

    python -m tpu_mpi_tests_torch.kernels.coll_ab base u2 u8 base

Each variant is a copy of the package under ``build/coll_ab/<name>/``
(listed in ``.gitignore``) with ``kUnroll`` — the 16-byte loads a thread
has in flight — of ``csrc/ring_collectives.cu``, ``csrc/oneshot.cu`` and
``csrc/ring_halo.cu`` changed: ``u1``, ``u2``, ``u8`` (the tree: 4,
``base``); or with the count that ends a CTA's share
(``coll_arrive_cta`` of ``csrc/ring_common.cuh``, which
``ring_arrive_cta`` calls; the tree: one ``atom.acq_rel.sys`` add)
changed to a relaxed add between two ``__threadfence_system()`` (the
second in the last CTA only), ``fence``, or between two
``fence.acq_rel.sys``, ``acqrel``; or with the ring halo's one-card
self-ring signalling at system scope, as across cards, instead of gpu
scope (``sys``). Each is built and timed in its own
process, in the order given, so that two versions compare within one
call (base, change, change, base). One JSON line per run: the registers
and spill bytes of the vec16 instances, and the queued time of one
launch (behind a stall: the wrapper's host time out), each checked bit
for bit against its plain version, at the operands of ``chip_smoke.py``'s
``TIME collectives``: the world=1 copies of 2 MiB and 16 MiB float32 and
1 GiB float64, the 4-step self-ring at a 16 MiB float32 shard (the
all-gather, and the reduce-scatter at credits 1 and 2), then the
self-ring at a 4 KiB float32 chunk and k = 2 and 8, where the steps'
signalling is all the time there is (the difference over six steps
prices one step); the one-shot gather and sum at world=1 on 16 MiB
float32; and of ``TIME ring_halo``: the periodic self-ring at the
stencil2d --rdma dim-0 shard (axis 0), the bench's rdma-chained buffer
(axis 1, n_bnd 8: all signalling) and the dim-1 shard (8-byte bands: the
scalar route).
"""

from __future__ import annotations

import re
import sys

from tpu_mpi_tests_torch.kernels import flash_ab

_UNROLL = "constexpr int kUnroll = 4;"
#: the sources whose kUnroll the u-variants change
_UNROLLED = ("ring_collectives.cu", "oneshot.cu", "ring_halo.cu")
_COUNT = """  int old;
  asm volatile("atom.acq_rel.sys.global.add.s32 %0, [%1], 1;"
               : "=r"(old) : "l"(counter) : "memory");
  return old == ctas - 1;"""
_COUNT_FENCED = """  __threadfence_system();
  if (atomicAdd(counter, 1) != ctas - 1) return false;
  __threadfence_system();
  return true;"""
#: variant -> (file, old text, new text) edits of the package's sources
VARIANTS = {
    "base": (),
    **{f"u{u}": tuple((file, _UNROLL, f"constexpr int kUnroll = {u};")
                      for file in _UNROLLED) for u in (1, 2, 8)},
    "fence": (("ring_common.cuh", _COUNT, _COUNT_FENCED),),
    "acqrel": (("ring_common.cuh", _COUNT, _COUNT_FENCED.replace(
        "__threadfence_system();",
        'asm volatile("fence.acq_rel.sys;" ::: "memory");')),),
    "sys": (("ring_halo.cu", "const bool one_card = left_z == z",
             "const bool one_card = false && left_z == z"),),
}


def measure(name: str) -> dict:
    """Build the package this process imported and time the kernels."""
    import torch

    from tpu_mpi_tests_torch.kernels import build, hand

    libs = ("ring_collectives", "oneshot", "ring_halo")
    build.build(libs)
    row = {"variant": name}
    entry = None
    for lib in libs:
        for ln in build.BUILD_LOGS.get(lib, "").splitlines():
            if m := re.search(r"Compiling entry function '([^']+)'", ln):
                entry = m[1] if "5uint4" in m[1] else None
            elif entry and (m := re.search(r"Used (\d+) registers", ln)):
                row.setdefault("registers", []).append(int(m[1]))
            elif entry and (m := re.search(r"(\d+) bytes spill stores",
                                           ln)):
                row.setdefault("spill_stores", []).append(int(m[1]))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = (("copy 2 MiB f32", 1 << 19, torch.float32, None, None),
             ("copy 16 MiB f32", 1 << 22, torch.float32, None, None),
             ("copy 1 GiB f64", 1 << 27, torch.float64, None, None),
             ("self-ring k=4 allgather 16 MiB", 1 << 22, torch.float32, 4,
              None),
             ("self-ring k=4 reduce_scatter credits=1", 1 << 22,
              torch.float32, 4, 1),
             ("self-ring k=4 reduce_scatter credits=2", 1 << 22,
              torch.float32, 4, 2),
             *((f"self-ring k={k} allgather 4 KiB", 1024, torch.float32,
                k, None) for k in (2, 8)),
             *((f"self-ring k={k} reduce_scatter credits=2 4 KiB chunk",
                1024 * k, torch.float32, k, 2) for k in (2, 8)))
    for label, n, dtype, k, credits in cases:
        x = torch.randn(n, generator=gen, device=dev).to(dtype)
        if credits is None:
            def fn():
                return hand.ring_allgather(x, self_ring=k)
            want = hand.ring_allgather_ref(x, self_ring=k)
        else:
            def fn():
                return hand.ring_reduce_scatter(x, credits, self_ring=k)
            want = hand.ring_reduce_scatter_ref(x, credits, self_ring=k)
        before = dict(hand.route_counts())
        ms = flash_ab.time_queued(fn, 5 if n * x.element_size() > 1 << 28
                                  else 20)
        got = fn()
        torch.cuda.synchronize()
        name_k = "ring_allgather" if credits is None else \
            "ring_reduce_scatter"
        after = hand.route_counts()[name_k]
        row[label] = {"queued_ms": ms, "exact": bool(torch.equal(got, want)),
                      "vec16": after["vec16"] > before[name_k]["vec16"]}
        del x, got, want
        torch.cuda.empty_cache()
    x = torch.randn(1 << 22, generator=gen, device=dev)
    for op in ("gather", "sum"):
        before = hand.oneshot.launches_by_route["vec16"]
        ms = flash_ab.time_queued(lambda: hand.oneshot(x, op), 20)
        got = hand.oneshot(x, op)
        row[f"oneshot {op} 16 MiB"] = {
            "queued_ms": ms, "exact": bool(torch.equal(
                got, hand.oneshot_ref(x, op))),
            "vec16": hand.oneshot.launches_by_route["vec16"] > before}
    del x
    for shape, axis, n_bnd in (((1028, 1 << 19), 0, 2),
                               ((8192, 8208), 1, 8),
                               ((1 << 19, 1028), 1, 2)):
        z = torch.randn(shape, generator=gen, device=dev)
        want = hand.ring_halo_ref(z.clone(), axis=axis, n_bnd=n_bnd,
                                  periodic=True)
        ms = flash_ab.time_queued(lambda: hand.ring_halo(
            z, axis=axis, n_bnd=n_bnd, periodic=True), 20)
        row[f"ring_halo {shape[0]}x{shape[1]} axis {axis}"] = {
            "queued_ms": ms, "exact": bool(torch.equal(z, want)),
            "route": hand.halo_route(z, axis, n_bnd)}
        del z, want
        torch.cuda.empty_cache()
    return row


if __name__ == "__main__":
    sys.exit(flash_ab.main(module="coll_ab", variants=VARIANTS,
                           default=("base", "u2")))
