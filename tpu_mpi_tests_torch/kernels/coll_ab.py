"""A/B timing of the ring collectives' vec16 route under other unroll
depths and step counts, for the card:

    python -m tpu_mpi_tests_torch.kernels.coll_ab base u2 u8 base

Each variant is a copy of the package under ``build/coll_ab/<name>/``
(listed in ``.gitignore``) with ``kUnroll`` of
``csrc/ring_collectives.cu`` — the 16-byte loads a thread has in flight —
changed: ``u1``, ``u2``, ``u8`` (the tree: 4, ``base``); or with the
count that ends a CTA's step (``coll_arrive_cta`` of
``csrc/ring_common.cuh``; the tree: one ``atom.acq_rel.sys`` add)
changed to a relaxed add between two ``__threadfence_system()`` (the
second in the last CTA only), ``fence``, or between two
``fence.acq_rel.sys``, ``acqrel``. Each is built
and timed in its own process, in the order given, so that two versions
compare within one call (base, change, change, base). One JSON line per
run: the registers and spill bytes of the vec16 instances, and the
queued time of one launch (behind a stall: the wrapper's host time out)
at the operands of ``chip_smoke.py``'s ``TIME collectives``: the
world=1 copies of 2 MiB and 16 MiB float32 and 1 GiB float64, and the
4-step self-ring at a 16 MiB float32 shard (the all-gather, and the
reduce-scatter at credits 1 and 2), each checked bit for bit against
its plain version; then the self-ring at a 4 KiB float32 chunk and k = 2
and 8, where the steps' signalling is all the time there is (the
difference over six steps prices one step).
"""

from __future__ import annotations

import re
import sys

from tpu_mpi_tests_torch.kernels import flash_ab

_UNROLL = "constexpr int kUnroll = 4;"
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
    **{f"u{u}": (("ring_collectives.cu", _UNROLL,
                  f"constexpr int kUnroll = {u};"),) for u in (1, 2, 8)},
    "fence": (("ring_common.cuh", _COUNT, _COUNT_FENCED),),
    "acqrel": (("ring_common.cuh", _COUNT, _COUNT_FENCED.replace(
        "__threadfence_system();",
        'asm volatile("fence.acq_rel.sys;" ::: "memory");')),),
}


def measure(name: str) -> dict:
    """Build the package this process imported and time the kernels."""
    import torch

    from tpu_mpi_tests_torch.kernels import build, hand

    build.build(["ring_collectives"])
    row = {"variant": name}
    entry = None
    for ln in build.BUILD_LOGS.get("ring_collectives", "").splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", ln):
            entry = m[1] if "5uint4" in m[1] else None
        elif entry and (m := re.search(r"Used (\d+) registers", ln)):
            row.setdefault("registers", []).append(int(m[1]))
        elif entry and (m := re.search(r"(\d+) bytes spill stores", ln)):
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
    return row


if __name__ == "__main__":
    sys.exit(flash_ab.main(module="coll_ab", variants=VARIANTS,
                           default=("base", "u2")))
