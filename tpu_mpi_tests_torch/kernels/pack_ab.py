"""A/B timing of the halo staging copies (``csrc/pack.cu``) under other
compile-time choices and designs, for the card:

    python -m tpu_mpi_tests_torch.kernels.pack_ab base u2 row sector base

Each variant is a copy of the package under ``build/pack_ab/<name>/``
(listed in ``.gitignore``) with ``csrc/pack.cu`` patched: ``u1``, ``u2``,
``u8`` set both ``kUnroll`` (the word pairs a thread has in flight on
axis 0) and ``kSeamUnroll`` (the seams it has in flight on axis 1) to 1,
2 or 8 (the tree: see the source); ``row`` walks axis 1 by rows, a
thread taking one row's two bands, instead of by seams (``kBehind`` 0);
the unpack seam walk's stores, where a row's band is one 8-byte word:
``seam32`` stores a seam whose 4b elements (edges and ghosts) fill one
aligned 32-byte sector as two 16-byte words, the edges rewritten with
the values just read; ``sector`` reads every 32-byte sector that holds a
seam's ghosts and stores it whole with the ghosts merged in (rows of 16
words or more, so that no two seams share a sector); ``nofill`` is
``sector`` without the reads — a probe of what whole-sector stores cost
when nothing is fetched first, whose result is wrong (``exact`` false)
and never a candidate — and ``nofill128`` the same probe with whole
128-byte lines; ``cs`` stores the ghosts with the evict-first hint
(``__stcs``); ``div`` divides the seam walk's first item and stride by
the band's words even where a band is one word; ``t64``, ``t128``,
``t512`` set the threads a CTA (``kThreads``). ``base`` is the tree
itself. Each is built and
timed in its own process, in the order given, so that two versions
compare within one call (base, change, change, base). One JSON line per
run: the registers and spill bytes of every pack instance, and for pack
and unpack at ``chip_smoke.py``'s staged-exchange operands (float32,
n_bnd 2: 1028×524288 axis 0, 524288×1028 and 8192×8196 axis 1) the
queued time of one launch (behind a stall: the wrapper's host time out),
its route and whether it equals its plain version bit for bit, beside
the one-call yardsticks ``torch.stack`` of the two narrows and two
``copy_``.
"""

from __future__ import annotations

import sys

from tpu_mpi_tests_torch.kernels import flash_ab


def _set(name: str, value) -> tuple:
    return ("pack.cu", f"constexpr {name} = ",
            f"constexpr {name} = {value}; //")


#: the unpack seam walk's stores in the tree
_STORES = """      } else {
        if (has_lo) z[base + lo_col] = wlo[u];
        if (has_hi) z[base + hi_col] = whi[u];
      }"""
#: seam32: an aligned seam's sector as two 16-byte words
_SEAM32 = """      } else {
        if constexpr (sizeof(V) == 8) {
          if (has_lo && has_hi && vb == 1 && pw >= 3 &&
              reinterpret_cast<uintptr_t>(z + base - 2) % 32 == 0) {
            const uint2* w = reinterpret_cast<const uint2*>(z + base - 2);
            const uint2 he = w[0], le = w[3];
            const uint2 hg = reinterpret_cast<const uint2&>(whi[u]);
            const uint2 lg = reinterpret_cast<const uint2&>(wlo[u]);
            uint4* s = reinterpret_cast<uint4*>(z + base - 2);
            s[0] = make_uint4(he.x, he.y, hg.x, hg.y);
            s[1] = make_uint4(lg.x, lg.y, le.x, le.y);
            continue;
          }
        }
        if (has_lo) z[base + lo_col] = wlo[u];
        if (has_hi) z[base + hi_col] = whi[u];
      }"""
#: sector: every sector of a seam's ghost words read and stored whole
_SECTOR = """      } else {
        if constexpr (sizeof(V) == 8) {
          if (has_lo && has_hi && vb == 1 && pw >= 16) {
            const uintptr_t a = reinterpret_cast<uintptr_t>(z + base - 1);
            const uintptr_t s0 = a & ~uintptr_t(31);
            const bool two = ((a + 15) & ~uintptr_t(31)) != s0;
            const int k = static_cast<int>((a - s0) / 8);
            uint4* q = reinterpret_cast<uint4*>(s0);
            uint4 t[4] = {};
            t[0] = q[0];
            t[1] = q[1];
            if (two) {
              t[2] = q[2];
              t[3] = q[3];
            }
            uint2 w[8];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              w[2 * i] = make_uint2(t[i].x, t[i].y);
              w[2 * i + 1] = make_uint2(t[i].z, t[i].w);
            }
            const uint2 hg = reinterpret_cast<const uint2&>(whi[u]);
            const uint2 lg = reinterpret_cast<const uint2&>(wlo[u]);
#pragma unroll
            for (int i = 0; i < 8; ++i)
              w[i] = i == k ? hg : (i == k + 1 ? lg : w[i]);
            q[0] = make_uint4(w[0].x, w[0].y, w[1].x, w[1].y);
            q[1] = make_uint4(w[2].x, w[2].y, w[3].x, w[3].y);
            if (two) {
              q[2] = make_uint4(w[4].x, w[4].y, w[5].x, w[5].y);
              q[3] = make_uint4(w[6].x, w[6].y, w[7].x, w[7].y);
            }
            continue;
          }
        }
        if (has_lo) z[base + lo_col] = wlo[u];
        if (has_hi) z[base + hi_col] = whi[u];
      }"""
#: nofill128: every 128-byte line of a seam's ghost words stored whole,
#: nothing read first (wrong values: a probe of the write granule)
_LINE = """      } else {
        if constexpr (sizeof(V) == 8) {
          if (has_lo && has_hi && vb == 1 && pw >= 64) {
            const uintptr_t a = reinterpret_cast<uintptr_t>(z + base - 1);
            const uintptr_t l0 = a & ~uintptr_t(127);
            const int lines = ((a + 15) & ~uintptr_t(127)) != l0 ? 2 : 1;
            const uint2 hg = reinterpret_cast<const uint2&>(whi[u]);
            const uint2 lg = reinterpret_cast<const uint2&>(wlo[u]);
            uint4* q = reinterpret_cast<uint4*>(l0);
            const int k = static_cast<int>((a - l0) / 8);
            for (int i = 0; i < 8 * lines; ++i) {
              const uint2 w0 = 2 * i == k ? hg : (2 * i == k + 1 ? lg
                                                                : uint2{});
              const uint2 w1 = 2 * i + 1 == k ? hg
                               : (2 * i + 1 == k + 1 ? lg : uint2{});
              q[i] = make_uint4(w0.x, w0.y, w1.x, w1.y);
            }
            continue;
          }
        }
        if (has_lo) z[base + lo_col] = wlo[u];
        if (has_hi) z[base + hi_col] = whi[u];
      }"""
#: variant -> (file, old text, new text) edits of the package's sources
VARIANTS = {
    "base": (),
    **{f"u{u}": (_set("int kUnroll", u), _set("int kSeamUnroll", u))
       for u in (1, 2, 8)},
    "row": (_set("long long kBehind", 0),),
    "seam32": (("pack.cu", _STORES, _SEAM32),),
    "sector": (("pack.cu", _STORES, _SECTOR),),
    "nofill": (("pack.cu", _STORES, _SECTOR.replace(
        "t[0] = q[0];", "").replace("t[1] = q[1];", "").replace(
        "t[2] = q[2];", "").replace("t[3] = q[3];", "")),),
    "nofill128": (("pack.cu", _STORES, _LINE),),
    "div": (("pack.cu", "  if (vb > 1) {\n    r = first / vb;",
             "  if (true) {\n    r = first / vb;"),),
    **{f"t{n}": (_set("int kThreads", n),) for n in (64, 128, 512)},
    "cs": (("pack.cu", _STORES, _STORES.replace(
        "z[base + lo_col] = wlo[u];", "__stcs(&z[base + lo_col], wlo[u]);")
        .replace("z[base + hi_col] = whi[u];",
                 "__stcs(&z[base + hi_col], whi[u]);")),),
}
#: (shape, axis) of the timed operands, float32, n_bnd 2
OPERANDS = (((1028, 1 << 19), 0), ((1 << 19, 1028), 1), ((8192, 8196), 1))


def measure(name: str) -> dict:
    """Build the package this process imported and time the copies."""
    import re

    import torch

    from tpu_mpi_tests_torch.kernels import build, hand

    build.build(["pack"])
    row = {"variant": name, "ptxas": {}}
    entry = None
    for ln in build.BUILD_LOGS.get("pack", "").splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", ln):
            entry = re.sub(r"^_ZN5tpumt12_GLOBAL__N_1\d+", "", m[1])
            row["ptxas"][entry] = {}
        elif entry and (m := re.search(r"Used (\d+) registers", ln)):
            row["ptxas"][entry]["registers"] = int(m[1])
        elif entry and (m := re.search(r"(\d+) bytes spill stores", ln)):
            row["ptxas"][entry]["spill_stores"] = int(m[1])
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for shape, axis in OPERANDS:
        z = torch.randn(shape, generator=gen, device=dev)
        n = shape[axis]
        lo, hi = hand.pack_edges(z, axis, 2)
        wlo, whi = hand.pack_edges_ref(z, axis, 2)
        got = hand.unpack_ghosts(z.clone(), hi, lo, axis, 2)
        want = hand.unpack_ghosts_ref(z.clone(), hi, lo, axis, 2)
        exact = bool(torch.equal(lo, wlo) and torch.equal(hi, whi)
                     and torch.equal(got, want))
        del wlo, whi, got, want
        row[f"{shape[0]}x{shape[1]} axis {axis}"] = {
            "route": hand.pack_route(z, axis, 2, lo.data_ptr(),
                                     hi.data_ptr()),
            "exact": exact,
            "pack_queued_ms": flash_ab.time_queued(
                lambda: hand.pack_edges(z, axis, 2), 20),
            "unpack_queued_ms": flash_ab.time_queued(
                lambda: hand.unpack_ghosts(z, lo, hi, axis, 2), 20),
            "stack_queued_ms": flash_ab.time_queued(lambda: torch.stack(
                (z.narrow(axis, 2, 2), z.narrow(axis, n - 4, 2))), 20),
            "copy_queued_ms": flash_ab.time_queued(lambda: (
                z.narrow(axis, 0, 2).copy_(lo),
                z.narrow(axis, n - 2, 2).copy_(hi)), 20)}
        del z, lo, hi
        torch.cuda.empty_cache()
    return row


if __name__ == "__main__":
    sys.exit(flash_ab.main(module="pack_ab", variants=VARIANTS,
                           default=("base", "sector")))
