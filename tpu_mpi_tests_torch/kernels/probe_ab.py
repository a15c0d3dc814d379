"""A/B timing of the ALU probe (``csrc/alu_probe.cu``) under other
compile-time choices and designs, for the card:

    python -m tpu_mpi_tests_torch.kernels.probe_ab base max8 t1024 float base

Each variant is a copy of the package under ``build/probe_ab/<name>/``
(listed in ``.gitignore``) with its sources patched: ``max8`` caps the
cluster at the 8 portable CTAs (``kMaxCluster``; the tree: 16, so a
float32 (512, 512) block, whose ping-pong needs 16, falls to the l2
route); ``t1024`` sets the threads a CTA (``kClusterThreads``; the
tree: 512); and the designs that lost or that the tree does not take,
kept only as patches: ``float`` computes bfloat16 in float, rounded
after each op, instead of bf16x2 ops (the dual step's too); ``l2``
sends every block to the l2 route (the grid barrier design the cluster
route replaced); ``walk`` takes every stencil mix through the
shared-memory walk, no rows held in registers (the first cluster
design). ``base`` is the tree itself.
Each is built and timed in its own process, in the order given (so that
two versions compare within one call: base, change, change, base). One
JSON line per run: the registers and spills of every probe instance, the
card's lone-op issue rate, and per main-path case — the (B, 512, 512)
stack of ``microbench.probe_batch`` at each mix in float32 and
``step5_d1`` and ``dualdim`` in bfloat16 — the route, whether it equals
its plain version at 3 reps (bit for bit; the dual mixes within
``hand.alu_probe_tolerance``), the queued time at each of the vpu and
roofline2 groups' reps triple, the per-rep cost as the triple's slope
(µs a rep and ps an element-rep) and the bound's ps an element-rep.
"""

from __future__ import annotations

import re
import statistics
import sys

import numpy as np

from tpu_mpi_tests_torch.kernels import flash_ab

_PROBE = "alu_probe.cu"
_COMMON = "stencil_common.cuh"


def _set(decl: str, old, new, file: str = _PROBE) -> tuple:
    return (file, f"constexpr {decl} = {old};", f"constexpr {decl} = {new};")


#: float: bfloat16 words computed in float, rounded after each op
_FLOAT_PK = tuple(
    (_COMMON,
     f"  __device__ static W {op}(W a, W b) {{ return bf2_{op}(a, b); }}\n",
     f"  __device__ static W {op}(W a, W b) {{\n"
     f"    const float2 x = __bfloat1622float2(a), "
     f"y = __bfloat1622float2(b);\n"
     f"    return __floats2bfloat162_rn(__f{op}_rn(x.x, y.x), "
     f"__f{op}_rn(x.y, y.y));\n"
     f"  }}\n")
    for op in ("add", "sub", "mul"))
#: variant -> (file, old text, new text) edits of the package's sources
VARIANTS = {
    "base": (),
    "max8": (_set("int kMaxCluster", 16, 8),),
    "t1024": (_set("int kClusterThreads", 512, 1024),),
    "float": _FLOAT_PK,
    "l2": ((_PROBE, "  return cluster_config(itemsize, H, W, &c) ? "
                    "kRouteCluster : kRouteL2;",
            "  return kRouteL2;"),),
    # the shared-memory walk for every stencil mix (no rows in registers)
    "walk": ((_PROBE, "  if (nv > 32 * L || (L > 1 && nv <= 16 * L) ||\n"
                      "      (rs + kClusterWarps - 1) / kClusterWarps != R)\n",
              "  if (true)\n"),
             (_PROBE, "  if (rs % RR != 0 || nv % 32 != 0 || nv * nq > "
                      "kClusterThreads)\n",
              "  if (true)\n")),
}
#: the main-path cases: (mix, dtype, the group's reps triple)
CASES = (("fma", "float32", (512, 2048, 8192)),
         ("step5_d0", "float32", (256, 1024, 4096)),
         ("step5_d1", "float32", (64, 256, 1024)),
         ("step5fma_d0", "float32", (256, 1024, 4096)),
         ("heat5", "float32", (64, 256, 1024)),
         ("dualdim", "float32", (32, 128, 512)),
         ("dualdim_lean", "float32", (32, 128, 512)),
         ("step5_d1", "bfloat16", (64, 256, 1024)),
         ("dualdim", "bfloat16", (32, 128, 512)))
HW = 512


def kernel_name(mangled: str) -> str:
    """``probe_cluster_kernel<float, 1>`` for the mangled name of a probe
    instance; the name itself when it is not one."""
    dtypes = {"f": "float", "13__nv_bfloat16": "bf16"}
    m = re.search(r"\d+(probe_cluster_kernel|probe_kernel)I"
                  r"(f|13__nv_bfloat16)Li(\d+)E", mangled)
    return f"{m[1]}<{dtypes[m[2]]}, {m[3]}>" if m else mangled


def _queued(fn, n_iter: int = 5) -> float:
    return statistics.median(flash_ab.time_queued(fn, n_iter)
                             for _ in range(3))


def measure(name: str) -> dict:
    """Build the package this process imported and time the probe."""
    import torch

    from tpu_mpi_tests_torch import microbench
    from tpu_mpi_tests_torch.kernels import build, hand

    build.build(["alu_probe"])
    src = (build.CSRC / _PROBE).read_text()
    # the rule follows this copy's cluster cap
    hand.PROBE_MAX_CLUSTER = int(re.search(
        r"constexpr int kMaxCluster = (\d+);", src)[1])
    if "  return kRouteL2;" in src:
        hand.probe_cluster = lambda *a: None
    rate = hand.alu_issue_rate()
    row = {"variant": name, "issue_rate": rate,
           "ptxas": build.ptxas_summary("alu_probe", kernel_name)}
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for mix, dname, reps3 in CASES:
        dtype = getattr(torch, dname)
        B = microbench.probe_batch(HW, HW, dev, dtype)
        z = torch.randn((B, HW, HW), generator=gen, device=dev).to(dtype)
        got = hand.alu_probe(z, 3, mix, se=0.05)
        shifts = []
        want = hand.alu_probe_ref(z, 3, mix, se=0.05, shifts=shifts)
        if mix.startswith("dualdim"):
            tol = hand.alu_probe_tolerance(
                dtype, 3, float(want.float().abs().max()), max(shifts))
            exact = float((got.float() - want.float()).abs().max()) <= tol
        else:
            exact = bool(torch.equal(got, want))
        del got, want
        ts = [_queued(lambda r=r: hand.alu_probe(z, r, mix)) for r in reps3]
        per_rep = float(np.polyfit(np.array(reps3, float), ts, 1)[0])  # ms
        elems = B * HW * HW
        row[f"{mix} {dname}"] = {
            "route": hand.probe_route(z, mix), "blocks": B,
            "ctas": hand.alu_probe.last_ctas, "exact": exact,
            "queued_ms": dict(zip(map(str, reps3), ts)),
            "us_per_rep": per_rep * 1e3,
            "ps_per_elt_rep": per_rep * 1e9 / elems,
            "bound_ps_per_elt_rep": hand.probe_bound_s(
                mix, dtype, 1, 1, rate) * 1e12}
        del z
        torch.cuda.empty_cache()
    return row


if __name__ == "__main__":
    sys.exit(flash_ab.main(module="probe_ab", variants=VARIANTS,
                           default=("base", "max8", "base")))
