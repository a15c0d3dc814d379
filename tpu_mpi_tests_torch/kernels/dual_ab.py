"""A/B timing of the dual step (``csrc/dual_dim_step.cu``) under other
compile-time choices and designs, for the card:

    python -m tpu_mpi_tests_torch.kernels.dual_ab base smem e4 cs base

Each variant is a copy of the package under ``build/dual_ab/<name>/``
(listed in ``.gitignore``) with its sources patched: ``smem`` sends every
bfloat16 operand to the smem route (the shared-memory tile body the
regs route replaced; float32 takes it in the tree); ``e4`` gives a
thread 4 output columns, all its loads and stores 8 bytes
(``kDualElems``; the tree: 8, with 16-byte vectors where rows start on
16 bytes); ``cs`` stores the derivatives with the evict-first hint
(``st.global.cs``); ``ta8``, ``ta32``, ``ta64``, ``ta256`` set
``kDualRunRows`` (the shortest run a thread walks; the tree: 16);
``t128``, ``t512`` the threads a CTA (``kDualRegsThreads``; the tree:
256); ``p2``, ``p3``, ``p4``, ``p8`` the rows loaded ahead
(``kDualPrefetch``; the tree: 6); ``lb3`` asks ptxas for three CTAs an SM
(``__launch_bounds__``); ``rul0`` builds the library at ptxas
register-usage level 0 (``build.KSTEP_PTXAS``; the tree: the default);
and, kept only as a patch, ``float``: bfloat16 computed in float,
rounded after each op, instead of bf16x2 ops. ``base`` is the tree
itself. Each is built and timed in its own process, in the order given
(so that two versions compare within one call: base, change, change,
base). One JSON line per run: the registers and spills of every
dual-step instance, and at each of :data:`SHAPES` (the main path's
8196 x 8196 block and roofline2's sizes) in float32 and bfloat16, raw
and lean, the route, whether the derivatives equal the plain version bit
for bit and the residual's relative error, and the queued time (behind
a stall: the wrapper's host time out; the median of three runs of 20
launches) beside the byte bound (z read once, both derivatives written
once, at 3.35 TB/s).
"""

from __future__ import annotations

import re
import statistics
import sys

from tpu_mpi_tests_torch.kernels import flash_ab, probe_ab

_DUAL = "dual_dim_step.cu"


def _set(decl: str, old, new) -> tuple:
    return (_DUAL, f"constexpr {decl} = {old};", f"constexpr {decl} = {new};")


#: variant -> (file, old text, new text) edits of the package's sources
VARIANTS = {
    "base": (),
    "smem": ((_DUAL, "  if (dtype != kBF16) return kDualSmem;",
              "  return kDualSmem;"),),
    "e4": (_set("int kDualElems", 8, 4),),
    "cs": ((_DUAL, "  *static_cast<V*>(p) = u;",
            "  __stcs(static_cast<V*>(p), u);"),),
    **{f"ta{n}": (_set("int kDualRunRows", 16, n),) for n in (8, 32, 64, 256)},
    **{f"t{n}": (_set("int kDualRegsThreads", 256, n),) for n in (128, 512)},
    **{f"p{n}": (_set("int kDualPrefetch", 6, n),) for n in (2, 3, 4, 8)},
    "float": probe_ab.VARIANTS["float"],
    "lb3": ((_DUAL, "__global__ void __launch_bounds__(kDualRegsThreads)\n",
             "__global__ void __launch_bounds__(kDualRegsThreads, 3)\n"),),
    "rul0": (("../build.py", '                 "alu_probe": KSTEP_PTXAS}',
              '                 "alu_probe": KSTEP_PTXAS, '
              '"dual_dim_step": KSTEP_PTXAS}'),),
}
#: the main path's block (stencil2d_grid at 8192² with its 2-deep ghosts)
#: and microbench roofline2's sizes
SHAPES = ((8196, 8196), (4104, 4104), (2904, 2904), (2056, 2056))
HBM_BYTES_PER_S = 3.35e12


def kernel_name(mangled: str) -> str:
    """``dual_regs_kernel<float, false>`` for the mangled name of a dual
    instance; the name itself when it is not one."""
    dtypes = {"f": "float", "d": "double", "13__nv_bfloat16": "bf16"}
    m = re.search(r"\d+(dual_regs_kernel|dual_kernel|reduce_kernel)I"
                  r"(f|d|13__nv_bfloat16)Lb([01])E", mangled)
    if not m:
        return mangled
    return f"{m[1]}<{dtypes[m[2]]}, {'true' if m[3] == '1' else 'false'}>"


def measure(name: str) -> dict:
    """Build the package this process imported and time the dual step."""
    import torch

    from tpu_mpi_tests_torch.kernels import build, hand

    build.build(["dual_dim_step"])
    if "  return kDualSmem;\n" in (build.CSRC / _DUAL).read_text():
        hand.dual_route = lambda z: "smem"
    row = {"variant": name,
           "ptxas": build.ptxas_summary("dual_dim_step", kernel_name)}
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    s = 8192 / 8.0
    for shape in SHAPES:
        n_out = (shape[0] - 4) * (shape[1] - 4)
        for dname in ("float32", "bfloat16"):
            dtype = getattr(torch, dname)
            z = torch.randn(shape, generator=gen, device=dev).to(dtype)
            item = z.element_size()
            bound = (shape[0] * shape[1] + 2 * n_out) * item / HBM_BYTES_PER_S
            for lean in (False, True):
                gx, gy, gr = hand.dual_dim_step(z, 2, s, s, lean=lean)
                wx, wy, wr = hand.dual_dim_step_ref(z, 2, s, s, lean=lean)
                row[f"{dname} {'lean' if lean else 'raw'} {shape[0]}"] = {
                    "route": hand.dual_route(z),
                    "exact": bool(torch.equal(gx, wx)
                                  and torch.equal(gy, wy)),
                    "residual_rel_err": abs(float(gr) - float(wr))
                    / abs(float(wr)),
                    "queued_ms": statistics.median(
                        flash_ab.time_queued(
                            lambda lean=lean: hand.dual_dim_step(
                                z, 2, s, s, lean=lean), 20)
                        for _ in range(3)),
                    "bound_ms": bound * 1e3}
                del gx, gy, gr, wx, wy, wr
            del z
            torch.cuda.empty_cache()
    return row


if __name__ == "__main__":
    sys.exit(flash_ab.main(module="dual_ab", variants=VARIANTS,
                           default=("base", "smem", "base")))
