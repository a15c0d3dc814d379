"""A/B timing of the heat update (``csrc/heat2d.cu``) and the derivative
(``csrc/stencil_deriv.cu``) under other compile-time choices and designs,
for the card:

    python -m tpu_mpi_tests_torch.kernels.heat_ab base smem scalar float base

Each variant is a copy of the package under ``build/heat_ab/<name>/``
(listed in ``.gitignore``) with its sources patched: ``smem`` sets
``kHeatRegsMaxSteps`` to 0, so the rule sends every heat operand to the
smem route (the shared-memory tile body the regs route replaced);
``scalar`` sends every derivative to the scalar route (one element a
thread, the body the regs route replaced); ``float`` computes bfloat16 in
float, rounded after each op, instead of bf16x2 ops (both kernels);
``p2``, ``p3`` set ``kHeatPrefetch`` (the rows loaded ahead; the tree:
4), ``p8`` too, in a ring of ten slots; ``l1``, ``l4`` give a heat lane
one or four vectors where they are narrower than 16 bytes
(``kHeatLaneVecs``; the tree: two, and one 16-byte vector); ``lb4`` asks
ptxas for four heat CTAs an SM (``__launch_bounds__``; the tree: one);
``ta16``, ``ta64``, ``ta256`` set ``kHeatRunRows`` (the shortest run a
warp walks; the tree: 32); ``t256`` 256 threads a heat CTA (the tree:
128); ``dp4`` sets ``kDerivPrefetch`` (the tree: 8); ``dta16``,
``dta256`` ``kDerivRunRows`` (the tree: 64); ``hrul0`` builds the heat
library at ptxas register-usage level 0 (``build.KSTEP_PTXAS``; the
tree: the default, 5). ``base`` is the tree itself. PERF.md gives each
variant's reading beside the tree's, from one call.
Each is built and timed in its own process, in the order given (so that
two versions compare within one call: base, change, change, base). One
JSON line per run: the card (``nvidia-smi`` name and power limit), the
registers and spills of every instance of both libraries, the SASS
opcode counts of the heat driver's three instances (``cuobjdump``, every
unrolled copy once); at the main paths' operands — the heat driver's
three runs (8200² f32 and bf16 at k = 4, 8194² f32 at k = 1: rows on 8
bytes), microbench ``heat``'s and ``roofline2``'s deepest (2064² f32 and
bf16 at k = 8) and its bf16 k = 1 field (2050²: rows on 4 bytes), the
``stencil2d`` driver's derivatives (1028×524288 f32 and bf16 along dim
0, 1024×524292 f32 along dim 1) and microbench ``stencil``'s (1028×8192
f32, both dims) — the route, the vector, whether the result equals the
plain version bit for bit, and the queued time (behind a stall: the
wrapper's host time out; the median of three runs of 20 launches)
beside the byte bound (the operand read once and the result written
once at 3.35 TB/s).
"""

from __future__ import annotations

import re
import statistics
import sys
from pathlib import Path

from tpu_mpi_tests_torch.kernels import flash_ab, probe_ab

_HEAT = "heat2d.cu"
_DERIV = "stencil_deriv.cu"


def _set(file: str, decl: str, old, new) -> tuple:
    return (file, f"constexpr {decl} = {old};", f"constexpr {decl} = {new};")


#: the last line of build.LIBRARY_FLAGS, the libraries built at level 0
_LEVEL0 = '                 "alu_probe": KSTEP_PTXAS}'
#: variant -> (file, old text, new text) edits of the package's sources
VARIANTS = {
    "base": (),
    "smem": (_set(_HEAT, "int kHeatRegsMaxSteps", 8, 0),),
    "scalar": ((_DERIV, "  if (deriv_vec_bytes(dim, z, out, n1, itemsize) "
                "== 0) return kDerivScalar;",
                "  return kDerivScalar;"),),
    "float": probe_ab.VARIANTS["float"],
    **{f"p{n}": (_set(_HEAT, "int kHeatPrefetch", 4, n),) for n in (2, 3)},
    "p8": (_set(_HEAT, "int kHeatPrefetch", 4, 8),
           _set(_HEAT, "int kHeatSlots", 5, 10)),
    **{f"l{n}": (_set(_HEAT, "int kHeatLaneVecs", 2, n),) for n in (1, 4)},
    "lb4": ((_HEAT, "__launch_bounds__(kHeatThreads, 1)\n",
             "__launch_bounds__(kHeatThreads, 4)\n"),),
    **{f"ta{n}": (_set(_HEAT, "int kHeatRunRows", 32, n),)
       for n in (16, 64, 256)},
    "t256": (_set(_HEAT, "int kHeatThreads", 128, 256),),
    "dp4": (_set(_DERIV, "int kDerivPrefetch", 8, 4),),
    **{f"dta{n}": (_set(_DERIV, "int kDerivRunRows", 64, n),)
       for n in (16, 256)},
    "hrul0": (("../build.py", _LEVEL0,
               _LEVEL0[:-1] + ', "heat2d": KSTEP_PTXAS}'),),
}
#: the heat update's main-path operands: (label, shape, dtype, steps)
HEAT_OPERANDS = (
    ("heat f32 8200x8200 k=4", (8200, 8200), "float32", 4),
    ("heat f32 8194x8194 k=1", (8194, 8194), "float32", 1),
    ("heat bf16 8200x8200 k=4", (8200, 8200), "bfloat16", 4),
    ("heat f32 2064x2064 k=8", (2064, 2064), "float32", 8),
    ("heat bf16 2064x2064 k=8", (2064, 2064), "bfloat16", 8),
    ("heat bf16 2050x2050 k=1", (2050, 2050), "bfloat16", 1),
)
#: the derivative's main-path operands: (label, shape, dtype, dim)
DERIV_OPERANDS = (
    ("deriv f32 1028x524288 dim 0", (1028, 524288), "float32", 0),
    ("deriv f32 1024x524292 dim 1", (1024, 524292), "float32", 1),
    ("deriv bf16 1028x524288 dim 0", (1028, 524288), "bfloat16", 0),
    ("deriv f32 1028x8192 dim 0", (1028, 8192), "float32", 0),
    ("deriv f32 1028x8192 dim 1", (1028, 8192), "float32", 1),
)
HBM_BYTES_PER_S = 3.35e12


def kernel_name(mangled: str) -> str:
    """``heat2d_regs<float, 4, 16>`` for the mangled name of a heat or
    derivative instance (``heat2d_kernel<bf16>``, ``deriv_regs_dim1<float,
    16>``, ``deriv_kernel<double, 0>``); the name itself when it is not
    one."""
    dtypes = {"f": "float", "d": "double", "13__nv_bfloat16": "bf16"}
    m = re.search(r"\d+(heat2d_regs|heat2d_kernel|deriv_regs_dim[01]|"
                  r"deriv_kernel)I(f|d|13__nv_bfloat16)(?:Li(\d+)E)?"
                  r"(?:Li(\d+)E)?", mangled)
    if not m:
        return mangled
    args = [dtypes[m[2]]] + [a for a in (m[3], m[4]) if a]
    return f"{m[1]}<{', '.join(args)}>"


#: the instances whose SASS opcodes a run counts (the heat driver's)
SASS_INSTANCES = ("heat2d_regs<float, 4, 16>", "heat2d_regs<float, 1, 8>",
                  "heat2d_regs<bf16, 4, 16>")


def sass_opcodes(lib: str, names=SASS_INSTANCES) -> dict:
    """Static opcode counts of the instances ``names`` of built library
    ``lib`` (``cuobjdump -sass``, beside ``nvcc``): the instructions the
    compiler emitted, every unrolled copy counted once."""
    import collections
    import subprocess

    from tpu_mpi_tests_torch.kernels import build

    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(build.library_path(lib))],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    for body in text.split("Function : ")[1:]:
        name = kernel_name(body.split("\n", 1)[0].strip())
        if name not in names:
            continue
        ops = collections.Counter(
            m[1].split(".")[0] for m in re.finditer(
                r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                body))
        out[name] = {"total": sum(ops.values()), **dict(ops.most_common(12))}
    return out


def _queued(fn, n_iter: int = 20) -> float:
    return statistics.median(flash_ab.time_queued(fn, n_iter)
                             for _ in range(3))


def measure(name: str) -> dict:
    """Build the package this process imported and time both kernels."""
    import torch

    from tpu_mpi_tests_torch.kernels import build, hand

    build.build(["heat2d", "stencil_deriv"])
    # the rules follow this copy's sources (the smem and scalar variants)
    hand.HEAT_REGS_MAX_STEPS = int(re.search(
        r"constexpr int kHeatRegsMaxSteps = (\d+);",
        (build.CSRC / _HEAT).read_text())[1])
    if name == "scalar":
        hand.deriv_route = lambda *a, **k: "scalar"
    import subprocess

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[:1]
    row = {"variant": name, "card": card,
           "ptxas": {**build.ptxas_summary("heat2d", kernel_name),
                     **build.ptxas_summary("stencil_deriv", kernel_name)},
           "sass": sass_opcodes("heat2d")}
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(
            getattr(torch, dtype))

    for label, shape, dtype, steps in HEAT_OPERANDS:
        z = rand(shape, dtype)
        out = torch.empty_like(z)

        def heat(z=z, out=out, steps=steps):
            return hand.heat2d(z, 0.1, 0.2, steps=steps, out=out)

        heat()
        row[label] = {
            "route": hand.heat_route(z, steps, out),
            "vec_bytes": hand.heat_vec_bytes(z, out),
            "exact": bool(torch.equal(out, hand.heat2d_ref(z, 0.1, 0.2,
                                                           steps))),
            "queued_ms": _queued(heat),
            "bytes_bound_ms": 2 * z.numel() * z.element_size()
            / HBM_BYTES_PER_S * 1e3}
        del z, out
        torch.cuda.empty_cache()
    for label, shape, dtype, dim in DERIV_OPERANDS:
        z = rand(shape, dtype)
        oshape = list(shape)
        oshape[dim] -= 4
        out = torch.empty(oshape, dtype=z.dtype, device=dev)

        def deriv(z=z, out=out, dim=dim):
            return hand.stencil2d_deriv(z, 128.0, dim=dim, out=out)

        deriv()
        row[label] = {
            "route": hand.deriv_route(z, dim, out),
            "vec_bytes": hand.deriv_vec_bytes(z, dim, out),
            "exact": bool(torch.equal(out, hand.stencil2d_deriv_ref(
                z, 128.0, dim=dim))),
            "queued_ms": _queued(deriv),
            "bytes_bound_ms": (z.numel() + out.numel()) * z.element_size()
            / HBM_BYTES_PER_S * 1e3}
        del z, out
        torch.cuda.empty_cache()
    return row


if __name__ == "__main__":
    sys.exit(flash_ab.main(module="heat_ab", variants=VARIANTS,
                           default=("base", "smem", "scalar", "base")))
