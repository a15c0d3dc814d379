"""A/B timing of the k-step kernels (``csrc/stencil_iterate.cu``,
``csrc/fused_rdma.cu``, their body ``csrc/stencil_kstep.cuh``) under other
compile-time choices and designs, for the card:

    python -m tpu_mpi_tests_torch.kernels.kstep_ab base smem ta256 p1 base

Each variant is a copy of the package under ``build/kstep_ab/<name>/``
(listed in ``.gitignore``) with its sources patched: ``smem`` sets
``kRegsMaxSteps`` to 0, so the rule sends every operand to the smem route
(the shared-memory body the regs route replaced, at its own tile and
row-block sizes); ``ta64``, ``ta256``, ``ta512`` set ``kRunRows`` (the
shortest run a dim-0 thread walks; the tree: 128); ``v8`` moves the
iterate's operands in 8-byte vectors (the tree: 16 bytes where every row
starts on 16); ``p1``, ``p2`` set ``kPrefetch`` (the rows loaded ahead; the tree:
4), ``p6``, ``p8`` too, in a ring of ten slots; ``u4`` gives a dim-1
lane four vectors (``kLaneVecs``; the tree: two); ``stage`` steps dim 1
from a shared-memory stage of the segment, each lane its own window,
instead of shuffles; ``float`` computes bfloat16 in float, rounded after
each op, instead of bf16x2 ops; ``oldsend`` sends the fused kernel's
bands one element a thread with a system-scope fence in every thread,
instead of ring_halo's walk; ``rul5`` builds the two libraries at
ptxas's default register-usage level (5) instead of 0
(``build.KSTEP_PTXAS``). ``base`` is the tree itself. Each is built and
timed in its own process, in the order given (so that two versions
compare within one call: base, change, change, base). One JSON line per
run: the registers and spills of every k-step instance; the queued time
(behind a stall: the wrapper's host time out; the median of three runs
of 20 launches) at the main path's operands — the iterate at the
bench's f32 block (4112×8192, dim 0), the bench's and ``rdma-chained``'s
bf16 buffer (8192×8208, dim 1), ``rdma-chained``'s f32 buffer (the same,
f32) and the ``stencil2d`` driver's block (528×524288, dim 0), all k =
4, and microbench ``iterate``'s bf16 field (8192×8196, dim 1, k = 1:
rows of 16392 bytes, 8-byte vectors); the fused kernel's compute-only
instance at the bench's 8208×8192 f32 buffer at its default row block
and at 57, 171, 228 and 456 rows, and in bf16, each labelled with the
rows per block it launched; the fused periodic self-ring beside the
chained pair ``ring_halo`` → ``stencil2d_iterate`` — each with its route
and whether it equals its plain version (or the chained pair) bit for
bit.
"""

from __future__ import annotations

import re
import statistics
import sys

from tpu_mpi_tests_torch.kernels import flash_ab


def _set(file: str, decl: str, old, new) -> tuple:
    return (file, f"constexpr {decl} = {old};", f"constexpr {decl} = {new};")


_KSTEP = "stencil_kstep.cuh"
_FUSED = "fused_rdma.cu"
#: stage: the segment and its aprons into the warp's shared-memory stage
#: once, each lane stepping its own window of it (no shuffles)
_STAGE_BODY = (_KSTEP, """  constexpr int n = kLaneVecs * NW;
  static_assert(n >= H, "a lane holds the halo its neighbours take");
  W x[n];
  const int lv = v0 + lane * kLaneVecs;  // this lane's first vector
#pragma unroll
  for (int u = 0; u < kLaneVecs; ++u) {
    R r = {};
    if (lv + u >= 0 && lv + u < nv)
      r = kload<false, R>(zr + static_cast<long long>(lv + u) * G::E);
    memcpy(x + u * NW, r.w, sizeof(R));
  }
  const int a_lane = lv * G::E;  // element index of x[0]
#pragma unroll
  for (int s = 1; s <= kK; ++s) {
    W e[n + 2 * H];
#pragma unroll
    for (int j = 0; j < n; ++j) e[H + j] = x[j];
#pragma unroll
    for (int h = 0; h < H; ++h) {
      e[H - 1 - h] = __shfl_up_sync(0xffffffffu, x[n - 1 - h], 1);
      e[H + n + h] = __shfl_down_sync(0xffffffffu, x[h], 1);
    }
#pragma unroll
    for (int j = 0; j < n; ++j) {
      const W v = kword_at<T>(e, H + j, se, c1, c2);
      x[j] = inner || !keep(a_lane + j * KW::kElems, s) ? v : x[j];
    }
  }
#pragma unroll
  for (int u = 0; u < kLaneVecs; ++u) {
    const int vi = lv + u;
    if (vi >= v0 + G::Kv && vi < v0 + G::Kv + G::kInner && vi < nv) {
      R r;
      memcpy(r.w, x + u * NW, sizeof(R));
      kstore(orow + static_cast<long long>(vi) * G::E, r);
    }
  }
}
""", """  __shared__ R stages[kRegsThreads / 32][G::kLoad];
  R* stage = stages[threadIdx.x / 32];
  for (int i = lane; i < G::kLoad; i += 32) {
    const int vi = v0 + i;
    R r = {};
    if (vi >= 0 && vi < nv)
      r = kload<false, R>(zr + static_cast<long long>(vi) * G::E);
    stage[i] = r;
  }
  __syncwarp();
  constexpr int m = (kLaneVecs + 2 * G::Kv) * NW;  // words of the window
  W x[m];
  memcpy(x, stage + lane * kLaneVecs, sizeof(x));
  const int a_win = (v0 + lane * kLaneVecs) * G::E;  // element of x[0]
#pragma unroll
  for (int s = 1; s <= kK; ++s) {
    W y[m];
#pragma unroll
    for (int j = 0; j < m; ++j) {
      y[j] = x[j];
      if (j >= H && j < m - H) {
        const W v = kword_at<T>(x, j, se, c1, c2);
        y[j] = inner || !keep(a_win + j * KW::kElems, s) ? v : x[j];
      }
    }
#pragma unroll
    for (int j = 0; j < m; ++j) x[j] = y[j];
  }
#pragma unroll
  for (int u = 0; u < kLaneVecs; ++u) {
    const int vi = v0 + G::Kv + lane * kLaneVecs + u;
    if (vi < nv) {
      R r;
      memcpy(r.w, x + (G::Kv + u) * NW, sizeof(R));
      kstore(orow + static_cast<long long>(vi) * G::E, r);
    }
  }
}
""")
#: float: each bfloat16 op in float, rounded to bfloat16 after it
_FLOAT_STEP = (_KSTEP, """    const W acc = bf2_add(bf2_mul(c1, bf2_sub(p1, m1)),
                          bf2_mul(c2, bf2_sub(p2, m2)));
    return bf2_add(z0, bf2_mul(se, acc));
""", """    using E = Elt<__nv_bfloat16>;
    const float2 f0 = __bfloat1622float2(z0), fm1 = __bfloat1622float2(m1),
                 fp1 = __bfloat1622float2(p1), fm2 = __bfloat1622float2(m2),
                 fp2 = __bfloat1622float2(p2);
    const float s = __low2float(se), k1 = __low2float(c1),
                k2 = __low2float(c2);
    auto one = [&](float x0, float xm1, float xp1, float xm2, float xp2) {
      const float acc = E::add(E::mul(k1, E::sub(xp1, xm1)),
                               E::mul(k2, E::sub(xp2, xm2)));
      return E::add(x0, E::mul(s, acc));
    };
    return __floats2bfloat162_rn(one(f0.x, fm1.x, fp1.x, fm2.x, fp2.x),
                                 one(f0.y, fm1.y, fp1.y, fm2.y, fp2.y));
""")
#: oldsend: one element-sized word a thread by ring_store, a system-scope
#: fence in every thread, one send CTA a 1024 words
_OLD_SEND = (
    (_FUSED, """  if (stage) {
    ring_store(r, stage, 0, 1);
  } else if (g.vec16) {
    const RingView<uint4> v{
        reinterpret_cast<const uint4*>(r.z),
        reinterpret_cast<uint4*>(r.left_z),
        reinterpret_cast<uint4*>(r.right_z), r.pad, r.left_pad,
        r.right_pad, r.epoch, r.axis, r.n0, r.n1, r.b, r.send_lo,
        r.send_hi};
    halo_walk<kSendUnroll>(v, g.walk, ticket, g.senders);
  } else {
    halo_walk<1>(r, g.walk, ticket, g.senders);
  }
  ring_arrive_cta<kSys>(r, g.senders);
""", """  ring_store(r, stage, ticket, g.senders);
  __threadfence_system();
  ring_arrive_cta<true>(r, g.senders);
"""),
    (_FUSED, "  if (senders > kMaxSendCtas) senders = kMaxSendCtas;\n",
     "  senders = (2LL * K * n1 + 1023) / 1024;\n"
     "  if (senders > kMaxSendCtas) senders = kMaxSendCtas;\n"))
#: variant -> (file, old text, new text) edits of the package's sources
VARIANTS = {
    "base": (),
    "smem": (_set(_KSTEP, "int kRegsMaxSteps", 8, 0),),
    **{f"ta{n}": (_set(_KSTEP, "int kRunRows", 128, n),)
       for n in (64, 256, 512)},
    "v8": (("stencil_iterate.cu",
            "const int vb = kstep_vec_bytes(z, out, n1, itemsize);",
            "const int vb = 8;"),),
    **{f"p{n}": (_set(_KSTEP, "int kPrefetch", 4, n),) for n in (1, 2)},
    **{f"p{n}": (_set(_KSTEP, "int kPrefetch", 4, n),
                 _set(_KSTEP, "int kSlots", 5, 10)) for n in (6, 8)},
    "u4": (_set(_KSTEP, "int kLaneVecs", 2, 4),),
    "stage": ((_KSTEP, "  static constexpr int kLoad = 32 * kLaneVecs;\n"
               "  static constexpr int kInner = 32 * kLaneVecs - 2 * Kv;\n",
               "  static constexpr int kLoad = 32 * kLaneVecs + 2 * Kv;\n"
               "  static constexpr int kInner = 32 * kLaneVecs;\n"),
              _STAGE_BODY),
    "float": (_FLOAT_STEP,),
    "oldsend": _OLD_SEND,
    "rul5": (("../build.py", '"--register-usage-level=0")',
              '"--register-usage-level=5")'),),
}
#: the bench's scale_eps at n = 8192 (chip_smoke.BENCH_SE)
SE = 1e-6 * 8192 / 8.0
#: the iterate's main-path operands: (label, shape, dtype, dim, flags,
#: scale_eps, steps)
ITERATE_OPERANDS = (
    ("iterate f32 4112x8192 dim 0", (4112, 8192), "float32", 0, (1, 0), SE,
     4),
    ("iterate bf16 8192x8208 dim 1", (8192, 8208), "bfloat16", 1, (1, 1), SE,
     4),
    ("iterate f32 8192x8208 dim 1", (8192, 8208), "float32", 1, (0, 0), SE,
     4),
    ("iterate f32 528x524288 dim 0", (528, 524288), "float32", 0, (0, 0),
     SE, 4),
    ("iterate bf16 8192x8196 dim 1 k=1", (8192, 8196), "bfloat16", 1,
     (0, 0), 1e-6, 1),
)
#: the fused kernel's operand and the row blocks timed beside its default
FUSED_SHAPE = (8208, 8192)
# the A/B harness's measurement grid, not a schedule any run resolves
FUSED_TILE_ROWS = (57, 171, 228, 456)  # tpumt: ignore[TPM701]


def kernel_name(mangled: str) -> str:
    """``iterate_regs_dim0<float, 4>`` for the mangled name of a k-step
    instance (the iterate's two routes, the fused kernel); the name itself
    when it is not one."""
    dtypes = {"f": "float", "d": "double", "13__nv_bfloat16": "bf16"}
    m = re.search(r"\d+(iterate_regs_dim[01]|iterate_kernel|"
                  r"fused_rdma_kernel)I(f|d|13__nv_bfloat16)Li(\d+)E"
                  r"(?:Li(\d+)E)?(?:Lb([01])E)?", mangled)
    if not m:
        return mangled
    args = ([dtypes[m[2]], m[3]] + ([m[4]] if m[4] else [])
            + ([{"0": "false", "1": "true"}[m[5]]] if m[5] else []))
    return f"{m[1]}<{', '.join(args)}>"


def _queued(fn, n_iter: int = 20) -> float:
    return statistics.median(flash_ab.time_queued(fn, n_iter)
                             for _ in range(3))


def measure(name: str) -> dict:
    """Build the package this process imported and time the kernels."""
    import torch

    from tpu_mpi_tests_torch.kernels import build, hand

    build.build(["stencil_iterate", "fused_rdma", "ring_halo"])
    # the rule follows this copy's register budget (the smem variant's 0)
    hand.KSTEP_REGS_MAX_STEPS = int(re.search(
        r"constexpr int kRegsMaxSteps = (\d+);",
        (build.CSRC / _KSTEP).read_text())[1])
    row = {"variant": name,
           "ptxas": {**build.ptxas_summary("stencil_iterate", kernel_name),
                     **build.ptxas_summary("fused_rdma", kernel_name)}}
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(
            getattr(torch, dtype))

    for label, shape, dtype, dim, flags, se, steps in ITERATE_OPERANDS:
        z = rand(shape, dtype)
        out = torch.empty_like(z)

        def it(z=z, out=out, dim=dim, flags=flags, se=se, steps=steps):
            return hand.stencil2d_iterate(z, se, dim=dim, steps=steps,
                                          phys_static=flags, out=out)

        it()
        row[label] = {
            "route": hand.kstep_route(z, dim, steps, out),
            "vec_bytes": hand.kstep_vec_bytes(z, out),
            "exact": bool(torch.equal(out, hand.stencil2d_iterate_ref(
                z, se, dim=dim, steps=steps, phys_static=flags))),
            "queued_ms": _queued(it)}
        del z, out
        torch.cuda.empty_cache()
    for dtype in ("float32", "bfloat16"):
        z = rand(FUSED_SHAPE, dtype)
        out = torch.empty_like(z)
        want = hand.stencil2d_iterate_ref(z, SE, dim=0, steps=4,
                                          phys_static=(1, 1))
        for tile in (None,) + (FUSED_TILE_ROWS if dtype == "float32"
                               else ()):
            def fused(z=z, out=out, tile=tile):
                return hand.stencil2d_fused_rdma(
                    z, SE, steps=4, local_only=True, phys_static=(1, 1),
                    tile_rows=tile, out=out)

            fused()
            label = "default" if tile is None else f"tile_rows={tile}"
            row[f"fused {dtype} compute-only {label}, "
                f"B={hand.stencil2d_fused_rdma.block_rows}"] = {
                "route": hand.kstep_route(z, 0, 4, out, fused=True),
                "exact": bool(torch.equal(out, want)),
                "queued_ms": _queued(fused)}
        del z, out, want
        torch.cuda.empty_cache()
    z = rand(FUSED_SHAPE, "float32")
    out, chained_out = torch.empty_like(z), torch.empty_like(z)

    def fused_ring():
        return hand.stencil2d_fused_rdma(z, SE, steps=4, periodic=True,
                                         phys_static=(0, 0), out=out)

    def chained():
        hand.ring_halo(z, axis=0, n_bnd=8, periodic=True)
        return hand.stencil2d_iterate(z, SE, dim=0, steps=4,
                                      phys_static=(0, 0), out=chained_out)

    fused_ring()
    chained()
    row["fused float32 periodic self-ring, "
        f"B={hand.stencil2d_fused_rdma.block_rows}"] = {
        "route": hand.kstep_route(z, 0, 4, out, fused=True),
        "exact_vs_chained": bool(torch.equal(out, chained_out)),
        "queued_ms": _queued(fused_ring),
        "chained_pair_queued_ms": _queued(chained)}
    return row


if __name__ == "__main__":
    sys.exit(flash_ab.main(module="kstep_ab", variants=VARIANTS,
                           default=("base", "smem", "base")))
