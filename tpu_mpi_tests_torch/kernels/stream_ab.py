"""A/B timing of the streaming kernels (``csrc/streams.cu``) under other
compile-time choices and designs, for the card:

    python -m tpu_mpi_tests_torch.kernels.stream_ab base u4 resident bulk base

Each variant is a copy of the package under ``build/stream_ab/<name>/``
(listed in ``.gitignore``) with ``csrc/streams.cu`` patched: ``u1``,
``u2``, ``u4``, ``u8`` set ``kUnroll`` (the 16-byte packs of each stream
a thread has in flight on the vec16 route) to 1 (the tree's), 2, 4 or
8; ``flat`` is the tree's grid, one group a CTA sized to the work with
no loop (how ``y.add_`` launches), so it repeats ``base``, and
``resident`` launches the vec16 route at the occupancy API's resident
count (``occupancy.cuh``) instead, each CTA looping over groups; ``cs``
loads and stores through the evict-first hints (``__ldcs`` /
``__stcs``); ``bulk`` sends the vec16 route through a ring of bulk
copies (``cp.async.bulk`` global → shared, the op in place in shared
memory, ``cp.async.bulk`` back; one CTA an SM); ``t128``, ``t512`` set
the threads a CTA (``kThreads``). ``base`` is the tree itself. Each is
built and timed in its own process, in the order given, so that two
versions compare within one call (base, change, change, base). One JSON
line per run: the registers and spill bytes of every stream instance;
the queued time (behind a stall: the wrapper's host time out; the median
of three runs of 20 launches, 10 at 2^28) of ``daxpy`` at 2^24, 2^26 and
2^28 and of ``stream_scale`` and ``stream_sum3`` at 2^26, float32, all
in place, each with its route and whether it equals its plain version
bit for bit; the yardsticks ``y.add_(x, alpha=a)`` and ``x.mul_(a)``
timed the same way in the same process; and the two-point fit
b/(t3 − t2) (one pass's bytes over daxpy's time less scale's at 2^26) of
the kernels and of the yardsticks.
"""

from __future__ import annotations

import re
import statistics
import sys

from tpu_mpi_tests_torch.kernels import flash_ab


def _set(name: str, value) -> tuple:
    return ("streams.cu", f"constexpr {name} = ",
            f"constexpr {name} = {value}; //")


_INCLUDE = ("streams.cu", '#include "stencil_common.cuh"\n',
            '#include "occupancy.cuh"\n#include "stencil_common.cuh"\n')
#: the tree's vec16 grid: one group a CTA, sized to the work
_FLAT_GRID = """    const int ctas =
        ctas_for(n, static_cast<long long>(kUnroll) * kThreads *
                        static_cast<long long>(16 / sizeof(T)));
"""
#: resident: the grid at the resident count, each CTA looping over groups
_RESIDENT = (
    _INCLUDE,
    ("streams.cu",
     "  const long long p0 = blockIdx.x * kGroup + threadIdx.x;\n",
     "  for (long long g = blockIdx.x; g * kGroup < packs; g += gridDim.x) {\n"
     "  const long long p0 = g * kGroup + threadIdx.x;\n"),
    ("streams.cu",
     "    if (p < packs) po[p] = apply_pack<T>(op, vw[u], vx[u], vy[u]);\n"
     "  }\n",
     "    if (p < packs) po[p] = apply_pack<T>(op, vw[u], vx[u], vy[u]);\n"
     "  }\n  }\n"),
    ("streams.cu", _FLAT_GRID, """    static int resident = 0;
    const cudaError_t rc = coll_resident_ctas(
        reinterpret_cast<const void*>(stream_vec16_kernel<T, Op>), kThreads,
        &resident);
    if (rc != cudaSuccess) return rc;
    const int ctas = coll_grid(
        resident, n, static_cast<long long>(kUnroll) * kThreads *
                         static_cast<long long>(16 / sizeof(T)), 0);
"""))
#: cs: evict-first loads and stores on the vec16 route
_CS = tuple(("streams.cu", old, new) for old, new in (
    ("vw[u] = pw[p];", "vw[u] = __ldcs(pw + p);"),
    ("vx[u] = px[p];", "vx[u] = __ldcs(px + p);"),
    ("vy[u] = py[p];", "vy[u] = __ldcs(py + p);"),
    ("po[p] = apply_pack<T>(op, vw[u], vx[u], vy[u]);",
     "__stcs(po + p, apply_pack<T>(op, vw[u], vx[u], vy[u]));")))
#: bulk: the vec16 route through a ring of bulk copies. One CTA an SM.
#: Chunk c (kBulkChunk bytes of the packs of every stream) goes to CTA c
#: mod grid. Warp kBulkWarps's lane 0 keeps kBulkStages chunks of every
#: input stream in flight, global -> shared, each stage's bytes counted
#: on its `full` barrier. The consumer warps compute a chunk in place
#: into the stage's first input slot; consumer thread 0 sends that slot
#: back, shared -> global, and frees a chunk's stage (`empty`) after
#: issuing the next chunk's store, once the chunk's own store has read
#: its shared memory.
_BULK_KERNEL = r"""
constexpr int kBulkStages = 4;
constexpr int kBulkChunk = 16384;
constexpr int kBulkWarps = 8;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

template <typename T, typename Op>
__global__ void __launch_bounds__((kBulkWarps + 1) * 32, 1)
    stream_bulk_kernel(Op op, const T* w, const T* x, const T* y, T* out,
                       long long n) {
  constexpr int kIn = Op::kW + Op::kX + Op::kY;
  constexpr int kConsumers = kBulkWarps * 32;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      smem + static_cast<size_t>(kBulkStages) * kIn * kBulkChunk);
  const long long bytes = n / (16 / sizeof(T)) * 16;
  const long long chunks = (bytes + kBulkChunk - 1) / kBulkChunk;
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2 * kBulkStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                       smem_addr(bars + s))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const char* src[3];
  int k = 0;
  if (Op::kW) src[k++] = reinterpret_cast<const char*>(w);
  if (Op::kX) src[k++] = reinterpret_cast<const char*>(x);
  if (Op::kY) src[k++] = reinterpret_cast<const char*>(y);
  auto slot = [&](int s, int j) {
    return smem + (static_cast<size_t>(s) * kIn + j) * kBulkChunk;
  };
  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x != kConsumers) return;
    int i = 0;
    for (long long c = blockIdx.x; c < chunks; c += gridDim.x, ++i) {
      const int s = i % kBulkStages;
      bulk_wait(smem_addr(bars + kBulkStages + s),
                ((i / kBulkStages) & 1) ^ 1);
      const long long at = c * kBulkChunk;
      const uint32_t len = static_cast<uint32_t>(
          bytes - at < kBulkChunk ? bytes - at : kBulkChunk);
      const uint32_t full = smem_addr(bars + s);
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
              full),
          "r"(len * kIn)
          : "memory");
      for (int j = 0; j < kIn; ++j)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
            "bytes [%0], [%1], %2, [%3];" ::"r"(smem_addr(slot(s, j))),
            "l"(src[j] + at), "r"(len), "r"(full)
            : "memory");
    }
    return;
  }
  int i = 0, prev = -1;
  for (long long c = blockIdx.x; c < chunks; c += gridDim.x, ++i) {
    const int s = i % kBulkStages;
    bulk_wait(smem_addr(bars + s), (i / kBulkStages) & 1);
    const long long at = c * kBulkChunk;
    const int len = static_cast<int>(
        bytes - at < kBulkChunk ? bytes - at : kBulkChunk);
    uint4* o = reinterpret_cast<uint4*>(slot(s, 0));
    for (int p = threadIdx.x; p < len / 16; p += kConsumers) {
      uint4 v[3];
#pragma unroll
      for (int j = 0; j < kIn; ++j)
        v[j] = reinterpret_cast<const uint4*>(slot(s, j))[p];
      const uint4 vw = Op::kW ? v[0] : uint4{};
      const uint4 vx = Op::kX ? v[Op::kW ? 1 : 0] : uint4{};
      const uint4 vy = Op::kY ? v[kIn - 1] : uint4{};
      o[p] = apply_pack<T>(op, vw, vx, vy);
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
    if (threadIdx.x == 0) {
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
              reinterpret_cast<char*>(out) + at),
          "r"(smem_addr(o)), "r"(len)
          : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      if (prev >= 0)
        asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                         smem_addr(bars + kBulkStages + prev))
                     : "memory");
      prev = s;
    }
  }
  if (threadIdx.x == 0)
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  pack_tail<T>(op, w, x, y, out, n);
}

template <typename T, typename Op>
int launch_bulk(const Op& op, const T* w, const T* x, const T* y, T* out,
                long long n, cudaStream_t s) {
  constexpr int kIn = Op::kW + Op::kX + Op::kY;
  constexpr int smem =
      kBulkStages * kIn * kBulkChunk + 2 * kBulkStages * sizeof(uint64_t);
  static int sms = 0;
  if (sms == 0) {
    int dev = 0, count = 0;
    cudaError_t rc = cudaGetDevice(&dev);
    if (rc == cudaSuccess)
      rc = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                                  dev);
    if (rc == cudaSuccess)
      rc = cudaFuncSetAttribute(stream_bulk_kernel<T, Op>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem);
    if (rc != cudaSuccess) return rc;
    sms = count;
  }
  const long long chunks =
      (n / (16 / sizeof(T)) * 16 + kBulkChunk - 1) / kBulkChunk;
  const int ctas = coll_grid(sms, chunks, 1, 0);
  stream_bulk_kernel<T, Op><<<ctas, (kBulkWarps + 1) * 32, smem, s>>>(
      op, w, x, y, out, n);
  return cudaGetLastError();
}

"""
_LAUNCH = "// --- launch ---"
_BULK = (
    _INCLUDE,
    ("streams.cu", _LAUNCH, _BULK_KERNEL.lstrip("\n") + _LAUNCH),
    ("streams.cu", "  if (route == kStreamVec16) {\n" + _FLAT_GRID,
     "  if (route == kStreamVec16) {\n"
     "    return launch_bulk<T>(op, tw, tx, ty, to, n, stream);\n"
     + _FLAT_GRID))

#: variant -> (file, old text, new text) edits of the package's sources
VARIANTS = {
    "base": (),
    **{f"u{u}": (_set("int kUnroll", u),) for u in (1, 2, 4, 8)},
    "flat": (),
    "resident": _RESIDENT,
    "cs": _CS,
    "bulk": _BULK,
    **{f"t{n}": (_set("int kThreads", n),) for n in (128, 512)},
}
N24, N26, N28 = 1 << 24, 1 << 26, 1 << 28
#: the coefficient of the timed launches (chip_smoke.py's): in place the
#: values stay put from launch to launch
A = 1e-7


def kernel_name(mangled: str) -> str:
    """``stream_vec16_kernel<float, Daxpy>`` for the mangled name of a
    stream instance; the name itself when it is not one."""
    dtypes = {"f": "float", "d": "double", "13__nv_bfloat16": "bf16"}
    m = re.search(r"(stream_\w+?_kernel)I(f|d|13__nv_bfloat16)NS0_\d+"
                  r"(\w+?)I", mangled)
    return f"{m[1]}<{dtypes[m[2]]}, {m[3]}>" if m else mangled


def _queued(fn, n_iter: int) -> float:
    return statistics.median(flash_ab.time_queued(fn, n_iter)
                             for _ in range(3))


def measure(name: str) -> dict:
    """Build the package this process imported and time the kernels."""
    import torch

    from tpu_mpi_tests_torch.kernels import build, hand

    build.build(["streams"])
    row = {"variant": name,
           "ptxas": build.ptxas_summary("streams", kernel_name)}
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(n):
        return torch.rand(n, generator=gen, device=dev) + 1.0

    def case(label, name, kernel, plain, yardstick, ops, n_iter):
        """``kernel(*ops)`` (in place into ``ops[-1]``), checked against
        ``plain`` on a copy, then timed beside ``yardstick``."""
        hand.reset_launch_counts()
        copy = (*ops[:-1], ops[-1].clone())
        got, want = kernel(*copy), plain(*ops)
        row[label] = {"route": hand.stream_route(*ops),
                      "launched_on": {r: c for r, c in
                                      hand.route_counts()[name].items()
                                      if c},
                      "exact": bool(torch.equal(got, want))}
        del copy, got, want
        row[label]["queued_ms"] = _queued(lambda: kernel(*ops), n_iter)
        if yardstick is not None:
            row[label]["yardstick_queued_ms"] = _queued(
                lambda: yardstick(*ops), n_iter)

    for n in (N24, N26, N28):
        x, y = rand(n), rand(n)
        case(f"daxpy 2^{n.bit_length() - 1}", "daxpy",
             lambda x, y: hand.daxpy(A, x, y, out=y),
             lambda x, y: hand.daxpy_ref(A, x, y),
             lambda x, y: y.add_(x, alpha=A), (x, y),
             20 if n < N28 else 10)
        del x, y
        torch.cuda.empty_cache()
    x = rand(N26)
    case("stream_scale 2^26", "stream_scale",
         lambda x: hand.stream_scale(A, x, out=x),
         lambda x: hand.stream_scale_ref(A, x), lambda x: x.mul_(A), (x,),
         20)
    w, y = rand(N26), rand(N26)
    case("stream_sum3 2^26", "stream_sum3",
         lambda w, x, y: hand.stream_sum3(w, x, y, out=y),
         hand.stream_sum3_ref, None, (w, x, y), 20)
    del w, x, y
    torch.cuda.empty_cache()
    gb = 4 * N26 / 1e9  # one pass at 2^26 float32
    for key, fit in (("queued_ms", "fit_gbps"),
                     ("yardstick_queued_ms", "yardstick_fit_gbps")):
        t3, t2 = row["daxpy 2^26"][key], row["stream_scale 2^26"][key]
        row[fit] = gb / ((t3 - t2) / 1e3) if t3 > t2 else float("nan")
    return row


if __name__ == "__main__":
    sys.exit(flash_ab.main(module="stream_ab", variants=VARIANTS,
                           default=("base", "u4")))
