// One-shot all-gather and allreduce by peer stores: one launch, one hop.
//
// Replaces the Pallas kernel _oneshot_kernel
// (tpu_mpi_tests/kernels/collectives_pallas.py:74, called by _oneshot_call
// :179 for oneshot_allgather_pallas :274 and oneshot_allreduce_pallas
// :308). Every rank stores its whole shard into slot `my` of every peer's
// comm buffer in one burst, then combines the w slots locally:
//   * gather: out = the w slots in rank order (w·n elements);
//   * sum:    out = slot 0 + slot 1 + ... + slot w-1, folded in ascending
//             source rank (acc = slot0; acc = acc + slot_s), in the dtype
//             (bfloat16 rounded per op, stencil_common.cuh) — the fixed,
//             rank-independent order of :29-33 and :327-330, so every rank
//             holds functools.reduce(add, shards) bit for bit.
// The rank's own slot is read from x itself (it is never stored).
//
// Synchronisation. An all-to-all entry barrier: rank p signals kOsBar[p]
// in every peer's pad, and a rank stores into the peers only after each
// of them has entered this launch (its previous launch on the comm
// buffer has finished). Each comm slot is written by exactly one rank in
// a launch, so one arrival flag per source rank (kOsArr[p], set by the
// last of p's CTAs once they are counted) says the slot is complete.
//
// Bound on the H100. At world = 1 (collbench's rows on one card) one copy
// in device memory: x read once and out written once, 2·n·itemsize over
// 3.35 TB/s. At world > 1 the burst leaves over NVLink, (w-1)·n·itemsize
// at 450 GB/s each way, then the w-1 arrived slots are read and out
// written in device memory. Small shards are bound by the launch and the
// two all-to-all waits (a few µs).
//
// Design. The JAX wrapper zero-pads a shard to a TPU tile because Mosaic's
// DMA needs it; a CUDA thread stores any element anywhere, so any n works
// and nothing is padded. Two routes, named by the wrapper (hand.coll_route
// over the shard's bytes) and checked here: where x, out and every comm
// buffer start on 16 bytes and the shard is whole 16-byte vectors, "vec16"
// moves uint4s — the burst loads each vector of x once and stores it to
// the w-1 peers, the fold unpacks each vector into 4 float, 2 double or 8
// bf16 and adds them with Elt<T> in ascending rank, slots read through L2
// (load_peer) — each thread with kUnroll vectors in flight; any other
// shard takes "scalar", the same passes one element at a time, one in
// flight. Every CTA of a launch must be resident at once (each waits for
// the peers' arrivals): the grid is the occupancy API's resident count
// for the kernel, clipped to the work and to `max_ctas`. After the burst
// a CTA crosses one barrier and its thread 0 counts it with one
// acquire-release add at system scope (coll_arrive_cta). At world = 1
// the launch is one copy (gather, or the one-term fold) and touches no
// pad.
#include <climits>
#include <cstdint>

#include "ring_common.cuh"
#include "stencil_common.cuh"

namespace tpumt {
namespace {

constexpr int kThreads = 256;
// 16-byte vectors each thread has in flight on the vec16 route (the
// scalar route: one element)
constexpr int kUnroll = 4;

template <typename V>
constexpr int kUnrollOf = sizeof(V) == 16 ? kUnroll : 1;

template <typename V>
struct OsArgs {
  const V* x;                 // my shard, n items
  V* out;                     // n (sum) or w·n (gather) items
  const V* mine;              // my comm buffer: slot s written by rank s
  V* comm[kCollMaxWorld];     // every rank's comm buffer (w·n items)
  int* pad;                   // mine
  int* pads[kCollMaxWorld];   // every rank's pad
  int epoch, w, my, sum;
  long long n;                // items of V in a shard
};

// T: the element type of the fold; V: what a thread moves at a time (T,
// or a uint4 of 16 / sizeof(T) elements).
template <typename T, typename V>
__global__ void __launch_bounds__(kThreads) oneshot_kernel(OsArgs<V> a) {
  __shared__ int epoch_slot;
  if (a.w > 1) a.epoch = launch_epoch(a.pad, &epoch_slot);
  constexpr int kU = kUnrollOf<V>;
  const int ctas = static_cast<int>(gridDim.x);
  const long long n = a.n;
  const int w = a.w, my = a.my;
  const V* x = a.x;
  if (w > 1) {
    if (threadIdx.x == 0) {
#pragma unroll
      for (int p = 0; p < kCollMaxWorld; ++p)
        if (blockIdx.x == 0 && p < w && p != my)
          pad_signal(a.pads[p] + kOsBar + my, a.epoch);
#pragma unroll
      for (int p = 0; p < kCollMaxWorld; ++p)
        if (p < w && p != my) pad_wait(a.pad + kOsBar + p, a.epoch);
    }
    __syncthreads();
    V* dst[kCollMaxWorld];  // slot `my` of every peer's comm buffer
#pragma unroll
    for (int p = 0; p < kCollMaxWorld; ++p)
      dst[p] = p < w && p != my ? a.comm[p] + my * n : nullptr;
    coll_sweep<kU, V>(  // the burst
        n, [=](long long e) { return x[e]; },
        [=](long long e, const V& v) {
#pragma unroll
          for (int p = 0; p < kCollMaxWorld; ++p)
            if (dst[p]) dst[p][e] = v;
        });
    if (coll_arrive_cta(a.pad + kCollSent, ctas)) {
#pragma unroll
      for (int p = 0; p < kCollMaxWorld; ++p)
        if (p < w && p != my) pad_signal(a.pads[p] + kOsArr + my, a.epoch);
    }
    if (threadIdx.x == 0) {
#pragma unroll
      for (int p = 0; p < kCollMaxWorld; ++p)
        if (p < w && p != my) pad_wait(a.pad + kOsArr + p, a.epoch);
    }
    __syncthreads();
  }
  const V* mine = a.mine;
  V* out = a.out;
  if (a.sum) {
    // acc = slot 0; acc = acc + slot s in ascending s, kU items of
    // every slot in flight a thread
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    for (long long e0 = blockIdx.x * static_cast<long long>(blockDim.x) +
                        threadIdx.x;
         e0 < n; e0 += stride * kU) {
      V acc[kU];
      const V* slot = my == 0 ? x : mine;
#pragma unroll
      for (int u = 0; u < kU; ++u)
        if (e0 + u * stride < n) acc[u] = load_peer(slot + e0 + u * stride);
      for (int s = 1; s < w; ++s) {
        slot = s == my ? x : mine + s * n;
        V v[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u)
          if (e0 + u * stride < n) v[u] = load_peer(slot + e0 + u * stride);
#pragma unroll
        for (int u = 0; u < kU; ++u)
          if (e0 + u * stride < n) acc[u] = fold<T>(acc[u], v[u]);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u)
        if (e0 + u * stride < n) out[e0 + u * stride] = acc[u];
    }
  } else {
    for (int s = 0; s < w; ++s) {
      const V* slot = s == my ? x : mine + s * n;
      V* to = out + s * n;
      coll_sweep<kU, V>(
          n, [=](long long e) { return load_peer(slot + e); },
          [=](long long e, const V& v) { to[e] = v; });
    }
  }
  if (w > 1) coll_exit(a.pad);
}

// n, in items of V
template <typename T, typename V>
int launch(const void* x, void* out, void* const* comms, void* const* pads,
           int w, int my, long long n, int sum, int max_ctas,
           cudaStream_t s) {
  static int resident = 0;
  const cudaError_t rc = coll_resident_ctas(
      reinterpret_cast<const void*>(oneshot_kernel<T, V>), kThreads,
      &resident);
  if (rc != cudaSuccess) return rc;
  OsArgs<V> a{};
  a.x = static_cast<const V*>(x);
  a.out = static_cast<V*>(out);
  a.mine = static_cast<const V*>(comms[my]);
  a.pad = static_cast<int*>(pads[my]);
  for (int p = 0; p < w; ++p) {
    a.comm[p] = static_cast<V*>(comms[p]);
    a.pads[p] = static_cast<int*>(pads[p]);
  }
  a.w = w;
  a.my = my;
  a.sum = sum;
  a.n = n;
  const int ctas = coll_grid(resident, n,
                             static_cast<long long>(kThreads) * kUnrollOf<V>,
                             max_ctas);
  oneshot_kernel<T, V><<<ctas, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
int launch_route(const void* x, void* out, void* const* comms,
                 void* const* pads, int w, int my, long long n, int sum,
                 int route, int max_ctas, cudaStream_t s) {
  if (route == kRouteVec16)
    return launch<T, uint4>(x, out, comms, pads, w, my,
                            n * static_cast<long long>(sizeof(T)) / 16, sum,
                            max_ctas, s);
  return launch<T, T>(x, out, comms, pads, w, my, n, sum, max_ctas, s);
}

}  // namespace
}  // namespace tpumt

// Plain C entry point (bound with ctypes). Returns a cudaError_t: 0 when
// the launch was accepted. `x` is my shard of `n` elements (dtype code of
// stencil_common.cuh); `out` holds n (sum = 1) or w·n (sum = 0) elements;
// `comms` and `pads` are host arrays of the w ranks' comm buffers (w·n
// elements each, written by the peers; at w = 1 any pointer, never read)
// and signal pads, indexed by rank (at w > 1 my pad's launch counter
// gives the launch its epoch); `route` is the CollRoute code that
// hand.coll_route names for x, out and the comm buffers over the shard's
// n elements (any other value is refused); `max_ctas` caps the grid (0:
// the card's resident count for the kernel).
extern "C" int tpumt_oneshot(const void* x, void* out, void* const* comms,
                             void* const* pads, int dtype, int w,
                             int my, long long n, int sum, int route,
                             int max_ctas, void* stream) {
  using namespace tpumt;
  if (n < 1 || w < 1 || w > kCollMaxWorld || my < 0 || my >= w ||
      max_ctas < 0 || n > LLONG_MAX / w / 8 ||
      comms == nullptr || pads == nullptr ||
      (dtype != kF32 && dtype != kF64 && dtype != kBF16))
    return cudaErrorInvalidValue;
  const int itemsize = dtype == kF64 ? 8 : dtype == kBF16 ? 2 : 4;
  int want = coll_route(n * itemsize, {x, out});
  for (int p = 0; p < w; ++p)
    if (!aligned16(comms[p])) want = kRouteScalar;
  if (route != want) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_route<float>(x, out, comms, pads, w, my, n, sum,
                                 route, max_ctas, s);
    case kF64:
      return launch_route<double>(x, out, comms, pads, w, my, n, sum,
                                  route, max_ctas, s);
    default:
      return launch_route<__nv_bfloat16>(x, out, comms, pads, w, my,
                                         n, sum, route, max_ctas, s);
  }
}
