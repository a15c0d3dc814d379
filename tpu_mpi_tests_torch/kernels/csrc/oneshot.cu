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
// last of p's CTAs once its stores are fenced) says the slot is complete.
//
// Design. The JAX wrapper zero-pads a shard to a TPU tile because Mosaic's
// DMA needs it; a CUDA thread stores any element anywhere, so any n works
// and nothing is padded. Every CTA takes a grid-stride share of the shard
// (the burst) and of the output (the combine); every CTA of the launch is
// resident at once (coll_ctas), since each waits for the peers' arrivals.
// At world = 1 the launch is one copy (gather) or the one-term fold (sum),
// and touches no pad.
//
// Bound on the H100: bytes. x read once and stored to w-1 peers (over
// NVLink at world > 1), the w-1 arrived slots read once, out written once.
#include <climits>
#include <cstdint>

#include "ring_common.cuh"
#include "stencil_common.cuh"

namespace tpumt {
namespace {

constexpr int kThreads = 256;

template <typename T>
struct OsArgs {
  const T* x;                 // my shard, n elements
  T* out;                     // n (sum) or w·n (gather) elements
  T* comm[kCollMaxWorld];     // every rank's comm buffer (w·n elements)
  int* pads[kCollMaxWorld];   // every rank's pad
  int epoch, w, my, sum;
  long long n;
};

// Slot s of element e: my own shard for s == my, else what rank s stored.
template <typename T>
__device__ __forceinline__ T slot_value(const OsArgs<T>& a, int s,
                                        long long e) {
  return s == a.my ? a.x[e] : load_cg(a.comm[a.my] + s * a.n + e);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) oneshot_kernel(OsArgs<T> a) {
  using E = Elt<T>;
  const long long first = blockIdx.x * static_cast<long long>(blockDim.x) +
                          threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const int ctas = static_cast<int>(gridDim.x);
  const long long n = a.n;
  const int w = a.w, my = a.my;
  int* pad = a.pads[my];
  if (w > 1) {
    if (blockIdx.x == 0 && threadIdx.x == 0)
      for (int p = 0; p < w; ++p)
        if (p != my) pad_signal(a.pads[p] + kOsBar + my, a.epoch);
    if (threadIdx.x == 0)
      for (int p = 0; p < w; ++p)
        if (p != my) pad_wait(pad + kOsBar + p, a.epoch);
    __syncthreads();
    for (long long e = first; e < n; e += stride) {  // the burst
      const T v = a.x[e];
      for (int p = 0; p < w; ++p)
        if (p != my) a.comm[p][my * n + e] = v;
    }
    __threadfence_system();
    __syncthreads();
    if (threadIdx.x == 0 && atomicAdd(pad + kCollSent, 1) == ctas - 1) {
      __threadfence_system();
      for (int p = 0; p < w; ++p)
        if (p != my) pad_signal(a.pads[p] + kOsArr + my, a.epoch);
    }
    if (threadIdx.x == 0)
      for (int p = 0; p < w; ++p)
        if (p != my) pad_wait(pad + kOsArr + p, a.epoch);
    __syncthreads();
  }
  if (a.sum) {
    for (long long e = first; e < n; e += stride) {
      T v = slot_value(a, 0, e);
      typename E::C acc = E::load(&v);
      for (int s = 1; s < w; ++s) {
        v = slot_value(a, s, e);
        acc = E::add(acc, E::load(&v));
      }
      a.out[e] = E::store(acc);
    }
  } else {
    for (int s = 0; s < w; ++s)
      for (long long e = first; e < n; e += stride)
        a.out[s * n + e] = slot_value(a, s, e);
  }
  if (w > 1) coll_exit(pad);
}

template <typename T>
int launch(const void* x, void* out, void* const* comms, void* const* pads,
           int epoch, int w, int my, long long n, int sum, int max_ctas,
           cudaStream_t s) {
  OsArgs<T> a{};
  a.x = static_cast<const T*>(x);
  a.out = static_cast<T*>(out);
  for (int p = 0; p < w; ++p) {
    a.comm[p] = static_cast<T*>(comms[p]);
    a.pads[p] = static_cast<int*>(pads[p]);
  }
  a.epoch = epoch;
  a.w = w;
  a.my = my;
  a.sum = sum;
  a.n = n;
  const int ctas = coll_ctas(n, kThreads, max_ctas);
  oneshot_kernel<T><<<ctas, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace tpumt

// Plain C entry point (bound with ctypes). Returns a cudaError_t: 0 when
// the launch was accepted. `x` is my shard of `n` elements (dtype code of
// stencil_common.cuh); `out` holds n (sum = 1) or w·n (sum = 0) elements;
// `comms` and `pads` are host arrays of the w ranks' comm buffers (w·n
// elements each, written by the peers; unused at w = 1) and signal pads,
// indexed by rank; `epoch` counts this process's RDMA launches from 1;
// `max_ctas` caps the grid (0: the default).
extern "C" int tpumt_oneshot(const void* x, void* out, void* const* comms,
                             void* const* pads, int epoch, int dtype, int w,
                             int my, long long n, int sum, int max_ctas,
                             void* stream) {
  using namespace tpumt;
  if (n < 1 || w < 1 || w > kCollMaxWorld || my < 0 || my >= w ||
      epoch < 1 || max_ctas < 0 || n > LLONG_MAX / w || comms == nullptr ||
      pads == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch<float>(x, out, comms, pads, epoch, w, my, n, sum,
                           max_ctas, s);
    case kF64:
      return launch<double>(x, out, comms, pads, epoch, w, my, n, sum,
                            max_ctas, s);
    case kBF16:
      return launch<__nv_bfloat16>(x, out, comms, pads, epoch, w, my, n, sum,
                                   max_ctas, s);
    default:
      return cudaErrorInvalidValue;
  }
}
