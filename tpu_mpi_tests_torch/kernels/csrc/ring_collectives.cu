// Ring all-gather and ring reduce-scatter by peer stores: w-1 hops, each
// rank storing straight into its right neighbour's buffer.
//
// Replaces the Pallas kernels ring_allgather_pallas
// (tpu_mpi_tests/kernels/pallas_kernels.py:2339, body
// _ring_allgather_kernel :2254) and ring_reduce_scatter_pallas (:2576,
// body _ring_reduce_scatter_kernel :2429); ring_allreduce_pallas (:2717)
// is the two launched one after the other (kernels/hand.py).
//
// All-gather. Rank r's shard x (n elements) becomes region r of the
// gathered array. Step s stores region (r - s) mod w into the same region
// of the right neighbour's buffer: its own block at step 0, then the
// region that arrived from the left at step s-1. Forwarding at step s
// waits for exactly the step-(s-1) arrival (a per-step flag, kAgArr[s],
// never one anonymous count that a later step's arrival could meet: the
// RAW hazard of :2264-2276). Every region is written once per launch.
// Each arrived region is copied into `out` as it is forwarded; the last
// one after the last wait. At world = 1 `buf` is `out` itself and nothing
// is copied twice.
//
// Reduce-scatter. Rank r ends owning chunk r (n/w elements) of the
// elementwise sum. Step s stores the running partial of chunk
// (r - s - 1) mod w into the right neighbour's comm slot s % credits: at
// step 0 the rank's own chunk, later the fold `received + local chunk`
// (in the dtype; bfloat16 rounded per op, stencil_common.cuh), which the
// rank computes into its local send buffer, then frees the slot it read
// (a credit to the left, kRsCred), then waits for a free slot at the
// right (the receiver credits of :2519-2573), then stores. The last fold
// goes to `out`. With credits = 2, two payloads may be in flight; each
// step has its own arrival flag (kRsArr[s]), so an arrival never answers
// another step's wait. The fold order is the JAX kernel's step for step,
// so the result equals the plain version bit for bit.
//
// The self-ring (world = 1, `w` = k > 1): both neighbours are the rank
// itself, every pointer is its own; the all-gather seeds every region with
// x first (the result is tile(x, k)), the reduce-scatter returns the fold
// of its own k chunks in the ring's order. It runs every step, flag and
// credit of the k-step schedule on one card.
//
// Design. Every CTA takes a grid-stride share of each step's region, the
// same share at every step; a per-step local counter (kCollSent[s],
// kCollFolded[s]) lets the last CTA of a step signal the peer. The CTAs
// wait for each other's peers, so every CTA of the launch must be resident
// at once: at most two CTAs per SM (coll_ctas). The entry barrier (kAgBar,
// kRsBar: the right neighbour entered this launch, so its previous launch
// on the buffer has finished) is the back-pressure across chained
// launches, as in ring_halo.cu.
//
// Bound on the H100: bytes. All-gather: x read once, out written once
// ((w-1)·n elements stored to the right neighbour, over NVLink at world > 1,
// 450 GB/s each way). Reduce-scatter: x read once, out written once, plus
// the (w-1) payloads of n/w elements.
#include <climits>
#include <cstdint>

#include "ring_common.cuh"
#include "stencil_common.cuh"

namespace tpumt {
namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ long long ring_mod(long long a, long long w) {
  return ((a % w) + w) % w;
}

// An element a peer stored during this launch, in the compute type.
template <typename T>
__device__ __forceinline__ typename Elt<T>::C load_elt_cg(const T* p) {
  const T v = load_cg(p);
  return Elt<T>::load(&v);
}

template <typename U>
struct AgArgs {
  const U* x;    // my shard, n elements
  U* out;        // the gathered array, w·n elements
  U* buf;        // my receive buffer (out itself at world = 1)
  U* right_buf;  // the right neighbour's receive buffer
  int* pad;
  int* left_pad;
  int* right_pad;
  int epoch, w, my, seed_all;
  long long n;
};

template <typename U>
__global__ void __launch_bounds__(kThreads)
    ring_allgather_kernel(AgArgs<U> a) {
  const long long first = blockIdx.x * static_cast<long long>(blockDim.x) +
                          threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const int ctas = static_cast<int>(gridDim.x);
  const long long n = a.n;
  const int steps = a.w - 1;
  if (a.seed_all) {  // the self-ring: every region starts as the shard
    for (int i = 0; i < a.w; ++i)
      for (long long e = first; e < n; e += stride) a.out[i * n + e] = a.x[e];
  }
  if (steps == 0) {  // one rank: out is my shard
    for (long long e = first; e < n; e += stride) a.out[e] = a.x[e];
    return;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0)
    pad_signal(a.left_pad + kAgBar, a.epoch);  // the left may write me
  coll_wait(a.pad + kAgBar, a.epoch);          // I may write the right
  const bool copy = a.buf != a.out;
  for (int s = 0; s < steps; ++s) {
    const long long src = ring_mod(a.my - s, a.w);
    U* dst = a.right_buf + src * n;
    if (s == 0) {
      U* own = a.out + src * n;
      for (long long e = first; e < n; e += stride) {
        const U v = a.x[e];
        own[e] = v;
        dst[e] = v;
      }
    } else {
      coll_wait(a.pad + kAgArr + s - 1, a.epoch);  // region src arrived
      const U* from = a.buf + src * n;
      U* own = a.out + src * n;
      for (long long e = first; e < n; e += stride) {
        const U v = load_cg(from + e);
        if (copy) own[e] = v;
        dst[e] = v;
      }
    }
    coll_arrive(a.pad + kCollSent + s, ctas, a.right_pad + kAgArr + s,
                a.epoch);
  }
  coll_wait(a.pad + kAgArr + steps - 1, a.epoch);  // the last region
  if (copy) {
    const long long last = ring_mod(a.my - steps, a.w);
    const U* from = a.buf + last * n;
    U* own = a.out + last * n;
    for (long long e = first; e < n; e += stride) own[e] = load_cg(from + e);
  }
  coll_exit(a.pad);
}

template <typename T>
struct RsArgs {
  const T* x;     // my shard, w chunks of cn elements
  T* out;         // my chunk of the sum, cn elements
  T* comm;        // my comm slots (credits × cn), written by the left
  T* right_comm;  // the right neighbour's comm slots
  T* send;        // my local send buffer, cn elements
  int* pad;
  int* left_pad;
  int* right_pad;
  int epoch, w, my, credits;
  long long cn;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ring_reduce_scatter_kernel(RsArgs<T> a) {
  using E = Elt<T>;
  const long long first = blockIdx.x * static_cast<long long>(blockDim.x) +
                          threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const int ctas = static_cast<int>(gridDim.x);
  const long long cn = a.cn;
  const int w = a.w;
  if (w == 1) {  // one rank: its shard is the sum (:2501-2505)
    for (long long e = first; e < cn; e += stride) a.out[e] = a.x[e];
    return;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0)
    pad_signal(a.left_pad + kRsBar, a.epoch);  // the left may write me
  coll_wait(a.pad + kRsBar, a.epoch);          // I may write the right
  for (int s = 0; s < w - 1; ++s) {
    const T* local = a.x + ring_mod(a.my - s - 1, w) * cn;
    const T* from = local;  // step 0 sends my own chunk verbatim
    if (s > 0) {
      // payload s-1 (the partial of this step's chunk) is in my slot
      coll_wait(a.pad + kRsArr + s - 1, a.epoch);
      const T* slot = a.comm + ((s - 1) % a.credits) * cn;
      for (long long e = first; e < cn; e += stride)
        a.send[e] = E::store(E::add(load_elt_cg(slot + e), E::load(local + e)));
      if (s - 1 <= w - 2 - a.credits)  // someone stores into it again
        coll_arrive(a.pad + kCollFolded + s - 1, ctas,
                    a.left_pad + kRsCred + s - 1, a.epoch);
      from = a.send;
    }
    if (s >= a.credits)  // the right consumed payload s - credits
      coll_wait(a.pad + kRsCred + s - a.credits, a.epoch);
    T* dst = a.right_comm + (s % a.credits) * cn;
    for (long long e = first; e < cn; e += stride) dst[e] = from[e];
    coll_arrive(a.pad + kCollSent + s, ctas, a.right_pad + kRsArr + s,
                a.epoch);
  }
  coll_wait(a.pad + kRsArr + w - 2, a.epoch);
  const T* slot = a.comm + ((w - 2) % a.credits) * cn;
  const T* local = a.x + static_cast<long long>(a.my) * cn;
  for (long long e = first; e < cn; e += stride)
    a.out[e] = E::store(E::add(load_elt_cg(slot + e), E::load(local + e)));
  coll_exit(a.pad);
}

template <typename U>
int launch_allgather(const void* x, void* out, void* buf, void* right_buf,
                     int* pad, int* left_pad, int* right_pad, int epoch,
                     int w, int my, long long n, int seed_all, int max_ctas,
                     cudaStream_t s) {
  AgArgs<U> a{static_cast<const U*>(x), static_cast<U*>(out),
              static_cast<U*>(buf), static_cast<U*>(right_buf), pad,
              left_pad, right_pad, epoch, w, my, seed_all, n};
  const int ctas = coll_ctas(n, kThreads, max_ctas);
  ring_allgather_kernel<U><<<ctas, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
int launch_reduce_scatter(const void* x, void* out, void* comm,
                          void* right_comm, void* send, int* pad,
                          int* left_pad, int* right_pad, int epoch, int w,
                          int my, long long cn, int credits, int max_ctas,
                          cudaStream_t s) {
  RsArgs<T> a{static_cast<const T*>(x), static_cast<T*>(out),
              static_cast<T*>(comm), static_cast<T*>(right_comm),
              static_cast<T*>(send), pad, left_pad, right_pad, epoch, w, my,
              credits, cn};
  const int ctas = coll_ctas(cn, kThreads, max_ctas);
  ring_reduce_scatter_kernel<T><<<ctas, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace tpumt

// Plain C entry points (bound with ctypes). Each returns a cudaError_t: 0
// when the launch was accepted. The pads are int32 words (comm/peer.py);
// `epoch` counts this process's RDMA launches from 1; `w` is the ring's
// size (world, or k on the self-ring, where every pointer is the rank's
// own and `my` is 0); `max_ctas` caps the grid (0: the default,
// coll_ctas), so that several instances of a kernel can be resident on
// one card at once.

// All-gather of `n` elements of `itemsize` bytes per rank: `out` holds
// w·n, `buf` is my receive buffer (w·n; `out` itself at world = 1 and on
// the self-ring), `right_buf` the right neighbour's; `seed_all` (the
// self-ring) seeds every region of `out` with `x`.
extern "C" int tpumt_ring_allgather(const void* x, void* out, void* buf,
                                    void* right_buf, void* pad,
                                    void* left_pad, void* right_pad,
                                    int epoch, int itemsize, int w, int my,
                                    long long n, int seed_all, int max_ctas,
                                    void* stream) {
  using namespace tpumt;
  if (n < 1 || w < 1 || w > kCollMaxWorld || my < 0 || my >= w ||
      epoch < 1 || max_ctas < 0 || (seed_all && (my != 0 || w < 2)) ||
      n > LLONG_MAX / w)
    return cudaErrorInvalidValue;
  int* p = static_cast<int*>(pad);
  int* lp = static_cast<int*>(left_pad);
  int* rp = static_cast<int*>(right_pad);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (itemsize) {
    case 2:
      return launch_allgather<Bits<2>::U>(x, out, buf, right_buf, p, lp, rp,
                                          epoch, w, my, n, seed_all,
                                          max_ctas, s);
    case 4:
      return launch_allgather<Bits<4>::U>(x, out, buf, right_buf, p, lp, rp,
                                          epoch, w, my, n, seed_all,
                                          max_ctas, s);
    case 8:
      return launch_allgather<Bits<8>::U>(x, out, buf, right_buf, p, lp, rp,
                                          epoch, w, my, n, seed_all,
                                          max_ctas, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// Reduce-scatter of my shard `x` (w chunks of `cn` elements, dtype code
// of stencil_common.cuh) into `out` (cn): `comm` is my `credits` comm
// slots of cn elements (written by the left), `right_comm` the right
// neighbour's, `send` cn elements of local scratch.
extern "C" int tpumt_ring_reduce_scatter(const void* x, void* out,
                                         void* comm, void* right_comm,
                                         void* send, void* pad,
                                         void* left_pad, void* right_pad,
                                         int epoch, int dtype, int w, int my,
                                         long long cn, int credits,
                                         int max_ctas, void* stream) {
  using namespace tpumt;
  if (cn < 1 || w < 1 || w > kCollMaxWorld || my < 0 || my >= w ||
      epoch < 1 || max_ctas < 0 || (credits != 1 && credits != 2) ||
      cn > LLONG_MAX / w)
    return cudaErrorInvalidValue;
  int* p = static_cast<int*>(pad);
  int* lp = static_cast<int*>(left_pad);
  int* rp = static_cast<int*>(right_pad);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_reduce_scatter<float>(x, out, comm, right_comm, send, p,
                                          lp, rp, epoch, w, my, cn, credits,
                                          max_ctas, s);
    case kF64:
      return launch_reduce_scatter<double>(x, out, comm, right_comm, send, p,
                                           lp, rp, epoch, w, my, cn, credits,
                                           max_ctas, s);
    case kBF16:
      return launch_reduce_scatter<__nv_bfloat16>(
          x, out, comm, right_comm, send, p, lp, rp, epoch, w, my, cn,
          credits, max_ctas, s);
    default:
      return cudaErrorInvalidValue;
  }
}
