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
// (in the dtype; bfloat16 rounded per op, stencil_common.cuh). The last
// fold goes to `out`. Each step has its own arrival flag (kRsArr[s]), so
// an arrival never answers another step's wait, and a receiver frees the
// slot it read with a credit to the left (kRsCred[s], the receiver
// credits of :2519-2573). The fold order is the JAX kernel's step for
// step, so the result equals the plain version bit for bit.
//   * credits = 1: the fold goes into a local send buffer; the rank then
//     credits its left, waits for its right's credit, and stores. Folding
//     straight into the right's one slot would make every rank wait for
//     its right's credit before crediting its left: the ring deadlocks.
//   * credits = 2: the slot a step stores into was freed by the credit
//     of payload s-2, two steps old, which never waits on this rank's
//     own step. So the fold reads my slot (s-1) % 2 and stores straight
//     into the right's slot s % 2 in one pass, and the credit goes left
//     when every CTA has read the slot.
//
// The self-ring (world = 1, `w` = k > 1): both neighbours are the rank
// itself, every pointer is its own; the all-gather's step 0 stores each
// vector of x into every region (the result is tile(x, k)), the
// reduce-scatter returns the fold of its own k chunks in the ring's
// order. It runs every step, flag and credit of the k-step schedule on
// one card.
//
// Bound on the H100: bytes. At world = 1 (the main paths' case) each
// kernel is one copy of the shard: x read once and out written once in
// device memory, 2·n·itemsize over 3.35 TB/s. At world > 1 the ring's
// (w-1) hops of n elements (the all-gather) or n/w (the reduce-scatter)
// leave over NVLink at 450 GB/s each way, and each hop's step waits for
// the one before.
//
// Design. Two routes, named by the wrapper (hand.coll_route) and checked
// here: where every pointer is 16-byte aligned and a region (chunk) is a
// whole number of 16-byte vectors, "vec16" moves uint4s, each thread
// issuing kUnroll independent 16-byte loads before it stores them (the
// reduce-scatter unpacks each uint4 into 4 float, 2 double or 8 bf16,
// folds each with Elt<T> and packs it again); any other shard takes
// "scalar", one element at a time. Peer-written data is read through L2
// (ld.global.cg). The CTAs wait for each other's signals, so every CTA of
// a launch must be resident at once: the grid is the card's resident
// count for the kernel (the occupancy API's CTAs per SM × SMs), clipped
// to the work and to `max_ctas`. Every CTA takes a grid-stride share of
// each step's region, the same share at every step; after its share a
// CTA crosses one barrier and its thread 0 counts it in a per-step
// local counter (kCollSent[s], kCollFolded[s]) with one acquire-release
// add at system scope (coll_arrive_cta: no separate fence), so that the
// last CTA of a step signals the peers. World = 1 is one 16-byte copy
// kernel that touches no pad. The entry barrier (kAgBar, kRsBar: the
// right neighbour entered this launch, so its previous launch on the
// buffer has finished) is the back-pressure across chained launches, as
// in ring_halo.cu.
#include <climits>
#include <cstdint>

#include "ring_common.cuh"
#include "stencil_common.cuh"

namespace tpumt {
namespace {

constexpr int kThreads = 256;
// 16-byte vectors each thread has in flight on the vec16 route
constexpr int kUnroll = 4;

__device__ __forceinline__ long long ring_mod(long long a, long long w) {
  return ((a % w) + w) % w;
}

// World = 1: out = x, n items.
template <typename V, int kU>
__global__ void __launch_bounds__(kThreads)
    coll_copy_kernel(const V* x, V* out, long long n) {
  coll_sweep<kU, V>(
      n, [=](long long e) { return x[e]; },
      [=](long long e, const V& v) { out[e] = v; });
}

template <typename V>
struct AgArgs {
  const V* x;    // my shard, n items
  V* out;        // the gathered array, w·n items
  V* buf;        // my receive buffer (out itself at world = 1)
  V* right_buf;  // the right neighbour's receive buffer
  int* pad;
  int* left_pad;
  int* right_pad;
  int epoch, w, my, seed_all;
  long long n;
};

template <typename V, int kU>
__global__ void __launch_bounds__(kThreads)
    ring_allgather_kernel(AgArgs<V> a) {
  __shared__ int epoch_slot;
  a.epoch = launch_epoch(a.pad, &epoch_slot);
  const int ctas = static_cast<int>(gridDim.x);
  const long long n = a.n;
  const int w = a.w, steps = a.w - 1;
  const V* x = a.x;
  V* out = a.out;
  if (blockIdx.x == 0 && threadIdx.x == 0)
    pad_signal(a.left_pad + kAgBar, a.epoch);  // the left may write me
  coll_wait(a.pad + kAgBar, a.epoch);          // I may write the right
  const bool copy = a.buf != a.out;
  for (int s = 0; s < steps; ++s) {
    const long long src = ring_mod(a.my - s, w);
    V* dst = a.right_buf + src * n;
    V* own = out + src * n;
    if (s == 0 && a.seed_all) {
      // the self-ring: each vector of x read once and stored into every
      // region of out, my own among them
      const bool also = dst != own;
      coll_sweep<kU, V>(
          n, [=](long long e) { return x[e]; },
          [=](long long e, const V& v) {
            for (int i = 0; i < w; ++i) out[i * n + e] = v;
            if (also) dst[e] = v;
          });
    } else if (s == 0) {
      coll_sweep<kU, V>(
          n, [=](long long e) { return x[e]; },
          [=](long long e, const V& v) {
            own[e] = v;
            dst[e] = v;
          });
    } else {
      coll_wait(a.pad + kAgArr + s - 1, a.epoch);  // region src arrived
      const V* from = a.buf + src * n;
      coll_sweep<kU, V>(
          n, [=](long long e) { return load_peer(from + e); },
          [=](long long e, const V& v) {
            if (copy) own[e] = v;
            dst[e] = v;
          });
    }
    if (coll_arrive_cta(a.pad + kCollSent + s, ctas))
      pad_signal(a.right_pad + kAgArr + s, a.epoch);
  }
  coll_wait(a.pad + kAgArr + steps - 1, a.epoch);  // the last region
  if (copy) {
    const long long last = ring_mod(a.my - steps, w);
    const V* from = a.buf + last * n;
    V* own = out + last * n;
    coll_sweep<kU, V>(
        n, [=](long long e) { return load_peer(from + e); },
        [=](long long e, const V& v) { own[e] = v; });
  }
  coll_exit(a.pad);
}

template <typename V>
struct RsArgs {
  const V* x;     // my shard, w chunks of cn items
  V* out;         // my chunk of the sum, cn items
  V* comm;        // my comm slots (credits × cn), written by the left
  V* right_comm;  // the right neighbour's comm slots
  V* send;        // my local send buffer, cn items (credits = 1)
  int* pad;
  int* left_pad;
  int* right_pad;
  int epoch, w, my, credits;
  long long cn;
};

// T: the element type of the fold; V: what a thread moves at a time (T,
// or a uint4 of 16 / sizeof(T) elements).
template <typename T, typename V, int kU>
__global__ void __launch_bounds__(kThreads)
    ring_reduce_scatter_kernel(RsArgs<V> a) {
  __shared__ int epoch_slot;
  a.epoch = launch_epoch(a.pad, &epoch_slot);
  const int ctas = static_cast<int>(gridDim.x);
  const long long cn = a.cn;
  const int w = a.w, credits = a.credits;
  V* send = a.send;
  if (blockIdx.x == 0 && threadIdx.x == 0)
    pad_signal(a.left_pad + kRsBar, a.epoch);  // the left may write me
  coll_wait(a.pad + kRsBar, a.epoch);          // I may write the right
  for (int s = 0; s < w - 1; ++s) {
    const V* local = a.x + ring_mod(a.my - s - 1, w) * cn;
    V* dst = a.right_comm + (s % credits) * cn;
    // payload s-1's slot is stored into again (so its credit goes left)
    const bool credit = s > 0 && s - 1 <= w - 2 - credits;
    if (s == 0) {  // my own chunk verbatim; no slot to wait for (s < credits)
      coll_sweep<kU, V>(
          cn, [=](long long e) { return local[e]; },
          [=](long long e, const V& v) { dst[e] = v; });
    } else {
      // payload s-1 (the partial of this step's chunk) is in my slot
      coll_wait(a.pad + kRsArr + s - 1, a.epoch);
      const V* slot = a.comm + ((s - 1) % credits) * cn;
      const auto folded = [=](long long e) {
        return fold<T>(load_peer(slot + e), local[e]);
      };
      if (credits == 1) {
        coll_sweep<kU, V>(cn, folded,
                          [=](long long e, const V& v) { send[e] = v; });
        if (coll_arrive_cta(a.pad + kCollFolded + s - 1, ctas) && credit)
          pad_signal(a.left_pad + kRsCred + s - 1, a.epoch);
        coll_wait(a.pad + kRsCred + s - 1, a.epoch);  // the right's slot
        coll_sweep<kU, V>(
            cn, [=](long long e) { return send[e]; },
            [=](long long e, const V& v) { dst[e] = v; });
      } else {
        if (s >= 2)  // the right consumed payload s-2 (slot s % 2)
          coll_wait(a.pad + kRsCred + s - 2, a.epoch);
        coll_sweep<kU, V>(cn, folded,
                          [=](long long e, const V& v) { dst[e] = v; });
      }
    }
    if (coll_arrive_cta(a.pad + kCollSent + s, ctas)) {
      pad_signal(a.right_pad + kRsArr + s, a.epoch);
      if (credits == 2 && credit)  // the one pass also read my slot
        pad_signal(a.left_pad + kRsCred + s - 1, a.epoch);
    }
  }
  coll_wait(a.pad + kRsArr + w - 2, a.epoch);
  const V* slot = a.comm + ((w - 2) % credits) * cn;
  const V* local = a.x + static_cast<long long>(a.my) * cn;
  V* out = a.out;
  coll_sweep<kU, V>(
      cn, [=](long long e) { return fold<T>(load_peer(slot + e), local[e]); },
      [=](long long e, const V& v) { out[e] = v; });
  coll_exit(a.pad);
}

// Launch `kernel` with `args` on the resident grid for `items` items (kU
// a thread). `resident` caches the kernel's resident count.
template <int kU, typename K, typename... A>
int launch_resident(K kernel, int* resident, long long items, int max_ctas,
                    cudaStream_t s, A... args) {
  const cudaError_t rc = coll_resident_ctas(
      reinterpret_cast<const void*>(kernel), kThreads, resident);
  if (rc != cudaSuccess) return rc;
  const int ctas = coll_grid(*resident, items,
                             static_cast<long long>(kThreads) * kU, max_ctas);
  kernel<<<ctas, kThreads, 0, s>>>(args...);
  return cudaGetLastError();
}

template <typename V, int kU>
int launch_copy(const void* x, void* out, long long n, cudaStream_t s) {
  static int resident = 0;
  return launch_resident<kU>(coll_copy_kernel<V, kU>, &resident, n, 0, s,
                             static_cast<const V*>(x), static_cast<V*>(out),
                             n);
}

// n, in items of V (elements, or 16-byte vectors on the vec16 route)
template <typename V, int kU>
int launch_allgather(const void* x, void* out, void* buf, void* right_buf,
                     int* pad, int* left_pad, int* right_pad, int w,
                     int my, long long n, int seed_all, int max_ctas,
                     cudaStream_t s) {
  if (w == 1) return launch_copy<V, kU>(x, out, n, s);
  AgArgs<V> a{static_cast<const V*>(x), static_cast<V*>(out),
              static_cast<V*>(buf), static_cast<V*>(right_buf), pad,
              left_pad, right_pad, 0, w, my, seed_all, n};
  static int resident = 0;
  return launch_resident<kU>(ring_allgather_kernel<V, kU>, &resident, n,
                             max_ctas, s, a);
}

// cn, in items of V
template <typename T, typename V, int kU>
int launch_reduce_scatter(const void* x, void* out, void* comm,
                          void* right_comm, void* send, int* pad,
                          int* left_pad, int* right_pad, int w, int my,
                          long long cn, int credits, int max_ctas,
                          cudaStream_t s) {
  if (w == 1) return launch_copy<V, kU>(x, out, cn, s);
  RsArgs<V> a{static_cast<const V*>(x), static_cast<V*>(out),
              static_cast<V*>(comm), static_cast<V*>(right_comm),
              static_cast<V*>(send), pad, left_pad, right_pad, 0, w, my,
              credits, cn};
  static int resident = 0;
  return launch_resident<kU>(ring_reduce_scatter_kernel<T, V, kU>, &resident,
                             cn, max_ctas, s, a);
}

}  // namespace
}  // namespace tpumt

// Plain C entry points (bound with ctypes). Each returns a cudaError_t: 0
// when the launch was accepted. The pads are int32 words (comm/peer.py),
// my pad's launch counter giving each launch its epoch (every launch at
// w > 1; the copy of w = 1 touches no pad); `w` is the ring's
// size (world, or k on the self-ring, where every pointer is the rank's
// own and `my` is 0); `route` is the CollRoute code that hand.coll_route
// names for these pointers and this length (a launch never takes another
// route than the caller counted: any other value is refused); `max_ctas`
// caps the grid (0: the card's resident count for the kernel), so that
// several instances of a kernel can be resident on one card at once.

// All-gather of `n` elements of `itemsize` bytes per rank: `out` holds
// w·n, `buf` is my receive buffer (w·n; `out` itself at world = 1 and on
// the self-ring), `right_buf` the right neighbour's; `seed_all` (the
// self-ring) seeds every region of `out` with `x`.
extern "C" int tpumt_ring_allgather(const void* x, void* out, void* buf,
                                    void* right_buf, void* pad,
                                    void* left_pad, void* right_pad,
                                    int itemsize, int w, int my,
                                    long long n, int seed_all, int route,
                                    int max_ctas, void* stream) {
  using namespace tpumt;
  if (n < 1 || w < 1 || w > kCollMaxWorld || my < 0 || my >= w ||
      max_ctas < 0 || (seed_all && (my != 0 || w < 2)) ||
      n > LLONG_MAX / w / 8 ||
      (itemsize != 2 && itemsize != 4 && itemsize != 8) ||
      route != coll_route(n * itemsize, {x, out, buf, right_buf}))
    return cudaErrorInvalidValue;
  int* p = static_cast<int*>(pad);
  int* lp = static_cast<int*>(left_pad);
  int* rp = static_cast<int*>(right_pad);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kRouteVec16)
    return launch_allgather<uint4, kUnroll>(x, out, buf, right_buf, p, lp,
                                            rp, w, my,
                                            n * itemsize / 16, seed_all,
                                            max_ctas, s);
  switch (itemsize) {
    case 2:
      return launch_allgather<Bits<2>::U, 1>(x, out, buf, right_buf, p, lp,
                                             rp, w, my, n, seed_all,
                                             max_ctas, s);
    case 4:
      return launch_allgather<Bits<4>::U, 1>(x, out, buf, right_buf, p, lp,
                                             rp, w, my, n, seed_all,
                                             max_ctas, s);
    default:
      return launch_allgather<Bits<8>::U, 1>(x, out, buf, right_buf, p, lp,
                                             rp, w, my, n, seed_all,
                                             max_ctas, s);
  }
}

namespace tpumt {
namespace {

template <typename T>
int reduce_scatter_route(const void* x, void* out, void* comm,
                         void* right_comm, void* send, int* pad,
                         int* left_pad, int* right_pad, int w, int my,
                         long long cn, int credits, int route,
                         int max_ctas, cudaStream_t s) {
  if (route == kRouteVec16)
    return launch_reduce_scatter<T, uint4, kUnroll>(
        x, out, comm, right_comm, send, pad, left_pad, right_pad, w, my,
        cn * static_cast<long long>(sizeof(T)) / 16, credits, max_ctas,
        s);
  return launch_reduce_scatter<T, T, 1>(x, out, comm, right_comm, send, pad,
                                        left_pad, right_pad, w, my, cn,
                                        credits, max_ctas, s);
}

}  // namespace
}  // namespace tpumt

// Reduce-scatter of my shard `x` (w chunks of `cn` elements, dtype code
// of stencil_common.cuh) into `out` (cn): `comm` is my `credits` comm
// slots of cn elements (written by the left), `right_comm` the right
// neighbour's, `send` cn elements of local scratch (read and written at
// credits = 1 only).
extern "C" int tpumt_ring_reduce_scatter(const void* x, void* out,
                                         void* comm, void* right_comm,
                                         void* send, void* pad,
                                         void* left_pad, void* right_pad,
                                         int dtype, int w, int my,
                                         long long cn, int credits,
                                         int route, int max_ctas,
                                         void* stream) {
  using namespace tpumt;
  const int itemsize = dtype == kF64 ? 8 : dtype == kBF16 ? 2 : 4;
  if (cn < 1 || w < 1 || w > kCollMaxWorld || my < 0 || my >= w ||
      max_ctas < 0 || (credits != 1 && credits != 2) ||
      cn > LLONG_MAX / w / 8 ||
      route != coll_route(cn * itemsize, {x, out, comm, right_comm, send}))
    return cudaErrorInvalidValue;
  int* p = static_cast<int*>(pad);
  int* lp = static_cast<int*>(left_pad);
  int* rp = static_cast<int*>(right_pad);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return reduce_scatter_route<float>(x, out, comm, right_comm, send, p,
                                         lp, rp, w, my, cn, credits,
                                         route, max_ctas, s);
    case kF64:
      return reduce_scatter_route<double>(x, out, comm, right_comm, send, p,
                                          lp, rp, w, my, cn, credits,
                                          route, max_ctas, s);
    case kBF16:
      return reduce_scatter_route<__nv_bfloat16>(
          x, out, comm, right_comm, send, p, lp, rp, w, my, cn,
          credits, route, max_ctas, s);
    default:
      return cudaErrorInvalidValue;
  }
}
