// Signalling and edge-band copies shared by the RDMA kernels: the two
// ring halo kernels (ring_halo.cu, fused_rdma.cu), the collective
// kernels (ring_collectives.cu, oneshot.cu) and the fused ring attention
// (fused_ring_attention.cu). The helpers at the end (the routes,
// load_peer, coll_sweep, coll_arrive_cta, ring_arrive_cta, the halo walk)
// and those of occupancy.cuh (coll_resident_ctas, coll_grid) serve
// ring_collectives.cu, oneshot.cu, ring_halo.cu and fused_rdma.cu, whose
// sends take ring_halo's walk (ring_stage / ring_store for extents under
// three bands).
//
// A rank's signal pad (comm/peer.py) holds 128 int32 words. Remote words
// are epoch counters written by other ranks; local words are counters of
// the rank's own CTAs, reset to 0 by the last CTA that touches them
// before the launch ends, so the next launch on the stream finds them at
// 0. The map:
//   0 kBarFromLeft / 1 kBarFromRight  remote, ring halo: the left / right
//                                  neighbour entered launch `epoch` (it
//                                  may now be written)
//   2 kArrFromLeft / 3 kArrFromRight  remote, ring halo: the left / right
//                                  neighbour's edge band of launch
//                                  `epoch` landed in my ghosts
//   4 kTicket                      local: work tickets of this launch's CTAs
//   5 kDone                        local: send CTAs that finished storing
//   6 kCollExit                    local, collectives: CTAs that finished
//   7 kAgBar                       remote, all-gather: the right neighbour
//                                  entered launch `epoch`
//   8 kRsBar                       remote, reduce-scatter: the same
//   9 + s  kCollSent[s]            local, collectives: CTAs that finished
//                                  their stores of step s
//   16 + s kCollFolded[s]          local, reduce-scatter: CTAs that
//                                  finished reading the arrival of step s
//   23 + s kAgArr[s]               remote, all-gather: the left
//                                  neighbour's step-s region landed
//   30 + s kRsArr[s]               remote, reduce-scatter: the left
//                                  neighbour's step-s payload landed
//   37 + s kRsCred[s]              remote, reduce-scatter: the right
//                                  neighbour consumed my step-s payload
//                                  (its comm slot is free again)
//   44 + p kOsBar[p]               remote, one-shot: rank p entered
//                                  launch `epoch`
//   52 + p kOsArr[p]               remote, one-shot: rank p's shard
//                                  landed in my slot p
//   60-61 kLaunches                local: the pad's launch counter, one
//                                  64-bit word (launch_epoch)
//   62-63                          unused
//   64 kFraBarFromLeft / 65 kFraBarFromRight  remote, fused ring
//                                  attention: the left / right neighbour
//                                  entered launch `epoch`
//   66 + s kFraArr[s]              remote: the left neighbour's step-(s-1)
//                                  K/V block landed in my slot s % 2
//   74 + s kFraCred[s]             remote: the right neighbour retired the
//                                  block it received for its step s (its
//                                  slot s % 2 is free again)
//   82 + s kFraSent[s]             local: CTAs that finished their share
//                                  of step s's send
//   90 + s kFraRetired[s]          local: CTAs that finished folding (and
//                                  forwarding) step s's block
//   98 kFraExit                    local: CTAs that finished the launch
//   99-127                         unused
// with s < kCollMaxSteps (kFraArr, kFraCred, kFraSent, kFraRetired: s <
// kCollMaxWorld) and p < kCollMaxWorld: the collectives and the fused
// ring attention run on at most 8 ranks (or an 8-step self-ring), which
// is what the pad holds.
// Epochs count every RDMA launch on a pad up from 1 (all kernel families
// share the count), so a wait for `word >= epoch` is met by this launch's
// signal or a later one, never by an earlier one, and no remote word is
// ever reset. Every rank makes the same sequence of launches, so the
// ranks' epochs stay equal. The count lives on the card, in the pad's
// launch counter (launch_epoch): each CTA reads its launch's epoch there
// at entry, so a launch captured into a CUDA graph takes a new epoch at
// every replay, as an eager launch does. Per-step words keep a step's
// wait from being met by a later step's signal.
//
// Memory order: a signal is a st.release.sys after the sender's peer
// stores were ordered, by __threadfence_system() in every thread
// (coll_arrive) or by one acquire-release count a CTA (coll_arrive_cta,
// ring_arrive_cta); a wait is a ld.acquire.sys loop; the two ring halo
// kernels' one-card self-ring does all of this at gpu scope (no other
// card takes part). Data that peers write during a launch is read
// with ld.global.cg (L2, never a stale L1 line). A wait gives up after
// kWaitTimeoutNs and traps, so a lost peer makes the launch fail (the next
// synchronise raises) instead of hanging the card. One stream per pad: two
// launches that share a pad must not run at once.
#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <cstring>
#include <initializer_list>

#include "occupancy.cuh"

namespace tpumt {

constexpr int kPadWords = 128;
constexpr int kCollMaxWorld = 8;
constexpr int kCollMaxSteps = kCollMaxWorld - 1;

enum PadWord : int {
  kBarFromLeft = 0,
  kBarFromRight = 1,
  kArrFromLeft = 2,
  kArrFromRight = 3,
  kTicket = 4,
  kDone = 5,
  kCollExit = 6,
  kAgBar = 7,
  kRsBar = 8,
  kCollSent = 9,
  kCollFolded = kCollSent + kCollMaxSteps,
  kAgArr = kCollFolded + kCollMaxSteps,
  kRsArr = kAgArr + kCollMaxSteps,
  kRsCred = kRsArr + kCollMaxSteps,
  kOsBar = kRsCred + kCollMaxSteps,
  kOsArr = kOsBar + kCollMaxWorld,
  kCollWordsEnd = kOsArr + kCollMaxWorld,
  kLaunches = kCollWordsEnd,  // two words: one 64-bit counter
  kFraBarFromLeft = 64,
  kFraBarFromRight = kFraBarFromLeft + 1,
  kFraArr = kFraBarFromRight + 1,
  kFraCred = kFraArr + kCollMaxWorld,
  kFraSent = kFraCred + kCollMaxWorld,
  kFraRetired = kFraSent + kCollMaxWorld,
  kFraExit = kFraRetired + kCollMaxWorld,
  kPadWordsUsed = kFraExit + 1,
};
static_assert(kCollFolded == 16 && kAgArr == 23 && kOsBar == 44 &&
                  kCollWordsEnd == 60 && kLaunches % 2 == 0 &&
                  kLaunches + 2 <= kFraBarFromLeft,
              "the pad map above");
static_assert(kFraArr == 66 && kFraCred == 74 && kFraSent == 82 &&
                  kFraRetired == 90 && kFraExit == 98,
              "the pad map above");
static_assert(kPadWordsUsed <= kPadWords, "the pad holds 128 words");

constexpr unsigned long long kWaitTimeoutNs = 20ull * 1000 * 1000 * 1000;

// kSys: at system scope, what a peer card's pad and buffers need; false:
// at gpu scope, enough where every pad and buffer of the launch is this
// card's own (a one-card self-ring), and cheaper — a system-scope release
// waits until the card's stores are visible to every other card too.
template <bool kSys = true>
__device__ __forceinline__ void pad_signal(int* word, int epoch) {
  if constexpr (kSys)
    asm volatile("st.release.sys.global.s32 [%0], %1;" ::"l"(word),
                 "r"(epoch)
                 : "memory");
  else
    asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(word),
                 "r"(epoch)
                 : "memory");
}

template <bool kSys = true>
__device__ __forceinline__ int pad_load(const int* word) {
  int v;
  if constexpr (kSys)
    asm volatile("ld.acquire.sys.global.s32 %0, [%1];"
                 : "=r"(v)
                 : "l"(word)
                 : "memory");
  else
    asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
                 : "=r"(v)
                 : "l"(word)
                 : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Spin until *word >= epoch (one thread).
template <bool kSys = true>
__device__ __forceinline__ void pad_wait(const int* word, int epoch) {
  if (pad_load<kSys>(word) - epoch >= 0) return;
  const unsigned long long t0 = global_ns();
  while (pad_load<kSys>(word) - epoch < 0) {
    __nanosleep(64);
    if (global_ns() - t0 > kWaitTimeoutNs) __trap();
  }
}

// Offset in a contiguous (n0, n1) array of element e of a band `b` wide
// along `axis` whose first index along the axis is `start`.
__device__ __forceinline__ long long band_offset(long long e, int axis,
                                                 long long n1, long long b,
                                                 long long start) {
  if (axis == 0) return start * n1 + e;  // b whole rows, contiguous
  return (e / b) * n1 + start + e % b;
}

// The ring's view of one launch: my array, my neighbours' copies of it,
// the three pads and what this rank sends.
template <typename W>
struct RingView {
  const W* z;     // my array (edges read here)
  W* left_z;      // the left neighbour's copy (its hi ghost written)
  W* right_z;     // the right neighbour's copy (its lo ghost written)
  int* pad;       // mine
  int* left_pad;  // the left neighbour's
  int* right_pad;
  int epoch;
  int axis;
  long long n0, n1, b;
  int send_lo;  // my lo edge -> the left neighbour's hi ghost
  int send_hi;  // my hi edge -> the right neighbour's lo ghost
};

template <typename W>
__device__ __forceinline__ long long ring_extent(const RingView<W>& r) {
  return r.axis == 0 ? r.n0 : r.n1;
}

template <typename W>
__device__ __forceinline__ long long ring_band(const RingView<W>& r) {
  return r.b * (r.axis == 0 ? r.n1 : r.n0);  // elements per band
}

// The entry barrier, one thread: tell the neighbours I send to that I have
// entered this launch (so my buffer may be written), then wait until they
// have entered theirs (so theirs may be written: their previous launch on
// the buffer, which wrote or read it, has finished). A rank receives from
// a side exactly when it sends to it, so the signal and wait predicates
// are the send predicates (pallas_kernels.py:1775-1801).
template <bool kSys = true, typename W>
__device__ __forceinline__ void ring_enter(const RingView<W>& r, bool signal) {
  if (signal) {
    if (r.send_lo) pad_signal<kSys>(r.left_pad + kBarFromRight, r.epoch);
    if (r.send_hi) pad_signal<kSys>(r.right_pad + kBarFromLeft, r.epoch);
  }
  if (r.send_lo) pad_wait<kSys>(r.pad + kBarFromLeft, r.epoch);
  if (r.send_hi) pad_wait<kSys>(r.pad + kBarFromRight, r.epoch);
}

// Copy this CTA's share (work index `part` of `parts`) of both edge bands
// into the neighbours' ghost bands: hi edge -> right's lo ghost, lo edge
// -> left's hi ghost. `stage` (or nullptr) holds both edges, lo then hi,
// read before the barrier (extents under 3b, where an edge overlaps the
// ghost band a neighbour writes).
template <typename W>
__device__ __forceinline__ void ring_store(const RingView<W>& r,
                                          const W* stage, long long part,
                                          long long parts) {
  const long long n = ring_extent(r), band = ring_band(r), b = r.b;
  const long long stride = parts * blockDim.x * blockDim.y;
  const long long tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (long long k = part * blockDim.x * blockDim.y + tid; k < 2 * band;
       k += stride) {
    const bool hi = k >= band;
    if (hi ? !r.send_hi : !r.send_lo) continue;
    const long long e = hi ? k - band : k;
    const W v = stage ? stage[k]
                      : r.z[band_offset(e, r.axis, r.n1, b,
                                        hi ? n - 2 * b : b)];
    W* dst = hi ? r.right_z : r.left_z;
    dst[band_offset(e, r.axis, r.n1, b, hi ? 0 : n - b)] = v;
  }
}

// Both edges into `stage` (lo then hi), by the threads of one CTA.
template <typename W>
__device__ __forceinline__ void ring_stage(const RingView<W>& r, W* stage) {
  const long long n = ring_extent(r), band = ring_band(r), b = r.b;
  const long long tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (long long k = tid; k < 2 * band; k += blockDim.x * blockDim.y) {
    const bool hi = k >= band;
    const long long e = hi ? k - band : k;
    stage[k] = r.z[band_offset(e, r.axis, r.n1, b, hi ? n - 2 * b : b)];
  }
}

// The epoch of this launch, by every thread of the CTA (thread 0 reads,
// `slot` in shared memory passes it on, a __syncthreads ends it). The
// pad's launch counter (kLaunches) is one 64-bit word: its low half
// counts the CTAs of the running launch that entered, its high half the
// launches before it. Each CTA adds 1 at entry; the CTA that enters last
// turns the count into the next launch's in one more add (low half back
// to 0, high half + 1). So every CTA of a launch reads one epoch, the
// launches before it + 1. The next launch on the stream enters only
// after this one has left, whatever its grid: an eager launch and a
// replay of a captured one advance the same count. Epochs are positive
// ints: a launch after the pad's 2^31 - 1st traps (the signal words
// hold int32 epochs, and a wrapped one would meet every wait at once).
__device__ __forceinline__ int launch_epoch(int* pad, int* slot) {
  if (threadIdx.x == 0 && threadIdx.y == 0 && threadIdx.z == 0) {
    auto* word = reinterpret_cast<unsigned long long*>(pad + kLaunches);
    const unsigned long long ctas =
        static_cast<unsigned long long>(gridDim.x) * gridDim.y * gridDim.z;
    const unsigned long long old = atomicAdd(word, 1ull);
    if ((old >> 32) >= static_cast<unsigned long long>(INT_MAX)) __trap();
    if ((old & 0xffffffffull) == ctas - 1)
      atomicAdd(word, (1ull << 32) - ctas);
    *slot = static_cast<int>(old >> 32) + 1;
  }
  __syncthreads();
  return *slot;
}

// This CTA's work ticket (the order CTAs started in); the last ticket
// resets the counter.
__device__ __forceinline__ int take_ticket(int* pad, int* slot) {
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    const int t = atomicAdd(pad + kTicket, 1);
    if (t == static_cast<int>(gridDim.x) - 1) atomicExch(pad + kTicket, 0);
    *slot = t;
  }
  __syncthreads();
  return *slot;
}


// ---------------------------------------------------------------------------
// the collective kernels' helpers (ring_collectives.cu, oneshot.cu)
// ---------------------------------------------------------------------------

template <int Bytes>
struct Bits;
template <>
struct Bits<2> {
  using U = unsigned short;
};
template <>
struct Bits<4> {
  using U = unsigned int;
};
template <>
struct Bits<8> {
  using U = unsigned long long;
};

// A load of data a peer wrote during this launch: through L2 (.cg), so no
// L1 line read earlier in the launch can answer it.
template <typename T>
__device__ __forceinline__ T load_cg(const T* p) {
  using U = typename Bits<sizeof(T)>::U;
  const U u = __ldcg(reinterpret_cast<const U*>(p));
  T v;
  memcpy(&v, &u, sizeof(T));
  return v;
}

// Thread 0 waits until *word >= epoch; then the whole CTA goes on.
__device__ __forceinline__ void coll_wait(const int* word, int epoch) {
  if (threadIdx.x == 0) pad_wait(word, epoch);
  __syncthreads();
}

// After a CTA's part of a step: order its stores (or its reads of an
// arrival) system-wide, count the CTA in `counter` (a local word), and
// let the last of `ctas` CTAs signal `remote` with the epoch.
__device__ __forceinline__ void coll_arrive(int* counter, int ctas,
                                            int* remote, int epoch) {
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0 && atomicAdd(counter, 1) == ctas - 1) {
    __threadfence_system();
    pad_signal(remote, epoch);
  }
}

// The end of a collective launch: the last CTA to finish resets the local
// words (kCollExit, kCollSent[], kCollFolded[]) for the next launch.
__device__ __forceinline__ void coll_exit(int* pad) {
  __syncthreads();
  if (threadIdx.x != 0) return;
  if (atomicAdd(pad + kCollExit, 1) != static_cast<int>(gridDim.x) - 1)
    return;
  for (int s = 0; s < kCollMaxSteps; ++s) {
    atomicExch(pad + kCollSent + s, 0);
    atomicExch(pad + kCollFolded + s, 0);
  }
  atomicExch(pad + kCollExit, 0);
}

// ---------------------------------------------------------------------------
// the 16-byte helpers (ring_collectives.cu, oneshot.cu, ring_halo.cu)
// ---------------------------------------------------------------------------

// The routes' codes (hand.COLL_ROUTES indices): "vec16" moves 16-byte
// vectors, "scalar" one element at a time. A launcher recomputes its
// kernel's rule and refuses any other code, so a count never lies.
enum CollRoute : int { kRouteScalar = 0, kRouteVec16 = 1 };

inline bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

// The collectives' rule (hand.coll_route): vec16 when every pointer
// starts on 16 bytes and a region (chunk, shard) of `bytes` is whole
// vectors.
inline int coll_route(long long bytes,
                      std::initializer_list<const void*> ptrs) {
  if (bytes % 16) return kRouteScalar;
  for (const void* p : ptrs)
    if (!aligned16(p)) return kRouteScalar;
  return kRouteVec16;
}

// A load of data a peer wrote during this launch, through L2 (.cg), of
// any width the collectives move: 2, 4 and 8 bytes through load_cg, 16
// as one uint4.
template <typename V>
__device__ __forceinline__ V load_peer(const V* p) {
  if constexpr (sizeof(V) == 16) {
    const uint4 u = __ldcg(reinterpret_cast<const uint4*>(p));
    V v;
    memcpy(&v, &u, sizeof(V));
    return v;
  } else {
    return load_cg(p);
  }
}

// Every item of [0, n) once, by the whole grid: item e belongs to thread
// e mod (gridDim.x · blockDim.x), as in a plain grid-stride loop, so a
// thread owns the same items at every step of a launch. Each thread
// issues kU independent loads (`load(e)`) before it stores them
// (`store(e, v)`), to keep kU loads of every thread in flight.
template <int kU, typename V, typename Load, typename Store>
__device__ __forceinline__ void coll_sweep(long long n, Load load,
                                           Store store) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e0 = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
       e0 < n; e0 += stride * kU) {
    V v[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (e0 + u * stride < n) v[u] = load(e0 + u * stride);
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (e0 + u * stride < n) store(e0 + u * stride, v[u]);
  }
}

// After a CTA's part of a step, with one ordering operation a CTA (the
// grid-sync pattern of cooperative groups): the barrier orders every
// thread's stores and reads of the step before thread 0's count, an add
// to `counter` (a local word) with acquire-release semantics at system
// scope. Its release is cumulative, so it covers the whole CTA's work;
// its acquire, in the last of `ctas` CTAs, takes in every CTA counted
// before, so the signals that CTA sends next (st.release.sys) order the
// whole grid's work of the step. True in thread 0 of that last CTA.
// (At gpu scope, !kSys, for a launch that involves no other card.)
template <bool kSys = true>
__device__ __forceinline__ bool coll_arrive_cta(int* counter, int ctas) {
  __syncthreads();
  if (threadIdx.x != 0 || threadIdx.y != 0) return false;
  if constexpr (!kSys) {
    int old;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
                 : "=r"(old) : "l"(counter) : "memory");
    return old == ctas - 1;
  }
  int old;
  asm volatile("atom.acq_rel.sys.global.add.s32 %0, [%1], 1;"
               : "=r"(old) : "l"(counter) : "memory");
  return old == ctas - 1;
}

// The two ring halo kernels' arrival, with one ordering operation a CTA
// (coll_arrive_cta's pattern on kDone), after each CTA's share of the
// bands: the last of `senders` CTAs resets the count for the next launch
// and signals the arrivals to the neighbours it sent to. True in that
// last CTA's thread 0.
template <bool kSys = true, typename W>
__device__ __forceinline__ bool ring_arrive_cta(const RingView<W>& r,
                                                int senders) {
  if (!coll_arrive_cta<kSys>(r.pad + kDone, senders)) return false;
  atomicExch(r.pad + kDone, 0);
  if (r.send_hi) pad_signal<kSys>(r.right_pad + kArrFromLeft, r.epoch);
  if (r.send_lo) pad_signal<kSys>(r.left_pad + kArrFromRight, r.epoch);
  return true;
}

// ---------------------------------------------------------------------------
// the halo walk (ring_halo.cu, and fused_rdma.cu's send CTAs)
// ---------------------------------------------------------------------------

// Both bands as `rows` runs of `vb` items of V each, `pitch` items apart
// (axis 0: one run of the band's whole rows; axis 1: a row's share of the
// band), with each band's first item in my array (src) and in the
// neighbour's (dst).
struct HaloWalk {
  long long rows, vb, pitch;
  long long lo_src, lo_dst, hi_src, hi_dst;
};

// The walk of an (n0, n1) array's bands `b` wide along `axis`, in items
// of `v` elements (1, or 16 / itemsize on the vec16 route).
inline HaloWalk walk_of(int axis, long long n0, long long n1, long long b,
                        long long v) {
  if (axis == 0) {
    const long long row = n1 / v;
    return {1, b * row, 0, b * row, (n0 - b) * row, (n0 - 2 * b) * row, 0};
  }
  const long long pitch = n1 / v, vb = b / v;
  return {n0, vb, pitch, vb, pitch - vb, pitch - 2 * vb, 0};
}

// The ring halo's route rule (hand.halo_route): vec16 when my buffer and
// both neighbours' start on 16 bytes, the row pitch is whole vectors and,
// on axis 1, so is a row's band; never for an extent under 3·b (staged).
inline int halo_route(int itemsize, int axis, long long n0, long long n1,
                      long long b, const void* z, const void* left_z,
                      const void* right_z) {
  if ((axis == 0 ? n0 : n1) < 3 * b || n1 * itemsize % 16)
    return kRouteScalar;
  return coll_route(axis == 0 ? n1 * itemsize : b * itemsize,
                    {z, left_z, right_z});
}

// This CTA's share (work index `part` of `parts`) of the walk: item e =
// row·vb + j of both bands, e = first + i·stride as in a grid-stride loop
// over parts × the CTA's threads. (row, j) is divided out once and stepped
// on after that; kU items are loaded before any is stored.
template <int kU, typename V>
__device__ __forceinline__ void halo_walk(const RingView<V>& r,
                                          const HaloWalk& h, long long part,
                                          long long parts) {
  const bool lo = r.send_lo, hi = r.send_hi;
  if (!lo && !hi) return;
  const long long threads = blockDim.x * blockDim.y;
  const long long stride = parts * threads;
  const long long first =
      part * threads + threadIdx.y * blockDim.x + threadIdx.x;
  const long long drow = stride / h.vb, dj = stride % h.vb;
  long long row = first / h.vb, j = first % h.vb;
  while (row < h.rows) {
    long long at[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      at[u] = row < h.rows ? row * h.pitch + j : -1;
      row += drow;
      j += dj;
      if (j >= h.vb) {
        j -= h.vb;
        ++row;
      }
    }
    V vlo[kU], vhi[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (at[u] < 0) continue;
      if (lo) vlo[u] = r.z[h.lo_src + at[u]];
      if (hi) vhi[u] = r.z[h.hi_src + at[u]];
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (at[u] < 0) continue;
      if (lo) r.left_z[h.lo_dst + at[u]] = vlo[u];
      if (hi) r.right_z[h.hi_dst + at[u]] = vhi[u];
    }
  }
}

}  // namespace tpumt
