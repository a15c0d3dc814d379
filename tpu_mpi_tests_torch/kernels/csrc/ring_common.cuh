// Signalling and edge-band copies shared by the two RDMA ring kernels
// (ring_halo.cu, fused_rdma.cu).
//
// A rank's signal pad (comm/peer.py) holds int32 words; neighbours write
// words 0-3 (epoch counters), the rank's own CTAs words 4-5:
//   kBarFromLeft / kBarFromRight   the left / right neighbour entered
//                                  launch `epoch` (it may now be written)
//   kArrFromLeft / kArrFromRight   the left / right neighbour's edge band
//                                  of launch `epoch` landed in my ghosts
//   kTicket                        work tickets of this launch's CTAs
//   kDone                          send CTAs that finished their stores
// Epochs count every RDMA launch up from 1 on every rank, so a wait for
// `word >= epoch` is met by this launch's signal or a later one, never by
// an earlier one, and no counter is ever reset across ranks. kTicket and
// kDone are reset to 0 by the last CTA that touches them, before the
// launch ends, so the next launch on the stream finds them at 0.
//
// Memory order: a signal is a st.release.sys after __threadfence_system()
// has ordered the sender's peer stores; a wait is a ld.acquire.sys loop.
// A wait gives up after kWaitTimeoutNs and traps, so a lost peer makes
// the launch fail (the next synchronise raises) instead of hanging the
// card.
#pragma once

#include <cuda_runtime.h>

namespace tpumt {

enum PadWord : int {
  kBarFromLeft = 0,
  kBarFromRight = 1,
  kArrFromLeft = 2,
  kArrFromRight = 3,
  kTicket = 4,
  kDone = 5,
};

constexpr unsigned long long kWaitTimeoutNs = 20ull * 1000 * 1000 * 1000;

__device__ __forceinline__ void pad_signal(int* word, int epoch) {
  asm volatile("st.release.sys.global.s32 [%0], %1;" ::"l"(word), "r"(epoch)
               : "memory");
}

__device__ __forceinline__ int pad_load(const int* word) {
  int v;
  asm volatile("ld.acquire.sys.global.s32 %0, [%1];"
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
__device__ __forceinline__ void pad_wait(const int* word, int epoch) {
  if (pad_load(word) - epoch >= 0) return;
  const unsigned long long t0 = global_ns();
  while (pad_load(word) - epoch < 0) {
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
template <typename W>
__device__ __forceinline__ void ring_enter(const RingView<W>& r, bool signal) {
  if (signal) {
    if (r.send_lo) pad_signal(r.left_pad + kBarFromRight, r.epoch);
    if (r.send_hi) pad_signal(r.right_pad + kBarFromLeft, r.epoch);
  }
  if (r.send_lo) pad_wait(r.pad + kBarFromLeft, r.epoch);
  if (r.send_hi) pad_wait(r.pad + kBarFromRight, r.epoch);
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

// After a CTA's stores: fence them system-wide, count the CTA done, and let
// the last of `senders` CTAs signal the arrivals to the neighbours. Returns
// true in that last CTA's thread 0.
template <typename W>
__device__ __forceinline__ bool ring_arrive(const RingView<W>& r,
                                            int senders) {
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x != 0 || threadIdx.y != 0) return false;
  if (atomicAdd(r.pad + kDone, 1) != senders - 1) return false;
  atomicExch(r.pad + kDone, 0);
  __threadfence_system();
  if (r.send_hi) pad_signal(r.right_pad + kArrFromLeft, r.epoch);
  if (r.send_lo) pad_signal(r.left_pad + kArrFromRight, r.epoch);
  return true;
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

}  // namespace tpumt
