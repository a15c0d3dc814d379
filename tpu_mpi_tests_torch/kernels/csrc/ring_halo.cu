// Ring halo exchange by peer stores: both n_bnd-wide interior edge bands
// of my array go straight into the ring neighbours' ghost bands.
//
// Replaces the Pallas kernel ring_halo_pallas
// (tpu_mpi_tests/kernels/pallas_kernels.py:1804, body _ring_edge_kernel
// :1697): hi edge -> the right neighbour's lo ghost, lo edge -> the left
// neighbour's hi ghost, behind an entry barrier, physical ghosts kept on a
// non-periodic ring's ends (the send predicates of :1775-1801: a rank
// sends to, and receives from, a side unless it is the ring's end on that
// side and the ring is not periodic). Along either axis of a contiguous
// 2-D array, any element size (2, 4, 8 bytes); a 1-D shard is an (n, 1)
// column.
//
// Design. The Pallas kernel moves pre-sliced edge operands because Mosaic
// DMA must be tile-aligned; a CUDA thread can store to any address of a
// peer's buffer, strided or not, so there is no pack and no unpack. The
// neighbours' buffers are mapped by the peer layer (comm/peer.py:
// symmetric memory at world > 1, my own buffer on the self-ring at
// world = 1). The schedule, CTAs ordered by a work ticket:
//   1. entry barrier (ticket 0 signals, every CTA waits): a neighbour's
//      buffer is written only after it entered this launch, i.e. after its
//      previous launch on the buffer finished — the receiver back-pressure
//      of :1734-1746;
//   2. each CTA stores its share of both bands into the peers;
//   3. __threadfence_system() releases the stores;
//   4. the last CTA to finish signals an arrival on each receiver;
//   5. that CTA waits for my own two arrivals, so when the launch ends my
//      ghost bands hold the neighbours' edges.
// Extents under 3*n_bnd: an edge overlaps the ghost band the other edge
// lands in, so one CTA reads both edges into a staging buffer before it
// signals the barrier (no neighbour writes my ghosts before I have read
// my edges) and stores from there.
//
// Bound on the H100: bytes. 2*n_bnd*extent*itemsize read and as many
// stored to the peers (NVLink at world > 1: 450 GB/s each way); a few µs of
// barrier latency on top at the sizes the stencil uses.
#include <climits>
#include <cstdint>

#include "ring_common.cuh"

namespace tpumt {
namespace {

constexpr int kThreads = 256;
constexpr long long kMaxCtas = 132LL * 4;  // co-resident on every SM

template <typename W>
__global__ void __launch_bounds__(kThreads)
    ring_halo_kernel(RingView<W> r, W* stage) {
  __shared__ int ticket_slot;
  const int ticket = take_ticket(r.pad, &ticket_slot);
  const int ctas = static_cast<int>(gridDim.x);
  if (stage) {  // one CTA: read both edges before anyone may write mine
    ring_stage(r, stage);
    __syncthreads();
  }
  if (threadIdx.x == 0) ring_enter(r, ticket == 0);
  __syncthreads();
  ring_store(r, stage, ticket, ctas);
  if (ring_arrive(r, ctas)) {
    if (r.send_lo) pad_wait(r.pad + kArrFromLeft, r.epoch);
    if (r.send_hi) pad_wait(r.pad + kArrFromRight, r.epoch);
  }
}

template <typename W>
int launch(void* z, void* left_z, void* right_z, int* pad, int* left_pad,
           int* right_pad, int epoch, int axis, long long n0, long long n1,
           long long b, int send_lo, int send_hi, void* stage,
           cudaStream_t s) {
  RingView<W> r{static_cast<const W*>(z), static_cast<W*>(left_z),
                static_cast<W*>(right_z), pad, left_pad, right_pad, epoch,
                axis, n0, n1, b, send_lo, send_hi};
  const long long band = b * (axis == 0 ? n1 : n0);
  long long ctas = (2 * band + kThreads * 4 - 1) / (kThreads * 4);
  if (ctas > kMaxCtas) ctas = kMaxCtas;
  if (ctas < 1 || stage) ctas = 1;
  ring_halo_kernel<W><<<static_cast<unsigned>(ctas), kThreads, 0, s>>>(
      r, static_cast<W*>(stage));
  return cudaGetLastError();
}

}  // namespace
}  // namespace tpumt

// Plain C entry point (bound with ctypes). Returns a cudaError_t: 0 when
// the launch was accepted. `z` is my contiguous (n0, n1) array of
// `itemsize`-byte elements; `left_z` / `right_z` the neighbours' copies of
// it (z itself on the self-ring); the pads are int32 words (comm/peer.py);
// `epoch` counts this process's RDMA launches from 1; `stage` is NULL, or
// 2*b*extent elements of scratch when the extent along `axis` is under
// 3*b. The extent must hold both bands (>= 2*b).
extern "C" int tpumt_ring_halo(void* z, void* left_z, void* right_z,
                               void* pad, void* left_pad, void* right_pad,
                               int epoch, int itemsize, int axis, long long n0,
                               long long n1, long long b, int send_lo,
                               int send_hi, void* stage, void* stream) {
  using namespace tpumt;
  const long long n = axis == 0 ? n0 : n1;
  if ((axis != 0 && axis != 1) || n0 < 1 || n1 < 1 || b < 1 || n < 2 * b ||
      epoch < 1)
    return cudaErrorInvalidValue;
  if (n < 3 * b && stage == nullptr && (send_lo || send_hi))
    return cudaErrorInvalidValue;
  int* p = static_cast<int*>(pad);
  int* lp = static_cast<int*>(left_pad);
  int* rp = static_cast<int*>(right_pad);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  void* st = n < 3 * b ? stage : nullptr;
  switch (itemsize) {
    case 2:
      return launch<uint16_t>(z, left_z, right_z, p, lp, rp, epoch, axis, n0,
                              n1, b, send_lo, send_hi, st, s);
    case 4:
      return launch<uint32_t>(z, left_z, right_z, p, lp, rp, epoch, axis, n0,
                              n1, b, send_lo, send_hi, st, s);
    case 8:
      return launch<uint64_t>(z, left_z, right_z, p, lp, rp, epoch, axis, n0,
                              n1, b, send_lo, send_hi, st, s);
    default:
      return cudaErrorInvalidValue;
  }
}
