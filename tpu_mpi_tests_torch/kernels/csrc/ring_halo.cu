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
// The Pallas kernel moves pre-sliced edge operands because Mosaic DMA
// must be tile-aligned; a CUDA thread can store to any address of a
// peer's buffer, strided or not, so there is no pack and no unpack. The
// neighbours' buffers are mapped by the peer layer (comm/peer.py:
// symmetric memory at world > 1, my own buffer on the self-ring at
// world = 1). The schedule, CTAs ordered by a work ticket:
//   1. entry barrier (ticket 0 signals, every CTA waits): a neighbour's
//      buffer is written only after it entered this launch, i.e. after its
//      previous launch on the buffer finished — the receiver back-pressure
//      of :1734-1746;
//   2. each CTA stores its share of both bands into the peers;
//   3. the CTA crosses one barrier and its thread 0 counts it with one
//      acquire-release add (ring_arrive_cta);
//   4. the last CTA counted signals an arrival on each receiver;
//   5. that CTA waits for my own two arrivals, so when the launch ends my
//      ghost bands hold the neighbours' edges.
// Extents under 3*n_bnd: an edge overlaps the ghost band the other edge
// lands in, so one CTA reads both edges into a staging buffer before it
// signals the barrier (no neighbour writes my ghosts before I have read
// my edges) and stores from there.
//
// Bound on the H100. On the self-ring (world = 1, every main path on one
// card) bytes of device memory: both bands read once and written once,
// 4·n_bnd·extent·itemsize over 3.35 TB/s (the axis-1 side in the 32-byte
// sectors it touches). At world > 1 the bands leave over NVLink, 450 GB/s
// each way. At the stencil's band sizes (a few KiB to 16 MiB) the launch,
// the barrier and the arrival — a few µs — weigh as much as the bytes, and
// on axis 1 at 8192 rows (0.3 µs of bytes) they are all the time there
// is.
//
// Design. Two routes, named by the wrapper (hand.halo_route) and checked
// here. "vec16", where my buffer and both neighbours' start on 16 bytes,
// the row pitch is whole 16-byte vectors and (on axis 1) so is a row's
// band: a walk over the bands in uint4s, each thread with kUnroll vector
// pairs (lo and hi edge) in flight, neighbouring threads on neighbouring
// vectors — on axis 0 two flat copies of contiguous runs, on axis 1 rows
// over the grid, a row's vectors on neighbouring threads, (row, vector)
// stepped on without a division. "scalar", any other operand, the same
// walk one element at a time, and the staged case (extent under 3·n_bnd)
// on one CTA. The grid is the occupancy API's resident count for the
// kernel, clipped to the work and to `max_ctas` (> 0: cross-wired
// instances on one card, every instance resident together). One count a
// CTA: no thread fences on its own. Signals, waits and the count are at
// system scope where a neighbour may be another card, and at gpu scope on
// the one-card self-ring (every buffer and pad the rank's own: the main
// paths on one card), where a system-scope release would wait for nothing
// but costs about a microsecond each.
#include <climits>
#include <cstdint>

#include "ring_common.cuh"

namespace tpumt {
namespace {

constexpr int kThreads = 256;
// vector pairs (lo and hi edge) each thread has in flight on the vec16
// route; the scalar route keeps one element pair in flight (kU = 1):
// more only crowds the strided rows' 32-byte sectors
constexpr int kUnroll = 4;

// V: uint4 (vec16) or the element's bits (scalar); `stage` (scalar
// route, one CTA) holds both edges for extents under 3·n_bnd. kSys:
// signals at system scope (neighbours on other cards); false on the
// one-card self-ring, where every pointer is my own.
template <typename V, bool kSys>
__global__ void __launch_bounds__(kThreads)
    ring_halo_kernel(RingView<V> r, HaloWalk h, V* stage) {
  __shared__ int ticket_slot;
  const int ticket = take_ticket(r.pad, &ticket_slot);
  constexpr bool kScalar = sizeof(V) <= 8;
  if constexpr (kScalar) {
    if (stage) {  // read both edges before anyone may write mine
      ring_stage(r, stage);
      __syncthreads();
    }
  }
  if (threadIdx.x == 0) ring_enter<kSys>(r, ticket == 0);
  __syncthreads();
  if constexpr (kScalar) {
    if (stage)
      ring_store(r, stage, 0, 1);
    else
      halo_walk<1>(r, h, blockIdx.x, gridDim.x);
  } else {
    halo_walk<kUnroll>(r, h, blockIdx.x, gridDim.x);
  }
  if (ring_arrive_cta<kSys>(r, static_cast<int>(gridDim.x))) {
    if (r.send_lo) pad_wait<kSys>(r.pad + kArrFromLeft, r.epoch);
    if (r.send_hi) pad_wait<kSys>(r.pad + kArrFromRight, r.epoch);
  }
}

template <typename V, bool kSys>
int launch(void* z, void* left_z, void* right_z, int* pad, int* left_pad,
           int* right_pad, int epoch, int axis, long long n0, long long n1,
           long long b, int send_lo, int send_hi, long long v, void* stage,
           int max_ctas, cudaStream_t s) {
  static int resident = 0;
  const cudaError_t rc = coll_resident_ctas(
      reinterpret_cast<const void*>(ring_halo_kernel<V, kSys>), kThreads,
      &resident);
  if (rc != cudaSuccess) return rc;
  RingView<V> r{static_cast<const V*>(z), static_cast<V*>(left_z),
                static_cast<V*>(right_z), pad, left_pad, right_pad, epoch,
                axis, n0, n1, b, send_lo, send_hi};
  const HaloWalk h = walk_of(axis, n0, n1, b, v);
  const long long items = send_lo || send_hi ? h.rows * h.vb : 0;
  const long long per_cta = kThreads * (sizeof(V) == 16 ? kUnroll : 1LL);
  const int ctas = stage ? 1 : coll_grid(resident, items, per_cta, max_ctas);
  ring_halo_kernel<V, kSys>
      <<<ctas, kThreads, 0, s>>>(r, h, static_cast<V*>(stage));
  return cudaGetLastError();
}

// The launch of route V, at gpu scope on the one-card self-ring (every
// buffer and pad my own), else at system scope.
template <typename V>
int launch_scoped(void* z, void* left_z, void* right_z, int* pad,
                  int* left_pad, int* right_pad, int epoch, int axis,
                  long long n0, long long n1, long long b, int send_lo,
                  int send_hi, long long v, void* stage, int max_ctas,
                  cudaStream_t s) {
  const bool one_card = left_z == z && right_z == z && left_pad == pad &&
                        right_pad == pad;
  const auto go = one_card ? launch<V, false> : launch<V, true>;
  return go(z, left_z, right_z, pad, left_pad, right_pad, epoch, axis, n0,
            n1, b, send_lo, send_hi, v, stage, max_ctas, s);
}

}  // namespace
}  // namespace tpumt

// Plain C entry point (bound with ctypes). Returns a cudaError_t: 0 when
// the launch was accepted. `z` is my contiguous (n0, n1) array of
// `itemsize`-byte elements; `left_z` / `right_z` the neighbours' copies of
// it (z itself on the self-ring); the pads are int32 words (comm/peer.py);
// `epoch` counts this process's RDMA launches from 1; `stage` is NULL, or
// 2*b*extent elements of scratch when the extent along `axis` is under
// 3*b. The extent must hold both bands (>= 2*b). `route` is the CollRoute
// code that hand.halo_route names for these pointers and this geometry
// (any other value is refused); `max_ctas` caps the grid (0: the card's
// resident count for the kernel).
extern "C" int tpumt_ring_halo(void* z, void* left_z, void* right_z,
                               void* pad, void* left_pad, void* right_pad,
                               int epoch, int itemsize, int axis, long long n0,
                               long long n1, long long b, int send_lo,
                               int send_hi, void* stage, int route,
                               int max_ctas, void* stream) {
  using namespace tpumt;
  const long long n = axis == 0 ? n0 : n1;
  if ((axis != 0 && axis != 1) || n0 < 1 || n1 < 1 || b < 1 || n < 2 * b ||
      epoch < 1 || max_ctas < 0 || n0 > LLONG_MAX / n1 / 8 ||
      (itemsize != 2 && itemsize != 4 && itemsize != 8) ||
      route != halo_route(itemsize, axis, n0, n1, b, z, left_z, right_z))
    return cudaErrorInvalidValue;
  if (n < 3 * b && stage == nullptr && (send_lo || send_hi))
    return cudaErrorInvalidValue;
  int* p = static_cast<int*>(pad);
  int* lp = static_cast<int*>(left_pad);
  int* rp = static_cast<int*>(right_pad);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  void* st = n < 3 * b ? stage : nullptr;
  if (route == kRouteVec16)
    return launch_scoped<uint4>(z, left_z, right_z, p, lp, rp, epoch, axis,
                                n0, n1, b, send_lo, send_hi, 16 / itemsize,
                                nullptr, max_ctas, s);
  switch (itemsize) {
    case 2:
      return launch_scoped<uint16_t>(z, left_z, right_z, p, lp, rp, epoch,
                                     axis, n0, n1, b, send_lo, send_hi, 1,
                                     st, max_ctas, s);
    case 4:
      return launch_scoped<uint32_t>(z, left_z, right_z, p, lp, rp, epoch,
                                     axis, n0, n1, b, send_lo, send_hi, 1,
                                     st, max_ctas, s);
    default:
      return launch_scoped<uint64_t>(z, left_z, right_z, p, lp, rp, epoch,
                                     axis, n0, n1, b, send_lo, send_hi, 1,
                                     st, max_ctas, s);
  }
}
