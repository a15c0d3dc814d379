// Halo staging: pack the two interior edge bands of a ghosted 2-D array
// into contiguous buffers, and write two received bands into its ghost
// bands.
//
// Replaces the Pallas kernels pack_edges_pallas
// (tpu_mpi_tests/kernels/pallas_kernels.py:2772, body _pack_kernel :2761)
// and unpack_ghosts_pallas (:2803, body _unpack_kernel :2791), themselves
// the SYCL buf_from_view / buf_to_view of the reference.
//
// Layout along `axis` (extent n, band width b):
//     [0, b)        lo ghost   <- unpack writes lo_ghost here
//     [b, 2b)       lo edge    -> pack reads lo from here
//     [n-2b, n-b)   hi edge    -> pack reads hi from here
//     [n-b, n)      hi ghost   <- unpack writes hi_ghost here
//
// Pack: lo, hi = z[b:2b], z[n-2b:n-b] along axis, each a contiguous
// (b, n1) or (n0, b) buffer. Unpack writes the two ghost bands of z IN
// PLACE (the Pallas kernel copies all of z because it is functional; the
// port's exchanges are in place by design).
//
// Design: pure copies, so elements move as raw 2-, 4- or 8-byte words; one
// grid-stride loop over the elements of both bands. Along axis 0 a band
// is one contiguous run of b rows. Along axis 1 it is b elements out of
// every row of n1: each b-element read touches a whole 32-byte sector,
// so the card moves ~32 bytes per row and band on the strided side
// whatever b is (for b * itemsize <= 32).
//
// Bound on the H100: memory (no arithmetic at all).
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace tpumt {
namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 16;

// Element e of band `band` (0 = lo, 1 = hi) lies at this offset of z;
// `start` is the band's first index along the axis.
__device__ __forceinline__ long long z_offset(long long e, int axis,
                                               long long n1, long long b,
                                               long long start) {
  if (axis == 0) return start * n1 + e;  // b whole rows, contiguous
  return (e / b) * n1 + start + e % b;
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
    pack_kernel(const W* __restrict__ z, W* __restrict__ lo,
                W* __restrict__ hi, int axis, long long n0, long long n1,
                long long b) {
  const long long n = axis == 0 ? n0 : n1;
  const long long band = b * (axis == 0 ? n1 : n0);  // elements per band
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long k = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       k < 2 * band; k += stride) {
    const bool is_hi = k >= band;
    const long long e = is_hi ? k - band : k;
    const long long start = is_hi ? n - 2 * b : b;
    (is_hi ? hi : lo)[e] = z[z_offset(e, axis, n1, b, start)];
  }
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
    unpack_kernel(W* __restrict__ z, const W* __restrict__ lo,
                  const W* __restrict__ hi, int axis, long long n0,
                  long long n1, long long b) {
  const long long n = axis == 0 ? n0 : n1;
  const long long band = b * (axis == 0 ? n1 : n0);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long k = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       k < 2 * band; k += stride) {
    const bool is_hi = k >= band;
    const long long e = is_hi ? k - band : k;
    const long long start = is_hi ? n - b : 0;
    z[z_offset(e, axis, n1, b, start)] = (is_hi ? hi : lo)[e];
  }
}

unsigned grid_for(long long elements) {
  long long blocks = (elements + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return static_cast<unsigned>(blocks < 1 ? 1 : blocks);
}

bool valid(int axis, long long n0, long long n1, long long b) {
  if (axis != 0 && axis != 1) return false;
  const long long n = axis == 0 ? n0 : n1;
  return n0 > 0 && n1 > 0 && b >= 1 && n >= 2 * b;
}

template <typename W>
int launch_pack(const void* z, void* lo, void* hi, int axis, long long n0,
                long long n1, long long b, cudaStream_t s) {
  const long long band = b * (axis == 0 ? n1 : n0);
  pack_kernel<W><<<grid_for(2 * band), kThreads, 0, s>>>(
      static_cast<const W*>(z), static_cast<W*>(lo), static_cast<W*>(hi),
      axis, n0, n1, b);
  return cudaGetLastError();
}

template <typename W>
int launch_unpack(void* z, const void* lo, const void* hi, int axis,
                  long long n0, long long n1, long long b, cudaStream_t s) {
  const long long band = b * (axis == 0 ? n1 : n0);
  unpack_kernel<W><<<grid_for(2 * band), kThreads, 0, s>>>(
      static_cast<W*>(z), static_cast<const W*>(lo),
      static_cast<const W*>(hi), axis, n0, n1, b);
  return cudaGetLastError();
}

}  // namespace
}  // namespace tpumt

// Plain C entry points (bound with ctypes). Each returns a cudaError_t: 0
// when the launch was accepted. `z` is a contiguous (n0, n1) array of
// `itemsize`-byte elements (2, 4 or 8); `lo` and `hi` are contiguous
// (b, n1) buffers for axis 0, (n0, b) for axis 1. The extent along
// `axis` must hold both bands (n >= 2b).
extern "C" int tpumt_pack_edges(const void* z, void* lo, void* hi,
                                int itemsize, int axis, long long n0,
                                long long n1, long long b, void* stream) {
  using namespace tpumt;
  if (!valid(axis, n0, n1, b)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (itemsize) {
    case 2:
      return launch_pack<uint16_t>(z, lo, hi, axis, n0, n1, b, s);
    case 4:
      return launch_pack<uint32_t>(z, lo, hi, axis, n0, n1, b, s);
    case 8:
      return launch_pack<uint64_t>(z, lo, hi, axis, n0, n1, b, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int tpumt_unpack_ghosts(void* z, const void* lo, const void* hi,
                                   int itemsize, int axis, long long n0,
                                   long long n1, long long b, void* stream) {
  using namespace tpumt;
  if (!valid(axis, n0, n1, b)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (itemsize) {
    case 2:
      return launch_unpack<uint16_t>(z, lo, hi, axis, n0, n1, b, s);
    case 4:
      return launch_unpack<uint32_t>(z, lo, hi, axis, n0, n1, b, s);
    case 8:
      return launch_unpack<uint64_t>(z, lo, hi, axis, n0, n1, b, s);
    default:
      return cudaErrorInvalidValue;
  }
}
