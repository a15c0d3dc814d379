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
// Bound on the H100: HBM traffic, no arithmetic. Along axis 0 a band is
// one contiguous run of b rows: both bands read once and written once,
// 4·b·n1·itemsize bytes (16 MiB at the stencil2d dim-0 shard, 1028×524288
// f32, b = 2: 5.0 µs at 3.35 TB/s). Along axis 1 a row's band is b
// elements (8 bytes at f32, b = 2) and the card moves whole 32-byte
// sectors on the strided side. On a row-major array row r-1's hi edge and
// hi ghost and row r's lo ghost and lo edge are one contiguous run of 4b
// elements, so the two sides share sectors: counted as the union of the
// sectors its bands touch, the strided side is 24 MiB at 524288×1028 f32,
// b = 2 (32 counting each band's own), plus the contiguous buffers (8
// MiB): 0.0100 ms of bytes. The card does not reach it there: rows 4112
// bytes apart put every seam (below) in a DRAM page of its own, so the
// strided side costs a page a seam. Measured (pack_ab and chip_smoke.py,
// NVIDIA H100 80GB HBM3, 700.00 W): pack 0.027 ms, ~20 G seams/s, just
// under torch.stack of the two narrows; unpack 0.077 ms, ~7 G seams/s,
// its stores partial-sector writes — whole-sector stores with nothing
// read first gain 4 % (a probe with wrong values), and a read of each
// sector before storing it whole loses 30-55 %. At the 8192-row operands
// the bytes take a fraction of a µs and the launch (~3 µs) is all the
// time there is.
//
// Design. Pure copies: elements move as raw words. Three routes, named by
// the wrapper (hand.pack_route) after the width of the word a thread moves
// and checked here: "vec16" (uint4) and "vec8" (uint2) where the word is
// wider than an element, z and both buffers start on a word, the row
// pitch is whole words and, along axis 1, so is a row's band (then every
// band's first column is too); "scalar", one element, on any other
// operand. Along axis 0 two flat copies of the bands' runs, kUnroll word
// pairs (lo and hi) in flight a thread, neighbouring threads on
// neighbouring words, no division. Along axis 1 a seam walk: seam r
// (r = 0..n0) is row r-1's hi side and row r's lo side (seam 0 only row
// 0's lo side, seam n0 only row n0-1's hi side). A thread takes word j of
// both sides of a seam (at the main path's 8-byte bands, the whole seam),
// kSeamUnroll seams in flight; (seam, j) is divided out once and stepped
// on after that. Pack then writes neighbouring words of the buffers from
// neighbouring threads; unpack writes the seam's 2b contiguous ghost
// elements from one thread. The grid is the occupancy API's resident
// count for the instance, clipped to the work at one item a thread (a
// thread loops, kUnroll or kSeamUnroll items in flight, only where the
// work outnumbers the resident threads): at four items a thread the
// 8192-row operands ran on 8 CTAs, 0.0037 / 0.0046 ms on the same card,
// against 0.0030 now. kernels/pack_ab.py times the choices below: four
// words in flight beat eight by ~10 % on axis 0 and tie one and two; on
// axis 1 depths 1-8, the row walk and an evict-first store hint all read
// within 7 % of the seam walk at four; CTAs of 64 or 128 threads gain
// 0.2-0.3 µs at 8192 rows but cost pack 5 % at 524288 rows, where it
// races torch.stack, so a CTA stays 256 threads.
#include <climits>
#include <cstdint>
#include <initializer_list>

#include <cuda_runtime.h>

#include "occupancy.cuh"

namespace tpumt {
namespace {

constexpr int kThreads = 256;
// word pairs (lo and hi band) each thread has in flight on axis 0
constexpr int kUnroll = 4;
// seams each thread has in flight on axis 1
constexpr int kSeamUnroll = 4;
// rows the hi side of an axis-1 item lies behind its lo side: 1 walks
// seams; 0 would walk rows, a thread taking one row's two bands
constexpr long long kBehind = 1;

enum PackRoute : int { kPackScalar = 0, kPackVec8 = 1, kPackVec16 = 2 };

// Two runs of `n` words: dst0[e] = src0[e], dst1[e] = src1[e] (axis 0:
// the two bands of z and the two buffers).
template <typename V>
__global__ void __launch_bounds__(kThreads)
    flat_copy_kernel(const V* __restrict__ src0, V* __restrict__ dst0,
                     const V* __restrict__ src1, V* __restrict__ dst1,
                     long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long e = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       e < n; e += kUnroll * stride) {
    V a[kUnroll], b[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long at = e + u * stride;
      if (at < n) {
        a[u] = src0[at];
        b[u] = src1[at];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long at = e + u * stride;
      if (at < n) {
        dst0[at] = a[u];
        dst1[at] = b[u];
      }
    }
  }
}

// Axis 1 of an (n0, pw)-word array whose bands are `vb` words a row.
// Item e = r·vb + j is word j of seam r: row r-1's hi side (r >= 1) and
// row r's lo side (r < n0); the buffers hold row r's words at r·vb.
// kPack: z -> lo, hi; else lo, hi -> z.
template <bool kPack, typename V>
__global__ void __launch_bounds__(kThreads)
    seam_walk_kernel(V* __restrict__ z, V* __restrict__ lo,
                     V* __restrict__ hi, long long n0, long long pw,
                     long long vb) {
  // each side's first word, from the start of row r: the edges (pack) or
  // the ghosts (unpack); the hi side kBehind rows back
  const long long lo_col = kPack ? vb : 0;
  const long long hi_col = (kPack ? pw - 2 * vb : pw - vb) - kBehind * pw;
  const long long seams = n0 + kBehind;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first =
      blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  // (seam, word) of this thread's first item and of the grid's stride;
  // a 64-bit division is a long subroutine, so only where a band is
  // several words
  long long r = first, j = 0, dr = stride, dj = 0;
  if (vb > 1) {
    r = first / vb;
    j = first % vb;
    dr = stride / vb;
    dj = stride % vb;
  }
  while (r < seams) {
    long long row[kSeamUnroll], col[kSeamUnroll];
#pragma unroll
    for (int u = 0; u < kSeamUnroll; ++u) {
      row[u] = r;
      col[u] = j;
      r += dr;
      j += dj;
      if (j >= vb) {
        j -= vb;
        ++r;
      }
    }
    V wlo[kSeamUnroll], whi[kSeamUnroll];
#pragma unroll
    for (int u = 0; u < kSeamUnroll; ++u) {
      const long long base = row[u] * pw + col[u];
      const long long e = row[u] * vb + col[u];
      const bool has_lo = row[u] < n0;
      const bool has_hi = row[u] >= kBehind && row[u] < seams;
      if constexpr (kPack) {
        if (has_lo) wlo[u] = z[base + lo_col];
        if (has_hi) whi[u] = z[base + hi_col];
      } else {
        if (has_lo) wlo[u] = lo[e];
        if (has_hi) whi[u] = hi[e - kBehind * vb];
      }
    }
#pragma unroll
    for (int u = 0; u < kSeamUnroll; ++u) {
      const long long base = row[u] * pw + col[u];
      const long long e = row[u] * vb + col[u];
      const bool has_lo = row[u] < n0;
      const bool has_hi = row[u] >= kBehind && row[u] < seams;
      if constexpr (kPack) {
        if (has_lo) lo[e] = wlo[u];
        if (has_hi) hi[e - kBehind * vb] = whi[u];
      } else {
        if (has_lo) z[base + lo_col] = wlo[u];
        if (has_hi) z[base + hi_col] = whi[u];
      }
    }
  }
}

template <typename V>
int launch_flat(const V* src0, V* dst0, const V* src1, V* dst1, long long n,
                cudaStream_t s) {
  static int resident = 0;
  const cudaError_t rc = coll_resident_ctas(
      reinterpret_cast<const void*>(flat_copy_kernel<V>), kThreads,
      &resident);
  if (rc != cudaSuccess) return rc;
  const int ctas = coll_grid(resident, n, kThreads, 0);
  flat_copy_kernel<V><<<ctas, kThreads, 0, s>>>(src0, dst0, src1, dst1, n);
  return cudaGetLastError();
}

template <bool kPack, typename V>
int launch_seams(V* z, V* lo, V* hi, long long n0, long long pw,
                 long long vb, cudaStream_t s) {
  static int resident = 0;
  const cudaError_t rc = coll_resident_ctas(
      reinterpret_cast<const void*>(seam_walk_kernel<kPack, V>), kThreads,
      &resident);
  if (rc != cudaSuccess) return rc;
  const int ctas = coll_grid(resident, (n0 + kBehind) * vb, kThreads, 0);
  seam_walk_kernel<kPack, V><<<ctas, kThreads, 0, s>>>(z, lo, hi, n0, pw,
                                                         vb);
  return cudaGetLastError();
}

// Pack (z -> lo, hi) or unpack (lo, hi -> z) on route V, `v` elements a
// word, of an (n0, n1) array's bands `b` wide along `axis`.
template <typename V>
int launch(bool pack, void* z, void* lo, void* hi, int axis, long long n0,
           long long n1, long long b, long long v, cudaStream_t s) {
  V* zw = static_cast<V*>(z);
  V* l = static_cast<V*>(lo);
  V* h = static_cast<V*>(hi);
  const long long pw = n1 / v;
  if (axis == 1)
    return pack ? launch_seams<true>(zw, l, h, n0, pw, b / v, s)
                : launch_seams<false>(zw, l, h, n0, pw, b / v, s);
  V* lo_band = zw + (pack ? b : 0) * pw;
  V* hi_band = zw + (pack ? n0 - 2 * b : n0 - b) * pw;
  return pack ? launch_flat<V>(lo_band, l, hi_band, h, b * pw, s)
              : launch_flat<V>(l, lo_band, h, hi_band, b * pw, s);
}

// The route the rule gives (hand.pack_route): the widest word (16, then
// 8 bytes) wider than an element on which z and both buffers start, of
// which the row pitch is whole words and, along axis 1, so is a row's
// band; else scalar.
int pack_route(int itemsize, int axis, long long n1, long long b,
               const void* z, const void* lo, const void* hi) {
  for (const long long w : {16LL, 8LL}) {
    if (w <= itemsize || n1 * itemsize % w || (axis == 1 && b * itemsize % w))
      continue;
    bool aligned = true;
    for (const void* p : {z, lo, hi})
      aligned = aligned && reinterpret_cast<uintptr_t>(p) % w == 0;
    if (aligned) return w == 16 ? kPackVec16 : kPackVec8;
  }
  return kPackScalar;
}

int stage(bool pack, void* z, void* lo, void* hi, int itemsize, int axis,
          long long n0, long long n1, long long b, int route,
          void* stream) {
  const long long n = axis == 0 ? n0 : n1;
  if ((axis != 0 && axis != 1) || n0 < 1 || n1 < 1 || b < 1 || n < 2 * b ||
      n0 > LLONG_MAX / n1 / 8 ||
      (itemsize != 2 && itemsize != 4 && itemsize != 8) ||
      route != pack_route(itemsize, axis, n1, b, z, lo, hi))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kPackVec16)
    return launch<uint4>(pack, z, lo, hi, axis, n0, n1, b, 16 / itemsize, s);
  if (route == kPackVec8)
    return launch<uint2>(pack, z, lo, hi, axis, n0, n1, b, 8 / itemsize, s);
  switch (itemsize) {
    case 2:
      return launch<uint16_t>(pack, z, lo, hi, axis, n0, n1, b, 1, s);
    case 4:
      return launch<uint32_t>(pack, z, lo, hi, axis, n0, n1, b, 1, s);
    default:
      return launch<uint64_t>(pack, z, lo, hi, axis, n0, n1, b, 1, s);
  }
}

}  // namespace
}  // namespace tpumt

// Plain C entry points (bound with ctypes). Each returns a cudaError_t: 0
// when the launch was accepted. `z` is a contiguous (n0, n1) array of
// `itemsize`-byte elements (2, 4 or 8); `lo` and `hi` are contiguous
// (b, n1) buffers for axis 0, (n0, b) for axis 1. The extent along
// `axis` must hold both bands (n >= 2b). `route` is the PackRoute code
// that hand.pack_route names for these pointers and this geometry (any
// other value is refused).
extern "C" int tpumt_pack_edges(const void* z, void* lo, void* hi,
                                int itemsize, int axis, long long n0,
                                long long n1, long long b, int route,
                                void* stream) {
  return tpumt::stage(true, const_cast<void*>(z), lo, hi, itemsize, axis,
                      n0, n1, b, route, stream);
}

extern "C" int tpumt_unpack_ghosts(void* z, const void* lo, const void* hi,
                                   int itemsize, int axis, long long n0,
                                   long long n1, long long b, int route,
                                   void* stream) {
  return tpumt::stage(false, z, const_cast<void*>(lo),
                      const_cast<void*>(hi), itemsize, axis, n0, n1, b,
                      route, stream);
}
