// k-step in-place-style stencil update along one axis of a 2-D array.
//
// Replaces the Pallas kernel stencil2d_iterate_pallas
// (tpu_mpi_tests/kernels/pallas_kernels.py:1177; bodies _iterate_kernel
// :869, _step5 :834, _masked_step :849, and the row-streaming path
// _iterate_stream0 :1111 / _iterate_stream0_kernel :951 / _kstep_advance
// :915). One template, parameterised on the stencil axis DIM, covers the
// full-height dim-0, the dim-1 strip and the dim-0 row-stream paths.
//
// What it computes: `steps` timesteps of the 5-point update along one
// axis over k*N_BND-deep ghosts, physical sides kept, exchange-fed sides
// shrinking by N_BND per step; the whole array is written. The tile body
// (kstep_tile, stencil_kstep.cuh) is shared with the fused ring kernel
// (fused_rdma.cu), which is what makes the fused and the chained RDMA
// tiers bitwise equal.
//
// Design. A CTA owns an output tile of TA indices along the stencil axis
// by TB along the other axis, loads it with a K-deep apron into shared
// memory, runs the k steps there and writes its TA indices to a SECOND
// buffer: the TPU kernel aliases input and output because each of its
// grid strips holds the whole stencil extent, but CTAs that split the
// stencil axis would read indices a neighbour had already overwritten.
//
// Bound on the H100: memory. At k=4 the update costs 7 flops × 4 steps
// per element against 8 bytes (f32 read + write): ~3.5 flop/byte, far
// below the card's ~20 flop/byte f32 ridge. The apron adds (TA+2K)/TA
// re-reads (1.25× at dim 0, 1.06× at dim 1, K=8), mostly from L2.
// Making it fast (TMA row streams, register sliding windows, persistent
// CTAs) is later work.
#include <climits>
#include <cstdint>

#include "stencil_kstep.cuh"

namespace tpumt {
namespace {

// output indices per CTA along the stencil axis
template <int DIM>
struct TileA;
template <>
struct TileA<0> {
  static constexpr int TA = 64;
};
template <>
struct TileA<1> {
  static constexpr int TA = 256;
};

template <typename T, int DIM>
__global__ void __launch_bounds__(256)
    iterate_kernel(const T* __restrict__ z, T* __restrict__ out, long long n0,
                   long long n1, int steps, typename Elt<T>::C se,
                   typename Elt<T>::C c1, typename Elt<T>::C c2, int phys_lo,
                   int phys_hi, const int* __restrict__ phys,
                   long long tiles_a) {
  using C = typename Elt<T>::C;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long tile = blockIdx.x;
  const long long a0 = (tile % tiles_a) * TileA<DIM>::TA;
  const long long b0 = (tile / tiles_a) * KTile<DIM>::TB;
  // dynamic flags (device int pair) win over the static ones
  const int plo = phys ? (phys[0] != 0) : phys_lo;
  const int phi = phys ? (phys[1] != 0) : phys_hi;
  kstep_tile<T, DIM>(z, out, n0, n1, steps, se, c1, c2, plo, phi, a0,
                     TileA<DIM>::TA, b0, reinterpret_cast<C*>(smem_raw));
}

template <typename T, int DIM>
int launch(const void* z, void* out, long long n0, long long n1, int steps,
           double se, double c1, double c2, int phys_lo, int phys_hi,
           const int* phys, cudaStream_t stream) {
  using E = Elt<T>;
  using G = KTile<DIM>;
  constexpr int TA = TileA<DIM>::TA;
  const long long N = DIM == 0 ? n0 : n1;
  const long long M = DIM == 0 ? n1 : n0;
  const long long tiles_a = (N + TA - 1) / TA;
  const long long tiles = tiles_a * ((M + G::TB - 1) / G::TB);
  if (tiles == 0) return cudaSuccess;
  if (tiles > INT_MAX) return cudaErrorInvalidConfiguration;
  const size_t smem = kstep_smem_bytes<T, DIM>(TA, steps);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        iterate_kernel<T, DIM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  iterate_kernel<T, DIM>
      <<<static_cast<unsigned>(tiles), dim3(G::BX, G::BY), smem, stream>>>(
          static_cast<const T*>(z), static_cast<T*>(out), n0, n1, steps,
          E::coef(se), E::coef(c1), E::coef(c2), phys_lo, phys_hi, phys,
          tiles_a);
  return cudaGetLastError();
}

template <typename T>
int launch_dim(int dim, const void* z, void* out, long long n0, long long n1,
               int steps, double se, double c1, double c2, int phys_lo,
               int phys_hi, const int* phys, cudaStream_t stream) {
  if (dim == 0)
    return launch<T, 0>(z, out, n0, n1, steps, se, c1, c2, phys_lo, phys_hi,
                        phys, stream);
  return launch<T, 1>(z, out, n0, n1, steps, se, c1, c2, phys_lo, phys_hi,
                      phys, stream);
}

}  // namespace
}  // namespace tpumt

// Plain C entry point (bound with ctypes). Returns a cudaError_t: 0 when
// the launch was accepted. `se`, `c1`, `c2` arrive already rounded to the
// array dtype. `phys` is a device pointer to two int32 flags, or NULL to
// use the static `phys_lo`/`phys_hi`.
extern "C" int tpumt_stencil2d_iterate(const void* z, void* out, int dtype,
                                       int dim, long long n0, long long n1,
                                       int steps, double se, double c1,
                                       double c2, int phys_lo, int phys_hi,
                                       const void* phys, void* stream) {
  using namespace tpumt;
  const int* ph = static_cast<const int*>(phys);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((dim != 0 && dim != 1) || steps < 1) return cudaErrorInvalidValue;
  switch (dtype) {
    case kF32:
      return launch_dim<float>(dim, z, out, n0, n1, steps, se, c1, c2,
                               phys_lo, phys_hi, ph, s);
    case kF64:
      return launch_dim<double>(dim, z, out, n0, n1, steps, se, c1, c2,
                                phys_lo, phys_hi, ph, s);
    case kBF16:
      return launch_dim<__nv_bfloat16>(dim, z, out, n0, n1, steps, se, c1,
                                       c2, phys_lo, phys_hi, ph, s);
    default:
      return cudaErrorInvalidValue;
  }
}
