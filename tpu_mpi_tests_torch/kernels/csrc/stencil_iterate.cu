// k-step in-place-style stencil update along one axis of a 2-D array.
//
// Replaces the Pallas kernel stencil2d_iterate_pallas
// (tpu_mpi_tests/kernels/pallas_kernels.py:1177; bodies _iterate_kernel
// :869, _step5 :834, _masked_step :849, and the row-streaming path
// _iterate_stream0 :1111 / _iterate_stream0_kernel :951 / _kstep_advance
// :915). One template, parameterised on the stencil axis DIM, covers the
// full-height dim-0, the dim-1 strip and the dim-0 row-stream paths.
//
// What it computes: `steps` timesteps of
//     z[a] += se * (C1*(z[a+1]-z[a-1]) + C2*(z[a+2]-z[a-2]))
// along the stencil axis. At step s an index a is updated iff
// a ∈ [dlo_s, dhi_s), dlo_s = K if phys_lo else s*R and
// dhi_s = N - (K if phys_hi else s*R), K = steps*R, R = N_BND = 2 —
// physical sides keep their K-deep band fixed, exchange-fed sides shrink
// by R per step (the deep-halo temporal-blocking contract). Indices never
// updated keep their input value; the whole array is written.
//
// Design. A CTA owns an output tile of TA indices along the stencil axis
// by TB along the other axis. It loads the tile plus a K-deep apron on
// each side (clipped at the array edge) into shared memory and runs the
// k steps there, ping-ponging between two shared buffers: at step s it
// updates [max(win_lo + s*R, dlo_s), min(win_hi - s*R, dhi_s)), the part
// of its window whose inputs are still exact (an unclipped side loses R
// per step; at a clipped side the window reaches the array edge). Then
// it writes its own TA indices. The output goes to a SECOND buffer: the
// TPU kernel aliases input and output because each of its grid strips
// holds the whole stencil extent, but CTAs that split the stencil axis
// would read indices a neighbour had already overwritten.
//
// Bound on the H100: memory. At k=4 the update costs 7 flops × 4 steps
// per element against 8 bytes (f32 read + write): ~3.5 flop/byte, far
// below the card's ~20 flop/byte f32 ridge. The apron adds (TA+2K)/TA
// re-reads (1.25× at dim 0, 1.06× at dim 1, K=8), mostly from L2.
// Making it fast (TMA row streams, register sliding windows, persistent
// CTAs) is later work.
#include <climits>
#include <cstdint>

#include "stencil_common.cuh"

namespace tpumt {
namespace {

constexpr int kRadius = 2;  // N_BND

// Tile geometry per stencil axis. The contiguous axis (columns) maps to
// threadIdx.x so global loads and stores coalesce.
template <int DIM>
struct Tile;
template <>
struct Tile<0> {                // stencil along rows
  static constexpr int TA = 64;  // output rows per CTA
  static constexpr int TB = 64;  // columns per CTA
  static constexpr int BX = 64;
  static constexpr int BY = 4;
};
template <>
struct Tile<1> {                 // stencil along columns
  static constexpr int TA = 256;  // output columns per CTA
  static constexpr int TB = 8;    // rows per CTA
  static constexpr int BX = 128;
  static constexpr int BY = 2;
};

template <typename T, int DIM>
__global__ void __launch_bounds__(256)
    iterate_kernel(const T* __restrict__ z, T* __restrict__ out, long long n0,
                   long long n1, int steps, typename Elt<T>::C se,
                   typename Elt<T>::C c1, typename Elt<T>::C c2, int phys_lo,
                   int phys_hi, const int* __restrict__ phys,
                   long long tiles_a) {
  using E = Elt<T>;
  using C = typename E::C;
  using G = Tile<DIM>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int K = steps * kRadius;
  const int WA = G::TA + 2 * K;             // window extent, stencil axis
  // int(...) keeps the constexpr members values, never references
  const int INNER = DIM == 0 ? int(G::TB) : WA;  // contiguous extent
  const int OUTER = DIM == 0 ? WA : int(G::TB);
  C* buf0 = reinterpret_cast<C*>(smem_raw);
  C* buf1 = buf0 + static_cast<size_t>(WA) * G::TB;

  const long long N = DIM == 0 ? n0 : n1;  // extent along the stencil axis
  const long long M = DIM == 0 ? n1 : n0;  // extent along the other axis
  const long long tile = blockIdx.x;
  const long long a0 = (tile % tiles_a) * G::TA;
  const long long b0 = (tile / tiles_a) * G::TB;
  const long long origin = a0 - K;  // absolute index of window position 0
  const long long wa0 = origin > 0 ? origin : 0;
  const long long wa1 = a0 + G::TA + K < N ? a0 + G::TA + K : N;

  // dynamic flags (device int pair) win over the static ones
  const int plo = phys ? (phys[0] != 0) : phys_lo;
  const int phi = phys ? (phys[1] != 0) : phys_hi;
  const int tx = threadIdx.x, ty = threadIdx.y;

  for (int pi = ty; pi < OUTER; pi += G::BY) {
    for (int pj = tx; pj < INNER; pj += G::BX) {
      const int pa = DIM == 0 ? pi : pj;
      const int pb = DIM == 0 ? pj : pi;
      const long long a = origin + pa, b = b0 + pb;
      C v = C(0);
      if (a >= wa0 && a < wa1 && b < M) {
        const long long g = DIM == 0 ? a * n1 + b : b * n1 + a;
        v = E::load(z + g);
      }
      buf0[pi * INNER + pj] = v;
    }
  }
  __syncthreads();

  const int st = DIM == 0 ? int(G::TB) : 1;  // smem stride along the stencil axis
  C* src = buf0;
  C* dst = buf1;
  for (int s = 1; s <= steps; ++s) {
    const long long shrink = static_cast<long long>(s) * kRadius;
    const long long dlo = plo ? K : shrink;
    const long long dhi = N - (phi ? K : shrink);
    long long lo = wa0 + shrink;
    long long hi = wa1 - shrink;
    lo = lo > dlo ? lo : dlo;
    hi = hi < dhi ? hi : dhi;
    for (int pi = ty; pi < OUTER; pi += G::BY) {
      for (int pj = tx; pj < INNER; pj += G::BX) {
        const int pa = DIM == 0 ? pi : pj;
        const long long a = origin + pa;
        const int e = pi * INNER + pj;
        C v = src[e];
        if (a >= lo && a < hi) {
          // _step5's order: z0 + se*(C1*(z+1 - z-1) + C2*(z+2 - z-2))
          const C* p = src + e;
          const C d1 = E::sub(p[st], p[-st]);
          const C d2 = E::sub(p[2 * st], p[-2 * st]);
          const C acc = E::add(E::mul(c1, d1), E::mul(c2, d2));
          v = E::add(v, E::mul(se, acc));
        }
        dst[e] = v;
      }
    }
    __syncthreads();
    C* t = src;
    src = dst;
    dst = t;
  }

  for (int pi = ty; pi < OUTER; pi += G::BY) {
    for (int pj = tx; pj < INNER; pj += G::BX) {
      const int pa = DIM == 0 ? pi : pj;
      const int pb = DIM == 0 ? pj : pi;
      if (pa < K || pa >= K + G::TA) continue;
      const long long a = origin + pa, b = b0 + pb;
      if (a < N && b < M) {
        const long long g = DIM == 0 ? a * n1 + b : b * n1 + a;
        out[g] = E::store(src[pi * INNER + pj]);
      }
    }
  }
}

template <typename T, int DIM>
int launch(const void* z, void* out, long long n0, long long n1, int steps,
           double se, double c1, double c2, int phys_lo, int phys_hi,
           const int* phys, cudaStream_t stream) {
  using E = Elt<T>;
  using G = Tile<DIM>;
  const long long N = DIM == 0 ? n0 : n1;
  const long long M = DIM == 0 ? n1 : n0;
  const int K = steps * kRadius;
  const long long tiles_a = (N + G::TA - 1) / G::TA;
  const long long tiles = tiles_a * ((M + G::TB - 1) / G::TB);
  if (tiles == 0) return cudaSuccess;
  if (tiles > INT_MAX) return cudaErrorInvalidConfiguration;
  const size_t smem =
      2 * static_cast<size_t>(G::TA + 2 * K) * G::TB * sizeof(typename E::C);
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
