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
// Design. Two routes (stencil_kstep.cuh), named by the wrapper
// (hand.kstep_route) and checked here. "regs", where 1 <= steps <= 8 and
// every row of z and out starts on 8 bytes, in vectors of 16 bytes where
// every row starts on 16 and of 8 otherwise: dim 0, a thread a column
// vector walking a run of rows through the register pipeline, as many
// runs (balanced over the height) as fill the card's resident threads
// once but none shorter than kRunRows, one run a thread — the grid sized
// to the work by the occupancy API; dim 1, a warp a row segment, its
// lanes stepping by shuffles, a grid of one warp a (row, segment). "smem", any
// other operand: a CTA owns an output tile of TA indices along the
// stencil axis by TB along the other axis, loads it with a K-deep apron
// into shared memory and runs the k steps there. Either way the result
// goes to a SECOND buffer: the TPU kernel aliases input and output
// because each of its grid strips holds the whole stencil extent, but
// tiles that split the stencil axis would read indices a neighbour had
// already overwritten.
//
// Bound on the H100: memory. At k=4 the update costs 7 flops × 4 steps
// per element against 8 bytes (f32 read + write): ~3.5 flop/byte, below
// the card's ~20 flop/byte f32 ridge. The aprons add re-reads: 2K rows a
// run at dim 0 (at k=4, 16 rows on 125 at the bench's 4112-row block, 16
// on 528 at the driver's block), 2·Ka elements a segment at dim 1.
#include <climits>
#include <cstdint>

#include "occupancy.cuh"
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
int launch_smem(const void* z, void* out, long long n0, long long n1,
                int steps, double se, double c1, double c2, int phys_lo,
                int phys_hi, const int* phys, cudaStream_t stream) {
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

// The regs route, dim 0: thread (x, y) owns column vector x of run y.
template <typename T, int kK, int kVB>
__global__ void __launch_bounds__(kRegsThreads)
    iterate_regs_dim0(const T* __restrict__ z, T* __restrict__ out, int n0,
                      long long n1, int ta, typename Elt<T>::C se,
                      typename Elt<T>::C c1, typename Elt<T>::C c2,
                      int phys_lo, int phys_hi, const int* __restrict__ phys) {
  using KW = KWord<T>;
  constexpr int E = kVB / sizeof(T);
  const long long v = blockIdx.x * static_cast<long long>(kRegsThreads) +
                      threadIdx.x;
  if (v >= n1 / E) return;
  const int plo = phys ? (phys[0] != 0) : phys_lo;
  const int phi = phys ? (phys[1] != 0) : phys_hi;
  kstep_regs_dim0<T, kK, kVB, false>(
      reinterpret_cast<const char*>(z + v * E),
      reinterpret_cast<char*>(out + v * E), n1 * sizeof(T), n0,
      static_cast<int>(blockIdx.y) * ta, ta, KW::coef(se), KW::coef(c1),
      KW::coef(c2), plo, phi);
}

// The regs route, dim 1: warp w of the grid owns segment w % segs of row
// w / segs.
template <typename T, int kK, int kVB>
__global__ void __launch_bounds__(kRegsThreads)
    iterate_regs_dim1(const T* __restrict__ z, T* __restrict__ out,
                      long long n0, int n1, int segs, typename Elt<T>::C se,
                      typename Elt<T>::C c1, typename Elt<T>::C c2,
                      int phys_lo, int phys_hi, const int* __restrict__ phys) {
  using KW = KWord<T>;
  const long long w = (blockIdx.x * static_cast<long long>(kRegsThreads) +
                       threadIdx.x) / 32;
  if (w >= n0 * segs) return;
  const long long row = w / segs;
  const int plo = phys ? (phys[0] != 0) : phys_lo;
  const int phi = phys ? (phys[1] != 0) : phys_hi;
  kstep_regs_dim1<T, kK, kVB>(z + row * n1, out + row * n1, n1,
                              static_cast<int>(w % segs), KW::coef(se),
                              KW::coef(c1), KW::coef(c2), plo, phi);
}

// The regs route at kK steps in vectors of kVB bytes.
template <typename T, int DIM, int kK, int kVB>
int launch_regs_as(const void* z, void* out, long long n0, long long n1,
                   double se, double c1, double c2, int phys_lo, int phys_hi,
                   const int* phys, cudaStream_t stream) {
  using E = Elt<T>;
  if constexpr (DIM == 0) {
    constexpr int V = kVB / sizeof(T);
    // as many runs as fill the card's resident threads once (one run a
    // thread, no loop), none shorter than kRunRows, balanced
    static int resident = 0;
    const cudaError_t rc = coll_resident_ctas(
        reinterpret_cast<const void*>(iterate_regs_dim0<T, kK, kVB>),
        kRegsThreads, &resident);
    if (rc != cudaSuccess) return rc;
    const long long nv = n1 / V;
    long long runs = nv > 0 ? (static_cast<long long>(resident) *
                                   kRegsThreads + nv - 1) / nv
                            : 1;
    const long long most = (n0 + kRunRows - 1) / kRunRows;
    if (runs > most) runs = most;
    if (runs < 1) runs = 1;
    const int ta = static_cast<int>((n0 + runs - 1) / runs);
    runs = (n0 + ta - 1) / ta;
    const long long cols = (nv + kRegsThreads - 1) / kRegsThreads;
    if (cols == 0) return cudaSuccess;
    if (cols > INT_MAX || runs > 65535) return cudaErrorInvalidConfiguration;
    iterate_regs_dim0<T, kK, kVB>
        <<<dim3(static_cast<unsigned>(cols), static_cast<unsigned>(runs)),
           kRegsThreads, 0, stream>>>(
            static_cast<const T*>(z), static_cast<T*>(out),
            static_cast<int>(n0), n1, ta, E::coef(se), E::coef(c1),
            E::coef(c2), phys_lo, phys_hi, phys);
  } else {
    using G = KDim1<T, kK, kVB>;
    const long long segs = (n1 / G::E + G::kInner - 1) / G::kInner;
    const long long ctas =
        (n0 * segs + kRegsThreads / 32 - 1) / (kRegsThreads / 32);
    if (ctas == 0) return cudaSuccess;
    if (ctas > INT_MAX) return cudaErrorInvalidConfiguration;
    iterate_regs_dim1<T, kK, kVB>
        <<<static_cast<unsigned>(ctas), kRegsThreads, 0, stream>>>(
            static_cast<const T*>(z), static_cast<T*>(out), n0,
            static_cast<int>(n1), static_cast<int>(segs), E::coef(se),
            E::coef(c1), E::coef(c2), phys_lo, phys_hi, phys);
  }
  return cudaGetLastError();
}

// The regs route in vectors of `vb` bytes (kstep_vec_bytes).
template <typename T, int DIM>
int launch_regs(const void* z, void* out, long long n0, long long n1,
                int steps, int vb, double se, double c1, double c2,
                int phys_lo, int phys_hi, const int* phys,
                cudaStream_t stream) {
  if (n0 > INT_MAX || n1 > INT_MAX) return cudaErrorInvalidValue;
  return with_steps(steps, [&](auto kk) -> int {
    return with_vec(vb, [&](auto vv) -> int {
      return launch_regs_as<T, DIM, decltype(kk)::value,
                            decltype(vv)::value>(
          z, out, n0, n1, se, c1, c2, phys_lo, phys_hi, phys, stream);
    });
  });
}

template <typename T>
int launch_dim(int route, int vb, int dim, const void* z, void* out,
               long long n0, long long n1, int steps, double se, double c1,
               double c2, int phys_lo, int phys_hi, const int* phys,
               cudaStream_t stream) {
  if (route == kKStepRegs)
    return dim == 0
               ? launch_regs<T, 0>(z, out, n0, n1, steps, vb, se, c1, c2,
                                   phys_lo, phys_hi, phys, stream)
               : launch_regs<T, 1>(z, out, n0, n1, steps, vb, se, c1, c2,
                                   phys_lo, phys_hi, phys, stream);
  return dim == 0 ? launch_smem<T, 0>(z, out, n0, n1, steps, se, c1, c2,
                                      phys_lo, phys_hi, phys, stream)
                  : launch_smem<T, 1>(z, out, n0, n1, steps, se, c1, c2,
                                      phys_lo, phys_hi, phys, stream);
}

}  // namespace
}  // namespace tpumt

// Plain C entry point (bound with ctypes). Returns a cudaError_t: 0 when
// the launch was accepted. `se`, `c1`, `c2` arrive already rounded to the
// array dtype. `phys` is a device pointer to two int32 flags, or NULL to
// use the static `phys_lo`/`phys_hi`. `route` is the KStepRoute code that
// hand.kstep_route names for these pointers, this row pitch and `steps`
// (any other value is refused).
extern "C" int tpumt_stencil2d_iterate(const void* z, void* out, int dtype,
                                       int dim, long long n0, long long n1,
                                       int steps, double se, double c1,
                                       double c2, int phys_lo, int phys_hi,
                                       const void* phys, int route,
                                       void* stream) {
  using namespace tpumt;
  const int* ph = static_cast<const int*>(phys);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int itemsize = dtype == kBF16 ? 2 : dtype == kF64 ? 8 : 4;
  if ((dim != 0 && dim != 1) || steps < 1 ||
      route != kstep_route(steps, z, out, n1, itemsize, kIterateRowBytes))
    return cudaErrorInvalidValue;
  const int vb = kstep_vec_bytes(z, out, n1, itemsize);
  switch (dtype) {
    case kF32:
      return launch_dim<float>(route, vb, dim, z, out, n0, n1, steps, se, c1,
                               c2, phys_lo, phys_hi, ph, s);
    case kF64:
      return launch_dim<double>(route, vb, dim, z, out, n0, n1, steps, se,
                                c1, c2, phys_lo, phys_hi, ph, s);
    case kBF16:
      return launch_dim<__nv_bfloat16>(route, vb, dim, z, out, n0, n1, steps,
                                       se, c1, c2, phys_lo, phys_hi, ph, s);
    default:
      return cudaErrorInvalidValue;
  }
}
