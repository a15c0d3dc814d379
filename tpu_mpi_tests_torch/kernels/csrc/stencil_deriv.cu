// Out-of-place 5-point first derivative × scale along one axis of a 2-D
// array ghosted along that axis (≅ the SYCL stencil2d_1d_5 kernel,
// mpi_stencil2d_sycl.cc:53-75).
//
// Replaces the Pallas kernel stencil2d_pallas
// (tpu_mpi_tests/kernels/pallas_kernels.py:636; bodies
// _stencil_strip_kernel :532, _stencil_stream0 :729, _stencil_stream1
// :777).
//
// What it computes: out has 2*N_BND fewer points along `dim`;
//     out[i] = (((c0*z[i] + c1*z[i+1]) + c3*z[i+3]) + c4*z[i+4]) * scale
// (the zero tap skipped, in the JAX kernel's order), with coefficients
// and scale in the array dtype.
//
// Design: one thread per output column, a grid-stride loop over output
// rows; each output point is 4 loads that coalesce across the warp
// (dim 0: neighbouring rows of the same columns; dim 1: neighbouring
// columns, served from L1). No shared memory.
//
// Bound on the H100: memory — 8 flops per output point against one read
// and one write of an element (8 bytes in f32), ~1 flop/byte.
#include <climits>
#include <cstdint>

#include "stencil_common.cuh"

namespace tpumt {
namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

template <typename T, int DIM>
__global__ void __launch_bounds__(kThreads)
    deriv_kernel(const T* __restrict__ z, T* __restrict__ out, long long n1,
                 long long m0, long long m1, typename Elt<T>::C c0,
                 typename Elt<T>::C c1, typename Elt<T>::C c3,
                 typename Elt<T>::C c4, typename Elt<T>::C scale) {
  using E = Elt<T>;
  using C = typename E::C;
  const long long j =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= m1) return;
  const long long st = DIM == 0 ? n1 : 1;  // input stride along `dim`
  for (long long i = blockIdx.y; i < m0; i += gridDim.y) {
    const T* p = z + i * n1 + j;
    C acc = E::mul(c0, E::load(p));
    acc = E::add(acc, E::mul(c1, E::load(p + st)));
    acc = E::add(acc, E::mul(c3, E::load(p + 3 * st)));
    acc = E::add(acc, E::mul(c4, E::load(p + 4 * st)));
    out[i * m1 + j] = E::store(E::mul(acc, scale));
  }
}

template <typename T, int DIM>
int launch(const void* z, void* out, long long n0, long long n1,
           const double* c, double scale, cudaStream_t stream) {
  using E = Elt<T>;
  const long long m0 = DIM == 0 ? n0 - 4 : n0;  // output shape
  const long long m1 = DIM == 0 ? n1 : n1 - 4;
  if (m0 <= 0 || m1 <= 0) return cudaSuccess;
  const long long gx = (m1 + kThreads - 1) / kThreads;
  if (gx > INT_MAX) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(gx),
                  static_cast<unsigned>(m0 < kMaxGridY ? m0 : kMaxGridY));
  deriv_kernel<T, DIM><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(z), static_cast<T*>(out), n1, m0, m1,
      E::coef(c[0]), E::coef(c[1]), E::coef(c[3]), E::coef(c[4]),
      E::coef(scale));
  return cudaGetLastError();
}

template <typename T>
int launch_dim(int dim, const void* z, void* out, long long n0, long long n1,
               const double* c, double scale, cudaStream_t stream) {
  if (dim == 0) return launch<T, 0>(z, out, n0, n1, c, scale, stream);
  return launch<T, 1>(z, out, n0, n1, c, scale, stream);
}

}  // namespace
}  // namespace tpumt

// Plain C entry point (bound with ctypes). Returns a cudaError_t: 0 when
// the launch was accepted. `c0..c4` and `scale` arrive already rounded to
// the array dtype; `c2` (the zero tap) is skipped.
extern "C" int tpumt_stencil2d_deriv(const void* z, void* out, int dtype,
                                     int dim, long long n0, long long n1,
                                     double c0, double c1, double c2,
                                     double c3, double c4, double scale,
                                     void* stream) {
  using namespace tpumt;
  const double c[5] = {c0, c1, c2, c3, c4};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim != 0 && dim != 1) return cudaErrorInvalidValue;
  switch (dtype) {
    case kF32:
      return launch_dim<float>(dim, z, out, n0, n1, c, scale, s);
    case kF64:
      return launch_dim<double>(dim, z, out, n0, n1, c, scale, s);
    case kBF16:
      return launch_dim<__nv_bfloat16>(dim, z, out, n0, n1, c, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
