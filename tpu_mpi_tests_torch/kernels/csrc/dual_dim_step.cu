// Both-axis 5-point derivatives and their sum-of-squares residual from
// one read of a block ghosted along both axes (the 2-D process grid's
// per-shard step).
//
// Replaces the Pallas kernel dual_dim_step_pallas
// (tpu_mpi_tests/kernels/pallas_kernels.py:1624; body _dual_step_kernel
// :1520), both of its bodies: the raw-tap one (the default, :1618) and
// the `lean` one (:1547-1565, :1591).
//
// What it computes, for z of shape (n0, n1), m0 = n0-4, m1 = n1-4:
//     dz_dx[i,j] = (((c0*z[i,j+2] + c1*z[i+1,j+2]) + c3*z[i+3,j+2])
//                   + c4*z[i+4,j+2]) * sx
//     dz_dy[i,j] = (((c0*z[i+2,j] + c1*z[i+2,j+1]) + c3*z[i+2,j+3])
//                   + c4*z[i+2,j+4]) * sy
// (the zero tap skipped, the tap order of stencil_deriv.cu and of the
// plain torch stencil), both (m0, m1), and the residual
//     sum(dz_dx^2) + sum(dz_dy^2),
// each square rounded to the array dtype as torch.square rounds it.
//
// The lean body computes the same derivatives in difference form with
// the per-axis scale folded into two coefficients,
//     dz_dx[i,j] = c1x*(z[i+3,j+2] - z[i+1,j+2]) + c2x*(z[i+4,j+2] - z[i,j+2])
//     dz_dy[i,j] = c1y*(z[i+2,j+3] - z[i+2,j+1]) + c2y*(z[i+2,j+4] - z[i+2,j])
// (c1 = dtype(f32(s)*f32(C1)), c2 = dtype(f32(s)*f32(C2)), folded by the
// wrapper), and ONE fused residual sum(dz_dx^2 + dz_dy^2), the squares
// and their sum taken in the accumulation type without rounding to the
// array dtype, the total rounded once.
//
// Design. Pass 1: a CTA owns TR x TC outputs of both derivatives; it
// loads its (TR+4) x (TC+4) window into shared memory once and computes
// both from there, and each thread sums its squares (f32 for f32 and
// bf16, f64 for f64). A fixed-order tree over the block gives one
// partial per axis, written to a small buffer — no atomics. Pass 2, one
// CTA: each thread sums a fixed stride of the partials, a tree finishes,
// and each axis's sum is rounded to the array dtype before the two are
// added, as the plain version's two torch.sum calls and its add round.
// So the residual is the same from run to run (the TPU kernel likewise
// writes per-block partials and sums them outside, :1689).
//
// Bound on the H100: memory. One read of z and two writes of (m0, m1):
// 12 bytes per output point in f32 against ~20 flops, ~1.7 flop/byte.
#include <climits>
#include <cstdint>

#include "stencil_common.cuh"

namespace tpumt {
namespace {

constexpr int TR = 32;   // output rows per CTA
constexpr int TC = 128;  // output columns per CTA
constexpr int BX = 32;
constexpr int BY = 8;
constexpr int kThreads = BX * BY;
constexpr int kWR = TR + 4;
constexpr int kWC = TC + 4;
constexpr int kReduceThreads = 1024;

// accumulation type of the residual: f64 for f64, f32 otherwise
template <typename T>
struct Acc {
  using A = float;
};
template <>
struct Acc<double> {
  using A = double;
};

template <typename A, int N>
__device__ A block_sum(A v, A* scratch) {
  // fixed-order tree: the result depends on nothing but the inputs
  const int t = threadIdx.y * blockDim.x + threadIdx.x;
  scratch[t] = v;
  __syncthreads();
  for (int h = N / 2; h > 0; h >>= 1) {
    if (t < h) scratch[t] = scratch[t] + scratch[t + h];
    __syncthreads();
  }
  const A r = scratch[0];
  __syncthreads();
  return r;
}

template <typename T, bool LEAN>
__global__ void __launch_bounds__(kThreads)
    dual_kernel(const T* __restrict__ z, T* __restrict__ dx,
                T* __restrict__ dy, typename Acc<T>::A* __restrict__ part,
                long long n0, long long n1, typename Elt<T>::C c0,
                typename Elt<T>::C c1, typename Elt<T>::C c3,
                typename Elt<T>::C c4, typename Elt<T>::C sx,
                typename Elt<T>::C sy, long long tiles_c) {
  using E = Elt<T>;
  using C = typename E::C;
  using A = typename Acc<T>::A;
  __shared__ C win[kWR * kWC];
  __shared__ A scratch[kThreads];
  const long long m0 = n0 - 4, m1 = n1 - 4;
  const long long tile = blockIdx.x;
  const long long i0 = (tile / tiles_c) * TR;  // first output row
  const long long j0 = (tile % tiles_c) * TC;  // first output column
  const int tx = threadIdx.x, ty = threadIdx.y;

  // window position (p, q) holds z[i0 + p, j0 + q]
  for (int p = ty; p < kWR; p += BY) {
    const long long r = i0 + p;
    for (int q = tx; q < kWC; q += BX) {
      const long long c = j0 + q;
      win[p * kWC + q] = (r < n0 && c < n1) ? E::load(z + r * n1 + c) : C(0);
    }
  }
  __syncthreads();

  A sum_x = A(0), sum_y = A(0);
  for (int p = ty; p < TR; p += BY) {
    const long long i = i0 + p;
    if (i >= m0) break;
    for (int q = tx; q < TC; q += BX) {
      const long long j = j0 + q;
      if (j >= m1) break;
      const C* px = win + p * kWC + q + 2;  // column j+2, rows i..i+4
      const C* py = win + (p + 2) * kWC + q;  // row i+2, columns j..j+4
      C vx, vy;
      if (LEAN) {
        // c0, c1 hold (c1x, c2x) and c3, c4 hold (c1y, c2y)
        vx = E::add(E::mul(c0, E::sub(px[3 * kWC], px[kWC])),
                    E::mul(c1, E::sub(px[4 * kWC], px[0])));
        vy = E::add(E::mul(c3, E::sub(py[3], py[1])),
                    E::mul(c4, E::sub(py[4], py[0])));
      } else {
        C ax = E::mul(c0, px[0]);
        ax = E::add(ax, E::mul(c1, px[kWC]));
        ax = E::add(ax, E::mul(c3, px[3 * kWC]));
        ax = E::add(ax, E::mul(c4, px[4 * kWC]));
        vx = E::mul(ax, sx);
        C ay = E::mul(c0, py[0]);
        ay = E::add(ay, E::mul(c1, py[1]));
        ay = E::add(ay, E::mul(c3, py[3]));
        ay = E::add(ay, E::mul(c4, py[4]));
        vy = E::mul(ay, sy);
      }
      dx[i * m1 + j] = E::store(vx);
      dy[i * m1 + j] = E::store(vy);
      if (LEAN) {
        // one fused sum, squares kept in the accumulation type
        const A ax2 = static_cast<A>(vx) * static_cast<A>(vx);
        const A ay2 = static_cast<A>(vy) * static_cast<A>(vy);
        sum_x = sum_x + (ax2 + ay2);
      } else {
        sum_x = sum_x + static_cast<A>(E::mul(vx, vx));
        sum_y = sum_y + static_cast<A>(E::mul(vy, vy));
      }
    }
  }
  const A bx = block_sum<A, kThreads>(sum_x, scratch);
  const A by = block_sum<A, kThreads>(sum_y, scratch);
  if (tx == 0 && ty == 0) {
    part[2 * tile] = bx;
    part[2 * tile + 1] = by;
  }
}

template <typename T, bool LEAN>
__global__ void __launch_bounds__(kReduceThreads)
    reduce_kernel(const typename Acc<T>::A* __restrict__ part,
                  long long n_part, T* __restrict__ res) {
  using E = Elt<T>;
  using A = typename Acc<T>::A;
  __shared__ A scratch[kReduceThreads];
  A sx = A(0), sy = A(0);
  for (long long k = threadIdx.x; k < n_part; k += kReduceThreads) {
    sx = sx + part[2 * k];
    sy = sy + part[2 * k + 1];
  }
  const A tx = block_sum<A, kReduceThreads>(sx, scratch);
  const A ty = block_sum<A, kReduceThreads>(sy, scratch);
  if (threadIdx.x == 0 && LEAN) {
    // the one fused sum (the y partials are zero), rounded once
    *res = E::store(static_cast<typename E::C>(tx));
  } else if (threadIdx.x == 0) {
    // each sum rounded to the array dtype, then added in it (the plain
    // version's torch.sum(...) + torch.sum(...))
    const auto rx = E::store(static_cast<typename E::C>(tx));
    const auto ry = E::store(static_cast<typename E::C>(ty));
    *res = E::store(E::add(E::load(&rx), E::load(&ry)));
  }
}

template <typename T, bool LEAN>
int launch(const void* z, void* dx, void* dy, void* part, void* res,
           long long n0, long long n1, const double* c, double sx, double sy,
           cudaStream_t stream) {
  using E = Elt<T>;
  using A = typename Acc<T>::A;
  const long long m0 = n0 - 4, m1 = n1 - 4;
  if (m0 <= 0 || m1 <= 0) return cudaErrorInvalidValue;
  const long long tiles_c = (m1 + TC - 1) / TC;
  const long long tiles = ((m0 + TR - 1) / TR) * tiles_c;
  if (tiles > INT_MAX) return cudaErrorInvalidConfiguration;
  dual_kernel<T, LEAN>
      <<<static_cast<unsigned>(tiles), dim3(BX, BY), 0, stream>>>(
      static_cast<const T*>(z), static_cast<T*>(dx), static_cast<T*>(dy),
      static_cast<A*>(part), n0, n1, E::coef(c[0]), E::coef(c[1]),
      E::coef(c[3]), E::coef(c[4]), E::coef(sx), E::coef(sy), tiles_c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_kernel<T, LEAN><<<1, kReduceThreads, 0, stream>>>(
      static_cast<const A*>(part), tiles, static_cast<T*>(res));
  return cudaGetLastError();
}

}  // namespace
}  // namespace tpumt

// Number of residual partials pass 1 writes (two values each): the
// wrapper allocates that many pairs of the accumulation type.
extern "C" long long tpumt_dual_dim_step_tiles(long long n0, long long n1) {
  using namespace tpumt;
  const long long m0 = n0 - 4, m1 = n1 - 4;
  if (m0 <= 0 || m1 <= 0) return 0;
  return ((m0 + TR - 1) / TR) * ((m1 + TC - 1) / TC);
}

// Plain C entry point (bound with ctypes). Returns a cudaError_t: 0 when
// both launches were accepted. `c0..c4`, `sx` and `sy` arrive already
// rounded to the array dtype; `c2` (the zero tap) is skipped. With
// `lean` != 0 the lean body runs and (c0, c1, c3, c4) carry its folded
// coefficients (c1x, c2x, c1y, c2y); `sx` and `sy` are then unused. `part`
// holds 2 * tpumt_dual_dim_step_tiles(n0, n1) values of the accumulation
// type (double for float64, float otherwise); `res` is one element of
// the array dtype.
extern "C" int tpumt_dual_dim_step(const void* z, void* dx, void* dy,
                                   void* part, void* res, int dtype,
                                   long long n0, long long n1, double c0,
                                   double c1, double c2, double c3, double c4,
                                   double sx, double sy, int lean,
                                   void* stream) {
  using namespace tpumt;
  const double c[5] = {c0, c1, c2, c3, c4};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TPUMT_DUAL(T)                                                      \
  (lean ? launch<T, true>(z, dx, dy, part, res, n0, n1, c, sx, sy, s)     \
        : launch<T, false>(z, dx, dy, part, res, n0, n1, c, sx, sy, s))
  switch (dtype) {
    case kF32:
      return TPUMT_DUAL(float);
    case kF64:
      return TPUMT_DUAL(double);
    case kBF16:
      return TPUMT_DUAL(__nv_bfloat16);
    default:
      return cudaErrorInvalidValue;
  }
#undef TPUMT_DUAL
}
