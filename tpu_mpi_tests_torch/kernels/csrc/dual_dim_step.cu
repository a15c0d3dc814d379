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
// Two routes (hand.DUAL_ROUTES; a route's code is its index), named by
// the operand (hand.dual_route, dual_route here); each a pass over z
// that writes both derivatives and one residual partial a CTA, then a
// one-CTA pass over the partials.
//
// "regs" (dual_regs_kernel), bfloat16 where every row of z starts on 4
// elements (z on 8 bytes, n1 % 4 == 0; then so do the outputs' rows,
// n1 - 4 wide): a thread owns E = kDualElems (8) output columns and walks
// a run of output rows down them. Each z row it needs is loaded once, z
// columns j0 .. j0 + E + 3 for outputs j0 .. j0 + E - 1, as aligned
// 4-element pieces (8 bytes; the last is also its right neighbour's
// first, which the L1 serves), the first two as one 16-byte vector where
// z's rows start on 16 bytes; its stores are 16 bytes where the outputs'
// rows do (the two never both do: n1 and n1 - 4 differ by 8 bytes). A
// row whose m1 is not a multiple of E ends on a thread that owns E - 4
// columns. dz_dy of row i comes from z row i + 2's E + 4 elements, dz_dx
// from the 5-row window of rows i .. i + 4 kept in registers (a ring of
// register rows, the next kDualPrefetch rows loaded ahead; dz_dy is done
// as a row is first used, so only its centre words stay in the window).
// No shared memory and no barrier but the partial's tree. The arithmetic
// is add/sub/mul.rn.bf16x2 (Pk<T>), bit-equal to float-then-round;
// squares and sums in float32, rounded where the plain version rounds
// (raw: each square to the dtype; lean: none; the lean body's dz_dx and
// dz_dy squares summed apart and added once). Runs are sized so that the
// grid fills the card once (the occupancy API's resident CTAs), at most
// ceil(m0 / kDualRunRows) of them. float32 stays on smem: the same walk
// in float32 (4 columns a thread, 16-byte pieces) ran 1-2 % behind the
// tile body at 8196² and 4104² on the H100, both at the card's rate for
// one read and two write streams (kernels/dual_ab.py).
//
// "smem" (dual_kernel; float32, float64, and bfloat16 rows off 4
// elements): a CTA owns TR x TC outputs of both derivatives; it loads its
// (TR+4) x (TC+4) window into shared memory once and computes both from
// there.
//
// Either way each thread sums its squares (f32 for f32 and bf16, f64 for
// f64) in a fixed order, a fixed-order tree over the CTA gives one
// partial per axis, written to a small buffer — no atomics. The second
// pass, one CTA: each thread sums a fixed stride of the partials, a tree
// finishes, and each axis's sum is rounded to the array dtype before the
// two are added, as the plain version's two torch.sum calls and its add
// round. So the residual is the same from run to run (the TPU kernel
// likewise writes per-block partials and sums them outside, :1689).
//
// Bound on the H100: memory. One read of z and two writes of (m0, m1):
// 12 bytes per output point in f32 against ~20 flops, ~1.7 flop/byte.
#include <climits>
#include <cstdint>
#include <type_traits>

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
    // the one sum of both squares (the smem route's y partials are zero,
    // the regs route's hold dz_dy's squares), rounded once
    *res = E::store(static_cast<typename E::C>(tx + ty));
  } else if (threadIdx.x == 0) {
    // each sum rounded to the array dtype, then added in it (the plain
    // version's torch.sum(...) + torch.sum(...))
    const auto rx = E::store(static_cast<typename E::C>(tx));
    const auto ry = E::store(static_cast<typename E::C>(ty));
    *res = E::store(E::add(E::load(&rx), E::load(&ry)));
  }
}

// ---------------------------------------------------------------------------
// the regs route
// ---------------------------------------------------------------------------

enum DualRoute : int { kDualSmem = 0, kDualRegs = 1 };

// The route's compile-time choices (kernels/dual_ab.py varies them).
constexpr int kDualRowElems = 4;       // elements a piece: the rows' alignment
constexpr int kDualElems = 8;          // output columns a thread
constexpr int kDualRegsThreads = 256;  // threads a CTA
constexpr int kDualRunRows = 16;       // runs at most ceil(m0 / this)
constexpr int kDualPrefetch = 6;       // rows loaded ahead of the newest used
// the ring's slots: the 5-row window and the rows in flight (row t of the
// walk in slot t % kDualSlots)
constexpr int kDualSlots = 5 + kDualPrefetch;

static_assert(kDualElems == 4 || kDualElems == 8);

// The rule (hand.dual_route): regs for bfloat16 where every row of z
// starts on 4 elements; smem otherwise.
inline int dual_route(int dtype, const void* z, long long n1) {
  if (dtype != kBF16) return kDualSmem;
  return reinterpret_cast<std::uintptr_t>(z) % (2 * kDualRowElems) == 0 &&
                 n1 % kDualRowElems == 0
             ? kDualRegs
             : kDualSmem;
}

using Bf = __nv_bfloat16;
using Bw = Pk<Bf>::W;  // a word: two elements
constexpr int kPieceWords = kDualRowElems / Pk<Bf>::kElems;

template <typename V, typename W>
__device__ __forceinline__ void ld_vec(const void* p, W* x) {
  const V u = __ldg(static_cast<const V*>(p));
  memcpy(x, &u, sizeof(V));
}
template <typename V, typename W>
__device__ __forceinline__ void st_vec(void* p, const W* x) {
  V u;
  memcpy(&u, x, sizeof(V));
  *static_cast<V*>(p) = u;
}

// The E + 4 elements z[., j0 .. j0 + E + 3] of one row into words, an
// 8-byte vector a piece; the first two pieces as one 16-byte vector where
// `wide` (z's rows on 16 bytes). The last piece is loaded only where
// `full`: a row's last thread owns E - 4 outputs when the row's m1 is
// not a multiple of E (its words stay zero and feed no output).
__device__ __forceinline__ void ld_row(const Bf* p, bool wide, bool full,
                                       Bw* x) {
  constexpr int NP = kDualElems / kDualRowElems + 1;
  constexpr bool kPair = NP > 2;  // pieces 0, 1 paired
  if constexpr (kPair) {
    if (wide) {
      ld_vec<uint4>(p, x);
    } else {
      ld_vec<uint2>(p, x);
      ld_vec<uint2>(p + kDualRowElems, x + kPieceWords);
    }
  }
#pragma unroll
  for (int k = kPair ? 2 : 0; k < NP; ++k) {
    if (kPair && k == NP - 1 && !full) {
#pragma unroll
      for (int u = 0; u < kPieceWords; ++u)
        x[k * kPieceWords + u] = Pk<Bf>::of(0u);
    } else {
      ld_vec<uint2>(p + k * kDualRowElems, x + k * kPieceWords);
    }
  }
}

// The E outputs of one row from words: one 16-byte vector where `wide`
// (the outputs' rows on 16 bytes, so every thread is full), else an
// 8-byte vector a piece, a thread that is not `full` storing its first
// E - 4.
__device__ __forceinline__ void st_row(Bf* p, bool wide, bool full,
                                       const Bw* y) {
  constexpr int NP = kDualElems / kDualRowElems;
  if constexpr (NP == 2) {
    if (wide) {
      st_vec<uint4>(p, y);
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < NP; ++k)
    if (k < NP - 1 || NP == 1 || full)
      st_vec<uint2>(p + k * kDualRowElems, y + k * kPieceWords);
}

// One (vector, run) item a thread: output columns E*v .. E*v + E - 1
// (E = kDualElems), output rows [q*rr, min((q + 1)*rr, m0)). c0..c4 as
// dual_kernel takes them; `wide_z` / `wide_o`: z's / the outputs' rows
// start on 16 bytes. T is bfloat16.
template <typename T, bool LEAN>
__global__ void __launch_bounds__(kDualRegsThreads)
    dual_regs_kernel(const T* __restrict__ z, T* __restrict__ dx,
                     T* __restrict__ dy, float* __restrict__ part,
                     long long n0, long long n1, float c0f, float c1f,
                     float c3f, float c4f, float sxf, float syf, int nv,
                     int runs, int rr, int wide_z, int wide_o) {
  static_assert(std::is_same_v<T, Bf>);
  using P = Pk<T>;
  using Wd = Bw;
  constexpr int E = kDualElems;
  constexpr int NW = E / P::kElems;      // words of outputs
  constexpr int LW = NW + kPieceWords;   // words of z a row
  constexpr int HE = 2 / P::kElems;      // words of 2 elements
  __shared__ float scratch[kDualRegsThreads];
  const long long m0 = n0 - 4, m1 = n1 - 4;
  const Wd c0 = P::splat(c0f), c1 = P::splat(c1f), c3 = P::splat(c3f),
           c4 = P::splat(c4f), sx = P::splat(sxf), sy = P::splat(syf);
  float sum_x = 0.f, sum_y = 0.f;
  const long long item =
      static_cast<long long>(blockIdx.x) * kDualRegsThreads + threadIdx.x;
  if (item < static_cast<long long>(nv) * runs) {
    const long long j0 = (item % nv) * E;
    const bool full = E == kDualRowElems || j0 + E <= m1;
    const long long a0 = (item / nv) * rr;
    const long long a1 = a0 + rr < m0 ? a0 + rr : m0;
    const long long n_walk = a1 - a0 + 4;  // z rows a0 .. a1 + 3
    const T* zc = z + a0 * n1 + j0;
    // slot t % kDualSlots holds z row a0 + t, loaded kDualPrefetch rows
    // before its window uses it
    constexpr int S = kDualSlots;
    Wd win[S][LW];
#pragma unroll
    for (int p = 0; p < kDualPrefetch; ++p)
      if (p < n_walk) ld_row(zc + p * n1, wide_z, full, win[p]);
    for (long long t0 = 0; t0 < n_walk; t0 += S) {
#pragma unroll
      for (int ph = 0; ph < S; ++ph) {
        const long long t = t0 + ph;
        if (t >= n_walk) break;
        if (t + kDualPrefetch < n_walk)
          ld_row(zc + (t + kDualPrefetch) * n1, wide_z, full,
                       win[(ph + kDualPrefetch) % S]);
        const Wd* r4 = win[ph];  // z row a0 + t, all E + 4 elements
        if (t >= 2 && t < n_walk - 2) {
          // dz_dy of output row a0 + t - 2 from z row a0 + t: after it
          // only the row's centre words stay live
          Wd oy[NW];
#pragma unroll
          for (int u = 0; u < NW; ++u) {
            const int x = HE + u;
            // a thread that is not full owns the first E - 4 outputs
            const bool live = full || u < NW - kPieceWords;
            const Wd w2 = pk_at<T, -2>(r4, x), w1 = pk_at<T, -1>(r4, x);
            const Wd e1 = pk_at<T, 1>(r4, x), e2 = pk_at<T, 2>(r4, x);
            Wd vy;
            if constexpr (LEAN) {
              vy = P::add(P::mul(c3, P::sub(e1, w1)),
                          P::mul(c4, P::sub(e2, w2)));
              // squares in float32, summed apart from dz_dx's and added
              // to them once (the reduce pass)
              const float2 fy = P::f2(vy);
              if (live) sum_y = sum_y + fy.x * fy.x + fy.y * fy.y;
            } else {
              Wd ay = P::mul(c0, w2);
              ay = P::add(ay, P::mul(c1, w1));
              ay = P::add(ay, P::mul(c3, e1));
              ay = P::add(ay, P::mul(c4, e2));
              vy = P::mul(ay, sy);
              // each square rounded to the dtype, as torch.square rounds
              const float2 qy = P::f2(P::mul(vy, vy));
              if (live) sum_y = sum_y + qy.x + qy.y;
            }
            oy[u] = vy;
          }
          st_row(dy + (a0 + t - 2) * m1 + j0, wide_o, full, oy);
        }
        if (t < 4) continue;
        // dz_dx of output row a0 + t - 4: the centre words (column j + 2)
        // of z rows t - 4 .. t
        const Wd* r0 = win[(ph + S - 4) % S];
        const Wd* r1 = win[(ph + S - 3) % S];
        const Wd* r3 = win[(ph + S - 1) % S];
        Wd ox[NW];
#pragma unroll
        for (int u = 0; u < NW; ++u) {
          const int x = HE + u;
          const bool live = full || u < NW - kPieceWords;
          Wd vx;
          if constexpr (LEAN) {
            // c0, c1 hold (c1x, c2x) and c3, c4 hold (c1y, c2y)
            vx = P::add(P::mul(c0, P::sub(r3[x], r1[x])),
                        P::mul(c1, P::sub(r4[x], r0[x])));
            const float2 fx = P::f2(vx);
            if (live) sum_x = sum_x + fx.x * fx.x + fx.y * fx.y;
          } else {
            Wd ax = P::mul(c0, r0[x]);
            ax = P::add(ax, P::mul(c1, r1[x]));
            ax = P::add(ax, P::mul(c3, r3[x]));
            ax = P::add(ax, P::mul(c4, r4[x]));
            vx = P::mul(ax, sx);
            const float2 qx = P::f2(P::mul(vx, vx));
            if (live) sum_x = sum_x + qx.x + qx.y;
          }
          ox[u] = vx;
        }
        st_row(dx + (a0 + t - 4) * m1 + j0, wide_o, full, ox);
      }
    }
  }
  const float bx = block_sum<float, kDualRegsThreads>(sum_x, scratch);
  const float by = block_sum<float, kDualRegsThreads>(sum_y, scratch);
  if (threadIdx.x == 0) {
    part[2 * blockIdx.x] = bx;
    part[2 * blockIdx.x + 1] = by;
  }
}

// The regs route's grid at (n0, n1): (vectors a row, runs, rows a run,
// CTAs). Runs: as many as the card's resident threads give each column
// of vectors (the occupancy API), at most ceil(m0 / kDualRunRows).
template <bool LEAN>
cudaError_t regs_grid(long long n0, long long n1, int* nv, int* runs,
                      int* rr, int* ctas) {
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t rc = cudaGetDevice(&dev);
    if (rc == cudaSuccess)
      rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc == cudaSuccess)
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, dual_regs_kernel<Bf, LEAN>, kDualRegsThreads, 0);
    if (rc != cudaSuccess) return rc;
    if (per_sm < 1) return cudaErrorLaunchOutOfResources;
    resident = per_sm * sms;
  }
  const long long m0 = n0 - 4, m1 = n1 - 4;
  if (m0 <= 0 || m1 <= 0 || m1 % kDualRowElems != 0)
    return cudaErrorInvalidValue;
  const long long v = (m1 + kDualElems - 1) / kDualElems;
  long long q = static_cast<long long>(resident) * kDualRegsThreads / v;
  const long long most = (m0 + kDualRunRows - 1) / kDualRunRows;
  if (q > most) q = most;
  if (q < 1) q = 1;
  const long long r = (m0 + q - 1) / q;
  q = (m0 + r - 1) / r;
  const long long c = (v * q + kDualRegsThreads - 1) / kDualRegsThreads;
  if (v > INT_MAX || c > INT_MAX) return cudaErrorInvalidConfiguration;
  *nv = static_cast<int>(v);
  *runs = static_cast<int>(q);
  *rr = static_cast<int>(r);
  *ctas = static_cast<int>(c);
  return cudaSuccess;
}

inline bool on16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

template <typename T, bool LEAN>
int launch(int route, const void* z, void* dx, void* dy, void* part,
           void* res, long long n0, long long n1, const double* c,
           double sx, double sy, cudaStream_t stream) {
  using E = Elt<T>;
  using A = typename Acc<T>::A;
  const long long m0 = n0 - 4, m1 = n1 - 4;
  if (m0 <= 0 || m1 <= 0) return cudaErrorInvalidValue;
  long long n_part = 0;
  if constexpr (!std::is_same_v<T, Bf>) {
    if (route != kDualSmem) return cudaErrorInvalidValue;
  } else if (route == kDualRegs) {
    int nv = 0, runs = 0, rr = 0, ctas = 0;
    const cudaError_t rc =
        regs_grid<LEAN>(n0, n1, &nv, &runs, &rr, &ctas);
    if (rc != cudaSuccess) return rc;
    dual_regs_kernel<T, LEAN><<<ctas, kDualRegsThreads, 0, stream>>>(
        static_cast<const T*>(z), static_cast<T*>(dx), static_cast<T*>(dy),
        static_cast<float*>(part), n0, n1, E::coef(c[0]), E::coef(c[1]),
        E::coef(c[3]), E::coef(c[4]), E::coef(sx), E::coef(sy), nv, runs,
        rr, on16(z) && (n1 * sizeof(T)) % 16 == 0 ? 1 : 0,
        on16(dx) && on16(dy) && (m1 * sizeof(T)) % 16 == 0 ? 1 : 0);
    n_part = ctas;
  }
  if (route == kDualSmem) {
    const long long tiles_c = (m1 + TC - 1) / TC;
    const long long tiles = ((m0 + TR - 1) / TR) * tiles_c;
    if (tiles > INT_MAX) return cudaErrorInvalidConfiguration;
    dual_kernel<T, LEAN>
        <<<static_cast<unsigned>(tiles), dim3(BX, BY), 0, stream>>>(
        static_cast<const T*>(z), static_cast<T*>(dx), static_cast<T*>(dy),
        static_cast<A*>(part), n0, n1, E::coef(c[0]), E::coef(c[1]),
        E::coef(c[3]), E::coef(c[4]), E::coef(sx), E::coef(sy), tiles_c);
    n_part = tiles;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_kernel<T, LEAN><<<1, kReduceThreads, 0, stream>>>(
      static_cast<const A*>(part), n_part, static_cast<T*>(res));
  return cudaGetLastError();
}

}  // namespace
}  // namespace tpumt

// The route of z (hand.dual_route): 1 regs, 0 smem.
extern "C" int tpumt_dual_dim_step_route(int dtype, const void* z,
                                         long long n1) {
  return tpumt::dual_route(dtype, z, n1);
}

// Number of residual partials pass 1 writes on `route` (two values
// each): the wrapper allocates that many pairs of the accumulation type.
// 0 on error.
extern "C" long long tpumt_dual_dim_step_parts(int dtype, long long n0,
                                               long long n1, int route,
                                               int lean) {
  using namespace tpumt;
  const long long m0 = n0 - 4, m1 = n1 - 4;
  if (m0 <= 0 || m1 <= 0) return 0;
  if (route == kDualSmem)
    return ((m0 + TR - 1) / TR) * ((m1 + TC - 1) / TC);
  if (dtype != kBF16) return 0;
  int nv = 0, runs = 0, rr = 0, ctas = 0;
  const cudaError_t rc =
      lean ? regs_grid<true>(n0, n1, &nv, &runs, &rr, &ctas)
           : regs_grid<false>(n0, n1, &nv, &runs, &rr, &ctas);
  return rc == cudaSuccess ? ctas : 0;
}

// Plain C entry point (bound with ctypes). Returns a cudaError_t: 0 when
// both launches were accepted. `c0..c4`, `sx` and `sy` arrive already
// rounded to the array dtype; `c2` (the zero tap) is skipped. With
// `lean` != 0 the lean body runs and (c0, c1, c3, c4) carry its folded
// coefficients (c1x, c2x, c1y, c2y); `sx` and `sy` are then unused. `part`
// holds 2 * tpumt_dual_dim_step_parts(...) values of the accumulation
// type (double for float64, float otherwise); `res` is one element of
// the array dtype. `route` is the route tpumt_dual_dim_step_route names
// (any other is refused).
extern "C" int tpumt_dual_dim_step(const void* z, void* dx, void* dy,
                                   void* part, void* res, int dtype,
                                   long long n0, long long n1, double c0,
                                   double c1, double c2, double c3, double c4,
                                   double sx, double sy, int lean, int route,
                                   void* stream) {
  using namespace tpumt;
  if (route != dual_route(dtype, z, n1)) return cudaErrorInvalidValue;
  const double c[5] = {c0, c1, c2, c3, c4};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TPUMT_DUAL(T)                                                        \
  (lean ? launch<T, true>(route, z, dx, dy, part, res, n0, n1, c, sx, sy, s) \
        : launch<T, false>(route, z, dx, dy, part, res, n0, n1, c, sx, sy,  \
                           s))
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
