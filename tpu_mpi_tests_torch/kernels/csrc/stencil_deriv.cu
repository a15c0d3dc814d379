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
// Two bodies, two routes (hand.DERIV_ROUTES; a route's code is its
// index), named by the wrapper (hand.deriv_route) and checked here:
//
// "regs" (deriv_regs_dim0, deriv_regs_dim1), where every row of z and of
// out starts on 16 or 8 bytes (deriv_vec_bytes: both start there and both
// row pitches are whole vectors): every input row read once from device
// memory, in vectors. Along dim 0 a thread owns one column vector and walks
// a run of output rows with a 5-row register window (a ring of register
// rows, row t of the walk in slot t % kDerivSlots), the loads of the next
// kDerivPrefetch rows in flight before a row's arithmetic and store, so a
// column is read once plus 4 apron rows a run. Along dim 1 a warp owns a
// row segment of 32 output vectors, one a lane, and walks a run of rows
// down it (the same prefetch ring), each row's 4 elements right of a lane's
// vector taken from the lanes after it by warp shuffles, and past the
// segment's end from the next segment's first vectors, which the first
// lanes load beside their own (an L2 hit: that segment's warp loads them
// too). Either way the runs are as many as one wave of the card's resident
// CTAs holds (the occupancy API), none shorter than kDerivRunRows. bfloat16
// runs packed (Pk<T>: mul/add.rn.bf16x2, two elements an instruction, each
// correctly rounded, which is what float-then-round gives).
//
// "scalar" (deriv_kernel), any other operand: one thread per output
// column, a grid-stride loop over output rows; each output point is 4
// loads that coalesce across the warp (dim 0: neighbouring rows of the
// same columns; dim 1: neighbouring columns, served from L1).
//
// Bound on the H100: memory — 8 lone ops per output point (nothing
// contracts under -fmad=false) against one read and one write of an
// element (8 bytes in f32), ~1 op/byte.
#include <climits>
#include <cstdint>
#include <cstring>

#include "occupancy.cuh"
#include "stencil_common.cuh"

namespace tpumt {

enum DerivRoute : int { kDerivScalar = 0, kDerivRegs = 1 };

// The regs route's compile-time choices (kernels/heat_ab.py varies each).
constexpr int kDerivPrefetch = 8;   // rows in flight ahead of the one entering
constexpr int kDerivRunRows = 64;   // dim 0: the shortest run a thread walks
constexpr int kDerivThreads = 256;  // threads a CTA
// the slots of the prefetch ring and of the dim-0 window (row t of the
// walk in slot t % kDerivSlots): the rows in flight, and five a window
constexpr int kDerivSlots = 10;
static_assert(kDerivPrefetch >= 1 && kDerivPrefetch < kDerivSlots &&
                  kDerivSlots >= 5,
              "rows in flight");
constexpr int kTaps = 4;  // the nonzero taps' reach: z[i] .. z[i + 4]

// The regs route's vector for z and out along `dim`: 16 bytes where every
// row of both starts on 16 (both start there and both row pitches, n1 and
// out's n1 - 4 along dim 1, are whole 16-byte vectors), else 8 where
// every row starts on 8, else 0.
inline int deriv_vec_bytes(int dim, const void* z, const void* out,
                           long long n1, int itemsize) {
  const long long m1 = dim == 0 ? n1 : n1 - kTaps;  // out's row
  for (int b = 16; b >= 8; b /= 2)
    if (rows_start_on(b, z, out, n1 * itemsize, m1 * itemsize)) return b;
  return 0;
}

// The rule (hand.deriv_route): regs where deriv_vec_bytes finds a vector,
// else scalar.
inline int deriv_route(int dim, const void* z, const void* out, long long n1,
                       int itemsize) {
  if (deriv_vec_bytes(dim, z, out, n1, itemsize) == 0) return kDerivScalar;
  return kDerivRegs;
}

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

// ---------------------------------------------------------------------------
// the regs route
// ---------------------------------------------------------------------------

// The taps z0, z1, z3, z4 of a word's outputs and their coefficients, in
// the plain version's order: (((c0*z0 + c1*z1) + c3*z3) + c4*z4)*scale.
template <typename T>
struct DerivTaps {
  using P = Pk<T>;
  using W = typename P::W;
  W c0, c1, c3, c4, scale;
  __device__ DerivTaps(typename Elt<T>::C c0_, typename Elt<T>::C c1_,
                       typename Elt<T>::C c3_, typename Elt<T>::C c4_,
                       typename Elt<T>::C scale_)
      : c0(P::splat(c0_)), c1(P::splat(c1_)), c3(P::splat(c3_)),
        c4(P::splat(c4_)), scale(P::splat(scale_)) {}
  __device__ W operator()(W z0, W z1, W z3, W z4) const {
    W acc = P::mul(c0, z0);
    acc = P::add(acc, P::mul(c1, z1));
    acc = P::add(acc, P::mul(c3, z3));
    acc = P::add(acc, P::mul(c4, z4));
    return P::mul(acc, scale);
  }
};

// The regs route, dim 0: thread (x, y) owns column vector x of run y
// (output rows y * ta .. + ta); rows of z and out `pitch` bytes apart.
template <typename T, int kVB>
__global__ void __launch_bounds__(kDerivThreads)
    deriv_regs_dim0(const T* __restrict__ z, T* __restrict__ out, int m0,
                    long long n1, int ta, typename Elt<T>::C c0_,
                    typename Elt<T>::C c1_, typename Elt<T>::C c3_,
                    typename Elt<T>::C c4_, typename Elt<T>::C scale_) {
  using P = Pk<T>;
  using W = typename P::W;
  using V = typename VecOf<kVB>::V;
  constexpr int E = kVB / sizeof(T);   // elements a vector
  constexpr int NW = kVB / sizeof(W);  // words a vector
  constexpr int S = kDerivSlots;
  const long long v =
      blockIdx.x * static_cast<long long>(kDerivThreads) + threadIdx.x;
  if (v >= n1 / E) return;
  const DerivTaps<T> taps(c0_, c1_, c3_, c4_, scale_);
  const long long pitch = n1 * static_cast<long long>(sizeof(T));
  const char* zc = reinterpret_cast<const char*>(z + v * E);
  char* oc = reinterpret_cast<char*>(out + v * E);
  const int a0 = static_cast<int>(blockIdx.y) * ta;  // the run's first row
  const int stop = a0 + ta < m0 ? a0 + ta : m0;
  const int rows = stop - a0 + kTaps;  // z rows a0 .. stop + 3 enter
  auto load = [&](int t, W* dst) {
    V u{};
    if (t < rows) u = __ldg(reinterpret_cast<const V*>(zc + (a0 + t) * pitch));
    memcpy(dst, &u, kVB);
  };
  W win[S][NW];  // z row a0 + t in slot t % S
  W pre[S][NW];  // the kDerivPrefetch rows loaded ahead
#pragma unroll
  for (int p = 0; p < kDerivPrefetch; ++p) load(p, pre[p]);
  for (int t0 = 0; t0 < rows; t0 += S) {
#pragma unroll
    for (int ph = 0; ph < S; ++ph) {
      const int t = t0 + ph;
      if (t >= rows) break;
      load(t + kDerivPrefetch, pre[(ph + kDerivPrefetch) % S]);
#pragma unroll
      for (int j = 0; j < NW; ++j) win[ph][j] = pre[ph][j];
      if (t < kTaps) continue;
      // output row a0 + t - 4 from z rows a0 + t - 4 .. a0 + t
      auto row = [&](int d) { return win[(ph + S - kTaps + d) % S]; };
      W o[NW];
#pragma unroll
      for (int j = 0; j < NW; ++j)
        o[j] = taps(row(0)[j], row(1)[j], row(3)[j], row(4)[j]);
      V u;
      memcpy(&u, o, kVB);
      *reinterpret_cast<V*>(oc + (a0 + t - kTaps) * pitch) = u;
    }
  }
}

// The regs route, dim 1: a segment is 32 vectors of out from vector
// 32 * seg on, lane L's the segment's vector L (so every store is 32
// consecutive vectors, 512 bytes on 16); the 4 elements right of it are
// words of lanes L + 1 .. L + Av, and past the segment's end of the next
// segment's first Av vectors, which lanes 0 .. Av - 1 load beside their
// own.
template <typename T, int kVB>
struct DerivDim1 {
  using W = typename Pk<T>::W;
  static constexpr int E = kVB / sizeof(T);
  static constexpr int NW = kVB / sizeof(W);
  // words right of a lane's vector its taps reach: the next 4 elements
  static constexpr int H = (kTaps + Pk<T>::kElems - 1) / Pk<T>::kElems;
  static constexpr int Av = (kTaps + E - 1) / E;  // vectors they span
  static_assert(1 + (H - 1) / NW == Av, "the taps reach Av lanes");
};

// Warp w of CTA column blockIdx.x owns segment blockIdx.x *
// (kDerivThreads / 32) + w of run blockIdx.y (rows blockIdx.y * ta ..
// + ta), and walks its rows, the next kDerivPrefetch rows' loads in
// flight before a row's shuffles, arithmetic and store.
template <typename T, int kVB>
__global__ void __launch_bounds__(kDerivThreads)
    deriv_regs_dim1(const T* __restrict__ z, T* __restrict__ out, int n0,
                    long long n1, int segs, int ta, typename Elt<T>::C c0_,
                    typename Elt<T>::C c1_, typename Elt<T>::C c3_,
                    typename Elt<T>::C c4_, typename Elt<T>::C scale_) {
  using P = Pk<T>;
  using W = typename P::W;
  using V = typename VecOf<kVB>::V;
  using G = DerivDim1<T, kVB>;
  constexpr int NW = G::NW;
  constexpr int S = kDerivSlots;
  const int seg = blockIdx.x * (kDerivThreads / 32) + threadIdx.x / 32;
  if (seg >= segs) return;  // the whole warp
  const int lane = threadIdx.x % 32;
  const DerivTaps<T> taps(c0_, c1_, c3_, c4_, scale_);
  const long long v = 32LL * seg + lane;  // this lane's vector
  const long long nv = n1 / G::E;
  // a vector loaded: this lane's, and the next segment's lane-th
  const bool vin = v < nv, xin = lane < G::Av && v + 32 < nv;
  const bool vout = v < (n1 - kTaps) / G::E;
  const long long zpitch = n1 * static_cast<long long>(sizeof(T));
  const long long opitch = (n1 - kTaps) * static_cast<long long>(sizeof(T));
  const char* zb = reinterpret_cast<const char*>(z) + v * kVB;
  char* ob = reinterpret_cast<char*>(out) + v * kVB;
  const int a0 = static_cast<int>(blockIdx.y) * ta;  // the run's first row
  const int rows = (a0 + ta < n0 ? a0 + ta : n0) - a0;
  auto load = [&](int t, W* dst, W* next) {
    V x{}, y{};
    if (t < rows && vin)
      x = __ldg(reinterpret_cast<const V*>(zb + (a0 + t) * zpitch));
    if (t < rows && xin)
      y = __ldg(reinterpret_cast<const V*>(zb + (a0 + t) * zpitch +
                                           32 * kVB));
    memcpy(dst, &x, kVB);
    memcpy(next, &y, kVB);
  };
  // row a0 + t in slot t % S, loaded kDerivPrefetch ahead: this lane's
  // vector and (lanes < Av) the next segment's
  W pre[S][NW], nxt[S][NW];
#pragma unroll
  for (int p = 0; p < kDerivPrefetch; ++p) load(p, pre[p], nxt[p]);
  for (int t0 = 0; t0 < rows; t0 += S) {
#pragma unroll
    for (int ph = 0; ph < S; ++ph) {
      const int t = t0 + ph;
      if (t >= rows) break;
      load(t + kDerivPrefetch, pre[(ph + kDerivPrefetch) % S],
           nxt[(ph + kDerivPrefetch) % S]);
      W e[NW + G::H];
#pragma unroll
      for (int j = 0; j < NW; ++j) e[j] = pre[ph][j];
      // word h right of the vector: word h % NW of lane + q, q = 1 + h /
      // NW, past lane 31 of the next segment's vectors, which lanes below
      // q hand out in place of their own (only the lanes past 31 - q ask
      // them)
#pragma unroll
      for (int h = 0; h < G::H; ++h) {
        const int q = 1 + h / NW;
        e[NW + h] = __shfl_sync(
            0xffffffffu, lane < q ? nxt[ph][h % NW] : pre[ph][h % NW],
            lane + q, 32);
      }
      if (vout) {
        W o[NW];
#pragma unroll
        for (int j = 0; j < NW; ++j)
          o[j] = taps(pk_at<T, 0>(e, j), pk_at<T, 1>(e, j),
                      pk_at<T, 3>(e, j), pk_at<T, 4>(e, j));
        V x;
        memcpy(&x, o, kVB);
        *reinterpret_cast<V*>(ob + (a0 + t) * opitch) = x;
      }
    }
  }
}

// The regs route in vectors of kVB bytes: as many runs as the card's
// resident CTAs hold in one wave (one run a thread along dim 0, a warp
// along dim 1; no loop), none shorter than kDerivRunRows, balanced.
template <typename T, int DIM, int kVB>
int launch_regs_as(const void* z, void* out, long long n0, long long n1,
                   const double* c, double scale, cudaStream_t stream) {
  using E = Elt<T>;
  constexpr int V = kVB / sizeof(T);
  const long long m0 = DIM == 0 ? n0 - kTaps : n0;
  const long long m1 = DIM == 0 ? n1 : n1 - kTaps;
  if (m0 <= 0 || m1 <= 0) return cudaSuccess;
  if (m0 > INT_MAX / 2) return cudaErrorInvalidValue;
  // the kernel, and its CTAs a run: a thread a column vector (dim 0), a
  // warp a segment (dim 1)
  const void* kernel;
  long long cols, segs = 0;
  if constexpr (DIM == 0) {
    kernel = reinterpret_cast<const void*>(deriv_regs_dim0<T, kVB>);
    cols = (n1 / V + kDerivThreads - 1) / kDerivThreads;
  } else {
    kernel = reinterpret_cast<const void*>(deriv_regs_dim1<T, kVB>);
    segs = (m1 / V + 31) / 32;
    cols = (segs + kDerivThreads / 32 - 1) / (kDerivThreads / 32);
  }
  static int resident = 0;
  const cudaError_t rc = coll_resident_ctas(kernel, kDerivThreads, &resident);
  if (rc != cudaSuccess) return rc;
  const long long runs = wave_runs(resident, cols, m0, kDerivRunRows);
  const long long ta = (m0 + runs - 1) / runs;
  if (cols > INT_MAX || runs > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(cols), static_cast<unsigned>(runs));
  if constexpr (DIM == 0) {
    deriv_regs_dim0<T, kVB><<<grid, kDerivThreads, 0, stream>>>(
        static_cast<const T*>(z), static_cast<T*>(out),
        static_cast<int>(m0), n1, static_cast<int>(ta), E::coef(c[0]),
        E::coef(c[1]), E::coef(c[3]), E::coef(c[4]), E::coef(scale));
  } else {
    deriv_regs_dim1<T, kVB><<<grid, kDerivThreads, 0, stream>>>(
        static_cast<const T*>(z), static_cast<T*>(out),
        static_cast<int>(m0), n1, static_cast<int>(segs),
        static_cast<int>(ta), E::coef(c[0]), E::coef(c[1]), E::coef(c[3]),
        E::coef(c[4]), E::coef(scale));
  }
  return cudaGetLastError();
}

template <typename T, int DIM>
int launch_regs(int vb, const void* z, void* out, long long n0, long long n1,
                const double* c, double scale, cudaStream_t stream) {
  if (vb == 16)
    return launch_regs_as<T, DIM, 16>(z, out, n0, n1, c, scale, stream);
  if (vb == 8)
    return launch_regs_as<T, DIM, 8>(z, out, n0, n1, c, scale, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
int launch_route(int route, int dim, const void* z, void* out, long long n0,
                 long long n1, const double* c, double scale,
                 cudaStream_t stream) {
  if (route == kDerivScalar)
    return launch_dim<T>(dim, z, out, n0, n1, c, scale, stream);
  const int vb = deriv_vec_bytes(dim, z, out, n1, sizeof(T));
  if (dim == 0)
    return launch_regs<T, 0>(vb, z, out, n0, n1, c, scale, stream);
  return launch_regs<T, 1>(vb, z, out, n0, n1, c, scale, stream);
}

}  // namespace
}  // namespace tpumt

// Plain C entry point (bound with ctypes). Returns a cudaError_t: 0 when
// the launch was accepted. `c0..c4` and `scale` arrive already rounded to
// the array dtype; `c2` (the zero tap) is skipped. `route` is the
// DerivRoute code that hand.deriv_route names for these pointers, this
// row pitch and `dim` (any other value is refused).
extern "C" int tpumt_stencil2d_deriv(const void* z, void* out, int dtype,
                                     int dim, long long n0, long long n1,
                                     double c0, double c1, double c2,
                                     double c3, double c4, double scale,
                                     int route, void* stream) {
  using namespace tpumt;
  const double c[5] = {c0, c1, c2, c3, c4};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((dim != 0 && dim != 1) ||
      (dtype != kF32 && dtype != kF64 && dtype != kBF16))
    return cudaErrorInvalidValue;
  const int itemsize = dtype == kBF16 ? 2 : dtype == kF64 ? 8 : 4;
  if (route != deriv_route(dim, z, out, n1, itemsize))
    return cudaErrorInvalidValue;
  switch (dtype) {
    case kF32:
      return launch_route<float>(route, dim, z, out, n0, n1, c, scale, s);
    case kF64:
      return launch_route<double>(route, dim, z, out, n0, n1, c, scale, s);
    default:
      return launch_route<__nv_bfloat16>(route, dim, z, out, n0, n1, c,
                                         scale, s);
  }
}
