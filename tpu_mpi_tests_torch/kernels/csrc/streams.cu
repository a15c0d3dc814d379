// The three streaming kernels of the DAXPY pillar and the HBM probes:
//
//   tpumt_daxpy         out = a*x + y         replaces daxpy_pallas
//                       (tpu_mpi_tests/kernels/pallas_kernels.py:84,
//                       body _daxpy_kernel :67)
//   tpumt_stream_scale  out = a*x             replaces stream_scale_pallas
//                       (:144, body _scale_kernel :137), the 2-stream
//                       probe
//   tpumt_stream_sum3   out = (w + x) + y     replaces stream_sum3_pallas
//                       (:190), the 4-stream probe
//
// Rounding: `a` arrives already rounded to the array dtype (as
// jnp.asarray(a, x.dtype) rounds it, :113); every op is one IEEE op via
// the _rn intrinsics (stencil_common.cuh), so the multiply and the add
// are never contracted into an FMA; in bfloat16 each op runs in float
// and is rounded to bf16, as an eager PyTorch op does. The plain
// versions in kernels/hand.py repeat this op for op, so kernel and plain
// version agree bit for bit.
//
// In place: every element is read, then written, by the one thread that
// owns it, so `out` may be the very buffer of any input (out == y is
// daxpy_pallas's inplace=True, out == x stream_scale_pallas's). No
// pointer is __restrict__ for that reason. A partial overlap is refused
// by the wrapper.
//
// Bound on the H100: HBM bytes. daxpy moves 3 streams of n elements for
// 2 flops an element, scale 2 for 1, sum3 4 for 2: far below the card's
// ~20 flop/byte float32 ridge. At 2^26 float32 every stream is 256 MiB,
// five times the 50 MB L2, so nothing is reused; below 2^24 the few µs
// of a launch are most of the time.
//
// Design. Two routes, named by the wrapper (hand.stream_route, the codes
// of hand.COLL_ROUTES) and checked here:
//   "vec16"  every data pointer (operands and out) starts on 16 bytes.
//            A CTA takes one group of kUnroll × kThreads 16-byte packs
//            (4 float, 2 double, 8 bf16) a stream; thread t takes packs
//            t, t + kThreads, ... of it and loads all its packs of every
//            stream before it computes and stores (with aliased pointers
//            the compiler cannot hoist a load above a store, so the loop
//            is written with its loads first). The last, partial group
//            is masked, and the ragged tail (n mod the pack, fewer than
//            8 elements) runs element by element in CTA 0 of the same
//            launch.
//   "scalar" any other operand: one element a thread. No main-path
//            operand takes it.
// The grid is one group a CTA (one element a thread on scalar), sized to
// the work, with no loop, as y.add_ launches; a grid of 2^31 - 1 CTAs
// covers more elements than the card holds.
// kernels/stream_ab.py decided each choice; the designs it lost to are
// patches there, not code here (PERF.md; queued ms, float32, in place,
// NVIDIA H100 80GB HBM3, 700.00 W): the grid was the whole gap to the
// yardsticks — at the occupancy API's resident count, CTAs looping over
// groups (`resident`), daxpy 2^26 read 0.2825 against y.add_'s 0.2666,
// one group a CTA 0.2665; kUnroll 1, 2, 4 and 8 read within 0.6 % of
// each other with either grid, 1 the best on every row (daxpy 0.2650,
// scale 0.1803 against x.mul_'s 0.1814), so bytes in flight were not
// what held the kernels back and a thread takes one pack a stream;
// evict-first hints (`cs`) lost 2-4 % (sum3 0.3620 against 0.3470); the
// bulk-copy ring (`bulk`: cp.async.bulk into shared memory, the op in
// place there, cp.async.bulk out, one CTA an SM) lost 3-5 % at 2^24,
// 2^26 and 2^28; 128 or 512 threads a CTA tie 256. Any n >= 0 works: the
// TPU's multiple-of-128 rule was its lane width.
#include <cstdint>
#include <cstring>
#include <initializer_list>

#include "stencil_common.cuh"

namespace tpumt {
namespace {

constexpr int kThreads = 256;
// 16-byte packs of each stream a thread has in flight on the vec16 route
constexpr int kUnroll = 1;

enum StreamRoute : int { kStreamScalar = 0, kStreamVec16 = 1 };

template <typename T>
struct Daxpy {
  using E = Elt<T>;
  using C = typename E::C;
  static constexpr bool kW = false, kX = true, kY = true;
  C a;
  __device__ C operator()(C, C x, C y) const {
    return E::add(E::mul(a, x), y);
  }
};

template <typename T>
struct Scale {
  using E = Elt<T>;
  using C = typename E::C;
  static constexpr bool kW = false, kX = true, kY = false;
  C a;
  __device__ C operator()(C, C x, C) const { return E::mul(a, x); }
};

template <typename T>
struct Sum3 {
  using E = Elt<T>;
  using C = typename E::C;
  static constexpr bool kW = true, kX = true, kY = true;
  __device__ C operator()(C w, C x, C y) const {
    return E::add(E::add(w, x), y);
  }
};

template <typename T, typename Op>
__device__ __forceinline__ void apply_one(const Op& op, const T* w,
                                          const T* x, const T* y, T* out,
                                          long long i) {
  using E = Elt<T>;
  using C = typename E::C;
  const C cw = Op::kW ? E::load(w + i) : C(0);
  const C cx = Op::kX ? E::load(x + i) : C(0);
  const C cy = Op::kY ? E::load(y + i) : C(0);
  out[i] = E::store(op(cw, cx, cy));
}

// op on the 16 / sizeof(T) elements of one pack of each stream
template <typename T, typename Op>
__device__ __forceinline__ uint4 apply_pack(const Op& op, const uint4& w,
                                            const uint4& x,
                                            const uint4& y) {
  using E = Elt<T>;
  using C = typename E::C;
  constexpr int kN = 16 / sizeof(T);
  T tw[kN], tx[kN], ty[kN], to[kN];
  if (Op::kW) memcpy(tw, &w, 16);
  if (Op::kX) memcpy(tx, &x, 16);
  if (Op::kY) memcpy(ty, &y, 16);
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const C cw = Op::kW ? E::load(&tw[j]) : C(0);
    const C cx = Op::kX ? E::load(&tx[j]) : C(0);
    const C cy = Op::kY ? E::load(&ty[j]) : C(0);
    to[j] = E::store(op(cw, cx, cy));
  }
  uint4 o;
  memcpy(&o, to, 16);
  return o;
}

// The ragged tail past the last whole pack, in CTA 0.
template <typename T, typename Op>
__device__ __forceinline__ void pack_tail(const Op& op, const T* w,
                                          const T* x, const T* y, T* out,
                                          long long n) {
  constexpr int kN = 16 / sizeof(T);
  const long long i = n / kN * kN + threadIdx.x;
  if (blockIdx.x == 0 && i < n) apply_one<T>(op, w, x, y, out, i);
}

// One group of kUnroll × kThreads packs a CTA. The loads go through the
// default path: never the read-only (.nc) one, since `out` may be an
// operand.
template <typename T, typename Op>
__global__ void __launch_bounds__(kThreads)
    stream_vec16_kernel(Op op, const T* w, const T* x, const T* y, T* out,
                        long long n) {
  constexpr long long kGroup = static_cast<long long>(kUnroll) * kThreads;
  const long long packs = n / (16 / sizeof(T));
  const uint4* pw = reinterpret_cast<const uint4*>(w);
  const uint4* px = reinterpret_cast<const uint4*>(x);
  const uint4* py = reinterpret_cast<const uint4*>(y);
  uint4* po = reinterpret_cast<uint4*>(out);
  const long long p0 = blockIdx.x * kGroup + threadIdx.x;
  uint4 vw[kUnroll], vx[kUnroll], vy[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long p = p0 + u * kThreads;
    if (p < packs) {
      if (Op::kW) vw[u] = pw[p];
      if (Op::kX) vx[u] = px[p];
      if (Op::kY) vy[u] = py[p];
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long p = p0 + u * kThreads;
    if (p < packs) po[p] = apply_pack<T>(op, vw[u], vx[u], vy[u]);
  }
  pack_tail<T>(op, w, x, y, out, n);
}

template <typename T, typename Op>
__global__ void __launch_bounds__(kThreads)
    stream_scalar_kernel(Op op, const T* w, const T* x, const T* y, T* out,
                         long long n) {
  const long long i =
      blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  if (i < n) apply_one<T>(op, w, x, y, out, i);
}

// --- launch -----------------------------------------------------------------

// The route the rule gives (hand.stream_route): vec16 when every data
// pointer of the launch starts on 16 bytes (an absent operand is null).
int stream_route(const void* w, const void* x, const void* y,
                 const void* out) {
  for (const void* p : {w, x, y, out})
    if (reinterpret_cast<uintptr_t>(p) % 16) return kStreamScalar;
  return kStreamVec16;
}

// CTAs for `n` elements at `per_cta` a CTA (n >= 1).
int ctas_for(long long n, long long per_cta) {
  return static_cast<int>((n + per_cta - 1) / per_cta);
}

template <typename T, typename Op>
int launch(const Op& op, const void* w, const void* x, const void* y,
           void* out, long long n, int route, cudaStream_t stream) {
  if (n < 0 || route != stream_route(w, x, y, out))
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const T* tw = static_cast<const T*>(w);
  const T* tx = static_cast<const T*>(x);
  const T* ty = static_cast<const T*>(y);
  T* to = static_cast<T*>(out);
  if (route == kStreamVec16) {
    const int ctas =
        ctas_for(n, static_cast<long long>(kUnroll) * kThreads *
                        static_cast<long long>(16 / sizeof(T)));
    stream_vec16_kernel<T, Op><<<ctas, kThreads, 0, stream>>>(op, tw, tx, ty,
                                                              to, n);
  } else {
    stream_scalar_kernel<T, Op><<<ctas_for(n, kThreads), kThreads, 0,
                                  stream>>>(op, tw, tx, ty, to, n);
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace tpumt

// Plain C entry points (bound with ctypes). Each returns a cudaError_t:
// 0 when the launch was accepted. `a` arrives already rounded to the
// array dtype. `out` may be the same buffer as any input, never a
// partial overlap of one. `route` is the StreamRoute code that
// hand.stream_route names for these pointers (any other value is
// refused).

extern "C" int tpumt_daxpy(double a, const void* x, const void* y, void* out,
                           int dtype, long long n, int route, void* stream) {
  using namespace tpumt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch<float>(Daxpy<float>{Elt<float>::coef(a)}, nullptr, x, y,
                           out, n, route, s);
    case kF64:
      return launch<double>(Daxpy<double>{Elt<double>::coef(a)}, nullptr, x,
                            y, out, n, route, s);
    case kBF16:
      return launch<__nv_bfloat16>(
          Daxpy<__nv_bfloat16>{Elt<__nv_bfloat16>::coef(a)}, nullptr, x, y,
          out, n, route, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int tpumt_stream_scale(double a, const void* x, void* out,
                                  int dtype, long long n, int route,
                                  void* stream) {
  using namespace tpumt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch<float>(Scale<float>{Elt<float>::coef(a)}, nullptr, x,
                           nullptr, out, n, route, s);
    case kF64:
      return launch<double>(Scale<double>{Elt<double>::coef(a)}, nullptr, x,
                            nullptr, out, n, route, s);
    case kBF16:
      return launch<__nv_bfloat16>(
          Scale<__nv_bfloat16>{Elt<__nv_bfloat16>::coef(a)}, nullptr, x,
          nullptr, out, n, route, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int tpumt_stream_sum3(const void* w, const void* x, const void* y,
                                 void* out, int dtype, long long n, int route,
                                 void* stream) {
  using namespace tpumt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch<float>(Sum3<float>{}, w, x, y, out, n, route, s);
    case kF64:
      return launch<double>(Sum3<double>{}, w, x, y, out, n, route, s);
    case kBF16:
      return launch<__nv_bfloat16>(Sum3<__nv_bfloat16>{}, w, x, y, out, n,
                                   route, s);
    default:
      return cudaErrorInvalidValue;
  }
}
