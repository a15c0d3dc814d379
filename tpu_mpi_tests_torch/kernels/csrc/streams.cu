// The three streaming kernels of the DAXPY pillar and the HBM probes:
//
//   tpumt_daxpy         out = a*x + y         replaces daxpy_pallas
//                       (tpu_mpi_tests/kernels/pallas_kernels.py:84)
//   tpumt_stream_scale  out = a*x             replaces stream_scale_pallas
//                       (:144), the 2-stream probe
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
// In place: each thread reads its elements and then writes the same
// elements, so `out` may be the very buffer of any input (out == y is
// daxpy_pallas's inplace=True, out == x stream_scale_pallas's). No
// pointer is __restrict__ for that reason. A partial overlap is refused
// by the wrapper.
//
// Bound on the H100: memory. daxpy moves 3 elements per 2 flops, scale 2
// per 1, sum3 4 per 2; far below the card's ~20 flop/byte float32 ridge.
// Design: a grid-stride loop over 16-byte packs (4 float, 2 double, 8
// bf16) when every pointer is 16-byte aligned, so each thread issues one
// 128-bit load per stream; the ragged tail (n not a multiple of the
// pack), and any misaligned call, runs element by element. Any n >= 1
// works: the TPU's multiple-of-128 rule was its lane width.
#include <cstdint>

#include "stencil_common.cuh"

namespace tpumt {
namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;  // 2048 resident threads per SM

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

template <typename T>
struct alignas(16) Pack {
  static constexpr int kN = 16 / sizeof(T);
  T v[kN];
};

template <typename T, typename Op>
__device__ void apply_one(const Op& op, const T* w, const T* x, const T* y,
                          T* out, long long i) {
  using E = Elt<T>;
  using C = typename E::C;
  const C cw = Op::kW ? E::load(w + i) : C(0);
  const C cx = Op::kX ? E::load(x + i) : C(0);
  const C cy = Op::kY ? E::load(y + i) : C(0);
  out[i] = E::store(op(cw, cx, cy));
}

template <typename T, typename Op>
__global__ void __launch_bounds__(kThreads)
    stream_kernel(Op op, const T* w, const T* x, const T* y, T* out,
                  long long n, bool packed) {
  using E = Elt<T>;
  using P = Pack<T>;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long done = 0;
  if (packed) {
    const long long n_packs = n / P::kN;
    const P* pw = reinterpret_cast<const P*>(w);
    const P* px = reinterpret_cast<const P*>(x);
    const P* py = reinterpret_cast<const P*>(y);
    P* po = reinterpret_cast<P*>(out);
    for (long long p = tid; p < n_packs; p += stride) {
      P vw, vx, vy, vo;
      if (Op::kW) vw = pw[p];
      if (Op::kX) vx = px[p];
      if (Op::kY) vy = py[p];
#pragma unroll
      for (int j = 0; j < P::kN; ++j) {
        using C = typename E::C;
        const C cw = Op::kW ? E::load(&vw.v[j]) : C(0);
        const C cx = Op::kX ? E::load(&vx.v[j]) : C(0);
        const C cy = Op::kY ? E::load(&vy.v[j]) : C(0);
        vo.v[j] = E::store(op(cw, cx, cy));
      }
      po[p] = vo;
    }
    done = n_packs * P::kN;
  }
  for (long long i = done + tid; i < n; i += stride) {
    apply_one<T>(op, w, x, y, out, i);
  }
}

bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

int grid_for(long long work) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        sms < 1) {
      sms = 132;  // an H100 SXM; the grid-stride loop covers any count
    }
  }
  const long long want = (work + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  return static_cast<int>(want < cap ? want : cap);
}

template <typename T, typename Op>
int launch(const Op& op, const void* w, const void* x, const void* y,
           void* out, long long n, cudaStream_t stream) {
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const bool packed =
      aligned16(w) && aligned16(x) && aligned16(y) && aligned16(out);
  const long long work = packed ? n / Pack<T>::kN + n % Pack<T>::kN : n;
  stream_kernel<T, Op><<<grid_for(work), kThreads, 0, stream>>>(
      op, static_cast<const T*>(w), static_cast<const T*>(x),
      static_cast<const T*>(y), static_cast<T*>(out), n, packed);
  return cudaGetLastError();
}

}  // namespace
}  // namespace tpumt

// Plain C entry points (bound with ctypes). Each returns a cudaError_t:
// 0 when the launch was accepted. `a` arrives already rounded to the
// array dtype. `out` may be the same buffer as any input, never a
// partial overlap of one.

extern "C" int tpumt_daxpy(double a, const void* x, const void* y, void* out,
                           int dtype, long long n, void* stream) {
  using namespace tpumt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch<float>(Daxpy<float>{Elt<float>::coef(a)}, nullptr, x, y,
                           out, n, s);
    case kF64:
      return launch<double>(Daxpy<double>{Elt<double>::coef(a)}, nullptr, x,
                            y, out, n, s);
    case kBF16:
      return launch<__nv_bfloat16>(
          Daxpy<__nv_bfloat16>{Elt<__nv_bfloat16>::coef(a)}, nullptr, x, y,
          out, n, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int tpumt_stream_scale(double a, const void* x, void* out,
                                  int dtype, long long n, void* stream) {
  using namespace tpumt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch<float>(Scale<float>{Elt<float>::coef(a)}, nullptr, x,
                           nullptr, out, n, s);
    case kF64:
      return launch<double>(Scale<double>{Elt<double>::coef(a)}, nullptr, x,
                            nullptr, out, n, s);
    case kBF16:
      return launch<__nv_bfloat16>(
          Scale<__nv_bfloat16>{Elt<__nv_bfloat16>::coef(a)}, nullptr, x,
          nullptr, out, n, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int tpumt_stream_sum3(const void* w, const void* x, const void* y,
                                 void* out, int dtype, long long n,
                                 void* stream) {
  using namespace tpumt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch<float>(Sum3<float>{}, w, x, y, out, n, s);
    case kF64:
      return launch<double>(Sum3<double>{}, w, x, y, out, n, s);
    case kBF16:
      return launch<__nv_bfloat16>(Sum3<__nv_bfloat16>{}, w, x, y, out, n, s);
    default:
      return cudaErrorInvalidValue;
  }
}
