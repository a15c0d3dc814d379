// Element-type policy shared by the stencil kernels.
//
// Every arithmetic op rounds exactly where the plain PyTorch version of
// the kernel rounds, so the two agree bit for bit on the card:
//   * float / double: one IEEE op each, via the _rn intrinsics (never
//     contracted into an FMA, whatever -fmad says);
//   * bfloat16: loaded to float, each op computed in float and rounded
//     back to bf16 — what an eager PyTorch bf16 op does (float "opmath",
//     one rounding per op). Shared memory keeps the bf16 values widened
//     to float, which is exact.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tpumt {

// dtype codes shared with the Python wrappers (kernels/hand.py)
enum DType : int { kF32 = 0, kF64 = 1, kBF16 = 2 };

template <typename T>
struct Elt;

template <>
struct Elt<float> {
  using C = float;  // compute / shared-memory type
  __device__ static C load(const float* p) { return *p; }
  __device__ static float store(C x) { return x; }
  __device__ static C add(C a, C b) { return __fadd_rn(a, b); }
  __device__ static C sub(C a, C b) { return __fsub_rn(a, b); }
  __device__ static C mul(C a, C b) { return __fmul_rn(a, b); }
  static C coef(double v) { return static_cast<float>(v); }
};

template <>
struct Elt<double> {
  using C = double;
  __device__ static C load(const double* p) { return *p; }
  __device__ static double store(C x) { return x; }
  __device__ static C add(C a, C b) { return __dadd_rn(a, b); }
  __device__ static C sub(C a, C b) { return __dsub_rn(a, b); }
  __device__ static C mul(C a, C b) { return __dmul_rn(a, b); }
  static C coef(double v) { return v; }
};

template <>
struct Elt<__nv_bfloat16> {
  using C = float;
  __device__ static C q(C x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  __device__ static C load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ static __nv_bfloat16 store(C x) {
    return __float2bfloat16_rn(x);
  }
  __device__ static C add(C a, C b) { return q(__fadd_rn(a, b)); }
  __device__ static C sub(C a, C b) { return q(__fsub_rn(a, b)); }
  __device__ static C mul(C a, C b) { return q(__fmul_rn(a, b)); }
  // the wrapper passes coefficients already rounded to bf16, so the
  // double → float conversion here is exact
  static C coef(double v) { return static_cast<float>(v); }
};

}  // namespace tpumt
