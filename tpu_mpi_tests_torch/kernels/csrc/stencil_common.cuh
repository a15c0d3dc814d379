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

#include <cstdint>
#include <cstring>
#include <type_traits>

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

// bfloat16 pairs as one 32-bit word, and the packed ops on them:
// add/sub/mul.rn.bf16x2 give each element correctly rounded, which is
// what float-then-round gives (float carries more than 2*8 + 2 bits).
__device__ __forceinline__ unsigned bf2_bits(__nv_bfloat162 x) {
  unsigned u;
  memcpy(&u, &x, 4);
  return u;
}
__device__ __forceinline__ __nv_bfloat162 bf2_of(unsigned u) {
  __nv_bfloat162 x;
  memcpy(&x, &u, 4);
  return x;
}
#define TPUMT_BF16X2_OP(name, op)                                       \
  __device__ __forceinline__ __nv_bfloat162 name(__nv_bfloat162 a,      \
                                                 __nv_bfloat162 b) {    \
    unsigned d;                                                         \
    asm(op " %0, %1, %2;" : "=r"(d) : "r"(bf2_bits(a)), "r"(bf2_bits(b))); \
    return bf2_of(d);                                                   \
  }
TPUMT_BF16X2_OP(bf2_add, "add.rn.bf16x2")
TPUMT_BF16X2_OP(bf2_sub, "sub.rn.bf16x2")
TPUMT_BF16X2_OP(bf2_mul, "mul.rn.bf16x2")
#undef TPUMT_BF16X2_OP

// One register word of packed arithmetic, rounding as Elt<T> does:
// float one element a word (the _rn intrinsics), bfloat16 two (bf16x2).
template <typename T>
struct Pk;
template <>
struct Pk<float> {
  using W = float;
  static constexpr int kElems = 1;
  __device__ static W add(W a, W b) { return __fadd_rn(a, b); }
  __device__ static W sub(W a, W b) { return __fsub_rn(a, b); }
  __device__ static W mul(W a, W b) { return __fmul_rn(a, b); }
  __device__ static W splat(float c) { return c; }
  __device__ static unsigned bits(W w) { return __float_as_uint(w); }
  __device__ static W of(unsigned u) { return __uint_as_float(u); }
  // element 0 (and 1) of the word as float
  __device__ static float2 f2(W w) { return make_float2(w, 0.f); }
  // n where `lo` (element 0) / `hi` (element 1) hold, else o
  __device__ static W sel(W n, W o, bool lo, bool) { return lo ? n : o; }
};
template <>
struct Pk<__nv_bfloat16> {
  using W = __nv_bfloat162;
  static constexpr int kElems = 2;
  __device__ static W add(W a, W b) { return bf2_add(a, b); }
  __device__ static W sub(W a, W b) { return bf2_sub(a, b); }
  __device__ static W mul(W a, W b) { return bf2_mul(a, b); }
  __device__ static W splat(float c) { return __float2bfloat162_rn(c); }
  __device__ static unsigned bits(W w) { return bf2_bits(w); }
  __device__ static W of(unsigned u) { return bf2_of(u); }
  __device__ static float2 f2(W w) { return __bfloat1622float2(w); }
  __device__ static W sel(W n, W o, bool lo, bool hi) {
    return bf2_of(__byte_perm(bf2_bits(n), bf2_bits(o),
                              (hi ? 0x3200 : 0x7600) | (lo ? 0x10 : 0x54)));
  }
};

// The word at element offset D (-2..2) from word j of a row segment `e`:
// float words are elements; a bfloat16 word is an element pair, so odd
// offsets straddle two words (one byte permute).
template <typename T, int D>
__device__ __forceinline__ typename Pk<T>::W pk_at(const typename Pk<T>::W* e,
                                                   int j) {
  using P = Pk<T>;
  if constexpr (P::kElems == 1) {
    return e[j + D];
  } else if constexpr (D % 2 == 0) {
    return e[j + D / 2];
  } else {
    constexpr int lo = D < 0 ? -1 : 0;  // the word of the pair's first element
    return P::of(__byte_perm(P::bits(e[j + lo]), P::bits(e[j + lo + 1]),
                             0x5432));
  }
}

// a + b, element by element in the dtype (bfloat16 rounded per op), for
// a V that packs one T or 16 / sizeof(T) of them: the collectives' folds
// (ring_collectives.cu: received + local; oneshot.cu: acc + slot).
template <typename T, typename V>
__device__ __forceinline__ V fold(const V& a, const V& b) {
  using E = Elt<T>;
  if constexpr (std::is_same_v<T, V>) {
    return E::store(E::add(E::load(&a), E::load(&b)));
  } else {
    constexpr int k = sizeof(V) / sizeof(T);
    T x[k], y[k];
    memcpy(x, &a, sizeof(V));
    memcpy(y, &b, sizeof(V));
#pragma unroll
    for (int i = 0; i < k; ++i)
      x[i] = E::store(E::add(E::load(&x[i]), E::load(&y[i])));
    V out;
    memcpy(&out, x, sizeof(V));
    return out;
  }
}

}  // namespace tpumt
