// The k-step tile update shared by the iterate kernel (stencil_iterate.cu)
// and the fused ring kernel (fused_rdma.cu) — one implementation, so a
// fused launch and the chained ring_halo -> stencil2d_iterate pair agree
// bit for bit by construction (as _kstep_advance gives it in the JAX
// package, pallas_kernels.py:915).
//
// What one tile computes: `steps` timesteps of
//     z[a] += se * (C1*(z[a+1]-z[a-1]) + C2*(z[a+2]-z[a-2]))
// along the stencil axis DIM for the TA output indices a0..a0+TA and the
// TB indices b0..b0+TB of the other axis. At step s an index a is updated
// iff a ∈ [dlo_s, dhi_s), dlo_s = K if plo else s*R and
// dhi_s = N - (K if phi else s*R), K = steps*R, R = N_BND = 2: physical
// sides keep their K-deep band fixed, exchange-fed sides shrink by R per
// step. Indices never updated keep their input value. Results go to
// `out`, never `z`: tiles that split the stencil axis would read indices
// a neighbour had overwritten.
//
// Two bodies, two routes (hand.KSTEP_ROUTES; a route's code is its index):
//
// "smem" (kstep_tile): the tile is loaded with a K-deep apron on each
// side (clipped at the array edge) into shared memory and stepped there,
// ping-ponging between two shared buffers: at step s it updates
// [max(win_lo + s*R, dlo_s), min(win_hi - s*R, dhi_s)), the part of its
// window whose inputs are still exact. Any steps, any alignment.
//
// "regs" (kstep_regs_dim0, kstep_regs_dim1), where 1 <= steps <=
// kRegsMaxSteps and every row of z and out starts on 8 bytes (the
// iterate) or 16 (the fused kernel): no shared memory, no barrier, all k
// steps in registers, in vectors of kVB bytes — 16 where every row starts
// on 16 bytes, else 8 (kstep_vec_bytes). Along
// dim 0 a thread owns one column vector and walks a run of rows through a
// k-stage pipeline of 5-row register windows: a row read at step r enters
// stage 1, and stage s emits its row 2 rows behind stage s-1, so the last
// stage emits row r - K; the span test is made once a row per stage,
// uniform across the warp, and the loads of the next kPrefetch rows are
// issued before a row's arithmetic. Along dim 1 a warp owns a row segment
// with a K-deep apron (rounded up to whole vectors) at both ends, each
// lane kLaneVecs contiguous vectors; a step takes the neighbours' values
// by warp shuffles, and the warp writes the segment's inner part. bfloat16
// runs packed (add/sub/mul.rn.bf16x2: two elements an instruction, each
// result correctly rounded, which is what float-then-round gives, since
// float carries more than 2*8 + 2 bits).
#pragma once

#include <cstdint>
#include <cstring>
#include <type_traits>

#include "stencil_common.cuh"

namespace tpumt {

constexpr int kRadius = 2;  // N_BND

// Thread layout per stencil axis: the contiguous axis (columns) maps to
// threadIdx.x so global loads and stores coalesce. TB is the tile's extent
// along the other axis.
template <int DIM>
struct KTile;
template <>
struct KTile<0> {  // stencil along rows
  static constexpr int TB = 64;  // columns per tile
  static constexpr int BX = 64;
  static constexpr int BY = 4;
};
template <>
struct KTile<1> {  // stencil along columns
  static constexpr int TB = 8;  // rows per tile
  static constexpr int BX = 128;
  static constexpr int BY = 2;
};

// Shared memory one tile of TA indices takes: two (TA + 2K) x TB buffers.
template <typename T, int DIM>
size_t kstep_smem_bytes(int TA, int steps) {
  return 2 * static_cast<size_t>(TA + 2 * steps * kRadius) * KTile<DIM>::TB *
         sizeof(typename Elt<T>::C);
}

// One tile: output indices [a0, a0 + TA) along DIM and [b0, b0 + TB) along
// the other axis of the (n0, n1) array z, written to out. `smem` holds
// kstep_smem_bytes<T, DIM>(TA, steps) bytes. `z` carries no __restrict__:
// in the fused ring kernel its ghost bands are written by peers while the
// launch runs, so its loads must not take the read-only path.
template <typename T, int DIM>
__device__ __forceinline__ void kstep_tile(
    const T* z, T* __restrict__ out, long long n0, long long n1, int steps,
    typename Elt<T>::C se, typename Elt<T>::C c1, typename Elt<T>::C c2,
    int plo, int phi, long long a0, int TA, long long b0,
    typename Elt<T>::C* smem) {
  using E = Elt<T>;
  using C = typename E::C;
  using G = KTile<DIM>;
  const int K = steps * kRadius;
  const int WA = TA + 2 * K;  // window extent, stencil axis
  // int(...) keeps the constexpr members values, never references
  const int INNER = DIM == 0 ? int(G::TB) : WA;  // contiguous extent
  const int OUTER = DIM == 0 ? WA : int(G::TB);
  C* buf0 = smem;
  C* buf1 = buf0 + static_cast<size_t>(WA) * G::TB;

  const long long N = DIM == 0 ? n0 : n1;  // extent along the stencil axis
  const long long M = DIM == 0 ? n1 : n0;  // extent along the other axis
  const long long origin = a0 - K;  // absolute index of window position 0
  const long long wa0 = origin > 0 ? origin : 0;
  const long long wa1 = a0 + TA + K < N ? a0 + TA + K : N;
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

  const int st = DIM == 0 ? int(G::TB) : 1;  // smem stride, stencil axis
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
      if (pa < K || pa >= K + TA) continue;
      const long long a = origin + pa, b = b0 + pb;
      if (a < N && b < M) {
        const long long g = DIM == 0 ? a * n1 + b : b * n1 + a;
        out[g] = E::store(src[pi * INNER + pj]);
      }
    }
  }
}


// ---------------------------------------------------------------------------
// the regs route
// ---------------------------------------------------------------------------

// The route's compile-time choices (kernels/kstep_ab.py varies each).
constexpr int kRegsMaxSteps = 8;   // the register budget: stages a thread holds
constexpr int kPrefetch = 4;       // dim 0: rows in flight ahead of the computed one
constexpr int kRunRows = 128;      // dim 0: the shortest run a thread walks (iterate)
constexpr int kLaneVecs = 2;       // dim 1: contiguous vectors a lane holds
constexpr int kRegsThreads = 128;  // threads a CTA
// dim 0: the slots of a window and of the prefetch ring (row t of the walk
// in slot t % kSlots): five rows a stage, and the rows in flight
constexpr int kSlots = 5;
static_assert(kPrefetch >= 1 && kPrefetch < kSlots, "rows in flight");

enum KStepRoute : int { kKStepSmem = 0, kKStepRegs = 1 };

// The regs route's vector for z and out: 16 bytes where every row of both
// starts on 16 bytes (both start there and the row pitch is whole 16-byte
// vectors), else 8 where every row starts on 8, else 0 (no vector).
inline int kstep_vec_bytes(const void* z, const void* out, long long n1,
                           int itemsize) {
  auto rows_on = [&](int b) {
    return reinterpret_cast<std::uintptr_t>(z) % b == 0 &&
           reinterpret_cast<std::uintptr_t>(out) % b == 0 &&
           n1 * itemsize % b == 0;
  };
  return rows_on(16) ? 16 : rows_on(8) ? 8 : 0;
}

// The bytes every row of z and out starts on for the regs route: the
// iterate's, and the fused kernel's (its instances with sends spill a few
// bytes in 8-byte vectors, at every ptxas register-usage level).
constexpr int kIterateRowBytes = 8;
constexpr int kFusedRowBytes = 16;

// The rule (hand.kstep_route): regs when 1 <= steps <= kRegsMaxSteps and
// every row of z and out starts on `row_bytes` (kIterateRowBytes,
// kFusedRowBytes).
inline int kstep_route(int steps, const void* z, const void* out,
                       long long n1, int itemsize, int row_bytes) {
  return steps >= 1 && steps <= kRegsMaxSteps &&
                 kstep_vec_bytes(z, out, n1, itemsize) >= row_bytes
             ? kKStepRegs
             : kKStepSmem;
}

// One register word of the route and its 5-point update, rounding as
// Elt<T> does: float and double one IEEE op each (the _rn intrinsics);
// bfloat16 two elements a word.
template <typename T>
struct KWord;
template <>
struct KWord<float> {
  using W = float;
  static constexpr int kElems = 1;  // elements a word holds
  static constexpr int kHalo = 2;   // words a dim-1 step reads each side
  __device__ static W coef(float c) { return c; }
  __device__ static W step(W z0, W m1, W p1, W m2, W p2, W se, W c1, W c2) {
    const W acc = __fadd_rn(__fmul_rn(c1, __fsub_rn(p1, m1)),
                            __fmul_rn(c2, __fsub_rn(p2, m2)));
    return __fadd_rn(z0, __fmul_rn(se, acc));
  }
};
template <>
struct KWord<double> {
  using W = double;
  static constexpr int kElems = 1;
  static constexpr int kHalo = 2;
  __device__ static W coef(double c) { return c; }
  __device__ static W step(W z0, W m1, W p1, W m2, W p2, W se, W c1, W c2) {
    const W acc = __dadd_rn(__dmul_rn(c1, __dsub_rn(p1, m1)),
                            __dmul_rn(c2, __dsub_rn(p2, m2)));
    return __dadd_rn(z0, __dmul_rn(se, acc));
  }
};

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

template <>
struct KWord<__nv_bfloat16> {
  using W = __nv_bfloat162;
  static constexpr int kElems = 2;
  static constexpr int kHalo = 1;
  __device__ static W coef(float c) { return __float2bfloat162_rn(c); }
  __device__ static W step(W z0, W m1, W p1, W m2, W p2, W se, W c1, W c2) {
    const W acc = bf2_add(bf2_mul(c1, bf2_sub(p1, m1)),
                          bf2_mul(c2, bf2_sub(p2, m2)));
    return bf2_add(z0, bf2_mul(se, acc));
  }
};

// The update of word j of a row segment `e` held in registers, along the
// row: f32/f64 words are elements; a bf16 word is an element pair, whose
// ±1 neighbours straddle two words (one byte permute each).
template <typename T>
__device__ __forceinline__ typename KWord<T>::W kword_at(
    const typename KWord<T>::W* e, int j, typename KWord<T>::W se,
    typename KWord<T>::W c1, typename KWord<T>::W c2) {
  using KW = KWord<T>;
  if constexpr (KW::kElems == 1) {
    return KW::step(e[j], e[j - 1], e[j + 1], e[j - 2], e[j + 2], se, c1, c2);
  } else {
    const auto m1 = bf2_of(__byte_perm(bf2_bits(e[j - 1]), bf2_bits(e[j]),
                                       0x5432));
    const auto p1 = bf2_of(__byte_perm(bf2_bits(e[j]), bf2_bits(e[j + 1]),
                                       0x5432));
    return KW::step(e[j], m1, p1, e[j - 1], e[j + 1], se, c1, c2);
  }
}

// kVB bytes of words, moved as one load or store.
template <typename W, int kVB>
struct KRow {
  W w[kVB / sizeof(W)];
};
template <int kVB>
struct KVec;
template <>
struct KVec<16> {
  using U = uint4;
};
template <>
struct KVec<8> {
  using U = uint2;
};

// kCg: through L2 only (ld.global.cg), for z in the fused kernel, whose
// ghost bands peers write during the launch; else the read-only path.
template <bool kCg, typename R>
__device__ __forceinline__ R kload(const void* p) {
  using U = typename KVec<sizeof(R)>::U;
  const U* q = static_cast<const U*>(p);
  U u;
  if constexpr (kCg)
    u = __ldcg(q);
  else
    u = __ldg(q);
  R r;
  memcpy(&r, &u, sizeof(R));
  return r;
}
template <typename R>
__device__ __forceinline__ void kstore(void* p, const R& r) {
  using U = typename KVec<sizeof(R)>::U;
  U u;
  memcpy(&u, &r, sizeof(R));
  *static_cast<U*>(p) = u;
}

// Dim 0, one thread: the column vector at `zc` / `oc` (row 0's bytes),
// rows `pitch` bytes apart, N rows; output rows [a0, min(a0 + ta, N)).
// Rows a0 - K .. enter the pipeline one an iteration (rows outside [0, N)
// as zeros, never stored); win[s] holds stage s's last five rows (row t of
// the walk in slot t % kSlots), pre[] the kPrefetch rows loaded ahead.
template <typename T, int kK, int kVB, bool kCg>
__device__ __forceinline__ void kstep_regs_dim0(
    const char* zc, char* oc, long long pitch, int N, int a0, int ta,
    typename KWord<T>::W se, typename KWord<T>::W c1,
    typename KWord<T>::W c2, int plo, int phi) {
  using KW = KWord<T>;
  using R = KRow<typename KW::W, kVB>;
  constexpr int K = kK * kRadius;
  constexpr int NW = kVB / sizeof(typename KW::W);
  const int r0 = a0 - K;
  const int stop = a0 + ta < N ? a0 + ta : N;
  const int r1 = stop + K;
  R win[kK][kSlots] = {};
  R pre[kSlots] = {};
  auto load = [&](int r) {
    R v = {};
    if (r >= 0 && r < N) v = kload<kCg, R>(zc + r * pitch);
    return v;
  };
#pragma unroll
  for (int p = 0; p < kPrefetch; ++p) pre[p] = load(r0 + p);
  for (int t0 = 0; r0 + t0 < r1; t0 += kSlots) {
#pragma unroll
    for (int ph = 0; ph < kSlots; ++ph) {
      const int r = r0 + t0 + ph;
      if (r >= r1) break;
      pre[(ph + kPrefetch) % kSlots] = load(r + kPrefetch);
      win[0][ph] = pre[ph];
#pragma unroll
      for (int s = 1; s <= kK; ++s) {
        const int c = r - s * kRadius;  // the row stage s emits
        const int dlo = plo ? K : s * kRadius;
        const int dhi = N - (phi ? K : s * kRadius);
        // rows c+2, c+1, c, c-1, c-2 in slots ph, ph-1, .. ph-4
        const R* w = win[s - 1];
        auto at = [&](int back) -> const R& {
          return w[(ph + kSlots - back) % kSlots];
        };
        R v = at(2);
        if (c >= dlo && c < dhi) {
#pragma unroll
          for (int i = 0; i < NW; ++i)
            v.w[i] = KW::step(v.w[i], at(3).w[i], at(1).w[i], at(4).w[i],
                              at(0).w[i], se, c1, c2);
        }
        if (s < kK)
          win[s][ph] = v;
        else if (c >= a0 && c < stop)
          kstore(oc + c * pitch, v);
      }
    }
  }
}

// Dim 1: vectors of kVB bytes a warp loads (32 lanes × kLaneVecs) and
// writes (all but the Kv-deep aprons), per segment.
template <typename T, int kK, int kVB>
struct KDim1 {
  static constexpr int E = kVB / sizeof(T);  // elements a vector
  static constexpr int K = kK * kRadius;
  static constexpr int Kv = (K + E - 1) / E;  // apron vectors
  static constexpr int kLoad = 32 * kLaneVecs;
  static constexpr int kInner = 32 * kLaneVecs - 2 * Kv;
  static_assert(kInner > 0, "a segment wider than its aprons");
};

// Dim 1, one warp: segment `seg` of the row at `zr` / `orow` (n1
// elements, whole vectors of kVB bytes).
template <typename T, int kK, int kVB>
__device__ __forceinline__ void kstep_regs_dim1(
    const T* zr, T* orow, int n1, int seg, typename KWord<T>::W se,
    typename KWord<T>::W c1, typename KWord<T>::W c2, int plo, int phi) {
  using KW = KWord<T>;
  using W = typename KW::W;
  using G = KDim1<T, kK, kVB>;
  using R = KRow<W, kVB>;
  constexpr int NW = kVB / sizeof(W);  // words a vector
  constexpr int H = KW::kHalo;
  constexpr int K = G::K;
  const int lane = threadIdx.x % 32;
  const int nv = n1 / G::E;
  const int v0 = seg * G::kInner - G::Kv;  // the segment's first vector
  // the elements the warp loads: no mask where they all lie in [K, n1 - K)
  const bool inner = v0 * G::E >= K && (v0 + G::kLoad) * G::E <= n1 - K;
  auto keep = [&](int a, int s) {  // element a not updated at step s
    const int dlo = plo ? K : s * kRadius;
    const int dhi = n1 - (phi ? K : s * kRadius);
    return a < dlo || a >= dhi;
  };
  constexpr int n = kLaneVecs * NW;
  static_assert(n >= H, "a lane holds the halo its neighbours take");
  W x[n];
  const int lv = v0 + lane * kLaneVecs;  // this lane's first vector
#pragma unroll
  for (int u = 0; u < kLaneVecs; ++u) {
    R r = {};
    if (lv + u >= 0 && lv + u < nv)
      r = kload<false, R>(zr + static_cast<long long>(lv + u) * G::E);
    memcpy(x + u * NW, r.w, sizeof(R));
  }
  const int a_lane = lv * G::E;  // element index of x[0]
#pragma unroll
  for (int s = 1; s <= kK; ++s) {
    W e[n + 2 * H];
#pragma unroll
    for (int j = 0; j < n; ++j) e[H + j] = x[j];
#pragma unroll
    for (int h = 0; h < H; ++h) {
      e[H - 1 - h] = __shfl_up_sync(0xffffffffu, x[n - 1 - h], 1);
      e[H + n + h] = __shfl_down_sync(0xffffffffu, x[h], 1);
    }
#pragma unroll
    for (int j = 0; j < n; ++j) {
      const W v = kword_at<T>(e, H + j, se, c1, c2);
      x[j] = inner || !keep(a_lane + j * KW::kElems, s) ? v : x[j];
    }
  }
#pragma unroll
  for (int u = 0; u < kLaneVecs; ++u) {
    const int vi = lv + u;
    if (vi >= v0 + G::Kv && vi < v0 + G::Kv + G::kInner && vi < nv) {
      R r;
      memcpy(r.w, x + u * NW, sizeof(R));
      kstore(orow + static_cast<long long>(vi) * G::E, r);
    }
  }
}

// f(std::integral_constant<int, steps>) for steps 1..kRegsMaxSteps (an
// instance each), cudaErrorInvalidValue for any other.
template <typename F>
auto with_steps(int steps, F f)
    -> decltype(f(std::integral_constant<int, 1>{})) {
  switch (steps) {
#define TPUMT_STEPS(k) \
  case k:              \
    if constexpr (k <= kRegsMaxSteps) return f(std::integral_constant<int, k>{});
    TPUMT_STEPS(1)
    TPUMT_STEPS(2)
    TPUMT_STEPS(3)
    TPUMT_STEPS(4)
    TPUMT_STEPS(5)
    TPUMT_STEPS(6)
    TPUMT_STEPS(7)
    TPUMT_STEPS(8)
#undef TPUMT_STEPS
    default:
      break;
  }
  return cudaErrorInvalidValue;
}

// f(std::integral_constant<int, vb>) for the regs route's vectors of 16
// or 8 bytes (kstep_vec_bytes).
template <typename F>
auto with_vec(int vb, F f) -> decltype(f(std::integral_constant<int, 16>{})) {
  if (vb == 16) return f(std::integral_constant<int, 16>{});
  return f(std::integral_constant<int, 8>{});
}

}  // namespace tpumt
