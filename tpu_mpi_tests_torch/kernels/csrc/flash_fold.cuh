// The per-tile fold of the flash-attention kernels, shared by
// flash_attention.cu (one launch per K/V block) and
// fused_ring_attention.cu (every ring step of the fused tier in one
// launch), so that the two compute the same fold bit for bit.
//
// flash_fma_fold is the HIGHEST route (f32 FMA on the CUDA cores),
// flash_mma_fold the DEFAULT route (mma.sync: bf16 m16n8k16, TF32
// m16n8k8); flash_attention.cu's header describes both. Each folds the
// 64 query rows [q0, q0 + 64) of one head against the K/V block of its
// Params into the (m, l, acc) carry; its template flag CG makes every
// K/V load go through L2 (ld.global.cg / cp.async.cg), for blocks that
// peers stored during the launch.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tpumt {
namespace {

// dtype codes shared with the Python wrappers (kernels/hand.py)
enum FlashDType : int { kF32 = 0, kBF16 = 2 };

constexpr int kQT = 64;  // query rows per CTA
constexpr int kKT = 64;  // key columns per shared-memory tile

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* m_in;
  const float* l_in;
  const float* acc_in;
  float* m_out;
  float* l_out;
  float* acc_out;
  long long L, Lk;
  int d;
  // element strides: (row, head) of each operand
  long long q_rs, q_hs, k_rs, k_hs, v_rs, v_hs;
  long long m_rs, m_hs, l_rs, l_hs, acc_rs, acc_hs;
  long long q_off, k_off, pos_stride;
  float scale;
  int causal;
  int vec;  // q, k, v move in 16-byte chunks (set by the launcher)
};

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// 16-byte chunks of an operand row: gathered element by element (a
// ragged or misaligned row) and widened to f32
template <typename T>
struct Chunk;

template <>
struct Chunk<float> {
  static constexpr int N = 4;
  template <bool CG>
  __device__ static uint4 gather(const float* s, int n) {
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < n) w[i] = __float_as_uint(CG ? __ldcg(s + i) : s[i]);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  __device__ static void widen(const uint4& r, float (&o)[4]) {
    o[0] = __uint_as_float(r.x);
    o[1] = __uint_as_float(r.y);
    o[2] = __uint_as_float(r.z);
    o[3] = __uint_as_float(r.w);
  }
};

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int N = 8;
  template <bool CG>
  __device__ static uint4 gather(const __nv_bfloat16* s, int n) {
    const unsigned short* u = reinterpret_cast<const unsigned short*>(s);
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i < n)
        w[i / 2] |= uint32_t(CG ? __ldcg(u + i) : u[i]) << (16 * (i & 1));
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  // a bf16 is the top half of its f32: widening is exact
  __device__ static void widen(const uint4& r, float (&o)[8]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[2 * i] = __uint_as_float(w[i] << 16);
      o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// chunk `c0` (elements [c0, c0 + N)) of row `row` of an operand with
// `rows` rows; zeros past the rows or past d. CG: through L2 only
// (ld.global.cg), for data that other SMs or peers wrote during the
// launch, which an L1 line read earlier must not answer.
template <bool CG, typename T>
__device__ __forceinline__ uint4 fetch_chunk(const Params& p, const T* base,
                                             long long row, long long rows,
                                             long long rs, int c0) {
  if (row >= rows || c0 >= p.d) return make_uint4(0u, 0u, 0u, 0u);
  const T* src = base + row * rs + c0;
  if (p.vec) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    return CG ? __ldcg(s4) : *s4;
  }
  const int n = p.d - c0 < Chunk<T>::N ? p.d - c0 : Chunk<T>::N;
  return Chunk<T>::template gather<CG>(src, n);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A (rows × DP) tile of an operand into shared memory rows of length
// `ld` elements, natural layout, zeros past `rows` and past d: by
// cp.async when the chunks allow it (p.vec; the caller commits), else
// by gathered 16-byte stores.
template <typename T, int DP, int THREADS, bool CG>
__device__ __forceinline__ void load_tile(const Params& p, T* dst, int ld,
                                          const T* base, long long row0,
                                          long long rows, long long rs,
                                          int n_rows) {
  constexpr int CPR = DP / Chunk<T>::N;  // chunks per row
  for (int c = threadIdx.x; c < n_rows * CPR; c += THREADS) {
    const int r = c / CPR, c0 = (c % CPR) * Chunk<T>::N;
    T* d = dst + r * ld + c0;
    const long long row = row0 + r;
    if (p.vec) {
      const bool ok = row < rows && c0 < p.d;
      cp_async16(d, ok ? base + row * rs + c0 : base, ok ? 16 : 0);
    } else {
      *reinterpret_cast<uint4*>(d) =
          fetch_chunk<CG>(p, base, row, rows, rs, c0);
    }
  }
}

// The live key columns of query rows [q0, q0 + kQT) ∩ [0, L):
// `live` — columns [0, live) hold every column live for some row (the
// tiles beyond are skipped); `full` — columns [0, full) are live for
// every row (tiles inside run without the mask). Positions grow with the
// index (pos_stride >= 1), so the first and last rows bound both.
struct LiveCols {
  long long live, full;
};

__device__ __forceinline__ LiveCols live_cols(const Params& p, long long q0) {
  if (!p.causal) return {p.Lk, p.Lk};
  const long long last = (q0 + kQT < p.L ? q0 + kQT : p.L) - 1;
  const long long q_min = p.q_off + p.pos_stride * q0;
  const long long q_max = p.q_off + p.pos_stride * last;
  auto upto = [&](long long qpos) -> long long {
    if (qpos < p.k_off) return 0;
    const long long n = (qpos - p.k_off) / p.pos_stride + 1;
    return n < p.Lk ? n : p.Lk;
  };
  return {upto(q_max), upto(q_min)};
}

__device__ __forceinline__ bool masked_out(const Params& p, long long i,
                                           long long j) {
  if (j >= p.Lk) return true;
  return p.causal &&
         p.q_off + p.pos_stride * i < p.k_off + p.pos_stride * j;
}

// the query tile of this CTA: the last tiles first (most causal work)
__device__ __forceinline__ long long cta_q0(const Params& p) {
  const long long n_qt = (p.L + kQT - 1) / kQT;
  return (n_qt - 1 - static_cast<long long>(blockIdx.x)) * kQT;
}

// ---------------------------------------------------------------------------
// HIGHEST: f32 FMA on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kFmaThreads = 256;

template <int DP>
constexpr int fma_smem_bytes() {
  return 4 * (DP * (kQT + 4) + DP * (kKT + 4) + kKT * (DP + 4) +
              kKT * (kQT + 4));
}

// The fold of query rows [q0, q0 + kQT) of head h against the K/V block
// of `p`, by the kFmaThreads threads of a CTA, in `smem4`
// (fma_smem_bytes<DP>()). The caller separates two calls that share
// `smem4` with a __syncthreads().
template <typename T, int DP, bool CG>
__device__ __forceinline__ void flash_fma_fold(const Params& p, long long q0,
                                               int h, float4* smem4) {
  constexpr int QS = kQT + 4;  // row length of Qt and Pt (16-byte rows)
  constexpr int KS = kKT + 4;  // row length of Kt
  constexpr int VS = DP + 4;   // row length of Vs
  constexpr int NC = DP / 64;  // 4-column output groups per thread
  constexpr int EPC = Chunk<T>::N;
  constexpr int CPR = DP / EPC;                     // chunks per row
  constexpr int NCH = kKT * CPR / kFmaThreads;      // per thread per tile
  // at d <= 128 the next tile waits in registers during the math; at 256
  // its 128 registers a thread would not fit, so it is fetched in turn
  constexpr bool kPrefetch = DP == 128;
  float* Qt = reinterpret_cast<float*>(smem4);  // [DP][QS]   Qt[c][r]
  float* Kt = Qt + DP * QS;                     // [DP][KS]   Kt[c][j]
  float* Vs = Kt + DP * KS;                     // [kKT][VS]  Vs[j][n]
  float* Pt = Vs + kKT * VS;                    // [kKT][QS]  Pt[j][r]

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const LiveCols lc = live_cols(p, q0);
  const int n_tiles = static_cast<int>((lc.live + kKT - 1) / kKT);
  const T* q = static_cast<const T*>(p.q) + h * p.q_hs;
  const T* k = static_cast<const T*>(p.k) + h * p.k_hs;
  const T* v = static_cast<const T*>(p.v) + h * p.v_hs;

  // the carry of this thread's rows ty*4 + ii
  float mr[4], lr[4], acc[4][NC * 4];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const long long i = q0 + ty * 4 + ii;
    const bool ok = i < p.L;
    mr[ii] = ok ? p.m_in[h * p.m_hs + i * p.m_rs] : neg_inf();
    lr[ii] = ok ? p.l_in[h * p.l_hs + i * p.l_rs] : 0.f;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int n = cc * 64 + tx * 4 + jj;
        acc[ii][cc * 4 + jj] =
            ok && n < p.d ? p.acc_in[h * p.acc_hs + i * p.acc_rs + n] : 0.f;
      }
    }
  }

  // K chunks: the key row varies fastest across threads, so the
  // transposed stores into Kt hit consecutive banks; V chunks: the column
  // varies fastest (coalesced reads, 16-byte stores)
  auto k_chunk = [&](int i, int& j, int& c0) {
    const int cq = tid + i * kFmaThreads;
    j = cq % kKT;
    c0 = (cq / kKT) * EPC;
  };
  auto v_chunk = [&](int i, int& j, int& c0) {
    const int cq = tid + i * kFmaThreads;
    j = cq / CPR;
    c0 = (cq % CPR) * EPC;
  };
  auto store_k = [&](const uint4& r, int j, int c0) {
    float f[EPC];
    Chunk<T>::widen(r, f);
#pragma unroll
    for (int e = 0; e < EPC; ++e) Kt[(c0 + e) * KS + j] = f[e];
  };
  auto store_v = [&](const uint4& r, int j, int c0) {
    float f[EPC];
    Chunk<T>::widen(r, f);
#pragma unroll
    for (int e = 0; e < EPC; e += 4)
      *reinterpret_cast<float4*>(&Vs[j * VS + c0 + e]) =
          make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
  };
  uint4 kreg[NCH], vreg[NCH];  // the prefetched tile (kPrefetch only)
  auto fetch = [&](int t) {
    const long long j0 = static_cast<long long>(t) * kKT;
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      int j, c0;
      k_chunk(i, j, c0);
      kreg[i] = fetch_chunk<CG>(p, k, j0 + j, p.Lk, p.k_rs, c0);
      v_chunk(i, j, c0);
      vreg[i] = fetch_chunk<CG>(p, v, j0 + j, p.Lk, p.v_rs, c0);
    }
  };

  if (n_tiles > 0) {
    for (int idx = tid; idx < kQT * DP; idx += kFmaThreads) {
      const int r = idx / DP, c = idx % DP;
      const long long i = q0 + r;
      Qt[c * QS + r] =
          i < p.L && c < p.d ? static_cast<float>(q[i * p.q_rs + c]) : 0.f;
    }
    if constexpr (kPrefetch) fetch(0);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const long long j0 = static_cast<long long>(t) * kKT;
    __syncthreads();  // the previous tile's readers are done
    if constexpr (!kPrefetch) fetch(t);
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      int j, c0;
      k_chunk(i, j, c0);
      store_k(kreg[i], j, c0);
      v_chunk(i, j, c0);
      store_v(vreg[i], j, c0);
    }
    __syncthreads();
    if constexpr (kPrefetch) {
      if (t + 1 < n_tiles) fetch(t + 1);  // in flight during the math
    }

    float s[4][4];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[ii][jj] = 0.f;
#pragma unroll 4
    for (int c = 0; c < p.d; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(&Qt[c * QS + ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Kt[c * KS + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[ii][jj] = fmaf(av[ii], bv[jj], s[ii][jj]);
    }

    const bool needs_mask = j0 + kKT > lc.full;
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const long long i = q0 + ty * 4 + ii;
      float mt = neg_inf();
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float x = s[ii][jj] * p.scale;
        if (needs_mask && masked_out(p, i, j0 + tx * 4 + jj)) x = neg_inf();
        s[ii][jj] = x;
        mt = fmaxf(mt, x);
      }
      // the row's 64 columns live in the 16 lanes sharing ty
#pragma unroll
      for (int o = 1; o < 16; o <<= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float mn = fmaxf(mr[ii], mt);
      const float ms = mn == neg_inf() ? 0.f : mn;
      float ps = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        s[ii][jj] = expf(s[ii][jj] - ms);
        ps += s[ii][jj];
      }
#pragma unroll
      for (int o = 1; o < 16; o <<= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, o);
      const float corr = expf(mr[ii] - ms);
      lr[ii] = lr[ii] * corr + ps;
      mr[ii] = mn;
#pragma unroll
      for (int x = 0; x < NC * 4; ++x) acc[ii][x] *= corr;
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      *reinterpret_cast<float4*>(&Pt[(tx * 4 + jj) * QS + ty * 4]) =
          make_float4(s[0][jj], s[1][jj], s[2][jj], s[3][jj]);
    }
    __syncthreads();

    // columns past the live ones hold p = 0: leave them out
    const long long rest = lc.live - j0;
    const int c_end = rest < kKT ? static_cast<int>(rest) : kKT;
    for (int j = 0; j < c_end; ++j) {
      const float4 pp = *reinterpret_cast<const float4*>(&Pt[j * QS + ty * 4]);
      const float pv[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        if (cc * 64 >= p.d) break;
        const float4 vv =
            *reinterpret_cast<const float4*>(&Vs[j * VS + cc * 64 + tx * 4]);
        const float vx[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            acc[ii][cc * 4 + jj] = fmaf(pv[ii], vx[jj], acc[ii][cc * 4 + jj]);
      }
    }
  }

#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const long long i = q0 + ty * 4 + ii;
    if (i >= p.L) continue;
    if (tx == 0) {
      p.m_out[h * p.m_hs + i * p.m_rs] = mr[ii];
      p.l_out[h * p.l_hs + i * p.l_rs] = lr[ii];
    }
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int n = cc * 64 + tx * 4 + jj;
        if (n < p.d) p.acc_out[h * p.acc_hs + i * p.acc_rs + n] = acc[ii][cc * 4 + jj];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// DEFAULT: tensor cores through mma.sync (bf16 m16n8k16, TF32 m16n8k8)
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;  // 4 warps × 16 query rows

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&b);
}

// D = A·B + D for one 16×8 tile; A 16×16 (4 regs), B 16×8 (2 regs)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D = A·B + D for one 16×8 tile; A 16×8 (4 regs), B 8×8 (2 regs), TF32
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared memory: Q [kQT][LD], then STAGES × (K [kKT][LD], V [kKT][LD]),
// all in the natural layout, as loaded. Row lengths are padded so that
// the fragment loads of one warp (lane = 4·g + t) hit distinct banks:
// LD = DP + 8 (bf16) or DP + 4 (f32) — 4 words past a multiple of 32.
template <typename T, int DP>
struct MmaLayout {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int KSTEP = kBf16 ? 16 : 8;
  static constexpr int LD = DP + (kBf16 ? 8 : 4);
  // TF32 at d = 256 has room for one K/V buffer only
  static constexpr int STAGES = (!kBf16 && DP == 256) ? 1 : 2;
  static constexpr int bytes() {
    return static_cast<int>(sizeof(T)) * (kQT + 2 * STAGES * kKT) * LD;
  }
};

// The fold of query rows [q0, q0 + kQT) of head h against the K/V block
// of `p`, by the kMmaThreads threads of a CTA, in `smem4`
// (MmaLayout<T, DP>::bytes()). K/V tiles arrive by cp.async.cg (L2
// only); CG also routes the element-wise loads of a ragged operand
// through L2. The caller separates two calls that share `smem4` with a
// __syncthreads().
template <typename T, int DP, bool CG>
__device__ __forceinline__ void flash_mma_fold(const Params& p, long long q0,
                                               int h, float4* smem4) {
  using Lay = MmaLayout<T, DP>;
  constexpr bool kBf16 = Lay::kBf16;
  constexpr int NT = kKT / 8;  // score n-tiles per warp
  constexpr int NO = DP / 8;   // output n-tiles per warp
  constexpr int LD = Lay::LD;
  constexpr int ST = Lay::STAGES;
  T* Qs = reinterpret_cast<T*>(smem4);
  auto Ks = [&](int b) { return Qs + (kQT + 2 * b * kKT) * LD; };
  auto Vs = [&](int b) { return Qs + (kQT + (2 * b + 1) * kKT) * LD; };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const LiveCols lc = live_cols(p, q0);
  const int n_tiles = static_cast<int>((lc.live + kKT - 1) / kKT);
  const T* q = static_cast<const T*>(p.q) + h * p.q_hs;
  const T* k = static_cast<const T*>(p.k) + h * p.k_hs;
  const T* v = static_cast<const T*>(p.v) + h * p.v_hs;

  // this thread's two rows: g and g + 8 of the warp's 16
  long long rows[2];
  rows[0] = q0 + warp * 16 + g;
  rows[1] = rows[0] + 8;
  float mr[2], lr[2], oacc[NO][4];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const long long i = rows[hr];
    const bool ok = i < p.L;
    mr[hr] = ok ? p.m_in[h * p.m_hs + i * p.m_rs] : neg_inf();
    lr[hr] = ok ? p.l_in[h * p.l_hs + i * p.l_rs] : 0.f;
#pragma unroll
    for (int nt = 0; nt < NO; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = nt * 8 + 2 * t4 + e;
        oacc[nt][2 * hr + e] =
            ok && n < p.d ? p.acc_in[h * p.acc_hs + i * p.acc_rs + n] : 0.f;
      }
    }
  }

  auto issue = [&](int t) {  // tile t's K and V into buffer t % ST
    const long long j0 = static_cast<long long>(t) * kKT;
    load_tile<T, DP, kMmaThreads, CG>(p, Ks(t % ST), LD, k, j0, p.Lk,
                                      p.k_rs, kKT);
    load_tile<T, DP, kMmaThreads, CG>(p, Vs(t % ST), LD, v, j0, p.Lk,
                                      p.v_rs, kKT);
    cp_async_commit();
  };
  if (n_tiles > 0) {
    load_tile<T, DP, kMmaThreads, false>(p, Qs, LD, q, q0, p.L, p.q_rs, kQT);
    issue(0);  // one group with Q
  }

  // 32-bit words of a bf16 row-major array with rows of LD elements
  auto word = [&](const T* base, int r, int c) {
    return *reinterpret_cast<const uint32_t*>(base + r * LD + c);
  };
  auto bits = [&](const T* base, int r, int c) -> uint32_t {
    if constexpr (kBf16) {
      return __bfloat16_as_ushort(base[r * LD + c]);
    } else {
      return to_tf32(base[r * LD + c]);
    }
  };

  const int n_kstep = (p.d + Lay::KSTEP - 1) / Lay::KSTEP;
  const int n_out = (p.d + 7) / 8;
  for (int t = 0; t < n_tiles; ++t) {
    const long long j0 = static_cast<long long>(t) * kKT;
    if (ST == 2 && t + 1 < n_tiles) {
      issue(t + 1);  // in flight during this tile's math
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and Q) visible to every warp
    const T* Kb = Ks(t % ST);
    const T* Vb = Vs(t % ST);

    // S = Q·Kᵀ for the warp's 16 rows × 64 columns
    float sc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
    const int r0 = warp * 16 + g;
    for (int ks = 0; ks < n_kstep; ++ks) {
      uint32_t a[4];
      if constexpr (kBf16) {
        const int c0 = ks * 16 + 2 * t4;
        a[0] = word(Qs, r0, c0);
        a[1] = word(Qs, r0 + 8, c0);
        a[2] = word(Qs, r0, c0 + 8);
        a[3] = word(Qs, r0 + 8, c0 + 8);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_bf16(sc[nt], a, word(Kb, nt * 8 + g, c0),
                   word(Kb, nt * 8 + g, c0 + 8));
      } else {
        const int c0 = ks * 8 + t4;
        a[0] = bits(Qs, r0, c0);
        a[1] = bits(Qs, r0 + 8, c0);
        a[2] = bits(Qs, r0, c0 + 4);
        a[3] = bits(Qs, r0 + 8, c0 + 4);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_tf32(sc[nt], a, bits(Kb, nt * 8 + g, c0),
                   bits(Kb, nt * 8 + g, c0 + 4));
      }
    }

    // scale, mask, online softmax on rows g (e = 0, 1) and g + 8 (e = 2, 3)
    const bool needs_mask = j0 + kKT > lc.full;
    float corr[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mt = neg_inf();
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = sc[nt][2 * hr + e] * p.scale;
          if (needs_mask && masked_out(p, rows[hr], j0 + nt * 8 + 2 * t4 + e))
            x = neg_inf();
          sc[nt][2 * hr + e] = x;
          mt = fmaxf(mt, x);
        }
      }
      // a row's 64 columns live in the 4 lanes of its quad
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float mn = fmaxf(mr[hr], mt);
      const float ms = mn == neg_inf() ? 0.f : mn;
      float ps = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = expf(sc[nt][2 * hr + e] - ms);
          sc[nt][2 * hr + e] = x;
          ps += x;
        }
      }
      ps += __shfl_xor_sync(0xffffffffu, ps, 1);
      ps += __shfl_xor_sync(0xffffffffu, ps, 2);
      corr[hr] = expf(mr[hr] - ms);
      lr[hr] = lr[hr] * corr[hr] + ps;
      mr[hr] = mn;
    }
#pragma unroll
    for (int nt = 0; nt < NO; ++nt) {
      oacc[nt][0] *= corr[0];
      oacc[nt][1] *= corr[0];
      oacc[nt][2] *= corr[1];
      oacc[nt][3] *= corr[1];
    }

    // acc += P·V, P from the S fragments in registers; V's B fragment
    // (key k, column n) gathered from the natural layout
    if constexpr (kBf16) {
#pragma unroll
      for (int ks = 0; ks < kKT / 16; ++ks) {
        const uint32_t a[4] = {
            pack_bf16(sc[2 * ks][0], sc[2 * ks][1]),
            pack_bf16(sc[2 * ks][2], sc[2 * ks][3]),
            pack_bf16(sc[2 * ks + 1][0], sc[2 * ks + 1][1]),
            pack_bf16(sc[2 * ks + 1][2], sc[2 * ks + 1][3])};
        const int kr = ks * 16 + 2 * t4;
#pragma unroll
        for (int nt = 0; nt < NO; ++nt) {
          if (nt >= n_out) break;
          const int n = nt * 8 + g;
          mma_bf16(oacc[nt], a,
                   bits(Vb, kr, n) | bits(Vb, kr + 1, n) << 16,
                   bits(Vb, kr + 8, n) | bits(Vb, kr + 9, n) << 16);
        }
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < kKT / 8; ++ks) {
        // key slot t4 holds column 8·ks + 2·t4, slot t4 + 4 column
        // 8·ks + 2·t4 + 1: the S accumulator's own layout
        const uint32_t a[4] = {to_tf32(sc[ks][0]), to_tf32(sc[ks][2]),
                               to_tf32(sc[ks][1]), to_tf32(sc[ks][3])};
        const int kr = ks * 8 + 2 * t4;
#pragma unroll
        for (int nt = 0; nt < NO; ++nt) {
          if (nt >= n_out) break;
          const int n = nt * 8 + g;
          mma_tf32(oacc[nt], a, bits(Vb, kr, n), bits(Vb, kr + 1, n));
        }
      }
    }
    __syncthreads();  // every warp is done with buffer t % ST
    if (ST == 1 && t + 1 < n_tiles) issue(t + 1);
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const long long i = rows[hr];
    if (i >= p.L) continue;
    if (t4 == 0) {
      p.m_out[h * p.m_hs + i * p.m_rs] = mr[hr];
      p.l_out[h * p.l_hs + i * p.l_rs] = lr[hr];
    }
#pragma unroll
    for (int nt = 0; nt < NO; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = nt * 8 + 2 * t4 + e;
        if (n < p.d) p.acc_out[h * p.acc_hs + i * p.acc_rs + n] = oacc[nt][2 * hr + e];
      }
    }
  }
}

}  // namespace
}  // namespace tpumt
