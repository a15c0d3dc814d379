// The per-tile fold of the flash-attention kernels, shared by
// flash_attention.cu (one launch per K/V block) and
// fused_ring_attention.cu (every ring step of the fused tier in one
// launch), so that the two compute the same fold bit for bit.
//
// Three routes, one rule (flash_route in kernels/hand.py; the launchers
// check the route they are given against it):
//   * wgmma (flash_wg_*) — bf16 at DEFAULT precision, d <= 128, every
//     operand in 16-byte chunks (Params.vec): every main-path operand
//     (attnbench and microbench at (8192, 128) and (32768, 128), every
//     ring and Ulysses shard). Hopper's own shape: a CTA of one consumer
//     warpgroup (64 query rows) and one producer warpgroup whose warp 4
//     loads, one CTA an SM; setmaxnreg moves registers from the producers
//     to the consumers. The producer loads Q once per query tile and K, V
//     in a ring of kWgStages stages of kWgKT = 128 key rows by TMA
//     (128-byte swizzle, a full and an empty mbarrier per stage and
//     operand; only live tiles). S = Q·Kᵀ is a wgmma m64n128k16 with both
//     operands in shared memory (K-major); P stays in registers, rounded
//     to bf16 (_pv_operands' rounding), and O += P·V is a wgmma
//     m64n128k16 with A from registers and V read MN-major (the transpose
//     bit). Each iteration issues S(j) and PV(j-1) as two commit groups,
//     waits for S(j) only, and runs the softmax of S(j) while the tensor
//     cores run PV(j-1); exp2 of scores prescaled by log2(e)
//     (ex2.approx) replaces expf. Issuing S(j+1) before the softmax of
//     S(j) as well needs a second S buffer; ptxas then spilled and
//     serialised the wgmmas even with the whole register file.
//     kernels/flash_ab.py times the other choices on the card (H100,
//     700 W, (8192, 128)): kWgKT = 64 0.109 ms against 0.087; three
//     stages 0.089.
//   * mma (flash_mma_fold) — DEFAULT for the rest: f32 operands as TF32
//     m16n8k8 (wgmma's TF32 form wants V K-major, which it is not), and
//     bf16 at d in (128, 256], misaligned operands or ragged chunks, as
//     bf16 m16n8k16; mma.sync, 4 warps, K/V by cp.async into two buffers.
//   * fma (flash_fma_fold) — HIGHEST: f32 FMA on the CUDA cores.
// Each folds the 64 query rows [q0, q0 + 64) of one head against the K/V
// block of its Params into the (m, l, acc) carry. The mma and fma bodies'
// template flag CG routes every K/V load through L2 (ld.global.cg /
// cp.async.cg), for blocks that peers stored during the launch; the wgmma
// body reads through TMA, and the fused kernel fences the proxies
// (fence.proxy.async.global) after each arrival instead.
//
// Bound at the main-path shape, (8192, 128) bf16: 4·L²·d = 34.4 GFLOP at
// 989 TFLOP/s, 0.0347 ms, against 20 MB of operands and carry (6 µs at
// 3.35 TB/s): the tensor cores bind. The L² = 67 M exponentials take
// ~17 µs at 16 a clock an SM: the softmax must run under the products.
#pragma once

#include <cstdint>

#include <cuda.h>  // CUtensorMap (types only: no libcuda is linked)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tpumt {
namespace {

// dtype codes shared with the Python wrappers (kernels/hand.py)
enum FlashDType : int { kF32 = 0, kBF16 = 2 };
// route codes: the index of the route's name in hand.FLASH_ROUTES
enum FlashRoute : int { kRouteFma = 0, kRouteMma = 1, kRouteWgmma = 2 };

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
  // wgmma route: bit 0/1/2 set when q/k/v's tensor map holds the head
  // axis inside the row axis (coordinates (column, head, row)); else
  // (column, row, head)
  int head_inner;
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

// The live key columns of query row i against a block at key offset
// k_off (p.k_off unless a caller folds several blocks with one Params):
// [0, live_upto(p, i, k_off)) — exactly the columns masked_out leaves.
__device__ __forceinline__ long long live_upto(const Params& p, long long i,
                                               long long k_off) {
  if (!p.causal) return p.Lk;
  const long long qpos = p.q_off + p.pos_stride * i;
  if (qpos < k_off) return 0;
  const long long n = (qpos - k_off) / p.pos_stride + 1;
  return n < p.Lk ? n : p.Lk;
}

__device__ __forceinline__ LiveCols live_cols(const Params& p, long long q0,
                                              long long k_off) {
  const long long last = (q0 + kQT < p.L ? q0 + kQT : p.L) - 1;
  return {live_upto(p, last, k_off), live_upto(p, q0, k_off)};
}

__device__ __forceinline__ LiveCols live_cols(const Params& p, long long q0) {
  return live_cols(p, q0, p.k_off);
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

// ---------------------------------------------------------------------------
// wgmma: bf16 DEFAULT, d <= 128, 16-byte chunks — TMA, wgmma, warp roles
// ---------------------------------------------------------------------------

constexpr int kWgKT = 128;         // key rows per K/V stage
constexpr int kWgStages = 2;       // K/V stages in the ring
constexpr int kWgDP = 128;         // d, padded with zeros (TMA's fill)
constexpr int kWgConsumers = 128;  // one warpgroup: 4 warps × 16 query rows
// A CTA is two whole warpgroups: the consumers (warps 0-3) and the
// producer warpgroup (warp 4 loads; the fused kernel's warp 5 sends; the
// rest exit), one CTA an SM (__launch_bounds__(kWgThreads, 1)). setmaxnreg
// moves registers from the producers to the consumers within the CTA's
// pool. At two CTAs an SM ptxas caps every region at 128 registers
// whatever setmaxnreg asks: the consumers spill and serialise their
// wgmmas (flash_ab's lb2 on the H100: 0.245 ms against 0.087 at (8192,
// 128)).
constexpr int kWgThreads = 2 * kWgConsumers;
constexpr int kWgProducerRegs = 56;
constexpr int kWgConsumerRegs = 216;
// an mbarrier wait that outlasts this traps (a lost load fails the launch
// instead of hanging the card)
constexpr unsigned long long kWgWaitNs = 20ull * 1000 * 1000 * 1000;

// Shared memory, from a 1024-byte-aligned base: Q (kQT rows), then
// kWgStages K tiles, then kWgStages V tiles (kWgKT rows each), then the
// mbarriers. Each tile is kWgDP / 64 column halves of 64 bf16 (one
// 128-byte swizzle row per tile row), as TMA writes them.
struct WgLayout {
  static constexpr int kRow = 128;  // bytes of one row of a half
  static constexpr int kHalves = kWgDP / 64;
  static constexpr int kQHalf = kQT * kRow;
  static constexpr int kKVHalf = kWgKT * kRow;
  static constexpr int kQBytes = kHalves * kQHalf;
  static constexpr int kKVBytes = kHalves * kKVHalf;
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kWgStages * kKVBytes;
  static constexpr int kBar = kV + kWgStages * kKVBytes;
  // barriers: full Q, empty Q, full K[st], empty K[st], full V[st],
  // empty V[st]
  static constexpr int kBars = 2 + 4 * kWgStages;
  static constexpr int bytes() { return kBar + 8 * kBars + 1024; }
  __device__ static uint32_t full_q(uint32_t b) { return b + kBar; }
  __device__ static uint32_t empty_q(uint32_t b) { return b + kBar + 8; }
  __device__ static uint32_t full_k(uint32_t b, int st) {
    return b + kBar + 8 * (2 + st);
  }
  __device__ static uint32_t empty_k(uint32_t b, int st) {
    return b + kBar + 8 * (2 + kWgStages + st);
  }
  __device__ static uint32_t full_v(uint32_t b, int st) {
    return b + kBar + 8 * (2 + 2 * kWgStages + st);
  }
  __device__ static uint32_t empty_v(uint32_t b, int st) {
    return b + kBar + 8 * (2 + 3 * kWgStages + st);
  }
};
static_assert(WgLayout::bytes() <= 232448, "one CTA's shared memory");

// The tensor maps of one fold's operands (3-D: column, then row and head
// in the order of Params.head_inner), encoded on the host
struct WgMaps {
  CUtensorMap q, k, v;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the 1024-byte-aligned base of the dynamic shared memory (128-byte
// swizzle atoms are 1024 bytes; WgLayout::bytes() holds the slack)
__device__ __forceinline__ uint32_t wg_smem_base(const void* raw) {
  return (smem_u32(raw) + 1023u) & ~1023u;
}

__device__ __forceinline__ unsigned long long wg_now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// until the phase of parity `parity` of `bar` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const unsigned long long t0 = wg_now_ns();
  while (!mbar_try_wait(bar, parity))
    if (wg_now_ns() - t0 > kWgWaitNs) __trap();
}

// one box of a 3-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// the 64-column half `col` of rows [row, row + box) of head h
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row, int h,
                                         bool head_inner) {
  if (head_inner)
    tma_load_3d(dst, map, bar, col, h, row);
  else
    tma_load_3d(dst, map, bar, col, row, h);
}

// A wgmma shared-memory descriptor, 128-byte swizzle: the start address,
// the leading and the stride byte offsets
__device__ __forceinline__ uint64_t wg_desc(uint32_t saddr, uint32_t lbo,
                                            uint32_t sbo) {
  return static_cast<uint64_t>((saddr & 0x3ffffu) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keep the compiler from moving register reads or writes across an
// asynchronous product's issue or wait
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// this thread's warp, broadcast from lane 0 so that the compiler knows it
// is the same across the warp: the role branches that setmaxnreg and
// wgmma sit in must be warp-uniform for ptxas to give each role its own
// register budget
__device__ __forceinline__ int wg_warp() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) >> 5, 0);
}

template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// D (64 x 64) = A·B (+ D): A and B in shared memory, both K-major; the
// width follows the accumulator: 32 floats a thread for n64 (kWgKT = 64,
// flash_ab's kt64), 64 for n128
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 128) = A·B (+ D): A and B in shared memory, both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 128) += A·B: A (64 x 16) from registers, B in shared memory,
// MN-major (the transpose bit set)
__device__ __forceinline__ void wgmma_rs_n128_tb(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// the 64-column halves that hold columns of d; a half wholly past d is
// never loaded (wg_init zeroes it once: its products add zeros)
__device__ __forceinline__ int wg_halves(const Params& p) {
  return p.d > 64 ? 2 : 1;
}

// Thread 0 initialises the barriers; every thread of the CTA must call it
// (it ends in a __syncthreads). At d <= 64 the second column half of
// every tile is zeroed (through the generic proxy, fenced for the async
// proxy that wgmma reads through).
__device__ __forceinline__ void wg_init(uint32_t sb, const Params& p) {
  using W = WgLayout;
  if (wg_halves(p) == 1) {
    const uint32_t zero = 0u;
    for (int t = 0; t < 1 + 2 * kWgStages; ++t) {
      const uint32_t half = t == 0 ? sb + W::kQHalf
                                   : sb + W::kK + (t - 1) * W::kKVBytes +
                                         W::kKVHalf;
      const int words = (t == 0 ? W::kQHalf : W::kKVHalf) / 4;
      for (int i = threadIdx.x; i < words; i += blockDim.x)
        asm volatile("st.shared.u32 [%0], %1;" ::"r"(half + 4 * i), "r"(zero)
                     : "memory");
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  if (threadIdx.x == 0) {
    mbar_init(W::full_q(sb), 1);
    mbar_init(W::empty_q(sb), kWgConsumers);
    for (int st = 0; st < kWgStages; ++st) {
      mbar_init(W::full_k(sb, st), 1);
      mbar_init(W::empty_k(sb, st), kWgConsumers);
      mbar_init(W::full_v(sb, st), 1);
      mbar_init(W::empty_v(sb, st), kWgConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// Tiles handed over so far (producer: loaded; consumer: taken). The
// producer and the consumers walk the same folds in the same order, so
// their counts — and with them every stage and barrier phase — agree.
struct WgPipe {
  int kv = 0;  // K/V tiles
  int q = 0;   // Q tiles
};

__device__ __forceinline__ int wg_tiles(const LiveCols& lc) {
  return static_cast<int>((lc.live + kWgKT - 1) / kWgKT);
}

// The producer's part of one fold (one thread: lane 0 of the producer
// warp): Q of rows [q0, q0 + kQT) of head h, then every live K/V tile of
// the block at key offset k_off, each into the next free stage. Rows past
// L or Lk arrive as zeros.
__device__ __forceinline__ void flash_wg_produce(
    const Params& p, long long k_off, long long q0, int h,
    const CUtensorMap* qm, const CUtensorMap* km, const CUtensorMap* vm,
    uint32_t sb, WgPipe& pipe) {
  using W = WgLayout;
  const int n = wg_tiles(live_cols(p, q0, k_off));
  if (n == 0) return;
  const int halves = wg_halves(p);
  mbar_wait(W::empty_q(sb), (pipe.q & 1) ^ 1);
  mbar_expect_tx(W::full_q(sb), halves * W::kQHalf);
  for (int hf = 0; hf < halves; ++hf)
    tma_tile(sb + hf * W::kQHalf, qm, W::full_q(sb), 64 * hf,
             static_cast<int>(q0), h, p.head_inner & 1);
  ++pipe.q;
  for (int j = 0; j < n; ++j, ++pipe.kv) {
    const int st = pipe.kv % kWgStages;
    const uint32_t ph = (pipe.kv / kWgStages) & 1;
    const uint32_t kb = sb + W::kK + st * W::kKVBytes;
    const uint32_t vb = sb + W::kV + st * W::kKVBytes;
    mbar_wait(W::empty_k(sb, st), ph ^ 1);
    mbar_expect_tx(W::full_k(sb, st), halves * W::kKVHalf);
    for (int hf = 0; hf < halves; ++hf)
      tma_tile(kb + hf * W::kKVHalf, km, W::full_k(sb, st), 64 * hf,
               j * kWgKT, h, p.head_inner & 2);
    mbar_wait(W::empty_v(sb, st), ph ^ 1);
    mbar_expect_tx(W::full_v(sb, st), halves * W::kKVHalf);
    for (int hf = 0; hf < halves; ++hf)
      tma_tile(vb + hf * W::kKVHalf, vm, W::full_v(sb, st), 64 * hf,
               j * kWgKT, h, p.head_inner & 4);
  }
}

// The consumers' part of one fold (the kWgConsumers threads of warps
// 0-3) against the block at key offset k_off: the carry of rows [q0, q0 +
// kQT) of head h read once, every live tile folded, and the carry
// written once — or, with `out`, the result acc / l in bf16 (rows of p.d
// elements) instead of the carry, as the fused kernel's last step
// finishes. `p` is best a kernel parameter: its fields then take no
// registers.
__device__ __forceinline__ void flash_wg_consume(const Params& p,
                                                 long long k_off, long long q0,
                                                 int h, uint32_t sb,
                                                 WgPipe& pipe,
                                                 __nv_bfloat16* out) {
  using W = WgLayout;
  constexpr int NS = kWgKT / 2;   // S accumulator floats a thread
  constexpr int NO = kWgDP / 2;   // O accumulator floats a thread
  constexpr int KS = kWgKT / 16;  // k-steps of the PV product
  constexpr float kLog2e = 1.4426950408889634f;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const LiveCols lc = live_cols(p, q0, k_off);
  const int n = wg_tiles(lc);

  // this thread's rows g and g + 8 of its warp's 16; accumulator element
  // 4·nt + 2·hr + e sits at row hr, column 8·nt + 2·t4 + e
  long long rows[2], lim[2];
  rows[0] = q0 + warp * 16 + g;
  rows[1] = rows[0] + 8;
  lim[0] = live_upto(p, rows[0], k_off);
  lim[1] = live_upto(p, rows[1], k_off);
  float mr[2], lr[2], o[NO];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const long long i = rows[hr];
    const bool ok = i < p.L;
    mr[hr] = ok ? p.m_in[h * p.m_hs + i * p.m_rs] : neg_inf();
    lr[hr] = ok ? p.l_in[h * p.l_hs + i * p.l_rs] : 0.f;
#pragma unroll
    for (int nt = 0; nt < NO / 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = nt * 8 + 2 * t4 + e;
        o[4 * nt + 2 * hr + e] =
            ok && c < p.d ? p.acc_in[h * p.acc_hs + i * p.acc_rs + c] : 0.f;
      }
    }
  }

  if (n > 0) {
    const int kv0 = pipe.kv;
    // K-major operands: rows of 128 bytes, 8-row groups 1024 bytes apart;
    // a k-step of 16 columns is 32 bytes along the row
    const uint64_t dq = wg_desc(sb, 16, 1024);
    auto issue_s = [&](float(&s)[NS], int j) {
      const int st = (kv0 + j) % kWgStages;
      const uint64_t dk = wg_desc(sb + W::kK + st * W::kKVBytes, 16, 1024);
#pragma unroll
      for (int kk = 0; kk < kWgDP / 16; ++kk) {
        const uint32_t off = (kk / 4) * W::kQHalf + (kk % 4) * 32;
        const uint32_t offk = (kk / 4) * W::kKVHalf + (kk % 4) * 32;
        wgmma_ss(s, dq + (off >> 4), dk + (offk >> 4), kk > 0);
      }
    };
    uint32_t pf[KS][4];  // P(j - 1) as bf16 A fragments
    float sacc[NS];      // S(j), then P(j) in f32
    // V, MN-major: 8-key groups 1024 bytes apart (a k-step of 16 keys is
    // 2048 bytes), its two 64-column halves kKVHalf apart
    auto issue_pv = [&](int j) {
      const int st = (kv0 + j) % kWgStages;
      const uint64_t dv =
          wg_desc(sb + W::kV + st * W::kKVBytes, W::kKVHalf, 1024);
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        wgmma_rs_n128_tb(o, pf[ks], dv + ((ks * 2048) >> 4));
    };
    auto wait_k = [&](int j) {
      const int t = kv0 + j;
      mbar_wait(W::full_k(sb, t % kWgStages), (t / kWgStages) & 1);
    };
    auto wait_v = [&](int j) {
      const int t = kv0 + j;
      mbar_wait(W::full_v(sb, t % kWgStages), (t / kWgStages) & 1);
    };

    // scale, mask, online softmax of tile j in place (s becomes p);
    // corr: the factor of each row's old acc. Column 8·nt + 2·t4 + e of
    // the tile is masked for row hr iff 8·nt + e >= rem: one compare with
    // a constant (masked_out's rule through live_upto).
    auto softmax = [&](float(&s)[NS], int j, float(&corr)[2]) {
      const long long j0 = static_cast<long long>(j) * kWgKT;
      const bool needs_mask = j0 + kWgKT > lc.full;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        long long live = lim[hr] - j0;
        live = live < 0 ? 0 : (live > kWgKT ? kWgKT : live);
        const int rem = static_cast<int>(live) - 2 * t4;
        float mt = neg_inf();
#pragma unroll
        for (int nt = 0; nt < NS / 4; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float x = s[4 * nt + 2 * hr + e] * p.scale;
            if (needs_mask && nt * 8 + e >= rem) x = neg_inf();
            s[4 * nt + 2 * hr + e] = x;
            mt = fmaxf(mt, x);
          }
        }
        // a row's columns live in the 4 lanes of its quad
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
        const float mn = fmaxf(mr[hr], mt);
        const float ms = mn == neg_inf() ? 0.f : mn;
        const float msl = ms * kLog2e;
        float ps = 0.f;
#pragma unroll
        for (int nt = 0; nt < NS / 4; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x =
                ex2(__fmaf_rn(s[4 * nt + 2 * hr + e], kLog2e, -msl));
            s[4 * nt + 2 * hr + e] = x;
            ps += x;
          }
        }
        ps += __shfl_xor_sync(0xffffffffu, ps, 1);
        ps += __shfl_xor_sync(0xffffffffu, ps, 2);
        corr[hr] = ex2(__fmaf_rn(mr[hr], kLog2e, -msl));
        lr[hr] = lr[hr] * corr[hr] + ps;
        mr[hr] = mn;
      }
    };
    // acc by the rows' factors; P (in sacc) into the A fragments, in bf16
    auto rescale_pack = [&](const float(&corr)[2]) {
#pragma unroll
      for (int i = 0; i < NO; ++i) o[i] *= corr[(i >> 1) & 1];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        pf[ks][0] = pack_bf16(sacc[8 * ks + 0], sacc[8 * ks + 1]);
        pf[ks][1] = pack_bf16(sacc[8 * ks + 2], sacc[8 * ks + 3]);
        pf[ks][2] = pack_bf16(sacc[8 * ks + 4], sacc[8 * ks + 5]);
        pf[ks][3] = pack_bf16(sacc[8 * ks + 6], sacc[8 * ks + 7]);
      }
    };

    // S(0), its softmax, P(0)
    mbar_wait(W::full_q(sb), pipe.q & 1);
    float corr[2];
    wait_k(0);
    wg_fence();
    issue_s(sacc, 0);
    wg_commit();
    wg_wait<0>();
    reg_fence(sacc);
    mbar_arrive(W::empty_k(sb, kv0 % kWgStages));
    softmax(sacc, 0, corr);
    rescale_pack(corr);
    // tile j: issue S(j) and PV(j-1) as two groups, wait for S(j) only,
    // run its softmax while the tensor cores run PV(j-1), then wait for
    // PV(j-1), rescale acc and pack P(j). Every product is issued
    // unconditionally in the loop's block.
    for (int j = 1; j < n; ++j) {
      wait_k(j);
      wait_v(j - 1);
      reg_fence(o);
      reg_fence(pf);
      reg_fence(sacc);
      wg_fence();
      issue_s(sacc, j);
      wg_commit();
      issue_pv(j - 1);
      wg_commit();
      reg_fence(pf);
      wg_wait<1>();
      reg_fence(sacc);
      mbar_arrive(W::empty_k(sb, (kv0 + j) % kWgStages));
      softmax(sacc, j, corr);
      wg_wait<0>();
      reg_fence(o);
      reg_fence(pf);
      mbar_arrive(W::empty_v(sb, (kv0 + j - 1) % kWgStages));
      rescale_pack(corr);
    }
    // the last tile's PV
    wait_v(n - 1);
    reg_fence(o);
    reg_fence(pf);
    wg_fence();
    issue_pv(n - 1);
    wg_commit();
    wg_wait<0>();
    reg_fence(o);
    reg_fence(pf);
    mbar_arrive(W::empty_v(sb, (kv0 + n - 1) % kWgStages));
    mbar_arrive(W::empty_q(sb));
    pipe.kv += n;
    ++pipe.q;
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const long long i = rows[hr];
    if (i >= p.L) continue;
    if (out != nullptr) {
#pragma unroll
      for (int nt = 0; nt < NO / 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = nt * 8 + 2 * t4 + e;
          if (c < p.d)
            out[i * p.d + c] =
                __float2bfloat16_rn(__fdiv_rn(o[4 * nt + 2 * hr + e], lr[hr]));
        }
      }
      continue;
    }
    if (t4 == 0) {
      p.m_out[h * p.m_hs + i * p.m_rs] = mr[hr];
      p.l_out[h * p.l_hs + i * p.l_rs] = lr[hr];
    }
#pragma unroll
    for (int nt = 0; nt < NO / 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = nt * 8 + 2 * t4 + e;
        if (c < p.d)
          p.acc_out[h * p.acc_hs + i * p.acc_rs + c] = o[4 * nt + 2 * hr + e];
      }
    }
  }
  // the quad's m and l, written by lane t4 = 0, are read by all four
  // lanes at this carry's next fold
  __syncwarp();
}

// ---------------------------------------------------------------------------
// host side: the route rule and the tensor maps
// ---------------------------------------------------------------------------

// The route of a fold (hand.flash_route's rule): HIGHEST on the CUDA
// cores; DEFAULT through wgmma for bf16 at d <= 128 in 16-byte chunks,
// else through mma.sync
inline int flash_route(int dtype, bool highest, int d, bool vec) {
  if (highest) return kRouteFma;
  if (dtype == kBF16 && d <= kWgDP && vec) return kRouteWgmma;
  return kRouteMma;
}

using TmaEncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, taken from the driver through the runtime (the
// libraries link no libcuda); null where the driver has none
inline TmaEncodeFn tma_encoder() {
  static const TmaEncodeFn fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<TmaEncodeFn>(f)
               : nullptr;
  }();
  return fn;
}

// The tensor map of a bf16 operand of `rows` rows of d columns (row
// stride rs, head stride hs, in elements) over `heads` heads, in boxes of
// 64 columns × box_rows rows with 128-byte swizzle; rows and columns past
// the operand arrive as zeros. The smaller stride goes nearer the column
// axis; *head_inner says whether that is the head axis.
inline cudaError_t tma_operand(CUtensorMap* map, const void* base, int d,
                               long long rows, int heads, long long rs,
                               long long hs, int box_rows, bool* head_inner) {
  const TmaEncodeFn enc = tma_encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  const bool hin = heads > 1 && hs < rs;
  const long long hstride = heads > 1 ? hs : rows * rs;
  const cuuint64_t dims[3] = {
      static_cast<cuuint64_t>(d),
      static_cast<cuuint64_t>(hin ? heads : rows),
      static_cast<cuuint64_t>(hin ? rows : heads)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(2 * (hin ? hstride : rs)),
      static_cast<cuuint64_t>(2 * (hin ? rs : hstride))};
  const cuuint32_t box[3] = {64u, hin ? 1u : static_cast<cuuint32_t>(box_rows),
                             hin ? static_cast<cuuint32_t>(box_rows) : 1u};
  const cuuint32_t estr[3] = {1u, 1u, 1u};
  const CUresult r =
      enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
          dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  *head_inner = hin;
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace
}  // namespace tpumt
