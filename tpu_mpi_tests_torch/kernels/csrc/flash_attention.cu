// Flash-attention block fold for Hopper:
//
//   tpumt_flash_attention_block   replaces flash_attention_block_pallas
//       (tpu_mpi_tests/kernels/pallas_kernels.py:3230; bodies
//       _flash_block_kernel :2942 and _flash_stream_kernel :3103) and,
//       through its wrapper, flash_attention_pallas (:3416).
//
// Computes, for every query row i of q (L, d) against one K/V block
// (Lk, d), the online-softmax fold of that block into the f32 carry
// (m, l, acc) of shapes (L,1), (L,1), (L,d) — the recurrence of
// comm.ring.online_softmax_update, tile by tile:
//
//   s      = (q_i · k_j) * scale, -inf where causal and
//            q_off + stride·i < k_off + stride·j (global positions)
//   m_new  = max(m, max_j s);   m_safe = m_new == -inf ? 0 : m_new
//   p      = exp(s - m_safe);   corr = exp(m - m_safe)
//   l      = l·corr + Σ_j p;    acc = acc·corr + p·V;   m = m_new
//
// A row whose columns are all masked keeps m = -inf and l, acc as the
// recurrence leaves them, with no NaN (the m_safe guard). The carry may
// be updated in place (out == in): each CTA reads its rows' m, l and acc
// once, before the loop, and writes them once, after it.
//
// The TPU's resident-vs-streaming split (_fit_flash_tiles :2848,
// _fit_stream_tiles :2884) was a VMEM-budget artefact; here one kernel
// streams K/V tiles through shared memory for any Lk. Grid:
// one CTA per (64-row query tile, head); blockIdx.x walks the query
// tiles from the last, so under a causal mask the CTAs with the most
// live tiles start first. A K/V tile dead for every row of the CTA is
// never loaded or computed (the causal tile skip); one live for every
// row runs without the mask. The L×L score matrix never leaves the SM.
//
// The fold bodies live in flash_fold.cuh (shared with the fused ring
// attention, fused_ring_attention.cu); the kernels below run one body
// per CTA. Four routes, named by the wrapper (hand.flash_route) and
// checked here against the same rule:
//   * wgmma — bf16 at DEFAULT, d <= 128, every operand in 16-byte chunks:
//     every main-path fold. A CTA is one consumer warpgroup (64 query
//     rows) and a producer warpgroup whose warp 4 loads, one CTA an SM;
//     setmaxnreg gives the producer warpgroup's registers to the
//     consumers (56 and 216). The producer loads Q and then the live K/V
//     tiles (kWgKT = 128 key rows) by TMA into a ring of two stages with
//     128-byte swizzle, a full and an empty mbarrier per stage and
//     operand; the tensor maps are encoded here, on the host
//     (cuTensorMapEncodeTiled through cudaGetDriverEntryPointByVersion:
//     no libcuda is linked), from the (row, head) element strides, and
//     passed as __grid_constant__ parameters. The consumers run S = Q·Kᵀ
//     as wgmma from shared memory, the softmax in registers (exp2 of
//     log2(e)-scaled scores), and O += P·V as wgmma with P from registers
//     (rounded to bf16, as _pv_operands rounds it) and V read MN-major;
//     each tile's S and the previous tile's PV are issued together and
//     the softmax of S runs while the tensor cores run that PV. One CTA
//     per 64 query rows keeps a single head at L = 8192 on 128 of the 132
//     SMs (a 128-row tile would fill 64).
//   * mma — the rest of DEFAULT, on mma.sync, 4 warps of 16 query rows:
//     bf16 m16n8k16 with P rounded to bf16, f32 operands as TF32 m16n8k8
//     (cvt.rna on each fragment; wgmma's TF32 form wants V K-major, which
//     it is not as stored), the card's counterpart of the TPU's
//     single-pass DEFAULT. It serves f32 DEFAULT, and bf16 at d in (128,
//     256], with misaligned operands or d not a whole number of chunks.
//     K/V tiles arrive by cp.async into two buffers (one for TF32 at d >
//     128, for want of room).
//   * tf32x3 — f32 at HIGHEST, d <= 128, every operand in 16-byte
//     chunks: every f32 HIGHEST main-path fold. The wgmma route's roles
//     and schedule on f32 tiles (32-column TMA boxes, two stages of 32
//     keys), every product in three TF32 wgmma passes (small·big,
//     big·small, big·big) with f32 accumulators, each tile's PV summed
//     apart and added to acc in f32; warps 5-7 split Q and K, the
//     consumers transpose V into K-major Vᵀ, P is split in registers
//     (flash_fold.cuh).
//   * fma — HIGHEST for the rest: f32 FMA on the CUDA cores
//     (flash_fma_fold): bf16 operands are widened to f32 on load, as
//     _qk_operands/_pv_operands (:2917, :2933) upcast them, and P stays
//     f32 into the PV product.
//     256 threads; each owns 4 query rows × 4 score columns and 4 rows ×
//     d/16 output columns, fed by 16-byte shared-memory loads (Q, K and P
//     stored transposed). At d <= 128 the next K/V tile is fetched into
//     registers while the current one is computed.
//
// Bound on the H100: operations. 4·L·Lk·d flops (half of them live when
// causal) against ~(3·Lk + 2·L)·d·itemsize + carries bytes — at L = Lk
// = 8192, d = 128 some 20 MB against 34.4 GFLOP: far above the ridge, so
// the time is the arithmetic's: 0.0347 ms on the bf16 tensor cores (989
// TFLOP/s), 0.069 ms in TF32 (495), 0.208 ms in 3xTF32 (three passes at
// 495), 0.51 ms on the CUDA cores (67). No
// split of the key axis across CTAs yet: a ring rank's 2048-query block
// fills 32 SMs.
//
// Shapes: any L >= 1, Lk >= 1 and 1 <= d <= 256 (d is padded to 128 or
// 256 in shared memory with zeros); rows, heads and the key axis are
// addressed through element strides, so an (L, H, d) layout needs no
// copy. The mma and fma routes move 16-byte chunks when d, the strides
// and the pointers allow it, else element by element, and use expf (not
// __expf) to keep the comparison with the plain version tight.
#include <climits>

#include "flash_fold.cuh"

namespace tpumt {
namespace {

// one CTA per (64-row query tile, head): the bodies of flash_fold.cuh
template <typename T, int DP>
__global__ void __launch_bounds__(kFmaThreads)
    flash_fma_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  flash_fma_fold<T, DP, false>(p, cta_q0(p), blockIdx.y, smem4);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kMmaThreads)
    flash_mma_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  flash_mma_fold<T, DP, false>(p, cta_q0(p), blockIdx.y, smem4);
}

// one CTA per (64-row query tile, head): warps 0-3 consume, warp 4's
// lane 0 loads, warps 5-7 only give their registers; the roles split once
// and never meet again
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_wg_kernel(const Params p, const __grid_constant__ WgMaps maps) {
  extern __shared__ float4 smem4[];
  const uint32_t sb = wg_smem_base(smem4);
  wg_init(sb, p);
  const long long q0 = cta_q0(p);
  const int h = blockIdx.y;
  WgPipe pipe;
  if (wg_warp() >= kWgConsumers / 32) {
    regs_dec<kWgProducerRegs>();
    if (threadIdx.x == kWgConsumers)
      flash_wg_produce(p, p.k_off, q0, h, &maps.q, &maps.k, &maps.v, sb,
                       pipe);
  } else {
    regs_inc<kWgConsumerRegs>();
    flash_wg_consume(p, p.k_off, q0, h, sb, pipe, nullptr);
  }
}

// the tf32x3 route: the wgmma route's roles, warps 5-7 splitting each
// landed tile into TF32 big and small parts
__global__ void __launch_bounds__(kX3Threads, 1)
    flash_x3_kernel(const Params p, const __grid_constant__ WgMaps maps) {
  extern __shared__ float4 smem4[];
  constexpr int kSplit0 = kWgConsumers + 32;
  const uint32_t sb = wg_smem_base(smem4);
  x3_init(sb, p, kX3Threads - kSplit0);
  const long long q0 = cta_q0(p);
  const int h = blockIdx.y;
  WgPipe pipe;
  const int warp = wg_warp();
  if (warp >= kWgConsumers / 32) {
    regs_dec<kX3ProducerRegs>();
    if (threadIdx.x == kWgConsumers)
      flash_x3_produce(p, p.k_off, q0, h, &maps.q, &maps.k, &maps.v, sb,
                       pipe);
    else if (warp > kWgConsumers / 32)
      flash_x3_split(p, p.k_off, q0, sb, pipe, threadIdx.x - kSplit0,
                     kX3Threads - kSplit0);
  } else {
    regs_inc<kX3ConsumerRegs>();
    flash_x3_consume(p, p.k_off, q0, h, sb, pipe, nullptr);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename Kernel>
int launch(Kernel kernel, int threads, int smem, const Params& p, int heads,
           cudaStream_t stream) {
  // above 48 KB a kernel must opt in to dynamic shared memory; the
  // attribute is per kernel, so set it every launch (a host-side call)
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const long long n_qt = (p.L + kQT - 1) / kQT;
  if (n_qt > 0x7fffffffLL || heads > 65535) return cudaErrorInvalidValue;
  kernel<<<dim3(static_cast<unsigned>(n_qt), heads), threads, smem, stream>>>(
      p);
  return cudaGetLastError();
}

// the wgmma (bf16) or tf32x3 (f32, X3) route: the operands' tensor maps,
// then one launch
template <bool X3>
int launch_tma(Params p, int heads, cudaStream_t s) {
  if (p.L > INT_MAX || p.Lk > INT_MAX) return cudaErrorInvalidValue;
  constexpr int elem = X3 ? 4 : 2;
  constexpr int kt = X3 ? kX3KT : kWgKT;
  WgMaps maps;
  bool hq = false, hk = false, hv = false;
  cudaError_t e;
  if ((e = tma_operand(&maps.q, p.q, elem, p.d, p.L, heads, p.q_rs, p.q_hs,
                       kQT, &hq)) != cudaSuccess ||
      (e = tma_operand(&maps.k, p.k, elem, p.d, p.Lk, heads, p.k_rs, p.k_hs,
                       kt, &hk)) != cudaSuccess ||
      (e = tma_operand(&maps.v, p.v, elem, p.d, p.Lk, heads, p.v_rs, p.v_hs,
                       kt, &hv)) != cudaSuccess)
    return e;
  p.head_inner = (hq ? 1 : 0) | (hk ? 2 : 0) | (hv ? 4 : 0);
  const auto kernel = X3 ? flash_x3_kernel : flash_wg_kernel;
  const int smem = X3 ? X3Layout::bytes() : WgLayout::bytes();
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const long long n_qt = (p.L + kQT - 1) / kQT;
  if (n_qt > 0x7fffffffLL || heads > 65535) return cudaErrorInvalidValue;
  kernel<<<dim3(static_cast<unsigned>(n_qt), heads),
           X3 ? kX3Threads : kWgThreads, smem, s>>>(p, maps);
  return cudaGetLastError();
}

template <typename T, int DP>
int launch_dp(const Params& p, int heads, int highest, cudaStream_t s) {
  if (highest)
    return launch(flash_fma_kernel<T, DP>, kFmaThreads, fma_smem_bytes<DP>(),
                  p, heads, s);
  return launch(flash_mma_kernel<T, DP>, kMmaThreads,
                MmaLayout<T, DP>::bytes(), p, heads, s);
}

// q, k and v move in 16-byte chunks when every row and head start is
// 16-byte aligned and d fills whole chunks. `route` must be the one
// flash_route names for its precision at this geometry: a launch never
// takes another route than the caller counted.
template <typename T>
int launch_t(Params p, int heads, int route, cudaStream_t s) {
  constexpr long long n = Chunk<T>::N;
  const bool aligned = (reinterpret_cast<uintptr_t>(p.q) |
                        reinterpret_cast<uintptr_t>(p.k) |
                        reinterpret_cast<uintptr_t>(p.v)) % 16 == 0;
  p.vec = aligned && p.d % n == 0 && p.q_rs % n == 0 && p.q_hs % n == 0 &&
          p.k_rs % n == 0 && p.k_hs % n == 0 && p.v_rs % n == 0 &&
          p.v_hs % n == 0;
  const bool highest = route_is_highest(route);
  if (route !=
      flash_route(sizeof(T) == 2 ? kBF16 : kF32, highest, p.d, p.vec))
    return cudaErrorInvalidValue;
  if (route == kRouteWgmma) return launch_tma<false>(p, heads, s);
  if (route == kRouteTf32x3) return launch_tma<true>(p, heads, s);
  if (p.d <= 128) return launch_dp<T, 128>(p, heads, highest, s);
  return launch_dp<T, 256>(p, heads, highest, s);
}

}  // namespace
}  // namespace tpumt

// Plain C entry point (bound with ctypes); returns a cudaError_t, 0 when
// the launch was accepted. Operands q (L, d), k and v (Lk, d) per head,
// carries m_in/l_in (L, 1) and acc_in (L, d) in float32, written to
// m_out/l_out/acc_out (the same buffers for the in-place fold, else
// disjoint ones with the same strides). Every stride is in elements;
// the last axis of each operand is contiguous. `route`: the FlashRoute
// code that hand.flash_route names (tf32x3 or fma for HIGHEST, wgmma or
// mma for DEFAULT, by the geometry); a route the rule does not give is
// refused.
extern "C" int tpumt_flash_attention_block(
    const void* q, const void* k, const void* v, const float* m_in,
    const float* l_in, const float* acc_in, float* m_out, float* l_out,
    float* acc_out, int dtype, long long L, long long Lk, int d, int heads,
    long long q_rs, long long q_hs, long long k_rs, long long k_hs,
    long long v_rs, long long v_hs, long long m_rs, long long m_hs,
    long long l_rs, long long l_hs, long long acc_rs, long long acc_hs,
    long long q_off, long long k_off, long long pos_stride, double scale,
    int causal, int route, void* stream) {
  using namespace tpumt;
  if (L < 1 || Lk < 1 || d < 1 || d > 256 || heads < 1 || pos_stride < 1)
    return cudaErrorInvalidValue;
  Params p{q,    k,    v,    m_in, l_in, acc_in, m_out, l_out,
           acc_out, L, Lk, d,    q_rs, q_hs,   k_rs,  k_hs,
           v_rs, v_hs, m_rs, m_hs, l_rs, l_hs,   acc_rs, acc_hs,
           q_off, k_off, pos_stride, static_cast<float>(scale), causal, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_t<float>(p, heads, route, s);
    case kBF16:
      return launch_t<__nv_bfloat16>(p, heads, route, s);
    default:
      return cudaErrorInvalidValue;
  }
}
