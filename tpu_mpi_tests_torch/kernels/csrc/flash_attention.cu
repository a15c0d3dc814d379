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
// streams 64-column K/V tiles through shared memory for any Lk. Grid:
// one CTA per (64-row query tile, head); blockIdx.x walks the query
// tiles from the last, so under a causal mask the CTAs with the most
// live tiles start first. A K/V tile dead for every row of the CTA is
// never loaded or computed (the causal tile skip); one live for every
// row runs without the mask. The L×L score matrix never leaves the SM.
//
// The fold bodies live in flash_fold.cuh (shared with the fused ring
// attention, fused_ring_attention.cu); the kernels below run one body
// per CTA. Two arithmetic routes, chosen by the wrapper's precision:
//   * HIGHEST — f32 FMA on the CUDA cores (flash_fma_fold): bf16
//     operands are widened to f32 on load, as _qk_operands/_pv_operands
//     (:2917, :2933) upcast them, and P stays f32 into the PV product.
//     256 threads; each owns 4 query rows × 4 score columns and 4 rows ×
//     d/16 output columns, fed by 16-byte shared-memory loads (Q, K and P
//     stored transposed). At d <= 128 the next K/V tile is fetched into
//     registers while the current one is computed.
//   * DEFAULT — tensor cores through mma.sync (flash_mma_fold), 4
//     warps of 16 query rows: bf16 m16n8k16 (bf16 → f32) with P rounded
//     to bf16 before the PV product, as _pv_operands rounds it; f32
//     operands as TF32 m16n8k8 (cvt.rna on each fragment), the card's
//     counterpart of the TPU's single-pass DEFAULT. The S accumulator
//     fragments feed the PV product's A operand straight from registers
//     (for TF32 through a fixed permutation of the 8 key slots, applied
//     to V's rows too). K/V tiles arrive by cp.async into two shared-
//     memory buffers, the next tile in flight while the current one is
//     computed (one buffer for TF32 at d > 128, for want of room).
//
// Bound on the H100: operations. 4·L·Lk·d flops (half of them live when
// causal) against ~(3·Lk + 2·L)·d·itemsize + carries bytes — at L = Lk
// = 8192, d = 128 some 20 MB against 34 GFLOP: far above the ridge, so
// the time is the arithmetic's, 67 TFLOP/s on the CUDA cores (HIGHEST)
// or 989 (bf16) / 495 (TF32) on the tensor cores. This kernel stays
// simple: no TMA, no wgmma, no warp specialisation, no split of the key
// axis across CTAs (so a single head at L = 8192 fills only 128 of the
// 132 SMs with 4–8 warps each). Those are later work.
//
// Shapes: any L >= 1, Lk >= 1 and 1 <= d <= 256 (d is padded to 128 or
// 256 in shared memory with zeros); rows, heads and the key axis are
// addressed through element strides, so an (L, H, d) layout needs no
// copy. Global loads move 16-byte chunks when d, the strides and the
// pointers allow it, else element by element. expf (not __expf) keeps
// the comparison with the plain version tight.
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

template <typename T, int DP>
int launch_dp(const Params& p, int heads, int highest, cudaStream_t s) {
  if (highest)
    return launch(flash_fma_kernel<T, DP>, kFmaThreads, fma_smem_bytes<DP>(),
                  p, heads, s);
  return launch(flash_mma_kernel<T, DP>, kMmaThreads,
                MmaLayout<T, DP>::bytes(), p, heads, s);
}

// q, k and v move in 16-byte chunks when every row and head start is
// 16-byte aligned and d fills whole chunks
template <typename T>
int launch_t(Params p, int heads, int highest, cudaStream_t s) {
  constexpr long long n = Chunk<T>::N;
  const bool aligned = (reinterpret_cast<uintptr_t>(p.q) |
                        reinterpret_cast<uintptr_t>(p.k) |
                        reinterpret_cast<uintptr_t>(p.v)) % 16 == 0;
  p.vec = aligned && p.d % n == 0 && p.q_rs % n == 0 && p.q_hs % n == 0 &&
          p.k_rs % n == 0 && p.k_hs % n == 0 && p.v_rs % n == 0 &&
          p.v_hs % n == 0;
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
// the last axis of each operand is contiguous. `highest` selects the
// f32 CUDA-core route (1) or the tensor-core route (0).
extern "C" int tpumt_flash_attention_block(
    const void* q, const void* k, const void* v, const float* m_in,
    const float* l_in, const float* acc_in, float* m_out, float* l_out,
    float* acc_out, int dtype, long long L, long long Lk, int d, int heads,
    long long q_rs, long long q_hs, long long k_rs, long long k_hs,
    long long v_rs, long long v_hs, long long m_rs, long long m_hs,
    long long l_rs, long long l_hs, long long acc_rs, long long acc_hs,
    long long q_off, long long k_off, long long pos_stride, double scale,
    int causal, int highest, void* stream) {
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
      return launch_t<float>(p, heads, highest, s);
    case kBF16:
      return launch_t<__nv_bfloat16>(p, heads, highest, s);
    default:
      return cudaErrorInvalidValue;
  }
}
