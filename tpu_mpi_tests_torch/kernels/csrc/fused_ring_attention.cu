// Fused ring attention for Hopper: every step of the ring-attention fold
// in one launch, the K/V rotation done by peer stores inside the kernel.
//
//   tpumt_fused_ring_attention   replaces fused_ring_attention_pallas
//       (tpu_mpi_tests/kernels/collectives_pallas.py:529; body
//       _fused_ring_attention_kernel :376; gate fused_ring_feasible :361).
//
// Computes, on rank `my` of a ring of `w` ranks, the attention of its
// query block q (lq, d) over every rank's K/V block (lk, d): at step s
// the block of source rank (my - s) mod w is folded into the f32 carry
// (m, l, acc) with the flash tile body of flash_fold.cuh, causal in
// global positions (contiguous: my·lq + i against src·lk + j; striped:
// i·w + my against j·w + src), and the result is acc / l in q's dtype —
// bit for bit what w launches of flash_attention.cu make when the
// pipelined tier passes the same offsets (comm/ring.py).
//
// Design (the TPU kernel's VMEM staging and DMA semaphores do not carry
// over):
//   * Grid. A persistent grid of cudaOccupancyMaxActiveBlocksPerMultiprocessor
//     × SMs CTAs (at most one per 64-row query tile; fewer under the
//     caller's max_ctas cap, so that several instances can share a card).
//     Every CTA must be resident: CTAs wait on flags that the rank's
//     other CTAs and its neighbours' CTAs set. The wgmma route's shared
//     memory (WgLayout, ~145 KB) and registers (256 threads, setmaxnreg
//     56/216) hold one CTA an SM; the occupancy API counts them.
//   * Carry. Each CTA owns the query tiles blockIdx.x, blockIdx.x +
//     gridDim.x, ... at every step; their f32 carry lives in a global
//     workspace between steps (the caller's m, l, acc), read and written
//     by the same CTA only.
//   * Entry barrier. Thread 0 of CTA 0 tells both neighbours that this
//     rank entered launch `epoch`; every CTA waits until both have
//     entered theirs (their previous launch on the slots has finished).
//   * Sends. At step s < w-1 the CTAs split the current block (the
//     inputs at s = 0, slot s % 2 after that; K ‖ V) and store it into
//     the right neighbour's slot (s+1) % 2, in 16-byte words where the
//     pointers and sizes allow it. The last CTA to finish fences
//     (__threadfence_system) and releases the right's arrival[s+1].
//   * Credits. A send at s >= 2 first waits for the right neighbour's
//     credit[s-1]: it retired the block it received for its step s-1,
//     which sat in the slot this send overwrites (the credits=2 contract
//     of the JAX kernel, kept per step so that no later signal meets an
//     earlier wait).
//   * Fold. At step s >= 1 the block is read only after arrival[s] (an
//     acquire). After every CTA has folded and forwarded the block of
//     step s, the last one releases the left neighbour's credit[s] (only
//     where the left sends again into that slot: s <= w-3).
//   * Finish. Each CTA writes acc / l of its rows in q's dtype
//     (__fdiv_rn, then round: torch's division and cast).
//   * Timeout. Every wait traps after kWaitTimeoutNs (ring_common.cuh).
// The pad words (64-98) are mapped in ring_common.cuh; the local counters
// are reset by the last CTA of the launch.
//
// Two bodies, by hand.flash_route's rule (the flash kernel's own):
//   * wgmma route (bf16 DEFAULT, d <= 128, 16-byte chunks; every
//     main-path call): warp-specialised like the flash kernel's — warps
//     0-3 fold (flash_wg_consume), warp 4's lane 0 loads by TMA
//     (flash_wg_produce), and warp 5 is the send warp, so that the
//     forward of step s's block runs beside step s's fold. The producer
//     waits for arrival[s] itself and then issues fence.proxy.async.global:
//     the peer stored the slot through the generic proxy, and TMA reads
//     through the async proxy. The send warp waits for arrival[s] and
//     credit[s-1] and reads the slot through L2 (ld.global.cg). A slot is
//     retired when both the consumer warpgroup and the send warp of every
//     CTA are done with it (2 arrivals a CTA). The last step's fold writes
//     the bf16 result straight from its registers.
//   * mma and fma routes (everything else): the send of a step runs
//     before its fold on the same CTAs, and K/V reads go through L2 only
//     (ld.global.cg, cp.async.cg).
//
// The self-ring (world 1, w = k >= 2, my = 0): every pointer is the
// rank's own, and the full k-step schedule runs into its own slots.
//
// Bound on the H100: operations. 4·lq·(w·lk)·d flops (about half of them
// live when causal) on the route's arithmetic (HIGHEST: f32 on the CUDA
// cores, 67 TFLOP/s; DEFAULT: bf16 989 or TF32 495 on the tensor cores)
// against (w-1)·2·lk·d·itemsize bytes forwarded to the right neighbour
// (NVLink, 450 GB/s each way) and q, K, V, out read and written once. At
// (8192, 128) bf16, world 1: 0.0347 ms. A rank with fewer query tiles
// than SMs leaves SMs idle (no split of the key axis yet).
#include <climits>
#include <cstdint>

#include "flash_fold.cuh"
#include "ring_common.cuh"

namespace tpumt {
namespace {

struct FraArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* m;    // carry workspace: (lq,) row maxima
  float* l;    // (lq,) row sums
  float* acc;  // (lq, d) numerators
  char* slots;        // my two parity slots, K then V (at v_off) in each
  char* right_slots;  // the right neighbour's
  int* pad;
  int* left_pad;
  int* right_pad;
  int epoch, w, my, causal, stripe, d;
  long long lq, lk;
  long long kv_bytes;  // bytes of one K (or V) block
  long long v_off;     // V's offset in a slot; a slot is 2·v_off bytes
  float scale;
  int vec;     // the fold moves 16-byte chunks (set by the launcher)
  int copy16;  // the sends move 16-byte words (set by the launcher)
};

// the wgmma route's tensor maps: the inputs, and my two parity slots
// (w > 1)
struct FraMaps {
  CUtensorMap q, k, v;
  CUtensorMap slot_k[2], slot_v[2];
};

// The flash fold's view of a fused launch: the carry updated in place,
// one head; each step sets the block (k, v, k_off). The wgmma route gets
// it as a kernel parameter (its fields then cost the consumers no
// registers) and passes each step's k_off beside it.
__host__ __device__ __forceinline__ Params fra_params(const FraArgs& a) {
  Params p{};
  p.q = a.q;
  p.m_in = p.m_out = a.m;
  p.l_in = p.l_out = a.l;
  p.acc_in = p.acc_out = a.acc;
  p.L = a.lq;
  p.Lk = a.lk;
  p.d = a.d;
  p.q_rs = p.k_rs = p.v_rs = p.acc_rs = a.d;
  p.m_rs = p.l_rs = 1;
  p.q_off = a.stripe ? a.my : static_cast<long long>(a.my) * a.lq;
  p.pos_stride = a.stripe ? a.w : 1;
  p.scale = a.scale;
  p.causal = a.causal;
  p.vec = a.vec;
  return p;
}

// The start of a launch, by every thread of the CTA: the fresh carry of
// this CTA's rows (m = -inf, l = 0, acc = 0) and, at w > 1, the entry
// barrier with both neighbours; the caller's __syncthreads then lets the
// CTA go on.
__device__ __forceinline__ void fra_enter(const FraArgs& a, long long n_qt,
                                          int ctas) {
  for (long long t = blockIdx.x; t < n_qt; t += ctas) {
    const long long q0 = (n_qt - 1 - t) * kQT;
    const long long rows = a.lq - q0 < kQT ? a.lq - q0 : kQT;
    for (long long e = threadIdx.x; e < rows * a.d; e += blockDim.x)
      a.acc[q0 * a.d + e] = 0.f;
    for (long long e = threadIdx.x; e < rows; e += blockDim.x) {
      a.m[q0 + e] = neg_inf();
      a.l[q0 + e] = 0.f;
    }
  }
  if (a.w > 1 && threadIdx.x == 0) {
    if (blockIdx.x == 0) {
      pad_signal(a.left_pad + kFraBarFromRight, a.epoch);
      pad_signal(a.right_pad + kFraBarFromLeft, a.epoch);
    }
    pad_wait(a.pad + kFraBarFromLeft, a.epoch);
    pad_wait(a.pad + kFraBarFromRight, a.epoch);
  }
}

// This CTA's grid-stride share of `bytes` bytes from `src` to `dst`;
// `cg`: the source is a slot a peer stored into during this launch.
__device__ __forceinline__ void send_share(const char* src, char* dst,
                                           long long bytes, int copy16,
                                           bool cg) {
  const long long first =
      blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  if (copy16) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (long long i = first; i < bytes / 16; i += stride)
      d[i] = cg ? __ldcg(s + i) : s[i];
  } else {
    const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
    unsigned short* d = reinterpret_cast<unsigned short*>(dst);
    for (long long i = first; i < bytes / 2; i += stride)
      d[i] = cg ? __ldcg(s + i) : s[i];
  }
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int DP, bool HIGHEST>
__global__ void __launch_bounds__(HIGHEST ? kFmaThreads : kMmaThreads)
    fused_ring_attention_kernel(const FraArgs a) {
  extern __shared__ float4 smem4[];
  const long long n_qt = (a.lq + kQT - 1) / kQT;
  const int ctas = static_cast<int>(gridDim.x);
  const int w = a.w;
  const int d = a.d;

  fra_enter(a, n_qt, ctas);
  __syncthreads();

  Params p = fra_params(a);  // k, v and k_off set at each step

  for (int s = 0; s < w; ++s) {
    const char* cur = a.slots + static_cast<long long>(s % 2) * 2 * a.v_off;
    const char* kb = s == 0 ? static_cast<const char*>(a.k) : cur;
    const char* vb = s == 0 ? static_cast<const char*>(a.v) : cur + a.v_off;
    if (s > 0) coll_wait(a.pad + kFraArr + s, a.epoch);  // block s landed
    if (s < w - 1) {
      // the right retired the block that sits in the slot I store into
      if (s >= 2) coll_wait(a.pad + kFraCred + s - 1, a.epoch);
      char* dst = a.right_slots + static_cast<long long>((s + 1) % 2) * 2 *
                                      a.v_off;
      send_share(kb, dst, a.kv_bytes, a.copy16, s > 0);
      send_share(vb, dst + a.v_off, a.kv_bytes, a.copy16, s > 0);
      coll_arrive(a.pad + kFraSent + s, ctas, a.right_pad + kFraArr + s + 1,
                  a.epoch);
    }
    const int src = ((a.my - s) % w + w) % w;
    p.k = kb;
    p.v = vb;
    p.k_off = a.stripe ? src : static_cast<long long>(src) * a.lk;
    for (long long t = blockIdx.x; t < n_qt; t += ctas) {
      __syncthreads();  // the previous fold's readers of smem4 are done
      const long long q0 = (n_qt - 1 - t) * kQT;
      if constexpr (HIGHEST) {
        flash_fma_fold<T, DP, true>(p, q0, 0, smem4);
      } else {
        flash_mma_fold<T, DP, true>(p, q0, 0, smem4);
      }
    }
    // slot s % 2 is read (folded and forwarded) by every CTA: free it
    // for the left's send of step s + 1
    if (s >= 1 && s <= w - 3)
      coll_arrive(a.pad + kFraRetired + s, ctas, a.left_pad + kFraCred + s,
                  a.epoch);
  }

  __syncthreads();  // this CTA's carry writes are visible to its threads
  T* out = static_cast<T*>(a.out);
  for (long long t = blockIdx.x; t < n_qt; t += ctas) {
    const long long q0 = (n_qt - 1 - t) * kQT;
    const long long rows = a.lq - q0 < kQT ? a.lq - q0 : kQT;
    for (long long e = threadIdx.x; e < rows * d; e += blockDim.x) {
      const long long i = q0 + e / d;
      out[q0 * d + e] = from_f32<T>(__fdiv_rn(a.acc[q0 * d + e], a.l[i]));
    }
  }

  if (w > 1) {  // the last CTA resets the local counters for the next launch
    __syncthreads();
    if (threadIdx.x == 0 && atomicAdd(a.pad + kFraExit, 1) == ctas - 1) {
      for (int s = 0; s < kCollMaxWorld; ++s) {
        atomicExch(a.pad + kFraSent + s, 0);
        atomicExch(a.pad + kFraRetired + s, 0);
      }
      atomicExch(a.pad + kFraExit, 0);
    }
  }
}

// ---------------------------------------------------------------------------
// the wgmma route: consumer warpgroup, producer lane, send warp
// ---------------------------------------------------------------------------


// The send warp's share of `bytes` bytes from `src` to `dst`: this CTA's
// 32 lanes in a grid-wide stride, four 16-byte words in flight a lane;
// `cg`: the source is a slot a peer stored into during this launch.
__device__ __forceinline__ void send_warp_share(const char* src, char* dst,
                                                long long bytes, int copy16,
                                                bool cg) {
  const long long first = blockIdx.x * 32LL + (threadIdx.x & 31);
  const long long stride = gridDim.x * 32LL;
  if (copy16) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    const long long n = bytes / 16;
    long long i = first;
    for (; i + 3 * stride < n; i += 4 * stride) {
      uint4 r[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        r[u] = cg ? __ldcg(s + i + u * stride) : s[i + u * stride];
#pragma unroll
      for (int u = 0; u < 4; ++u) d[i + u * stride] = r[u];
    }
    for (; i < n; i += stride) d[i] = cg ? __ldcg(s + i) : s[i];
  } else {
    const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
    unsigned short* d = reinterpret_cast<unsigned short*>(dst);
    for (long long i = first; i < bytes / 2; i += stride)
      d[i] = cg ? __ldcg(s + i) : s[i];
  }
}

// One of the `arrivals` parties that retire step s's slot; the last
// gives the left neighbour its credit[s]
__device__ __forceinline__ void fra_retire(const FraArgs& a, int s,
                                           int arrivals) {
  __threadfence_system();
  if (atomicAdd(a.pad + kFraRetired + s, 1) == arrivals - 1) {
    __threadfence_system();
    pad_signal(a.left_pad + kFraCred + s, a.epoch);
  }
}

// One of the `arrivals` parties that finish the launch; the last resets
// the local counters for the next launch
__device__ __forceinline__ void fra_exit(const FraArgs& a, int arrivals) {
  __threadfence();
  if (atomicAdd(a.pad + kFraExit, 1) != arrivals - 1) return;
  for (int s = 0; s < kCollMaxWorld; ++s) {
    atomicExch(a.pad + kFraSent + s, 0);
    atomicExch(a.pad + kFraRetired + s, 0);
  }
  atomicExch(a.pad + kFraExit, 0);
}

// the causal offsets of step s (the block of source rank (my - s) mod w)
__device__ __forceinline__ long long fra_k_off(const FraArgs& a, int s) {
  const int src = ((a.my - s) % a.w + a.w) % a.w;
  return a.stripe ? src : static_cast<long long>(src) * a.lk;
}

__global__ void __launch_bounds__(kWgThreads, 1)
    fused_ring_wg_kernel(const FraArgs a, const __grid_constant__ Params p,
                         const __grid_constant__ FraMaps maps) {
  extern __shared__ float4 smem4[];
  const uint32_t sb = wg_smem_base(smem4);
  const long long n_qt = (a.lq + kQT - 1) / kQT;
  const int ctas = static_cast<int>(gridDim.x);
  const int w = a.w;

  fra_enter(a, n_qt, ctas);
  wg_init(sb, p);  // ends in a __syncthreads: the carry and the entry are done

  const int warp = wg_warp(), lane = threadIdx.x & 31;
  WgPipe pipe;
  if (warp >= kWgConsumers / 32) {
    regs_dec<kWgProducerRegs>();
    if (warp > kWgConsumers / 32 + 1) return;  // no role
    if (warp == kWgConsumers / 32) {  // the producer: lane 0 loads
      if (lane != 0) return;
      for (int s = 0; s < w; ++s) {
        if (s > 0) {
          pad_wait(a.pad + kFraArr + s, a.epoch);  // block s landed
          asm volatile("fence.proxy.async.global;" ::: "memory");
        }
        const long long k_off = fra_k_off(a, s);
        const CUtensorMap* km = s == 0 ? &maps.k : &maps.slot_k[s % 2];
        const CUtensorMap* vm = s == 0 ? &maps.v : &maps.slot_v[s % 2];
        for (long long t = blockIdx.x; t < n_qt; t += ctas)
          flash_wg_produce(p, k_off, (n_qt - 1 - t) * kQT, 0, &maps.q, km, vm,
                           sb, pipe);
      }
      return;
    }
    // the send warp
    for (int s = 0; s < w - 1; ++s) {
      const char* cur = a.slots + static_cast<long long>(s % 2) * 2 * a.v_off;
      const char* kb = s == 0 ? static_cast<const char*>(a.k) : cur;
      const char* vb = s == 0 ? static_cast<const char*>(a.v) : cur + a.v_off;
      if (lane == 0) {
        if (s > 0) pad_wait(a.pad + kFraArr + s, a.epoch);  // block s landed
        // the right retired the block that sits in the slot I store into
        if (s >= 2) pad_wait(a.pad + kFraCred + s - 1, a.epoch);
      }
      __syncwarp();
      char* dst =
          a.right_slots + static_cast<long long>((s + 1) % 2) * 2 * a.v_off;
      send_warp_share(kb, dst, a.kv_bytes, a.copy16, s > 0);
      send_warp_share(vb, dst + a.v_off, a.kv_bytes, a.copy16, s > 0);
      __threadfence_system();
      __syncwarp();
      if (lane == 0) {
        if (atomicAdd(a.pad + kFraSent + s, 1) == ctas - 1) {
          __threadfence_system();
          pad_signal(a.right_pad + kFraArr + s + 1, a.epoch);
        }
        if (s >= 1 && s <= w - 3) fra_retire(a, s, 2 * ctas);
      }
    }
    if (w > 1 && lane == 0) fra_exit(a, 2 * ctas);
    return;
  }

  // the consumer warpgroup: every step's fold, the last one finishing
  regs_inc<kWgConsumerRegs>();
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
  for (int s = 0; s < w; ++s) {
    const long long k_off = fra_k_off(a, s);
    for (long long t = blockIdx.x; t < n_qt; t += ctas)
      flash_wg_consume(p, k_off, (n_qt - 1 - t) * kQT, 0, sb, pipe,
                       s == w - 1 ? out : nullptr);
    // slot s % 2 is folded by this CTA: with its send warp's arrival,
    // free it for the left's send of step s + 1
    if (s >= 1 && s <= w - 3) {
      asm volatile("bar.sync 1, %0;" ::"n"(kWgConsumers) : "memory");
      if (threadIdx.x == 0) fra_retire(a, s, 2 * ctas);
    }
  }
  if (w > 1 && threadIdx.x == 0) fra_exit(a, 2 * ctas);
}

int launch_fra_wg(FraArgs a, int max_ctas, int* ctas_out, cudaStream_t s) {
  if (a.lq > INT_MAX || a.lk > INT_MAX) return cudaErrorInvalidValue;
  FraMaps maps{};
  bool hin = false;
  cudaError_t e;
  if ((e = tma_operand(&maps.q, a.q, a.d, a.lq, 1, a.d, 0, kQT, &hin)) !=
          cudaSuccess ||
      (e = tma_operand(&maps.k, a.k, a.d, a.lk, 1, a.d, 0, kWgKT, &hin)) !=
          cudaSuccess ||
      (e = tma_operand(&maps.v, a.v, a.d, a.lk, 1, a.d, 0, kWgKT, &hin)) !=
          cudaSuccess)
    return e;
  for (int par = 0; par < 2 && a.w > 1; ++par) {
    const char* slot = a.slots + static_cast<long long>(par) * 2 * a.v_off;
    if ((e = tma_operand(&maps.slot_k[par], slot, a.d, a.lk, 1, a.d, 0, kWgKT,
                         &hin)) != cudaSuccess ||
        (e = tma_operand(&maps.slot_v[par], slot + a.v_off, a.d, a.lk, 1, a.d,
                         0, kWgKT, &hin)) != cudaSuccess)
      return e;
  }
  const int smem = WgLayout::bytes();
  e = cudaFuncSetAttribute(fused_ring_wg_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fused_ring_wg_kernel, kWgThreads, smem)) !=
      cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // every CTA resident at once: at most the card's capacity
  long long ctas = static_cast<long long>(per_sm) * sms;
  const long long n_qt = (a.lq + kQT - 1) / kQT;
  if (ctas > n_qt) ctas = n_qt;
  if (max_ctas > 0 && ctas > max_ctas) ctas = max_ctas;
  if (ctas < 1) ctas = 1;
  if (ctas_out) *ctas_out = static_cast<int>(ctas);
  fused_ring_wg_kernel<<<static_cast<unsigned>(ctas), kWgThreads, smem,
                         s>>>(a, fra_params(a), maps);
  return cudaGetLastError();
}

template <typename T, int DP, bool HIGHEST>
int launch_fra(FraArgs a, int max_ctas, int* ctas_out, cudaStream_t s) {
  auto kernel = fused_ring_attention_kernel<T, DP, HIGHEST>;
  const int threads = HIGHEST ? kFmaThreads : kMmaThreads;
  const int smem = HIGHEST ? fma_smem_bytes<DP>() : MmaLayout<T, DP>::bytes();
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, smem)) != cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // every CTA resident at once: at most the card's capacity
  long long ctas = static_cast<long long>(per_sm) * sms;
  const long long n_qt = (a.lq + kQT - 1) / kQT;
  if (ctas > n_qt) ctas = n_qt;
  if (max_ctas > 0 && ctas > max_ctas) ctas = max_ctas;
  if (ctas < 1) ctas = 1;
  if (ctas_out) *ctas_out = static_cast<int>(ctas);
  kernel<<<static_cast<unsigned>(ctas), threads, smem, s>>>(a);
  return cudaGetLastError();
}

// `route` as the flash kernel's: HIGHEST's, or the one flash_route names
// for DEFAULT at this geometry (else refused)
template <typename T>
int launch_fra_t(FraArgs a, int route, int max_ctas, int* ctas_out,
                 cudaStream_t s) {
  constexpr long long n = Chunk<T>::N;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a.q) |
                         reinterpret_cast<uintptr_t>(a.k) |
                         reinterpret_cast<uintptr_t>(a.v) |
                         reinterpret_cast<uintptr_t>(a.slots) |
                         reinterpret_cast<uintptr_t>(a.right_slots);
  a.vec = ptrs % 16 == 0 && a.d % n == 0;
  a.copy16 = ptrs % 16 == 0 && a.kv_bytes % 16 == 0;
  const bool highest = route == kRouteFma;
  if (!highest &&
      route != flash_route(sizeof(T) == 2 ? kBF16 : kF32, false, a.d, a.vec))
    return cudaErrorInvalidValue;
  if (route == kRouteWgmma) return launch_fra_wg(a, max_ctas, ctas_out, s);
  if (a.d <= 128) {
    return highest ? launch_fra<T, 128, true>(a, max_ctas, ctas_out, s)
                   : launch_fra<T, 128, false>(a, max_ctas, ctas_out, s);
  }
  return highest ? launch_fra<T, 256, true>(a, max_ctas, ctas_out, s)
                 : launch_fra<T, 256, false>(a, max_ctas, ctas_out, s);
}

}  // namespace
}  // namespace tpumt

// Plain C entry point (bound with ctypes); returns a cudaError_t, 0 when
// the launch was accepted. q (lq, d), k and v (lk, d), out (lq, d), all
// contiguous in the dtype (code of flash_fold.cuh: float32 or bfloat16);
// m, l (lq) and acc (lq, d) float32 scratch for the carry. `slots` holds
// my two parity slots of 2·v_off bytes each (K at 0, V at v_off, v_off a
// multiple of 16 of at least lk·d·itemsize), `right_slots` the right
// neighbour's (both unused at w = 1); the pads are int32 words
// (comm/peer.py). `epoch` counts this process's RDMA launches from 1; `w`
// is the ring's size (world, or k on the self-ring, where every pointer
// is the rank's own and `my` is 0). `route`: the FlashRoute code of
// hand.flash_route, as for the flash kernel (a route the rule does not
// give is refused). `max_ctas` caps the grid (0: the
// card's resident capacity), so that several instances can share a card;
// `ctas_out` (or null) receives the grid size.
extern "C" int tpumt_fused_ring_attention(
    const void* q, const void* k, const void* v, void* out, float* m,
    float* l, float* acc, void* slots, void* right_slots, void* pad,
    void* left_pad, void* right_pad, int epoch, int dtype, long long lq,
    long long lk, int d, int w, int my, long long v_off, double scale,
    int causal, int stripe, int route, int max_ctas, int* ctas_out,
    void* stream) {
  using namespace tpumt;
  const int item = dtype == kF32 ? 4 : 2;
  if (lq < 1 || lk < 1 || d < 1 || d > 256 || w < 1 || w > kCollMaxWorld ||
      my < 0 || my >= w || epoch < 1 || max_ctas < 0 ||
      (stripe && !causal) || (dtype != kF32 && dtype != kBF16) ||
      lk > LLONG_MAX / (static_cast<long long>(d) * item * 2))
    return cudaErrorInvalidValue;
  const long long kv_bytes = lk * d * item;
  if (w > 1 && (slots == nullptr || right_slots == nullptr ||
                v_off < kv_bytes || v_off % 16 != 0))
    return cudaErrorInvalidValue;
  FraArgs a{q,
            k,
            v,
            out,
            m,
            l,
            acc,
            static_cast<char*>(slots),
            static_cast<char*>(right_slots),
            static_cast<int*>(pad),
            static_cast<int*>(left_pad),
            static_cast<int*>(right_pad),
            epoch,
            w,
            my,
            causal,
            stripe,
            d,
            lq,
            lk,
            kv_bytes,
            v_off,
            static_cast<float>(scale),
            0,
            0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_fra_t<float>(a, route, max_ctas, ctas_out, s);
  return launch_fra_t<__nv_bfloat16>(a, route, max_ctas, ctas_out, s);
}
