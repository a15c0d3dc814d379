// ALU op-rate probe: out = body^reps(z) on B independent (H, W) blocks,
// with no traffic to device memory between repetitions.
//
// Replaces the Pallas kernel vpu_probe_pallas
// (tpu_mpi_tests/kernels/pallas_kernels.py:469; body _vpu_probe_kernel
// :231), which loads one block into the TPU's VMEM, applies `reps`
// repetitions of an op mix and writes it back.
//
// The mixes (one repetition each, every rep reading only the previous
// rep's values):
//   fma           a*z + b                                   (:245)
//   step5_d0/_d1  the k-step stencil update on [2, N-2) along the axis,
//                 z0 + se*(c1*(z+1 - z-1) + c2*(z+2 - z-2))  (:448, :834)
//   step5fma_*    the same update as raw se-folded taps,
//                 (((z0 + t1*z+1) + tm1*z-1) + t2*z+2) + tm2*z-2   (:433)
//   heat5         the heat Laplacian step on [1, H-1) x [1, W-1),
//                 (w + cx*((up+down) - 2w)) + cy*((left+right) - 2w),
//                 the border kept                            (:258)
//   dualdim       4-tap derivatives on both axes (dx on rows [2, H-2) over
//                 all columns, dy on columns [2, W-2) over all rows), two
//                 row-masked f32 sums of squares, the derivatives folded
//                 back at `se`, and shift = f32(se) * (sums / 1024) added
//                 to every element                            (:284)
//   dualdim_lean  difference-form folded-coefficient taps on the
//                 both-axes interior, one fused masked sum, the same
//                 feedback                                    (:351)
//
// Bound on the H100: operations. Every rep of every mix is lone mul, add
// and sub instructions (-fmad=false), 128 lanes a clock an SM, bfloat16
// two elements an instruction; nothing need touch device memory between
// the first load and the last store.
//
// Two routes (hand.PROBE_ROUTES; a route's code is its index), named by
// the block's shape (hand.probe_route, probe_route here):
//
// "cluster" (probe_cluster_kernel): one thread-block cluster a block,
// from the first load to the last store. The block's rows are split over
// the cluster's CTAs (rs rows a CTA's slab) and nothing goes to device
// memory between reps:
//   * fma reads no neighbour: a thread's elements stay in registers for
//     all reps, with no barrier at all;
//   * the dim-1 mixes (step5_d1, step5fma_d1) read only their own row: a
//     warp holds whole rows in registers, a lane a run of vectors, and a
//     rep takes the two elements a side from lanes -1 / +1 by shuffles,
//     with no shared memory and no barrier;
//   * the dim-0 mixes (step5_d0, step5fma_d0): a thread holds one 16-byte
//     column vector of a run of 8 rows in registers; a rep reads only the
//     2 rows above and below a run, which every thread publishes after
//     its rep into an edge buffer in shared memory, and the cluster
//     barrier (barrier.cluster.arrive.release / wait.acquire) is split
//     around the run's interior rows, which need no neighbour: the first
//     and last runs' rows come from the neighbouring CTAs' buffers
//     through distributed shared memory (mapa, ld.shared::cluster);
//   * heat5 and the dual mixes, and blocks whose slabs do not fall into
//     those register shapes (8-row runs, whole warps of vectors a row):
//     a shared-memory ping-pong of the slabs, a thread a column vector
//     walking a run of rows through a 5-row register window, the slab's
//     edge rows read from the neighbours' slabs through DSMEM, one
//     cluster barrier a rep (a CTA barrier for the dim-1 mixes). The dual
//     mixes' whole-block sums: a fixed-order tree a CTA, then each CTA's
//     partial read through DSMEM after the barrier and added in rank
//     order, so every CTA applies the same shift, the same from run to
//     run.
// bfloat16 runs as add/sub/mul.rn.bf16x2 (Pk<T>),
// bit-equal to float-then-round. The cluster is the fewest CTAs (1, 2,
// 4, 8, 16; 16 with cudaFuncAttributeNonPortableClusterSizeAllowed) whose
// two slabs fit kClusterSmem bytes a CTA with at least 2 rows a slab:
// (512, 512) takes 16 CTAs of 128 KiB in float32, 8 in bfloat16.
//
// "l2" (probe_kernel, the blocks too large for a cluster, up to the L2
// guard of the wrapper): two ping-pong buffers in global memory, small
// enough to stay in the 50 MB L2, and ONE cooperative launch advances
// every block: a CTA owns 32 x 128 tiles (a grid-stride loop over the
// tiles of all blocks), stages each tile and its 2-deep apron in shared
// memory, computes, and writes the other buffer; cg::grid_group::sync()
// separates repetitions. The grid never exceeds what the card can hold
// co-resident (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs). The
// dual mixes' tiles write partial sums; after the grid barrier every CTA
// sums its block's partials in one fixed order and applies the shift
// while it loads the next rep's window (a last pass applies the final
// shift). Per rep: one grid barrier plus a pass over L2.
//
// Rounding: as the kernels it prices (_rn intrinsics, -fmad=false, bf16
// rounded after every op, coefficients rounded to the dtype first), so a
// lone mul and a lone add are issued, never an FMA. fma, step5*, heat5
// equal the plain PyTorch version bit for bit on both routes; the dual
// mixes differ by the order of the sums.
#include <cooperative_groups.h>

#include <climits>
#include <cstdint>

#include "stencil_common.cuh"

namespace cg = cooperative_groups;

namespace tpumt {
namespace {

enum Mix : int {
  kFma = 0,
  kStep5D0 = 1,
  kStep5D1 = 2,
  kStep5FmaD0 = 3,
  kStep5FmaD1 = 4,
  kHeat5 = 5,
  kDualDim = 6,
  kDualDimLean = 7,
  kNumMixes = 8,
};

constexpr int TR = 32;   // tile rows
constexpr int TC = 128;  // tile columns
constexpr int G = 2;     // apron depth (the stencil radius)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWR = TR + 2 * G;
constexpr int kWC = TC + 2 * G;

// the mix's constants, already rounded to the array dtype (see the
// wrapper for which slot holds what)
struct Coef {
  float v[8];
};

// Two block-wide sums in one fixed-order pass: a butterfly over each
// warp (every lane ends with the same bits: float add commutes), then
// the warps' values in order. Every thread returns the totals. `red`
// holds 2 * kW floats, kW the CTA's warps.
template <int kW>
__device__ float2 block_sum2(float a, float b, float* red) {
  for (int o = 16; o > 0; o >>= 1) {
    a = __fadd_rn(a, __shfl_xor_sync(0xffffffffu, a, o));
    b = __fadd_rn(b, __shfl_xor_sync(0xffffffffu, b, o));
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // red may still be read from the previous call
  if (lane == 0) {
    red[warp] = a;
    red[kW + warp] = b;
  }
  __syncthreads();
  float ta = red[0], tb = red[kW];
  for (int w = 1; w < kW; ++w) {
    ta = __fadd_rn(ta, red[w]);
    tb = __fadd_rn(tb, red[kW + w]);
  }
  return make_float2(ta, tb);
}

// The shift one block's partials give: f32(se) * ((sum_x + sum_y) /
// 1024), rounded to the array dtype. `part` holds (x, y) per tile.
template <typename T>
__device__ float block_shift(const float* part, long long n_tiles,
                             float se32, float* red) {
  using E = Elt<T>;
  float sx = 0.f, sy = 0.f;
  for (long long k = threadIdx.x; k < n_tiles; k += kThreads) {
    sx = __fadd_rn(sx, part[2 * k]);
    sy = __fadd_rn(sy, part[2 * k + 1]);
  }
  const float2 s = block_sum2<kWarps>(sx, sy, red);
  const float r = __fdiv_rn(__fadd_rn(s.x, s.y), 1024.0f);
  const T rounded = E::store(__fmul_rn(se32, r));
  return E::load(&rounded);
}

template <typename T, int MIX>
__global__ void __launch_bounds__(kThreads)
    probe_kernel(const T* z, T* buf_a, T* buf_b, float* part,
                 long long n_blocks, long long H, long long W, int reps,
                 Coef k, float se32, long long tiles_c,
                 long long tiles_per_block) {
  using E = Elt<T>;
  using C = typename E::C;
  constexpr bool kDual = MIX == kDualDim || MIX == kDualDimLean;
  constexpr bool kWindow = MIX != kFma;
  cg::grid_group grid = cg::this_grid();
  __shared__ C win[kWindow ? kWR * kWC : 1];
  __shared__ float red[2 * kWarps];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const long long total = n_blocks * tiles_per_block;
  const long long plane = H * W;

  const T* src = z;
  T* last = nullptr;
  for (int rep = 0; rep < reps; ++rep) {
    T* dst = (rep & 1) ? buf_b : buf_a;
    float* part_w = part + (rep & 1) * 2 * total;
    const float* part_r = part + ((rep & 1) ^ 1) * 2 * total;
    const bool pending = kDual && rep > 0;  // last rep's shift not yet in src
    for (long long tile = blockIdx.x; tile < total; tile += gridDim.x) {
      const long long blk = tile / tiles_per_block;
      const long long t = tile % tiles_per_block;
      const long long i0 = (t / tiles_c) * TR, j0 = (t % tiles_c) * TC;
      const T* zs = src + blk * plane;
      T* zd = dst + blk * plane;
      C shift = C(0);
      if (pending) {
        shift = block_shift<T>(part_r + 2 * blk * tiles_per_block,
                               tiles_per_block, se32, red);
      }
      if constexpr (kWindow) {
        // window position (p, q) holds z[i0 - G + p, j0 - G + q]
        for (int p = ty; p < kWR; p += kWarps) {
          const long long r = i0 - G + p;
          for (int q = tx; q < kWC; q += 32) {
            const long long c = j0 - G + q;
            C v = C(0);
            if (r >= 0 && r < H && c >= 0 && c < W) {
              v = E::load(zs + r * W + c);
              if (pending) v = E::add(v, shift);
            }
            win[p * kWC + q] = v;
          }
        }
        __syncthreads();
      }
      float sum_a = 0.f, sum_b = 0.f;
      for (int p = ty; p < TR; p += kWarps) {
        const long long i = i0 + p;
        if (i >= H) break;
        for (int q = tx; q < TC; q += 32) {
          const long long j = j0 + q;
          if (j >= W) break;
          // the centre of the stencil in the window (unused by fma)
          const C* c = kWindow ? win + (p + G) * kWC + (q + G) : win;
          C out;
          if constexpr (MIX == kFma) {
            out = E::add(E::mul(k.v[0], E::load(zs + i * W + j)), k.v[1]);
          } else if constexpr (MIX == kStep5D0 || MIX == kStep5D1 ||
                               MIX == kStep5FmaD0 ||
                               MIX == kStep5FmaD1) {
            const bool d0 = MIX == kStep5D0 || MIX == kStep5FmaD0;
            const int s = d0 ? kWC : 1;
            const long long a = d0 ? i : j, n = d0 ? H : W;
            out = c[0];
            if (a >= G && a < n - G) {
              if constexpr (MIX == kStep5D0 || MIX == kStep5D1) {
                const C acc = E::add(
                    E::mul(k.v[1], E::sub(c[s], c[-s])),
                    E::mul(k.v[2], E::sub(c[2 * s], c[-2 * s])));
                out = E::add(c[0], E::mul(k.v[0], acc));
              } else {
                out = E::add(c[0], E::mul(k.v[0], c[s]));
                out = E::add(out, E::mul(k.v[1], c[-s]));
                out = E::add(out, E::mul(k.v[2], c[2 * s]));
                out = E::add(out, E::mul(k.v[3], c[-2 * s]));
              }
            }
          } else if constexpr (MIX == kHeat5) {
            out = c[0];
            if (i >= 1 && i < H - 1 && j >= 1 && j < W - 1) {
              const C two_w = E::mul(k.v[2], c[0]);
              const C lx = E::sub(E::add(c[kWC], c[-kWC]), two_w);
              const C ly = E::sub(E::add(c[-1], c[1]), two_w);
              out = E::add(E::add(c[0], E::mul(k.v[0], lx)),
                           E::mul(k.v[1], ly));
            }
          } else if constexpr (MIX == kDualDim) {
            out = c[0];
            if (i >= G && i < H - G) {  // dx row i - G, every column
              C ax = E::mul(k.v[0], c[-2 * kWC]);
              ax = E::add(ax, E::mul(k.v[1], c[-kWC]));
              ax = E::add(ax, E::mul(k.v[2], c[kWC]));
              ax = E::add(ax, E::mul(k.v[3], c[2 * kWC]));
              const C dx = E::mul(ax, k.v[4]);
              if (i - G < H - 2 * G - 1) {
                sum_a = __fadd_rn(sum_a, __fmul_rn(dx, dx));
              }
              out = E::add(out, E::mul(k.v[6], dx));
            }
            if (j >= G && j < W - G) {  // dy column j - G, every row
              C ay = E::mul(k.v[0], c[-2]);
              ay = E::add(ay, E::mul(k.v[1], c[-1]));
              ay = E::add(ay, E::mul(k.v[2], c[1]));
              ay = E::add(ay, E::mul(k.v[3], c[2]));
              const C dy = E::mul(ay, k.v[5]);
              if (i < H - 1) sum_b = __fadd_rn(sum_b, __fmul_rn(dy, dy));
              out = E::add(out, E::mul(k.v[6], dy));
            }
          } else {  // kDualDimLean
            out = c[0];
            if (i >= G && i < H - G && j >= G && j < W - G) {
              const C dx = E::add(
                  E::mul(k.v[0], E::sub(c[kWC], c[-kWC])),
                  E::mul(k.v[1], E::sub(c[2 * kWC], c[-2 * kWC])));
              const C dy = E::add(E::mul(k.v[2], E::sub(c[1], c[-1])),
                                  E::mul(k.v[3], E::sub(c[2], c[-2])));
              if (i - G < H - 2 * G - 1) {
                sum_a = __fadd_rn(
                    sum_a, __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
              }
              out = E::add(E::add(out, E::mul(k.v[4], dx)),
                           E::mul(k.v[4], dy));
            }
          }
          zd[i * W + j] = E::store(out);
        }
      }
      if constexpr (kDual) {
        const float2 s = block_sum2<kWarps>(sum_a, sum_b, red);
        if (threadIdx.x == 0) {
          part_w[2 * tile] = s.x;
          part_w[2 * tile + 1] = s.y;
        }
      }
      if constexpr (kWindow) __syncthreads();  // the next tile overwrites win
    }
    if (kDual || rep + 1 < reps) grid.sync();
    src = dst;
    last = dst;
  }

  if (kDual && last != nullptr) {
    // the last rep's shift, in place: each element read and written by
    // one thread
    const float* part_r = part + ((reps - 1) & 1) * 2 * total;
    for (long long tile = blockIdx.x; tile < total; tile += gridDim.x) {
      const long long blk = tile / tiles_per_block;
      const long long t = tile % tiles_per_block;
      const long long i0 = (t / tiles_c) * TR, j0 = (t % tiles_c) * TC;
      T* zd = last + blk * plane;
      const C shift = block_shift<T>(part_r + 2 * blk * tiles_per_block,
                                     tiles_per_block, se32, red);
      for (int p = ty; p < TR; p += kWarps) {
        const long long i = i0 + p;
        if (i >= H) break;
        for (int q = tx; q < TC; q += 32) {
          const long long j = j0 + q;
          if (j >= W) break;
          zd[i * W + j] = E::store(E::add(E::load(zd + i * W + j), shift));
        }
      }
    }
  }
}

long long tiles_per_block(long long H, long long W, long long* tiles_c) {
  *tiles_c = (W + TC - 1) / TC;
  return ((H + TR - 1) / TR) * *tiles_c;
}

// The most CTAs of this kernel the card holds at once: a cooperative
// grid larger than this is refused by the runtime, and one that is not
// co-resident would deadlock at the grid barrier.
template <typename T, int MIX>
int max_resident_ctas(int* out) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, probe_kernel<T, MIX>, kThreads, 0);
  if (err != cudaSuccess) return err;
  *out = sms * per_sm;
  return *out > 0 ? cudaSuccess : cudaErrorLaunchOutOfResources;
}

template <typename T, int MIX>
int launch(const void* z, void* a, void* b, void* part, long long n_blocks,
           long long H, long long W, int reps, const Coef& k, float se32,
           int* grid_out, cudaStream_t stream) {
  long long tiles_c = 0;
  long long tpb = tiles_per_block(H, W, &tiles_c);
  const long long total = n_blocks * tpb;
  if (total <= 0 || reps < 1) return cudaErrorInvalidValue;
  int resident = 0;
  int rc = max_resident_ctas<T, MIX>(&resident);
  if (rc != cudaSuccess) return rc;
  const int grid = static_cast<int>(total < resident ? total : resident);
  const T* zp = static_cast<const T*>(z);
  T* ap = static_cast<T*>(a);
  T* bp = static_cast<T*>(b);
  float* pp = static_cast<float*>(part);
  Coef kc = k;
  void* args[] = {&zp, &ap, &bp, &pp, &n_blocks, &H, &W, &reps,
                  &kc, &se32, &tiles_c, &tpb};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(probe_kernel<T, MIX>), dim3(grid),
      dim3(kThreads), args, 0, stream);
  if (err != cudaSuccess) return err;
  if (grid_out != nullptr) *grid_out = grid;
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the cluster route
// ---------------------------------------------------------------------------

// hand.PROBE_ROUTES: a route's code is its index
enum ProbeRoute : int { kRouteL2 = 0, kRouteCluster = 1 };

// The route's compile-time choices (kernels/probe_ab.py varies the
// first and the third).
constexpr int kClusterThreads = 512;  // threads a CTA (1024 spill)
constexpr int kClusterWarps = kClusterThreads / 32;
constexpr int kMaxCluster = 16;       // CTAs a cluster (non-portable above 8)
// dynamic shared memory a CTA's ping-pong may take: the 232448 bytes a
// CTA can have, less 1 KiB for the static variables
constexpr long long kClusterSmem = 232448 - 1024;
// words a thread carries through fma's reps: 8 independent mul/add
// chains, which hold fma within 1.3x of its issue bound (fixed)
constexpr int kFmaWords = 8;


struct ClusterCfg {
  int cs;          // CTAs a cluster
  int rs;          // rows a CTA's slab
  int pitch;       // elements a slab row: whole 16-byte vectors
  long long smem;  // bytes of the two slabs
};

// The cluster of an (H, W) block of `itemsize`-byte elements: the fewest
// CTAs whose two rs x pitch slabs fit kClusterSmem, with rs >= G (a
// slab's apron lies in its two neighbours) unless one CTA holds the
// block. False when none fits: the l2 route (hand.probe_route).
inline bool cluster_config(int itemsize, long long H, long long W,
                           ClusterCfg* c) {
  const long long ve = 16 / itemsize;
  const long long pitch = (W + ve - 1) / ve * ve;
  for (int cs = 1; cs <= kMaxCluster; cs *= 2) {
    const long long rs = (H + cs - 1) / cs;
    if (cs > 1 && rs < G) break;
    const long long bytes = 2 * rs * pitch * itemsize;
    if (bytes <= kClusterSmem) {
      *c = {cs, static_cast<int>(rs), static_cast<int>(pitch), bytes};
      return true;
    }
  }
  return false;
}

inline int probe_route(int itemsize, long long H, long long W) {
  ClusterCfg c;
  return cluster_config(itemsize, H, W, &c) ? kRouteCluster : kRouteL2;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_barrier() {
  cluster_arrive();
  cluster_wait();
}

// 16 bytes of packed words: 4 float32 or 8 bfloat16
template <typename T>
struct PVec {
  typename Pk<T>::W w[4];
};

// 16 bytes at a 32-bit shared address: this CTA's (ld.shared) or, mapped
// by mapa, a neighbour's (ld.shared::cluster). Explicit addresses keep the
// compiler from rebuilding the CTA's shared window base at every access.
template <typename V>
__device__ __forceinline__ V lds16(unsigned a) {
  uint4 u;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(u.x), "=r"(u.y), "=r"(u.z), "=r"(u.w)
               : "r"(a));
  V v;
  memcpy(&v, &u, 16);
  return v;
}
template <typename V>
__device__ __forceinline__ V ldc16(unsigned a) {
  uint4 u;
  asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(u.x), "=r"(u.y), "=r"(u.z), "=r"(u.w)
               : "r"(a));
  V v;
  memcpy(&v, &u, 16);
  return v;
}
template <typename V>
__device__ __forceinline__ void sts16(unsigned a, const V& v) {
  uint4 u;
  memcpy(&u, &v, 16);
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(a),
               "r"(u.x), "r"(u.y), "r"(u.z), "r"(u.w)
               : "memory");
}
__device__ __forceinline__ void sts4(unsigned a, unsigned u) {
  asm volatile("st.shared.u32 [%0], %1;" ::"r"(a), "r"(u) : "memory");
}
__device__ __forceinline__ unsigned lds4(unsigned a) {
  unsigned u;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(u) : "r"(a));
  return u;
}
// the address `a` of this CTA's shared memory in CTA `rank`'s
__device__ __forceinline__ unsigned mapa(unsigned a, unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r)
               : "r"(a), "r"(rank));
  return r;
}

// The dual mixes' shift after a rep: every CTA's partial (x, y) read
// through DSMEM and added in rank order, so every CTA of the cluster gets
// the same bits: f32(se) * ((sum_x + sum_y) / 1024), rounded to the
// dtype. Returns it to every thread of the CTA.
template <typename T>
__device__ float cluster_shift(cg::cluster_group& cluster, float2* part,
                               int cs, float se32, float* s_shift) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float2 p = make_float2(0.f, 0.f);
    if (lane < cs) p = *cluster.map_shared_rank(part, lane);
    float sx = __shfl_sync(0xffffffffu, p.x, 0);
    float sy = __shfl_sync(0xffffffffu, p.y, 0);
    for (int r = 1; r < cs; ++r) {
      sx = __fadd_rn(sx, __shfl_sync(0xffffffffu, p.x, r));
      sy = __fadd_rn(sy, __shfl_sync(0xffffffffu, p.y, r));
    }
    if (lane == 0) {
      const float r = __fdiv_rn(__fadd_rn(sx, sy), 1024.0f);
      const T rounded = Elt<T>::store(__fmul_rn(se32, r));
      *s_shift = Elt<T>::load(&rounded);
    }
  }
  __syncthreads();
  return *s_shift;
}

// Bits e of `m` for the VE elements of vector v: column v*VE + e in
// [lo, hi).
template <int VE>
__device__ __forceinline__ unsigned col_bits(int v, int lo, int hi) {
  unsigned m = 0;
#pragma unroll
  for (int e = 0; e < VE; ++e) {
    const int col = v * VE + e;
    if (col >= lo && col < hi) m |= 1u << e;
  }
  return m;
}

// One row of a stencil mix: the centre vector cc updated from the rows
// -2..+2 about it (u2, u1, d1, d2: the dim-0 taps) and the row segment e
// (cc's words with two elements a side, HE words each: the dim-1 taps);
// i the row in the block, the m_* the vector's columns in [0, W),
// [G, W - G), [1, W - 1). The dual mixes' squares go to sum_a / sum_b
// where `active`. Shared by the shared-memory walk and the rows held in
// registers, so both compute every element with the same ops.
template <typename T, int MIX>
__device__ __forceinline__ PVec<T> mix_row(
    const typename Pk<T>::W* kw, int i, int Hi, bool active,
    unsigned m_real, unsigned m_in2, unsigned m_in1, const PVec<T>& u2,
    const PVec<T>& u1, const PVec<T>& cc, const PVec<T>& d1,
    const PVec<T>& d2, const typename Pk<T>::W* e, float& sum_a,
    float& sum_b) {
  using P = Pk<T>;
  using Wd = typename P::W;
  using V = PVec<T>;
  constexpr int NW = 4, kE = P::kElems, HE = 2 / kE;
  // the row's conditions folded into the column masks once, so that every
  // word is computed and then selected, with no branch a word (faster for
  // heat5 and the dual mixes)
  const bool r2 = i >= G && i < Hi - G;  // rows a dim-0 update takes
  const bool r1 = i >= 1 && i < Hi - 1;  // heat5's rows
  const bool dx_sum = active && r2 && i - G < Hi - 2 * G - 1;
  const unsigned m_heat = r1 ? m_in1 : 0u;
  const unsigned m_lean = r2 ? m_in2 : 0u;
  if constexpr (MIX == kStep5D0 || MIX == kStep5FmaD0) {
    if (!r2) return cc;  // one test a row (a select a word is slower)
  }
  auto bit = [](unsigned m, int e) { return ((m >> e) & 1u) != 0; };
  // s += w² element by element where m holds (adding +0 elsewhere: the
  // sums are of squares, never -0)
  auto sq_add = [&](float& s, Wd w, unsigned m, int j) {
    const float2 f = P::f2(w);
    s = __fadd_rn(s, bit(m, j * kE) ? __fmul_rn(f.x, f.x) : 0.f);
    if (kE == 2)
      s = __fadd_rn(s, bit(m, j * kE + 1) ? __fmul_rn(f.y, f.y) : 0.f);
  };
  auto sq2_add = [&](float& s, Wd a, Wd b, unsigned m, int j) {
    const float2 fa = P::f2(a), fb = P::f2(b);
    s = __fadd_rn(s, bit(m, j * kE)
                         ? __fadd_rn(__fmul_rn(fa.x, fa.x),
                                     __fmul_rn(fb.x, fb.x))
                         : 0.f);
    if (kE == 2)
      s = __fadd_rn(s, bit(m, j * kE + 1)
                           ? __fadd_rn(__fmul_rn(fa.y, fa.y),
                                       __fmul_rn(fb.y, fb.y))
                           : 0.f);
  };
  auto sel = [&](Wd n, Wd o, unsigned m, int j) {
    return P::sel(n, o, bit(m, j * kE), bit(m, j * kE + 1));
  };
  V o;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const Wd x0 = cc.w[j];
    if constexpr (MIX == kStep5D0) {
      const Wd acc = P::add(P::mul(kw[1], P::sub(d1.w[j], u1.w[j])),
                            P::mul(kw[2], P::sub(d2.w[j], u2.w[j])));
      o.w[j] = P::add(x0, P::mul(kw[0], acc));
    } else if constexpr (MIX == kStep5FmaD0) {
      Wd x = P::add(x0, P::mul(kw[0], d1.w[j]));
      x = P::add(x, P::mul(kw[1], u1.w[j]));
      x = P::add(x, P::mul(kw[2], d2.w[j]));
      o.w[j] = P::add(x, P::mul(kw[3], u2.w[j]));
    } else if constexpr (MIX == kStep5D1 || MIX == kStep5FmaD1) {
      const Wd p1 = pk_at<T, 1>(e, HE + j);
      const Wd m1 = pk_at<T, -1>(e, HE + j);
      const Wd p2 = pk_at<T, 2>(e, HE + j);
      const Wd m2 = pk_at<T, -2>(e, HE + j);
      Wd x;
      if constexpr (MIX == kStep5D1) {
        const Wd acc = P::add(P::mul(kw[1], P::sub(p1, m1)),
                              P::mul(kw[2], P::sub(p2, m2)));
        x = P::add(x0, P::mul(kw[0], acc));
      } else {
        x = P::add(x0, P::mul(kw[0], p1));
        x = P::add(x, P::mul(kw[1], m1));
        x = P::add(x, P::mul(kw[2], p2));
        x = P::add(x, P::mul(kw[3], m2));
      }
      o.w[j] = sel(x, x0, m_in2, j);
    } else if constexpr (MIX == kHeat5) {
      const Wd two_w = P::mul(kw[2], x0);
      const Wd lx = P::sub(P::add(d1.w[j], u1.w[j]), two_w);
      const Wd ly = P::sub(
          P::add(pk_at<T, -1>(e, HE + j), pk_at<T, 1>(e, HE + j)), two_w);
      const Wd x = P::add(P::add(x0, P::mul(kw[0], lx)), P::mul(kw[1], ly));
      o.w[j] = sel(x, x0, m_heat, j);
    } else if constexpr (MIX == kDualDim) {
      // dx row i - G, every column
      Wd ax = P::mul(kw[0], u2.w[j]);
      ax = P::add(ax, P::mul(kw[1], u1.w[j]));
      ax = P::add(ax, P::mul(kw[2], d1.w[j]));
      ax = P::add(ax, P::mul(kw[3], d2.w[j]));
      const Wd dx = P::mul(ax, kw[4]);
      sq_add(sum_a, dx, dx_sum ? m_real : 0u, j);
      const Wd x = r2 ? P::add(x0, P::mul(kw[6], dx)) : x0;
      // dy column j - G, every row
      Wd ay = P::mul(kw[0], pk_at<T, -2>(e, HE + j));
      ay = P::add(ay, P::mul(kw[1], pk_at<T, -1>(e, HE + j)));
      ay = P::add(ay, P::mul(kw[2], pk_at<T, 1>(e, HE + j)));
      ay = P::add(ay, P::mul(kw[3], pk_at<T, 2>(e, HE + j)));
      const Wd dy = P::mul(ay, kw[5]);
      sq_add(sum_b, dy, active && i < Hi - 1 ? m_in2 : 0u, j);
      o.w[j] = sel(P::add(x, P::mul(kw[6], dy)), x, m_in2, j);
    } else {  // kDualDimLean
      const Wd dx = P::add(P::mul(kw[0], P::sub(d1.w[j], u1.w[j])),
                           P::mul(kw[1], P::sub(d2.w[j], u2.w[j])));
      const Wd dy = P::add(
          P::mul(kw[2],
                 P::sub(pk_at<T, 1>(e, HE + j), pk_at<T, -1>(e, HE + j))),
          P::mul(kw[3],
                 P::sub(pk_at<T, 2>(e, HE + j), pk_at<T, -2>(e, HE + j))));
      sq2_add(sum_a, dx, dy, dx_sum ? m_lean : 0u, j);
      const Wd x = P::add(P::add(x0, P::mul(kw[4], dx)), P::mul(kw[4], dy));
      o.w[j] = sel(x, x0, m_lean, j);
    }
  }
  return o;
}

// The dim-1 mixes with a CTA's rows in registers: warp w holds slab rows
// w, w + kClusterWarps, .. (R of them), a lane L contiguous vectors of
// each, and every rep steps them with the neighbours' two elements a side
// taken by shuffles: no shared memory between the first load (from slab
// `in`) and the last store (to slab `out`), and no barrier, for a rep
// reads only its own row. False, and nothing done, when the slab's rows
// and vectors do not fit R x L (the shared-memory walk then runs).
template <typename T, int MIX, int L, int R>
__device__ __forceinline__ bool d1_in_registers(
    unsigned in, unsigned out, int rs, int pitch, int Wi, int reps,
    const typename Pk<T>::W* kw) {
  using P = Pk<T>;
  using Wd = typename P::W;
  using V = PVec<T>;
  constexpr int NW = 4, kE = P::kElems, VE = NW * kE, HE = 2 / kE;
  constexpr int kB = sizeof(T);
  const int nv = pitch / VE;
  // the fewest vectors a lane and rows a warp that hold the slab
  if (nv > 32 * L || (L > 1 && nv <= 16 * L) ||
      (rs + kClusterWarps - 1) / kClusterWarps != R)
    return false;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  V x[R][L];
  unsigned m[L];  // the columns [G, W - G) a rep updates
#pragma unroll
  for (int l = 0; l < L; ++l) m[l] = col_bits<VE>(lane * L + l, G, Wi - G);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int rho = warp + r * kClusterWarps;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const int v = lane * L + l;
      x[r][l] = rho < rs && v < nv
                    ? lds16<V>(in + (rho * pitch + v * VE) * kB)
                    : V{};
    }
  }
  for (int rep = 0; rep < reps; ++rep) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      Wd e[HE + L * NW + HE];
#pragma unroll
      for (int l = 0; l < L; ++l)
#pragma unroll
        for (int j = 0; j < NW; ++j) e[HE + l * NW + j] = x[r][l].w[j];
#pragma unroll
      for (int h = 0; h < HE; ++h) {
        const unsigned lo = __shfl_up_sync(
            0xffffffffu, P::bits(e[L * NW + h]), 1);
        const unsigned hi = __shfl_down_sync(
            0xffffffffu, P::bits(e[HE + h]), 1);
        e[h] = P::of(lane > 0 ? lo : 0u);
        e[HE + L * NW + h] = P::of(lane < 31 ? hi : 0u);
      }
#pragma unroll
      for (int l = 0; l < L; ++l) {
#pragma unroll
        for (int j = 0; j < NW; ++j) {
          const int i = HE + l * NW + j;
          const Wd x0 = e[i];
          const Wd p1 = pk_at<T, 1>(e, i), m1 = pk_at<T, -1>(e, i);
          const Wd p2 = pk_at<T, 2>(e, i), m2 = pk_at<T, -2>(e, i);
          Wd y;
          if constexpr (MIX == kStep5D1) {
            const Wd acc = P::add(P::mul(kw[1], P::sub(p1, m1)),
                                  P::mul(kw[2], P::sub(p2, m2)));
            y = P::add(x0, P::mul(kw[0], acc));
          } else {
            y = P::add(x0, P::mul(kw[0], p1));
            y = P::add(y, P::mul(kw[1], m1));
            y = P::add(y, P::mul(kw[2], p2));
            y = P::add(y, P::mul(kw[3], m2));
          }
          x[r][l].w[j] = P::sel(y, x0, (m[l] >> (j * kE)) & 1u,
                                (m[l] >> (j * kE + 1)) & 1u);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int rho = warp + r * kClusterWarps;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const int v = lane * L + l;
      if (rho < rs && v < nv) sts16(out + (rho * pitch + v * VE) * kB, x[r][l]);
    }
  }
  return true;
}

// The register shapes (vectors a lane, rows a warp) the dim-1 mixes try:
// a (512, 512) block's slab, float32 (16 CTAs) and bfloat16 (8); false
// when neither holds the slab exactly.
template <typename T, int MIX>
__device__ __forceinline__ bool d1_shapes(unsigned in, unsigned out, int rs,
                                          int pitch, int Wi, int reps,
                                          const typename Pk<T>::W* kw) {
  return d1_in_registers<T, MIX, 4, 2>(in, out, rs, pitch, Wi, reps, kw) ||
         d1_in_registers<T, MIX, 2, 4>(in, out, rs, pitch, Wi, reps, kw);
}

// The dim-0 mixes (step5_d0, step5fma_d0) and heat5 with a CTA's rows
// in registers: thread (q, v) holds vector v of the slab's rows [q*RR,
// (q + 1)*RR) for all reps. A rep reads from other threads only the 2
// rows above and below a run and, for heat5, at a warp's two ends the 2
// elements beside each row; each thread publishes its own after its rep
// into edge buffers in shared memory (the row edges in slab 1's space,
// the column edges in slab 0's; two parities). The run's interior rows
// need no other CTA, so the cluster barrier is split around them: arrive
// after the publish (and a CTA barrier for the column edges), the next
// rep's interior, wait, then the rows next to the run's ends (the first
// and last runs' from the neighbouring CTAs' buffers through DSMEM).
// Holds where every run is RR rows of whole warps of vectors (rs % RR ==
// 0, 32 | vectors a row) and one thread an item; false, with nothing
// done, otherwise. The values written to slab 0 at the end are the
// walk's, bit for bit.
template <typename T, int MIX, int RR>
__device__ __forceinline__ bool rows_in_registers(
    cg::cluster_group& cluster, int cs, int c, unsigned sa, int rs,
    int my_rows, int pitch, int Hi, int Wi, int r0i, int reps,
    const typename Pk<T>::W* kw) {
  using P = Pk<T>;
  using Wd = typename P::W;
  using V = PVec<T>;
  constexpr int NW = 4, kE = P::kElems, VE = NW * kE, HE = 2 / kE;
  constexpr int kB = sizeof(T);
  static_assert(RR >= 4, "a run's interior");
  constexpr bool kCols = MIX == kHeat5;  // dim-1 taps too
  const int nv = pitch / VE, nq = rs / RR, nw = nv / 32;
  if (rs % RR != 0 || nv % 32 != 0 || nv * nq > kClusterThreads)
    return false;
  const int tid = threadIdx.x, lane = tid & 31;
  const bool live = tid < nv * nq;
  const int v = live ? tid % nv : 0, q = live ? tid / nv : 0;
  const int w = v / 32;  // the warp's place in its row
  const int rho0 = q * RR;
  const unsigned m_real = col_bits<VE>(v, 0, Wi);
  const unsigned m_in2 = col_bits<VE>(v, G, Wi - G);
  const unsigned m_in1 = col_bits<VE>(v, 1, Wi - 1);
  V x[RR], y[RR];
#pragma unroll
  for (int r = 0; r < RR; ++r)
    x[r] = lds16<V>(sa + ((rho0 + r) * pitch + v * VE) * kB);
  // the row edges: [parity][run][top, bottom][2 rows][vector]
  const unsigned re = sa + rs * pitch * kB;
  const unsigned re_up = c > 0 ? mapa(re, c - 1) : 0u;
  const unsigned re_dn = c + 1 < cs ? mapa(re, c + 1) : 0u;
  auto re_at = [&](unsigned base, int par, int qq, int side, int row) {
    return base + ((((par * nq + qq) * 2 + side) * 2 + row) * nv + v) * 16;
  };
  // the column edges: [parity][run][row][warp][first, last][HE words]
  auto ce_at = [&](int par, int r, int ww, int side, int h) {
    return sa + ((((par * nq + q) * RR + r) * nw + ww) * 2 + side) * 8 +
           h * 4;
  };
  auto publish = [&](int par) {
    if (!live) return;
    sts16(re_at(re, par, q, 0, 0), x[0]);
    sts16(re_at(re, par, q, 0, 1), x[1]);
    sts16(re_at(re, par, q, 1, 0), x[RR - 2]);
    sts16(re_at(re, par, q, 1, 1), x[RR - 1]);
    if (kCols && (lane == 0 || lane == 31)) {
#pragma unroll
      for (int r = 0; r < RR; ++r)
#pragma unroll
        for (int h = 0; h < HE; ++h)
          sts4(ce_at(par, r, w, lane == 31, h),
               P::bits(x[r].w[lane == 31 ? NW - HE + h : h]));
    }
  };
  // the 2 elements beside each row at a warp's two ends (lane 0: left,
  // lane 31: right), zero off the row
  Wd cl[RR][HE], cr[RR][HE];
  float sum_a = 0.f, sum_b = 0.f;  // no sums
  auto row = [&](int r, const V& u2, const V& u1, const V& d1,
                 const V& d2) {
    Wd e[HE + NW + HE] = {};
#pragma unroll
    for (int j = 0; j < NW; ++j) e[HE + j] = x[r].w[j];
#pragma unroll
    for (int h = 0; h < (kCols ? HE : 0); ++h) {
      const unsigned lo = __shfl_up_sync(0xffffffffu,
                                         P::bits(x[r].w[NW - HE + h]), 1);
      const unsigned hi =
          __shfl_down_sync(0xffffffffu, P::bits(x[r].w[h]), 1);
      e[h] = lane == 0 ? cl[r][h] : P::of(lo);
      e[HE + NW + h] = lane == 31 ? cr[r][h] : P::of(hi);
    }
    y[r] = mix_row<T, MIX>(kw, r0i + rho0 + r, Hi,
                           live && rho0 + r < my_rows, m_real, m_in2, m_in1,
                           u2, u1, x[r], d1, d2, e, sum_a, sum_b);
  };
  __syncthreads();  // slab 0 read before the column edges take its space
  publish(0);
  cluster_arrive();
  if (kCols) __syncthreads();  // the column edges, within the CTA
  for (int rep = 0; rep < reps; ++rep) {
    const int par = rep & 1;
    if constexpr (kCols) {
#pragma unroll
      for (int r = 0; r < RR; ++r)
#pragma unroll
        for (int h = 0; h < HE; ++h) {
          cl[r][h] = lane == 0 && w > 0
                         ? P::of(lds4(ce_at(par, r, w - 1, 1, h)))
                         : P::of(0u);
          cr[r][h] = lane == 31 && w + 1 < nw
                         ? P::of(lds4(ce_at(par, r, w + 1, 0, h)))
                         : P::of(0u);
        }
    }
#pragma unroll
    for (int r = G; r < RR - G; ++r)
      row(r, x[r - 2], x[r - 1], x[r + 1], x[r + 2]);
    cluster_wait();  // the last rep's edges published everywhere
    // the 2 rows above the run and the 2 below: a run's neighbour here, or
    // the last / first run of the CTA above / below
    V above[2], below[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      above[k] = q > 0 ? lds16<V>(re_at(re, par, q - 1, 1, k))
                 : c > 0 ? ldc16<V>(re_at(re_up, par, nq - 1, 1, k))
                         : V{};
      below[k] = q + 1 < nq ? lds16<V>(re_at(re, par, q + 1, 0, k))
                 : c + 1 < cs ? ldc16<V>(re_at(re_dn, par, 0, 0, k))
                              : V{};
    }
    row(0, above[0], above[1], x[1], x[2]);
    row(1, above[1], x[0], x[2], x[3]);
    row(RR - 2, x[RR - 4], x[RR - 3], x[RR - 1], below[0]);
    row(RR - 1, x[RR - 3], x[RR - 2], below[0], below[1]);
#pragma unroll
    for (int r = 0; r < RR; ++r) x[r] = y[r];
    publish(par ^ 1);
    cluster_arrive();
    if (kCols) __syncthreads();  // the column edges, within the CTA
  }
  cluster_wait();
#pragma unroll
  for (int r = 0; r < RR; ++r)
    if (live) sts16(sa + ((rho0 + r) * pitch + v * VE) * kB, x[r]);
  return true;
}

template <typename T, int MIX>
__global__ void __launch_bounds__(kClusterThreads, 1)
    probe_cluster_kernel(const T* z, T* out, long long H, long long W,
                         int reps, Coef k, float se32, int rs, int pitch) {
  using P = Pk<T>;
  using Wd = typename P::W;
  using V = PVec<T>;
  constexpr int NW = 4;                 // words a vector
  constexpr int kE = P::kElems;
  constexpr int VE = NW * kE;           // elements a vector
  constexpr int HE = 2 / kE;            // words of two elements
  constexpr bool kDual = MIX == kDualDim || MIX == kDualDimLean;
  // taps along the rows (dim 0) and along the columns (dim 1)
  constexpr bool kRows = MIX == kStep5D0 || MIX == kStep5FmaD0 ||
                         MIX == kHeat5 || kDual;
  constexpr bool kCols = MIX == kStep5D1 || MIX == kStep5FmaD1 ||
                         MIX == kHeat5 || kDual;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int c = static_cast<int>(cluster.block_rank());
  const long long blk = blockIdx.x / cs;
  const long long row0 = static_cast<long long>(c) * rs;  // slab's first row
  const long long left = H - row0;
  const int my_rows = left <= 0 ? 0 : left < rs ? static_cast<int>(left) : rs;
  // a block fits a cluster's shared memory: every index below fits an int
  const int Hi = static_cast<int>(H), Wi = static_cast<int>(W);
  const int r0i = c * rs;
  const T* zb = z + blk * H * W + row0 * W;
  T* ob = out + blk * H * W + row0 * W;
  const int tid = threadIdx.x, lane = tid & 31;
  Wd kw[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) kw[i] = P::splat(k.v[i]);

  if constexpr (MIX == kFma) {
    // every element on its own: kFmaWords words a thread stay in
    // registers through all reps (any two elements may share a word)
    constexpr int Q = kFmaWords * kE;
    const long long n = static_cast<long long>(my_rows) * W;
    for (long long base = 0; base < n;
         base += static_cast<long long>(Q) * kClusterThreads) {
      T x[Q] = {};
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const long long e = base + static_cast<long long>(q) *
                                       kClusterThreads + tid;
        if (e < n) x[q] = zb[e];
      }
      Wd w[kFmaWords];
      memcpy(w, x, sizeof(w));
      for (int r = 0; r < reps; ++r) {
#pragma unroll
        for (int q = 0; q < kFmaWords; ++q)
          w[q] = P::add(P::mul(kw[0], w[q]), kw[1]);
      }
      memcpy(x, w, sizeof(w));
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const long long e = base + static_cast<long long>(q) *
                                       kClusterThreads + tid;
        if (e < n) ob[e] = x[q];
      }
    }
    return;
  } else {
    extern __shared__ __align__(16) unsigned char probe_smem[];
    __shared__ float2 s_part[2];
    __shared__ float s_shift;
    __shared__ float red[2 * kClusterWarps];
    T* const slabs = reinterpret_cast<T*>(probe_smem);
    const int plane = rs * pitch;
    constexpr int kB = sizeof(T);  // bytes an element
    // shared addresses: the slabs here, and the neighbours' (the rows
    // above lie in CTA c - 1, below in c + 1; both ping-pong buffers,
    // laid out as here)
    const unsigned sa =
        static_cast<unsigned>(__cvta_generic_to_shared(slabs));
    const unsigned up = c > 0 ? mapa(sa, c - 1) : 0u;
    const unsigned dn = c + 1 < cs ? mapa(sa, c + 1) : 0u;

    for (int e = tid; e < plane; e += kClusterThreads) {
      const int r = e / pitch, col = e % pitch;
      T v = {};
      if (r < my_rows && col < Wi) v = zb[r * Wi + col];
      slabs[e] = v;
    }
    // every CTA of the cluster running and its slab loaded before any
    // DSMEM read
    cluster_barrier();

    const int nv = pitch / VE;  // vectors a row
    // (vector, run) items, a thread an item, runs of rr rows
    const int nq = nv >= kClusterThreads ? 1 : kClusterThreads / nv;
    const int rr = (rs + nq - 1) / nq;
    const int items = nv * nq;
    float shift = 0.f;
    bool in_regs = false;
    int res_slab = reps & 1;  // the slab the final store reads
    if constexpr (MIX == kStep5D0 || MIX == kStep5FmaD0 || MIX == kHeat5) {
      in_regs = rows_in_registers<T, MIX, 8>(cluster, cs, c, sa, rs,
                                             my_rows, pitch, Hi, Wi, r0i,
                                             reps, kw);
      if (in_regs) {
        res_slab = 0;
        __syncthreads();  // the slab complete before the store reads it
      }
    } else if constexpr (!kRows) {
      // the rows in registers where they fit: up to 8 vectors a thread
      const unsigned out_slab = sa + (reps & 1) * plane * kB;
      in_regs = d1_shapes<T, MIX>(sa, out_slab, rs, pitch, Wi, reps, kw);
      __syncthreads();  // the slab complete before the store reads it
    }
    for (int rep = 0; rep < (in_regs ? 0 : reps); ++rep) {
      const int par = rep & 1;
      const unsigned cur = sa + par * plane * kB;
      const unsigned nxt = sa + (par ^ 1) * plane * kB;
      const bool pending = kDual && rep > 0;  // last rep's shift not yet in
      if constexpr (kDual) {
        if (pending)
          shift = cluster_shift<T>(cluster, &s_part[par ^ 1], cs, se32,
                                   &s_shift);
      }
      const Wd sw = P::splat(shift);
      auto shifted = [&](V r) {
        if (pending) {
#pragma unroll
          for (int j = 0; j < NW; ++j) r.w[j] = P::add(r.w[j], sw);
        }
        return r;
      };
      // the vector at element offset `off` of this CTA's slab
      auto lload = [&](int off) { return shifted(lds16<V>(cur + off * kB)); };
      // the vector of any slab row rho (-G .. rs + G - 1), zero off the
      // block: the rows above and below the slab from the neighbours
      auto vload = [&](int rho, int v) {
        const int i = r0i + rho;
        if (i < 0 || i >= Hi) return V{};
        if (rho >= 0 && rho < rs) return lload(rho * pitch + v * VE);
        const unsigned nb = rho < 0 ? up + (rho + rs) * pitch * kB
                                    : dn + (rho - rs) * pitch * kB;
        return shifted(ldc16<V>(nb + (par * plane + v * VE) * kB));
      };
      // the word at element col of own row rho, zero off [0, pitch)
      auto wload = [&](int rho, int col) {
        if (col < 0 || col >= pitch) return P::of(0u);
        const Wd w = P::of(lds4(cur + (rho * pitch + col) * kB));
        return pending ? P::add(w, sw) : w;
      };
      float sum_a = 0.f, sum_b = 0.f;
      // the slab's rows, consecutive lanes on consecutive vectors of one
      // row
      for (int base = 0; base < items; base += kClusterThreads) {
        const int item = base + tid;
        const bool live = item < items;
        const int v = live ? item % nv : 0;
        const int q = live ? item / nv : 0;
        const int rho0 = q * rr;
        // lanes -1 / +1 hold vectors v - 1 / v + 1 of the same row
        const bool lnb = lane > 0 && v > 0;
        const bool rnb = lane < 31 && v + 1 < nv && item + 1 < items;
        const unsigned m_real = col_bits<VE>(v, 0, Wi);
        const unsigned m_in2 = col_bits<VE>(v, G, Wi - G);
        const unsigned m_in1 = col_bits<VE>(v, 1, Wi - 1);
        // one output row rho at element offset off: cc the centre row's
        // vector, u2..d2 rows -2..+2
        auto update = [&](int rho, int off, const V& u2, const V& u1,
                          const V& cc, const V& d1, const V& d2) {
          const bool active = live && rho < my_rows;
          Wd e[HE + NW + HE];
#pragma unroll
          for (int j = 0; j < NW; ++j) e[HE + j] = cc.w[j];
          if constexpr (kCols) {
#pragma unroll
            for (int h = 0; h < HE; ++h) {
              e[h] = P::of(__shfl_up_sync(0xffffffffu,
                                          P::bits(cc.w[NW - HE + h]), 1));
              e[HE + NW + h] = P::of(__shfl_down_sync(
                  0xffffffffu, P::bits(cc.w[h]), 1));
            }
            if (!lnb) {
#pragma unroll
              for (int h = 0; h < HE; ++h)
                e[h] = active && v > 0 ? wload(rho, v * VE - 2 + h * kE)
                                       : P::of(0u);
            }
            if (!rnb) {
#pragma unroll
              for (int h = 0; h < HE; ++h)
                e[HE + NW + h] =
                    active ? wload(rho, (v + 1) * VE + h * kE) : P::of(0u);
            }
          }
          const V o = mix_row<T, MIX>(kw, r0i + rho, Hi, active, m_real,
                                      m_in2, m_in1, u2, u1, cc, d1, d2, e,
                                      sum_a, sum_b);
          if (active) sts16(nxt + off * kB, o);
        };
        // the centre's element offset, one pitch further each row
        int off = rho0 * pitch + v * VE;
        if constexpr (kRows) {
          // slot t % 5 holds slab row rho0 - G + t of the walk; a row
          // entering it is a local load unless it lies past this CTA's
          // rows (the neighbour's, or off the block)
          V win[5];
          // every row the run reads is one of this CTA's: no test a row
          const bool local = rho0 >= G && rho0 + rr + G <= my_rows;
          if (local) {
#pragma unroll
            for (int t = 0; t < 4; ++t)
              win[t] = lload(off + (t - G) * pitch);
            for (int t0 = 0; t0 < rr; t0 += 5) {
#pragma unroll
              for (int ph = 0; ph < 5; ++ph) {
                if (t0 + ph >= rr) break;
                win[(ph + 4) % 5] = lload(off + G * pitch);
                update(rho0 + t0 + ph, off, win[ph % 5], win[(ph + 1) % 5],
                       win[(ph + 2) % 5], win[(ph + 3) % 5],
                       win[(ph + 4) % 5]);
                off += pitch;
              }
            }
          } else {
#pragma unroll
            for (int t = 0; t < 4; ++t) win[t] = vload(rho0 - G + t, v);
            for (int t0 = 0; t0 < rr; t0 += 5) {
#pragma unroll
              for (int ph = 0; ph < 5; ++ph) {
                if (t0 + ph >= rr) break;
                const int rho = rho0 + t0 + ph;
                win[(ph + 4) % 5] = vload(rho + G, v);
                update(rho, off, win[ph % 5], win[(ph + 1) % 5],
                       win[(ph + 2) % 5], win[(ph + 3) % 5],
                       win[(ph + 4) % 5]);
                off += pitch;
              }
            }
          }
        } else {
          for (int t = 0; t < rr; ++t, off += pitch) {
            // rows past this CTA's are never stored: any value will do
            const V cc = lload(rho0 + t < rs ? off : 0);
            update(rho0 + t, off, cc, cc, cc, cc, cc);
          }
        }
      }
      if constexpr (kDual) {
        // the whole block's sums: every CTA's rows before any shift
        const float2 s = block_sum2<kClusterWarps>(sum_a, sum_b, red);
        if (tid == 0) s_part[par] = s;
        cluster_barrier();  // rep done everywhere: its slabs may be read
      } else if constexpr (!kRows) {
        __syncthreads();  // a rep reads its own rows only, in this CTA
      } else {
        cluster_barrier();  // the slab's edge rows read the neighbours'
      }
    }

    const T* res = slabs + res_slab * plane;
    if constexpr (kDual)
      shift = cluster_shift<T>(cluster, &s_part[(reps - 1) & 1], cs, se32,
                               &s_shift);
    const int n = my_rows * Wi;
    for (int e = tid; e < n; e += kClusterThreads) {
      const int r = e / Wi, col = e % Wi;
      T v = res[r * pitch + col];
      if constexpr (kDual)
        v = Elt<T>::store(Elt<T>::add(Elt<T>::load(&v), shift));
      ob[e] = v;
    }
    // no CTA leaves while another may still read its slab or partials
    cluster_barrier();
  }
}

// Sets a cluster instance's attributes once: the dynamic shared memory
// it may take and, for 16 CTAs, the non-portable cluster size.
template <typename T, int MIX>
cudaError_t cluster_attrs() {
  static bool done = false;
  if (done) return cudaSuccess;
  auto kern = probe_cluster_kernel<T, MIX>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kClusterSmem));
  if (err == cudaSuccess && kMaxCluster > 8)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  done = err == cudaSuccess;
  return err;
}

template <typename T, int MIX>
cudaLaunchConfig_t cluster_launch_config(const ClusterCfg& cfg,
                                         long long n_blocks,
                                         cudaLaunchAttribute* attr,
                                         cudaStream_t stream) {
  cudaLaunchConfig_t lc = {};
  lc.gridDim = dim3(static_cast<unsigned>(n_blocks * cfg.cs));
  lc.blockDim = dim3(kClusterThreads);
  lc.dynamicSmemBytes = MIX == kFma ? 0 : static_cast<size_t>(cfg.smem);
  lc.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cfg.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  lc.attrs = attr;
  lc.numAttrs = 1;
  return lc;
}

template <typename T, int MIX>
int launch_cluster(const void* z, void* out, long long n_blocks, long long H,
                   long long W, int reps, const Coef& k, float se32,
                   int* grid_out, cudaStream_t stream) {
  ClusterCfg cfg;
  if (!cluster_config(sizeof(T), H, W, &cfg) || n_blocks < 1 || reps < 1)
    return cudaErrorInvalidValue;
  if (n_blocks * cfg.cs > INT_MAX) return cudaErrorInvalidConfiguration;
  cudaError_t err = cluster_attrs<T, MIX>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t lc =
      cluster_launch_config<T, MIX>(cfg, n_blocks, attr, stream);
  err = cudaLaunchKernelEx(&lc, probe_cluster_kernel<T, MIX>,
                           static_cast<const T*>(z), static_cast<T*>(out), H,
                           W, reps, k, se32, cfg.rs, cfg.pitch);
  if (err != cudaSuccess) return err;
  if (grid_out != nullptr) *grid_out = static_cast<int>(n_blocks * cfg.cs);
  return cudaGetLastError();
}

// Clusters of the stencil mixes' instance at (H, W) the card holds at
// once (cudaOccupancyMaxActiveClusters): the blocks a launch takes to
// fill it.
template <typename T>
int cluster_capacity(long long H, long long W, int* out) {
  ClusterCfg cfg;
  if (!cluster_config(sizeof(T), H, W, &cfg)) return cudaErrorInvalidValue;
  cudaError_t err = cluster_attrs<T, kStep5D0>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t lc =
      cluster_launch_config<T, kStep5D0>(cfg, 1, attr, nullptr);
  return cudaOccupancyMaxActiveClusters(out, probe_cluster_kernel<T, kStep5D0>,
                                        &lc);
}

template <typename T>
int dispatch(int route, int mix, const void* z, void* a, void* b,
             void* part, long long n_blocks, long long H, long long W,
             int reps, const Coef& k, float se32, int* grid_out,
             cudaStream_t s) {
  if (route != probe_route(sizeof(T), H, W)) return cudaErrorInvalidValue;
  const bool cl = route == kRouteCluster;
#define TPUMT_MIX(M)                                                       \
  case M:                                                                  \
    return cl ? launch_cluster<T, M>(z, a, n_blocks, H, W, reps, k, se32,  \
                                     grid_out, s)                          \
              : launch<T, M>(z, a, b, part, n_blocks, H, W, reps, k,       \
                             se32, grid_out, s);
  switch (mix) {
    TPUMT_MIX(kFma)
    TPUMT_MIX(kStep5D0)
    TPUMT_MIX(kStep5D1)
    TPUMT_MIX(kStep5FmaD0)
    TPUMT_MIX(kStep5FmaD1)
    TPUMT_MIX(kHeat5)
    TPUMT_MIX(kDualDim)
    TPUMT_MIX(kDualDimLean)
    default:
      return cudaErrorInvalidValue;
  }
#undef TPUMT_MIX
}

}  // namespace
}  // namespace tpumt

// Tiles one (H, W) block splits into on the l2 route: the wrapper
// allocates 2 (ping-pong) x n_blocks x tiles x 2 floats of partial sums.
extern "C" long long tpumt_alu_probe_tiles(long long H, long long W) {
  long long tiles_c = 0;
  return tpumt::tiles_per_block(H, W, &tiles_c);
}

// The current device's L2 cache in bytes (0 on error): what the l2
// route's two ping-pong buffers must fit in for the blocks to stay on
// chip.
extern "C" long long tpumt_alu_probe_l2_bytes() {
  int dev = 0, l2 = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, dev) !=
      cudaSuccess) {
    return 0;
  }
  return l2;
}

// Lone float32 mul/add/sub instructions the current device issues a
// second at most: SMs x 128 lanes x the SM's peak clock (0 on error).
// The probe's bound: its issued ops over this rate (bfloat16 as bf16x2,
// two elements an instruction).
extern "C" double tpumt_alu_issue_rate() {
  int dev = 0, sms = 0, khz = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, dev) !=
          cudaSuccess) {
    return 0.0;
  }
  return static_cast<double>(sms) * 128.0 * khz * 1e3;
}

// The route of an (H, W) block (hand.probe_route): 1 cluster, 0 l2.
extern "C" int tpumt_alu_probe_route(int dtype, long long H, long long W) {
  return tpumt::probe_route(dtype == tpumt::kBF16 ? 2 : 4, H, W);
}

// Clusters of (H, W) blocks of the dtype the card holds at once on the
// cluster route (cudaOccupancyMaxActiveClusters), or minus a cudaError_t.
extern "C" int tpumt_alu_probe_clusters(int dtype, long long H,
                                        long long W) {
  using namespace tpumt;
  int n = 0;
  const int rc = dtype == kBF16
                     ? cluster_capacity<__nv_bfloat16>(H, W, &n)
                     : dtype == kF32 ? cluster_capacity<float>(H, W, &n)
                                     : cudaErrorInvalidValue;
  return rc == cudaSuccess ? n : -rc;
}

// Plain C entry point (bound with ctypes). Returns a cudaError_t: 0 when
// the launch was accepted. `z` holds n_blocks contiguous (H, W) blocks and
// is only read. `route` is the route tpumt_alu_probe_route names (any
// other is refused). On the cluster route the result lies in `a` (`b` and
// `part` unused); on the l2 route `a` and `b` are two buffers of z's size
// and the result lies in `a` when reps is odd, in `b` when even, `part`
// the partial sums. `k0..k7` are the mix's constants already rounded to
// the array dtype; `se32` is float32(se), the dual mixes' shift scale.
// `grid_out` receives the number of CTAs launched. dtype: float32 or
// bfloat16.
extern "C" int tpumt_alu_probe(const void* z, void* a, void* b, void* part,
                               int dtype, int mix, long long n_blocks,
                               long long H, long long W, int reps, double k0,
                               double k1, double k2, double k3, double k4,
                               double k5, double k6, double k7, double se32,
                               int route, int* grid_out, void* stream) {
  using namespace tpumt;
  const double kd[8] = {k0, k1, k2, k3, k4, k5, k6, k7};
  Coef k;
  for (int i = 0; i < 8; ++i) k.v[i] = static_cast<float>(kd[i]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float se = static_cast<float>(se32);
  switch (dtype) {
    case kF32:
      return dispatch<float>(route, mix, z, a, b, part, n_blocks, H, W,
                             reps, k, se, grid_out, s);
    case kBF16:
      return dispatch<__nv_bfloat16>(route, mix, z, a, b, part, n_blocks, H,
                                     W, reps, k, se, grid_out, s);
    default:
      return cudaErrorInvalidValue;
  }
}
