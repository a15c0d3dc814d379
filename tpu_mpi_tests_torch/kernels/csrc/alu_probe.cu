// ALU op-rate probe: out = body^reps(z) on B independent (H, W) blocks,
// with no traffic to device memory between repetitions beyond what the
// L2 cache holds.
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
// Design. A (512, 512) float32 block is 1 MB and a CTA has 227 KB of
// shared memory, so "load once, iterate in fast memory, store once"
// cannot be one CTA. Here the blocks live in two ping-pong buffers in
// global memory, small enough to stay in the 50 MB L2 (the wrapper
// refuses more), and ONE cooperative launch advances every block: a CTA
// owns 32 x 128 tiles (a grid-stride loop over the tiles of all blocks),
// stages each tile and its 2-deep apron in shared memory, computes, and
// writes the other buffer; cg::grid_group::sync() separates repetitions.
// The grid never exceeds what the card can hold co-resident
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs).
//
// The dual mixes feed a whole-block sum back into every element. Each
// CTA writes its tile's partial sums (fixed-order shuffle tree); after
// the grid barrier, every CTA sums its block's partials in one fixed
// order and applies the shift while it loads the next rep's window (a
// last pass applies the final shift), so one barrier per rep suffices
// and the result is the same from run to run.
//
// What this measures: per rep, one grid barrier plus a pass over L2 —
// NOT the ALUs' peak. Rates from it are element-steps per second of an
// op mix whose operands stay on chip, at this design; never a ceiling.
//
// Rounding: as the kernels it prices (_rn intrinsics, -fmad=false, bf16
// rounded after every op, coefficients rounded to the dtype first), so a
// lone mul and a lone add are issued, never an FMA. fma, step5*, heat5
// equal the plain PyTorch version bit for bit; the dual mixes differ by
// the order of the sums.
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
// the warps' values in order. Every thread returns the totals.
__device__ float2 block_sum2(float a, float b, float* red) {
  for (int o = 16; o > 0; o >>= 1) {
    a = __fadd_rn(a, __shfl_xor_sync(0xffffffffu, a, o));
    b = __fadd_rn(b, __shfl_xor_sync(0xffffffffu, b, o));
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // red may still be read from the previous call
  if (lane == 0) {
    red[warp] = a;
    red[kWarps + warp] = b;
  }
  __syncthreads();
  float ta = red[0], tb = red[kWarps];
  for (int w = 1; w < kWarps; ++w) {
    ta = __fadd_rn(ta, red[w]);
    tb = __fadd_rn(tb, red[kWarps + w]);
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
  const float2 s = block_sum2(sx, sy, red);
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
        const float2 s = block_sum2(sum_a, sum_b, red);
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

template <typename T>
int dispatch(int mix, const void* z, void* a, void* b, void* part,
             long long n_blocks, long long H, long long W, int reps,
             const Coef& k, float se32, int* grid_out, cudaStream_t s) {
#define TPUMT_MIX(M)                                                     \
  case M:                                                                \
    return launch<T, M>(z, a, b, part, n_blocks, H, W, reps, k, se32,   \
                        grid_out, s);
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

// Tiles one (H, W) block splits into: the wrapper allocates
// 2 (ping-pong) x n_blocks x tiles x 2 floats of partial sums.
extern "C" long long tpumt_alu_probe_tiles(long long H, long long W) {
  long long tiles_c = 0;
  return tpumt::tiles_per_block(H, W, &tiles_c);
}

// The current device's L2 cache in bytes (0 on error): what the two
// ping-pong buffers must fit in for the blocks to stay on chip.
extern "C" long long tpumt_alu_probe_l2_bytes() {
  int dev = 0, l2 = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, dev) !=
      cudaSuccess) {
    return 0;
  }
  return l2;
}

// Plain C entry point (bound with ctypes). Returns a cudaError_t: 0 when
// the cooperative launch was accepted. `z` holds n_blocks contiguous
// (H, W) blocks and is only read; `a` and `b` are two buffers of the same
// size, and the result lies in `a` when reps is odd, in `b` when even.
// `k0..k7` are the mix's constants already rounded to the array dtype;
// `se32` is float32(se), the dual mixes' shift scale. `grid_out`
// receives the number of CTAs launched. dtype: float32 or bfloat16.
extern "C" int tpumt_alu_probe(const void* z, void* a, void* b, void* part,
                               int dtype, int mix, long long n_blocks,
                               long long H, long long W, int reps, double k0,
                               double k1, double k2, double k3, double k4,
                               double k5, double k6, double k7, double se32,
                               int* grid_out, void* stream) {
  using namespace tpumt;
  const double kd[8] = {k0, k1, k2, k3, k4, k5, k6, k7};
  Coef k;
  for (int i = 0; i < 8; ++i) k.v[i] = static_cast<float>(kd[i]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float se = static_cast<float>(se32);
  switch (dtype) {
    case kF32:
      return dispatch<float>(mix, z, a, b, part, n_blocks, H, W, reps, k, se,
                             grid_out, s);
    case kBF16:
      return dispatch<__nv_bfloat16>(mix, z, a, b, part, n_blocks, H, W,
                                     reps, k, se, grid_out, s);
    default:
      return cudaErrorInvalidValue;
  }
}
