// k explicit-Euler steps of the 2-D heat equation (5-point Laplacian) on
// a shard ghosted along both axes.
//
// Replaces the Pallas kernel heat2d_pallas
// (tpu_mpi_tests/kernels/pallas_kernels.py:1448; body
// _heat_stream0_kernel :1361), which carries the XLA body of
// heat_step2d_fn (tpu_mpi_tests/comm/halo.py:1445-1457) update for update.
//
// What it computes: `steps` times, every cell of [1, n0-1) x [1, n1-1)
// (the "maximal span": ghost-band cells too, stale creep included) gets
//     new = (mid + cx*((z[i+1] + z[i-1]) - 2*mid))
//               + cy*((z[j+1] + z[j-1]) - 2*mid)
// from the previous step's values; the outermost ring keeps its value.
// cx, cy and 2 arrive rounded to the array dtype.
//
// Design. A CTA owns an output tile of TR rows by TC columns. It loads
// the tile plus a `steps`-deep apron on every side (zero outside the
// array) into shared memory and advances it `steps` times there,
// ping-ponging two shared buffers: at step s it updates the window
// positions [s, W-s) on both axes, the part whose inputs are still
// exact (the valid window shrinks by one cell per step and per side), so
// after `steps` steps the tile itself is exact. Then it writes the tile,
// outer ring included. The output goes to a SECOND buffer: the TPU
// kernel aliases input and output because each of its row blocks holds
// the whole shard width, but CTAs that split both axes would read apron
// cells a neighbour had already overwritten. The caller ping-pongs two
// buffers.
//
// Bound on the H100: memory. Per step a cell costs 10 flops; at k=4
// that is 40 flops against 8 bytes (f32 read + write), ~5 flop/byte,
// below the card's ~20 flop/byte f32 ridge. The apron is re-read from
// L2 ((TR+2k)(TC+2k)/(TR*TC) = 1.33 at k=4).
#include <climits>
#include <cstdint>

#include "stencil_common.cuh"

namespace tpumt {
namespace {

constexpr int TR = 32;   // output rows per CTA
constexpr int TC = 128;  // output columns per CTA
constexpr int BX = 32;   // threads along columns (one warp: coalesced rows)
constexpr int BY = 8;    // threads along rows
constexpr size_t kMaxSmem = 232448;  // H100: 227 KB per block, opt-in

template <typename T>
__global__ void __launch_bounds__(BX* BY)
    heat2d_kernel(const T* __restrict__ z, T* __restrict__ out, long long n0,
                  long long n1, int steps, typename Elt<T>::C cx,
                  typename Elt<T>::C cy, typename Elt<T>::C two,
                  long long tiles_c) {
  using E = Elt<T>;
  using C = typename E::C;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int WR = TR + 2 * steps;  // window rows
  const int WC = TC + 2 * steps;  // window columns
  C* buf0 = reinterpret_cast<C*>(smem_raw);
  C* buf1 = buf0 + static_cast<size_t>(WR) * WC;

  const long long tile = blockIdx.x;
  const long long r0 = (tile / tiles_c) * TR - steps;  // window origin
  const long long c0 = (tile % tiles_c) * TC - steps;
  const int tx = threadIdx.x, ty = threadIdx.y;

  for (int pr = ty; pr < WR; pr += BY) {
    const long long r = r0 + pr;
    for (int pc = tx; pc < WC; pc += BX) {
      const long long c = c0 + pc;
      C v = C(0);
      if (r >= 0 && r < n0 && c >= 0 && c < n1) v = E::load(z + r * n1 + c);
      buf0[pr * WC + pc] = v;
    }
  }
  __syncthreads();

  C* src = buf0;
  C* dst = buf1;
  for (int s = 1; s <= steps; ++s) {
    for (int pr = s + ty; pr < WR - s; pr += BY) {
      const long long r = r0 + pr;
      const bool row_in = r >= 1 && r < n0 - 1;
      for (int pc = s + tx; pc < WC - s; pc += BX) {
        const long long c = c0 + pc;
        const int e = pr * WC + pc;
        const C mid = src[e];
        C v = mid;
        if (row_in && c >= 1 && c < n1 - 1) {
          // the XLA body's order: d2 = (z+1 + z-1) - 2*mid per axis,
          // then (mid + cx*d2x) + cy*d2y
          const C m2 = E::mul(two, mid);
          const C d2x = E::sub(E::add(src[e + WC], src[e - WC]), m2);
          const C d2y = E::sub(E::add(src[e + 1], src[e - 1]), m2);
          v = E::add(E::add(mid, E::mul(cx, d2x)), E::mul(cy, d2y));
        }
        dst[e] = v;
      }
    }
    __syncthreads();
    C* t = src;
    src = dst;
    dst = t;
  }

  for (int pr = steps + ty; pr < steps + TR; pr += BY) {
    const long long r = r0 + pr;
    if (r >= n0) break;
    for (int pc = steps + tx; pc < steps + TC; pc += BX) {
      const long long c = c0 + pc;
      if (c < n1) out[r * n1 + c] = E::store(src[pr * WC + pc]);
    }
  }
}

// shared memory one CTA needs: two (TR+2k) x (TC+2k) windows
size_t smem_bytes(int steps, size_t elt) {
  return 2 * static_cast<size_t>(TR + 2 * steps) * (TC + 2 * steps) * elt;
}

template <typename T>
int max_steps() {
  int k = 0;
  while (smem_bytes(k + 1, sizeof(typename Elt<T>::C)) <= kMaxSmem) ++k;
  return k;
}

template <typename T>
int launch(const void* z, void* out, long long n0, long long n1, int steps,
           double cx, double cy, double two, cudaStream_t stream) {
  using E = Elt<T>;
  const long long tiles_c = (n1 + TC - 1) / TC;
  const long long tiles = ((n0 + TR - 1) / TR) * tiles_c;
  if (tiles == 0) return cudaSuccess;
  if (tiles > INT_MAX) return cudaErrorInvalidConfiguration;
  const size_t smem = smem_bytes(steps, sizeof(typename E::C));
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        heat2d_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  heat2d_kernel<T>
      <<<static_cast<unsigned>(tiles), dim3(BX, BY), smem, stream>>>(
          static_cast<const T*>(z), static_cast<T*>(out), n0, n1, steps,
          E::coef(cx), E::coef(cy), E::coef(two), tiles_c);
  return cudaGetLastError();
}

}  // namespace
}  // namespace tpumt

// The deepest `steps` one launch takes for `dtype` (0 for an unknown
// dtype): the two windows must fit in a block's shared memory.
extern "C" int tpumt_heat2d_max_steps(int dtype) {
  using namespace tpumt;
  switch (dtype) {
    case kF32:
      return max_steps<float>();
    case kF64:
      return max_steps<double>();
    case kBF16:
      return max_steps<__nv_bfloat16>();
    default:
      return 0;
  }
}

// Plain C entry point (bound with ctypes). Returns a cudaError_t: 0 when
// the launch was accepted. `cx`, `cy` and `two` arrive already rounded to
// the array dtype. `out` must not alias `z`.
extern "C" int tpumt_heat2d(const void* z, void* out, int dtype, long long n0,
                            long long n1, int steps, double cx, double cy,
                            double two, void* stream) {
  using namespace tpumt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (steps < 1) return cudaErrorInvalidValue;
  switch (dtype) {
    case kF32:
      return launch<float>(z, out, n0, n1, steps, cx, cy, two, s);
    case kF64:
      return launch<double>(z, out, n0, n1, steps, cx, cy, two, s);
    case kBF16:
      return launch<__nv_bfloat16>(z, out, n0, n1, steps, cx, cy, two, s);
    default:
      return cudaErrorInvalidValue;
  }
}
