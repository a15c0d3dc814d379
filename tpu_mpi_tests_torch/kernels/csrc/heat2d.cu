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
// cx, cy and 2 arrive rounded to the array dtype. The output goes to a
// SECOND buffer: the TPU kernel aliases input and output because each of
// its row blocks holds the whole shard width, but blocks that split both
// axes would read apron cells a neighbour had already overwritten. The
// caller ping-pongs two buffers.
//
// Two bodies, two routes (hand.HEAT_ROUTES; a route's code is its index),
// named by the wrapper (hand.heat_route) and checked here:
//
// "regs" (heat2d_regs), where 1 <= steps <= kHeatRegsMaxSteps and every
// row of z and out starts on a word (4 bytes; 8 for float64): no shared
// memory, no barrier, every step in registers, in vectors of 16, 8 or 4
// bytes — the widest every row of both starts on (heat_vec_bytes). A warp
// owns a column segment of 32 lanes × one 16-byte vector or kHeatLaneVecs
// narrower ones: lane L holds the segment's vectors L, L + 32, .. (so
// every load and store is 32 consecutive vectors). The segment carries a
// steps-deep apron on each side, rounded up to whole vectors, and the
// warp writes only the inner part. The warp walks a run of rows through a
// k-stage pipeline of 3-row register windows (radius 1): a row read at
// iteration r enters stage 1, and stage s emits its row one behind stage
// s-1, so the last stage emits row r - k; the loads of the next
// kHeatPrefetch rows are issued before a row's arithmetic. A step takes
// the column neighbours at a vector's edges from lanes +-1 by warp
// shuffles (the segment's first and last element get wrong ones, which
// the apron absorbs: it loses one exact column a step). Every branch
// around the shuffles is uniform in the CTA, so the compiler adds no
// reconvergence to them: the walk runs whole turns of kHeatSlots rows,
// the row test is made once a row per stage, the column test only in the
// CTAs whose segments reach column 0 or n1-1, and a warp past the last
// segment walks with its loads and stores off. Runs are sized so that one
// wave of warps fills the card (the occupancy API), none shorter than
// kHeatRunRows. bfloat16 runs packed (Pk<T>: add/sub/mul.rn.bf16x2, two
// elements an instruction, each result correctly rounded, which is what
// float-then-round gives).
//
// "smem" (heat2d_kernel), any other depth or alignment: a CTA owns an
// output tile of TR rows by TC columns. It loads the tile plus a
// `steps`-deep apron on every side (zero outside the array) into shared
// memory and advances it `steps` times there, ping-ponging two shared
// buffers: at step s it updates the window positions [s, W-s) on both
// axes, the part whose inputs are still exact (the valid window shrinks
// by one cell per step and per side), so after `steps` steps the tile
// itself is exact. Then it writes the tile, outer ring included.
//
// Bound on the H100: memory at k = 1 and 4 (the driver's depths), close
// to the issue rate at k = 8. Per step a cell costs 9 lone ops (nothing
// contracts under -fmad=false); at k=4 that is 36 ops against 8 bytes
// (f32 read + write), 4.5 op/byte, below the card's ~10 lone-op/byte f32
// ridge (33.45 T lone ops/s over 3.35 TB/s); at k=8, 9 op/byte. The regs
// route re-reads its aprons from L2: 2k rows a run and 2*ceil(k/E)
// vectors a segment (at k=4 in f32, 8 of 128 columns).
#include <climits>
#include <cstdint>
#include <type_traits>

#include "occupancy.cuh"
#include "stencil_common.cuh"

namespace tpumt {

enum HeatRoute : int { kHeatSmem = 0, kHeatRegs = 1 };

// The regs route's compile-time choices (kernels/heat_ab.py varies each).
constexpr int kHeatRegsMaxSteps = 8;  // the stages a lane's registers hold
constexpr int kHeatPrefetch = 4;      // rows in flight ahead of the last in
constexpr int kHeatRunRows = 32;      // the shortest run a warp walks
constexpr int kHeatLaneVecs = 2;      // vectors a lane holds under 16 bytes
constexpr int kHeatThreads = 128;     // threads a CTA
// the slots of a window and of the prefetch ring (row t of the walk in
// slot t % kHeatSlots): three rows a window, and the rows in flight
constexpr int kHeatSlots = 5;
static_assert(kHeatPrefetch >= 1 && kHeatPrefetch < kHeatSlots &&
                  kHeatSlots >= 3,
              "rows in flight");

// The regs route's vector for z and out: the widest of 16, 8 and 4 bytes
// that every row of both starts on (both start there and the row pitch is
// whole vectors) and that holds a whole word (8 bytes for float64), else
// 0 (no vector).
inline int heat_vec_bytes(const void* z, const void* out, long long n1,
                          int itemsize) {
  const int word = itemsize == 8 ? 8 : 4;
  for (int b = 16; b >= word; b /= 2)
    if (rows_start_on(b, z, out, n1 * itemsize, n1 * itemsize)) return b;
  return 0;
}

// The rule (hand.heat_route): regs when 1 <= steps <= kHeatRegsMaxSteps
// and heat_vec_bytes finds a vector, else smem.
inline int heat_route(int steps, const void* z, const void* out,
                      long long n1, int itemsize) {
  return steps >= 1 && steps <= kHeatRegsMaxSteps &&
                 heat_vec_bytes(z, out, n1, itemsize) > 0
             ? kHeatRegs
             : kHeatSmem;
}

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

// ---------------------------------------------------------------------------
// the regs route
// ---------------------------------------------------------------------------

// A warp's segment at kK steps in vectors of kVB bytes: lane L holds
// vectors v0 + 32 * u + L, u < U.
template <typename T, int kK, int kVB>
struct HeatGeom {
  using W = typename Pk<T>::W;
  static constexpr int E = kVB / sizeof(T);    // elements a vector
  static constexpr int NW = kVB / sizeof(W);   // words a vector
  static constexpr int U = kVB == 16 ? 1 : kHeatLaneVecs;  // vectors a lane
  static constexpr int n = U * NW;             // words a lane holds
  static constexpr int Kv = (kK + E - 1) / E;  // apron vectors a side
  static constexpr int kLoad = 32 * U;         // vectors a warp loads a row
  static constexpr int kInner = kLoad - 2 * Kv;  // vectors it writes
  static_assert(U >= 1 && NW >= 1 && kInner > 0,
                "a segment wider than its aprons");
};

// The regs route: warp w of CTA column blockIdx.x owns segment
// blockIdx.x * (kHeatThreads / 32) + w of run blockIdx.y (rows
// blockIdx.y * ta .. + ta).
// (__launch_bounds__ with one CTA an SM: without it ptxas capped the
// deeper f32 and bf16 instances at 80-128 registers, with spills)
template <typename T, int kK, int kVB>
__global__ void __launch_bounds__(kHeatThreads, 1)
    heat2d_regs(const T* __restrict__ z, T* __restrict__ out, int n0, int n1,
                int segs, int ta, typename Elt<T>::C cx_,
                typename Elt<T>::C cy_, typename Elt<T>::C two_) {
  using P = Pk<T>;
  using W = typename P::W;
  using G = HeatGeom<T, kK, kVB>;
  using V = typename VecOf<kVB>::V;
  constexpr int n = G::n;
  constexpr int S = kHeatSlots;
  constexpr int kWarps = kHeatThreads / 32;
  // a warp past the last segment walks with its loads and stores off (no
  // exit: every branch around the shuffles stays uniform in the CTA)
  const int seg = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const W cx = P::splat(cx_), cy = P::splat(cy_), two = P::splat(two_);
  const int nv = n1 / G::E;
  const long long v0 = static_cast<long long>(seg) * G::kInner - G::Kv;
  const long long lv = v0 + lane;   // this lane's first vector
  const long long a_lane = lv * G::E;  // the column of its first element
  // no column test where every column the CTA's warps load lies in
  // [1, n1 - 1) (a test on blockIdx alone, uniform in the CTA)
  const long long c0 = static_cast<long long>(blockIdx.x) * kWarps;
  const bool inner = (c0 * G::kInner - G::Kv) * G::E >= 1 &&
                     ((c0 + kWarps - 1) * G::kInner - G::Kv + G::kLoad) *
                             G::E <=
                         n1 - 1;
  bool vin[G::U], vout[G::U];  // a vector loaded / written by this lane
#pragma unroll
  for (int u = 0; u < G::U; ++u) {
    const long long vi = lv + 32 * u;
    vin[u] = seg < segs && vi >= 0 && vi < nv;
    vout[u] = seg < segs && vi >= v0 + G::Kv &&
              vi < v0 + G::Kv + G::kInner && vi < nv;
  }
  const long long pitch = static_cast<long long>(n1) * sizeof(T);
  constexpr int kStride = 32 * kVB;  // bytes from a lane's vector to its next
  const char* zb = reinterpret_cast<const char*>(z) + lv * kVB;
  char* ob = reinterpret_cast<char*>(out) + lv * kVB;

  const int a0 = blockIdx.y * ta;  // the run's first row
  const int stop = a0 + ta < n0 ? a0 + ta : n0;
  const int r0 = a0 - kK;  // rows r0 .. r1 - 1 enter the pipeline
  const int r1 = stop + kK;
  const int rend = r1 < n0 ? r1 : n0;  // rows past it load as zeros
  // the walk, with the column test where the segment reaches column 0 or
  // n1 - 1 (kEdge) and without it elsewhere; it runs whole turns of S
  // rows (no exit in a turn: the warp stays converged), the rows past r1
  // loaded as zeros and their results not stored
  auto walk = [&](auto edge) {
    constexpr bool kEdge = decltype(edge)::value;
    // the next row to load and the next to store (stage k's row c = r -
    // kK at row r), a row pitch apart from one phase to the next
    int rl = r0 + kHeatPrefetch;
    const char* zl = zb + static_cast<long long>(rl) * pitch;
    char* os = ob + static_cast<long long>(r0 - kK) * pitch;
    auto load = [&](int r, const char* src, W* dst) {
#pragma unroll
      for (int u = 0; u < G::U; ++u) {
        V v{};
        if (static_cast<unsigned>(r) < static_cast<unsigned>(rend) && vin[u])
          v = __ldg(reinterpret_cast<const V*>(src + u * kStride));
        memcpy(dst + u * G::NW, &v, kVB);
      }
    };
    // win[s][t % S]: row t of the walk as stage s emitted it (stage 0: as
    // loaded); pre[]: the kHeatPrefetch rows loaded ahead
    W win[kK][S][n];
    W pre[S][n];
#pragma unroll
    for (int s = 0; s < kK; ++s)
#pragma unroll
      for (int i = 0; i < S; ++i)
#pragma unroll
        for (int j = 0; j < n; ++j) win[s][i][j] = P::splat(0);
#pragma unroll
    for (int p = 0; p < kHeatPrefetch; ++p)
      load(r0 + p, zb + static_cast<long long>(r0 + p) * pitch, pre[p]);
    for (int r = r0; r < r1; r += S) {
#pragma unroll
      for (int ph = 0; ph < S; ++ph) {
        load(rl, zl, pre[(ph + kHeatPrefetch) % S]);
        ++rl;
        zl += pitch;
#pragma unroll
        for (int j = 0; j < n; ++j) win[0][ph][j] = pre[ph][j];
#pragma unroll
        for (int s = 1; s <= kK; ++s) {
          const int c = r + ph - s;  // the row stage s emits
          // rows c - 1, c, c + 1 of stage s - 1
          const W* up = win[s - 1][(ph + S - 2) % S];
          const W* mid = win[s - 1][(ph + S - 1) % S];
          const W* dn = win[s - 1][ph];
          // each vector's edge words from lanes -1 and +1 (a lane's
          // vector u follows lane 31's vector u - 1): the segment's first
          // and last are wrong, and absorbed by the apron
          W lft[G::U], rgt[G::U];
#pragma unroll
          for (int u = 0; u < G::U; ++u) {
            const int w = u * G::NW;
            lft[u] = __shfl_sync(0xffffffffu, mid[w + G::NW - 1], lane - 1,
                                 32);
            rgt[u] = __shfl_sync(0xffffffffu, mid[w], lane + 1, 32);
          }
          W v[n];
          if (c >= 1 && c < n0 - 1) {
#pragma unroll
            for (int u = 0; u < G::U; ++u) {
              W e[G::NW + 2];
              e[0] = lane == 0 && u > 0 ? lft[u - 1] : lft[u];
              e[G::NW + 1] = lane == 31 && u + 1 < G::U ? rgt[u + 1] : rgt[u];
#pragma unroll
              for (int j = 0; j < G::NW; ++j) e[1 + j] = mid[u * G::NW + j];
#pragma unroll
              for (int j = 0; j < G::NW; ++j) {
                const W m = e[1 + j];
                // the XLA body's order: d2 = (z+1 + z-1) - 2*mid per axis,
                // then (mid + cx*d2x) + cy*d2y
                const W m2 = P::mul(two, m);
                const W d2x = P::sub(P::add(dn[u * G::NW + j],
                                            up[u * G::NW + j]), m2);
                const W d2y = P::sub(
                    P::add(pk_at<T, 1>(e, 1 + j), pk_at<T, -1>(e, 1 + j)), m2);
                const W nw = P::add(P::add(m, P::mul(cx, d2x)),
                                    P::mul(cy, d2y));
                if constexpr (!kEdge) {
                  v[u * G::NW + j] = nw;
                } else {
                  const long long a = a_lane + 32LL * u * G::E + j * P::kElems;
                  v[u * G::NW + j] = P::sel(nw, m, a >= 1 && a < n1 - 1,
                                            a + 1 >= 1 && a + 1 < n1 - 1);
                }
              }
            }
          } else {
#pragma unroll
            for (int j = 0; j < n; ++j) v[j] = mid[j];
          }
          if (s < kK) {
#pragma unroll
            for (int j = 0; j < n; ++j) win[s][ph][j] = v[j];
          } else if (static_cast<unsigned>(c - a0) <
                     static_cast<unsigned>(stop - a0)) {
#pragma unroll
            for (int u = 0; u < G::U; ++u) {
              if (!vout[u]) continue;
              V o;
              memcpy(&o, v + u * G::NW, kVB);
              *reinterpret_cast<V*>(os + u * kStride) = o;
            }
          }
        }
        os += pitch;
      }
    }
  };
  if (inner)
    walk(std::false_type{});
  else
    walk(std::true_type{});
}

// The regs route at kK steps in vectors of kVB bytes: as many runs as
// the card's resident CTAs hold in one wave (one run a warp, no loop),
// none shorter than kHeatRunRows, balanced.
template <typename T, int kK, int kVB>
int launch_regs_as(const void* z, void* out, long long n0, long long n1,
                   double cx, double cy, double two, cudaStream_t stream) {
  using E = Elt<T>;
  using G = HeatGeom<T, kK, kVB>;
  constexpr int kWarps = kHeatThreads / 32;
  static int resident = 0;
  const cudaError_t rc = coll_resident_ctas(
      reinterpret_cast<const void*>(heat2d_regs<T, kK, kVB>), kHeatThreads,
      &resident);
  if (rc != cudaSuccess) return rc;
  const long long nv = n1 / G::E;
  const long long segs = (nv + G::kInner - 1) / G::kInner;
  const long long cols = (segs + kWarps - 1) / kWarps;
  const long long runs = wave_runs(resident, cols, n0, kHeatRunRows);
  const long long ta = (n0 + runs - 1) / runs;
  if (cols > INT_MAX || runs > 65535) return cudaErrorInvalidConfiguration;
  heat2d_regs<T, kK, kVB>
      <<<dim3(static_cast<unsigned>(cols), static_cast<unsigned>(runs)),
         kHeatThreads, 0, stream>>>(
          static_cast<const T*>(z), static_cast<T*>(out),
          static_cast<int>(n0), static_cast<int>(n1),
          static_cast<int>(segs), static_cast<int>(ta), E::coef(cx),
          E::coef(cy), E::coef(two));
  return cudaGetLastError();
}

// The regs route in vectors of `vb` bytes (heat_vec_bytes): an instance
// for each of 1 .. kHeatRegsMaxSteps steps, cudaErrorInvalidValue for any
// other.
template <typename T>
int launch_regs(int vb, const void* z, void* out, long long n0,
                long long n1, int steps, double cx, double cy, double two,
                cudaStream_t stream) {
  if (n0 > INT_MAX / 2 || n1 > INT_MAX / 2) return cudaErrorInvalidValue;
  if (n0 == 0 || n1 == 0) return cudaSuccess;
  auto as = [&](auto kk) -> int {
    constexpr int k = decltype(kk)::value;
    if (vb == 16)
      return launch_regs_as<T, k, 16>(z, out, n0, n1, cx, cy, two, stream);
    if (vb == 8)
      return launch_regs_as<T, k, 8>(z, out, n0, n1, cx, cy, two, stream);
    if constexpr (sizeof(T) < 8) {
      if (vb == 4)
        return launch_regs_as<T, k, 4>(z, out, n0, n1, cx, cy, two, stream);
    }
    return cudaErrorInvalidValue;
  };
  switch (steps) {
#define TPUMT_HEAT_STEPS(k)                        \
  case k:                                          \
    if constexpr (k <= kHeatRegsMaxSteps)          \
      return as(std::integral_constant<int, k>{}); \
    break;
    TPUMT_HEAT_STEPS(1)
    TPUMT_HEAT_STEPS(2)
    TPUMT_HEAT_STEPS(3)
    TPUMT_HEAT_STEPS(4)
    TPUMT_HEAT_STEPS(5)
    TPUMT_HEAT_STEPS(6)
    TPUMT_HEAT_STEPS(7)
    TPUMT_HEAT_STEPS(8)
#undef TPUMT_HEAT_STEPS
    default:
      break;
  }
  return cudaErrorInvalidValue;
}

template <typename T>
int launch_route(int route, const void* z, void* out, long long n0,
                 long long n1, int steps, double cx, double cy, double two,
                 cudaStream_t stream) {
  if (route == kHeatRegs)
    return launch_regs<T>(heat_vec_bytes(z, out, n1, sizeof(T)), z, out, n0,
                          n1, steps, cx, cy, two, stream);
  return launch<T>(z, out, n0, n1, steps, cx, cy, two, stream);
}

}  // namespace
}  // namespace tpumt

// The deepest `steps` one launch on the smem route takes for `dtype` (0
// for an unknown dtype): the two windows must fit in a block's shared
// memory.
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
// the array dtype. `out` must not alias `z`. `route` is the HeatRoute
// code that hand.heat_route names for these pointers, this row pitch and
// `steps` (any other value is refused).
extern "C" int tpumt_heat2d(const void* z, void* out, int dtype, long long n0,
                            long long n1, int steps, double cx, double cy,
                            double two, int route, void* stream) {
  using namespace tpumt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (steps < 1 || (dtype != kF32 && dtype != kF64 && dtype != kBF16))
    return cudaErrorInvalidValue;
  const int itemsize = dtype == kBF16 ? 2 : dtype == kF64 ? 8 : 4;
  if (route != heat_route(steps, z, out, n1, itemsize))
    return cudaErrorInvalidValue;
  switch (dtype) {
    case kF32:
      return launch_route<float>(route, z, out, n0, n1, steps, cx, cy, two,
                                 s);
    case kF64:
      return launch_route<double>(route, z, out, n0, n1, steps, cx, cy, two,
                                  s);
    default:
      return launch_route<__nv_bfloat16>(route, z, out, n0, n1, steps, cx,
                                         cy, two, s);
  }
}
