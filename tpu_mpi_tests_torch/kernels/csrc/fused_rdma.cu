// One-launch fused halo exchange + k-step stencil update along dim 0.
//
// Replaces the Pallas kernel stencil2d_fused_rdma_pallas
// (tpu_mpi_tests/kernels/pallas_kernels.py:2090, body _fused_rdma_kernel
// :1905, ghost patch _patch_rows :1886): in one launch, the edge bands go
// to the ring neighbours while the interior row blocks are computed, and
// the two seam blocks are computed once the neighbours' edges have landed.
// The result equals ring_halo followed by stencil2d_iterate (dim 0) bit for
// bit: the tile update is the iterate kernel's own (stencil_kstep.cuh, on
// the route hand.kstep_route names for z and out), fed the same ghost
// bytes.
//
// Layout: the (R, W) array is cut into nb = R / B row blocks of B rows
// (B divides R, B >= 2K, K = steps*N_BND), each block into column tiles
// (the regs route, on rows of whole 16-byte vectors: kRegsThreads 16-byte
// column vectors, each thread walking the block's B rows as its run; the
// smem route: 64
// columns, the block in shared memory, B <= 256). B >= 2K keeps every
// block but the first and the last away from the ghost bands: only those
// two are seams. On the regs route the caller may leave B to the launcher
// (B = 0): the shortest divisor of R no shorter than the seam,
// kMinBlockRows and the rows that fill the card once (every CTA of the
// launch resident at once, by the occupancy API), else R.
// Out of place, like stencil_iterate.cu: the result goes to `out`, the
// runner's second buffer.
//
// Schedule, by an atomic work ticket (the order CTAs started in, never
// blockIdx): tickets [0, S) send, then the seam tiles, then the interior
// tiles. A seam CTA spins only after every send CTA has started, so on the
// self-ring, where the producers are CTAs of this very launch, the
// spinning cannot starve them; the seams' wait overlaps the interior's
// work, and no seam tile is left for the launch's tail.
//   send CTAs: entry barrier (as ring_halo.cu); each stores its share of
//     my two K-row edge bands straight into the neighbours' INPUT ghost
//     bands by ring_halo's walk (the barrier makes that safe: the
//     neighbour has entered this launch, so its previous launch, which
//     wrote this buffer as its output, has finished) — 16-byte vectors,
//     kSendUnroll pairs in flight a thread, where ring_halo's rule says
//     vec16, one element pair a thread otherwise; one acquire-release
//     count a CTA (ring_arrive_cta); the last send CTA signals the
//     arrivals.
//   interior tiles: the k-step body from `z`; their K-deep apron reads no
//     ghost band an exchange feeds.
//   seam tiles: wait for the arrival on their side, then the k-step body
//     (the window reads the landed ghost rows in place, through L2: no
//     patch, never the read-only path).
// Signals, waits and counts at gpu scope on the one-card self-ring (every
// pointer the rank's own), at system scope otherwise (ring_halo.cu's
// rule). Extents under 3K: one send CTA stages both edges before the
// barrier (the edges overlap the ghost bands neighbours write) and stores
// them by ring_store.
// `local_only` (and a ring that sends nothing, world = 1 non-periodic) is
// the template instance with the barrier, the stores and the waits
// compiled out: the pure compute pass the OVERLAP probe times against.
//
// Bound on the H100: bytes, as the iterate kernel: R*W read and written
// once, plus the 2*K*W edge bytes to the peers.
#include <climits>
#include <cstdint>

#include "occupancy.cuh"
#include "ring_common.cuh"
#include "stencil_kstep.cuh"

namespace tpumt {
namespace {

constexpr int kTB = KTile<0>::TB;  // 64 columns per smem tile
constexpr int kMaxB = 256;         // rows per block the shared memory holds
constexpr long long kMaxSendCtas = 64;
constexpr int kSendUnroll = 4;     // vector pairs in flight a send thread
constexpr int kMinBlockRows = 128; // the regs route's shortest default block

template <int N>
struct Word;
template <>
struct Word<2> {
  using type = uint16_t;
};
template <>
struct Word<4> {
  using type = uint32_t;
};
template <>
struct Word<8> {
  using type = uint64_t;
};

struct FusedGeom {
  long long n0, n1;
  int steps;
  int B, nb, tiles_b;
  int senders;   // send CTAs
  int interior;  // interior tiles
  bool vec16;    // the sends' route: ring_halo's vec16 rule
  bool sys;      // signals at system scope (a neighbour on another card)
  HaloWalk walk;  // the bands in items of the sends' route
};

template <bool kSys, typename W>
__device__ __forceinline__ void fused_send(const RingView<W>& r,
                                          const FusedGeom& g, W* stage,
                                          int ticket) {
  if (threadIdx.x == 0 && threadIdx.y == 0) ring_enter<kSys>(r, ticket == 0);
  __syncthreads();
  if (stage) {
    ring_store(r, stage, 0, 1);
  } else if (g.vec16) {
    const RingView<uint4> v{
        reinterpret_cast<const uint4*>(r.z),
        reinterpret_cast<uint4*>(r.left_z),
        reinterpret_cast<uint4*>(r.right_z), r.pad, r.left_pad,
        r.right_pad, r.epoch, r.axis, r.n0, r.n1, r.b, r.send_lo,
        r.send_hi};
    halo_walk<kSendUnroll>(v, g.walk, ticket, g.senders);
  } else {
    halo_walk<1>(r, g.walk, ticket, g.senders);
  }
  ring_arrive_cta<kSys>(r, g.senders);
}

// kK: the regs route's steps (CTAs of kRegsThreads); 0, the smem route
// (any steps, CTAs of 256 threads).
template <typename T, int kK, bool kComm>
__global__ void __launch_bounds__(kK ? kRegsThreads : 256)
    fused_rdma_kernel(RingView<typename Word<sizeof(T)>::type> r, T* out,
                      FusedGeom g, typename Elt<T>::C se,
                      typename Elt<T>::C c1, typename Elt<T>::C c2,
                      int phys_lo, int phys_hi, const int* phys,
                      typename Word<sizeof(T)>::type* stage) {
  using C = typename Elt<T>::C;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int ticket_slot;
  const int ticket = take_ticket(r.pad, &ticket_slot);
  const T* z = reinterpret_cast<const T*>(r.z);

  if (kComm && ticket < g.senders) {
    if (stage) {
      ring_stage(r, stage);
      __syncthreads();
    }
    if (g.sys)
      fused_send<true>(r, g, stage, ticket);
    else
      fused_send<false>(r, g, stage, ticket);
    return;
  }
  int t = ticket - (kComm ? g.senders : 0);
  const int seams = g.nb == 1 ? g.tiles_b : 2 * g.tiles_b;
  int blk;
  if (t >= seams) {
    t -= seams;
    blk = 1 + t / g.tiles_b;
  } else {
    blk = t < g.tiles_b ? 0 : g.nb - 1;
    if (kComm && threadIdx.x == 0 && threadIdx.y == 0) {
      // the seam waits mirror the neighbours' send predicates: a side
      // receives exactly when it sends
      if (blk == 0 && r.send_lo) {
        if (g.sys)
          pad_wait<true>(r.pad + kArrFromLeft, r.epoch);
        else
          pad_wait<false>(r.pad + kArrFromLeft, r.epoch);
      }
      if (blk == g.nb - 1 && r.send_hi) {
        if (g.sys)
          pad_wait<true>(r.pad + kArrFromRight, r.epoch);
        else
          pad_wait<false>(r.pad + kArrFromRight, r.epoch);
      }
    }
    __syncthreads();
  }
  const int col = t % g.tiles_b;
  const int plo = phys ? (phys[0] != 0) : phys_lo;
  const int phi = phys ? (phys[1] != 0) : phys_hi;
  if constexpr (kK == 0) {
    kstep_tile<T, 0>(z, out, g.n0, g.n1, g.steps, se, c1, c2, plo, phi,
                     static_cast<long long>(blk) * g.B, g.B,
                     static_cast<long long>(col) * kTB,
                     reinterpret_cast<C*>(smem_raw));
  } else {
    using KW = KWord<T>;
    constexpr int E = kFusedRowBytes / sizeof(T);
    const long long v =
        static_cast<long long>(col) * kRegsThreads + threadIdx.x;
    if (v >= g.n1 / E) return;
    kstep_regs_dim0<T, kK, kFusedRowBytes, true>(
        reinterpret_cast<const char*>(z + v * E),
        reinterpret_cast<char*>(out + v * E), g.n1 * sizeof(T),
        static_cast<int>(g.n0), blk * g.B, g.B, KW::coef(se), KW::coef(c1),
        KW::coef(c2), plo, phi);
  }
}

// The shortest divisor of n0 no shorter than `least`, else n0.
inline long long shortest_divisor(long long n0, long long least) {
  long long best = n0;
  for (long long d = 1; d * d <= n0; ++d) {
    if (n0 % d) continue;
    if (d >= least && d < best) best = d;
    if (n0 / d >= least && n0 / d < best) best = n0 / d;
  }
  return best;
}

// Launch with row blocks of B rows (0 on the regs route: the launcher's,
// see the layout note), written to *block_rows unless it is NULL.
template <typename T, int kK, bool kComm>
int launch_as(const RingView<typename Word<sizeof(T)>::type>& r, void* out,
              FusedGeom g, int B, double se, double c1, double c2,
              int phys_lo, int phys_hi, const int* phys, void* stage,
              int* block_rows, cudaStream_t s) {
  using E = Elt<T>;
  using W = typename Word<sizeof(T)>::type;
  auto* kernel = fused_rdma_kernel<T, kK, kComm>;
  if constexpr (kK > 0) {
    if (B == 0) {
      static int resident = 0;
      const cudaError_t rc = coll_resident_ctas(
          reinterpret_cast<const void*>(kernel), kRegsThreads, &resident);
      if (rc != cudaSuccess) return rc;
      long long least = (g.n0 * g.tiles_b + resident - 1) / resident;
      if (least < kMinBlockRows) least = kMinBlockRows;
      if (least < 2LL * g.steps * kRadius) least = 2LL * g.steps * kRadius;
      B = static_cast<int>(shortest_divisor(g.n0, least));
    }
  }
  if (B < 1) return cudaErrorInvalidValue;
  g.B = B;
  g.nb = static_cast<int>(g.n0 / B);
  if (g.tiles_b > INT_MAX / (g.nb + 1)) return cudaErrorInvalidConfiguration;
  g.interior = g.nb > 2 ? (g.nb - 2) * g.tiles_b : 0;
  if (block_rows) *block_rows = B;
  const long long seams = g.nb == 1 ? g.tiles_b : 2LL * g.tiles_b;
  const long long ctas = (kComm ? g.senders : 0) + g.interior + seams;
  if (ctas > INT_MAX) return cudaErrorInvalidConfiguration;
  size_t smem = 0;
  dim3 block(kRegsThreads);
  if constexpr (kK == 0) {
    smem = kstep_smem_bytes<T, 0>(g.B, g.steps);
    if (smem > 227 * 1024 - 1024) return cudaErrorInvalidValue;
    // the ticket's static word counts against the 48 KiB default too
    if (smem > 47 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    block = dim3(KTile<0>::BX, KTile<0>::BY);
  }
  kernel<<<static_cast<unsigned>(ctas), block, smem, s>>>(
      r, static_cast<T*>(out), g, E::coef(se), E::coef(c1), E::coef(c2),
      phys_lo, phys_hi, phys, static_cast<W*>(stage));
  return cudaGetLastError();
}

template <typename T, int kK>
int launch_comm(bool comm, const RingView<typename Word<sizeof(T)>::type>& r,
                void* out, const FusedGeom& g, int B, double se, double c1,
                double c2, int phys_lo, int phys_hi, const int* phys,
                void* stage, int* block_rows, cudaStream_t s) {
  if (comm)
    return launch_as<T, kK, true>(r, out, g, B, se, c1, c2, phys_lo,
                                  phys_hi, phys, stage, block_rows, s);
  return launch_as<T, kK, false>(r, out, g, B, se, c1, c2, phys_lo, phys_hi,
                                 phys, nullptr, block_rows, s);
}

template <typename T>
int launch(int route, void* z, void* out, void* left_z, void* right_z,
           int* pad, int* left_pad, int* right_pad, int epoch, long long n0,
           long long n1, int steps, int B, double se, double c1, double c2,
           int phys_lo, int phys_hi, const int* phys, int send_lo,
           int send_hi, void* stage, int* block_rows, cudaStream_t s) {
  using W = typename Word<sizeof(T)>::type;
  const int K = steps * kRadius;
  RingView<W> r{static_cast<const W*>(z), static_cast<W*>(left_z),
                static_cast<W*>(right_z), pad, left_pad, right_pad, epoch,
                0, n0, n1, K, send_lo, send_hi};
  FusedGeom g{};
  g.n0 = n0;
  g.n1 = n1;
  g.steps = steps;
  const long long cols =
      route == kKStepRegs
          ? (n1 / (kFusedRowBytes / sizeof(T)) + kRegsThreads - 1) /
                kRegsThreads
          : (n1 + kTB - 1) / kTB;
  if (cols > INT_MAX) return cudaErrorInvalidConfiguration;
  g.tiles_b = static_cast<int>(cols);
  const bool comm = send_lo || send_hi;
  g.vec16 = halo_route(sizeof(T), 0, n0, n1, K, z, left_z, right_z) ==
            kRouteVec16;
  g.sys = !(left_z == z && right_z == z && left_pad == pad &&
            right_pad == pad);
  const long long v = g.vec16 ? 16 / sizeof(T) : 1;
  g.walk = walk_of(0, n0, n1, K, v);
  const int threads = route == kKStepRegs ? kRegsThreads
                                          : KTile<0>::BX * KTile<0>::BY;
  const long long per_cta = threads * (g.vec16 ? kSendUnroll : 1LL);
  long long senders = (g.walk.rows * g.walk.vb + per_cta - 1) / per_cta;
  if (senders > kMaxSendCtas) senders = kMaxSendCtas;
  if (senders < 1 || stage) senders = 1;
  g.senders = comm ? static_cast<int>(senders) : 0;
  if (route == kKStepSmem)
    return launch_comm<T, 0>(comm, r, out, g, B, se, c1, c2, phys_lo,
                             phys_hi, phys, stage, block_rows, s);
  return with_steps(steps, [&](auto kk) -> int {
    return launch_comm<T, decltype(kk)::value>(comm, r, out, g, B, se, c1,
                                               c2, phys_lo, phys_hi, phys,
                                               stage, block_rows, s);
  });
}

}  // namespace
}  // namespace tpumt

// Plain C entry point (bound with ctypes). Returns a cudaError_t: 0 when
// the launch was accepted. `z` (my input, in peer memory) and `out` are
// contiguous (n0, n1) float32, float64 or bfloat16 arrays that share no
// storage;
// `left_z` / `right_z` are the neighbours' copies of `z`; pads and epoch as
// in ring_halo.cu. B rows per block must divide n0 and hold the seam
// (B >= 2K, K = 2*steps; on the smem route B <= 256), or be 0 on the regs
// route (the launcher's block); the block launched goes to *block_rows
// unless it is NULL. n0 > 2K. send_lo =
// send_hi = 0 (local_only, or a ring with no peer) runs the compute-only
// instance. `route` is the KStepRoute code hand.kstep_route (fused) names
// for z, out and `steps` (any other value is refused). `stage` is NULL, or
// 2*K*n1 elements of scratch when n0 < 3K.
extern "C" int tpumt_stencil2d_fused_rdma(
    void* z, void* out, void* left_z, void* right_z, void* pad,
    void* left_pad, void* right_pad, int epoch, int dtype, long long n0,
    long long n1, int steps, int B, double se, double c1, double c2,
    int phys_lo, int phys_hi, const void* phys, int send_lo, int send_hi,
    int route, void* stage, int* block_rows, void* stream) {
  using namespace tpumt;
  const long long K = 2LL * steps;
  const int itemsize = dtype == kBF16 ? 2 : dtype == kF64 ? 8 : 4;
  const bool chosen = B == 0 && route == kKStepRegs;
  if (steps < 1 || n1 < 1 || n0 <= 2 * K ||
      (!chosen && (B < 2 * K || n0 % B != 0)) || n0 > INT_MAX ||
      ((send_lo || send_hi) && epoch < 1) ||
      route != kstep_route(steps, z, out, n1, itemsize, kFusedRowBytes) ||
      (route == kKStepSmem && B > kMaxB))
    return cudaErrorInvalidValue;
  if (n0 < 3 * K && stage == nullptr && (send_lo || send_hi))
    return cudaErrorInvalidValue;
  int* p = static_cast<int*>(pad);
  int* lp = static_cast<int*>(left_pad);
  int* rp = static_cast<int*>(right_pad);
  const int* ph = static_cast<const int*>(phys);
  void* st = n0 < 3 * K ? stage : nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch<float>(route, z, out, left_z, right_z, p, lp, rp, epoch,
                           n0, n1, steps, B, se, c1, c2, phys_lo, phys_hi,
                           ph, send_lo, send_hi, st, block_rows, s);
    case kF64:
      return launch<double>(route, z, out, left_z, right_z, p, lp, rp, epoch,
                            n0, n1, steps, B, se, c1, c2, phys_lo, phys_hi,
                            ph, send_lo, send_hi, st, block_rows, s);
    case kBF16:
      return launch<__nv_bfloat16>(route, z, out, left_z, right_z, p, lp, rp,
                                   epoch, n0, n1, steps, B, se, c1, c2,
                                   phys_lo, phys_hi, ph, send_lo, send_hi,
                                   st, block_rows, s);
    default:
      return cudaErrorInvalidValue;
  }
}
