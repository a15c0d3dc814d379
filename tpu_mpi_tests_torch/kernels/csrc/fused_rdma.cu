// One-launch fused halo exchange + k-step stencil update along dim 0.
//
// Replaces the Pallas kernel stencil2d_fused_rdma_pallas
// (tpu_mpi_tests/kernels/pallas_kernels.py:2090, body _fused_rdma_kernel
// :1905, ghost patch _patch_rows :1886): in one launch, the edge bands go
// to the ring neighbours while the interior row blocks are computed, and
// the two seam blocks are computed once the neighbours' edges have landed.
// The result equals ring_halo followed by stencil2d_iterate (dim 0) bit for
// bit: the tile update is the iterate kernel's own (kstep_tile,
// stencil_kstep.cuh), fed the same ghost bytes.
//
// Layout: the (R, W) array is cut into nb = R / B row blocks of B rows
// (B divides R, B >= 2K, K = steps*N_BND), each block into 64-column
// tiles. B >= 2K keeps every block but the first and the last away from
// the ghost bands: only those two are seams. Out of place, like
// stencil_iterate.cu: the result goes to `out`, the runner's second
// buffer.
//
// Schedule, by an atomic work ticket (the order CTAs started in, never
// blockIdx): tickets [0, S) send, then the interior tiles, then the seam
// tiles. A seam CTA spins only after every send CTA has started, so on the
// self-ring, where the producers are CTAs of this very launch, the
// spinning cannot starve them.
//   send CTAs: entry barrier (as ring_halo.cu); each stores its share of
//     my two K-row edge bands straight into the neighbours' INPUT ghost
//     bands (the barrier makes that safe: the neighbour has entered this
//     launch, so its previous launch, which wrote this buffer as its
//     output, has finished); fence; the last send CTA signals the
//     arrivals.
//   interior tiles: kstep_tile from `z`; their K-deep apron reads no ghost
//     band an exchange feeds.
//   seam tiles: wait for the arrival on their side, then kstep_tile (the
//     window reads the landed ghost rows in place: no patch).
// Extents under 3K: one send CTA stages both edges before the barrier
// (the edges overlap the ghost bands neighbours write).
// `local_only` (and a ring that sends nothing, world = 1 non-periodic) is
// the template instance with the barrier, the stores and the waits
// compiled out: the pure compute pass the OVERLAP probe times against.
//
// Bound on the H100: bytes, as the iterate kernel: R*W read and written
// once, plus the 2*K*W edge bytes to the peers.
#include <climits>
#include <cstdint>

#include "ring_common.cuh"
#include "stencil_kstep.cuh"

namespace tpumt {
namespace {

constexpr int kTB = KTile<0>::TB;  // 64 columns per tile
constexpr int kMaxB = 256;         // rows per block the shared memory holds
constexpr long long kMaxSendCtas = 64;

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
  int senders;  // send CTAs
  int interior;  // interior tiles
};

template <typename T, bool kComm>
__global__ void __launch_bounds__(256)
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
    if (threadIdx.x == 0 && threadIdx.y == 0) ring_enter(r, ticket == 0);
    __syncthreads();
    ring_store(r, stage, ticket, g.senders);
    ring_arrive(r, g.senders);
    return;
  }
  int t = ticket - (kComm ? g.senders : 0);
  int blk;
  if (t < g.interior) {
    blk = 1 + t / g.tiles_b;
  } else {
    t -= g.interior;
    blk = t < g.tiles_b ? 0 : g.nb - 1;
    if (kComm && threadIdx.x == 0 && threadIdx.y == 0) {
      // the seam waits mirror the neighbours' send predicates: a side
      // receives exactly when it sends
      if (blk == 0 && r.send_lo) pad_wait(r.pad + kArrFromLeft, r.epoch);
      if (blk == g.nb - 1 && r.send_hi)
        pad_wait(r.pad + kArrFromRight, r.epoch);
    }
    __syncthreads();
  }
  const int col = t % g.tiles_b;
  const int plo = phys ? (phys[0] != 0) : phys_lo;
  const int phi = phys ? (phys[1] != 0) : phys_hi;
  kstep_tile<T, 0>(z, out, g.n0, g.n1, g.steps, se, c1, c2, plo, phi,
                   static_cast<long long>(blk) * g.B, g.B,
                   static_cast<long long>(col) * kTB,
                   reinterpret_cast<C*>(smem_raw));
}

template <typename T, bool kComm>
int launch_as(const RingView<typename Word<sizeof(T)>::type>& r, void* out,
              const FusedGeom& g, double se, double c1, double c2,
              int phys_lo, int phys_hi, const int* phys, void* stage,
              cudaStream_t s) {
  using E = Elt<T>;
  using W = typename Word<sizeof(T)>::type;
  const long long seams = g.nb == 1 ? g.tiles_b : 2LL * g.tiles_b;
  const long long ctas = (kComm ? g.senders : 0) + g.interior + seams;
  if (ctas > INT_MAX) return cudaErrorInvalidConfiguration;
  const size_t smem = kstep_smem_bytes<T, 0>(g.B, g.steps);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  auto* kernel = fused_rdma_kernel<T, kComm>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<static_cast<unsigned>(ctas),
           dim3(KTile<0>::BX, KTile<0>::BY), smem, s>>>(
      r, static_cast<T*>(out), g, E::coef(se), E::coef(c1), E::coef(c2),
      phys_lo, phys_hi, phys, static_cast<W*>(stage));
  return cudaGetLastError();
}

template <typename T>
int launch(void* z, void* out, void* left_z, void* right_z, int* pad,
           int* left_pad, int* right_pad, int epoch, long long n0,
           long long n1, int steps, int B, double se, double c1, double c2,
           int phys_lo, int phys_hi, const int* phys, int send_lo,
           int send_hi, void* stage, cudaStream_t s) {
  using W = typename Word<sizeof(T)>::type;
  const int K = steps * kRadius;
  RingView<W> r{static_cast<const W*>(z), static_cast<W*>(left_z),
                static_cast<W*>(right_z), pad, left_pad, right_pad, epoch,
                0, n0, n1, K, send_lo, send_hi};
  FusedGeom g{};
  g.n0 = n0;
  g.n1 = n1;
  g.steps = steps;
  g.B = B;
  g.nb = static_cast<int>(n0 / B);
  g.tiles_b = static_cast<int>((n1 + kTB - 1) / kTB);
  g.interior = g.nb > 2 ? (g.nb - 2) * g.tiles_b : 0;
  const bool comm = send_lo || send_hi;
  long long senders = (2LL * K * n1 + 1023) / 1024;  // 4 elements a thread
  if (senders > kMaxSendCtas) senders = kMaxSendCtas;
  if (senders < 1 || stage) senders = 1;
  g.senders = comm ? static_cast<int>(senders) : 0;
  if (comm)
    return launch_as<T, true>(r, out, g, se, c1, c2, phys_lo, phys_hi, phys,
                              stage, s);
  return launch_as<T, false>(r, out, g, se, c1, c2, phys_lo, phys_hi, phys,
                             nullptr, s);
}

}  // namespace
}  // namespace tpumt

// Plain C entry point (bound with ctypes). Returns a cudaError_t: 0 when
// the launch was accepted. `z` (my input, in peer memory) and `out` are
// contiguous (n0, n1) float32, float64 or bfloat16 arrays that share no
// storage;
// `left_z` / `right_z` are the neighbours' copies of `z`; pads and epoch as
// in ring_halo.cu. B rows per block must divide n0 and hold the seam
// (B >= 2K, K = 2*steps; B <= 256); n0 > 2K. send_lo = send_hi = 0
// (local_only, or a ring with no peer) runs the compute-only instance.
// `stage` is NULL, or 2*K*n1 elements of scratch when n0 < 3K.
extern "C" int tpumt_stencil2d_fused_rdma(
    void* z, void* out, void* left_z, void* right_z, void* pad,
    void* left_pad, void* right_pad, int epoch, int dtype, long long n0,
    long long n1, int steps, int B, double se, double c1, double c2,
    int phys_lo, int phys_hi, const void* phys, int send_lo, int send_hi,
    void* stage, void* stream) {
  using namespace tpumt;
  const long long K = 2LL * steps;
  if (steps < 1 || n1 < 1 || n0 <= 2 * K || B < 2 * K || B > kMaxB ||
      n0 % B != 0 || ((send_lo || send_hi) && epoch < 1))
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
      return launch<float>(z, out, left_z, right_z, p, lp, rp, epoch, n0, n1,
                           steps, B, se, c1, c2, phys_lo, phys_hi, ph,
                           send_lo, send_hi, st, s);
    case kF64:
      return launch<double>(z, out, left_z, right_z, p, lp, rp, epoch, n0, n1,
                            steps, B, se, c1, c2, phys_lo, phys_hi, ph,
                            send_lo, send_hi, st, s);
    case kBF16:
      return launch<__nv_bfloat16>(z, out, left_z, right_z, p, lp, rp, epoch,
                                   n0, n1, steps, B, se, c1, c2, phys_lo,
                                   phys_hi, ph, send_lo, send_hi, st, s);
    default:
      return cudaErrorInvalidValue;
  }
}
