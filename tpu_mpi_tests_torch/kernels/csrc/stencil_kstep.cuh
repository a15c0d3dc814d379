// The k-step tile update shared by the iterate kernel (stencil_iterate.cu)
// and the fused ring kernel (fused_rdma.cu) — one implementation, so a
// fused launch and the chained ring_halo -> stencil2d_iterate pair agree
// bit for bit by construction (as _kstep_advance gives it in the JAX
// package, pallas_kernels.py:915).
//
// What one tile computes: `steps` timesteps of
//     z[a] += se * (C1*(z[a+1]-z[a-1]) + C2*(z[a+2]-z[a-2]))
// along the stencil axis DIM for the TA output indices a0..a0+TA and the
// TB indices b0..b0+TB of the other axis. At step s an index a is updated
// iff a ∈ [dlo_s, dhi_s), dlo_s = K if plo else s*R and
// dhi_s = N - (K if phi else s*R), K = steps*R, R = N_BND = 2: physical
// sides keep their K-deep band fixed, exchange-fed sides shrink by R per
// step. Indices never updated keep their input value.
//
// The tile is loaded with a K-deep apron on each side (clipped at the
// array edge) into shared memory and stepped there, ping-ponging between
// two shared buffers: at step s it updates [max(win_lo + s*R, dlo_s),
// min(win_hi - s*R, dhi_s)), the part of its window whose inputs are still
// exact. Then it writes its own TA indices to `out` (never `z`: CTAs that
// split the stencil axis would read indices a neighbour had overwritten).
#pragma once

#include "stencil_common.cuh"

namespace tpumt {

constexpr int kRadius = 2;  // N_BND

// Thread layout per stencil axis: the contiguous axis (columns) maps to
// threadIdx.x so global loads and stores coalesce. TB is the tile's extent
// along the other axis.
template <int DIM>
struct KTile;
template <>
struct KTile<0> {  // stencil along rows
  static constexpr int TB = 64;  // columns per tile
  static constexpr int BX = 64;
  static constexpr int BY = 4;
};
template <>
struct KTile<1> {  // stencil along columns
  static constexpr int TB = 8;  // rows per tile
  static constexpr int BX = 128;
  static constexpr int BY = 2;
};

// Shared memory one tile of TA indices takes: two (TA + 2K) x TB buffers.
template <typename T, int DIM>
size_t kstep_smem_bytes(int TA, int steps) {
  return 2 * static_cast<size_t>(TA + 2 * steps * kRadius) * KTile<DIM>::TB *
         sizeof(typename Elt<T>::C);
}

// One tile: output indices [a0, a0 + TA) along DIM and [b0, b0 + TB) along
// the other axis of the (n0, n1) array z, written to out. `smem` holds
// kstep_smem_bytes<T, DIM>(TA, steps) bytes. `z` carries no __restrict__:
// in the fused ring kernel its ghost bands are written by peers while the
// launch runs, so its loads must not take the read-only path.
template <typename T, int DIM>
__device__ __forceinline__ void kstep_tile(
    const T* z, T* __restrict__ out, long long n0, long long n1, int steps,
    typename Elt<T>::C se, typename Elt<T>::C c1, typename Elt<T>::C c2,
    int plo, int phi, long long a0, int TA, long long b0,
    typename Elt<T>::C* smem) {
  using E = Elt<T>;
  using C = typename E::C;
  using G = KTile<DIM>;
  const int K = steps * kRadius;
  const int WA = TA + 2 * K;  // window extent, stencil axis
  // int(...) keeps the constexpr members values, never references
  const int INNER = DIM == 0 ? int(G::TB) : WA;  // contiguous extent
  const int OUTER = DIM == 0 ? WA : int(G::TB);
  C* buf0 = smem;
  C* buf1 = buf0 + static_cast<size_t>(WA) * G::TB;

  const long long N = DIM == 0 ? n0 : n1;  // extent along the stencil axis
  const long long M = DIM == 0 ? n1 : n0;  // extent along the other axis
  const long long origin = a0 - K;  // absolute index of window position 0
  const long long wa0 = origin > 0 ? origin : 0;
  const long long wa1 = a0 + TA + K < N ? a0 + TA + K : N;
  const int tx = threadIdx.x, ty = threadIdx.y;

  for (int pi = ty; pi < OUTER; pi += G::BY) {
    for (int pj = tx; pj < INNER; pj += G::BX) {
      const int pa = DIM == 0 ? pi : pj;
      const int pb = DIM == 0 ? pj : pi;
      const long long a = origin + pa, b = b0 + pb;
      C v = C(0);
      if (a >= wa0 && a < wa1 && b < M) {
        const long long g = DIM == 0 ? a * n1 + b : b * n1 + a;
        v = E::load(z + g);
      }
      buf0[pi * INNER + pj] = v;
    }
  }
  __syncthreads();

  const int st = DIM == 0 ? int(G::TB) : 1;  // smem stride, stencil axis
  C* src = buf0;
  C* dst = buf1;
  for (int s = 1; s <= steps; ++s) {
    const long long shrink = static_cast<long long>(s) * kRadius;
    const long long dlo = plo ? K : shrink;
    const long long dhi = N - (phi ? K : shrink);
    long long lo = wa0 + shrink;
    long long hi = wa1 - shrink;
    lo = lo > dlo ? lo : dlo;
    hi = hi < dhi ? hi : dhi;
    for (int pi = ty; pi < OUTER; pi += G::BY) {
      for (int pj = tx; pj < INNER; pj += G::BX) {
        const int pa = DIM == 0 ? pi : pj;
        const long long a = origin + pa;
        const int e = pi * INNER + pj;
        C v = src[e];
        if (a >= lo && a < hi) {
          // _step5's order: z0 + se*(C1*(z+1 - z-1) + C2*(z+2 - z-2))
          const C* p = src + e;
          const C d1 = E::sub(p[st], p[-st]);
          const C d2 = E::sub(p[2 * st], p[-2 * st]);
          const C acc = E::add(E::mul(c1, d1), E::mul(c2, d2));
          v = E::add(v, E::mul(se, acc));
        }
        dst[e] = v;
      }
    }
    __syncthreads();
    C* t = src;
    src = dst;
    dst = t;
  }

  for (int pi = ty; pi < OUTER; pi += G::BY) {
    for (int pj = tx; pj < INNER; pj += G::BX) {
      const int pa = DIM == 0 ? pi : pj;
      const int pb = DIM == 0 ? pj : pi;
      if (pa < K || pa >= K + TA) continue;
      const long long a = origin + pa, b = b0 + pb;
      if (a < N && b < M) {
        const long long g = DIM == 0 ? a * n1 + b : b * n1 + a;
        out[g] = E::store(src[pi * INNER + pj]);
      }
    }
  }
}

}  // namespace tpumt
