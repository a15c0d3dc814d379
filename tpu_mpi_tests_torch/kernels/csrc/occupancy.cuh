// The grid of a launch sized by the card: the occupancy API's resident
// count for a kernel, clipped to the work. Shared by the peer-store
// kernels (ring_common.cuh), the halo staging copies (pack.cu) and the
// register walks of heat2d.cu and stencil_deriv.cu.
#pragma once

#include <cuda_runtime.h>

namespace tpumt {

// CTAs of `kernel` at `threads` threads that the card keeps resident at
// once, when the kernel runs alone on it: the occupancy API's CTAs per SM
// × SMs. Asked once; `*cache` (0 before) keeps the answer.
inline cudaError_t coll_resident_ctas(const void* kernel, int threads,
                                      int* cache) {
  if (*cache > 0) return cudaSuccess;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                       threads, 0);
  if (rc != cudaSuccess) return rc;
  if (per_sm < 1 || sms < 1) return cudaErrorInvalidConfiguration;
  *cache = per_sm * sms;
  return cudaSuccess;
}

// The grid of a collective launch: `resident` CTAs (every CTA of the
// launch resident at once: they wait for each other's signals), clipped
// to the work (`items` at `per_cta` a CTA) and to `max_ctas` (> 0: several
// instances resident on one card together).
inline int coll_grid(int resident, long long items, long long per_cta,
                     int max_ctas) {
  long long ctas = (items + per_cta - 1) / per_cta;
  if (ctas > resident) ctas = resident;
  if (max_ctas > 0 && ctas > max_ctas) ctas = max_ctas;
  if (ctas < 1) ctas = 1;
  return static_cast<int>(ctas);
}

// The runs a walk of `rows` rows splits into so that `cols` CTAs a run
// fill at most one wave of `resident` CTAs, none shorter than
// `floor_rows`, balanced (every run ceil(rows / runs) rows but the last):
// the heat update's and the derivative's regs routes.
inline long long wave_runs(int resident, long long cols, long long rows,
                           int floor_rows) {
  long long runs = cols > 0 ? resident / cols : 1;
  const long long most = (rows + floor_rows - 1) / floor_rows;
  if (runs > most) runs = most;
  if (runs < 1) runs = 1;
  const long long ta = (rows + runs - 1) / runs;
  return (rows + ta - 1) / ta;
}

}  // namespace tpumt
