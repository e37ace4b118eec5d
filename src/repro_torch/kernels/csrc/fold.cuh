// The reduce epilogue shared by the stencil kernels (stencil2d.cu,
// multistep.cu): monoid and measure ids, and the deterministic fold of the
// per-cell measure into one scalar per lane.
//
// The TPU kernels carry one accumulator across their sequential grid.  CTAs
// run in parallel, so each CTA folds its cells in a fixed order, then in a
// fixed shared-memory tree, and writes one partial; the last CTA of the lane
// to finish (an integer atomic ticket, no float atomics) folds the lane's
// partials in a fixed order and writes the lane's result, in the same
// launch.  Max/min propagate NaN like jnp.maximum/torch.maximum (fmaxf/fminf
// would drop it); any/all ride as {0,1} indicators folded with max/min.
#pragma once

#include <math.h>

namespace fold {

// Keep in step with MONOID_IDS in repro_torch/kernels/stencil2d.py and
// MEASURE_IDS in ref.py.
enum MonoidId : int { M_SUM = 0, M_PROD = 1, M_MAX = 2, M_MIN = 3, M_ANY = 4, M_ALL = 5 };
enum MeasureId : int { MEAS_NONE = 0, MEAS_ABS_DELTA = 1 };

constexpr int kThreadsX = 32, kThreadsY = 8, kThreads = kThreadsX * kThreadsY;

// Error codes of our own, outside cudaError_t's range.
constexpr int kErrUnknownFunctor = 10001;
constexpr int kErrBadArgs = 10002;
constexpr int kErrSharedMemory = 10003;
constexpr int kErrTensorMap = 10004;

__device__ __forceinline__ float monoid_identity(int monoid) {
  switch (monoid) {
    case M_SUM: return 0.0f;
    case M_PROD: return 1.0f;
    case M_MAX: return -INFINITY;
    case M_MIN: return INFINITY;
    case M_ANY: return 0.0f;
    default: return 1.0f;  // M_ALL
  }
}

__device__ __forceinline__ float monoid_combine(int monoid, float a, float b) {
  switch (monoid) {
    case M_SUM: return a + b;
    case M_PROD: return a * b;
    case M_MAX:
    case M_ANY: return (a > b || isnan(a)) ? a : b;
    default: return (a < b || isnan(a)) ? a : b;  // M_MIN, M_ALL
  }
}

// What the reduce folds for one domain cell: the measure of the new value
// against the old centre (or the new value), as a {0,1} indicator for the
// bool monoids.
__device__ __forceinline__ float cell_measure(int monoid, int measure, float v, float old) {
  float mv = measure == MEAS_ABS_DELTA ? fabsf(v - old) : v;
  if (monoid >= M_ANY) mv = (mv != 0.0f) ? 1.0f : 0.0f;
  return mv;
}

// Fold each thread's `acc` into the CTA's partial (slot `tile` of the
// lane's `ntiles` partials); the lane's last CTA folds all its partials into
// `*result` and re-arms `*ticket`.  Every thread of the (kThreadsX,
// kThreadsY) block must call it.
__device__ __forceinline__ void fold_tiles(float acc, int monoid, float* __restrict__ partials,
                                           unsigned int* __restrict__ ticket,
                                           float* __restrict__ result, unsigned int tile,
                                           unsigned int ntiles) {
  __shared__ float sh[kThreads];
  __shared__ bool is_last;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  sh[tid] = acc;
  __syncthreads();
#pragma unroll
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) sh[tid] = monoid_combine(monoid, sh[tid], sh[tid + s]);
    __syncthreads();
  }
  if (tid == 0) {
    partials[tile] = sh[0];
    __threadfence();  // publish the partial before taking a ticket
    is_last = (atomicAdd(ticket, 1u) == ntiles - 1);
  }
  __syncthreads();
  if (!is_last) return;

  // Last CTA: fold every partial in a fixed order (thread t takes
  // partials t, t+256, ... in turn, then the same tree as above), so the
  // result does not depend on which CTA finished last.
  __threadfence();
  float a2 = monoid_identity(monoid);
  for (unsigned int i = tid; i < ntiles; i += kThreads)
    a2 = monoid_combine(monoid, a2, __ldcg(partials + i));
  sh[tid] = a2;
  __syncthreads();
#pragma unroll
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) sh[tid] = monoid_combine(monoid, sh[tid], sh[tid + s]);
    __syncthreads();
  }
  if (tid == 0) {
    result[0] = sh[0];
    *ticket = 0u;  // ready for the next launch on this scratch
  }
}

}  // namespace fold
