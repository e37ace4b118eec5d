// The reduce epilogue shared by the stencil kernels (window.cuh): monoid
// and measure ids, and the deterministic fold of the per-cell measure into
// one scalar per lane.
//
// The TPU kernels carry one accumulator across their sequential grid.  CTAs
// run in parallel, so each persistent CTA folds its cells of a lane in a
// fixed order, then across its warps by shuffles in a fixed butterfly, and
// writes one partial per lane it visited; the lane's last CTA to finish (an
// integer atomic ticket, no float atomics) folds the lane's partials in a
// fixed order and writes the lane's result, in the same launch.  Max/min
// propagate NaN like jnp.maximum/torch.maximum (fmaxf/fminf would drop it);
// any/all ride as {0,1} indicators folded with max/min.
#pragma once

#include <math.h>

namespace fold {

// Keep in step with MONOID_IDS in repro_torch/kernels/stencil2d.py and
// MEASURE_IDS in ref.py.
enum MonoidId : int { M_SUM = 0, M_PROD = 1, M_MAX = 2, M_MIN = 3, M_ANY = 4, M_ALL = 5 };
enum MeasureId : int { MEAS_NONE = 0, MEAS_ABS_DELTA = 1 };

constexpr int kThreads = 256, kWarps = kThreads / 32;  // a 1-D block

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

// Fold over the 32 lanes of a warp in a fixed butterfly: every lane ends
// with the warp's value (a + b == b + a exactly, and the NaN rule is
// symmetric, so all lanes agree).
__device__ __forceinline__ float warp_fold(int monoid, float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v = monoid_combine(monoid, v, __shfl_xor_sync(0xffffffffu, v, s));
  return v;
}

// Fold over the CTA: warps by shuffles, then thread 0 over the kWarps warp
// values in order.  Every thread must call it; thread 0 gets the value.
__device__ __forceinline__ float block_fold(int monoid, float v, float* sh) {
  v = warp_fold(monoid, v);
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  float a = sh[0];
  if (threadIdx.x == 0)
    for (int w = 1; w < kWarps; ++w) a = monoid_combine(monoid, a, sh[w]);
  return a;
}

// Fold each thread's `acc` into the CTA's partial of one lane (slot `slot`
// of the lane's `nslots` partials); the lane's last CTA folds all its
// partials into `*result` and re-arms `*ticket`.  Every thread of the
// kThreads block must call it.
__device__ __forceinline__ void fold_cta(float acc, int monoid, float* __restrict__ partials,
                                         unsigned int* __restrict__ ticket,
                                         float* __restrict__ result, unsigned int slot,
                                         unsigned int nslots) {
  __shared__ float sh[kWarps];
  __shared__ bool is_last;
  const int tid = threadIdx.x;
  const float a = block_fold(monoid, acc, sh);
  if (tid == 0) {
    partials[slot] = a;
    __threadfence();  // publish the partial before taking a ticket
    is_last = (atomicAdd(ticket, 1u) == nslots - 1);
  }
  __syncthreads();
  if (is_last) {
    // Last CTA: fold every partial in a fixed order (thread t takes
    // partials t, t+kThreads, ... in turn, then the same fold as above), so
    // the result does not depend on which CTA finished last.
    __threadfence();
    float a2 = monoid_identity(monoid);
    for (unsigned int i = tid; i < nslots; i += kThreads)
      a2 = monoid_combine(monoid, a2, __ldcg(partials + i));
    a2 = block_fold(monoid, a2, sh);
    if (tid == 0) {
      result[0] = a2;
      *ticket = 0u;  // ready for the next launch on this scratch
    }
  }
  __syncthreads();  // sh and is_last are free for the next call
}

}  // namespace fold
