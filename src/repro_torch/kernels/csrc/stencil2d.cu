// Fused stencil + reduce sweep on a persistent halo frame, for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/stencil2d.py::_stencil_kernel
// (and its reduce_epilogue): one sweep of an elemental functor over the
// block-rounded interior of the frame, written into the same layout of a
// second frame (ghost ring untouched: the engine re-asserts it after every
// sweep), with the convergence measure folded over in-domain cells.
//
// What bounds it on an H100: device-memory bytes.  A sweep reads the frame
// and each env field once and writes the frame once (4-20 flops a cell for
// the Jacobi-type functors), far below the card's ~20 flops/byte ridge; the
// AMF functors sort up to 49 values a cell and are bound by operations.
// Design, simple first:
//   * one CTA of 32x8 threads per (bm, bn) output tile; a thread walks the
//     tile's columns in steps of 32 (coalesced rows) and rows in steps of 8;
//   * taps are __ldg loads straight from the frame: the (bm+2k)x(bn+2k)
//     window a CTA touches is reused through L1/L2, no shared-memory staging;
//   * the reduce is deterministic.  The TPU kernel carries one accumulator
//     across its sequential grid; here tiles run in parallel, so each CTA
//     folds its cells in a fixed order, then in a fixed shared-memory tree,
//     and writes one partial.  The last CTA to finish (an integer atomic
//     ticket, no float atomics) folds all partials in a fixed order and
//     writes the result, in the same launch.  Max/min propagate NaN like
//     jnp.maximum/torch.maximum (fmaxf/fminf would drop it); any/all ride as
//     {0,1} indicators folded with max/min.
// The C entry points take raw device pointers and the caller's stream, and
// return the launch's cudaError_t (the Python wrapper raises on non-zero).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "elementals.cuh"

using namespace elementals;

namespace {

// Keep in step with the monoid names and MEASURE_IDS in
// repro_torch/kernels/stencil2d.py and ref.py.
enum MonoidId : int { M_SUM = 0, M_PROD = 1, M_MAX = 2, M_MIN = 3, M_ANY = 4, M_ALL = 5 };
enum MeasureId : int { MEAS_NONE = 0, MEAS_ABS_DELTA = 1 };

constexpr int kThreadsX = 32, kThreadsY = 8, kThreads = kThreadsX * kThreadsY;

// Error codes of our own, outside cudaError_t's range.
constexpr int kErrUnknownFunctor = 10001;
constexpr int kErrBadArgs = 10002;

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

template <class F>
__global__ void __launch_bounds__(kThreads)
stencil_sweep_kernel(const float* __restrict__ in, float* __restrict__ out,
                     const float* __restrict__ env0, const float* __restrict__ env1,
                     long long ld, int pad, int ni, int m, int n, int bm, int bn,
                     F f, int monoid, int measure, int do_reduce,
                     float* __restrict__ partials, unsigned int* __restrict__ ticket,
                     float* __restrict__ result) {
  const int r0 = blockIdx.y * bm, c0 = blockIdx.x * bn;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  float acc = monoid_identity(monoid);
  for (int dr = threadIdx.y; dr < bm; dr += kThreadsY) {
    const int r = r0 + dr;
    for (int dc = threadIdx.x; dc < bn; dc += kThreadsX) {
      const int c = c0 + dc;
      const long long fo = (long long)(r + pad) * ld + (c + pad);
      const long long eo = (long long)r * ni + c;
      const Taps get{in + fo, ld};
      const float e0 = F::N_ENV > 0 ? __ldg(env0 + eo) : 0.0f;
      const float e1 = F::N_ENV > 1 ? __ldg(env1 + eo) : 0.0f;
      const float v = f(get, e0, e1);
      out[fo] = v;
      if (do_reduce && r < m && c < n) {
        float mv = measure == MEAS_ABS_DELTA ? fabsf(v - get(0, 0)) : v;
        if (monoid >= M_ANY) mv = (mv != 0.0f) ? 1.0f : 0.0f;
        acc = monoid_combine(monoid, acc, mv);
      }
    }
  }
  if (!do_reduce) return;

  __shared__ float sh[kThreads];
  __shared__ bool is_last;
  sh[tid] = acc;
  __syncthreads();
#pragma unroll
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) sh[tid] = monoid_combine(monoid, sh[tid], sh[tid + s]);
    __syncthreads();
  }
  const unsigned int nblocks = gridDim.x * gridDim.y;
  if (tid == 0) {
    partials[blockIdx.y * gridDim.x + blockIdx.x] = sh[0];
    __threadfence();  // publish the partial before taking a ticket
    is_last = (atomicAdd(ticket, 1u) == nblocks - 1);
  }
  __syncthreads();
  if (!is_last) return;

  // Last CTA: fold every partial in a fixed order (thread t takes
  // partials t, t+256, ... in turn, then the same tree as above), so the
  // result does not depend on which CTA finished last.
  __threadfence();
  float a2 = monoid_identity(monoid);
  for (unsigned int i = tid; i < nblocks; i += kThreads)
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

struct Launch {
  const float* in;
  float* out;
  const float* env0;
  const float* env1;
  long long ld;
  int pad, ni, m, n, bm, bn, gm, gn;
  int monoid, measure, do_reduce;
  float* partials;
  unsigned int* ticket;
  float* result;
  cudaStream_t stream;
};

template <class F>
int launch(const Params& p, const Launch& a) {
  dim3 grid(a.gn, a.gm), block(kThreadsX, kThreadsY);
  stencil_sweep_kernel<F><<<grid, block, 0, a.stream>>>(
      a.in, a.out, a.env0, a.env1, a.ld, a.pad, a.ni, a.m, a.n, a.bm, a.bn, F(p),
      a.monoid, a.measure, a.do_reduce, a.partials, a.ticket, a.result);
  return (int)cudaGetLastError();
}

int dispatch(int functor, int radius, const Params& p, const Launch& a) {
  switch (functor) {
    case JACOBI: return radius == 1 ? launch<Jacobi>(p, a) : kErrUnknownFunctor;
    case HELMHOLTZ_JACOBI: return radius == 1 ? launch<HelmholtzJacobi>(p, a) : kErrUnknownFunctor;
    case HEAT: return radius == 1 ? launch<Heat>(p, a) : kErrUnknownFunctor;
    case SOBEL: return radius == 1 ? launch<Sobel>(p, a) : kErrUnknownFunctor;
    case GOL: return radius == 1 ? launch<Gol>(p, a) : kErrUnknownFunctor;
    case MEDIAN3: return radius == 1 ? launch<Median3>(p, a) : kErrUnknownFunctor;
    case RESTORE: return radius == 1 ? launch<Restore>(p, a) : kErrUnknownFunctor;
    case AMF_MASK:
      switch (radius) {
        case 1: return launch<AmfMask<1>>(p, a);
        case 2: return launch<AmfMask<2>>(p, a);
        case 3: return launch<AmfMask<3>>(p, a);
        default: return kErrUnknownFunctor;
      }
    case AMF_REPL:
      switch (radius) {
        case 1: return launch<AmfRepl<1>>(p, a);
        case 2: return launch<AmfRepl<2>>(p, a);
        case 3: return launch<AmfRepl<3>>(p, a);
        default: return kErrUnknownFunctor;
      }
    case CONV:
      switch (radius) {
        case 1: return launch<Conv<1>>(p, a);
        case 2: return launch<Conv<2>>(p, a);
        case 3: return launch<Conv<3>>(p, a);
        default: return kErrUnknownFunctor;
      }
    default: return kErrUnknownFunctor;
  }
}

}  // namespace

extern "C" {

// One fused sweep.  Frames are (gm*bm + 2*pad, gn*bn + 2*pad) row-major
// float32 with row stride ld; env fields are (gm*bm, gn*bn) row-major.
// partials holds gm*gn floats and ticket one zeroed uint (reset by the
// kernel itself); result receives the folded scalar when do_reduce != 0.
int stencil_sweep(int functor, int radius, const float* params, int n_params,
                  const float* in, float* out, const float* env0, const float* env1,
                  long long ld, int pad, int gm, int gn, int bm, int bn, int m, int n,
                  int monoid, int measure, int do_reduce, float* partials,
                  unsigned int* ticket, float* result, void* stream) {
  if (n_params < 0 || n_params > kMaxParams || gm <= 0 || gn <= 0 || gm > 65535 ||
      bm <= 0 || bn <= 0 || radius > pad || in == nullptr || out == nullptr ||
      (do_reduce && (partials == nullptr || ticket == nullptr || result == nullptr)))
    return kErrBadArgs;
  Params p = {};
  for (int i = 0; i < n_params; ++i) p.v[i] = params[i];
  Launch a{in, out, env0, env1, ld, pad, gn * bn, m, n, bm, bn, gm, gn,
           monoid, measure, do_reduce, partials, ticket, result, (cudaStream_t)stream};
  return dispatch(functor, radius, p, a);
}

const char* stencil_error_string(int code) {
  if (code == kErrUnknownFunctor) return "no kernel instantiation for this functor and radius";
  if (code == kErrBadArgs) return "invalid launch arguments";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
