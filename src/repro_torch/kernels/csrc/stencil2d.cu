// Fused stencil + reduce sweep on a persistent halo frame, for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/stencil2d.py::_stencil_kernel
// (and its reduce_epilogue): one sweep of an elemental functor over the
// block-rounded interior of the frame, written into the same layout of a
// second frame (ghost ring untouched: the engine re-asserts it after every
// sweep), with the convergence measure folded over in-domain cells.
//
// A single sweep at pad k is the T = 1 case of window.cuh's kernel (its
// instantiations live in multistep.cu): env fields in the interior layout,
// no boundary re-assertion, the fold only when do_reduce.  What bounds it
// on an H100 and what the design does about it: see window.cuh.
//
// The C entry points take raw device pointers and the caller's stream, and
// return the launch's cudaError_t (the Python wrapper raises on non-zero).
#include <cuda_runtime.h>

#include "window.cuh"

extern "C" {

// One fused sweep over `lanes` stacked frames.  Each frame is
// (mi + 2*pad, ni + 2*pad) row-major, float32 (dtype 0) or bfloat16
// (dtype 1), with row stride ld (even); the lanes follow each other, so
// the stack holds lanes*(mi + 2*pad) rows.  Env fields are (mi, ni)
// row-major, stacked the same way.  The kernel's CTA tile is (tm, tn), tm
// a multiple of 8 and tn of 32, with `ring` (1 or 2) window slots.  live
// (nullable) holds one byte per lane; a 0 lane is copied through.
// partials holds lanes*slots floats, ticket `lanes` zeroed uints
// (re-armed by the kernel), result `lanes` floats, when do_reduce != 0.
int stencil_sweep(int functor, int radius, int dtype, const float* params, int n_params,
                  const void* in, void* out, const void* env0, const void* env1, long long ld,
                  int lanes, int pad, int mi, int ni, int m, int n, int tm, int tn, int ring,
                  int monoid, int measure, int do_reduce, const unsigned char* live,
                  float* partials, int slots, unsigned int* ticket, float* result,
                  void* stream) {
  const window::Args a{in, out, env0, env1, ld, mi + 2 * pad, lanes, pad, pad, 1, mi, ni, m, n,
                       tm, tn, ring, 0, 0, 0, 0, 0, window::B_WRAP, monoid, measure, do_reduce,
                       live, partials, slots, ticket, result, (cudaStream_t)stream};
  const int bad = window::check(a, n_params, radius);
  if (bad) return bad;
  return window::launch_any(functor, radius, dtype, params, n_params, a);
}

const char* stencil_error_string(int code) {
  if (code == fold::kErrUnknownFunctor) return "no kernel instantiation for this functor and radius";
  if (code == fold::kErrBadArgs) return "invalid launch arguments";
  if (code == fold::kErrSharedMemory) return "the window does not fit the block's shared memory";
  if (code == fold::kErrTensorMap) return "no TMA tensor map for these operands";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
