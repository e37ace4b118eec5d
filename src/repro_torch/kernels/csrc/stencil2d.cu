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
//   * one CTA of 32x8 threads per (bm, bn) output tile and lane
//     (blockIdx.z: the lane farm's stack of frames, one launch for all
//     lanes); a thread walks the tile's columns in steps of 32 (coalesced
//     rows) and rows in steps of 8;
//   * taps are __ldg loads straight from the frame: the (bm+2k)x(bn+2k)
//     window a CTA touches is reused through L1/L2, no shared-memory staging;
//   * float32 or bfloat16 frames (env fields share the frame's type): taps
//     are widened to float, the functor computes in float, the store rounds
//     once; the reduce accumulates in float32;
//   * a lane whose live flag is 0 (a finished lane of the farm) copies its
//     tiles through and skips the fold, so it keeps its value while the
//     others sweep;
//   * the reduce is deterministic: per-CTA partials folded by the lane's
//     last CTA in the same launch (fold.cuh, shared with multistep.cu).
// The C entry points take raw device pointers and the caller's stream, and
// return the launch's cudaError_t (the Python wrapper raises on non-zero).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "dispatch.cuh"
#include "elementals.cuh"
#include "fold.cuh"

using namespace elementals;
using namespace fold;

namespace {

template <class T, class F>
__global__ void __launch_bounds__(kThreads)
stencil_sweep_kernel(const T* __restrict__ in, T* __restrict__ out,
                     const T* __restrict__ env0, const T* __restrict__ env1,
                     long long ld, int frame_rows, int pad, int mi, int ni, int m, int n,
                     int bm, int bn, F f, int monoid, int measure,
                     int do_reduce, const unsigned char* __restrict__ live,
                     float* __restrict__ partials, unsigned int* __restrict__ ticket,
                     float* __restrict__ result) {
  // A lane stack is one tall frame: lane l's row r is row l*frame_rows + r
  // (and l*mi + r of the env fields).  Offsetting the row index, not the
  // base pointers, keeps the single-frame register count (61 against 80
  // with 64-bit pointer offsets: four CTAs an SM instead of three).
  const int lane = blockIdx.z;
  const int frow = lane * frame_rows + pad, erow = lane * mi;
  const int r0 = blockIdx.y * bm, c0 = blockIdx.x * bn;
  const unsigned int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const unsigned int ntiles = gridDim.x * gridDim.y;
  if (live != nullptr && !live[lane]) {
    // a finished lane keeps its value: copy the tile through, no fold
    for (int dr = threadIdx.y; dr < bm; dr += kThreadsY)
      for (int dc = threadIdx.x; dc < bn; dc += kThreadsX) {
        const long long fo = (long long)(frow + r0 + dr) * ld + (c0 + dc + pad);
        out[fo] = in[fo];
      }
    if (do_reduce && tile == 0 && threadIdx.x == 0 && threadIdx.y == 0)
      result[lane] = monoid_identity(monoid);
    return;
  }
  float acc = monoid_identity(monoid);
  for (int dr = threadIdx.y; dr < bm; dr += kThreadsY) {
    const int r = r0 + dr;
    for (int dc = threadIdx.x; dc < bn; dc += kThreadsX) {
      const int c = c0 + dc;
      const long long fo = (long long)(frow + r) * ld + (c + pad);
      const long long eo = (long long)(erow + r) * ni + c;
      const Taps<T> get{in + fo, ld};
      const float e0 = F::N_ENV > 0 ? load_f(env0 + eo) : 0.0f;
      const float e1 = F::N_ENV > 1 ? load_f(env1 + eo) : 0.0f;
      const float v = f(get, e0, e1);
      out[fo] = store_as<T>(v);
      if (do_reduce && r < m && c < n)
        acc = monoid_combine(monoid, acc, cell_measure(monoid, measure, round_as<T>(v), get(0, 0)));
    }
  }
  if (!do_reduce) return;
  fold_tiles(acc, monoid, partials + (long long)lane * ntiles, ticket + lane, result + lane,
             tile, ntiles);
}

struct Launch {
  const void* in;
  void* out;
  const void* env0;
  const void* env1;
  long long ld;
  int frame_rows, pad, mi, ni, m, n, bm, bn, gm, gn, lanes;
  int monoid, measure, do_reduce;
  const unsigned char* live;
  float* partials;
  unsigned int* ticket;
  float* result;
  cudaStream_t stream;
};

template <class T, class F>
int launch(const Params& p, const Launch& a) {
  dim3 grid(a.gn, a.gm, a.lanes), block(kThreadsX, kThreadsY);
  stencil_sweep_kernel<T, F><<<grid, block, 0, a.stream>>>(
      static_cast<const T*>(a.in), static_cast<T*>(a.out), static_cast<const T*>(a.env0),
      static_cast<const T*>(a.env1), a.ld, a.frame_rows, a.pad, a.mi, a.ni, a.m, a.n, a.bm,
      a.bn, F(p), a.monoid, a.measure, a.do_reduce, a.live, a.partials, a.ticket, a.result);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One fused sweep over `lanes` stacked frames.  Each frame is
// (gm*bm + 2*pad, gn*bn + 2*pad) row-major, float32 (dtype 0) or bfloat16
// (dtype 1), with row stride ld; the lanes follow each other, so the
// stack holds lanes*(gm*bm + 2*pad) rows.  Env fields are (gm*bm, gn*bn)
// row-major, stacked the same way.  live (nullable) holds one byte per
// lane; a 0 lane is copied through.  partials holds lanes*gm*gn floats,
// ticket `lanes` zeroed uints (re-armed by the kernel), result `lanes`
// floats, when do_reduce != 0.
int stencil_sweep(int functor, int radius, int dtype, const float* params, int n_params,
                  const void* in, void* out, const void* env0, const void* env1, long long ld,
                  int lanes, int pad, int gm, int gn, int bm, int bn, int m, int n, int monoid,
                  int measure, int do_reduce, const unsigned char* live, float* partials,
                  unsigned int* ticket, float* result, void* stream) {
  if (n_params < 0 || n_params > kMaxParams || gm <= 0 || gn <= 0 || gm > 65535 ||
      lanes <= 0 || lanes > 65535 || bm <= 0 || bn <= 0 || radius > pad ||
      (long long)lanes * (gm * bm + 2 * pad) > INT_MAX || in == nullptr || out == nullptr ||
      (do_reduce && (partials == nullptr || ticket == nullptr || result == nullptr)))
    return kErrBadArgs;
  Params p = {};
  for (int i = 0; i < n_params; ++i) p.v[i] = params[i];
  const Launch a{in, out, env0, env1, ld, gm * bm + 2 * pad, pad, gm * bm, gn * bn, m, n,
                 bm, bn, gm, gn, lanes, monoid, measure, do_reduce, live, partials, ticket,
                 result, (cudaStream_t)stream};
  return dispatch::by_dtype_and_functor(dtype, functor, radius, [&](auto t, auto fz) {
    return launch<typename decltype(t)::type, typename decltype(fz)::type>(p, a);
  });
}

const char* stencil_error_string(int code) {
  if (code == kErrUnknownFunctor) return "no kernel instantiation for this functor and radius";
  if (code == kErrBadArgs) return "invalid launch arguments";
  if (code == kErrSharedMemory) return "the window does not fit the block's shared memory";
  if (code == kErrTensorMap) return "no TMA tensor map for these operands";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
