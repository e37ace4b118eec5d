// Temporal blocking: T fused stencil sweeps per device-memory round trip,
// with the convergence reduce on the last two iterates, for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/multistep.py::_ms_kernel
// (with _fix_boundary and _ShrinkTaps): each (bm, bn) output tile loads its
// (bm+2kT, bn+2kT) window of the frame once, applies T sweeps on chip with
// the valid region shrinking by k a side per sweep, re-asserts the boundary
// model after every sweep, and writes the final bm x bn into the output
// frame (ghost ring untouched: the engine refreshes it).
//
// What bounds it on an H100: device-memory bytes per sweep fall by about T
// against the single-step kernel (one window read, (1+2kT/bm)(1+2kT/bn)
// times the tile, and one tile write per T sweeps), at the cost of
// recomputing the window's halo cells (the same factor in operations).
// Design, simple first:
//   * one CTA of 32x8 threads per output tile and lane (blockIdx.z); the
//     window of the frame and of each env field (halo layout: full frames)
//     is staged in dynamic shared memory as float, and the T sweeps
//     ping-pong between two float buffers in window coordinates;
//   * sweep s computes window cells [k(s+1), w - k(s+1)) of each axis;
//     each value is rounded to the storage type as it is stored (float32
//     or bfloat16), so a bfloat16 iterate rounds as T single sweeps would;
//   * the boundary model is re-asserted after every sweep in global frame
//     coordinates against run-time domain bounds [row_lo, row_hi) x
//     [col_lo, col_hi) (a sharded caller may pass +-2^30 sentinels on
//     interior sides): zero/nan fill the cells outside; reflect mirrors
//     rows first (ghost row g < row_lo takes row 2*row_lo - g, g >= row_hi
//     takes 2*(row_hi-1) - g), then columns over the row-fixed values; wrap
//     does nothing (a wrapped ghost ring evolves like its pre-image).  Block
//     round-up cells lie outside the domain and are re-asserted too;
//   * a lane whose live flag is 0 copies its tiles through and skips the
//     fold;
//   * the reduce folds measure(last, second last) over the tile's domain
//     cells with the shared deterministic epilogue (fold.cuh).
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

// Keep in step with BOUNDARY_IDS in repro_torch/kernels/multistep.py.
enum BoundaryId : int { B_ZERO = 0, B_NAN = 1, B_REFLECT = 2, B_WRAP = 3 };

struct Bounds {
  int row_lo, row_hi, col_lo, col_hi;
};

// Mirror source of global coordinate g along one axis with domain [lo, hi),
// or -1 when g is inside (or the source lies outside [lo, hi)).
__device__ __forceinline__ long long mirror(long long g, int lo, int hi) {
  long long s;
  if (g < lo)
    s = 2LL * lo - g;
  else if (g >= hi)
    s = 2LL * (hi - 1) - g;
  else
    return -1;
  return (s >= lo && s < hi) ? s : -1;
}

template <class T, class F>
__global__ void __launch_bounds__(kThreads)
multistep_kernel(const T* __restrict__ in, T* __restrict__ out, const T* __restrict__ env0,
                 const T* __restrict__ env1, long long ld, int frame_rows, int k, int nsweeps,
                 int m, int n, int bm, int bn, Bounds b, int boundary, F f, int monoid,
                 int measure, const unsigned char* __restrict__ live,
                 float* __restrict__ partials, unsigned int* __restrict__ ticket,
                 float* __restrict__ result) {
  extern __shared__ float smem[];
  const int pad = k * nsweeps;
  const int wm = bm + 2 * pad, wn = bn + 2 * pad;
  const int lane = blockIdx.z;
  const int grow0 = blockIdx.y * bm, gcol0 = blockIdx.x * bn;  // window origin, frame coords
  // a lane stack is one tall frame: lane l's row r is row l*frame_rows + r
  const long long wbase = (long long)(lane * frame_rows + grow0) * ld + gcol0;
  const unsigned int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const unsigned int ntiles = gridDim.x * gridDim.y;
  const int tx = threadIdx.x, ty = threadIdx.y;

  if (live != nullptr && !live[lane]) {
    for (int r = pad + ty; r < pad + bm; r += kThreadsY)
      for (int c = pad + tx; c < pad + bn; c += kThreadsX) {
        const long long o = wbase + (long long)r * ld + c;
        out[o] = in[o];
      }
    if (tile == 0 && tx == 0 && ty == 0) result[lane] = monoid_identity(monoid);
    return;
  }

  const int wsz = wm * wn;
  float* cur = smem;
  float* nxt = smem + wsz;
  float* e0s = smem + 2 * wsz;
  float* e1s = e0s + (F::N_ENV > 0 ? wsz : 0);
  for (int r = ty; r < wm; r += kThreadsY)
    for (int c = tx; c < wn; c += kThreadsX) {
      const long long g = wbase + (long long)r * ld + c;
      cur[r * wn + c] = load_f(in + g);
      if (F::N_ENV > 0) e0s[r * wn + c] = load_f(env0 + g);
      if (F::N_ENV > 1) e1s[r * wn + c] = load_f(env1 + g);
    }
  __syncthreads();

  // Does this window reach outside the domain?  (Uniform over the block.)
  const bool edge = boundary != B_WRAP &&
                    (grow0 < b.row_lo || grow0 + wm > b.row_hi || gcol0 < b.col_lo ||
                     gcol0 + wn > b.col_hi);
  const float fill = boundary == B_NAN ? NAN : 0.0f;
  for (int s = 0; s < nsweeps; ++s) {
    const int lo = k * (s + 1), rhi = wm - lo, chi = wn - lo;
    for (int r = lo + ty; r < rhi; r += kThreadsY)
      for (int c = lo + tx; c < chi; c += kThreadsX) {
        const int o = r * wn + c;
        const SmemTaps get{cur + o, wn};
        float v = round_as<T>(f(get, F::N_ENV > 0 ? e0s[o] : 0.0f, F::N_ENV > 1 ? e1s[o] : 0.0f));
        if (edge && boundary != B_REFLECT) {
          const int gr = grow0 + r, gc = gcol0 + c;
          if (gr < b.row_lo || gr >= b.row_hi || gc < b.col_lo || gc >= b.col_hi) v = fill;
        }
        nxt[o] = v;
      }
    __syncthreads();
    if (edge && boundary == B_REFLECT) {
      // rows first: a ghost row reads a domain row, which this pass leaves
      for (int r = lo + ty; r < rhi; r += kThreadsY) {
        const long long sr = mirror(grow0 + r, b.row_lo, b.row_hi);
        const int lr = (int)(sr - grow0);
        if (sr < 0 || lr < lo || lr >= rhi) continue;
        for (int c = lo + tx; c < chi; c += kThreadsX) nxt[r * wn + c] = nxt[lr * wn + c];
      }
      __syncthreads();
      // then columns, over the row-fixed values
      for (int r = lo + ty; r < rhi; r += kThreadsY)
        for (int c = lo + tx; c < chi; c += kThreadsX) {
          const long long sc = mirror(gcol0 + c, b.col_lo, b.col_hi);
          const int lc = (int)(sc - gcol0);
          if (sc < 0 || lc < lo || lc >= chi) continue;
          nxt[r * wn + c] = nxt[r * wn + lc];
        }
      __syncthreads();
    }
    float* t = cur;
    cur = nxt;
    nxt = t;
  }

  // cur: the last iterate on [pad, pad+bm) x [pad, pad+bn); nxt: the one
  // before it (valid on a larger region).
  float acc = monoid_identity(monoid);
  for (int r = ty; r < bm; r += kThreadsY)
    for (int c = tx; c < bn; c += kThreadsX) {
      const int o = (pad + r) * wn + pad + c;
      const float v = cur[o];
      out[wbase + (long long)(pad + r) * ld + pad + c] = store_as<T>(v);
      if (grow0 + r < m && gcol0 + c < n)
        acc = monoid_combine(monoid, acc, cell_measure(monoid, measure, v, nxt[o]));
    }
  fold_tiles(acc, monoid, partials + (long long)lane * ntiles, ticket + lane, result + lane, tile,
             ntiles);
}

struct Launch {
  const void* in;
  void* out;
  const void* env0;
  const void* env1;
  long long ld;
  int frame_rows, lanes, k, nsweeps, gm, gn, bm, bn, m, n;
  Bounds b;
  int boundary, monoid, measure;
  const unsigned char* live;
  float* partials;
  unsigned int* ticket;
  float* result;
  cudaStream_t stream;
};

template <class T, class F>
int launch(const Params& p, const Launch& a) {
  const int pad = a.k * a.nsweeps;
  const size_t bytes =
      (size_t)(2 + F::N_ENV) * (a.bm + 2 * pad) * (a.bn + 2 * pad) * sizeof(float);
  auto kernel = multistep_kernel<T, F>;
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return (int)e;
  if (bytes + attr.sharedSizeBytes > (size_t)optin) return kErrSharedMemory;
  if (bytes > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(a.gn, a.gm, a.lanes), block(kThreadsX, kThreadsY);
  kernel<<<grid, block, bytes, a.stream>>>(
      static_cast<const T*>(a.in), static_cast<T*>(a.out), static_cast<const T*>(a.env0),
      static_cast<const T*>(a.env1), a.ld, a.frame_rows, a.k, a.nsweeps, a.m, a.n, a.bm, a.bn,
      a.b, a.boundary, F(p), a.monoid, a.measure, a.live, a.partials, a.ticket, a.result);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// T (= nsweeps) fused sweeps over `lanes` stacked frames of pad k*T.  Each
// frame is (gm*bm + 2kT, gn*bn + 2kT) row-major, float32 (dtype 0) or
// bfloat16 (dtype 1), with row stride ld; the lanes follow each other.
// Env fields are full frames of the same layout.  The domain occupies frame rows
// [row_lo, row_hi) x cols [col_lo, col_hi) for the boundary model, and
// [kT, kT+m) x [kT, kT+n) for the reduce.  live (nullable) holds one byte
// per lane; a 0 lane is copied through.  partials holds lanes*gm*gn floats,
// ticket `lanes` zeroed uints (re-armed by the kernel), result `lanes`
// floats.
int multistep_sweep(int functor, int radius, int dtype, const float* params, int n_params,
                    const void* in, void* out, const void* env0, const void* env1, long long ld,
                    int lanes, int k, int nsweeps, int gm, int gn, int bm, int bn, int m, int n,
                    int row_lo, int row_hi, int col_lo, int col_hi,
                    int boundary, int monoid, int measure, const unsigned char* live,
                    float* partials, unsigned int* ticket, float* result, void* stream) {
  if (n_params < 0 || n_params > kMaxParams || gm <= 0 || gn <= 0 || gm > 65535 ||
      lanes <= 0 || lanes > 65535 || bm <= 0 || bn <= 0 || k <= 0 || nsweeps <= 0 ||
      radius > k || boundary < B_ZERO || boundary > B_WRAP ||
      (long long)lanes * (gm * bm + 2 * k * nsweeps) > INT_MAX || in == nullptr ||
      out == nullptr || partials == nullptr || ticket == nullptr || result == nullptr)
    return kErrBadArgs;
  Params p = {};
  for (int i = 0; i < n_params; ++i) p.v[i] = params[i];
  const Launch a{in, out, env0, env1, ld, gm * bm + 2 * k * nsweeps, lanes, k, nsweeps, gm, gn,
                 bm, bn, m, n,
                 Bounds{row_lo, row_hi, col_lo, col_hi}, boundary, monoid, measure, live,
                 partials, ticket, result, (cudaStream_t)stream};
  return dispatch::by_dtype_and_functor(dtype, functor, radius, [&](auto t, auto fz) {
    return launch<typename decltype(t)::type, typename decltype(fz)::type>(p, a);
  });
}

}  // extern "C"
