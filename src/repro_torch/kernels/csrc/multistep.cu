// Temporal blocking: T fused stencil sweeps per device-memory round trip,
// with the convergence reduce on the last two iterates, for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/multistep.py::_ms_kernel
// (with _fix_boundary and _ShrinkTaps).  The kernel is window.cuh's, which
// stencil2d.cu's single sweep shares as its T = 1 case; this unit holds its
// float32 instantiations (one per functor and radius, compiled once for
// both entry points; window_bf16.cu holds the bfloat16 ones), the dtype
// dispatch and the multistep C entry point.  What bounds it on an H100 and
// what the design does about it: see window.cuh.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dispatch.cuh"
#include "window.cuh"

namespace {
window::Info last_launch = {};
}  // namespace

int window::launch_f32(int functor, int radius, const Params& p, const Args& a, Info* info) {
  auto go = [&](auto t, auto fz) {
    using F = typename decltype(fz)::type;
    return launch<typename decltype(t)::type, F>(F(p), a, info);
  };
  return dispatch::by_functor<float>(functor, radius, go);
}

// dtype: 0 float32, 1 bfloat16 (DTYPE_IDS in repro_torch/kernels/stencil2d.py)
int window::launch_any(int functor, int radius, int dtype, const float* params, int n_params,
                       const Args& a) {
  Params p = {};
  for (int i = 0; i < n_params; ++i) p.v[i] = params[i];
  if (dtype == 0) return launch_f32(functor, radius, p, a, &last_launch);
  if (dtype == 1) return launch_bf16(functor, radius, p, a, &last_launch);
  return kErrBadArgs;
}

extern "C" {

// T (= nsweeps) fused sweeps over `lanes` stacked frames of pad k*T.  Each
// frame is (mi + 2kT, ni + 2kT) row-major, float32 (dtype 0) or bfloat16
// (dtype 1), with row stride ld (even); the lanes follow each other.  Env
// fields are full frames of the same layout.  The kernel's CTA tile is
// (tm, tn), tm a multiple of 8 and tn of 32, with `ring` (1 or 2) window
// slots.  The domain occupies frame rows [row_lo, row_hi) x cols [col_lo,
// col_hi) for the boundary model, and [kT, kT+m) x [kT, kT+n) for the
// reduce.  live (nullable) holds one byte per lane; a 0 lane is copied
// through.  partials holds lanes*slots floats, ticket `lanes` zeroed uints
// (re-armed by the kernel), result `lanes` floats.
int multistep_sweep(int functor, int radius, int dtype, const float* params, int n_params,
                    const void* in, void* out, const void* env0, const void* env1, long long ld,
                    int lanes, int k, int nsweeps, int mi, int ni, int m, int n, int tm, int tn,
                    int ring, int row_lo, int row_hi, int col_lo, int col_hi, int boundary,
                    int monoid, int measure, const unsigned char* live, float* partials,
                    int slots, unsigned int* ticket, float* result, void* stream) {
  const window::Args a{in, out, env0, env1, ld, mi + 2 * k * nsweeps, lanes, k * nsweeps, k,
                       nsweeps, mi, ni, m, n, tm, tn, ring, 1, row_lo, row_hi, col_lo, col_hi,
                       boundary, monoid, measure, 1, live, partials, slots, ticket, result,
                       (cudaStream_t)stream};
  const int bad = window::check(a, n_params, radius);
  if (bad) return bad;
  return window::launch_any(functor, radius, dtype, params, n_params, a);
}

// What the last launch of either entry point chose: grid, CTAs an SM,
// dynamic shared memory a CTA (bytes), registers a thread, tile rows, tile
// columns, window slots, (tile, lane) pairs.
void stencil_launch_info(int* out8) {
  const window::Info& i = last_launch;
  const int v[8] = {i.grid, i.ctas_per_sm, i.smem_bytes, i.registers,
                    i.tm,   i.tn,          i.ring,       i.tiles};
  for (int j = 0; j < 8; ++j) out8[j] = v[j];
}

}  // extern "C"
