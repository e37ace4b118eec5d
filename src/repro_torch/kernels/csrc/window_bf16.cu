// The bfloat16 instantiations of window.cuh's stencil kernel (one per
// functor and radius), in a unit of their own so that they compile in
// parallel with multistep.cu's float32 ones.  Entry points: stencil2d.cu,
// multistep.cu.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dispatch.cuh"
#include "window.cuh"

int window::launch_bf16(int functor, int radius, const Params& p, const Args& a, Info* info) {
  auto go = [&](auto t, auto fz) {
    using F = typename decltype(fz)::type;
    return launch<typename decltype(t)::type, F>(F(p), a, info);
  };
  return dispatch::by_functor<__nv_bfloat16>(functor, radius, go);
}
