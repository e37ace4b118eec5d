// Run-time (functor, radius) -> kernel instantiation for one storage type
// (window.cuh's launch_f32 / launch_bf16).  `go` is a generic callable
// taking two type tags, the storage type and the functor type, and
// returning the launch's error code.
#pragma once

#include <cuda_bf16.h>

#include "elementals.cuh"
#include "fold.cuh"

namespace dispatch {

template <class X>
struct tag {
  using type = X;
};

template <class T, class Go>
int by_functor(int functor, int radius, Go& go) {
  using namespace elementals;
  constexpr int kNone = fold::kErrUnknownFunctor;
  switch (functor) {
    case JACOBI: return radius == 1 ? go(tag<T>{}, tag<Jacobi>{}) : kNone;
    case HELMHOLTZ_JACOBI: return radius == 1 ? go(tag<T>{}, tag<HelmholtzJacobi>{}) : kNone;
    case HEAT: return radius == 1 ? go(tag<T>{}, tag<Heat>{}) : kNone;
    case SOBEL: return radius == 1 ? go(tag<T>{}, tag<Sobel>{}) : kNone;
    case GOL: return radius == 1 ? go(tag<T>{}, tag<Gol>{}) : kNone;
    case MEDIAN3: return radius == 1 ? go(tag<T>{}, tag<Median3>{}) : kNone;
    case RESTORE: return radius == 1 ? go(tag<T>{}, tag<Restore>{}) : kNone;
    case AMF_MASK:
      switch (radius) {
        case 1: return go(tag<T>{}, tag<AmfMask<1>>{});
        case 2: return go(tag<T>{}, tag<AmfMask<2>>{});
        case 3: return go(tag<T>{}, tag<AmfMask<3>>{});
        default: return kNone;
      }
    case AMF_REPL:
      switch (radius) {
        case 1: return go(tag<T>{}, tag<AmfRepl<1>>{});
        case 2: return go(tag<T>{}, tag<AmfRepl<2>>{});
        case 3: return go(tag<T>{}, tag<AmfRepl<3>>{});
        default: return kNone;
      }
    case CONV:
      switch (radius) {
        case 1: return go(tag<T>{}, tag<Conv<1>>{});
        case 2: return go(tag<T>{}, tag<Conv<2>>{});
        case 3: return go(tag<T>{}, tag<Conv<3>>{});
        default: return kNone;
      }
    default: return kNone;
  }
}

}  // namespace dispatch
