// The stencil+reduce kernel of the port, for sm_90a: T fused sweeps of an
// elemental functor over a window of a persistent halo frame, shared by
// both stencil entry points.
//
// Replaces two Pallas TPU kernels:
//   * repro/kernels/stencil2d.py::_stencil_kernel (stencil2d.cu's
//     stencil_sweep): T = 1, pad = k, env fields in the interior layout,
//     no boundary re-assertion, the reduce optional (do_reduce);
//   * repro/kernels/multistep.py::_ms_kernel with _fix_boundary and
//     _ShrinkTaps (multistep.cu's multistep_sweep): T sweeps on one
//     (tm+2kT, tn+2kT) window with the valid region shrinking by k a side
//     per sweep, the boundary model re-asserted after every sweep, env
//     fields as full halo frames, the reduce on the last two iterates.
//
// What bounds it on an H100: device-memory bytes.  A launch must read the
// frame and each env field once and write the frame once (3 x 4 bytes a
// cell for Helmholtz in f32: 0.24 ms at 8192^2 at 3.35 TB/s), and does
// 10-25 operations a cell a sweep, far below the card's ~20 flops/byte
// ridge at T = 1.  At T = 8 the operations (the Helmholtz functor's IEEE
// division, the taps and the window's recomputed halo) come close to the
// byte time.  The AMF functors sort up to 49 values a cell and are bound
// by operations at any T.
//
// What the design does about it:
//   * the CTA tile (tm, tn) is the kernel's own, a whole number of 8-row,
//     32-column pieces chosen by the wrapper (stencil2d.cta_tile) from the
//     radius, T, the field count and the frame size, and not the frame's
//     block: tiles that run past the block-rounded interior are masked, and
//     a lane stack is one list of (tile, lane) pairs;
//   * persistent CTAs: the grid is the SMs times the CTAs an SM holds, and
//     CTA b walks pairs b, b + grid, ... in lane-major order;
//   * async window staging: a two-slot ring in dynamic shared memory; the
//     next pair's window of the frame and of the env fields is copied by
//     cp.async while this one sweeps (one slot, loaded between pairs, where
//     two do not fit: deep k*T).  Copies move two elements (8 bytes of f32,
//     4 of bf16): every window row starts at an even element (the row
//     stride and the tile's first column are even), while 16-byte copies or
//     TMA would need row strides the frames do not have (pad 1 gives 8194
//     floats a row).  Cells past the frame's end are filled with zeros;
//     they lie more than kT from any cell written;
//   * register-blocked sweeps: a warp covers 32 consecutive columns and
//     each thread walks a strip of one column, keeping the (2K+1)^2 taps
//     in registers, so a row step loads 2K+1 values (3 for the radius-1
//     functors, against 5-9 taps) and the functor sees the same values
//     through the same g(di, dj) calls as before (AMF, whose taps are
//     run-time offsets, reads the window directly);
//   * the sweeps ping-pong between the staged slot and one work buffer,
//     each value rounded to the storage type as it is stored, so a bf16
//     iterate rounds as T single sweeps would; the last sweep writes the
//     output frame and folds the measure straight from registers (only a
//     reflect edge window goes through the buffer for its mirror passes);
//   * the boundary model after every sweep, in lane-local frame
//     coordinates against run-time domain bounds [row_lo, row_hi) x
//     [col_lo, col_hi) (a sharded caller may pass +-2^30 sentinels):
//     zero/nan fill the cells outside; reflect mirrors rows first (ghost
//     row g < row_lo takes 2*row_lo - g, g >= row_hi takes 2*(row_hi-1) -
//     g, where that row lies in the domain and the region), then columns
//     over the row-fixed values; wrap does nothing (a wrapped ghost ring
//     evolves like its pre-image, and stencil_sweep re-asserts nothing);
//   * the fold: per-thread accumulators over all of a CTA's tiles of a
//     lane, warp shuffles, one partial per CTA and lane, and the lane's
//     last CTA folds the partials in a fixed order (fold.cuh): the same
//     grid gives the same sum on every run;
//   * a lane whose live flag is 0 copies its tiles through and skips the
//     fold, so it keeps its value while the others sweep.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "elementals.cuh"
#include "fold.cuh"

namespace window {

using namespace elementals;
using namespace fold;

// Keep in step with BOUNDARY_IDS in repro_torch/kernels/multistep.py.
enum BoundaryId : int { B_ZERO = 0, B_NAN = 1, B_REFLECT = 2, B_WRAP = 3 };

// rows a register-blocked thread evaluates together (independent cells)
constexpr int kGroup = 4;
// the most CTAs a launch keeps resident (the partials' capacity bound)
constexpr int kMaxGrid = 4096;

// One launch, as the C entry points describe it.
struct Args {
  const void* in;
  void* out;
  const void* env0;
  const void* env1;
  long long ld;        // frame row stride (elements); even
  int frame_rows;      // rows of one lane's frame
  int lanes;
  int pad;             // frame pad (= k * nsweeps)
  int k;               // region shrink a sweep
  int nsweeps;         // T
  int mi, ni;          // block-rounded interior of one lane
  int m, n;            // domain, for the reduce
  int tm, tn;          // CTA tile
  int ring;            // window slots: 2 (the next window loads during the
                       // sweeps) or 1 (where two do not fit)
  int env_halo;        // 1: env fields are full frames; 0: interior (mi, ni)
  int row_lo, row_hi, col_lo, col_hi;
  int boundary;        // B_WRAP: re-assert nothing
  int monoid, measure, do_reduce;
  const unsigned char* live;
  float* partials;
  int slots;           // partials a lane may hold
  unsigned int* ticket;
  float* result;
  cudaStream_t stream;
};

// What the last launch chose, for the caller's report.
struct Info {
  int grid, ctas_per_sm, smem_bytes, registers, tm, tn, ring, tiles;
};

// Shared memory of one CTA (bytes): `ring` slots of (frame window, env
// windows) and, for T > 1 or a reflect boundary, one work buffer.  Each
// buffer rounded up to 16 bytes.  stencil2d.window_bytes mirrors it.
__host__ __device__ inline size_t round16(size_t b) { return (b + 15) / 16 * 16; }

struct Layout {
  int wm, wn, elo, ewm, ewn;
  size_t win, env, slot, total;
  __host__ __device__ Layout(const Args& a, int n_env, size_t elem) {
    wm = a.tm + 2 * a.pad;
    wn = a.tn + 2 * a.pad;
    elo = a.env_halo ? 0 : a.pad;
    ewm = wm - 2 * elo;
    ewn = wn - 2 * elo;
    win = round16((size_t)wm * wn * elem);
    env = round16((size_t)ewm * ewn * elem);
    slot = win + n_env * env;
    const bool work = a.nsweeps > 1 || a.boundary == B_REFLECT;
    total = a.ring * slot + (work ? win : 0);
  }
};

// cp.async of N bytes, or N zero bytes when !ok (the source is not read).
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool ok) {
  const unsigned int s = (unsigned int)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(src), "n"(N),
               "r"(ok ? N : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Issue the copies of an h x w window (w even) whose [0, 0] is (row0,
// col0) of a (rows, cols) source with row stride sld; dst has row stride w.
// Warps take rows, lanes take element pairs.
template <class T>
__device__ __forceinline__ void stage(T* dst, const T* src, long long sld, int rows, int cols,
                                      int row0, int col0, int h, int w) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < h; i += kWarps) {
    const int gr = row0 + i;
    const T* srow = src + (long long)gr * sld + col0;
    for (int j = 2 * lane; j < w; j += 64) {
      const bool ok = gr < rows && col0 + j < cols;
      cp_async<2 * sizeof(T)>(dst + i * w + j, ok ? srow + j : src, ok);
    }
  }
}

// Mirror source of coordinate g along one axis with domain [lo, hi), or
// -1 when g is inside (or the source lies outside [lo, hi)).
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

// CTAs an SM that the register budget must allow.  The AMF functors run
// small tiles and sort in local memory: many warps hide that.  For the
// others ptxas would trade a few spills for a fourth CTA, which the shared
// memory of the large tiles does not allow.
template <class F>
constexpr int min_ctas() {
  return !reg_taps<F>::value ? 5 : F::K == 1 ? 3 : 2;
}

template <class T, class F>
__global__ void __launch_bounds__(kThreads, min_ctas<F>()) window_kernel(const Args a, const F f) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int K = F::K, D = 2 * K + 1;
  const Layout L(a, F::N_ENV, sizeof(T));
  const int wm = L.wm, wn = L.wn, elo = L.elo, ewn = L.ewn;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ntn = (a.ni + a.tn - 1) / a.tn;
  const int per_lane = ((a.mi + a.tm - 1) / a.tm) * ntn;
  const int total = per_lane * a.lanes;
  const int grid = gridDim.x;
  const int nslots = per_lane < grid ? per_lane : grid;
  const T* in = static_cast<const T*>(a.in);
  T* out = static_cast<T*>(a.out);
  const T* envp[2] = {static_cast<const T*>(a.env0), static_cast<const T*>(a.env1)};
  const int erows = a.env_halo ? a.frame_rows : a.mi;
  const long long eld = a.env_halo ? a.ld : a.ni;
  T* work = reinterpret_cast<T*>(smem + a.ring * L.slot);
  const bool ahead = a.ring == 2;  // the next window loads during the sweeps
  const float fill = a.boundary == B_NAN ? NAN : 0.0f;

  auto slot_u = [&](int s) { return reinterpret_cast<T*>(smem + s * L.slot); };
  auto slot_e = [&](int s, int e) {
    return reinterpret_cast<T*>(smem + s * L.slot + L.win + e * L.env);
  };
  auto issue = [&](int t, int s) {
    const int ln = t / per_lane, tl = t - ln * per_lane;
    const int ir0 = (tl / ntn) * a.tm, ic0 = (tl % ntn) * a.tn;
    stage(slot_u(s), in + (long long)ln * a.frame_rows * a.ld, a.ld, a.frame_rows, (int)a.ld,
          ir0, ic0, wm, wn);
#pragma unroll
    for (int e = 0; e < F::N_ENV; ++e)
      stage(slot_e(s, e), envp[e] + (long long)ln * erows * eld, eld, erows, (int)eld, ir0, ic0,
            L.ewm, ewn);
  };

  int t = blockIdx.x;
  if (t >= total) return;
  issue(t, 0);
  cp_async_commit();
  float acc = monoid_identity(a.monoid);
  int first = t;  // this CTA's first pair in the current lane
  for (int it = 0; t < total; t += grid, ++it) {
    const int nt = t + grid;
    const int sl = ahead ? it & 1 : 0;
    if (ahead) {
      if (nt < total) issue(nt, sl ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const int ln = t / per_lane, tl = t - ln * per_lane;
    const int ir0 = (tl / ntn) * a.tm, ic0 = (tl % ntn) * a.tn;  // window origin, frame coords
    const long long obase = ((long long)ln * a.frame_rows + ir0) * a.ld + ic0;
    const bool live = a.live == nullptr || a.live[ln];
    T* cur = slot_u(sl);
    const T* e0 = F::N_ENV > 0 ? slot_e(sl, 0) : nullptr;
    const T* e1 = F::N_ENV > 1 ? slot_e(sl, 1) : nullptr;

    if (!live) {
      // a finished lane keeps its value: copy the tile through, no fold
      for (int r = warp; r < a.tm; r += kWarps)
        for (int c = lane; c < a.tn; c += 32)
          if (ir0 + r < a.mi && ic0 + c < a.ni)
            out[obase + (long long)(a.pad + r) * a.ld + a.pad + c] =
                cur[(a.pad + r) * wn + a.pad + c];
    } else {
      // Does this window reach outside the domain?  (Uniform over the CTA.)
      const bool edge = a.boundary != B_WRAP &&
                        (ir0 < a.row_lo || ir0 + wm > a.row_hi || ic0 < a.col_lo ||
                         ic0 + wn > a.col_hi);
      const bool reflect = edge && a.boundary == B_REFLECT;
      const bool fills = edge && a.boundary != B_REFLECT;
      T* nxt = work;
      bool direct = false;
      for (int s = 0; s < a.nsweeps; ++s) {
        const int lo = a.k * (s + 1);
        const int H = wm - 2 * lo, W = wn - 2 * lo;
        direct = s == a.nsweeps - 1 && !reflect;
        // The region's cells, as 32-column chunks of H rows, split evenly
        // over the warps in chunk-major order: each warp walks at most a
        // few strips of one column a lane.
        const int nch = (W + 31) >> 5;
        const int per = (H * nch + kWarps - 1) / kWarps;
        const int s1 = (warp + 1) * per < H * nch ? (warp + 1) * per : H * nch;
        // one specialisation a (last sweep?, fill?) pair: no per-cell test
        auto sweep = [&](auto direct_c, auto fills_c) {
          constexpr bool kDirect = decltype(direct_c)::value;
          constexpr bool kFills = decltype(fills_c)::value;
          for (int s0 = warp * per; s0 < s1;) {
            const int ch = s0 / H, rr = s0 - ch * H;
            const int len = H - rr < s1 - s0 ? H - rr : s1 - s0;
            s0 += len;
            const int c = lo + ch * 32 + lane;
            if (c >= lo + W) continue;
            const int gc = ic0 + c;
            // one cell's value: the functor on its taps and env values
            auto value = [&](int r, const auto& taps) {
              const int eo = (r - elo) * ewn + (c - elo);
              const float x0 = F::N_ENV > 0 ? to_f(e0[eo]) : 0.0f;
              const float x1 = F::N_ENV > 1 ? to_f(e1[eo]) : 0.0f;
              return f(taps, x0, x1);
            };
            // ... rounded, the boundary fill, then the work buffer or (last
            // sweep) the output frame and the fold
            auto emit = [&](int r, float val, float centre) {
              val = round_as<T>(val);
              const int gr = ir0 + r;
              if (kFills && (gr < a.row_lo || gr >= a.row_hi || gc < a.col_lo || gc >= a.col_hi))
                val = fill;
              if constexpr (!kDirect) {
                nxt[r * wn + c] = store_as<T>(val);
              } else {
                // the last sweep: rows and columns [pad, pad + tile)
                const int ir = gr - a.pad, ic = gc - a.pad;
                if (ir < a.mi && ic < a.ni) {
                  out[obase + (long long)r * a.ld + c] = store_as<T>(val);
                  if (a.do_reduce && ir < a.m && ic < a.n)
                    acc = monoid_combine(a.monoid, acc,
                                         cell_measure(a.monoid, a.measure, val, centre));
                }
              }
            };
            const int r0 = lo + rr, r1 = r0 + len;
            if constexpr (reg_taps<F>::value) {
              // v holds rows r-K .. r+K+G-1 of columns c-K .. c+K: a step of
              // G rows loads G new rows and evaluates G independent cells,
              // without a branch between them (div_fast; a group with an
              // operand out of its range is evaluated again with IEEE
              // division)
              constexpr int G = kGroup;
              float v[D + G - 1][D];
              auto load_row = [&](int i, int r) {
  #pragma unroll
                for (int j = 0; j < D; ++j) v[i][j] = to_f(cur[r * wn + c - K + j]);
              };
  #pragma unroll
              for (int i = 0; i + 1 < D; ++i) load_row(i, r0 - K + i);
              int r = r0;
              for (; r + G <= r1; r += G) {
  #pragma unroll
                for (int q = 0; q < G; ++q) load_row(D - 1 + q, r + K + q);
                float val[G];
                bool unsafe = false;
  #pragma unroll
                for (int q = 0; q < G; ++q) val[q] = value(r + q, RegTaps<K, true>{v + q, &unsafe});
                if (unsafe) {
  #pragma unroll
                  for (int q = 0; q < G; ++q) val[q] = value(r + q, RegTaps<K, false>{v + q, nullptr});
                }
  #pragma unroll
                for (int q = 0; q < G; ++q) emit(r + q, val[q], v[q + K][K]);
  #pragma unroll
                for (int i = 0; i + 1 < D; ++i)
  #pragma unroll
                  for (int j = 0; j < D; ++j) v[i][j] = v[i + G][j];
              }
              for (; r < r1; ++r) {
                load_row(D - 1, r + K);
                emit(r, value(r, RegTaps<K, false>{v, nullptr}), v[K][K]);
  #pragma unroll
                for (int i = 0; i + 1 < D; ++i)
  #pragma unroll
                  for (int j = 0; j < D; ++j) v[i][j] = v[i + 1][j];
              }
            } else {
              for (int r = r0; r < r1; ++r)
                emit(r, value(r, WinTaps<T>{cur + r * wn + c, wn}), to_f(cur[r * wn + c]));
            }
          }
        };
        using yes = std::true_type;
        using no = std::false_type;
        if (direct)
          fills ? sweep(yes{}, yes{}) : sweep(yes{}, no{});
        else
          fills ? sweep(no{}, yes{}) : sweep(no{}, no{});
        if (direct) break;
        __syncthreads();
        if (reflect) {
          // rows first: a ghost row reads a domain row, which this pass leaves
          for (int r = lo + warp; r < lo + H; r += kWarps) {
            const long long sr = mirror(ir0 + r, a.row_lo, a.row_hi);
            const int lr = (int)(sr - ir0);
            if (sr < 0 || lr < lo || lr >= lo + H) continue;
            for (int c = lo + lane; c < lo + W; c += 32) nxt[r * wn + c] = nxt[lr * wn + c];
          }
          __syncthreads();
          // then columns, over the row-fixed values
          for (int r = lo + warp; r < lo + H; r += kWarps)
            for (int c = lo + lane; c < lo + W; c += 32) {
              const long long sc = mirror(ic0 + c, a.col_lo, a.col_hi);
              const int lc = (int)(sc - ic0);
              if (sc < 0 || lc < lo || lc >= lo + W) continue;
              nxt[r * wn + c] = nxt[r * wn + lc];
            }
          __syncthreads();
        }
        T* tmp = cur;
        cur = nxt;
        nxt = tmp;
      }
      if (!direct) {
        // a reflect edge window: cur holds the last iterate on the tile,
        // nxt the one before it
        for (int r = a.pad + warp; r < a.pad + a.tm; r += kWarps)
          for (int c = a.pad + lane; c < a.pad + a.tn; c += 32) {
            const int ir = ir0 + r - a.pad, ic = ic0 + c - a.pad;
            if (ir >= a.mi || ic >= a.ni) continue;
            const float val = to_f(cur[r * wn + c]);
            out[obase + (long long)r * a.ld + c] = store_as<T>(val);
            if (a.do_reduce && ir < a.m && ic < a.n)
              acc = monoid_combine(a.monoid, acc,
                                   cell_measure(a.monoid, a.measure, val, to_f(nxt[r * wn + c])));
          }
      }
    }
    __syncthreads();  // the slot and the work buffer are free
    if (!ahead && nt < total) {
      issue(nt, 0);
      cp_async_commit();
    }

    // the lane's last pair of this CTA: fold its partial
    if (nt >= total || nt / per_lane != ln) {
      if (a.do_reduce) {
        if (live)
          fold_cta(acc, a.monoid, a.partials + (long long)ln * a.slots, a.ticket + ln,
                   a.result + ln, (unsigned int)(first - ln * per_lane), (unsigned int)nslots);
        else if (first == ln * per_lane && threadIdx.x == 0)
          a.result[ln] = monoid_identity(a.monoid);
      }
      acc = monoid_identity(a.monoid);
      first = nt;
    }
  }
}

// Launch the kernel for one (storage, functor): the persistent grid from
// the occupancy at this window's shared memory.  Returns a cudaError_t or
// one of fold.cuh's codes; fills *info.
template <class T, class F>
int launch(const F& f, const Args& a, Info* info) {
  const Layout L(a, F::N_ENV, sizeof(T));
  auto kernel = window_kernel<T, F>;
  // per instantiation: the dynamic shared memory granted so far and the
  // occupancy at the last size asked (launches of one loop repeat it).
  // Two host threads racing here can at worst launch a grid sized for
  // another window: the CTAs then share the SMs in turns, and no CTA
  // waits for another, so the result is the same.
  static int granted = 48 * 1024, occ_bytes = -1, occ = 0, regs = 0;
  int dev = 0, optin = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int bytes = (int)L.total;
  if (L.total + 1024 > (size_t)optin) return kErrSharedMemory;
  if (bytes > granted) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    granted = bytes;
  }
  if (bytes != occ_bytes) {
    cudaFuncAttributes attr;
    e = cudaFuncGetAttributes(&attr, kernel);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kThreads, bytes);
    if (e != cudaSuccess) return (int)e;
    if (occ < 1) return kErrSharedMemory;
    regs = attr.numRegs;
    occ_bytes = bytes;
  }
  const long long per_lane =
      (long long)((a.mi + a.tm - 1) / a.tm) * ((a.ni + a.tn - 1) / a.tn);
  const long long total = per_lane * a.lanes;
  if (total > INT_MAX) return kErrBadArgs;
  long long grid = (long long)sms * occ;
  if (grid > kMaxGrid) grid = kMaxGrid;
  if (grid > total) grid = total;
  if (a.do_reduce && (per_lane < grid ? per_lane : grid) > a.slots) return kErrBadArgs;
  *info = Info{(int)grid, occ, bytes, regs, a.tm, a.tn, a.ring, (int)total};
  kernel<<<(unsigned int)grid, kThreads, bytes, a.stream>>>(a, f);
  return (int)cudaGetLastError();
}

// Checks shared by the entry points; 0 when the launch may go ahead.
inline int check(const Args& a, int n_params, int radius) {
  const bool bad =
      n_params < 0 || n_params > kMaxParams || a.lanes <= 0 || a.mi <= 0 || a.ni <= 0 ||
      a.tm <= 0 || a.tn <= 0 || a.tm % 8 != 0 || a.tn % 32 != 0 || a.ni % 2 != 0 ||
      (a.ring != 1 && a.ring != 2) || a.ld % 2 != 0 || a.k <= 0 || a.nsweeps <= 0 ||
      radius > a.k || a.pad != a.k * a.nsweeps || a.boundary < B_ZERO ||
      a.boundary > B_WRAP || a.frame_rows != a.mi + 2 * a.pad ||
      (long long)a.lanes * a.frame_rows > INT_MAX || a.in == nullptr || a.out == nullptr ||
      (a.do_reduce && (a.partials == nullptr || a.ticket == nullptr || a.result == nullptr));
  return bad ? kErrBadArgs : 0;
}

// The launch for the (functor, radius) of a call, one function a storage
// type: each instantiates the kernel for every functor once, in a unit of
// its own (multistep.cu: float32, window_bf16.cu: bfloat16), and the two
// compile in parallel.
int launch_f32(int functor, int radius, const Params& p, const Args& a, Info* info);
int launch_bf16(int functor, int radius, const Params& p, const Args& a, Info* info);

// The launch for the (dtype, functor, radius) of a call (multistep.cu).
int launch_any(int functor, int radius, int dtype, const float* params, int n_params,
               const Args& a);

}  // namespace window
