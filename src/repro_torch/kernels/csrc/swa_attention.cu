// Flash sliding-window attention with native GQA on CUDA cores, for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/swa_attention.py::_swa_kernel
// (pallas_call at :97) for float32 at every head_dim and bfloat16 at head_dim
// 16 and 32 (bf16 at 64, 96, 128 and 256 runs on the tensor cores:
// swa_wgmma.cu): softmax(softcap(q k^T * scale) + band mask) v with the
// running max m, sum l and output accumulator in float32 (online softmax over
// kv tiles), kv head = query head / G (GQA).
//
// What bounds it on an H100: operations, at the f32 CUDA-core peak (67
// TFLOP/s: an SM's four schedulers each issue one 32-lane FMA a cycle, so the
// peak needs every issue slot to be an FMA); a TF32 tensor-core product would
// miss the float32 gate.  The design spends issue slots and shared-memory
// bandwidth on FMAs, keeps copies off the critical path and keeps 16 warps an
// SM resident:
//   * GQA packing: a CTA of 512 threads serves 64 q rows, HG query heads of
//     one kv head times 64 / HG positions, HG the largest power of two <= 8
//     that divides G; a larger G (or one with an odd factor) splits its
//     heads over G / HG CTAs, neighbours in grid y.  Every staged k/v tile
//     feeds 64 rows.  The grid's x runs over q blocks from the last (most kv
//     tiles under the causal band) to the first;
//   * 256-key tiles over the band [max(0, q0 - window + 1), q_last] (all
//     keys when causal = 0 and window = 0) and nothing outside it, the
//     reference's block skip: they start at the band's first key, and the
//     last tile's Q·K^T runs only on its 64-key blocks that reach into the
//     band;
//   * asynchronous staging: k and v reach shared memory by 16-byte cp.async
//     (zero-filled past the band) through a ring of 4 slots of 20 KB, each with a
//     full and an empty mbarrier: a thread's copies arrive on full when they
//     land, each warp arrives on empty when done with the slot, and the slot
//     is refilled three chunks ahead once every warp is done with it, so
//     warps drift up to a chunk apart with no CTA barrier.  A tile is a
//     run of chunks: k first, 64 bytes of each of its 256 key rows a chunk,
//     row-major with an 80-byte stride (float4 reads of 8 consecutive rows
//     hit 32 distinct banks; no transpose), then v, whole rows, at most 16 KB
//     a chunk; v chunks wholly outside the band are neither copied nor used.
//     q is staged once, scaled, transposed ([d][row]);
//   * register blocking: the 64 threads of a row group own 8 q rows.  In
//     Q·K^T a thread owns their 8 x 4 scores at keys g + 64 j (j < 4): per 4
//     d (f32; 8 for bf16) one float4 of each of its 4 key rows, per d two
//     float4s of q that the warp shares (a broadcast), 32 FMAs per 3 loads.
//     In P·V it owns RO rows x 4 output columns (RO = 8 at hd 256, 4 at 128
//     and 96, 2 at 64, 1 below): per key the RO probabilities (a broadcast)
//     and a float4 of v, 32 FMAs per 3 loads at hd 256;
//   * occupancy: at hd 256, 222,784 bytes of shared memory and at most 128
//     registers a thread: one CTA of 16 warps an SM (swa_launch_info);
//   * the epilogue: 1/sqrt(hd) * log2(e) is folded into q's scale (q is still
//     scaled before the dot) and softcap into cap * log2(e), so the softmax
//     runs on exp2f; capping is cap * tanhf(x * (1 / cap)) with the accurate
//     tanhf; masked scores are -2^30 (finite, as in the reference: a row
//     that is fully masked in one tile is wiped by the next tile's alpha =
//     0); tiles wholly inside the band skip the mask; a row's max crosses the
//     two warps of its group through shared memory and a 64-thread named
//     barrier, which also orders p^T between them; l is kept per warp in
//     shared memory and summed over the group's two warps at the end,
//     clamped at 1e-30;
//   * both products are fmaf (the library is built with --fmad=false); bf16
//     inputs widen to float when read from shared memory; the output rounds
//     once to the input type.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fold.cuh"

namespace {

constexpr int kRows = 64;            // q rows a CTA: heads x positions
constexpr int kBK = 256;             // keys a kv tile
constexpr int kThreads = 512;        // 8 row groups of 64 threads
constexpr int kGroup = 64;           // threads a row group
constexpr int kStages = 4;           // ring slots
constexpr int kChunk = 64;           // bytes of each key row a k chunk takes
constexpr int kLdK = 80;             // k chunk row stride, bytes
constexpr int kSlot = kBK * kLdK;    // 20480 bytes
constexpr int kVChunk = 16384;       // most bytes of v rows a chunk takes
constexpr int kLdQ = kRows + 4;      // floats: q^T [d][row]
constexpr int kLdP = kRows + 4;      // floats: p^T [key][row]
constexpr int kMaxHeads = 8;         // a CTA holds 8 positions at least
constexpr float kNegInf = -1073741824.0f;  // -2^30, NEG_INF of the reference
constexpr float kLog2e = 1.4426950408889634f;

constexpr int pow2_floor(int x) {
  int p = 1;
  while (2 * p <= x) p *= 2;
  return p;
}

// The tiling of one (storage type, head_dim).
template <class T, int HD>
struct Cfg {
  static constexpr int E = (int)sizeof(T);
  static constexpr int ROW = HD * E;                       // bytes of a k or v row
  static constexpr int CB = ROW < kChunk ? ROW : kChunk;   // bytes of a row a k chunk takes
  static constexpr int EPL = 16 / E;                       // elements a 16-byte piece
  static constexpr int DC = CB / E;                        // d's a k chunk
  static constexpr int NK = ROW / CB;                      // k chunks a tile
  static constexpr int KC =
      pow2_floor(kVChunk / ROW) < kBK ? pow2_floor(kVChunk / ROW) : kBK;  // keys a v chunk
  static constexpr int NV = kBK / KC;                      // v chunks a tile
  static constexpr int NCG = HD / 4;                       // float4 columns of the output
  static constexpr int RO = 8 * NCG <= kGroup ? 1 : 4 * NCG <= kGroup ? 2 : 2 * NCG <= kGroup ? 4 : 8;
  static constexpr int PV = (8 / RO) * NCG;                // threads of a group busy in P·V
  static constexpr size_t RING = (size_t)kStages * kSlot;
  static constexpr size_t QT = (size_t)HD * kLdQ * sizeof(float);
  static constexpr size_t PT = (size_t)kBK * kLdP * sizeof(float);
  static constexpr size_t RED = (3 * 8 * 2 * 8) * sizeof(float);  // row maxima, l, m
  static constexpr size_t BARS = 2 * kStages * sizeof(uint64_t);       // full, empty a slot
  static constexpr size_t SMEM = RING + QT + PT + RED + BARS;
  static_assert(HD % 16 == 0 && ROW % CB == 0 && CB % 16 == 0, "16-byte pieces of a row");
  static_assert(KC * ROW <= kSlot && kBK % KC == 0, "a v chunk fits a slot");
  static_assert(PV <= kGroup, "P·V threads of a group");
};

// 16 bytes (EPL elements) or 4 elements of a row, widened to float; 4 floats
// rounded once to T.
template <class T>
struct Wide;
template <>
struct Wide<float> {
  static __device__ __forceinline__ void load16(const char* p, float* f) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    f[0] = x.x, f[1] = x.y, f[2] = x.z, f[3] = x.w;
  }
  static __device__ __forceinline__ void load4(const char* p, float* f) { load16(p, f); }
  static __device__ __forceinline__ void store4(float* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};
template <>
struct Wide<__nv_bfloat16> {
  static __device__ __forceinline__ float lo(uint32_t x) { return __uint_as_float(x << 16); }
  static __device__ __forceinline__ float hi(uint32_t x) { return __uint_as_float(x & 0xffff0000u); }
  static __device__ __forceinline__ void load16(const char* p, float* f) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    f[0] = lo(x.x), f[1] = hi(x.x), f[2] = lo(x.y), f[3] = hi(x.y);
    f[4] = lo(x.z), f[5] = hi(x.z), f[6] = lo(x.w), f[7] = hi(x.w);
  }
  static __device__ __forceinline__ void load4(const char* p, float* f) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    f[0] = lo(x.x), f[1] = hi(x.x), f[2] = lo(x.y), f[3] = hi(x.y);
  }
  static __device__ __forceinline__ void store4(__nv_bfloat16* p, const float* f) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(f[0], f[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(f[2], f[3]);
    uint2 x;
    x.x = *reinterpret_cast<const uint32_t*>(&a);
    x.y = *reinterpret_cast<const uint32_t*>(&b);
    *reinterpret_cast<uint2*>(p) = x;
  }
};

// N consecutive floats of shared memory (N = 1, 2, 4 or 8; aligned to N).
template <int N>
__device__ __forceinline__ void load_floats(const float* p, float* f) {
  if constexpr (N == 8) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w, f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
  } else if constexpr (N == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
  } else if constexpr (N == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    f[0] = a.x, f[1] = a.y;
  } else {
    f[0] = *p;
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// cp.async of 16 bytes, or 16 zero bytes when !ok (the source is not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

// mbarriers of the ring (shared-memory words): init, arrive, wait for the
// completion of the phase of the given parity; an arrival that fires once
// this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// The two warps of row group rg (named barrier 1 + rg; 0 is __syncthreads).
__device__ __forceinline__ void group_sync(int rg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(rg + 1), "n"(kGroup) : "memory");
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int N>
struct Int {
  static constexpr int value = N;
};

// a[i] for a run-time i < 8, without local memory.
__device__ __forceinline__ float pick8(const float (&a)[8], int i) {
  float r = a[0];
#pragma unroll
  for (int u = 1; u < 8; ++u) r = i == u ? a[u] : r;
  return r;
}

// q: (bh, S, HD); k, v: (bh / group, S, HD); o: (bh, S, HD); row-major.
// A CTA's 64 rows are 2^(6 - bq_log2) query heads (a power of two dividing
// group) times 2^bq_log2 positions; qscale = log2(e) / sqrt(HD); cap =
// softcap * log2(e), 0 for none, inv_cap its reciprocal (0 for none).
template <class T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
swa_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           T* __restrict__ o, int S, int group, int window, int causal, float qscale,
           float cap, float inv_cap, int bq_log2) {
  using C = Cfg<T, HD>;
  extern __shared__ float4 smem4[];
  char* ring = reinterpret_cast<char*>(smem4);                // kStages slots
  float* qt = reinterpret_cast<float*>(ring + C::RING);       // [HD][kLdQ], scaled q
  float* pt = qt + HD * kLdQ;                                 // [kBK][kLdP], probabilities
  float* red = pt + kBK * kLdP;        // [8 groups][2 warps][8 rows]: a tile's row maxima
  float* lsh = red + 128;              // [8 groups][2 warps][8 rows]: l of the warp's keys
  float* msh = lsh + 128;              // [2][8 groups][8 rows]: m, by tile parity
  uint64_t* full = reinterpret_cast<uint64_t*>(msh + 128);    // a slot's copies landed
  uint64_t* empty = full + kStages;                           // every warp is done with it

  const int tid = threadIdx.x, rg = tid >> 6, g = tid & (kGroup - 1);
  const int half = g >> 5, lane = tid & 31;
  const int bq = 1 << bq_log2;             // positions a CTA
  const int heads = kRows >> bq_log2;      // query heads a CTA
  const int nq = (S + bq - 1) / bq;
  const int q0 = (nq - 1 - (int)blockIdx.x) * bq;
  const int splits = group / heads;
  const int kvrow = (int)blockIdx.y / splits;
  const int qrow0 = kvrow * group + ((int)blockIdx.y - kvrow * splits) * heads;
  const char* kb = reinterpret_cast<const char*>(k) + (long long)kvrow * S * C::ROW;
  const char* vb = reinterpret_cast<const char*>(v) + (long long)kvrow * S * C::ROW;

  const int q_last = min(q0 + bq, S) - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? q_last : S - 1;
  const int ntiles = (k_hi - k_lo) / kBK + 1;  // tiles from k_lo
  const int nchunks = ntiles * (C::NK + C::NV);

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + i, kThreads);      // every thread's copies
      mbar_init(empty + i, kThreads / 32);  // every warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  // the copies of chunk ic: slot ic % kStages, last used by chunk ic - kStages
  auto issue = [&](int ic) {
    if (ic < nchunks) {
      const int it = ic / (C::NK + C::NV), iw = ic - it * (C::NK + C::NV);
      const int k0 = k_lo + it * kBK;
      char* slot = ring + (ic % kStages) * kSlot;
      if (ic >= kStages) mbar_wait(empty + ic % kStages, ((ic - kStages) / kStages) & 1);
      if (iw < C::NK) {
        constexpr int SEG = C::CB / 16, N = kBK * SEG;
#pragma unroll
        for (int i = 0; i < (N + kThreads - 1) / kThreads; ++i) {
          const int e = tid + i * kThreads;
          if (N % kThreads == 0 || e < N) {
            const int key = e / SEG, s = e - key * SEG;
            const bool ok = k0 + key <= k_hi;
            cp_async16(slot + key * kLdK + s * 16,
                       kb + (long long)(ok ? k0 + key : 0) * C::ROW + iw * C::CB + s * 16, ok);
          }
        }
      } else {
        const int kc = k0 + (iw - C::NK) * C::KC;
        if (kc <= k_hi && kc + C::KC > k_lo) {
          constexpr int SEG = C::ROW / 16, N = C::KC * SEG;
#pragma unroll
          for (int i = 0; i < (N + kThreads - 1) / kThreads; ++i) {
            const int e = tid + i * kThreads;
            if (N % kThreads == 0 || e < N) {
              const int key = e / SEG, s = e - key * SEG;
              const bool ok = kc + key <= k_hi;
              cp_async16(slot + key * C::ROW + s * 16,
                         vb + (long long)(ok ? kc + key : 0) * C::ROW + s * 16, ok);
            }
          }
        }
      }
      cp_async_arrive(full + ic % kStages);
    }
  };

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);

  // q^T, scaled, while the first chunks are in flight; threads take rows
  for (int e = tid; e < kRows * (HD / 4); e += kThreads) {
    const int r = e & (kRows - 1), d = (e / kRows) * 4;
    const int pos = q0 + (r & (bq - 1));
    float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (pos < S)
      Wide<T>::load4(reinterpret_cast<const char*>(
                         q + ((long long)(qrow0 + (r >> bq_log2)) * S + pos) * HD + d),
                     x);
#pragma unroll
    for (int i = 0; i < 4; ++i) qt[(d + i) * kLdQ + r] = x[i] * qscale;
  }
  if (tid < 128) lsh[tid] = 0.0f;
  if (tid < 64) msh[tid] = kNegInf;
  __syncthreads();

  const int row0 = rg * 8;                 // the group's first row
  const int pos0 = q0 + (row0 & (bq - 1));  // and its position
  const int cgo = g % C::NCG, rsub = g / C::NCG;  // P·V: columns 4 cgo.., rows rsub RO..
  const bool pv = g < C::PV;

  // chunk c is computed once its copies have landed; then its slot is
  // released (every warp arrives) and chunk c + kStages - 1 is issued into
  // the slot of chunk c - 1: warps drift up to a chunk apart, no CTA barrier
  int c = 0;
  auto acquire = [&]() { mbar_wait(full + c % kStages, (c / kStages) & 1); };
  auto release = [&]() {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + c % kStages);
    ++c;
    issue(c + kStages - 2);
  };

  float s[8][4], acc[C::RO][4];
#pragma unroll
  for (int i = 0; i < C::RO; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = k_lo + t * kBK;
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[r][j] = 0.0f;

    // S = (q * scale) k^T over the k chunks, on the 64-key blocks j < J that
    // hold keys of the band: all four but in the last tile
    auto qk = [&](auto live) {
      constexpr int J = decltype(live)::value;
      for (int w = 0; w < C::NK; ++w) {
        acquire();
        const char* slot = ring + (c % kStages) * kSlot + g * kLdK;
        const float* qd = qt + w * C::DC * kLdQ + row0;
#pragma unroll
        for (int sg = 0; sg < C::CB / 16; ++sg) {
          float kf[J][C::EPL];
#pragma unroll
          for (int j = 0; j < J; ++j) Wide<T>::load16(slot + 64 * j * kLdK + sg * 16, kf[j]);
#pragma unroll
          for (int i = 0; i < C::EPL; ++i) {
            float a[8];
            load_floats<8>(qd + (sg * C::EPL + i) * kLdQ, a);
#pragma unroll
            for (int r = 0; r < 8; ++r)
#pragma unroll
              for (int j = 0; j < J; ++j) s[r][j] = fmaf(a[r], kf[j][i], s[r][j]);
          }
        }
        release();
      }
    };
    const int live = t + 1 < ntiles ? 4 : (k_hi - k0) / 64 + 1;
    if (live == 4)
      qk(Int<4>{});
    else if (live == 3)
      qk(Int<3>{});
    else if (live == 2)
      qk(Int<2>{});
    else
      qk(Int<1>{});

    // softcap, mask, online softmax; p^T to shared memory
    {
      const bool inside = k0 + kBK <= S && (!causal || k0 + kBK - 1 <= q0) &&
                          (window == 0 || k0 > q_last - window);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int qp = pos0 + r;
        const int lo = window > 0 ? qp - window + 1 : 0;
        const int hi = causal ? min(qp, S - 1) : S - 1;
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x = s[r][j];
          if (cap != 0.0f) x = cap * tanhf(x * inv_cap);
          const int kp = k0 + g + 64 * j;
          if (!inside && (kp < lo || kp > hi)) x = kNegInf;
          s[r][j] = x;
          mx = fmaxf(mx, x);
        }
        mx = warp_max(mx);
        if (lane == 0) red[(rg * 2 + half) * 8 + r] = mx;
      }
      group_sync(rg);  // both warps' maxima are in; both are done with the
                       // last tile's p^T, maxima and m
      const float* mcur = msh + (t & 1) * 64 + row0;
      float* mnxt = msh + ((t + 1) & 1) * 64 + row0;
      float alpha[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float mo = mcur[r];
        const float mn = fmaxf(mo, fmaxf(red[rg * 16 + r], red[rg * 16 + 8 + r]));
        alpha[r] = exp2f(mo - mn);
        float rs = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = exp2f(s[r][j] - mn);
          s[r][j] = p;
          rs += p;
        }
        rs = warp_sum(rs);
        float* lw = lsh + (rg * 2 + half) * 8 + r;
        if (lane == 0) *lw = *lw * alpha[r] + rs;
        if (g == 0) mnxt[r] = mn;
        if constexpr (C::RO == 8) {
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[r][j] *= alpha[r];
        }
      }
      if constexpr (C::RO < 8) {
#pragma unroll
        for (int i = 0; i < C::RO; ++i) {
          const float a = pick8(alpha, rsub * C::RO + i);
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] *= a;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float* dst = pt + (g + 64 * j) * kLdP + row0;
        *reinterpret_cast<float4*>(dst) = make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
        *reinterpret_cast<float4*>(dst + 4) = make_float4(s[4][j], s[5][j], s[6][j], s[7][j]);
      }
      group_sync(rg);  // p^T, l and m are in
    }

    // acc += p v over the v chunks
    for (int w = 0; w < C::NV; ++w) {
      acquire();
      const int kc = w * C::KC;
      if (pv && k0 + kc <= k_hi && k0 + kc + C::KC > k_lo) {
        const float* prow = pt + kc * kLdP + row0 + rsub * C::RO;
        const char* vrow = ring + (c % kStages) * kSlot + cgo * 4 * C::E;
#pragma unroll 4
        for (int kk = 0; kk < C::KC; ++kk) {
          float p[C::RO], vv[4];
          load_floats<C::RO>(prow + kk * kLdP, p);
          Wide<T>::load4(vrow + kk * C::ROW, vv);
#pragma unroll
          for (int i = 0; i < C::RO; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
        }
      }
      release();
    }
  }

  if (pv) {
#pragma unroll
    for (int i = 0; i < C::RO; ++i) {
      const int row = row0 + rsub * C::RO + i;
      const int pos = q0 + (row & (bq - 1));
      if (pos < S) {
        const int gr = rsub * C::RO + i;
        const float li = fmaxf(lsh[rg * 16 + gr] + lsh[rg * 16 + 8 + gr], 1e-30f);
        float out[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) out[j] = acc[i][j] / li;
        Wide<T>::store4(o + ((long long)(qrow0 + (row >> bq_log2)) * S + pos) * HD + cgo * 4, out);
      }
    }
  }
}

struct Args {
  const void *q, *k, *v;
  void* o;
  int bh, S, group, window, causal;
  float scale, cap;
  cudaStream_t stream;
};

// What the last launch chose (swa_launch_info).
struct Info {
  int grid_x, grid_y, threads, smem_bytes, registers, ctas_per_sm, bq, heads, bk, stages,
      head_dim;
};
Info last_launch = {};

template <class T, int HD>
int launch(const Args& a) {
  constexpr int bytes = (int)Cfg<T, HD>::SMEM;
  auto kernel = swa_kernel<T, HD>;
  // per instantiation, asked once: occupancy at this shared memory, registers
  static int occ = 0, regs = 0;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  if (bytes > optin) return fold::kErrSharedMemory;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  if (occ == 0) {
    cudaFuncAttributes attr;
    int n = 0;
    e = cudaFuncGetAttributes(&attr, kernel);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, bytes);
    if (e != cudaSuccess) return (int)e;
    if (n < 1) return fold::kErrSharedMemory;
    regs = attr.numRegs;
    occ = n;
  }
  int heads = 1, bq_log2 = 6;  // kRows = 2^6 rows: heads x 2^bq_log2 positions
  while (2 * heads <= kMaxHeads && a.group % (2 * heads) == 0) heads *= 2, --bq_log2;
  const int bq = 1 << bq_log2;
  const dim3 grid((a.S + bq - 1) / bq, a.bh / heads);
  kernel<<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.o), a.S, a.group, a.window, a.causal, a.scale * kLog2e,
      a.cap * kLog2e, a.cap != 0.0f ? 1.0f / (a.cap * kLog2e) : 0.0f, bq_log2);
  last_launch = Info{(int)grid.x, (int)grid.y, kThreads, bytes, regs, occ, bq, heads, kBK,
                     kStages, HD};
  return (int)cudaGetLastError();
}

int f32_by_head_dim(int hd, const Args& a) {
  switch (hd) {
    case 16: return launch<float, 16>(a);
    case 32: return launch<float, 32>(a);
    case 64: return launch<float, 64>(a);
    case 96: return launch<float, 96>(a);
    case 128: return launch<float, 128>(a);
    case 256: return launch<float, 256>(a);
    default: return fold::kErrBadArgs;
  }
}

int bf16_by_head_dim(int hd, const Args& a) {
  switch (hd) {
    case 16: return launch<__nv_bfloat16, 16>(a);
    case 32: return launch<__nv_bfloat16, 32>(a);
    default: return fold::kErrBadArgs;  // 64, 96, 128, 256: swa_attention_wgmma
  }
}

}  // namespace

extern "C" {

// Flash attention over bh = B*H query rows of (S, hd) and bkh = B*KH kv rows
// (query row b reads kv row b / (bh / bkh)), float32 (dtype 0) or bfloat16
// (dtype 1, head_dim 16 and 32 only), all contiguous; o has q's shape and
// type.  window 0 means no band, causal 0 no causal mask, softcap 0 no
// capping.
int swa_attention_fwd(int dtype, int hd, const void* q, const void* k, const void* v, void* o,
                      int bh, int bkh, int S, int window, int causal, float scale,
                      float softcap, void* stream) {
  if (bh <= 0 || bkh <= 0 || bh % bkh != 0 || bh > 65535 || S <= 0 || window < 0 ||
      q == nullptr || k == nullptr || v == nullptr || o == nullptr)
    return fold::kErrBadArgs;
  const Args a{q, k, v, o, bh, S, bh / bkh, window, causal != 0, scale, softcap,
               (cudaStream_t)stream};
  if (dtype == 0) return f32_by_head_dim(hd, a);
  if (dtype == 1) return bf16_by_head_dim(hd, a);
  return fold::kErrBadArgs;
}

// The last launch of swa_kernel: grid x (q blocks) and y (CTAs over kv rows
// and head splits), threads, dynamic shared memory, registers a thread, CTAs
// resident an SM, positions and query heads a CTA, keys a tile, ring slots,
// head_dim.
void swa_launch_info(int* out11) {
  const Info& i = last_launch;
  const int v[11] = {i.grid_x,      i.grid_y, i.threads, i.smem_bytes, i.registers, i.ctas_per_sm,
                     i.bq,          i.heads,  i.bk,      i.stages,     i.head_dim};
  for (int n = 0; n < 11; ++n) out11[n] = v[n];
}

}  // extern "C"
