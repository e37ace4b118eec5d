// Flash sliding-window attention with native GQA on CUDA cores, for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/swa_attention.py::_swa_kernel
// for float32 at every head_dim and bfloat16 at head_dim 16 and 32 (bf16 at
// 64, 128 and 256 runs on the tensor cores: swa_wgmma.cu):
// softmax(softcap(q k^T * scale) + band mask) v for one (q row block, query
// head) per CTA, with the running max m, sum l and output accumulator in
// float32 (online softmax over kv tiles), kv head = query head / G (GQA).
//
// What bounds it on an H100: operations, at the f32 CUDA-core peak (67
// TFLOP/s); a TF32 tensor-core product would miss the float32 gate.
// Design, simple first:
//   * one CTA of 256 threads per (64-row q block, b*H + h); the grid's x
//     runs over q blocks from the last (most kv tiles under the causal
//     band) to the first;
//   * the kv loop visits only the 64-row tiles inside the band
//     [max(0, q0 - window + 1), q_last] (all tiles when causal = 0 and
//     window = 0), which gives the reference's block skip;
//   * q (scaled by 1/sqrt(hd) in float before the dot, as the reference
//     does), k and v tiles are staged in dynamic shared memory as float, q
//     and k transposed so that each thread reads float4s; each thread owns
//     4 rows x 4 kv columns of the score tile and 4 rows x hd/16 columns of
//     the output, so a row's m and l live in the 16 threads that share it
//     (warp shuffles reduce across them);
//   * both products are float FMAs from shared memory (fmaf: the library is
//     built with --fmad=false); softcap first (cap * tanhf(s / cap)), then
//     the mask, masked scores set to -2^30 (finite, as in the reference: a
//     row that is fully masked in one tile is wiped by the next tile's
//     alpha = exp(-2^30 - m) = 0), l clamped at 1e-30 at the end;
//   * bf16 inputs widen to float on load; the output rounds once to the
//     input type.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fold.cuh"

namespace {

constexpr int kBQ = 64, kBK = 64;      // q rows and kv rows per tile
constexpr int kSwaThreads = 256;       // 16 x 16: tx owns columns, ty rows
constexpr int kPad = 4;                // keeps float4 rows, spreads banks
constexpr int kLdQ = kBQ + kPad, kLdK = kBK + kPad, kLdP = kBQ + kPad;
constexpr float kNegInf = -1073741824.0f;  // -2^30, NEG_INF of the reference

template <class T>
__device__ __forceinline__ float to_float(T x);
template <>
__device__ __forceinline__ float to_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <class T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int HD>
constexpr size_t smem_floats() {
  return (size_t)HD * kLdQ + (size_t)HD * kLdK + (size_t)kBK * HD + (size_t)kBK * kLdP;
}

// q: (bh, S, HD); k, v: (bh / group, S, HD); o: (bh, S, HD); row-major.
template <class T, int HD>
__global__ void __launch_bounds__(kSwaThreads, 1)
swa_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           T* __restrict__ o, int S, int group, int window, int causal, float scale,
           float cap) {
  constexpr int CPT = HD / 16;         // output columns per thread
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [HD][kLdQ], scaled q
  float* kt = qt + HD * kLdQ;                    // [HD][kLdK]
  float* vs = kt + HD * kLdK;                    // [kBK][HD]
  float* pt = vs + kBK * HD;                     // [kBK][kLdP], probabilities

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int nq = (S + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kBQ;
  const int bh = blockIdx.y;
  const long long qoff = (long long)bh * S * HD;
  const long long kvoff = (long long)(bh / group) * S * HD;

  for (int e = tid; e < kBQ * HD; e += kSwaThreads) {
    const int r = e / HD, d = e % HD;
    float x = 0.0f;
    if (q0 + r < S) x = to_float(q[qoff + (long long)(q0 + r) * HD + d]) * scale;
    qt[d * kLdQ + r] = x;
  }

  const int q_last = min(q0 + kBQ, S) - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? q_last : S - 1;

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.0f;
  }

  for (int t = k_lo / kBK; t <= k_hi / kBK; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's readers are done (and q is staged)
    for (int e = tid; e < kBK * HD; e += kSwaThreads) {
      const int c = e / HD, d = e % HD;
      float kx = 0.0f, vx = 0.0f;
      if (k0 + c < S) {
        const long long g = kvoff + (long long)(k0 + c) * HD + d;
        kx = to_float(k[g]);
        vx = to_float(v[g]);
      }
      kt[d * kLdK + c] = kx;
      vs[c * HD + d] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * kLdQ + ty * 4);
      const float4 b = *reinterpret_cast<const float4*>(kt + d * kLdK + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx * 4 + j;
        float x = s[i][j];
        if (cap != 0.0f) x = cap * tanhf(x / cap);
        bool ok = kp < S;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && kp > qp - window;
        x = ok ? x : kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
      l[i] = alpha * l[i] + row_sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pt + (tx * 4 + j) * kLdP + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float4 p = *reinterpret_cast<const float4*>(pt + c * kLdP + ty * 4);
#pragma unroll
      for (int jj = 0; jj < CPT; ++jj) {
        const float vv = vs[c * HD + tx + 16 * jj];
        acc[0][jj] = fmaf(p.x, vv, acc[0][jj]);
        acc[1][jj] = fmaf(p.y, vv, acc[1][jj]);
        acc[2][jj] = fmaf(p.z, vv, acc[2][jj]);
        acc[3][jj] = fmaf(p.w, vv, acc[3][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float li = fmaxf(l[i], 1e-30f);
    T* dst = o + qoff + (long long)row * HD;
#pragma unroll
    for (int jj = 0; jj < CPT; ++jj) dst[tx + 16 * jj] = from_float<T>(acc[i][jj] / li);
  }
}

struct Args {
  const void *q, *k, *v;
  void* o;
  int bh, S, group, window, causal;
  float scale, cap;
  cudaStream_t stream;
};

template <class T, int HD>
int launch(const Args& a) {
  const size_t bytes = smem_floats<HD>() * sizeof(float);
  auto kernel = swa_kernel<T, HD>;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  if (bytes > (size_t)optin) return fold::kErrSharedMemory;
  if (bytes > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((a.S + kBQ - 1) / kBQ, a.bh);
  kernel<<<grid, kSwaThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.o), a.S, a.group, a.window, a.causal, a.scale, a.cap);
  return (int)cudaGetLastError();
}

int f32_by_head_dim(int hd, const Args& a) {
  switch (hd) {
    case 16: return launch<float, 16>(a);
    case 32: return launch<float, 32>(a);
    case 64: return launch<float, 64>(a);
    case 128: return launch<float, 128>(a);
    case 256: return launch<float, 256>(a);
    default: return fold::kErrBadArgs;
  }
}

int bf16_by_head_dim(int hd, const Args& a) {
  switch (hd) {
    case 16: return launch<__nv_bfloat16, 16>(a);
    case 32: return launch<__nv_bfloat16, 32>(a);
    default: return fold::kErrBadArgs;  // 64, 128, 256: swa_attention_wgmma
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

}  // extern "C"
