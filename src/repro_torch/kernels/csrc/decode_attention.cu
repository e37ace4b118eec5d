// Cached single-token decode attention over a bf16 KV pool, for sm_90a.
//
// Replaces no Pallas TPU kernel: the reference decodes with a grouped-query
// einsum (repro/models/attention.py), which XLA lowers to a dot_general that
// reads the (B, T, KH, hd) cache where it lies.  torch.einsum cannot: the
// batch dims (b, kh) of its bmm do not flatten over that layout, so it copies
// the whole K and V pool, every layer, every step, and then multiplies over
// the pool's full width.  This kernel does the einsum route's mathematics
// (repro_torch/models/attention.py, full cache, S == 1) without the copy:
// softmax(softcap(q . k * scale)) . v over the keys max(0, pos - window + 1)
// .. pos of each sequence, the keys the route's mask leaves visible.  Keys
// outside that range had weight exactly 0 there (NEG_INF = -2^30 in float32)
// and are skipped here, never read.
//
// What bounds it on an H100: bytes.  Each visible key and value row (hd bf16)
// is read once and used for G = H / KH query heads, about 2 * G flops a byte:
// far below the ~295 the card needs before its tensor cores are the limit.
// The least time is (visible K and V rows) * hd * 2 * 2 bytes / 3.35 TB/s.
// The design spends everything on streaming those bytes:
//   * flash-decoding splits along T: a block serves one (sequence, kv head,
//     split of split_keys keys).  The wrapper picks split_keys from the static
//     shapes alone (the pool's width and the sequences and kv heads it
//     holds), so the grid is the same at every step (a CUDA graph replays
//     it); blocks whose split lies wholly outside their sequence's key
//     range return at once;
//   * one block serves all G query heads of its kv head, so every key and
//     value row is read once a group;
//   * a key row is L lanes (hd / 8 rounded up to a power of two: 8 at hd 64,
//     16 at 96 and 128, 32 at 256), each loading 16 bytes through the
//     read-only path: neighbouring lanes read a row's contiguous bytes and
//     neighbouring lane groups neighbouring rows, so a warp reads whole
//     512-byte runs.  At hd 96, 4 of the 16 lanes of a row load nothing;
//   * loads in flight: each thread issues the K and V loads of R rows (8 at
//     G <= 2, 4 at G = 4, 2 at G = 8, where q and the sums take the
//     registers) before it uses any of them, up to 16 loads of 16 bytes;
//     with 4 or more 128-thread blocks resident an SM that is well over the
//     ~25 KB an SM must keep in flight to cover DRAM latency at 3.35 TB/s;
//   * scores, the online softmax (base 2: 1/sqrt(hd) * log2(e) is folded into
//     q, or log2(e) into the softcap's scale) and the weighted sum of v are
//     float32; a row's dot product crosses its L lanes by xor shuffles, so
//     every lane holds the score and the softmax state stays in registers;
//   * the block's lane groups merge through shared memory into one partial
//     (max, sum, unnormalised output) a head and split; a second small kernel
//     merges the splits of each (sequence, head) and rounds the output to
//     bf16 once.  Nothing synchronises with the host, and the wrapper
//     allocates the partials (torch.empty).
// Both products are fmaf (the library is built with --fmad=false).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "fold.cuh"

namespace {

constexpr int kThreads = 128;        // threads a split block
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const __nv_bfloat16* q;            // (B, H, hd)
  const __nv_bfloat16* k;            // row (b, t) at b * k_sb + t * k_st, (KH, hd) dense
  const __nv_bfloat16* v;
  const int* pos;                    // (B,) each sequence's query position
  __nv_bfloat16* o;                  // (B, H, hd)
  float* part_o;                     // (B, KH, splits, G, hd) unnormalised outputs
  float* part_ml;                    // (B, KH, splits, G, 2) max (base 2) and sum
  long long k_sb, k_st, v_sb, v_st;  // strides in elements
  int B, KH, G, hd, T, splits, split_keys, window;
  float qscale;                      // scale * log2(e), or scale under a softcap
  float cap2;                        // softcap * log2(e); 0: no capping
  float cap_inv;                     // 1 / softcap
};

// The keys sequence b attends: lo .. hi (empty when lo > hi).
__device__ __forceinline__ void key_range(const Args& a, int b, int& lo, int& hi) {
  const int p = a.pos[b];
  hi = min(p, a.T - 1);
  lo = a.window > 0 ? max(0, p - a.window + 1) : 0;
}

// Eight bf16 values (one 16-byte load) widened to float: a bf16 is the high
// half of its float.
__device__ __forceinline__ void widen(const uint4 u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <int G, int L, int R>
__global__ void __launch_bounds__(kThreads) decode_split(const Args a) {
  constexpr int kGroups = kThreads / L;         // key rows a block pass
  const int s = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  int lo, hi;
  key_range(a, b, lo, hi);
  const int k0 = max(lo, s * a.split_keys);
  const int k1 = min(hi + 1, (s + 1) * a.split_keys);
  if (k0 >= k1) return;                          // the whole block: no sync below is skipped

  const int j = threadIdx.x % L;                 // this lane's 8 columns: 8j .. 8j + 7
  const int grp = threadIdx.x / L;               // lane group: one key row a pass
  const bool on = j * 8 < a.hd;
  const int H = a.KH * G;

  float qf[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    uint4 u = make_uint4(0, 0, 0, 0);
    if (on) u = __ldg(reinterpret_cast<const uint4*>(
                a.q + ((size_t)b * H + (size_t)kh * G + g) * a.hd + 8 * j));
    widen(u, qf[g]);
#pragma unroll
    for (int e = 0; e < 8; ++e) qf[g][e] *= a.qscale;
  }

  float m[G], l[G], acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -FLT_MAX;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }

  const __nv_bfloat16* kb = a.k + (long long)b * a.k_sb + (long long)kh * a.hd + 8 * j;
  const __nv_bfloat16* vb = a.v + (long long)b * a.v_sb + (long long)kh * a.hd + 8 * j;

  for (int t0 = k0; t0 < k1; t0 += kGroups * R) {   // uniform over the block
    uint4 kr[R], vr[R];
    bool rv[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int t = t0 + r * kGroups + grp;
      rv[r] = t < k1;
      kr[r] = vr[r] = make_uint4(0, 0, 0, 0);
      if (rv[r] && on) {
        kr[r] = __ldg(reinterpret_cast<const uint4*>(kb + (long long)t * a.k_st));
        vr[r] = __ldg(reinterpret_cast<const uint4*>(vb + (long long)t * a.v_st));
      }
    }
    float sc[G][R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float kf[8];
      widen(kr[r], kf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) d = fmaf(qf[g][e], kf[e], d);
#pragma unroll
        for (int off = L / 2; off > 0; off /= 2) d += __shfl_xor_sync(0xffffffffu, d, off);
        if (a.cap2 != 0.f) d = a.cap2 * tanhf(d * a.cap_inv);
        sc[g][r] = d;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {                 // scores become weights in place
      float mx = m[g];
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (rv[r]) mx = fmaxf(mx, sc[g][r]);
      const float alpha = exp2f(m[g] - mx);
      m[g] = mx;
      float ps = 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        sc[g][r] = rv[r] ? exp2f(sc[g][r] - mx) : 0.f;
        ps += sc[g][r];
      }
      l[g] = fmaf(l[g], alpha, ps);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] *= alpha;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float vf[8];
      widen(vr[r], vf);
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(sc[g][r], vf[e], acc[g][e]);
    }
  }

  // merge the block's lane groups: one partial a head for this split
  __shared__ float s_acc[kGroups * G * 8 * L];
  __shared__ float s_ml[kGroups * G * 2];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (on) {
#pragma unroll
      for (int e = 0; e < 8; ++e) s_acc[(grp * G + g) * 8 * L + 8 * j + e] = acc[g][e];
    }
    if (j == 0) {
      s_ml[(grp * G + g) * 2] = m[g];
      s_ml[(grp * G + g) * 2 + 1] = l[g];
    }
  }
  __syncthreads();
  const size_t part = ((size_t)b * a.KH + kh) * a.splits + s;
  for (int i = threadIdx.x; i < G * a.hd; i += kThreads) {
    const int g = i / a.hd, d = i % a.hd;
    float mx = -FLT_MAX;
    for (int c = 0; c < kGroups; ++c) mx = fmaxf(mx, s_ml[(c * G + g) * 2]);
    float ls = 0.f, o = 0.f;
    for (int c = 0; c < kGroups; ++c) {
      const float w = exp2f(s_ml[(c * G + g) * 2] - mx);   // 0 for a group with no rows
      ls = fmaf(w, s_ml[(c * G + g) * 2 + 1], ls);
      o = fmaf(w, s_acc[(c * G + g) * 8 * L + d], o);
    }
    a.part_o[(part * G + g) * a.hd + d] = o;
    if (d == 0) {
      a.part_ml[(part * G + g) * 2] = mx;
      a.part_ml[(part * G + g) * 2 + 1] = ls;
    }
  }
}

// Merge the splits of one (sequence, query head): a block of hd threads.
__global__ void __launch_bounds__(256) decode_combine(const Args a) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int kh = h / a.G, g = h % a.G;
  int lo, hi;
  key_range(a, b, lo, hi);
  float out = 0.f;                               // a sequence with no visible key
  if (lo <= hi) {
    const size_t base = ((size_t)b * a.KH + kh) * a.splits;
    const int s0 = lo / a.split_keys, s1 = hi / a.split_keys;
    float mx = -FLT_MAX;
#pragma unroll 8
    for (int s = s0; s <= s1; ++s) mx = fmaxf(mx, a.part_ml[((base + s) * a.G + g) * 2]);
    float ls = 0.f, o = 0.f;
#pragma unroll 8                                 // loads of 8 splits in flight
    for (int s = s0; s <= s1; ++s) {
      const size_t p = (base + s) * a.G + g;
      const float w = exp2f(a.part_ml[p * 2] - mx);
      ls = fmaf(w, a.part_ml[p * 2 + 1], ls);
      o = fmaf(w, a.part_o[p * a.hd + d], o);
    }
    out = o / ls;
  }
  a.o[((size_t)b * a.KH * a.G + h) * a.hd + d] = __float2bfloat16(out);
}

template <int G, int L>
int launch_split(const Args& a, cudaStream_t stream) {
  constexpr int R = G <= 2 ? 8 : 8 / G * 2;   // rows in flight: 8, 8, 4, 2
  decode_split<G, L, R><<<dim3(a.splits, a.KH, a.B), kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int G>
int launch_group(const Args& a, cudaStream_t stream) {
  switch (a.hd) {
    case 64: return launch_split<G, 8>(a, stream);
    case 96:
    case 128: return launch_split<G, 16>(a, stream);
    case 256: return launch_split<G, 32>(a, stream);
    default: return fold::kErrBadArgs;
  }
}

}  // namespace

extern "C" {

// q (B, 1, H, hd) and o contiguous; k and v (B, T, KH, hd) with each row's
// (KH, hd) dense and the batch and row strides (elements) k_sb, k_st, v_sb,
// v_st multiples of 8; pos (B,) int32 on the device; part_o and part_ml
// float32 scratch of (B, KH, splits, G, hd) and (B, KH, splits, G, 2);
// splits = ceil(T / split_keys); G = H / KH in {1, 2, 4, 8}; hd in {64, 96, 128,
// 256}; window 0 means no band, softcap 0 no capping.
int decode_attention_bf16(const void* q, const void* k, const void* v, const void* pos, void* o,
                          void* part_o, void* part_ml, int B, int H, int KH, int hd, int T,
                          int splits, int split_keys, long long k_sb, long long k_st, long long v_sb,
                          long long v_st, int window, float scale, float softcap, void* stream) {
  if (B <= 0 || B > 65535 || KH <= 0 || KH > 65535 || H <= 0 || H > 65535 || H % KH != 0 ||
      T <= 0 || split_keys <= 0 || splits != (T + split_keys - 1) / split_keys || window < 0 ||
      softcap < 0.f ||
      q == nullptr || k == nullptr || v == nullptr || pos == nullptr || o == nullptr ||
      part_o == nullptr || part_ml == nullptr ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16 != 0 ||
      (k_sb | k_st | v_sb | v_st) % 8 != 0)
    return fold::kErrBadArgs;
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.pos = static_cast<const int*>(pos);
  a.o = static_cast<__nv_bfloat16*>(o);
  a.part_o = static_cast<float*>(part_o);
  a.part_ml = static_cast<float*>(part_ml);
  a.k_sb = k_sb;
  a.k_st = k_st;
  a.v_sb = v_sb;
  a.v_st = v_st;
  a.B = B;
  a.KH = KH;
  a.G = H / KH;
  a.hd = hd;
  a.T = T;
  a.splits = splits;
  a.split_keys = split_keys;
  a.window = window;
  a.qscale = softcap > 0.f ? scale : scale * kLog2e;
  a.cap2 = softcap > 0.f ? softcap * kLog2e : 0.f;
  a.cap_inv = softcap > 0.f ? 1.f / softcap : 0.f;
  cudaStream_t st = (cudaStream_t)stream;
  int rc;
  switch (a.G) {
    case 1: rc = launch_group<1>(a, st); break;
    case 2: rc = launch_group<2>(a, st); break;
    case 4: rc = launch_group<4>(a, st); break;
    case 8: rc = launch_group<8>(a, st); break;
    default: return fold::kErrBadArgs;
  }
  if (rc != 0) return rc;
  decode_combine<<<dim3(H, B), hd, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
