// Flash sliding-window attention on Hopper's tensor cores (bf16), for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/swa_attention.py::_swa_kernel
// on the bfloat16 route at head_dim 64, 96, 128 and 256 (swa_attention.cu
// keeps float32, and bfloat16 at the test-size head dims 16 and 32):
// softmax(softcap(q k^T * scale) + band mask) v for one (128-row q block,
// query head) per CTA, with the running max m, sum l and the output
// accumulator in float32, kv head = query head / G (GQA), masked scores at
// -2^30 as in the reference.
//
// What bounds it on an H100: operations.  At gemma2-9b's shape (S 8192, hd
// 256, 16 heads) a global layer is 550 GFLOP of q.k and p.v against ~0.2 GB
// of q, k, v and o; only wgmma reaches the bf16 tensor-core rate.  Design:
//   * 256 threads = two consumer warpgroups of 64 q rows each; the grid's x
//     runs over q blocks from the last (most kv tiles) to the first;
//   * TMA brings q once, and 64-row k and v tiles into two-slot rings of
//     128-byte-swizzled 64-column panels (an hd 256 row is 4 panels),
//     completing on mbarriers (full: transaction bytes; empty: all 256
//     threads arrive once their products have read the slot); thread 0
//     refills both rings at the start of each phase; rows past S are
//     zero-filled by TMA and masked by position;
//   * only the tiles in [max(0, q0 - window + 1), q_last] are visited; a
//     warpgroup skips a tile none of its rows can see, and applies the
//     element mask only on tiles that straddle the diagonal, the band's
//     lower edge or S;
//   * S = Q K^T: wgmma m64n64k16, both operands K-major in shared memory,
//     hd/16 k-steps, float32 accumulators; then the scale 1/sqrt(hd) and
//     the softcap (t = tanhf(s * scale / cap), accurate tanhf, the capped
//     score being cap * t), mask, online softmax with m kept on t's scale
//     and p = 2^((t - m) * cap * log2(e)), all in float32 (within a few
//     float32 ulps of the plain version's cap * tanh(s / cap) and exp);
//   * O += P V: wgmma m64n{hd}k16 with P from registers (the S accumulator
//     fragment is the A fragment once pairs are packed to bf16) and V read
//     MN-major (transposed) from shared memory.  P goes in as two bf16
//     parts, P_hi = bf16(P) and P_lo = bf16(P - P_hi), both into the same
//     accumulator: P_hi alone would add an error of the size of one bf16 ulp
//     of the output, the split keeps ~16 bits of P for 1.5x the tensor-core
//     work of a plain flash kernel;
//   * each warpgroup issues S_j and P_{j-1} V_{j-1} in one phase, then runs
//     the softmax of S_j (at hd <= 128 while P V is still in flight) as the
//     tensor cores take the other warpgroup's phase: the two take turns
//     (ping-pong, two named barriers), so one's softmax can hide behind the
//     other's products;
//   * the output is O / max(l, 1e-30) rounded once to bf16;
//   * head_dim 96 runs in the hd-128 layout, padded in shared memory and
//     not in HBM: the tensor maps carry the true width (96 columns, rows
//     of 192 bytes), so TMA zero-fills columns 96-127 of the second panel
//     (the barrier still counts the whole box, as for rows past S); S
//     takes the 6 k-steps of the real columns, P V runs at N = 128 over
//     the zero columns (4/3 of a native hd 96's P V work, on the hd-128
//     path's descriptors, ping-pong and overlap), and the store writes
//     the first 96 columns.
// The tensor maps are encoded on the host per launch by
// cuTensorMapEncodeTiled, looked up with cudaGetDriverEntryPointByVersion
// (no libcuda link).  A producer warp with setmaxnreg is later work.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fold.cuh"

namespace {

constexpr int kBQ = 128;        // q rows per CTA: two warpgroups of 64
constexpr int kBK = 64;         // kv rows per tile
constexpr int kPanel = 64;      // bf16 columns in one 128-byte swizzled panel
constexpr int kThreads = 256;
constexpr int kStages = 2;
// Head dims up to this one run the softmax of S_j while P_{j-1} V_{j-1} is
// still in flight (its P and O registers stay live across the softmax); at
// hd 256 that needs more than 255 registers, so it waits for both first.
constexpr int kOverlapMaxHd = 128;
constexpr float kNegInf = -1073741824.0f;  // -2^30, NEG_INF of the reference

// Shared memory: q (hd/64 panels of kBQ rows), the k ring and the v ring
// (kStages tiles of hd/64 panels of kBK rows each), then the barriers.
template <int HD>
struct Layout {
  static constexpr int kPanels = HD / kPanel;
  static constexpr uint32_t kQPanel = kBQ * 128, kKPanel = kBK * 128;
  static constexpr uint32_t kQBytes = kPanels * kQPanel;
  static constexpr uint32_t kTileBytes = kPanels * kKPanel;  // one k or v tile
  static constexpr uint32_t kBars = kQBytes + 2 * kStages * kTileBytes;
  static constexpr size_t kBytes = kBars + 128 + 1024;  // + barriers, alignment slack
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One box of the 3-d map (hd, S, rows) into shared memory, completing on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int col,
                                         int row, int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row), "r"(head)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// byte offset (MN-major: the next 64-column panel; unused K-major) and
// stride byte offset (the next group of 8 rows), all in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from touching wgmma registers across the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]; A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] B[16 x 64]; A in registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D[64 x 128] += A[64 x 16] B[16 x 128]; A in registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D[64 x 256] += A[64 x 16] B[16 x 256]; A in registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
      "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
      "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
      "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
      "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
      "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
      "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
      "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
      "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (HD == 64) wgmma_rs_n64(o, a, db, 1);
  else if constexpr (HD == 128) wgmma_rs_n128(o, a, db, 1);
  else wgmma_rs_n256(o, a, db, 1);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// 2^x to two float32 ulps (ex2.approx, as exp2f) for every x whose result
// is a normal float; results below 2^-126 flush to zero, which p and alpha
// can afford (the plain version's exp gives them as ~1e-38 or less).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// One 64-row k or v tile (kv rows k0 .. k0 + 63, all hd/64 panels) into dst.
template <int HD>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t full,
                                          int k0, int kvh) {
  using L = Layout<HD>;
  mbar_expect_tx(full, L::kTileBytes);
#pragma unroll
  for (int p = 0; p < L::kPanels; ++p) tma_load(dst + p * L::kKPanel, map, full, p * kPanel, k0, kvh);
}

// Named barriers 1 and 2: warpgroup 0's and warpgroup 1's turn to issue
// their products (bar.sync by the one whose turn it is, bar.arrive by the
// other; 256 threads each).
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
}

// S_j = Q K_j^T for this warpgroup's 64 rows: GHD/16 k-steps over the
// 64-column panels of q (kBQ rows) and k (kBK rows); columns past GHD are
// the layout's zero padding and are skipped.
template <int HD, int GHD>
__device__ __forceinline__ void issue_s(float (&sc)[32], uint32_t q_wg, uint32_t kb) {
  using L = Layout<HD>;
#pragma unroll
  for (int kk = 0; kk < GHD / 16; ++kk) {
    const uint32_t col = (kk & 3) * 32;  // 16 columns = 32 bytes into the panel
    wgmma_ss_n64(sc, sw128_desc(q_wg + (kk >> 2) * L::kQPanel + col, 16, 1024),
                 sw128_desc(kb + (kk >> 2) * L::kKPanel + col, 16, 1024), kk > 0);
  }
}

// O += P_hi V + P_lo V: 16 kv rows (2 KB of each panel) per k-step.
template <int HD>
__device__ __forceinline__ void issue_pv(float (&acc)[HD / 2], const uint32_t (&p_hi)[4][4],
                                         const uint32_t (&p_lo)[4][4], uint32_t vb) {
  using L = Layout<HD>;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_pv<HD>(acc, p_hi[kk], sw128_desc(vb + kk * 2048, L::kKPanel, 1024));
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_pv<HD>(acc, p_lo[kk], sw128_desc(vb + kk * 2048, L::kKPanel, 1024));
}

// HD is the shared-memory layout's head dim (64, 128 or 256), GHD the
// tensors' (HD, or 96 in the hd-128 layout).  Maps: q (GHD, S, bh), k and v
// (GHD, S, bh / group), boxes of 64 columns by kBQ (q) or kBK (k, v) rows;
// o: (bh, S, GHD) row-major.
//
// Phase j of a warpgroup (j = 0 .. n_tiles) issues S_j = Q K_j^T (j <
// n_tiles) and O += P_{j-1} V_{j-1} (j > 0) together, then computes the
// softmax of S_j (see kOverlapMaxHd) while the tensor cores serve the other
// warpgroup's phase (the two take turns at issuing: ping-pong).  So k tile
// j is free after phase j and v tile j after phase j + 1: k and v have
// rings of their own, and thread 0 refills both at the start of its phase
// with slots the previous phase freed.  The first and last phases are
// peeled so that every wgmma is issued unconditionally (under a branch
// ptxas serializes them); a tile none of a warpgroup's rows can see gets
// P = 0.
template <int HD, int GHD>
__global__ void __launch_bounds__(kThreads, 1)
swa_wgmma_kernel(__grid_constant__ const CUtensorMap tq, __grid_constant__ const CUtensorMap tk,
                 __grid_constant__ const CUtensorMap tv, __nv_bfloat16* __restrict__ o, int S,
                 int group, int window, int causal, float scale, float cap) {
  using L = Layout<HD>;
  constexpr bool kOverlap = HD <= kOverlapMaxHd;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle atoms are 1024 bytes and must start 1024-aligned
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base, sk = base + L::kQBytes, sv = sk + kStages * L::kTileBytes;
  const uint32_t bars = base + L::kBars;  // k full, v full, k empty, v empty (kStages each), q
  const uint32_t kfull = bars, vfull = bars + 8 * kStages, kempty = bars + 16 * kStages,
                 vempty = bars + 24 * kStages, qbar = bars + 32 * kStages;

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int nq = (S + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kBQ;
  const int bh = blockIdx.y, kvh = bh / group;
  const int q_last = min(q0 + kBQ, S) - 1;
  const int t_lo = (window > 0 ? max(0, q0 - window + 1) : 0) / kBK;
  const int n_tiles = (causal ? q_last : S - 1) / kBK - t_lo + 1;

  // this warpgroup's rows, the keys any of them can see, and this thread's
  // two rows (row0, row0 + 8) and first column in each 8-column block
  const int r_lo = q0 + 64 * wg, r_hi = min(r_lo + 63, S - 1);
  const bool has_rows = r_lo < S;
  const int w_lo = window > 0 ? max(0, r_lo - window + 1) : 0;
  const int w_hi = causal ? r_hi : S - 1;
  const int row0 = r_lo + 16 * warp + (lane >> 2), col0 = 2 * (lane & 3);
  // scores in float32: t = s * scale, or tanhf(s * scale / cap) with a
  // softcap, whose capped score is cap * t; m is kept on t's scale and
  // p = 2^((t - m) * t_to_log2), t_to_log2 = cap * log2(e) (or log2(e))
  const float cap_abs = fabsf(cap);
  const float s_to_t = cap != 0.0f ? scale / cap_abs : scale;
  const float t_to_log2 = (cap != 0.0f ? cap_abs : 1.0f) * 1.4426950408889634f;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(kfull + 8 * s, 1);  // the loader's arrive + the tile's bytes
      mbar_init(vfull + 8 * s, 1);
      mbar_init(kempty + 8 * s, kThreads);  // every consumer thread
      mbar_init(vempty + 8 * s, kThreads);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(qbar, L::kQBytes);
#pragma unroll
    for (int p = 0; p < L::kPanels; ++p) tma_load(sq + p * L::kQPanel, &tq, qbar, p * kPanel, q0, bh);
    load_tile<HD>(sk, &tk, kfull, t_lo * kBK, kvh);
  }
  if (wg == 1) turn_pass(wg);  // warpgroup 0 issues first

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.0f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;
  float sc[32];
  uint32_t p_hi[4][4], p_lo[4][4];  // P of the previous tile, as bf16 A fragments
  const uint32_t q_wg = sq + wg * 64 * 128;  // this warpgroup's rows in each q panel

  // thread 0, at the start of phase j < n_tiles: k tile j + 1 into the
  // slot of tile j - 1 and v tile j into the slot of tile j - 2, both
  // freed by phase j - 1; then every thread waits for k tile j and v tile
  // j - 1
  auto refill_and_wait = [&](int j) {
    if (tid == 0 && j < n_tiles) {
      const int k0 = (t_lo + j) * kBK, ks = j % kStages, ns = (j + 1) % kStages;
      if (j + 1 < n_tiles) {
        if (j >= 1) mbar_wait(kempty + 8 * ns, ((j + 1) / kStages + 1) & 1);
        load_tile<HD>(sk + ns * L::kTileBytes, &tk, kfull + 8 * ns, k0 + kBK, kvh);
      }
      if (j >= kStages) mbar_wait(vempty + 8 * ks, (j / kStages + 1) & 1);
      load_tile<HD>(sv + ks * L::kTileBytes, &tv, vfull + 8 * ks, k0, kvh);
    }
    __syncwarp();
    if (j < n_tiles) mbar_wait(kfull + 8 * (j % kStages), (j / kStages) & 1);
    if (j > 0) mbar_wait(vfull + 8 * ((j - 1) % kStages), ((j - 1) / kStages) & 1);
    __syncwarp();
  };

  // the online softmax of S_j (in sc) into unnormalised probabilities
  // (in sc), updating m and l; returns the rows' rescale factors
  auto softmax = [&](int j, float& alpha0, float& alpha1) {
    const int k0 = (t_lo + j) * kBK;
    alpha0 = alpha1 = 1.0f;
    if (!(has_rows && k0 + kBK - 1 >= w_lo && k0 <= w_hi)) {  // no row sees this tile
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
      return;
    }
    // scale, softcap, mask (only on tiles that need it), row max
    const bool masked = k0 + kBK > S || (causal && k0 + kBK - 1 > r_lo) ||
                        (window > 0 && k0 <= r_hi - window);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = sc[i] * s_to_t;
      if (cap != 0.0f) x = tanhf(x);
      if (masked) {
        const int qp = row0 + 8 * ((i >> 1) & 1), kp = k0 + 8 * (i >> 2) + col0 + (i & 1);
        bool ok = kp < S;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && kp > qp - window;
        x = ok ? x : kNegInf;
      }
      sc[i] = x;
      if (i & 2) mx1 = fmaxf(mx1, x);
      else mx0 = fmaxf(mx0, x);
    }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    alpha0 = exp2_ftz((m0 - mn0) * t_to_log2);
    alpha1 = exp2_ftz((m1 - mn1) * t_to_log2);
    float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (i & 2) {
        sc[i] = exp2_ftz((sc[i] - mn1) * t_to_log2);
        rs1 += sc[i];
      } else {
        sc[i] = exp2_ftz((sc[i] - mn0) * t_to_log2);
        rs0 += sc[i];
      }
    }
    l0 = alpha0 * l0 + quad_sum(rs0);
    l1 = alpha1 * l1 + quad_sum(rs1);
    m0 = mn0;
    m1 = mn1;
  };

  // rescale O (skipped when no row of the warp moved its max) and pack P:
  // k-step kk takes the score columns 16 kk .. 16 kk + 15, register r the
  // pair sc[8 kk + 2 r, + 1], as hi and lo bf16 parts
  auto rescale_and_pack = [&](float alpha0, float alpha1) {
    if (__any_sync(0xffffffffu, alpha0 != 1.0f || alpha1 != 1.0f)) {
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] *= (i & 2) ? alpha1 : alpha0;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x = sc[8 * kk + 2 * r], y = sc[8 * kk + 2 * r + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x, y);
        p_hi[kk][r] = bf16x2_bits(hi);
        p_lo[kk][r] = bf16x2_bits(__floats2bfloat162_rn(x - __low2float(hi), y - __high2float(hi)));
      }
  };

  mbar_wait(qbar, 0);
  float alpha0, alpha1;
  // phase 0: S_0 alone
  refill_and_wait(0);
  turn_wait(wg);
  wgmma_fence();
  issue_s<HD, GHD>(sc, q_wg, sk);
  wgmma_commit();
  turn_pass(wg);
  wgmma_wait<0>();
  fence_regs(sc);
  mbar_arrive(kempty);
  softmax(0, alpha0, alpha1);
  rescale_and_pack(alpha0, alpha1);
  // phases 1 .. n_tiles - 1: S_j with P_{j-1} V_{j-1}
  for (int j = 1; j < n_tiles; ++j) {
    refill_and_wait(j);
    const uint32_t kb = sk + (j % kStages) * L::kTileBytes, vb = sv + ((j - 1) % kStages) * L::kTileBytes;
    turn_wait(wg);
    wgmma_fence();
    issue_s<HD, GHD>(sc, q_wg, kb);
    wgmma_commit();
    issue_pv<HD>(acc, p_hi, p_lo, vb);
    wgmma_commit();
    turn_pass(wg);
    if constexpr (kOverlap) {
      wgmma_wait<1>();
      fence_regs(sc);
      mbar_arrive(kempty + 8 * (j % kStages));  // S_j has read k tile j
      softmax(j, alpha0, alpha1);
    }
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(acc);
    fence_regs(p_hi);
    fence_regs(p_lo);
    if constexpr (!kOverlap) mbar_arrive(kempty + 8 * (j % kStages));
    mbar_arrive(vempty + 8 * ((j - 1) % kStages));  // P V has read v tile j - 1
    if constexpr (!kOverlap) softmax(j, alpha0, alpha1);
    rescale_and_pack(alpha0, alpha1);
  }
  // phase n_tiles: P_{n-1} V_{n-1} alone; warpgroup 1 passes no turn after
  // its last phase, which balances its first pass
  refill_and_wait(n_tiles);
  turn_wait(wg);
  wgmma_fence();
  issue_pv<HD>(acc, p_hi, p_lo, sv + ((n_tiles - 1) % kStages) * L::kTileBytes);
  wgmma_commit();
  if (wg == 0) turn_pass(wg);
  wgmma_wait<0>();
  fence_regs(acc);

  if (!has_rows) return;
  const float li0 = fmaxf(l0, 1e-30f), li1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* dst = o + (long long)bh * S * GHD;
#pragma unroll
  for (int n = 0; n < GHD / 8; ++n) {
    const int c = 8 * n + col0;
    if (row0 < S)
      *reinterpret_cast<__nv_bfloat162*>(dst + (long long)row0 * GHD + c) =
          __floats2bfloat162_rn(acc[4 * n] / li0, acc[4 * n + 1] / li0);
    if (row0 + 8 < S)
      *reinterpret_cast<__nv_bfloat162*>(dst + (long long)(row0 + 8) * GHD + c) =
          __floats2bfloat162_rn(acc[4 * n + 2] / li1, acc[4 * n + 3] / li1);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (rows, S, hd) bf16 as a 3-d map with boxes of 64 columns by box_rows rows,
// 128-byte swizzle; out-of-range rows, and columns past hd (hd 96's second
// panel), read as zeros.
int encode(CUtensorMap* map, const void* ptr, int rows, int S, int hd, int box_rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return fold::kErrTensorMap;
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)S, (cuuint64_t)rows};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * 2, (cuuint64_t)S * hd * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kPanel, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : fold::kErrTensorMap;
}

struct Args {
  const void *q, *k, *v;
  void* o;
  int bh, bkh, S, window, causal;
  float scale, cap;
  cudaStream_t stream;
};

template <int HD, int GHD = HD>
int launch(const Args& a) {
  CUtensorMap tq, tk, tv;
  int rc = encode(&tq, a.q, a.bh, a.S, GHD, kBQ);
  if (rc == 0) rc = encode(&tk, a.k, a.bkh, a.S, GHD, kBK);
  if (rc == 0) rc = encode(&tv, a.v, a.bkh, a.S, GHD, kBK);
  if (rc != 0) return rc;
  const size_t bytes = Layout<HD>::kBytes;
  auto kernel = swa_wgmma_kernel<HD, GHD>;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  if (bytes > (size_t)optin) return fold::kErrSharedMemory;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.S + kBQ - 1) / kBQ, a.bh);
  kernel<<<grid, kThreads, bytes, a.stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(a.o), a.S,
                                              a.bh / a.bkh, a.window, a.causal, a.scale, a.cap);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The bf16 tensor-core route of swa_attention_fwd (swa_attention.cu): bh =
// B*H query rows of (S, hd) and bkh = B*KH kv rows, hd in {64, 96, 128, 256},
// all contiguous and 16-byte aligned; o has q's shape.  window 0 means no
// band, causal 0 no causal mask, softcap 0 no capping.
int swa_attention_wgmma(int hd, const void* q, const void* k, const void* v, void* o, int bh,
                        int bkh, int S, int window, int causal, float scale, float softcap,
                        void* stream) {
  if (bh <= 0 || bkh <= 0 || bh % bkh != 0 || bh > 65535 || S <= 0 || window < 0 ||
      q == nullptr || k == nullptr || v == nullptr || o == nullptr ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16 != 0)
    return fold::kErrBadArgs;
  const Args a{q, k, v, o, bh, bkh, S, window, causal != 0, scale, softcap, (cudaStream_t)stream};
  switch (hd) {
    case 64: return launch<64>(a);
    case 96: return launch<128, 96>(a);
    case 128: return launch<128>(a);
    case 256: return launch<256>(a);
    default: return fold::kErrBadArgs;
  }
}

}  // extern "C"
