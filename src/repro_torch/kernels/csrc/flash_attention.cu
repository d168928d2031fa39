// flash_attention: the forward pass of softmax attention with an online
// softmax, causal or not, one CTA per (query tile, batch, head).
//
//   o[b,h,i,:] = sum_j softmax_j(q[b,h,i,:] . k[b,kv,j,:] / sqrt(hd)) v[b,kv,j,:]
//   with kv = h / (H / KV) (grouped-query heads share a KV head), keys j >= S
//   masked, and under causal masking keys j > i masked.
//
// Replaces the Pallas kernel flash_attention (src/repro/kernels/flash_attention.py:64,
// body _flash_kernel :21): the attention of every layer of an LM prefill.  Its
// arithmetic is the Pallas kernel's: scores in f32 times 1/sqrt(hd), masked
// scores dropped, a running row max m, denominator l and f32 accumulator per
// query row, the probabilities rounded to v's type before the P.V product
// (accumulated in f32), l floored at 1e-30 at the end, the output in q's type.
//
// Bound by operations on the H100: 4 flops per (query, key) pair kept (two
// products of hd-long rows), 825 GFLOP at the serving prefill's shape (q
// (4, 48, 4096, 128), k and v (4, 8, 4096, 128), causal), 0.834 ms at the
// dense bf16 peak, against 2 * hd bytes per key row shared by a whole tile of
// query rows.  So the tensor cores set the pace, and the bf16 kernel is built
// to keep them fed:
//   * one CTA per (128-row query tile, b, h), 3 warpgroups: a producer whose
//     one elected thread issues TMA copies (its warpgroup gives up registers
//     with setmaxnreg.dec), and two consumers of 64 query rows each (which
//     take them with setmaxnreg.inc);
//   * TMA brings Q once and K and V tiles of 128 keys (64 at hd 256, see
//     Tile) into a ring of STAGES shared-memory stages; K and V of each stage have a full mbarrier (the
//     copy's bytes have landed) and a free one (all 8 consumer warps are done
//     with it: K once its scores have landed, V once its P.V has), so the
//     copies of the next tiles overlap this tile's products.  The tensor
//     maps are 4-D (hd, S, heads, B) over each tensor's own strides, built on
//     the host per launch, so the model's transposed (B, S, heads, hd)
//     projections are read in place; rows past S arrive as zeros (TMA's
//     out-of-bounds fill) and keys past S are still masked, since a zero key
//     scores 0, not -inf.  Rows arrive in the 128-byte swizzle
//     (64 bytes at hd 32: the span is min(2 hd, 128) bytes, one TMA box of
//     that width per slice of hd) that wgmma reads without bank conflicts;
//   * S = Q.K^T with wgmma.mma_async (both from shared memory, K-major) into
//     f32 registers; the softmax in registers (a row's max over the 4 lanes
//     that share it, its sum kept per lane until the end); O += P.V with
//     wgmma from registers: the f32 score fragment is the bf16 A fragment of
//     the next product, so P needs no shuffle, and V is read MN-major through
//     the transpose bit;
//   * the softmax is taken off the tensor cores' critical path twice over:
//     a consumer issues tile j's S = Q.K^T, rescales O by tile j-1's factor
//     while it runs, issues tile j-1's P.V and computes tile j's softmax
//     while P.V runs; and the two consumers take turns (named barriers) to
//     issue their products, so one's softmax runs while the other's products
//     do.  That keeps S, O and P live at once, ~184 registers a thread, which
//     the consumers' setmaxnreg.inc allows; the mbarrier waits spin with no
//     timeout, since a trap in the wait loop made ptxas spill and serialize
//     the wgmmas;
//   * under causal masking the KV tiles wholly above the diagonal are skipped
//     (the Pallas kernel computes them and masks every score: they add exactly
//     0 to l and the accumulator), only the tiles that cross the diagonal or S
//     apply the mask, and the grid (1-D over query tiles and b * h, so B * H
//     is not limited) launches the longest query tiles first so the short ones
//     fill the tail.  The tiles a query tile reads come from kv_tiles, which
//     the producer and the consumers both call: two ranges that differed
//     would deadlock the pipeline;
//   * exp2 with log2(e) folded into the scale, one FFMA and one MUFU.EX2 per
//     probability, moves each probability by about an f32 ulp against exp of
//     the scaled score; a masked score is -inf and adds exactly 0, as the
//     Pallas kernel's -1e30 does once a row has met a live key (every row
//     that is written has: key 0, or its own position, is live); the output
//     is o times one reciprocal of l per row, within an f32 ulp of o / l
//     before its rounding to bf16.
// At hd 256 (gemma-7b) a consumer thread holds 128 f32 of O beside 32 of S
// and 16 b32 of P, within the 240 registers setmaxnreg.inc gives it; S is a
// 64 x 64 wgmma per k16 step and P . V one 64 x 256 wgmma per 16 keys.
// The f32 kernel (no tensor-core type keeps f32's precision: TF32 keeps ~3
// digits) runs on the CUDA cores: hd/32 threads per query row, each owning
// 32 of its dims in 16-byte chunks, a shuffle sum per score, KV tiles staged
// in shared memory by all threads; 2-D grid (q tile, b * h), so B * H is at
// most 65535 there.
//
// Both read q, k, v and write o through their strides (the last dim
// contiguous), so the output goes straight into the (B, S, H, hd) layout the
// output projection reads: no transposing copy on either side.
//
// The mbarrier and TMA helpers and the driver's tensor-map encoder come from
// hopper_async.cuh, which ssd_intra_chunk.cu shares.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "hopper_async.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  // element strides (batch, head, position) of q, k, v, o; the dim stride is 1
  int64_t qs[3], ks[3], vs[3], os[3];
  int H, KV, S, causal;
  float scale;
};

// The number of KV tiles of bk keys that the query tile of bq rows at q0
// reads, tiles 0 .. n - 1: every tile that holds a key below S and, under
// causal masking, a key at or before the query tile's last row.  Both
// kernels take their range from it; in the bf16 kernel the producer and the
// consumers both loop over it.
__device__ __forceinline__ int kv_tiles(int S, int causal, int q0, int bq,
                                        int bk) {
  int n = (S + bk - 1) / bk;
  if (causal) n = min(n, (q0 + bq - 1) / bk + 1);
  return n;
}

// ---- bf16: TMA and wgmma, warp-specialised ----------------------------------

constexpr int BQ = 128;       // query rows per CTA, 64 per consumer warpgroup
constexpr int STAGES = 2;     // K and V tiles in flight
constexpr int THREADS = 384;  // producer warpgroup, then two consumers
constexpr int CONSUMER_WARPS = 8;
constexpr float LOG2E = 1.4426950408889634f;

// keys per KV tile: 128, or 64 at hd 256, where Q (64 KB) and two stages of
// K and V tiles of 128 keys (256 KB) would not fit the 227 KB of a block and
// each consumer thread already holds 128 f32 of O
template <int HD>
struct Tile {
  static constexpr int BK = HD == 256 ? 64 : 128;
  static constexpr int SW = HD >= 64 ? 128 : 2 * HD;  // swizzle span, bytes
  static constexpr int CB = SW / 2;        // columns of one TMA box
  static constexpr int BOXES = HD / CB;    // boxes across hd
  static constexpr int KPB = CB / 16;      // k16 steps of one box
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;
  // Q, then K of each stage, then V of each stage, then the mbarriers; the
  // base is rounded up to 1024 bytes, the swizzle's period
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 4 * STAGES) + 1024;
};

struct TileArgs {
  void* o;
  int64_t os[3];   // o's element strides (batch, head, position)
  int H, group;    // query heads, and query heads per KV head
  int S, causal;
  int n_bh;        // B * H
  float scale_log2;  // 1/sqrt(hd) * log2(e)
};

// A wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle mode (bits 62-63: 1 for 128
// bytes, 2 for 64).  SBO is the step between 8-row groups (8 rows of SW
// bytes).  LBO is unused for K-major operands (set to 1); for the MN-major V
// it is the step between SW-byte column slices, one TMA box apart.
template <int SW>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo) {
  constexpr uint64_t mode = SW == 128 ? 1 : 2;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(8 * SW >> 4) << 32 | mode << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N of this warpgroup's commit groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the points where it issues and completes.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64 x 128 f32) = A . B, or d += A . B when `accumulate`: A 64 x 16 and
// B 128 x 16 both K-major in shared memory, addressed by descriptors
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64 f32) = A . B, or d += A . B when `accumulate`: the scores of a
// tile of 64 keys (head dim 256), A and B as for wgmma_ss_n128
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 256 f32) += A . B: head dim 256's P . V, A and B as for
// wgmma_rs_n128
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]),
        "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]),
        "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]),
        "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]),
        "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]),
        "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x N f32) += A . B: A 64 x 16 bf16 from registers (the A fragment:
// four b32 of bf16 pairs), B 16 x N MN-major in shared memory (the
// descriptor's transpose bit set)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// 2^x in one MUFU.EX2 (results below 2^-126 flush to 0, a probability that
// bf16 rounding and the f32 sums would not see)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// The two consumer warpgroups take turns on the tensor cores: c waits for its
// turn on named barrier 1 + c before it issues its products, and passes the
// turn to the other with an arrival on the other's barrier after, so one's
// products run while the other computes its softmax.
__device__ __forceinline__ void turn_wait(int c) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + c) : "memory");
}

__device__ __forceinline__ void turn_pass(int c) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - c) : "memory");
}

// Fragment layout of a wgmma m64nN f32 accumulator (warp w of the warpgroup,
// lane = 4 * g + t): element 4i + e is row 16w + g + 8 (e >> 1), column
// 8i + 2t + (e & 1).  Packed to bf16 pairs, elements 8kk .. 8kk + 7 are the
// A fragment of the k16 step kk (rows g, g + 8; columns 2t, 2t + 8), so the
// scores become P's A operand where they lie.

// Issues s = Q . K^T for a consumer's 64 query rows (Q at q_rows) and the
// BK keys of the tile at k_tile, as one commit group.  A k16 step moves 32
// bytes along a row inside a box of SW-byte rows, and a box along hd.
template <int HD>
__device__ __forceinline__ void issue_scores(float (&s)[Tile<HD>::BK / 2],
                                             uint32_t q_rows,
                                             uint32_t k_tile) {
  using T = Tile<HD>;
  const uint64_t dq = smem_desc<T::SW>(q_rows, 16);
  const uint64_t dk = smem_desc<T::SW>(k_tile, 16);
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t koff = (kk % T::KPB) * 32;  // 16 columns of bf16
    const uint64_t da = dq + ((kk / T::KPB * BQ * T::SW + koff) >> 4);
    const uint64_t db = dk + ((kk / T::KPB * T::BK * T::SW + koff) >> 4);
    if constexpr (T::BK == 128)
      wgmma_ss_n128(s, da, db, kk > 0);
    else
      wgmma_ss_n64(s, da, db, kk > 0);
  }
  wgmma_commit();
}

// Issues o += P . V for the BK keys of the tile at v_tile (MN-major: the
// descriptor's LBO steps from one box of hd columns to the next), as one
// commit group.
template <int HD>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2],
                                         uint32_t (&p)[Tile<HD>::BK / 4],
                                         uint32_t v_tile) {
  using T = Tile<HD>;
  const uint64_t dv = smem_desc<T::SW>(v_tile, T::BK * T::SW);
  fence_regs(o);
  fence_regs(p);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < T::BK / 16; ++kk) {
    const uint32_t pa[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                            p[4 * kk + 3]};
    const uint64_t db = dv + ((kk * 16 * T::SW) >> 4);  // 16 keys on
    if constexpr (HD == 256)
      wgmma_rs_n256(o, pa, db);
    else if constexpr (HD == 128)
      wgmma_rs_n128(o, pa, db);
    else if constexpr (HD == 64)
      wgmma_rs_n64(o, pa, db);
    else
      wgmma_rs_n32(o, pa, db);
  }
  wgmma_commit();
}

// One tile's online softmax, in place: masks s where the tile holds keys
// past S or above a row's diagonal, raises the running max m (of the raw
// scores; a row's 4 lanes share it), scales this lane's share of the
// denominator l, leaves the probabilities exp2(s c - m c), c = scale
// log2(e), in s and their sum in l, and returns in corr the factor that
// rescales the accumulator.  BK: the keys of the tile.
template <int BK>
__device__ __forceinline__ void online_softmax(float (&s)[BK / 2],
                                               float (&m)[2], float (&l)[2],
                                               float (&corr)[2],
                                               const TileArgs& a, int k0,
                                               int q0, int row0, int t) {
  if (k0 + BK > a.S || (a.causal && k0 + BK - 1 > q0)) {
#pragma unroll
    for (int i = 0; i < BK / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * i + 2 * t + (e & 1);
        const int row = row0 + 8 * (e >> 1);
        if (key >= a.S || (a.causal && key > row))
          s[4 * i + e] = -CUDART_INF_F;
      }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < BK / 8; ++i) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * i], s[4 * i + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * i + 2], s[4 * i + 3]));
  }
  float off[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    mx[j] = fmaxf(mx[j], __shfl_xor_sync(FULL, mx[j], 1));
    mx[j] = fmaxf(mx[j], __shfl_xor_sync(FULL, mx[j], 2));
    // a row with no live key yet keeps max -inf: its probabilities are 0
    off[j] = mx[j] == -CUDART_INF_F ? 0.f : mx[j] * a.scale_log2;
    corr[j] = ex2(m[j] * a.scale_log2 - off[j]);
    m[j] = mx[j];
    l[j] *= corr[j];
  }
#pragma unroll
  for (int i = 0; i < BK / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * i + e] = ex2(fmaf(s[4 * i + e], a.scale_log2, -off[e >> 1]));
      l[e >> 1] += s[4 * i + e];
    }
}

// P, the probabilities rounded to bf16, as the A fragments of P . V
template <int BK>
__device__ __forceinline__ void to_bf16(const float (&s)[BK / 2],
                                        uint32_t (&p)[BK / 4]) {
#pragma unroll
  for (int i = 0; i < BK / 4; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const TileArgs a) {
  using T = Tile<HD>;
  constexpr int BK = T::BK;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) &
      ~1023u;
  const uint32_t q_s = base;
  const uint32_t bar = base + T::BAR_OFF;
  const uint32_t q_full = bar;
  auto k_s = [&](int st) { return base + T::K_OFF + st * T::KV_BYTES; };
  auto v_s = [&](int st) { return base + T::V_OFF + st * T::KV_BYTES; };
  // per stage: K and V have landed; both consumers are done with K, with V
  auto k_full = [&](int st) { return bar + 8 * (1 + st); };
  auto v_full = [&](int st) { return bar + 8 * (1 + STAGES + st); };
  auto k_free = [&](int st) { return bar + 8 * (1 + 2 * STAGES + st); };
  auto v_free = [&](int st) { return bar + 8 * (1 + 3 * STAGES + st); };

  // longest query tiles first: the first B * H CTAs take the last tile
  const int n_qt = (a.S + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / a.n_bh) * BQ;
  const int bh = static_cast<int>(blockIdx.x) % a.n_bh;
  const int b = bh / a.H, h = bh % a.H;
  const int n = kv_tiles(a.S, a.causal, q0, BQ, BK);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(k_free(st), CONSUMER_WARPS);
      mbar_init(v_free(st), CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread issues every copy, K and V of each tile in turn
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      const int kvh = h / a.group;
      mbar_expect_tx(q_full, T::Q_BYTES);
#pragma unroll
      for (int x = 0; x < T::BOXES; ++x)
        tma_load(q_s + x * BQ * T::SW, &tq, x * T::CB, q0, h, b, q_full);
      // kt: the tile; it: its place in the ring, counted from 0 as the
      // consumers count it
      for (int kt = 0, it = 0; kt < n; ++kt, ++it) {
        const int st = it % STAGES;
        const uint32_t parity = ((it / STAGES) & 1) ^ 1;  // first pass: free
        mbar_wait(k_free(st), parity);
        mbar_expect_tx(k_full(st), T::KV_BYTES);
#pragma unroll
        for (int x = 0; x < T::BOXES; ++x)
          tma_load(k_s(st) + x * BK * T::SW, &tk, x * T::CB, kt * BK, kvh, b,
                   k_full(st));
        mbar_wait(v_free(st), parity);
        mbar_expect_tx(v_full(st), T::KV_BYTES);
#pragma unroll
        for (int x = 0; x < T::BOXES; ++x)
          tma_load(v_s(st) + x * BK * T::SW, &tv, x * T::CB, kt * BK, kvh, b,
                   v_full(st));
      }
    }
  } else {
    // consumers: 64 query rows each.  Each tile's scores are issued together
    // with the previous tile's P . V (O rescaled between the two issues, by
    // the factor the previous tile's softmax left in corr), and its softmax
    // runs while that product does.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = wg - 1;
    const int lane = threadIdx.x % 32;
    const int t = lane % 4;
    // this thread's rows: row0 and row0 + 8
    const int row0 = q0 + c * 64 + (threadIdx.x % 128) / 32 * 16 + lane / 4;
    const uint32_t q_rows = q_s + c * 64 * T::SW;

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
    float l[2] = {0.f, 0.f};
    float s[BK / 2], corr[2];
    uint32_t p[BK / 4];
    if (c == 1) turn_pass(c);  // consumer 0 goes first

    mbar_wait(q_full, 0);
    int kt = 0, it = 0;  // the first tile, and its place in the ring
    mbar_wait(k_full(0), 0);
    turn_wait(c);
    issue_scores<HD>(s, q_rows, k_s(0));
    turn_pass(c);
    wgmma_wait<0>();
    fence_regs(s);
    if (lane == 0) mbar_arrive(k_free(0));
    online_softmax<BK>(s, m, l, corr, a, kt * BK, q0, row0, t);
    to_bf16<BK>(s, p);

    for (++kt, ++it; kt < n; ++kt, ++it) {
      const int st = it % STAGES, prev = (it - 1) % STAGES;
      mbar_wait(k_full(st), (it / STAGES) & 1);
      mbar_wait(v_full(prev), ((it - 1) / STAGES) & 1);
      turn_wait(c);
      issue_scores<HD>(s, q_rows, k_s(st));
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] *= corr[(i >> 1) & 1];
      issue_pv<HD>(o, p, v_s(prev));
      turn_pass(c);
      wgmma_wait<1>();  // the scores have landed; P . V may still run
      fence_regs(s);
      if (lane == 0) mbar_arrive(k_free(st));
      online_softmax<BK>(s, m, l, corr, a, kt * BK, q0, row0, t);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(p);
      if (lane == 0) mbar_arrive(v_free(prev));
      to_bf16<BK>(s, p);
    }

    const int last = (it - 1) % STAGES;  // it: the tiles this consumer read
    mbar_wait(v_full(last), ((it - 1) / STAGES) & 1);
    turn_wait(c);
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] *= corr[(i >> 1) & 1];
    issue_pv<HD>(o, p, v_s(last));
    if (c == 0) turn_pass(c);  // consumer 1's last turn; 0's has none after
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(p);
    if (lane == 0) mbar_arrive(v_free(last));

    __nv_bfloat16* op = static_cast<__nv_bfloat16*>(a.o) + b * a.os[0] +
                        h * a.os[1];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      l[j] += __shfl_xor_sync(FULL, l[j], 1);
      l[j] += __shfl_xor_sync(FULL, l[j], 2);
      const int row = row0 + 8 * j;
      if (row >= a.S) continue;
      const float inv = 1.f / fmaxf(l[j], 1e-30f);
#pragma unroll
      for (int i = 0; i < HD / 8; ++i)
        *reinterpret_cast<uint32_t*>(op + row * a.os[2] + 8 * i + 2 * t) =
            pack_bf16(o[4 * i + 2 * j] * inv, o[4 * i + 2 * j + 1] * inv);
    }
  }
}

// ---- f32: the CUDA cores ----------------------------------------------------

constexpr int F32_BQ = 64;  // query rows per CTA
constexpr int F32_NC = 8;   // 16-byte chunks (32 dims) per thread

// hd / 32 threads per query row; thread `part` of a row owns the dims
// (i * TPR + part) * 4 .. + 3 for i < 8, so the TPR threads of a row read
// neighbouring 16-byte chunks of a K or V row and the rows of a warp share
// them by broadcast.
template <int HD>
__global__ void __launch_bounds__(F32_BQ * HD / 32)
    flash_f32_kernel(const Args a) {
  constexpr int TPR = HD / 32;
  constexpr int THREADS = F32_BQ * TPR;
  // keys per KV tile: 32, or 16 at hd 256, so that the K and V tiles stay
  // within the 48 KB of static shared memory (2 x 16 x 256 x 4 = 32 KB)
  constexpr int F32_BK = HD == 256 ? 16 : 32;
  __shared__ __align__(16) float k_s[F32_BK][HD];
  __shared__ __align__(16) float v_s[F32_BK][HD];

  const int n_qt = (a.S + F32_BQ - 1) / F32_BQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * F32_BQ;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int kvh = h / (a.H / a.KV);
  const int part = threadIdx.x % TPR, row = q0 + threadIdx.x / TPR;
  const bool live_row = row < a.S;

  const float* qp = static_cast<const float*>(a.q) + b * a.qs[0] +
                    h * a.qs[1] + row * a.qs[2];
  const float* kp = static_cast<const float*>(a.k) + b * a.ks[0] + kvh * a.ks[1];
  const float* vp = static_cast<const float*>(a.v) + b * a.vs[0] + kvh * a.vs[1];

  float4 qv[F32_NC], acc[F32_NC];
#pragma unroll
  for (int i = 0; i < F32_NC; ++i) {
    qv[i] = live_row ? *reinterpret_cast<const float4*>(qp + (i * TPR + part) * 4)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = NEG_INF, l = 0.f;

  const int n_kt = kv_tiles(a.S, a.causal, q0, F32_BQ, F32_BK);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * F32_BK;
    __syncthreads();
    for (int i = threadIdx.x; i < F32_BK * HD / 4; i += THREADS) {
      const int r = i / (HD / 4), c = (i % (HD / 4)) * 4, key = k0 + r;
      const bool live = key < a.S;
      *reinterpret_cast<float4*>(&k_s[r][c]) =
          live ? *reinterpret_cast<const float4*>(kp + key * a.ks[2] + c)
               : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(&v_s[r][c]) =
          live ? *reinterpret_cast<const float4*>(vp + key * a.vs[2] + c)
               : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();

    float s[F32_BK];
    float cur = NEG_INF;
#pragma unroll
    for (int j = 0; j < F32_BK; ++j) {
      float x = 0.f;
#pragma unroll
      for (int i = 0; i < F32_NC; ++i) {
        const float4 kv4 =
            *reinterpret_cast<const float4*>(&k_s[j][(i * TPR + part) * 4]);
        x = fmaf(qv[i].x, kv4.x, x);
        x = fmaf(qv[i].y, kv4.y, x);
        x = fmaf(qv[i].z, kv4.z, x);
        x = fmaf(qv[i].w, kv4.w, x);
      }
#pragma unroll
      for (int off = 1; off < TPR; off <<= 1)
        x += __shfl_xor_sync(FULL, x, off);
      const int key = k0 + j;
      const bool valid = key < a.S && (!a.causal || key <= row);
      s[j] = valid ? x * a.scale : NEG_INF;
      cur = fmaxf(cur, s[j]);
    }
    const float m_new = fmaxf(m, cur);
    const float corr = expf(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < F32_BK; ++j) {
      s[j] = expf(s[j] - m_new);
      sum += s[j];
    }
    l = corr * l + sum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < F32_NC; ++i) {
      acc[i].x *= corr;
      acc[i].y *= corr;
      acc[i].z *= corr;
      acc[i].w *= corr;
    }
#pragma unroll
    for (int j = 0; j < F32_BK; ++j)
#pragma unroll
      for (int i = 0; i < F32_NC; ++i) {
        const float4 vv =
            *reinterpret_cast<const float4*>(&v_s[j][(i * TPR + part) * 4]);
        acc[i].x = fmaf(s[j], vv.x, acc[i].x);
        acc[i].y = fmaf(s[j], vv.y, acc[i].y);
        acc[i].z = fmaf(s[j], vv.z, acc[i].z);
        acc[i].w = fmaf(s[j], vv.w, acc[i].w);
      }
  }

  if (!live_row) return;
  float* op = static_cast<float*>(a.o) + b * a.os[0] + h * a.os[1] +
              row * a.os[2];
  const float den = fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < F32_NC; ++i)
    *reinterpret_cast<float4*>(op + (i * TPR + part) * 4) =
        make_float4(acc[i].x / den, acc[i].y / den, acc[i].z / den,
                    acc[i].w / den);
}

// The 4-D map (hd, S, heads, B) of a bf16 tensor with element strides
// (batch, head, position) `st`, in boxes of one swizzle span of hd by `rows`
// positions; positions past S read as zeros.
template <int HD>
bool tensor_map(CUtensorMap* map, const void* ptr, const int64_t* st, int B,
                int heads, int S, int rows) {
  using T = Tile<HD>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(HD),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(B)};
  // strides in bytes of position, head and batch; a dim of size 1 is never
  // stepped over, so it takes any legal stride
  const int64_t el[3] = {st[2], st[1], st[0]};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i)
    strides[i] = static_cast<cuuint64_t>(dims[i + 1] == 1 ? HD : el[i]) * 2;
  const cuuint32_t box[4] = {T::CB, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                T::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                             : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch_bf16(const Args& a, int B, cudaStream_t stream) {
  using T = Tile<HD>;
  const int64_t n_tiles =
      static_cast<int64_t>((a.S + BQ - 1) / BQ) * B * a.H;
  CUtensorMap tq, tk, tv;
  if (n_tiles > 0x7fffffff ||
      !tensor_map<HD>(&tq, a.q, a.qs, B, a.H, a.S, BQ) ||
      !tensor_map<HD>(&tk, a.k, a.ks, B, a.KV, a.S, T::BK) ||
      !tensor_map<HD>(&tv, a.v, a.vs, B, a.KV, a.S, T::BK))
    return static_cast<int>(cudaErrorInvalidValue);
  TileArgs t;
  t.o = a.o;
  for (int i = 0; i < 3; ++i) t.os[i] = a.os[i];
  t.H = a.H;
  t.group = a.H / a.KV;
  t.S = a.S;
  t.causal = a.causal;
  t.n_bh = B * a.H;
  t.scale_log2 = a.scale * LOG2E;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bf16_kernel<HD><<<static_cast<unsigned>(n_tiles), THREADS, T::SMEM,
                          stream>>>(tq, tk, tv, t);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_hd(const Args& a, int B, bool bf16, cudaStream_t stream) {
  if (bf16) return launch_bf16<HD>(a, B, stream);
  if (B * a.H > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((a.S + F32_BQ - 1) / F32_BQ, B * a.H);
  flash_f32_kernel<HD><<<grid, F32_BQ * HD / 32, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int launch(const void* q, const void* k, const void* v, void* o,
           const int64_t* strides, int B, int H, int KV, int S, int hd,
           int causal, float scale, bool bf16, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = strides[i];
    a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i];
    a.os[i] = strides[9 + i];
  }
  a.H = H;
  a.KV = KV;
  a.S = S;
  a.causal = causal;
  a.scale = scale;
  const auto st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch_hd<32>(a, B, bf16, st);
    case 64: return launch_hd<64>(a, B, bf16, st);
    case 128: return launch_hd<128>(a, B, bf16, st);
    case 256: return launch_hd<256>(a, B, bf16, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, H, S, hd), k and v (B, KV, S, hd), o (B, H, S, hd), all of one type
// (bf16 or f32) on the device of the current context, each addressed through
// element strides (batch, head, position) with the dim contiguous; `strides`
// is a host array of 12: q's three, then k's, v's and o's.  Every row must
// start on 16 bytes.  hd is 32, 64, 128 or 256; H a multiple of KV; in f32, B * H
// at most 65535.  Launches on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments it does not take.
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v,
                                    void* o, const int64_t* strides, int B,
                                    int H, int KV, int S, int hd, int causal,
                                    float scale, void* stream) {
  return launch(q, k, v, o, strides, B, H, KV, S, hd, causal, scale, true,
                stream);
}

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   void* o, const int64_t* strides, int B,
                                   int H, int KV, int S, int hd, int causal,
                                   float scale, void* stream) {
  return launch(q, k, v, o, strides, B, H, KV, S, hd, causal, scale, false,
                stream);
}
