// ssd_intra_chunk: the intra-chunk ("attention dual") term of Mamba2's
// chunked SSD scan, for every (batch, chunk, head) cell of a prefill.
//
//   y[g,i,:] = sum_{j <= i} (C[g,i,:] . B[g,j,:]) exp(cum[g,i] - cum[g,j]) xdt[g,j,:]
//
// Replaces the Pallas kernel ssd_intra_chunk (src/repro/kernels/ssd_chunk.py:43,
// body _ssd_chunk_kernel :25).  Its arithmetic is the Pallas body's: the scores
// C.B^T summed in f32, multiplied by exp(cum_i - cum_j) where j <= i and set to
// 0 elsewhere, then their product with xdt summed in f32; in bf16 the scores
// are rounded to bf16 before that second product.  The output is f32.
//
// Every operand is read through element strides of a (outer, inner, row) cell
// layout, cell = outer * inner_count + inner, with the last dim contiguous,
// and the output is written straight into the layout the caller reads.  In
// the model's layout the heads of one SSD group are the inner dim and read
// the group's C and B rows through a stride-0 inner dim.  The exponent
// cum_i - cum_j is taken only where j <= i: above the diagonal it is positive
// and reaches hundreds at mamba2's decay rates, so exp overflows to inf, and a
// mask multiplied in would turn inf * 0 into NaN; nor is it factored into
// exp(cum_i) exp(-cum_j), which overflows the same way.
//
// f32 (the serving path: ssd_chunked computes in f32).  Bound by operations
// on the H100's CUDA cores: at the mamba2-130m prefill (cells (64, 24), Q 256,
// N 128, P 64) the work these inputs need is the group's scores once per
// (outer cell, pair j <= i), 2 N flops, and each head's product, 2 P flops
// per pair: 0.539 + 6.468 = 7.01 GFLOP, 0.105 ms at 67 TFLOP/s, against 0.066
// ms for its 219.7 MB over 3.35 TB/s.  The design:
//   * one CTA per (outer cell, 64-row query tile, block of heads).  Where C's
//     and B's inner strides are both 0 (the wrapper decides, and passes the
//     heads per CTA) the CTA computes the tile's scores S = C_q B_k^T for its
//     key tiles j0 <= i0 once, into shared memory (at most 64 x 256 f32), and
//     then loops over its heads, each applying its own decay to S pair by
//     pair and multiplying by its own xdt rows.  Any other layout takes one
//     head per CTA: the scores of that cell alone.  Past 256 keys the key
//     tiles are taken in windows of four, the output carried in device
//     memory from one window to the next;
//   * both products on the CUDA cores in f32 FMA, each sum taken in the order
//     the plain version's cuBLAS products take it (S along N from 0 up, y
//     along the keys from 0 up), so the kernel equals that plain version.
//     Split-precision TF32 on the tensor cores ("3xTF32", three TF32
//     products per f32 one) was rehearsed first: as accurate as f32 against
//     the f64 answer, but another summation order, and f32 rounding in
//     another order alone leaves ops.TOLERANCE (rtol = atol = 1e-5) at these
//     widths (tests/test_torch_ssd.py);
//   * one producer warp stages every tile asynchronously into rings of one or
//     two stages with full and free mbarriers: C and B by one cp.async.bulk
//     per 64-row tile row, xdt by one TMA box (64 rows) per tile and cum by
//     two (the tile's keys and the query rows), rows past Q zero-filled;
//     element copies where rows are not 16-byte vectors.  The next head's
//     xdt rows arrive while the current head's product runs;
//   * three consumer warpgroups (two at P = 128) take the heads in turn, so
//     that each SM sub-partition has three warps to issue from (at 128
//     registers a thread, which is what 13 warps leave).  Each warp owns 16
//     query rows and accumulates its 16 x P outputs in registers, 8 rows by
//     P / 16 columns a thread, 16 keys at a time from 16-byte reads of its
//     rows' decayed scores and of xdt.  It writes those decayed scores into
//     one of its two shared-memory blocks while it multiplies the previous
//     16 keys' (the exponent once per pair and head, by selects, so that
//     the exp chains overlap the FMAs).  On the diagonal tile a warp stops
//     at its last row: the key steps wholly above its diagonal are neither
//     decayed nor multiplied;
//   * the heaviest query tiles (most key tiles) are launched first, so the
//     short ones fill the tail, and the head blocks of one cell next to each
//     other, so they read its C and B rows from L2.
//
// bf16: 4 warps of 16 query rows on the tensor cores, mma.sync m16n8k16 (bf16
// in, f32 accumulate) for C.B^T and for scores.xdt, one CTA per (cell, 64-row
// query tile) walking its 64-key tiles, each staged in shared memory; the score
// fragments rounded to bf16 and re-packed in registers as the second product's
// A fragments; any Q (rows and keys past Q zero-filled), N and P padded with
// zeros in shared memory to 16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper_async.cuh"  // mbarriers, TMA, the tensor-map encoder

namespace {

constexpr int BQ = 64;  // query rows per CTA
constexpr int BK = 64;  // keys per key tile

struct Args {
  const float* cum;
  const void* c;
  const void* b;
  const void* x;
  float* out;
  // element strides (outer, inner, row) of cum, C, B, xdt and out
  int64_t cs[3], ccs[3], bs[3], xs[3], os[3];
  int G, Gi, Q, N, P, n_qt;
};

__device__ __forceinline__ int64_t cell_offset(const int64_t (&s)[3], int cell,
                                               int Gi) {
  return static_cast<int64_t>(cell / Gi) * s[0] +
         static_cast<int64_t>(cell % Gi) * s[1];
}

__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// rows [r0, r0 + rows) x cols [0, ld_cols) of a (row, col) operand into shared
// memory with row stride ld; rows past Q and cols past n are zero
template <typename T, typename S>
__device__ __forceinline__ void stage(S* dst, int ld, int ld_cols,
                                      const T* src, int64_t row_stride, int r0,
                                      int rows, int Q, int n, int tid,
                                      int threads) {
  for (int idx = tid; idx < rows * ld_cols; idx += threads) {
    const int r = idx / ld_cols, col = idx % ld_cols;
    const bool live = r0 + r < Q && col < n;
    const float v = live ? load(src + (r0 + r) * row_stride + col) : 0.f;
    if constexpr (sizeof(S) == 4)
      dst[r * ld + col] = v;
    else
      dst[r * ld + col] = __float2bfloat16_rn(v);
  }
}

// ---- f32: group-shared scores, async staging, the CUDA cores ---------------

// NWG consumer warpgroups (3 where P <= 64, 2 for P = 128, whose 64
// accumulators a thread leave fewer registers), then one producer warp
constexpr int MAX_WG = 3;
constexpr int S_WARPS = 8;     // the consumer warps that compute the scores
constexpr int KW = 4;          // key tiles of one window of scores
constexpr int S_LD = 80;       // row stride of the scores (16 mod 32 banks)
constexpr int DK = 16;         // keys decayed at a time
constexpr int D_FLOATS = 2 * DK * 16;  // one warp's two blocks of decayed
                                       // scores, [key][row]
constexpr int MAX_SMEM = 232448;
// mbarriers: ring stages of B (FULL1, FREE1), C, the warpgroups' xdt rings
// (FULL2, FREE2: [warpgroup][stage]) and the ends of the two phases
enum { FULL1 = 0, FREE1 = 2, FULLC = 4, FULL2 = 5, FREE2 = 5 + 2 * MAX_WG,
       P1DONE = 5 + 4 * MAX_WG, P2DONE, N_BARS };
constexpr int BAR_BYTES = 256;  // a multiple of 128: TMA boxes follow
static_assert(N_BARS * 8 <= BAR_BYTES, "mbarriers overflow their bytes");

template <int TN>
__host__ __device__ constexpr int n_wg() { return TN == 8 ? 2 : 3; }

// the f32 kernel's consumer warpgroups at width P
__host__ int f32_warpgroups(int P) { return P == 128 ? n_wg<8>() : n_wg<4>(); }

struct F32Args {
  const float* cum;
  const float* c;
  const float* b;
  const float* x;
  float* out;
  // element strides (outer, inner, row) of cum, C, B, xdt and out
  int64_t cs[3], ccs[3], bs[3], xs[3], os[3];
  int Go, Gi, Q, N, P, n_qt;
  int heads, n_hb;   // heads per CTA, head blocks per outer cell
  int kw;            // key tiles per window: min(n_qt, KW)
  int n4, ldn;       // N rounded up to 4 (the sum's length), C and B's row
                     // stride in shared memory (4 mod 8: no bank conflict)
  int ldx;           // xdt's row stride in shared memory: P padded to 16
  int st1, st2;      // stages of the B ring and of each xdt ring
  int bulk_cb;           // C and B in bulk copies
  int tma_x, tma_cum;   // xdt and cum through their tensor maps
  int r_off, slot_floats, d_off;  // byte offsets of the staging region and of
                                  // the decayed scores in it; an xdt slot
};

// One bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned) from
// device memory into shared memory, its bytes counted on `bar`.
__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The consumer warps, and only they.
template <int NWG>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * NWG) : "memory");
}

// One producer warp stages rows [r0, r0 + 64) of a (row, col) operand with
// `cols` columns into dst (row stride ld floats): by one bulk copy per row
// where rows are 16-byte vectors, else by element copies that also zero
// columns [cols, ldc); rows past Q are zero in the first ldc columns.  Each
// lane arrives on `bar` once (its count is 32), lane 0 with the copies' bytes.
__device__ __forceinline__ void stage_rows(float* dst, int ld, int ldc,
                                           const float* src, int64_t rs,
                                           int r0, int cols, int Q, bool bulk,
                                           uint32_t bar, int lane) {
  const int rows = min(BK, Q - r0);
  if (bulk) {
    for (int idx = lane; idx < (BK - rows) * ldc; idx += 32)
      dst[(rows + idx / ldc) * ld + idx % ldc] = 0.f;
    fence_proxy_async();
    if (lane == 0)
      mbar_expect_tx(bar, rows * cols * 4);
    else
      mbar_arrive(bar);
    for (int r = lane; r < rows; r += 32)
      bulk_load(dst + r * ld, src + (r0 + r) * rs, cols * 4, bar);
  } else {
    for (int idx = lane; idx < BK * ldc; idx += 32) {
      const int r = idx / ldc, col = idx % ldc;
      float v = 0.f;
      if (r < rows && col < cols) v = src[(r0 + r) * rs + col];
      dst[r * ld + col] = v;
    }
    fence_proxy_async();
    mbar_arrive(bar);
  }
}

// The producer warp: C and the B tiles of each window, then, once phase 1
// has freed the staging region, the xdt rows and cum of every warpgroup's
// heads (warpgroup g takes heads g, g + NWG, ...), tile by tile, the
// warpgroups in turn.
template <int NWG>
__device__ void f32_producer(const F32Args& a, const CUtensorMap* tx,
                             const CUtensorMap* tc, unsigned char* smem,
                             int lane, int o, int qt, int h0, int nh) {
  const uint32_t bars = smem_u32(smem);
  float* region = reinterpret_cast<float*>(smem + a.r_off);
  const int q0 = qt * BQ, n_win = qt / a.kw + 1;
  const float* cp = a.c + o * a.ccs[0] + h0 * a.ccs[1];
  const float* bp = a.b + o * a.bs[0] + h0 * a.bs[1];
  int it1 = 0, it2[NWG] = {};
  for (int w = 0; w < n_win; ++w) {
    const int kt0 = w * a.kw, n_kt = min(a.kw, qt + 1 - kt0);
    if (w > 0) mbar_wait(bars + 8 * P2DONE, (w - 1) & 1);
    stage_rows(region, a.ldn, a.n4, cp, a.ccs[2], q0, a.N, a.Q, a.bulk_cb,
               bars + 8 * FULLC, lane);
    for (int t = 0; t < n_kt; ++t, ++it1) {
      const int s = it1 % a.st1;
      if (it1 >= a.st1) mbar_wait(bars + 8 * (FREE1 + s), (it1 / a.st1 - 1) & 1);
      stage_rows(region + (1 + s) * BK * a.ldn, a.ldn, a.n4, bp, a.bs[2],
                 (kt0 + t) * BK, a.N, a.Q, a.bulk_cb, bars + 8 * (FULL1 + s),
                 lane);
    }
    mbar_wait(bars + 8 * P1DONE, w & 1);
    for (int h1 = 0; h1 < nh; h1 += NWG) {
      for (int kt = 0; kt < n_kt; ++kt) {
#pragma unroll
        for (int g = 0; g < NWG; ++g) {
          if (h1 + g >= nh) continue;
          const int h = h0 + h1 + g;
          const float* cum = a.cum + o * a.cs[0] + h * a.cs[1];
          const float* xp = a.x + o * a.xs[0] + h * a.xs[1];
          const int s = it2[g] % a.st2;
          if (it2[g] >= a.st2)
            mbar_wait(bars + 8 * (FREE2 + 2 * g + s), (it2[g] / a.st2 - 1) & 1);
          ++it2[g];
          float* slot = region + (g * a.st2 + s) * a.slot_floats;
          float* ck = slot + BK * a.ldx;  // cum of the tile's keys, then of
          const int k0 = (kt0 + kt) * BK; // the query rows
          const uint32_t full = bars + 8 * (FULL2 + 2 * g + s);
          if (!a.tma_cum) {
            for (int j = lane; j < BK; j += 32) {
              float vk = 0.f, vq = 0.f;
              if (k0 + j < a.Q) vk = cum[(k0 + j) * a.cs[2]];
              if (q0 + j < a.Q) vq = cum[(q0 + j) * a.cs[2]];
              ck[j] = vk;
              ck[BK + j] = vq;
            }
          }
          if (!a.tma_x) {
            stage_rows(slot, a.ldx, a.ldx, xp, a.xs[2], k0, a.P, a.Q, false,
                       full, lane);
          } else if (lane == 0) {
            mbar_expect_tx(full, 4 * BK * (a.P + (a.tma_cum ? 2 : 0)));
            tma_load(smem_u32(slot), tx, 0, k0, h, o, full);
            if (a.tma_cum) {
              tma_load_3d(smem_u32(ck), tc, k0, h, o, full);
              tma_load_3d(smem_u32(ck + BK), tc, q0, h, o, full);
            }
          } else {
            mbar_arrive(full);
          }
        }
      }
    }
  }
}

// Output column of a thread's c-th column (cg = lane % 16): runs of 4 (16
// bytes) 64 columns apart for TN >= 4, else TN adjacent ones.
template <int TN>
__device__ __forceinline__ int out_col(int cg, int c) {
  if constexpr (TN >= 4)
    return (c / 4) * 64 + 4 * cg + c % 4;
  else
    return TN * cg + c;
}

// The head's decay of the tile's key j for the lane's query row (kept where
// j <= last), into its block d of decayed scores.  Selects, not a branch, so
// that the exp chains of several keys overlap; a pair above the diagonal
// takes exp(0), never its overflowing exponent.
__device__ __forceinline__ void decay_key(float* d, const float* srow,
                                          const float* ck, float cq, int last,
                                          int j, int il) {
  const bool keep = j <= last;
  const float e = expf(keep ? cq - ck[j] : 0.f);
  const float sc = srow[j * S_LD];
  d[j % DK * 16 + il] = keep ? sc * e : 0.f;
}

// acc += the lane's 8 rows of decayed scores at key row jd of d times the
// key's xdt row
template <int TN>
__device__ __forceinline__ void product_key(float (&acc)[8][TN],
                                            const float* d, int jd,
                                            const float* xrow, int rg,
                                            int il) {
  const float4 d0 = *reinterpret_cast<const float4*>(&d[jd * 16 + 8 * rg]);
  const float4 d1 = *reinterpret_cast<const float4*>(&d[jd * 16 + 8 * rg + 4]);
  const float dv[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
  float xv[TN];
  if constexpr (TN >= 4) {
#pragma unroll
    for (int v = 0; v < TN / 4; ++v) {
      const float4 t = *reinterpret_cast<const float4*>(xrow + 64 * v + 4 * il);
      xv[4 * v] = t.x;
      xv[4 * v + 1] = t.y;
      xv[4 * v + 2] = t.z;
      xv[4 * v + 3] = t.w;
    }
  } else if constexpr (TN == 2) {
    const float2 t = *reinterpret_cast<const float2*>(xrow + 2 * il);
    xv[0] = t.x;
    xv[1] = t.y;
  } else {
    xv[0] = xrow[il];
  }
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(dv[r], xv[c], acc[r][c]);
}

// The consumer warps: phase 1, the window's scores by the first 8; phase 2,
// warpgroup wg's heads, warp wl of it owning query rows 16 wl .. 16 wl + 15.
template <int TN>
__device__ void f32_consumer(const F32Args& a, unsigned char* smem, int warp,
                             int lane, int o, int qt, int h0, int nh) {
  constexpr int NWG = n_wg<TN>();
  const uint32_t bars = smem_u32(smem);
  float* s_t = reinterpret_cast<float*>(smem + BAR_BYTES);  // [key][row]
  float* region = reinterpret_cast<float*>(smem + a.r_off);
  float* d_w = reinterpret_cast<float*>(smem + a.r_off + a.d_off) +
               warp * D_FLOATS;  // [2][DK keys][16 rows]
  const int q0 = qt * BQ, n_win = qt / a.kw + 1;
  const int tid = warp * 32 + lane, wg = warp / 4, wl = warp % 4;
  const int tx = tid & 15, ty = tid >> 4;  // phase 1: rows tx + 16 r, keys
                                           // 4 ty + c
  const int il = lane & 15, rg = lane >> 4;  // phase 2: row il of the warp's
                                             // 16; rows 8 rg .. 8 rg + 7
  int it1 = 0, it2 = 0;
  for (int w = 0; w < n_win; ++w) {
    const int kt0 = w * a.kw, n_kt = min(a.kw, qt + 1 - kt0);
    // phase 1: S = C_q B_k^T of the window's key tiles, summed along N in
    // order, into s_t
    if (warp < S_WARPS) {
      mbar_wait(bars + 8 * FULLC, w & 1);
      for (int t = 0; t < n_kt; ++t, ++it1) {
        const int s = it1 % a.st1;
        mbar_wait(bars + 8 * (FULL1 + s), (it1 / a.st1) & 1);
        const float* b_s = region + (1 + s) * BK * a.ldn;
        float acc[4][4] = {};
#pragma unroll 2
        for (int k = 0; k < a.n4; k += 4) {
          float4 av[4], bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            av[r] = *reinterpret_cast<const float4*>(
                &region[(tx + 16 * r) * a.ldn + k]);
#pragma unroll
          for (int c = 0; c < 4; ++c)
            bv[c] =
                *reinterpret_cast<const float4*>(&b_s[(4 * ty + c) * a.ldn + k]);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              acc[r][c] = fmaf(av[r].x, bv[c].x, acc[r][c]);
              acc[r][c] = fmaf(av[r].y, bv[c].y, acc[r][c]);
              acc[r][c] = fmaf(av[r].z, bv[c].z, acc[r][c]);
              acc[r][c] = fmaf(av[r].w, bv[c].w, acc[r][c]);
            }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            s_t[(t * BK + 4 * ty + c) * S_LD + tx + 16 * r] = acc[r][c];
        __syncwarp();
        if (lane == 0) mbar_arrive(bars + 8 * (FREE1 + s));
      }
    }
    consumers_sync<NWG>();  // s_t whole; C and B read for the last time
    if (tid == 0) mbar_arrive(bars + 8 * P1DONE);

    // phase 2: each head of the warpgroup's in turn
    for (int hh = wg; hh < nh; hh += NWG) {
      float* op = a.out + o * a.os[0] + (h0 + hh) * a.os[1];
      float acc[8][TN];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = q0 + 16 * wl + 8 * rg + r;
#pragma unroll
        for (int c = 0; c < TN; ++c) {
          const int col = out_col<TN>(il, c);
          acc[r][c] = w > 0 && i < a.Q && col < a.P ? op[i * a.os[2] + col]
                                                    : 0.f;
        }
      }
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = it2 % a.st2;
        mbar_wait(bars + 8 * (FULL2 + 2 * wg + s), (it2 / a.st2) & 1);
        ++it2;
        const float* x_s = region + (wg * a.st2 + s) * a.slot_floats;
        const float* ck = x_s + BK * a.ldx;
        const int k0 = (kt0 + kt) * BK;
        // keys this warp needs: all, or on the diagonal up to its last row
        const int J = kt0 + kt == qt ? 16 * (wl + 1) : BK;
        const int i = 16 * wl + il, last = q0 + i - k0;  // keys j <= last
        const float cq = ck[BK + i];
        const float* srow = s_t + kt * BK * S_LD + i;
        // the decay of the tile's first DK keys, then, DK keys at a time,
        // their product with xdt interleaved with the next DK keys' decay
        // into the warp's other block, so that the exp chains overlap the
        // FMAs; the keys in order
#pragma unroll
        for (int m = 0; m < DK / 2; ++m)
          decay_key(d_w, srow, ck, cq, last, rg + 2 * m, il);
        __syncwarp();
        for (int j0 = 0; j0 < J; j0 += DK) {
          const float* d = d_w + (j0 / DK % 2) * DK * 16;
          float* next = d_w + (1 - j0 / DK % 2) * DK * 16;
          if (j0 + DK < J) {
#pragma unroll
            for (int j = 0; j < DK; ++j) {
              product_key<TN>(acc, d, j, x_s + (j0 + j) * a.ldx, rg, il);
              if (j % 2)
                decay_key(next, srow, ck, cq, last, j0 + DK + rg + j - 1, il);
            }
          } else {
#pragma unroll
            for (int j = 0; j < DK; ++j)
              product_key<TN>(acc, d, j, x_s + (j0 + j) * a.ldx, rg, il);
          }
          __syncwarp();
        }
        if (lane == 0) mbar_arrive(bars + 8 * (FREE2 + 2 * wg + s));
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = q0 + 16 * wl + 8 * rg + r;
        if (i >= a.Q) continue;
        float* orow = op + i * a.os[2];
        if constexpr (TN >= 4) {  // 16-byte stores (the launch checked)
#pragma unroll
          for (int v = 0; v < TN / 4; ++v)
            *reinterpret_cast<float4*>(orow + out_col<TN>(il, 4 * v)) =
                make_float4(acc[r][4 * v], acc[r][4 * v + 1],
                            acc[r][4 * v + 2], acc[r][4 * v + 3]);
          continue;
        }
#pragma unroll
        for (int c = 0; c < TN; ++c) {
          const int col = out_col<TN>(il, c);
          if (col < a.P) orow[col] = acc[r][c];
        }
      }
    }
    if (w + 1 < n_win) {
      // the next window's C and B land where the decayed scores were
      fence_proxy_async();
      consumers_sync<NWG>();
      if (tid == 0) mbar_arrive(bars + 8 * P2DONE);
    }
  }
}

// TN = P / 16 output columns per thread (P = 32, 64, 128), or 1 (P <= 16).
template <int TN>
__global__ void __launch_bounds__((4 * n_wg<TN>() + 1) * 32, 1)
    ssd_f32_kernel(const F32Args a, const __grid_constant__ CUtensorMap tx,
                   const __grid_constant__ CUtensorMap tc) {
  constexpr int NWG = n_wg<TN>();
  // TMA writes boxes at 128-byte aligned shared addresses
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  const int id = static_cast<int>(blockIdx.x), per_qt = a.Go * a.n_hb;
  const int qt = a.n_qt - 1 - id / per_qt;
  const int o = id % per_qt / a.n_hb, hb = id % a.n_hb;
  const int h0 = hb * a.heads, nh = min(a.heads, a.Gi - h0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    const uint32_t bars = smem_u32(smem);
    for (int s = 0; s < 2; ++s) {
      mbar_init(bars + 8 * (FULL1 + s), 32);
      mbar_init(bars + 8 * (FREE1 + s), S_WARPS);
    }
    mbar_init(bars + 8 * FULLC, 32);
    for (int s = 0; s < 2 * MAX_WG; ++s) {
      mbar_init(bars + 8 * (FULL2 + s), 32);
      mbar_init(bars + 8 * (FREE2 + s), 4);
    }
    mbar_init(bars + 8 * P1DONE, 1);
    mbar_init(bars + 8 * P2DONE, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == 4 * NWG)
    f32_producer<NWG>(a, &tx, &tc, smem, lane, o, qt, h0, nh);
  else
    f32_consumer<TN>(a, smem, warp, lane, o, qt, h0, nh);
}

// ---- bf16: mma.sync on the tensor cores ------------------------------------

constexpr int WARPS = 4;  // 16 query rows each

__host__ __device__ inline int bf16_ld(int n) { return (n + 15) / 16 * 16 + 8; }

__host__ inline size_t bf16_smem(int N, int P) {
  return sizeof(__nv_bfloat16) *
             (static_cast<size_t>(BQ + BK) * bf16_ld(N) + BK * bf16_ld(P)) +
         sizeof(float) * (BQ + BK);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  const unsigned p = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(p)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem) {
  const unsigned p = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(p)
      : "memory");
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Fragment layout of mma m16n8k16 (lane = 4 * g + t): A holds rows g and g+8
// at columns 2t, 2t+1 and 2t+8, 2t+9; B holds (k = 2t, 2t+1 and 2t+8, 2t+9;
// n = g); C holds rows g (c0, c1) and g+8 (c2, c3) at columns 2t, 2t+1.
// PT: P padded to 16, in 16-column steps.
template <int PT>
__global__ void __launch_bounds__(WARPS * 32)
    ssd_bf16_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char raw[];
  const int ldn = bf16_ld(a.N), ldp = bf16_ld(a.P);
  const int n16 = ldn - 8, p16 = ldp - 8;
  __nv_bfloat16* c_s = reinterpret_cast<__nv_bfloat16*>(raw);  // [BQ][ldn]
  __nv_bfloat16* b_s = c_s + BQ * ldn;                          // [BK][ldn]
  __nv_bfloat16* x_s = b_s + BK * ldn;                          // [BK][ldp]
  float* cq = reinterpret_cast<float*>(x_s + BK * ldp);         // [BQ]
  float* ck = cq + BQ;                                          // [BK]

  const int id = static_cast<int>(blockIdx.x);
  const int qt = a.n_qt - 1 - id / a.G, cell = id % a.G;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;

  const float* cum = a.cum + cell_offset(a.cs, cell, a.Gi);
  const __nv_bfloat16* cp =
      static_cast<const __nv_bfloat16*>(a.c) + cell_offset(a.ccs, cell, a.Gi);
  const __nv_bfloat16* bp =
      static_cast<const __nv_bfloat16*>(a.b) + cell_offset(a.bs, cell, a.Gi);
  const __nv_bfloat16* xp =
      static_cast<const __nv_bfloat16*>(a.x) + cell_offset(a.xs, cell, a.Gi);

  stage(c_s, ldn, n16, cp, a.ccs[2], q0, BQ, a.Q, a.N, tid, WARPS * 32);
  for (int r = tid; r < BQ; r += WARPS * 32)
    cq[r] = q0 + r < a.Q ? cum[(q0 + r) * a.cs[2]] : 0.f;

  float acc[2 * PT][4];
#pragma unroll
  for (int n = 0; n < 2 * PT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const int rl[2] = {warp * 16 + g, warp * 16 + g + 8};  // rows in the tile

  const int n_kt = qt + 1;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    stage(b_s, ldn, n16, bp, a.bs[2], k0, BK, a.Q, a.N, tid, WARPS * 32);
    stage(x_s, ldp, p16, xp, a.xs[2], k0, BK, a.Q, a.P, tid, WARPS * 32);
    for (int r = tid; r < BK; r += WARPS * 32)
      ck[r] = k0 + r < a.Q ? cum[(k0 + r) * a.cs[2]] : 0.f;
    __syncthreads();

    // scores: 16 rows x 64 keys per warp, f32
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    for (int kk = 0; kk < n16 / 16; ++kk) {
      uint32_t af[4];
      ldmatrix_x4(af, &c_s[(warp * 16 + (lane & 15)) * ldn + kk * 16 +
                           (lane >> 4) * 8]);
#pragma unroll
      for (int nj = 0; nj < BK / 16; ++nj) {
        uint32_t bf[4];
        ldmatrix_x4(bf, &b_s[(nj * 16 + (lane & 7) + (lane >> 4) * 8) * ldn +
                             kk * 16 + ((lane >> 3) & 1) * 8]);
        mma_bf16(s[2 * nj], af, bf[0], bf[1]);
        mma_bf16(s[2 * nj + 1], af, bf[2], bf[3]);
      }
    }
    // the decay where j <= i (the exponent taken there only), 0 elsewhere
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int il = rl[e >> 1], jl = j * 8 + 2 * t + (e & 1);
        const bool keep = k0 + jl <= q0 + il && q0 + il < a.Q;
        s[j][e] = keep ? s[j][e] * expf(cq[il] - ck[jl]) : 0.f;
      }
    // acc += scores (rounded to bf16) . xdt: the C fragments of score tiles
    // 2kk and 2kk+1 are the A fragment of key step kk
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < PT; ++dn) {
        uint32_t bf[4];
        ldmatrix_x4_trans(
            bf, &x_s[(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ldp +
                     dn * 16 + (lane >> 4) * 8]);
        mma_bf16(acc[2 * dn], pa, bf[0], bf[1]);
        mma_bf16(acc[2 * dn + 1], pa, bf[2], bf[3]);
      }
    }
  }

  float* op = a.out + cell_offset(a.os, cell, a.Gi);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + rl[i];
    if (row >= a.Q) continue;
#pragma unroll
    for (int n = 0; n < 2 * PT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n * 8 + 2 * t + e;
        if (col < a.P) op[row * a.os[2] + col] = acc[n][2 * i + e];
      }
  }
}

// ---- launch -----------------------------------------------------------------

template <typename K, typename... A>
int launch_kernel(K kernel, unsigned grid, int threads, size_t smem,
                  cudaStream_t stream, const A&... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The map of an f32 tensor of `rank` dims, dims[0] contiguous and the others
// at element strides el[0 ..], in boxes `box`, elements past an edge read as
// zeros; false where TMA cannot read it (strides or address off 16 bytes).
bool f32_map(CUtensorMap* map, const float* ptr, int rank,
             const cuuint64_t* dims, const int64_t* el, const cuuint32_t* box) {
  if (!aligned16(ptr)) return false;
  cuuint64_t strides[3];
  for (int i = 0; i + 1 < rank; ++i) {
    // a dim of size 1 is never stepped over, so it takes any legal stride
    const int64_t e =
        dims[i + 1] == 1 ? static_cast<int64_t>(dims[0] + 3) / 4 * 4 : el[i];
    if (e <= 0 || e % 4) return false;
    strides[i] = static_cast<cuuint64_t>(e) * 4;
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank,
                const_cast<float*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// every stride a whole number of 16-byte vectors
bool vec4(const int64_t (&s)[3]) {
  return s[0] % 4 == 0 && s[1] % 4 == 0 && s[2] % 4 == 0;
}

bool args_ok(int N, int P) {
  return N > 0 && N <= 256 && P > 0 &&
         (P <= 16 || P == 32 || P == 64 || P == 128);
}

int launch_f32(const float* cum, const float* c, const float* b,
               const float* x, float* out, const int64_t* strides, int Go,
               int Gi, int Q, int N, int P, int heads, cudaStream_t st) {
  F32Args a;
  a.cum = cum;
  a.c = c;
  a.b = b;
  a.x = x;
  a.out = out;
  for (int i = 0; i < 3; ++i) {
    a.cs[i] = strides[i];
    a.ccs[i] = strides[3 + i];
    a.bs[i] = strides[6 + i];
    a.xs[i] = strides[9 + i];
    a.os[i] = strides[12 + i];
  }
  // several heads per CTA share one C and one B: only through stride-0
  // heads; at P = 64 and 128 the output rows take 16-byte stores
  if (heads < 1 || heads > Gi ||
      (heads > 1 && (a.ccs[1] != 0 || a.bs[1] != 0)) ||
      (P >= 64 && !(aligned16(out) && vec4(a.os))))
    return static_cast<int>(cudaErrorInvalidValue);
  a.Go = Go;
  a.Gi = Gi;
  a.Q = Q;
  a.N = N;
  a.P = P;
  a.n_qt = (Q + BQ - 1) / BQ;
  a.heads = heads;
  a.n_hb = (Gi + heads - 1) / heads;
  a.kw = a.n_qt < KW ? a.n_qt : KW;
  a.n4 = (N + 3) / 4 * 4;
  a.ldn = (N + 7) / 8 * 8 + 4;
  a.ldx = P <= 16 ? 16 : P;
  a.bulk_cb = N % 4 == 0 && aligned16(c) && aligned16(b) && vec4(a.ccs) &&
              vec4(a.bs);
  // xdt by one TMA box of 64 rows per tile where its rows are whole 16-byte
  // vectors as wide as their shared-memory rows, cum by two boxes of 64 (the
  // keys' and the query rows') where its rows are contiguous; element copies
  // otherwise
  CUtensorMap tx = {}, tc = {};
  const cuuint64_t xdims[4] = {static_cast<cuuint64_t>(P),
                               static_cast<cuuint64_t>(Q),
                               static_cast<cuuint64_t>(Gi),
                               static_cast<cuuint64_t>(Go)};
  const int64_t xel[3] = {a.xs[2], a.xs[1], a.xs[0]};
  const cuuint32_t xbox[4] = {static_cast<cuuint32_t>(P), BK, 1, 1};
  a.tma_x = P == a.ldx && f32_map(&tx, x, 4, xdims, xel, xbox);
  const cuuint64_t cdims[3] = {static_cast<cuuint64_t>(Q),
                               static_cast<cuuint64_t>(Gi),
                               static_cast<cuuint64_t>(Go)};
  const int64_t cel[2] = {a.cs[1], a.cs[0]};
  const cuuint32_t cbox[3] = {BK, 1, 1};
  a.tma_cum = a.tma_x && a.cs[2] == 1 && f32_map(&tc, cum, 3, cdims, cel, cbox);
  a.slot_floats = BK * a.ldx + 2 * BK;
  const size_t s_bytes = sizeof(float) * a.kw * BK * S_LD;
  const size_t c_bytes = sizeof(float) * BK * a.ldn;
  const size_t slot_bytes = sizeof(float) * a.slot_floats;
  const int nwg = f32_warpgroups(P);
  const size_t d_bytes = sizeof(float) * 4 * nwg * D_FLOATS;
  // two stages of each ring where they fit, the xdt rings first
  size_t smem = 0;
  for (int st2 = 2; st2 >= 1 && !smem; --st2)
    for (int st1 = 2; st1 >= 1 && !smem; --st1) {
      const size_t p1 = c_bytes * (1 + st1),
                   p2 = nwg * st2 * slot_bytes + d_bytes;
      // and 128 bytes to align the base for TMA
      const size_t total = 128 + BAR_BYTES + s_bytes + (p1 > p2 ? p1 : p2);
      if (total <= MAX_SMEM) {
        smem = total;
        a.st1 = st1;
        a.st2 = st2;
        a.d_off = static_cast<int>(nwg * st2 * slot_bytes);
      }
    }
  if (!smem) return static_cast<int>(cudaErrorInvalidValue);
  a.r_off = static_cast<int>(BAR_BYTES + s_bytes);
  const int64_t grid = static_cast<int64_t>(a.n_qt) * Go * a.n_hb;
  if (grid > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned g = static_cast<unsigned>(grid);
  const int threads = (4 * nwg + 1) * 32;
  if (P <= 16)
    return launch_kernel(ssd_f32_kernel<1>, g, threads, smem, st, a, tx, tc);
  switch (P) {
    case 32:
      return launch_kernel(ssd_f32_kernel<2>, g, threads, smem, st, a, tx, tc);
    case 64:
      return launch_kernel(ssd_f32_kernel<4>, g, threads, smem, st, a, tx, tc);
    case 128:
      return launch_kernel(ssd_f32_kernel<8>, g, threads, smem, st, a, tx, tc);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch_bf16(const float* cum, const void* c, const void* b, const void* x,
                float* out, const int64_t* strides, int Go, int Gi, int Q,
                int N, int P, cudaStream_t st) {
  Args a;
  a.cum = cum;
  a.c = c;
  a.b = b;
  a.x = x;
  a.out = out;
  for (int i = 0; i < 3; ++i) {
    a.cs[i] = strides[i];
    a.ccs[i] = strides[3 + i];
    a.bs[i] = strides[6 + i];
    a.xs[i] = strides[9 + i];
    a.os[i] = strides[12 + i];
  }
  a.G = Go * Gi;
  a.Gi = Gi;
  a.Q = Q;
  a.N = N;
  a.P = P;
  a.n_qt = (Q + BQ - 1) / BQ;
  const int64_t grid = static_cast<int64_t>(a.n_qt) * a.G;
  if (grid > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned g = static_cast<unsigned>(grid);
  const size_t smem = bf16_smem(N, P);
  switch ((P + 15) / 16) {
    case 1: return launch_kernel(ssd_bf16_kernel<1>, g, WARPS * 32, smem, st, a);
    case 2: return launch_kernel(ssd_bf16_kernel<2>, g, WARPS * 32, smem, st, a);
    case 4: return launch_kernel(ssd_bf16_kernel<4>, g, WARPS * 32, smem, st, a);
    case 8: return launch_kernel(ssd_bf16_kernel<8>, g, WARPS * 32, smem, st, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// cum (cells, Q) f32; C and B (cells, Q, N) and xdt (cells, Q, P), all f32 or
// all bf16; out (cells, Q, P) f32; on the device of the current context.  The
// cells are (Go, Gi), cell = outer * Gi + inner, and every operand is addressed
// through element strides (outer, inner, row) with its last dim contiguous;
// `strides` is a host array of 15: cum's three, then C's, B's, xdt's and out's.
// N is at most 256; P is at most 16, or 32, 64 or 128.  In f32, `heads` is
// the number of inner cells (heads) one CTA takes: above 1 only where C's and
// B's inner strides are 0, and the CTA then computes their scores once for
// all of them.  Launches on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments it does not take.
extern "C" int ssd_intra_chunk_f32(const float* cum, const void* c,
                                   const void* b, const void* x, float* out,
                                   const int64_t* strides, int Go, int Gi,
                                   int Q, int N, int P, int heads,
                                   void* stream) {
  if (Go <= 0 || Gi <= 0 || Q <= 0) return 0;
  if (!args_ok(N, P)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_f32(cum, static_cast<const float*>(c),
                    static_cast<const float*>(b), static_cast<const float*>(x),
                    out, strides, Go, Gi, Q, N, P, heads,
                    static_cast<cudaStream_t>(stream));
}

// The f32 kernel's consumer warpgroups at width P (3, or 2 at P = 128), which
// take a CTA's heads in turn: the wrapper cuts a group's heads into blocks of
// whole rounds of them.
extern "C" int ssd_intra_chunk_f32_warpgroups(int P) {
  return f32_warpgroups(P);
}

extern "C" int ssd_intra_chunk_bf16(const float* cum, const void* c,
                                    const void* b, const void* x, float* out,
                                    const int64_t* strides, int Go, int Gi,
                                    int Q, int N, int P, void* stream) {
  if (Go <= 0 || Gi <= 0 || Q <= 0) return 0;
  if (!args_ok(N, P)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_bf16(cum, c, b, x, out, strides, Go, Gi, Q, N, P,
                     static_cast<cudaStream_t>(stream));
}
