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
// Bound by operations on the H100 at the serving shape (Q = 256, N = 128,
// P = 64): 2 Q^2 (N + P) flops per cell, about half of them causal, against
// (Q (2N + P) + Q) inputs read once per query tile.  The design:
//   * the TPU kernel holds a whole (Q, Q) score block of one cell in VMEM; here
//     one CTA takes one cell and one 64-row query tile, keeps the tile's C rows
//     in shared memory and walks the 64-key tiles j0 <= i0 in order (the tiles
//     wholly above the diagonal are skipped: their scores are all 0), staging
//     each tile's B and xdt rows in shared memory and accumulating the tile's
//     contribution to the (64, P) output in registers;
//   * the exponent is taken only where j <= i: above the diagonal cum_i - cum_j
//     is positive and reaches hundreds at mamba2's decay rates, so exp overflows
//     to inf, and a mask multiplied in would turn inf * 0 into NaN;
//   * f32 (the model's path: ssd_chunked computes in f32): the CUDA cores, in
//     f32 (TF32 keeps ~3 digits).  256 threads; each forms a 4 x 4 block of the
//     tile's scores from 16-byte shared-memory reads along N, parks them in
//     shared memory, then accumulates a 4 x (P / 16) block of the output from
//     16-byte reads along the keys and along P;
//   * bf16: 4 warps of 16 query rows on the tensor cores, mma.sync m16n8k16
//     (bf16 in, f32 accumulate) for C.B^T and for scores.xdt, the score
//     fragments rounded to bf16 and re-packed in registers as the second
//     product's A fragments;
//   * any Q: the grid covers ceil(Q / 64) query tiles, and rows and keys past Q
//     are zero-filled in shared memory and never written; N and P are padded
//     with zeros in shared memory (to 4 in f32, to 16 in bf16);
//   * every operand is read through element strides of a (outer, inner, row)
//     cell layout, cell = outer * inner_count + inner, with the last dim
//     contiguous: a group's B and C rows shared by its heads come as a stride-0
//     inner dim (no per-head copy), and the output is written straight into the
//     layout the caller reads;
//   * the heaviest query tiles (most key tiles) are launched first, so the
//     short ones fill the tail.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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

__device__ __forceinline__ float load(const float* p) { return *p; }
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

// ---- f32: the CUDA cores ---------------------------------------------------

constexpr int F32_THREADS = 256;  // 16 x 16
constexpr int S_LD = BK + 4;      // row stride of the parked scores

__host__ __device__ inline int f32_ldn(int N) { return (N + 3) / 4 * 4 + 4; }

__host__ inline size_t f32_smem(int N, int P) {
  return sizeof(float) *
         (static_cast<size_t>(BQ + BK) * f32_ldn(N) + BK * P + BQ * S_LD +
          BQ + BK);
}

// TN output columns per thread: P / 16 (P = 32, 64, 128), or 1 with threads
// tx >= P idle in the second product (P <= 16)
template <int TN>
__global__ void __launch_bounds__(F32_THREADS)
    ssd_f32_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int ldn = f32_ldn(a.N), np4 = ldn - 4;
  float* c_s = smem;                     // [BQ][ldn]
  float* b_s = c_s + BQ * ldn;           // [BK][ldn]
  float* x_s = b_s + BK * ldn;           // [BK][P]
  float* s_s = x_s + BK * a.P;           // [BQ][S_LD]
  float* cq = s_s + BQ * S_LD;           // [BQ]
  float* ck = cq + BQ;                   // [BK]

  const int id = static_cast<int>(blockIdx.x);
  const int qt = a.n_qt - 1 - id / a.G, cell = id % a.G;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  const float* cum = a.cum + cell_offset(a.cs, cell, a.Gi);
  const float* cp = static_cast<const float*>(a.c) + cell_offset(a.ccs, cell, a.Gi);
  const float* bp = static_cast<const float*>(a.b) + cell_offset(a.bs, cell, a.Gi);
  const float* xp = static_cast<const float*>(a.x) + cell_offset(a.xs, cell, a.Gi);

  stage(c_s, ldn, np4, cp, a.ccs[2], q0, BQ, a.Q, a.N, tid, F32_THREADS);
  for (int r = tid; r < BQ; r += F32_THREADS)
    cq[r] = q0 + r < a.Q ? cum[(q0 + r) * a.cs[2]] : 0.f;

  float acc[4][TN];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = 0.f;

  const int n_kt = qt + 1;  // BK == BQ: key tiles 0 .. qt
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's products are done
    stage(b_s, ldn, np4, bp, a.bs[2], k0, BK, a.Q, a.N, tid, F32_THREADS);
    stage(x_s, a.P, a.P, xp, a.xs[2], k0, BK, a.Q, a.P, tid, F32_THREADS);
    for (int r = tid; r < BK; r += F32_THREADS)
      ck[r] = k0 + r < a.Q ? cum[(k0 + r) * a.cs[2]] : 0.f;
    __syncthreads();

    // scores of rows 4ty + r and keys tx + 16c, summed along N in order
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
    for (int k = 0; k < np4; k += 4) {
      float4 av[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        av[r] = *reinterpret_cast<const float4*>(&c_s[(4 * ty + r) * ldn + k]);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        bv[c] = *reinterpret_cast<const float4*>(&b_s[(tx + 16 * c) * ldn + k]);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[r][c] = fmaf(av[r].x, bv[c].x, s[r][c]);
          s[r][c] = fmaf(av[r].y, bv[c].y, s[r][c]);
          s[r][c] = fmaf(av[r].z, bv[c].z, s[r][c]);
          s[r][c] = fmaf(av[r].w, bv[c].w, s[r][c]);
        }
    }
    // the decay where j <= i (the exponent taken there only), 0 elsewhere
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int il = 4 * ty + r, jl = tx + 16 * c;
        const bool keep = k0 + jl <= q0 + il && q0 + il < a.Q;
        s_s[il * S_LD + jl] = keep ? s[r][c] * expf(cq[il] - ck[jl]) : 0.f;
      }
    __syncthreads();

    // out rows 4ty + r, columns tx * TN .. + TN - 1: scores . xdt
    if (TN > 1 || tx < a.P) {
      for (int j = 0; j < BK; j += 4) {
        float4 sv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          sv[r] = *reinterpret_cast<const float4*>(&s_s[(4 * ty + r) * S_LD + j]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float xv[TN];
          const float* row = &x_s[(j + e) * a.P + tx * TN];
          if constexpr (TN % 4 == 0) {
#pragma unroll
            for (int c = 0; c < TN; c += 4) {
              const float4 v = *reinterpret_cast<const float4*>(row + c);
              xv[c] = v.x;
              xv[c + 1] = v.y;
              xv[c + 2] = v.z;
              xv[c + 3] = v.w;
            }
          } else if constexpr (TN == 2) {
            const float2 v = *reinterpret_cast<const float2*>(row);
            xv[0] = v.x;
            xv[1] = v.y;
          } else {
            xv[0] = row[0];
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float se = e == 0 ? sv[r].x : e == 1 ? sv[r].y
                           : e == 2 ? sv[r].z : sv[r].w;
#pragma unroll
            for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(se, xv[c], acc[r][c]);
          }
        }
      }
    }
  }

  if (TN == 1 && tx >= a.P) return;
  float* op = a.out + cell_offset(a.os, cell, a.Gi);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + 4 * ty + r;
    if (i >= a.Q) continue;
#pragma unroll
    for (int c = 0; c < TN; ++c) op[i * a.os[2] + tx * TN + c] = acc[r][c];
  }
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

template <typename K>
int launch_kernel(K kernel, int threads, size_t smem, const Args& a,
                  cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned grid = static_cast<unsigned>(a.n_qt) * a.G;
  kernel<<<grid, threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int launch(const float* cum, const void* c, const void* b, const void* x,
           float* out, const int64_t* strides, int Go, int Gi, int Q, int N,
           int P, bool bf16, void* stream) {
  if (Go <= 0 || Gi <= 0 || Q <= 0) return 0;
  if (N <= 0 || N > 256 || P <= 0 || (P > 16 && P != 32 && P != 64 && P != 128))
    return static_cast<int>(cudaErrorInvalidValue);
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
  if (static_cast<int64_t>(a.n_qt) * a.G > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    const size_t smem = bf16_smem(N, P);
    switch ((P + 15) / 16) {
      case 1: return launch_kernel(ssd_bf16_kernel<1>, WARPS * 32, smem, a, st);
      case 2: return launch_kernel(ssd_bf16_kernel<2>, WARPS * 32, smem, a, st);
      case 4: return launch_kernel(ssd_bf16_kernel<4>, WARPS * 32, smem, a, st);
      case 8: return launch_kernel(ssd_bf16_kernel<8>, WARPS * 32, smem, a, st);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const size_t smem = f32_smem(N, P);
  if (P <= 16) return launch_kernel(ssd_f32_kernel<1>, F32_THREADS, smem, a, st);
  switch (P) {
    case 32: return launch_kernel(ssd_f32_kernel<2>, F32_THREADS, smem, a, st);
    case 64: return launch_kernel(ssd_f32_kernel<4>, F32_THREADS, smem, a, st);
    case 128: return launch_kernel(ssd_f32_kernel<8>, F32_THREADS, smem, a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// cum (cells, Q) f32; C and B (cells, Q, N) and xdt (cells, Q, P), all f32 or
// all bf16; out (cells, Q, P) f32; on the device of the current context.  The
// cells are (Go, Gi), cell = outer * Gi + inner, and every operand is addressed
// through element strides (outer, inner, row) with its last dim contiguous;
// `strides` is a host array of 15: cum's three, then C's, B's, xdt's and out's.
// N is at most 256; P is at most 16, or 32, 64 or 128.  Launches on `stream`
// and returns cudaGetLastError(), or cudaErrorInvalidValue for arguments it
// does not take.
extern "C" int ssd_intra_chunk_f32(const float* cum, const void* c,
                                   const void* b, const void* x, float* out,
                                   const int64_t* strides, int Go, int Gi,
                                   int Q, int N, int P, void* stream) {
  return launch(cum, c, b, x, out, strides, Go, Gi, Q, N, P, false, stream);
}

extern "C" int ssd_intra_chunk_bf16(const float* cum, const void* c,
                                    const void* b, const void* x, float* out,
                                    const int64_t* strides, int Go, int Gi,
                                    int Q, int N, int P, void* stream) {
  return launch(cum, c, b, x, out, strides, Go, Gi, Q, N, P, true, stream);
}
