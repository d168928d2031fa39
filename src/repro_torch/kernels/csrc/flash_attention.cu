// flash_attention: the forward pass of softmax attention with an online
// softmax, causal or not, for one (batch, head) row of query tiles per grid row.
//
//   o[b,h,i,:] = sum_j softmax_j(q[b,h,i,:] . k[b,kv,j,:] / sqrt(hd)) v[b,kv,j,:]
//   with kv = h / (H / KV) (grouped-query heads share a KV head), keys j >= S
//   masked, and under causal masking keys j > i masked.
//
// Replaces the Pallas kernel flash_attention (src/repro/kernels/flash_attention.py:64,
// body _flash_kernel :21): the attention of every layer of an LM prefill.  Its
// arithmetic is the Pallas kernel's: scores in f32 times 1/sqrt(hd), masked
// scores set to -1e30, a running row max m, denominator l and f32 accumulator
// per query row, the probabilities rounded to v's type before the P.V product
// (accumulated in f32), l floored at 1e-30 at the end, the output in q's type.
//
// Bound by operations on the H100 at the serving shapes: 4 flops per score
// (two products of hd-long rows) against 2*hd bytes per key row shared by a
// whole tile of query rows, so the tensor cores, not device memory, set the
// pace.  The design:
//   * the TPU kernel's sequential kv grid axis, which carries m, l and the
//     accumulator in VMEM scratch from step to step, becomes a loop inside one
//     CTA: one CTA per (b*h, q-tile) walks the KV tiles in order, staging each
//     K and V tile in shared memory, and keeps m, l and the accumulator in
//     registers;
//   * bf16 (the serving type): 4 warps, 16 query rows each (BQ = 64), KV tiles
//     of 64 keys; Q.K^T and P.V on the tensor cores with mma.sync m16n8k16
//     (bf16 in, f32 accumulate).  Q is loaded once into A fragments; K and V
//     tiles arrive by cp.async in two groups, so the V copy overlaps Q.K^T; the
//     rows of the tiles are padded by 16 bytes so ldmatrix reads them without
//     bank conflicts; the score fragments become P's A fragments in registers
//     (the C layout of two n8 tiles is the A layout of one k16 step);
//   * f32: no tensor-core type keeps f32's precision (TF32 keeps ~3 digits),
//     so the product runs on the CUDA cores: hd/32 threads per query row, each
//     owning 32 of its dims in 16-byte chunks, a shuffle sum per score;
//   * under causal masking the KV tiles wholly above the diagonal are skipped
//     (the Pallas kernel computes them and masks every score: they add exactly
//     0 to l and the accumulator), and the grid launches the longest rows of
//     tiles first so the short ones fill the tail;
//   * q, k, v and o are read and written through their strides (the last dim
//     contiguous), so the (B, S, H, hd) projections of the model are read in
//     place and the output is written straight into the (B, S, H, hd) layout
//     the output projection reads: no transposing copy on either side.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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

__device__ __forceinline__ int n_kv_tiles(const Args& a, int q0, int bq,
                                          int bk) {
  int n = (a.S + bk - 1) / bk;
  if (a.causal) n = min(n, (q0 + bq - 1) / bk + 1);
  return n;
}

// ---- bf16: mma.sync on the tensor cores -------------------------------------

constexpr int BQ = 64;   // query rows per CTA, 16 per warp
constexpr int BK = 64;   // keys per KV tile
constexpr int WARPS = 4;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool live) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = live ? 16 : 0;  // 0: no read, the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
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
template <int HD>
__global__ void __launch_bounds__(WARPS * 32)
    flash_bf16_kernel(const Args a) {
  constexpr int LD = HD + 8;  // smem row stride: 16 bytes of pad per row
  constexpr int KSTEPS = HD / 16;
  constexpr int NT = BK / 8;  // n8 tiles of scores per warp
  constexpr int CH = HD / 8;  // 16-byte chunks per row
  __shared__ __align__(16) __nv_bfloat16 k_s[BK * LD];
  __shared__ __align__(16) __nv_bfloat16 v_s[BK * LD];

  const int n_qt = (a.S + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * BQ;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int kvh = h / (a.H / a.KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  const __nv_bfloat16* qp =
      static_cast<const __nv_bfloat16*>(a.q) + b * a.qs[0] + h * a.qs[1];
  const __nv_bfloat16* kp =
      static_cast<const __nv_bfloat16*>(a.k) + b * a.ks[0] + kvh * a.ks[1];
  const __nv_bfloat16* vp =
      static_cast<const __nv_bfloat16*>(a.v) + b * a.vs[0] + kvh * a.vs[1];

  // Q's A fragments for every k16 step of hd, once; rows past S read as 0
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = rows[r & 1];
      const int col = kk * 16 + 2 * t + (r >> 1) * 8;
      qf[kk][r] = row < a.S ? *reinterpret_cast<const uint32_t*>(
                                  qp + row * a.qs[2] + col)
                            : 0u;
    }

  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  const int n_kt = n_kv_tiles(a, q0, BQ, BK);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous tiles
    for (int i = threadIdx.x; i < BK * CH; i += WARPS * 32) {
      const int r = i / CH, c = (i % CH) * 8, key = k0 + r;
      const bool live = key < a.S;  // keys past S are zero-filled
      cp_async16(&k_s[r * LD + c], kp + (live ? key : 0) * a.ks[2] + c, live);
    }
    cp_async_commit();
    for (int i = threadIdx.x; i < BK * CH; i += WARPS * 32) {
      const int r = i / CH, c = (i % CH) * 8, key = k0 + r;
      const bool live = key < a.S;
      cp_async16(&v_s[r * LD + c], vp + (live ? key : 0) * a.vs[2] + c, live);
    }
    cp_async_commit();
    cp_async_wait<1>();  // K has arrived; V may still be in flight
    __syncthreads();

    // scores: 16 rows x BK keys per warp, f32
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
      for (int nj = 0; nj < BK / 16; ++nj) {
        // matrices: keys +0 dims +0, keys +0 dims +8, keys +8 dims +0,
        // keys +8 dims +8 -> B fragments of n tiles 2nj and 2nj+1
        uint32_t bf[4];
        ldmatrix_x4(bf, &k_s[(nj * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                             kk * 16 + ((lane >> 3) & 1) * 8]);
        mma_bf16(s[2 * nj], qf[kk], bf[0], bf[1]);
        mma_bf16(s[2 * nj + 1], qf[kk], bf[2], bf[3]);
      }

    // scale, mask, online softmax per row (a row's 4 lanes share it)
    float cur[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = rows[e >> 1], key = k0 + j * 8 + 2 * t + (e & 1);
        const bool valid = key < a.S && (!a.causal || key <= row);
        s[j][e] = valid ? s[j][e] * a.scale : NEG_INF;
        cur[e >> 1] = fmaxf(cur[e >> 1], s[j][e]);
      }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      cur[i] = fmaxf(cur[i], __shfl_xor_sync(FULL, cur[i], 1));
      cur[i] = fmaxf(cur[i], __shfl_xor_sync(FULL, cur[i], 2));
      const float m_new = fmaxf(m[i], cur[i]);
      corr[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m[e >> 1]);
        sum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(FULL, sum[i], 1);
      sum[i] += __shfl_xor_sync(FULL, sum[i], 2);
      l[i] = corr[i] * l[i] + sum[i];
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];

    cp_async_wait<0>();  // V has arrived
    __syncthreads();
    // acc += P (bf16) . V: the C fragments of score tiles 2kk and 2kk+1 are
    // the A fragment of key step kk
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < HD / 16; ++dn) {
        // transposed matrices: keys +0 dims +0, keys +8 dims +0, keys +0
        // dims +8, keys +8 dims +8 -> B fragments of dim tiles 2dn, 2dn+1
        uint32_t bf[4];
        ldmatrix_x4_trans(
            bf, &v_s[(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                     dn * 16 + (lane >> 4) * 8]);
        mma_bf16(acc[2 * dn], pa, bf[0], bf[1]);
        mma_bf16(acc[2 * dn + 1], pa, bf[2], bf[3]);
      }
    }
  }

  __nv_bfloat16* op =
      static_cast<__nv_bfloat16*>(a.o) + b * a.os[0] + h * a.os[1];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= a.S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<uint32_t*>(op + rows[i] * a.os[2] + n * 8 + 2 * t) =
          pack_bf16(acc[n][2 * i] / den, acc[n][2 * i + 1] / den);
  }
}

// ---- f32: the CUDA cores ----------------------------------------------------

constexpr int F32_BQ = 64;  // query rows per CTA
constexpr int F32_BK = 32;  // keys per KV tile
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

  const int n_kt = n_kv_tiles(a, q0, F32_BQ, F32_BK);
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

template <int HD>
int launch_hd(const Args& a, int B, bool bf16, cudaStream_t stream) {
  if (bf16) {
    const dim3 grid((a.S + BQ - 1) / BQ, B * a.H);
    flash_bf16_kernel<HD><<<grid, WARPS * 32, 0, stream>>>(a);
  } else {
    const dim3 grid((a.S + F32_BQ - 1) / F32_BQ, B * a.H);
    flash_f32_kernel<HD><<<grid, F32_BQ * HD / 32, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

int launch(const void* q, const void* k, const void* v, void* o,
           const int64_t* strides, int B, int H, int KV, int S, int hd,
           int causal, float scale, bool bf16, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
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
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, H, S, hd), k and v (B, KV, S, hd), o (B, H, S, hd), all of one type
// (bf16 or f32) on the device of the current context, each addressed through
// element strides (batch, head, position) with the dim contiguous; `strides`
// is a host array of 12: q's three, then k's, v's and o's.  Every row must
// start on 16 bytes.  hd is 32, 64 or 128; H a multiple of KV; B * H at most
// 65535.  Launches on `stream` and returns cudaGetLastError(), or
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
