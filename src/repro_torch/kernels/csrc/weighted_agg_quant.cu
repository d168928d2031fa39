// weighted_agg_quant:
//   out[d] = sum_k coeffs[k] * (payload[k, d] * scales[k, d / chunk]),
// the int8 codes dequantized in registers and reduced in f32.
//
// Replaces the Pallas kernel weighted_agg_quant
// (src/repro/kernels/weighted_agg.py:187, kernel body _agg_kernel_quant :162):
// the fused dequantize-and-reduce of the compressed round, which
// aggregate_deltas_flat launches once per round on the int8 and int8-topk
// wires.
//
// Bound by bytes on the H100: each code is read once (1 byte) and costs a
// convert, two multiplies and an add; the scales add 4 bytes per chunk of
// codes.  The time to beat is one pass over the payload, and the design is
// that pass with the dequantized deltas kept out of device memory:
//   * every row is read in 16-byte vectors of 16 codes, each thread one vector
//     per row, neighbouring threads on neighbouring addresses.  For that every
//     row must start on 16 bytes: rows lie `ld` bytes apart, ld a multiple of
//     16 and at least D (quantize_chunked pads the rows with zero codes when D
//     is not a multiple of 16), and the codes a row's last vector reads past D
//     are pad whose sums are never stored;
//   * each code takes the scale of its own chunk.  When chunk is a multiple of
//     16 a vector never straddles two chunks and takes one scale per row
//     (UNIFORM); otherwise the chunk of each of its 16 codes, as an offset
//     from the chunk of its first code, is computed once per thread, and every
//     code reads its own scale (neighbouring codes read the same word, from
//     L1);
//   * a loop over K inside the thread takes the place of the TPU's sequential
//     K grid axis; the coefficients are staged in shared memory in tiles of
//     KTILE, so any K works in one pass, the K > 64 case that the reference
//     streams in slabs included;
//   * codes are dequantized in registers and summed there: no (K, D) f32
//     buffer exists, the counterpart of the reference's VMEM-only tiles;
//   * no cross-block reduction and no atomics: one thread sums each output in
//     the order k = 0..K-1, and code*scale, its product with the coefficient
//     and the sum are each rounded on their own (__fmul_rn, __fadd_rn: no FMA
//     contraction), which is the arithmetic of the plain version in
//     weighted_agg.py, so the two are equal bit for bit.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 128;
constexpr int KTILE = 256;
constexpr int VEC = 16;

struct alignas(16) Codes {
  int8_t v[VEC];
};

template <bool UNIFORM>
__global__ void __launch_bounds__(THREADS)
    weighted_agg_quant_kernel(const float* __restrict__ coeffs,
                              const int8_t* __restrict__ payload, int64_t ld,
                              const float* __restrict__ scales, int64_t chunk,
                              float* __restrict__ out, int K, int64_t D) {
  __shared__ float cs[KTILE];
  const int64_t col =
      (static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x) * VEC;
  const bool live = col < D;
  const int64_t n_chunks = D / chunk;
  const int64_t g0 = col / chunk;  // the chunk of the vector's first code
  // the chunk of each code, relative to g0; pad codes past D take the last
  // chunk's scale (their sums are not stored)
  int off[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    off[j] = static_cast<int>((col + j < D ? col + j : D - 1) / chunk - g0);
  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += KTILE) {
    const int kt = min(KTILE, K - k0);
    __syncthreads();  // every thread is done with the previous tile
    for (int i = threadIdx.x; i < kt; i += THREADS) cs[i] = coeffs[k0 + i];
    __syncthreads();
    if (live) {
      const int8_t* row = payload + static_cast<int64_t>(k0) * ld + col;
      const float* srow = scales + static_cast<int64_t>(k0) * n_chunks + g0;
#pragma unroll 4
      for (int k = 0; k < kt; ++k, row += ld, srow += n_chunks) {
        const float c = cs[k];
        const Codes x = *reinterpret_cast<const Codes*>(row);
        if (UNIFORM) {
          const float s = srow[0];
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            acc[j] = __fadd_rn(
                acc[j],
                __fmul_rn(c, __fmul_rn(static_cast<float>(x.v[j]), s)));
        } else {
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            acc[j] = __fadd_rn(
                acc[j], __fmul_rn(c, __fmul_rn(static_cast<float>(x.v[j]),
                                               srow[off[j]])));
        }
      }
    }
  }
  if (!live) return;
  if (col + VEC <= D) {
    float4* o = reinterpret_cast<float4*>(out + col);
#pragma unroll
    for (int j = 0; j < VEC / 4; ++j)
      o[j] = make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2],
                         acc[4 * j + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      if (col + j < D) out[col + j] = acc[j];
  }
}

}  // namespace

// coeffs (K,) f32; payload K rows of D int8 codes, row k at payload + k * ld,
// with payload 16-byte aligned, ld a multiple of 16 and ld >= D (every row
// readable up to D rounded up to 16); scales (K, D / chunk) f32, contiguous;
// D a multiple of chunk; out (D,) f32, 16-byte aligned; all on the device of
// the current context.  Launches on `stream` and returns cudaGetLastError(),
// or cudaErrorInvalidValue for a layout it cannot read.
extern "C" int weighted_agg_quant(const float* coeffs, const void* payload,
                                  int64_t ld, const float* scales,
                                  int64_t chunk, float* out, int K, int64_t D,
                                  void* stream) {
  if (D == 0) return 0;
  if (chunk < 1 || D % chunk != 0 || ld % VEC != 0 || ld < D ||
      reinterpret_cast<uintptr_t>(payload) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (D + VEC * THREADS - 1) / (VEC * THREADS);
  const auto* codes = static_cast<const int8_t*>(payload);
  auto s = static_cast<cudaStream_t>(stream);
  if (chunk % VEC == 0)
    weighted_agg_quant_kernel<true><<<static_cast<unsigned>(blocks), THREADS,
                                      0, s>>>(coeffs, codes, ld, scales, chunk,
                                              out, K, D);
  else
    weighted_agg_quant_kernel<false><<<static_cast<unsigned>(blocks), THREADS,
                                       0, s>>>(coeffs, codes, ld, scales,
                                               chunk, out, K, D);
  return static_cast<int>(cudaGetLastError());
}
