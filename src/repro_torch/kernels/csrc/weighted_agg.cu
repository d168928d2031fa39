// weighted_agg: out[d] = sum_k coeffs[k] * deltas[k, d], accumulated in f32.
//
// Replaces the Pallas kernel weighted_agg (src/repro/kernels/weighted_agg.py:108,
// kernel bodies _agg_kernel :84 and _agg_kernel_ktiled :91): the Eq. 2
// reduction of the flattened (K, D) client deltas, which aggregate_deltas_flat
// launches once per round.
//
// Bound by bytes on the H100: each delta is read once and used for one
// multiply and one add, 2 flops per 4 bytes in f32, far below the flops per
// byte at which the card's f32 cores would become the limit.  The time to
// beat is the time to stream K*D elements from device memory once, and the
// design is one pass that keeps many loads in flight:
//   * every row is read in 16-byte vectors (4 f32 or 8 bf16), each thread one
//     vector of VEC adjacent columns per row, neighbouring threads on
//     neighbouring addresses.  For that every row must start on 16 bytes: the
//     rows lie `ld` elements apart, ld a multiple of VEC and at least D
//     rounded up to VEC, so the last vector of a row reads the row's padding
//     and a ragged D needs no second code path; the thread stores only the
//     columns below D (the wrapper in weighted_agg.py lays buffers out so);
//   * a loop over K inside the thread takes the place of the TPU's sequential
//     K grid axis; the coefficients are staged in shared memory in tiles of
//     KTILE, so any K works, the K > 64 case that the reference streams in
//     slabs included; the loop is unrolled so several rows are in flight;
//   * 128 threads per block, so that the few hundred blocks of a model's D
//     spread evenly over the 132 SMs;
//   * no cross-block reduction and no atomics: one thread sums each output in
//     the order k = 0..K-1, so the result is deterministic.  Products and sums
//     are rounded separately (__fmul_rn, __fadd_rn: no FMA contraction), which
//     is the arithmetic of the plain version in weighted_agg.py.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 128;
constexpr int KTILE = 256;

template <typename T>
struct alignas(16) Vec {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    weighted_agg_kernel(const float* __restrict__ coeffs,
                        const T* __restrict__ deltas, int64_t ld,
                        float* __restrict__ out, int K, int64_t D) {
  constexpr int VEC = Vec<T>::N;
  __shared__ float cs[KTILE];
  const int64_t col =
      (static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x) * VEC;
  const bool live = col < D;
  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += KTILE) {
    const int kt = min(KTILE, K - k0);
    __syncthreads();  // every thread is done with the previous tile
    for (int i = threadIdx.x; i < kt; i += THREADS) cs[i] = coeffs[k0 + i];
    __syncthreads();
    if (live) {
      const T* row = deltas + static_cast<int64_t>(k0) * ld + col;
#pragma unroll 8
      for (int k = 0; k < kt; ++k, row += ld) {
        const float c = cs[k];
        const Vec<T> x = *reinterpret_cast<const Vec<T>*>(row);
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          acc[j] = __fadd_rn(acc[j], __fmul_rn(c, to_f32(x.v[j])));
      }
    }
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      if (col + j < D) out[col + j] = acc[j];
  }
}

template <typename T>
int launch(const float* coeffs, const T* deltas, int64_t ld, float* out, int K,
           int64_t D, cudaStream_t stream) {
  if (D == 0) return 0;
  constexpr int VEC = Vec<T>::N;
  if (ld % VEC != 0 || ld < D || reinterpret_cast<uintptr_t>(deltas) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = ((D + VEC - 1) / VEC + THREADS - 1) / THREADS;
  weighted_agg_kernel<T><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      coeffs, deltas, ld, out, K, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// coeffs (K,) f32; deltas K rows of D elements, row k at deltas + k * ld, with
// deltas 16-byte aligned, ld a multiple of 16 / sizeof(element) and ld >= D
// (every row readable up to D rounded up to that multiple); out (D,) f32; all
// on the device of the current context.  Launches on `stream` and returns
// cudaGetLastError(), or cudaErrorInvalidValue for a layout it cannot read.
extern "C" int weighted_agg_f32(const float* coeffs, const float* deltas,
                                int64_t ld, float* out, int K, int64_t D,
                                void* stream) {
  return launch(coeffs, deltas, ld, out, K, D,
                static_cast<cudaStream_t>(stream));
}

extern "C" int weighted_agg_bf16(const float* coeffs, const void* deltas,
                                 int64_t ld, float* out, int K, int64_t D,
                                 void* stream) {
  return launch(coeffs, static_cast<const __nv_bfloat16*>(deltas), ld, out, K,
                D, static_cast<cudaStream_t>(stream));
}
