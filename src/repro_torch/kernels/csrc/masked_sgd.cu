// masked_sgd: w[r, :] <- w[r, :] - s[r] * g[r, :], computed in f32 and stored
// in w's dtype.  The update is written in place into w.
//
// Replaces the Pallas kernel masked_sgd (src/repro/kernels/masked_sgd.py:26,
// kernel body _sgd_kernel :18).  The same function is the reference's inline
// local-SGD step at src/repro/core/fed_step.py:41-44, and that is where the
// port launches it: once per parameter leaf per local step, on the (C, n)
// stack of the clients' copies, with the per-client scale s = eta * alpha[:, e].
// The scalar form of the Pallas kernel, w and g of shape (D,) with one scale,
// is the one-row case.
//
// Bound by bytes on the H100: each element costs 12 bytes in f32 (read w,
// read g, write w) for 2 flops.  The design is one pass at the rate of
// device memory:
//   * in place: w is overwritten, so the step moves no byte more than it
//     must and allocates nothing (the reference's jit had the same from
//     buffer donation);
//   * a 2-D grid: blockIdx.y is the row (the client), so the row's scale is
//     one load per thread and no division by n is needed; blockIdx.x and the
//     threads cover the row in 16-byte vectors (4 f32 or 8 bf16) when n is a
//     multiple of the vector width and both buffers are 16-byte aligned, one
//     element per thread otherwise (the rows of a leaf are the clients'
//     copies of it, n apart, so a leaf of n = 2 mod 4 has rows off 16 bytes:
//     the paper CNN's b2, n = 62, takes that form on every step);
//   * w - s*g is rounded as the plain version rounds it (__fmul_rn, then
//     __fsub_rn: no FMA contraction).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(x);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
    masked_sgd_kernel(T* __restrict__ w, const T* __restrict__ g,
                      const float* __restrict__ scale, int64_t n) {
  const int64_t row = blockIdx.y;
  const int64_t col =
      (static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x) * VEC;
  if (col >= n) return;  // the launch keeps whole vectors inside the row
  const float s = scale[row];
  Vec<T, VEC>* wp = reinterpret_cast<Vec<T, VEC>*>(w + row * n + col);
  const Vec<T, VEC> gv =
      *reinterpret_cast<const Vec<T, VEC>*>(g + row * n + col);
  Vec<T, VEC> wv = *wp;
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    from_f32(__fsub_rn(to_f32(wv.v[j]), __fmul_rn(s, to_f32(gv.v[j]))),
             &wv.v[j]);
  *wp = wv;
}

template <typename T>
int launch(T* w, const T* g, const float* scale, int rows, int64_t n,
           cudaStream_t stream) {
  if (rows == 0 || n == 0) return 0;
  constexpr int VEC = 16 / sizeof(T);
  const bool vec = n % VEC == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(g) % 16 == 0;
  if (vec) {
    const dim3 grid(static_cast<unsigned>((n / VEC + THREADS - 1) / THREADS),
                    static_cast<unsigned>(rows));
    masked_sgd_kernel<T, VEC><<<grid, THREADS, 0, stream>>>(w, g, scale, n);
  } else {
    const dim3 grid(static_cast<unsigned>((n + THREADS - 1) / THREADS),
                    static_cast<unsigned>(rows));
    masked_sgd_kernel<T, 1><<<grid, THREADS, 0, stream>>>(w, g, scale, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// w, g (rows, n) row-major of one dtype, scale (rows,) f32; all on the device
// of the current context.  rows <= 65535 (the grid's y limit).  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int masked_sgd_f32(float* w, const float* g, const float* scale,
                              int rows, int64_t n, void* stream) {
  return launch(w, g, scale, rows, n, static_cast<cudaStream_t>(stream));
}

extern "C" int masked_sgd_bf16(void* w, const void* g, const float* scale,
                               int rows, int64_t n, void* stream) {
  return launch(static_cast<__nv_bfloat16*>(w),
                static_cast<const __nv_bfloat16*>(g), scale, rows, n,
                static_cast<cudaStream_t>(stream));
}
