// weighted_agg_quant:
//   out[d] = sum_k coeffs[k] * (payload[k, d] * scales[k, d / chunk]),
// the int8 codes dequantized in registers and reduced in f32.
//
// Replaces the Pallas kernel weighted_agg_quant
// (src/repro/kernels/weighted_agg.py:187, kernel body _agg_kernel_quant :162):
// the fused dequantize-and-reduce of the compressed round, which
// aggregate_deltas_flat launches once per round on the int8 and int8-topk
// wires, and the sharded round once per rank on its slab.
//
// Bound by bytes on the H100: each code is read once (1 byte) and costs a
// conversion, two multiplies and an add; the scales add 4 bytes per chunk of
// codes.  At the int8 wire's shape, (62, 461,824) codes, the bytes take
// 9.2 us at 3.35 TB/s, and by Little's law an SM must keep 15-20 KB in
// flight to draw its share of that rate.  The design keeps the loads
// asynchronous and deep, and the arithmetic off the slow conversion pipe
// (PERF.md, Findings, says what the alternatives to each choice showed):
//   * persistent CTAs, min(SMs, tiles) of them; CTA c walks the column tiles
//     c, c + gridDim.x, ... of TILE = 512 codes, handing them in turn to its
//     GROUPS groups of WARPS_PER_PLACE consumer warps; each warp of a group
//     takes 128 of the tile's columns, 4 codes a lane, and sums its outputs
//     over all K rows;
//   * warp 0 produces.  Its lane 0 brings each tile's codes by TMA, as one
//     2-D box of (rows, TILE / 4) 32-bit words of the (K, ld) payload (512
//     bytes a row: narrower boxes were slower, the TMA unit's time going by
//     boxes more than by bytes), with K cut into boxes of at most
//     MAX_BOX_ROWS rows taken in order; the box lands in one place of its
//     group's ring of `stages` places, each with a full mbarrier and an
//     empty one (the group's warps are done with it).  At the wire's shape a
//     place holds 32 KB and the ring most of the SM's shared memory, so
//     nearly all of a CTA's share of the payload is asked for before the
//     first box arrives.  A group waits on a place's phase only after it
//     consumed the one before, and the waits spin with no timeout (a trap in
//     them makes ptxas spill).  Codes past D or rows past K arrive as zeros
//     (TMA's out-of-bounds fill) or as the rows' pad; their sums are never
//     stored and the loop over rows stops at K;
//   * the scales of the tile's chunks (sb of them a row: the chunks a tile
//     can touch) ride in the same place: warp 0's 32 lanes copy them with
//     4-byte cp.async and arrive on the full barrier as their copies land
//     (its count is 1 + 32).  A second TMA box a tile cost the TMA unit more
//     than the 2 KB it brings, and a box of scales must start on a 16-byte
//     boundary, which the chunks of 128 codes do not (an illegal-instruction
//     fault otherwise); cp.async takes any n_chunks.  This path (STAGED)
//     needs a chunk that 4 divides, so that a lane's 4 codes share one
//     scale, and a tile that touches at most SB_MAX chunks; on any other
//     chunk each code reads its own scale from device memory (PER_CODE);
//   * a lane reads its 4 codes of a row as one 32-bit word, neighbouring
//     lanes on neighbouring words (conflict-free), and turns each code into
//     f32 without the I2F pipe: the byte xor 0x80 put under the exponent of
//     2^23 (one PRMT) is the float 2^23 + 128 + code, and one subtract of
//     8,388,736 leaves the code, exact for every int8.  Each warp stages its
//     box's coefficients in shared memory, read as broadcasts; no (K, D) f32
//     buffer exists, the counterpart of the reference's VMEM-only tiles;
//   * no cross-block reduction and no atomics: one lane sums each output in
//     the order k = 0..K-1, and code*scale, its product with the coefficient
//     and the sum are each rounded on their own (__fmul_rn, __fadd_rn: no FMA
//     contraction), which is the arithmetic of the plain version in
//     weighted_agg.py, so the two are equal bit for bit.
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper_async.cuh"

namespace {

constexpr int WARP_CODES = 128;  // a consumer warp's columns: 32 lanes x 4
constexpr int CONSUMER_WARPS = 16;
constexpr int WARPS_PER_PLACE = 4;  // the consumer warps that share a place
constexpr int GROUPS = CONSUMER_WARPS / WARPS_PER_PLACE;
constexpr int TILE = WARP_CODES * WARPS_PER_PLACE;  // a box's columns
static_assert(TILE <= 1024, "a box row is at most 256 32-bit words");
constexpr int THREADS = 32 * (1 + CONSUMER_WARPS);  // warp 0 produces
constexpr int MAX_BOX_ROWS = 64;  // two coefficients per lane
static_assert(MAX_BOX_ROWS <= 64, "a lane loads two coefficients of a box");
constexpr int MAX_STAGES = 4;     // ring places per group
constexpr int SB_MAX = 36;        // scales a row of a place holds
constexpr int ALIGN = 128;        // TMA writes boxes at 128-byte addresses
constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }
// shared memory: the full and empty mbarriers of every place, each consumer
// warp's coefficients of its box, then the ring
constexpr int BAR_BYTES = round_up(16 * GROUPS * MAX_STAGES, ALIGN);
constexpr int COEF_BYTES = 4 * 64 * CONSUMER_WARPS;
constexpr int RING_OFFSET = BAR_BYTES + COEF_BYTES;
static_assert(RING_OFFSET % ALIGN == 0, "the ring starts aligned");

enum Path { STAGED, PER_CODE };

struct Args {
  const float* coeffs;
  const float* scales;
  float* out;
  int64_t D, chunk, n_chunks;
  int K;
  int rows;     // rows of a box (a tile's last box may reach past K)
  int n_boxes;  // boxes per tile
  int n_tiles;
  int stages;   // ring places per group
  int sb;       // scales per row of a place (the chunks a tile can touch)
  uint32_t code_bytes;   // a place's codes, rows x TILE bytes
  uint32_t place_bytes;  // a place: the codes, then the staged scales
};

__device__ __forceinline__ uint32_t full_bar(uint32_t bars, int p) {
  return bars + 8 * p;
}

__device__ __forceinline__ uint32_t empty_bar(uint32_t bars, int p) {
  return bars + 8 * (GROUPS * MAX_STAGES + p);
}

// One 4-byte asynchronous copy from device memory into shared memory.
__device__ __forceinline__ void cp_async_4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// An arrival on `bar` once every cp.async this thread issued has landed;
// it counts against the barrier's expected arrivals.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// The CTA's lt-th tile, or -1 past its last: CTA c takes tiles c,
// c + gridDim.x, ...
__device__ __forceinline__ int tile_of(const Args& a, int lt) {
  const int tile = static_cast<int>(blockIdx.x + lt * gridDim.x);
  return tile < a.n_tiles ? tile : -1;
}

// Code j of a word whose 4 bytes were flipped by 0x80: 0x4B0000xx is the
// float 2^23 + xx, and xx = code + 128.
__device__ __forceinline__ float code_of(uint32_t flipped, int j) {
  const uint32_t bits = __byte_perm(flipped, 0x4B000000u, 0x7440u + j);
  return __fsub_rn(__uint_as_float(bits), 8388736.f);
}

// Warp 0: lane 0 brings each box of codes by TMA, and the warp's 32 lanes
// copy the box's rows' scales of the tile's chunks beside it by cp.async;
// each lane arrives on the place's full barrier once its copies landed.
template <int PATH>
__device__ void produce(const Args& a, const CUtensorMap* codes,
                        unsigned char* ring, uint32_t bars, int lane) {
  for (int lt = 0;; ++lt) {
    const int tile = tile_of(a, lt);
    if (tile < 0) break;
    const int grp = lt % GROUPS;
    const int64_t t0 = static_cast<int64_t>(tile) * TILE;
    const int64_t c0 = t0 / a.chunk;  // the tile's first chunk
    const int sbw = static_cast<int>(
        a.n_chunks - c0 < a.sb ? a.n_chunks - c0 : a.sb);
    for (int b = 0; b < a.n_boxes; ++b) {
      const int i = lt / GROUPS * a.n_boxes + b;  // the group's i-th place
      const int p = grp * a.stages + i % a.stages;
      const int k0 = b * a.rows, nr = min(a.rows, a.K - k0);
      if (i >= a.stages)
        mbar_wait(empty_bar(bars, p), (i / a.stages - 1) & 1);
      unsigned char* place = ring + static_cast<size_t>(a.place_bytes) * p;
      if (lane == 0) {
        mbar_expect_tx(full_bar(bars, p), static_cast<int>(a.code_bytes));
        tma_load_2d(smem_u32(place), codes, static_cast<int>(t0 / 4), k0,
                    full_bar(bars, p));
      }
      if (PATH == STAGED) {
        float* sc = reinterpret_cast<float*>(place + a.code_bytes);
        for (int g = 0; g < sbw; ++g)
          for (int r = lane; r < nr; r += 32)
            cp_async_4(sc + r * a.sb + g,
                       a.scales + static_cast<int64_t>(k0 + r) * a.n_chunks +
                           c0 + g);
      }
      cp_async_arrive(full_bar(bars, p));
    }
  }
}

template <int PATH>
__device__ void consume(const Args& a, unsigned char* ring, float* cs,
                        uint32_t bars, int cw, int lane) {
  const int grp = cw / WARPS_PER_PLACE, sub = cw % WARPS_PER_PLACE;
  for (int lt = grp, i = 0;; lt += GROUPS) {
    const int tile = tile_of(a, lt);
    if (tile < 0) break;
    const int64_t t0 = static_cast<int64_t>(tile) * TILE;
    const int64_t c0 = t0 / a.chunk;  // the tile's first chunk
    const int64_t col = t0 + sub * WARP_CODES + 4 * lane;
    // the chunk of each of the lane's codes, from c0; codes past D take the
    // last chunk's scale (their sums are not stored)
    int off[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      off[j] = static_cast<int>((col + j < a.D ? col + j : a.D - 1) / a.chunk -
                                c0);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int b = 0; b < a.n_boxes; ++b, ++i) {
      const int p = grp * a.stages + i % a.stages;
      const int k0 = b * a.rows, nr = min(a.rows, a.K - k0);
      // the box's coefficients, loaded while its codes are in flight
      const float c_lo = lane < nr ? __ldg(a.coeffs + k0 + lane) : 0.f;
      const float c_hi = lane + 32 < nr ? __ldg(a.coeffs + k0 + 32 + lane)
                                        : 0.f;
      mbar_wait(full_bar(bars, p), (i / a.stages) & 1);
      const unsigned char* place =
          ring + static_cast<size_t>(p) * a.place_bytes;
      cs[lane] = c_lo;
      cs[lane + 32] = c_hi;
      __syncwarp();
      const uint32_t* codes =
          reinterpret_cast<const uint32_t*>(place) + sub * 32 + lane;
      const float* sc = reinterpret_cast<const float*>(place + a.code_bytes);
      const float* srow =
          a.scales + static_cast<int64_t>(k0) * a.n_chunks + c0;
#pragma unroll 4
      for (int r = 0; r < nr; ++r, srow += a.n_chunks) {
        const float c = cs[r];
        const uint32_t w = codes[r * (TILE / 4)] ^ 0x80808080u;
        float s[4];
        if (PATH == STAGED) {
          s[0] = s[1] = s[2] = s[3] = sc[r * a.sb + off[0]];
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) s[j] = __ldg(srow + off[j]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[j] = __fadd_rn(acc[j],
                             __fmul_rn(c, __fmul_rn(code_of(w, j), s[j])));
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_bar(bars, p));
    }
    if (col + 4 <= a.D) {
      *reinterpret_cast<float4*>(a.out + col) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (col + j < a.D) a.out[col + j] = acc[j];
    }
  }
}

template <int PATH>
__global__ void __launch_bounds__(THREADS, 1)
    weighted_agg_quant_kernel(const Args a,
                              const __grid_constant__ CUtensorMap codes) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((ALIGN - (smem_u32(smem_raw) & (ALIGN - 1))) & (ALIGN - 1));
  const uint32_t bars = smem_u32(smem);
  unsigned char* ring = smem + RING_OFFSET;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int p = 0; p < GROUPS * a.stages; ++p) {
      // lane 0's arrival with the box's bytes, and the producer's 32 lanes'
      // once their scales landed
      mbar_init(full_bar(bars, p), 1 + 32);
      mbar_init(empty_bar(bars, p), WARPS_PER_PLACE);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == 0) {
    produce<PATH>(a, &codes, ring, bars, lane);
  } else {
    float* cs = reinterpret_cast<float*>(smem + BAR_BYTES) + 64 * (warp - 1);
    consume<PATH>(a, ring, cs, bars, warp - 1, lane);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

constexpr int MAX_DEVICES = 64;

struct Plan {
  Args a;
  Path path;
  int dev, optin;  // the current device and its shared memory per block
  unsigned grid;
  size_t smem;
  CUtensorMap codes;
};

// The launch's path, boxes, ring and grid, and its tensor map; 0, or the
// CUDA error for a layout the kernel cannot read.
int make_plan(const float* coeffs, const void* payload, int64_t ld,
              const float* scales, int64_t chunk, float* out, int K,
              int64_t D, Plan* plan) {
  // a box's first word is an int coordinate
  if (K < 1 || D < 1 || D / 4 > INT32_MAX - TILE || chunk < 1 ||
      D % chunk != 0 || ld % 16 != 0 || ld < D || !aligned16(payload) ||
      !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  // the device's SMs and shared memory a block may have, asked once
  static int sms[MAX_DEVICES], optin[MAX_DEVICES];
  if (sms[dev] == 0) {
    int n = 0, bytes = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    optin[dev] = bytes;
    sms[dev] = n;
  }
  plan->dev = dev;
  plan->optin = optin[dev];
  Args& a = plan->a;
  a.coeffs = coeffs;
  a.scales = scales;
  a.out = out;
  a.D = D;
  a.chunk = chunk;
  a.n_chunks = D / chunk;
  a.K = K;
  a.n_boxes = (K + MAX_BOX_ROWS - 1) / MAX_BOX_ROWS;
  a.rows = (K + a.n_boxes - 1) / a.n_boxes;
  a.n_tiles = static_cast<int>((D + TILE - 1) / TILE);
  a.code_bytes = static_cast<uint32_t>(a.rows * TILE);
  // the chunks a tile can touch: staged beside its codes where they are
  // few and a lane's 4 codes share one chunk
  const int span = static_cast<int>((TILE - 1) / chunk) + 2;
  plan->path = span <= SB_MAX && chunk % 4 == 0 ? STAGED : PER_CODE;
  a.sb = plan->path == STAGED ? span : 0;
  a.place_bytes = a.code_bytes + round_up(a.rows * a.sb * 4, ALIGN);
  a.stages = (optin[dev] - RING_OFFSET - ALIGN) /
             (GROUPS * static_cast<int>(a.place_bytes));
  if (a.stages > MAX_STAGES) a.stages = MAX_STAGES;
  if (a.stages < 1) return static_cast<int>(cudaErrorInvalidValue);
  // the codes as 32-bit words, 4 to a word: rows are whole 16-byte vectors
  // and the words of a row past D read pad (or zeros past the row's end)
  const EncodeTiled encode = encode_tiled();
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>((D + 3) / 4),
                              static_cast<cuuint64_t>(K)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld)};
  const cuuint32_t box[2] = {TILE / 4, static_cast<cuuint32_t>(a.rows)};
  const cuuint32_t unit[2] = {1, 1};
  if (encode == nullptr ||
      encode(&plan->codes, CU_TENSOR_MAP_DATA_TYPE_UINT32, 2,
             const_cast<void*>(payload), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  plan->grid =
      static_cast<unsigned>(a.n_tiles < sms[dev] ? a.n_tiles : sms[dev]);
  plan->smem = RING_OFFSET + ALIGN +
               static_cast<size_t>(GROUPS) * a.stages * a.place_bytes;
  return 0;
}

template <int PATH>
int launch(const Plan& plan, cudaStream_t stream) {
  const auto kernel = weighted_agg_quant_kernel<PATH>;
  // the kernel may take all of a block's shared memory: set once a device
  static bool opted_in[MAX_DEVICES];
  if (!opted_in[plan.dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.optin);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[plan.dev] = true;
  }
  kernel<<<plan.grid, THREADS, plan.smem, stream>>>(plan.a, plan.codes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// coeffs (K,) f32; payload K rows of D int8 codes, row k at payload + k * ld,
// with payload 16-byte aligned, ld a multiple of 16 and ld >= D; scales
// (K, D / chunk) f32, contiguous; D a multiple of chunk, D / 4 below
// 2^31 - 512;
// out (D,) f32, 16-byte aligned; all on the device of the current context.
// Launches on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a layout it cannot read.
extern "C" int weighted_agg_quant(const float* coeffs, const void* payload,
                                  int64_t ld, const float* scales,
                                  int64_t chunk, float* out, int K, int64_t D,
                                  void* stream) {
  if (D == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (K == 0 && D > 0) {
    cudaMemsetAsync(out, 0, static_cast<size_t>(D) * sizeof(float), s);
    return static_cast<int>(cudaGetLastError());
  }
  Plan plan{};
  const int err = make_plan(coeffs, payload, ld, scales, chunk, out, K, D,
                            &plan);
  if (err) return err;
  return plan.path == STAGED ? launch<STAGED>(plan, s)
                             : launch<PER_CODE>(plan, s);
}

// What a launch on these arguments would do, without launching: out[0] the
// scales a ring place stages per row (0: each code reads its own from
// device memory), out[1] rows per box, out[2] boxes per tile, out[3] ring
// places per group of consumer warps, out[4] CTAs, out[5] bytes of shared
// memory.  Returns make_plan's error, the tensor map's encoding included.
extern "C" int weighted_agg_quant_plan(const void* payload, int64_t ld,
                                       const float* scales, int64_t chunk,
                                       int K, int64_t D, int* out) {
  Plan plan{};
  // the plan reads no coefficient and writes no output: a 16-byte aligned
  // stand-in passes the alignment check
  const int err = make_plan(nullptr, payload, ld, scales, chunk,
                            reinterpret_cast<float*>(16), K, D, &plan);
  if (err) return err;
  const int v[6] = {plan.a.sb, plan.a.rows, plan.a.n_boxes, plan.a.stages,
                    static_cast<int>(plan.grid), static_cast<int>(plan.smem)};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}
