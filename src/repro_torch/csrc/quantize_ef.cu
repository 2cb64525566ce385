// Fused error feedback + stochastic int8 quantization, hand-written for
// Hopper (sm_90a). Built by repro_torch/kernels/_build.py with plain nvcc
// into a shared library with a C interface, loaded with ctypes.
//
// Replaces two Pallas TPU kernels of src/repro/kernels/quantize.py (tile
// body `_qef_body`), one instantiation each:
//   * `_quantize_ef_kernel` (B1): the level count L is a kernel argument;
//     exported as quantize_ef_f32. Rows of 1024 columns, the width of
//     every comm bucket's rows, run quantize_ef_row1024 (one warp a row);
//     other widths run quantize_ef_rows.
//   * `_quantize_ef_kernel_dyn` (B2): L is read from a one-element f32
//     array in device memory (a row of the adaptive PlanFamily's levels
//     table, selected on the device by the round's participant count), so
//     one launch serves every family member without a host sync; exported
//     as quantize_ef_dyn_f32. Thread 0 of each block reads L once into
//     shared memory.
//
// Per row of C elements (one scale block):
//     m  = g + e
//     s  = max|m| + 1e-20
//     lv = m / s * L;   low = floor(lv);   q = low + (rand < lv - low)
//     e' = m - q * (s / L)
// Outputs: int8 codes (R, C), f32 scale (R, 1), f32 e' (R, C).
//
// Bound: device memory. Each element reads g, e and rand (12 B) and writes
// its code and e' (5 B), 17 B per element plus 4 B of scale per row, for
// about ten flops: far below the card's flop-per-byte ridge. At dcgan32
// (buckets of 648, 648 and 512 rows) that is 31.5 MB per training step,
// 9.4 us at the H100's 3.35 TB/s; B2 over four stacked workers moves four
// times that. A launch costs about 5 us on its own, so the one-worker
// trainer packs a step's buckets back to back and makes one B1 launch a
// step, not one a bucket. Both bodies move every byte across DRAM once.
// quantize_ef_rows: one block of 256 threads per row, each
// thread keeps its float4 slices of m in registers between the row-max
// reduction and the quantize pass, loads and stores are 16 B per thread
// (4 B for the int8 codes), and the row max is a warp shuffle plus one
// shared-memory step. Rows longer than kMaxCached elements re-read g and e
// in the second pass instead (an L2 hit for a row this block just read).
//
// The arithmetic follows the plain PyTorch version operation for operation:
// IEEE division, and __fmul_rn/__fadd_rn/__fsub_rn so that nvcc does not
// contract a multiply and an add into an FMA with another rounding. Do not
// build with --use_fast_math: codes depend on exact division and on floor
// of negative values.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxVecs = 8;  // float4 slices per thread held in registers
constexpr int kMaxCached = kThreads * kMaxVecs * 4;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ float absmax4(float4 m) {
  return fmaxf(fmaxf(fabsf(m.x), fabsf(m.y)), fmaxf(fabsf(m.z), fabsf(m.w)));
}

// One element: stochastic round of m/s*L, and the residual it leaves.
template <typename Code>
__device__ __forceinline__ float quant1(float m, float r, float s, float L,
                                        float step, Code* code) {
  const float lv = __fmul_rn(__fdiv_rn(m, s), L);
  const float low = floorf(lv);
  const float q = (r < __fsub_rn(lv, low)) ? __fadd_rn(low, 1.0f) : low;
  *code = static_cast<Code>(static_cast<int>(q));
  return __fsub_rn(m, __fmul_rn(q, step));
}

__device__ __forceinline__ void quant4(float4 m, float4 r, float s, float L,
                                       float step, char4* code, float4* enew) {
  char4 c;
  float4 o;
  o.x = quant1(m.x, r.x, s, L, step, &c.x);
  o.y = quant1(m.y, r.y, s, L, step, &c.y);
  o.z = quant1(m.z, r.z, s, L, step, &c.z);
  o.w = quant1(m.w, r.w, s, L, step, &c.w);
  *code = c;
  *enew = o;
}

// Block-wide max of a per-thread value; every thread gets the result.
__device__ __forceinline__ float block_max(float v) {
  __shared__ float warp_part[kWarps];
  __shared__ float total;
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) warp_part[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    float w = threadIdx.x < kWarps ? warp_part[threadIdx.x] : 0.0f;
    w = warp_max(w);
    if (threadIdx.x == 0) total = w;
  }
  __syncthreads();
  return total;
}

// NV > 0: the row's m stays in registers (NV float4 per thread).
// NV == 0: rows longer than kMaxCached; the second pass recomputes m.
// kDyn: L is *levels_dev (B2) instead of `levels` (B1).
template <int NV, bool kDyn>
__global__ void __launch_bounds__(kThreads)
quantize_ef_rows(const float* __restrict__ g, const float* __restrict__ e,
                 const float* __restrict__ rand, signed char* __restrict__ codes,
                 float* __restrict__ scale, float* __restrict__ e_new, int cols,
                 float levels, const float* __restrict__ levels_dev) {
  __shared__ float levels_sh;
  if constexpr (kDyn) {
    // one read per block; block_max's barriers publish it to every thread
    if (threadIdx.x == 0) levels_sh = *levels_dev;
  }
  const size_t base = static_cast<size_t>(blockIdx.x) * cols;
  const int nvec = cols / 4;
  const float4* g4 = reinterpret_cast<const float4*>(g + base);
  const float4* e4 = reinterpret_cast<const float4*>(e + base);
  const float4* r4 = reinterpret_cast<const float4*>(rand + base);
  char4* c4 = reinterpret_cast<char4*>(codes + base);
  float4* n4 = reinterpret_cast<float4*>(e_new + base);

  float amax = 0.0f;
  float4 m[NV > 0 ? NV : 1];
  if constexpr (NV > 0) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int v = threadIdx.x + j * kThreads;
      if (v < nvec) {
        m[j] = add4(g4[v], e4[v]);
        amax = fmaxf(amax, absmax4(m[j]));
      }
    }
  } else {
    for (int v = threadIdx.x; v < nvec; v += kThreads)
      amax = fmaxf(amax, absmax4(add4(g4[v], e4[v])));
  }

  const float s = __fadd_rn(block_max(amax), 1e-20f);
  const float L = kDyn ? levels_sh : levels;
  const float step = __fdiv_rn(s, L);

  if constexpr (NV > 0) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int v = threadIdx.x + j * kThreads;
      if (v < nvec) quant4(m[j], r4[v], s, L, step, &c4[v], &n4[v]);
    }
  } else {
    for (int v = threadIdx.x; v < nvec; v += kThreads)
      quant4(add4(g4[v], e4[v]), r4[v], s, L, step, &c4[v], &n4[v]);
  }
  if (threadIdx.x == 0) scale[blockIdx.x] = s;
}

// B1 over rows of exactly 1024 columns: one warp a row, kRowsPerBlock rows
// a block. At dcgan32 a step's 1808 rows are 226 blocks of 8 warps, one
// wave on 132 SMs. Each lane holds 8 float4 of the row (slices lane,
// lane + 32, ..., lane + 224) in registers from the row max to the
// quantize pass. All 16 of its g and e loads and its 8 rand loads are
// issued before the first add, so a lane has 384 bytes in flight and the
// rand latency hides behind the adds and the row max. The row max is five
// shuffles: no shared memory, no barrier. The arithmetic is quant1's, so
// the results are those of quantize_ef_rows and of the plain version to
// the last bit (the row max is exact in any order). One launch still pays
// the card's launch floor (about 5 us) before it moves its 9.4 us of
// bytes; the time goes to the floor and to DRAM, not to this body.
constexpr int kRowCols = 1024;
constexpr int kRowVecs = kRowCols / 4 / 32;  // float4 slices per lane
constexpr int kRowsPerBlock = 8;

__global__ void __launch_bounds__(kRowsPerBlock * 32)
quantize_ef_row1024(const float* __restrict__ g, const float* __restrict__ e,
                    const float* __restrict__ rand,
                    signed char* __restrict__ codes,
                    float* __restrict__ scale, float* __restrict__ e_new,
                    int rows, float levels) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves: the shuffles see 32
  const size_t base = static_cast<size_t>(row) * kRowCols;
  const float4* g4 = reinterpret_cast<const float4*>(g + base) + lane;
  const float4* e4 = reinterpret_cast<const float4*>(e + base) + lane;
  const float4* r4 = reinterpret_cast<const float4*>(rand + base) + lane;
  unsigned* c4 = reinterpret_cast<unsigned*>(codes + base) + lane;
  float4* n4 = reinterpret_cast<float4*>(e_new + base) + lane;

  // evict-first loads and stores (ld/st.global.cs): every byte is touched
  // once, so none of it should displace other data from L2
  float4 m[kRowVecs], x[kRowVecs], r[kRowVecs];
#pragma unroll
  for (int j = 0; j < kRowVecs; ++j) m[j] = __ldcs(g4 + 32 * j);
#pragma unroll
  for (int j = 0; j < kRowVecs; ++j) x[j] = __ldcs(e4 + 32 * j);
#pragma unroll
  for (int j = 0; j < kRowVecs; ++j) r[j] = __ldcs(r4 + 32 * j);
  float amax = 0.0f;
#pragma unroll
  for (int j = 0; j < kRowVecs; ++j) {
    m[j] = add4(m[j], x[j]);
    amax = fmaxf(amax, absmax4(m[j]));
  }
  const float s = __fadd_rn(warp_max(amax), 1e-20f);
  const float step = __fdiv_rn(s, levels);
#pragma unroll
  for (int j = 0; j < kRowVecs; ++j) {
    // four codes as ints, packed into one 32-bit store (a char4 built
    // through its members' addresses would go through local memory)
    int q[4];
    float4 o;
    o.x = quant1(m[j].x, r[j].x, s, levels, step, &q[0]);
    o.y = quant1(m[j].y, r[j].y, s, levels, step, &q[1]);
    o.z = quant1(m[j].z, r[j].z, s, levels, step, &q[2]);
    o.w = quant1(m[j].w, r[j].w, s, levels, step, &q[3]);
    __stcs(c4 + 32 * j, (q[0] & 0xffu) | (q[1] & 0xffu) << 8 |
                            (q[2] & 0xffu) << 16 | (q[3] & 0xffu) << 24);
    __stcs(n4 + 32 * j, o);
  }
  if (lane == 0) scale[row] = s;
}

template <bool kDyn>
int launch(const float* g, const float* e, const float* rand,
           signed char* codes, float* scale, float* e_new, int rows, int cols,
           float levels, const float* levels_dev, void* stream) {
  if (rows <= 0 || cols <= 0 || cols % 4 != 0 || (kDyn && !levels_dev))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!kDyn && cols == kRowCols) {
    quantize_ef_row1024<<<(rows + kRowsPerBlock - 1) / kRowsPerBlock,
                          kRowsPerBlock * 32, 0, st>>>(
        g, e, rand, codes, scale, e_new, rows, levels);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid(rows), block(kThreads);
  const int nvec = cols / 4;
  if (nvec <= kThreads)
    quantize_ef_rows<1, kDyn><<<grid, block, 0, st>>>(
        g, e, rand, codes, scale, e_new, cols, levels, levels_dev);
  else if (nvec <= 2 * kThreads)
    quantize_ef_rows<2, kDyn><<<grid, block, 0, st>>>(
        g, e, rand, codes, scale, e_new, cols, levels, levels_dev);
  else if (nvec <= 4 * kThreads)
    quantize_ef_rows<4, kDyn><<<grid, block, 0, st>>>(
        g, e, rand, codes, scale, e_new, cols, levels, levels_dev);
  else if (cols <= kMaxCached)
    quantize_ef_rows<kMaxVecs, kDyn><<<grid, block, 0, st>>>(
        g, e, rand, codes, scale, e_new, cols, levels, levels_dev);
  else
    quantize_ef_rows<0, kDyn><<<grid, block, 0, st>>>(
        g, e, rand, codes, scale, e_new, cols, levels, levels_dev);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface. Pointers are device pointers of contiguous row-major (rows,
// cols) arrays, 16-byte aligned, cols % 4 == 0 (the Python wrapper checks
// all of this). `stream` is a cudaStream_t. Each returns cudaGetLastError()
// after the launch: 0 when the kernel was accepted.

// B1: the level count as an argument.
extern "C" int quantize_ef_f32(const float* g, const float* e,
                               const float* rand, signed char* codes,
                               float* scale, float* e_new, int rows, int cols,
                               float levels, void* stream) {
  return launch<false>(g, e, rand, codes, scale, e_new, rows, cols, levels,
                       nullptr, stream);
}

// B2: the level count read on the device from levels_dev (one f32).
extern "C" int quantize_ef_dyn_f32(const float* g, const float* e,
                                   const float* rand, signed char* codes,
                                   float* scale, float* e_new, int rows,
                                   int cols, const float* levels_dev,
                                   void* stream) {
  return launch<true>(g, e, rand, codes, scale, e_new, rows, cols, 0.0f,
                      levels_dev, stream);
}
