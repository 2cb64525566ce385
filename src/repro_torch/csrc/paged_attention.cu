// Paged decode attention (one query token per row, grouped GQA heads),
// hand-written for Hopper (sm_90a). Built by repro_torch/kernels/_build.py
// with plain nvcc into a shared library with a C interface, loaded with
// ctypes.
//
// Replaces the Pallas TPU kernel `_paged_kernel` of
// src/repro/kernels/flash_attention.py (B3, behind paged_flash_attention),
// which the serving engine's decode step runs once per attention layer.
//
//   q      (B, K, G, D)    one token per row; K kv heads, G query heads each
//   pool_k (NB, bs, K, D)  block pools shared by all rows through the table
//   pool_v (NB, bs, K, D)
//   table  (B, MAXB) int32 row b's logical block j is pool block table[b, j]
//   lengths (B,) int32     live context of row b
//   out    (B, K, G, D)    in q's dtype
//
// Per (row b, kv head h), over the row's ceil(L/bs) live blocks only:
//     q' = q * (1/sqrt(D))                                (f32)
//     s  = q' . k_i          for the block's positions i, -1e30 where >= L
//     m' = max(m, max s);  p = exp(s - m');  a = exp(m - m')
//     l' = l * a + sum p;  acc' = acc * a + p @ v
//     out = acc / max(l, 1e-20)
// with (m, l, acc) in f32, as `_paged_kernel` carries them. A row with
// L = 0 runs no block and returns zeros.
//
// Bound: device memory. Each row reads L·K·D keys and as many values
// (2 B each in bf16) and does 4·G·D flops per key (q·k and p·v), G = 8 on
// gemma-2b: 16 flops a byte, far below the card's ridge. At the serving
// path's shapes (B = 16, K = 1, G = 8, D = 256, bs = 16, L <= 319) that
// is at most 5.2 MB, 1.6 us at 3.35 TB/s.
//
// Design, the simple first version: one block of 256 threads per (row,
// kv head), as `_paged_kernel`'s grid (B, K). The block walks the row's
// table in order and stages one pool block's bs×D keys and values in
// shared memory in their own type: every thread starts its 16-byte loads
// (up to 8 in flight) before it stores any, so a block costs one trip to
// device memory, not one per element. Scores: a warp takes one key row
// at a time (two when D = 16), each lane holds D/32 of the row in
// registers and accumulates all G query heads against it, and the G
// shuffle reductions run interleaved. Warp g updates (m, l) of query
// head g with warp-wide max and sum. Each thread keeps up to 8 of the G×D
// accumulators in registers. D is a template parameter (16, 32, 64, 128,
// 256), so the per-lane loops unroll. B·K blocks (16 on gemma-2b) leave
// most of the card's 132 SMs idle and a block's loads are not overlapped
// with the previous block's arithmetic; splitting a row's blocks over
// several CTAs, prefetching and tensor-core products are later work
// (ROADMAP §B).
//
// Table entries must be pool block ids (the engine's allocator writes
// them); the live block count is clamped to MAXB. The pools must be
// 16-byte aligned. Built without --use_fast_math: expf and IEEE division.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;
constexpr int kAcc = 8;           // accumulators a thread: G*D <= 2048
constexpr int kLoadBatch = 4;     // 16-byte loads per tensor in flight
constexpr int kMaxSmem = 232448;  // bytes a block may opt into on sm_90

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode(const T* __restrict__ q, const T* __restrict__ pool_k,
             const T* __restrict__ pool_v, const int* __restrict__ table,
             const int* __restrict__ lengths, T* __restrict__ out, int Kh,
             int G, int bs, int maxb, float sm_scale) {
  constexpr int kVec = 16 / sizeof(T);          // elements per 16-byte load
  constexpr int kRowVecs = D / kVec;            // 16-byte loads per key row
  constexpr int kLanes = D >= 32 ? 32 : D;      // lanes sharing one key row
  constexpr int kPerLane = D / kLanes;          // its elements per lane
  constexpr int kRowsPerWarp = 32 / kLanes;     // key rows a warp takes
  extern __shared__ __align__(16) unsigned char smem[];
  T* k_sh = reinterpret_cast<T*>(smem);                    // bs*D keys
  T* v_sh = k_sh + bs * D;                                  // bs*D values
  float* q_sh = reinterpret_cast<float*>(v_sh + bs * D);   // G*D scaled q
  float* p_sh = q_sh + G * D;                               // G*bs scores
  __shared__ float m_sh[kMaxG], l_sh[kMaxG], alpha_sh[kMaxG];

  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int GD = G * D;
  const size_t qo = (static_cast<size_t>(b) * Kh + h) * GD;
  for (int e = tid; e < GD; e += kThreads)
    q_sh[e] = __fmul_rn(to_f32(q[qo + e]), sm_scale);
  if (tid < G) {
    m_sh[tid] = -1e30f;
    l_sh[tid] = 0.0f;
  }
  float acc[kAcc];
#pragma unroll
  for (int r = 0; r < kAcc; ++r) acc[r] = 0.0f;

  const int L = lengths[b];
  int nb = L > 0 ? (L + bs - 1) / bs : 0;
  if (nb > maxb) nb = maxb;
  const int* row_table = table + static_cast<size_t>(b) * maxb;
  const int nvec = bs * kRowVecs;
  const int sub = lane / kLanes, ll = lane % kLanes;

  for (int j = 0; j < nb; ++j) {
    const size_t bid = static_cast<size_t>(row_table[j]);
    __syncthreads();  // the previous block's k/v/p are consumed
    for (int v0 = 0; v0 < nvec; v0 += kThreads * kLoadBatch) {
      uint4 rk[kLoadBatch], rv[kLoadBatch];
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u) {
        const int v = v0 + tid + u * kThreads;
        if (v < nvec) {
          const int i = v / kRowVecs, c = v % kRowVecs;
          const size_t off = ((bid * bs + i) * Kh + h) * D + c * kVec;
          rk[u] = *reinterpret_cast<const uint4*>(pool_k + off);
          rv[u] = *reinterpret_cast<const uint4*>(pool_v + off);
        }
      }
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u) {
        const int v = v0 + tid + u * kThreads;
        if (v < nvec) {
          reinterpret_cast<uint4*>(k_sh)[v] = rk[u];
          reinterpret_cast<uint4*>(v_sh)[v] = rv[u];
        }
      }
    }
    __syncthreads();
    // scores: a warp per key row (kRowsPerWarp rows when D < 32)
    for (int i0 = warp * kRowsPerWarp; i0 < bs; i0 += kWarps * kRowsPerWarp) {
      const int i = i0 + sub;
      float kv[kPerLane];
#pragma unroll
      for (int c = 0; c < kPerLane; ++c)
        kv[c] = i < bs ? to_f32(k_sh[i * D + ll + c * kLanes]) : 0.0f;
      float s[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        float a = 0.0f;
        if (g < G) {
#pragma unroll
          for (int c = 0; c < kPerLane; ++c)
            a = fmaf(q_sh[g * D + ll + c * kLanes], kv[c], a);
        }
        s[g] = a;
      }
#pragma unroll
      for (int o = kLanes / 2; o > 0; o >>= 1) {
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          s[g] += __shfl_xor_sync(0xffffffffu, s[g], o);
      }
      if (ll == 0 && i < bs) {
        const bool live = j * bs + i < L;
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) p_sh[g * bs + i] = live ? s[g] : -1e30f;
      }
    }
    __syncthreads();
    // online softmax: warp g owns query head g
    if (warp < G) {
      float* pg = p_sh + warp * bs;
      const float m_prev = m_sh[warp];
      float m_new = m_prev;
      for (int i = lane; i < bs; i += 32) m_new = fmaxf(m_new, pg[i]);
      m_new = warp_max(m_new);
      float sum = 0.0f;
      for (int i = lane; i < bs; i += 32) {
        const float p = expf(pg[i] - m_new);
        pg[i] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_sh[warp] = fmaf(l_sh[warp], alpha, sum);
        m_sh[warp] = m_new;
        alpha_sh[warp] = alpha;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kAcc; ++r) {
      const int e = tid + r * kThreads;
      if (e < GD) acc[r] *= alpha_sh[e / D];
    }
    for (int i = 0; i < bs; ++i) {
#pragma unroll
      for (int r = 0; r < kAcc; ++r) {
        const int e = tid + r * kThreads;
        if (e < GD)
          acc[r] = fmaf(p_sh[(e / D) * bs + i], to_f32(v_sh[i * D + e % D]),
                        acc[r]);
      }
    }
  }
  __syncthreads();  // l_sh of the last block (or of the init) is visible
#pragma unroll
  for (int r = 0; r < kAcc; ++r) {
    const int e = tid + r * kThreads;
    if (e < GD) store(out + qo + e, acc[r] / fmaxf(l_sh[e / D], 1e-20f));
  }
}

template <typename T, int D>
int launch_d(const T* q, const T* pool_k, const T* pool_v, const int* table,
             const int* lengths, T* out, int B, int Kh, int G, int bs,
             int maxb, float sm_scale, cudaStream_t stream) {
  const size_t smem = 2 * sizeof(T) * static_cast<size_t>(bs) * D +
                      sizeof(float) * (static_cast<size_t>(G) * D +
                                       static_cast<size_t>(G) * bs);
  if (smem + 3 * kMaxG * sizeof(float) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_decode<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  paged_decode<T, D><<<dim3(B, Kh), kThreads, smem, stream>>>(
      q, pool_k, pool_v, table, lengths, out, Kh, G, bs, maxb, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* q, const T* pool_k, const T* pool_v, const int* table,
           const int* lengths, T* out, int B, int Kh, int G, int D, int bs,
           int maxb, float sm_scale, void* stream) {
  if (B <= 0 || Kh <= 0 || Kh > 65535 || G <= 0 || G > kMaxG || bs <= 0 ||
      maxb <= 0 || G * D > kThreads * kAcc ||
      (reinterpret_cast<uintptr_t>(pool_k) |
       reinterpret_cast<uintptr_t>(pool_v)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_d<T, 16>(q, pool_k, pool_v, table, lengths, out,
                                    B, Kh, G, bs, maxb, sm_scale, st);
    case 32: return launch_d<T, 32>(q, pool_k, pool_v, table, lengths, out,
                                    B, Kh, G, bs, maxb, sm_scale, st);
    case 64: return launch_d<T, 64>(q, pool_k, pool_v, table, lengths, out,
                                    B, Kh, G, bs, maxb, sm_scale, st);
    case 128: return launch_d<T, 128>(q, pool_k, pool_v, table, lengths, out,
                                      B, Kh, G, bs, maxb, sm_scale, st);
    case 256: return launch_d<T, 256>(q, pool_k, pool_v, table, lengths, out,
                                      B, Kh, G, bs, maxb, sm_scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C interface. Pointers are device pointers of contiguous arrays with the
// shapes above (the Python wrapper checks shapes, types, devices and
// contiguity). `stream` is a cudaStream_t. Each returns cudaGetLastError()
// after the launch: 0 when the kernel was accepted.

extern "C" int paged_attention_f32(const float* q, const float* pool_k,
                                   const float* pool_v, const int* table,
                                   const int* lengths, float* out, int B,
                                   int Kh, int G, int D, int bs, int maxb,
                                   float sm_scale, void* stream) {
  return launch<float>(q, pool_k, pool_v, table, lengths, out, B, Kh, G, D,
                       bs, maxb, sm_scale, stream);
}

extern "C" int paged_attention_bf16(const __nv_bfloat16* q,
                                    const __nv_bfloat16* pool_k,
                                    const __nv_bfloat16* pool_v,
                                    const int* table, const int* lengths,
                                    __nv_bfloat16* out, int B, int Kh, int G,
                                    int D, int bs, int maxb, float sm_scale,
                                    void* stream) {
  return launch<__nv_bfloat16>(q, pool_k, pool_v, table, lengths, out, B, Kh,
                               G, D, bs, maxb, sm_scale, stream);
}
