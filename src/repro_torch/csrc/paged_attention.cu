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
// L = 0 reads no block and returns zeros.
//
// Bound: device memory. Each row reads L·K·D keys and as many values
// (2 B each in bf16) and does 4·G·D flops per key (q·k and p·v), G = 8 on
// gemma-2b: 16 flops a byte, far below the card's ridge. At the serving
// path's shapes (B = 16, K = 1, G = 8, D = 256, bs = 16, L <= 319) that
// is at most 5.2 MB, 1.6 us at 3.35 TB/s.
//
// Design: flash-decoding over a thread block cluster. Each (row, kv head)
// is a cluster of c CTAs of 256 threads (grid (c, K, B)); the wrapper
// picks c (kernels/flash_attention.py `paged_split`) so that B·K·c fills
// the card: c = 8 at the serving shape, 128 CTAs on 132 SMs, and c = 1
// where B·K already fills it. CTA r takes the contiguous share
// [r·nb/c, (r+1)·nb/c) of the row's nb live blocks, nb read from
// `lengths` on the device (no host sync): 2-3 blocks at the serving
// shape. Its row's table entries are read beside the row's length, q into
// registers; it issues every cp.async of its share's keys and values at
// once (up to `chunk` blocks; a longer share goes chunk by chunk), waits
// once, then: scores, a warp per key row, each lane one 16-byte load of
// its columns against all G heads, the heads summed by a 9-shuffle
// butterfly; the softmax, warp g for head g; p·v, each thread owning one
// fixed column of up to 8 heads. The CTAs' partial (m, l, acc) are merged
// inside the cluster through distributed shared memory (softmax_merge.cuh):
// one launch per layer per decode step, no workspace. The math stays on
// CUDA cores (16 flops a byte needs no tensor cores).
//
// What holds it back (PERF.md, H100 80GB HBM3 at 700 W; measured by
// `python -m repro_torch.kernels.probe`): a chain of small dependent steps
// (length and table, loads, scores, softmax, p·v, merge) over a floor of
// about 9 us a call (launch, cluster scheduling and syncs); the bytes
// alone would take 1.5 us.
//
// Table entries must be pool block ids (the engine's allocator writes
// them); the live block count is clamped to MAXB. The pools must be
// 16-byte aligned. Built without --use_fast_math: expf and IEEE division.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "softmax_merge.cuh"

namespace {

using softmax_merge::cp_async16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;
constexpr int kW = softmax_merge::kMaxCluster + 1;
constexpr int kMaxSmem = 232448;  // bytes a block may opt into on sm_90
constexpr float kMask = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

// Shared memory of one CTA, in bytes: `chunk` blocks of keys and values in
// their own type, the partial acc and the scores (kMaxG a key) in f32, the
// per-head m, l, alpha and merge weights, and up to kThreads table entries.
// `esize` is the pools' element size.
constexpr size_t smem_bytes(int esize, int G, int D, int bs, int chunk) {
  return 2 * static_cast<size_t>(esize) * chunk * bs * D +
         sizeof(float) * (static_cast<size_t>(G) * D +
                          static_cast<size_t>(kMaxG) * chunk * bs +
                          3 * kMaxG + kMaxG * kW) +
         sizeof(int) * kThreads;
}

// N consecutive elements of shared memory as f32, in one load of up to 16
// bytes (or several of 16).
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* p, float* f) {
  constexpr int kBytes = N * static_cast<int>(sizeof(T));
  alignas(16) T buf[N];
  if constexpr (kBytes % 16 == 0) {
#pragma unroll
    for (int u = 0; u < kBytes / 16; ++u)
      reinterpret_cast<uint4*>(buf)[u] = reinterpret_cast<const uint4*>(p)[u];
  } else if constexpr (kBytes == 8) {
    *reinterpret_cast<uint2*>(buf) = *reinterpret_cast<const uint2*>(p);
  } else if constexpr (kBytes == 4) {
    *reinterpret_cast<unsigned*>(buf) = *reinterpret_cast<const unsigned*>(p);
  } else {
    buf[0] = p[0];
  }
#pragma unroll
  for (int e = 0; e < N; ++e) f[e] = to_f32(buf[e]);
}

// Sum each of a lane's 8 values over the warp: a butterfly that halves the
// values at each of the first three levels (9 shuffles, not 40). Lane l
// returns the sum of value l / 4.
__device__ __forceinline__ float warp_sum8(const float* s, int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  float t[4], u[2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    t[j] = (b4 ? s[j + 4] : s[j]) +
           __shfl_xor_sync(0xffffffffu, b4 ? s[j] : s[j + 4], 16);
#pragma unroll
  for (int j = 0; j < 2; ++j)
    u[j] = (b3 ? t[j + 2] : t[j]) +
           __shfl_xor_sync(0xffffffffu, b3 ? t[j] : t[j + 2], 8);
  float x = (b2 ? u[1] : u[0]) +
            __shfl_xor_sync(0xffffffffu, b2 ? u[0] : u[1], 4);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode(const T* __restrict__ q, const T* __restrict__ pool_k,
             const T* __restrict__ pool_v, const int* __restrict__ table,
             const int* __restrict__ lengths, T* __restrict__ out, int Kh,
             int G, int bs, int maxb, int chunk, float sm_scale) {
  constexpr int kVec = 16 / sizeof(T);          // elements per 16-byte load
  constexpr int kRowVecs = D / kVec;            // 16-byte loads per key row
  constexpr int kLanes = D >= 32 ? 32 : D;      // lanes sharing one key row
  constexpr int kPerLane = D / kLanes;          // its contiguous elements
  constexpr int kRowsPerWarp = 32 / kLanes;     // key rows a warp takes
  constexpr int kSlots = kThreads / D;          // heads sharing a column
  constexpr int kAcc = (kMaxG + kSlots - 1) / kSlots;  // heads a thread
  extern __shared__ __align__(16) unsigned char smem[];
  const int ck = chunk * bs;                                // keys staged
  T* k_sh = reinterpret_cast<T*>(smem);                     // ck*D keys
  T* v_sh = k_sh + ck * D;                                  // ck*D values
  float* acc_sh = reinterpret_cast<float*>(v_sh + ck * D); // G*D acc
  float* p_sh = acc_sh + G * D;                             // ck*kMaxG p
  float* m_sh = p_sh + kMaxG * ck;                          // G
  float* l_sh = m_sh + kMaxG;                               // G
  float* a_sh = l_sh + kMaxG;                               // G alpha
  float* w_sh = a_sh + kMaxG;                               // merge weights
  int* tab_sh = reinterpret_cast<int*>(w_sh + kMaxG * kW);  // table entries

  const int c = gridDim.x, r = blockIdx.x;  // the cluster spans x
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int GD = G * D;
  const size_t qo = (static_cast<size_t>(b) * Kh + h) * GD;
  const int sub = lane / kLanes, ll = lane % kLanes;
  // q' in registers: this lane's kPerLane columns of every head
  float qr[kMaxG][kPerLane];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int e = 0; e < kPerLane; ++e)
      qr[g][e] = g < G ? __fmul_rn(to_f32(q[qo + g * D + ll * kPerLane + e]),
                                   sm_scale)
                       : 0.0f;
  if (tid < G) {
    m_sh[tid] = kMask;
    l_sh[tid] = 0.0f;
  }
  // p @ v: this thread's column, for heads g0, g0 + kSlots, ...
  const int col = tid % D, g0 = tid / D;
  float acc[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) acc[j] = 0.0f;

  // the row's table, read beside its length rather than after it (a row
  // of more than kThreads entries is read from device memory as needed)
  const int* row_table = table + static_cast<size_t>(b) * maxb;
  const bool tab_staged = maxb <= kThreads;
  if (tab_staged && tid < maxb) tab_sh[tid] = row_table[tid];
  const int L = lengths[b];
  int nb = L > 0 ? (L + bs - 1) / bs : 0;
  if (nb > maxb) nb = maxb;
  const int lo = r * nb / c, hi = (r + 1) * nb / c;  // this CTA's share

  for (int j0 = lo; j0 < hi; j0 += chunk) {
    const int nk = min(chunk, hi - j0) * bs;  // keys of this chunk
    __syncthreads();  // the previous chunk's k, v and p are consumed
    for (int v = tid; v < nk * kRowVecs; v += kThreads) {
      const int i = v / kRowVecs, cv = v % kRowVecs;
      const int blk = i / bs, ii = i - blk * bs;
      const size_t bid = static_cast<size_t>(
          tab_staged ? tab_sh[j0 + blk] : row_table[j0 + blk]);
      const size_t off = ((bid * bs + ii) * Kh + h) * D + cv * kVec;
      cp_async16(k_sh + i * D + cv * kVec, pool_k + off);
      cp_async16(v_sh + i * D + cv * kVec, pool_v + off);
    }
    softmax_merge::cp_async_commit();
    softmax_merge::cp_async_wait<0>();
    __syncthreads();
    // scores: a warp per key row (kRowsPerWarp rows when D < 32), each
    // lane's kPerLane contiguous keys in one load against q' in registers
    for (int i0 = warp * kRowsPerWarp; i0 < nk; i0 += kWarps * kRowsPerWarp) {
      const int i = i0 + sub;
      float kv[kPerLane];
      if (i < nk) {
        load_f32<T, kPerLane>(k_sh + i * D + ll * kPerLane, kv);
      } else {
#pragma unroll
        for (int e = 0; e < kPerLane; ++e) kv[e] = 0.0f;
      }
      float s[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        float a = 0.0f;
#pragma unroll
        for (int e = 0; e < kPerLane; ++e) a = fmaf(qr[g][e], kv[e], a);
        s[g] = a;
      }
      const bool live = j0 * bs + i < L;
      if constexpr (kLanes == 32) {
        const float x = warp_sum8(s, lane);
        const int g = lane >> 2;
        if ((lane & 3) == 0 && g < G) p_sh[i * kMaxG + g] = live ? x : kMask;
      } else {
#pragma unroll
        for (int o = kLanes / 2; o > 0; o >>= 1) {
#pragma unroll
          for (int g = 0; g < kMaxG; ++g)
            s[g] += __shfl_xor_sync(0xffffffffu, s[g], o);
        }
        if (ll == 0 && i < nk) {
#pragma unroll
          for (int g = 0; g < kMaxG; ++g)
            if (g < G) p_sh[i * kMaxG + g] = live ? s[g] : kMask;
        }
      }
    }
    __syncthreads();
    // online softmax: warp g owns query head g
    if (warp < G) {
      float* pg = p_sh + warp;
      const float m_prev = m_sh[warp];
      float m_new = m_prev;
      for (int i = lane; i < nk; i += 32)
        m_new = fmaxf(m_new, pg[i * kMaxG]);
      m_new = warp_max(m_new);
      float sum = 0.0f;
      for (int i = lane; i < nk; i += 32) {
        const float x = pg[i * kMaxG];
        const float p = x > kMask ? expf(x - m_new) : 0.0f;
        pg[i * kMaxG] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_sh[warp] = fmaf(l_sh[warp], alpha, sum);
        m_sh[warp] = m_new;
        a_sh[warp] = alpha;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      const int g = g0 + j * kSlots;
      if (g < G) acc[j] *= a_sh[g];
    }
#pragma unroll 4
    for (int i = 0; i < nk; ++i) {
      const float vv = to_f32(v_sh[i * D + col]);
      const float* pi = p_sh + i * kMaxG;
      if constexpr (kSlots == 1) {  // all 8 heads: two broadcast loads
        const float4 p0 = *reinterpret_cast<const float4*>(pi);
        const float4 p1 = *reinterpret_cast<const float4*>(pi + 4);
        const float pr[kMaxG] = {p0.x, p0.y, p0.z, p0.w,
                                 p1.x, p1.y, p1.z, p1.w};
#pragma unroll
        for (int j = 0; j < kAcc; ++j) acc[j] = fmaf(pr[j], vv, acc[j]);
      } else {
#pragma unroll
        for (int j = 0; j < kAcc; ++j) {
          const int g = g0 + j * kSlots;
          if (g < G) acc[j] = fmaf(pi[g], vv, acc[j]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
    const int g = g0 + j * kSlots;
    if (g < G) acc_sh[g * D + col] = acc[j];
  }
  T* o = out + qo;
  softmax_merge::cluster_merge<kThreads>(
      m_sh, l_sh, acc_sh, G, D, D, w_sh,
      [o](int g, int cc, const float* x, int n) {
        softmax_merge::store_n(o + g * D + cc, x, n);
      });
}

template <typename T, int D>
int launch_d(const T* q, const T* pool_k, const T* pool_v, const int* table,
             const int* lengths, T* out, int B, int Kh, int G, int bs,
             int maxb, int cluster, int chunk, float sm_scale,
             cudaStream_t stream) {
  const size_t smem = smem_bytes(sizeof(T), G, D, bs, chunk);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  return softmax_merge::launch_cluster(
      paged_decode<T, D>, dim3(cluster, Kh, B), kThreads, smem, stream,
      cluster, q, pool_k, pool_v, table, lengths, out, Kh, G, bs, maxb,
      chunk, sm_scale);
}

template <typename T>
int launch(const T* q, const T* pool_k, const T* pool_v, const int* table,
           const int* lengths, T* out, int B, int Kh, int G, int D, int bs,
           int maxb, int cluster, int chunk, float sm_scale, void* stream) {
  if (B <= 0 || B > 65535 || Kh <= 0 || Kh > 65535 || G <= 0 ||
      G > kMaxG || bs <= 0 || maxb <= 0 || chunk <= 0 || cluster <= 0 ||
      cluster > softmax_merge::kMaxCluster || D % cluster ||
      (reinterpret_cast<uintptr_t>(pool_k) |
       reinterpret_cast<uintptr_t>(pool_v)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_d<T, 16>(q, pool_k, pool_v, table, lengths, out,
                                    B, Kh, G, bs, maxb, cluster, chunk,
                                    sm_scale, st);
    case 32: return launch_d<T, 32>(q, pool_k, pool_v, table, lengths, out,
                                    B, Kh, G, bs, maxb, cluster, chunk,
                                    sm_scale, st);
    case 64: return launch_d<T, 64>(q, pool_k, pool_v, table, lengths, out,
                                    B, Kh, G, bs, maxb, cluster, chunk,
                                    sm_scale, st);
    case 128: return launch_d<T, 128>(q, pool_k, pool_v, table, lengths, out,
                                      B, Kh, G, bs, maxb, cluster, chunk,
                                      sm_scale, st);
    case 256: return launch_d<T, 256>(q, pool_k, pool_v, table, lengths, out,
                                      B, Kh, G, bs, maxb, cluster, chunk,
                                      sm_scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Shared memory of one CTA in bytes, for pools of `esize`-byte elements
// (4: f32, 2: bf16) and `chunk` pool blocks staged at once; -1 where that
// is more than a block may use, which the launch refuses. The wrapper
// checks its plan (`paged_chunk`) with it before the launch.
extern "C" long long paged_attention_smem(int esize, int G, int D, int bs,
                                          int chunk) {
  if ((esize != 2 && esize != 4) || G <= 0 || D <= 0 || bs <= 0 ||
      chunk <= 0)
    return -1;
  const size_t smem = smem_bytes(esize, G, D, bs, chunk);
  return smem > kMaxSmem ? -1 : static_cast<long long>(smem);
}

// C interface. Pointers are device pointers of contiguous arrays with the
// shapes above (the Python wrapper checks shapes, types, devices and
// contiguity). `cluster` is the CTAs a (row, kv head), 1..8, dividing D;
// `chunk` the pool blocks a CTA stages at once; both from the wrapper's
// plan. `stream` is a cudaStream_t. Each returns the launch's error: 0
// when the kernel was accepted.

extern "C" int paged_attention_f32(const float* q, const float* pool_k,
                                   const float* pool_v, const int* table,
                                   const int* lengths, float* out, int B,
                                   int Kh, int G, int D, int bs, int maxb,
                                   int cluster, int chunk, float sm_scale,
                                   void* stream) {
  return launch<float>(q, pool_k, pool_v, table, lengths, out, B, Kh, G, D,
                       bs, maxb, cluster, chunk, sm_scale, stream);
}

extern "C" int paged_attention_bf16(const __nv_bfloat16* q,
                                    const __nv_bfloat16* pool_k,
                                    const __nv_bfloat16* pool_v,
                                    const int* table, const int* lengths,
                                    __nv_bfloat16* out, int B, int Kh, int G,
                                    int D, int bs, int maxb, int cluster,
                                    int chunk, float sm_scale, void* stream) {
  return launch<__nv_bfloat16>(q, pool_k, pool_v, table, lengths, out, B, Kh,
                               G, D, bs, maxb, cluster, chunk, sm_scale,
                               stream);
}
