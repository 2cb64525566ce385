// Causal (or full) softmax attention over (BH, S, D) tensors, hand-written
// for Hopper (sm_90a). Built by repro_torch/kernels/_build.py with plain
// nvcc into a shared library with a C interface, loaded with ctypes.
//
// Replaces the Pallas TPU kernel `_flash_kernel` of
// src/repro/kernels/flash_attention.py (B4, behind flash_attention), which
// the JAX package's kernel benchmark and kernel tests call; no model path
// runs it.
//
//   q, k, v (BH, S, D)   batch*heads flattened, the same heads for k/v
//   out     (BH, S, D)   in q's dtype
//
// Per row r of a (bh) slice, over the keys c <= r (all keys when not
// causal), with (m, l, acc) in f32 as `_flash_kernel` carries them:
//     q' = q * (1/sqrt(D))
//     s  = q' . k_c          -1e30 where c > r (causal) or c >= S
//     m' = max(m, max s);  p = exp(s - m');  a = exp(m - m')
//     l' = l * a + sum p;  acc' = acc * a + p @ v
//     out = acc / max(l, 1e-20)
// The mask is -1e30, not -inf, so a masked exp(s - m) never computes
// -inf - (-inf). The kernel's tiles are its own (kBQ query rows, kBK keys);
// the JAX tile sizes bq/bk change nothing but float summation order.
//
// Bound: operations at the shapes that call it. A causal (BH, S, D) call
// does 4·D·S(S+1)/2·BH flops (q·k and p·v over the lower triangle) and
// moves 4·BH·S·D elements (q, k, v read, out written): at BH = 4, S =
// 1024, D = 128 in f32 that is 1.075 GFLOP against 8.39 MB, 64 flops a
// byte, above the f32 ridge (67 TFLOP/s over 3.35 TB/s = 20): 0.0160 ms
// at the f32 peak. In bf16 the bound is the tensor cores' (989 TFLOP/s),
// which this version does not use.
//
// Design, the simple first version: one CTA of 128 threads per (bh, tile
// of kBQ = 32 query rows); the grid runs the tiles nearest the diagonal
// (the longest) first. q is scaled once and staged in shared memory as
// f32. Each key tile of kBK = 64 rows is staged as f32 (K and V), every
// thread starting its 16-byte loads before it stores any. Scores: each
// thread takes a 4-row × 4-key block of the 32 × 64 tile, accumulating
// over D in float4 steps from shared memory (rows padded by 4 floats, so
// the 8 threads of a quarter warp read 8 keys on distinct banks). The
// 16 threads of a row group reduce the row max and sum with shuffles,
// keep (m, l) in registers, and write p transposed to shared memory.
// p @ v: each thread owns up to 4 rows × D/16 columns of the output
// (64 f32 accumulators at D = 256) in registers. Key tiles wholly above
// the diagonal are never loaded; only tiles that cross it (or pass S) are
// masked. CUDA cores only (f32 FMAs): no tensor cores, no overlap of a
// tile's loads with the previous tile's arithmetic; both, and splitting
// long rows over CTAs, are later work (ROADMAP §B).
//
// The operands must be 16-byte aligned. Built without --use_fast_math:
// expf and IEEE division.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 32;           // query rows a CTA
constexpr int kBK = 64;           // keys a tile
constexpr int kRS = kBQ / 8;      // score rows a thread (8 row groups)
constexpr int kKS = kBK / 16;     // score keys a thread (16 key groups)
constexpr int kPS = kBQ + 4;      // row stride of p^T in shared memory
constexpr int kLoadBatch = 4;     // 16-byte loads in flight a thread
constexpr int kMaxSmem = 232448;  // bytes a block may opt into on sm_90
constexpr float kMask = -1e30f;

static_assert(kRS == 4, "p^T is stored a float4 of rows at a time");

template <int D>
struct Tile {
  static constexpr int QS = D + 4;                  // q/k row stride (floats)
  static constexpr int TC = D / 4 < 16 ? D / 4 : 16;  // column groups of p@v
  static constexpr int TR = kThreads / TC;          // row groups of p@v
  static constexpr int RO = kBQ / TR;               // output rows a thread
  static constexpr int CV = D / (4 * TC);           // float4 columns a thread
  static constexpr int kFloats = kBQ * QS + kBK * QS + kBK * D + kBK * kPS +
                                 2 * kBQ;
  static constexpr size_t kSmem = sizeof(float) * kFloats;
  static_assert(TR * RO == kBQ && TC * CV * 4 == D, "tiling");
  static_assert(kSmem <= kMaxSmem, "shared memory");
};

// The 16 bytes of one load as f32: 4 floats, or 8 bf16 widened.
template <typename T>
__device__ __forceinline__ void unpack(const uint4& r, float* f);
template <>
__device__ __forceinline__ void unpack<float>(const uint4& r, float* f) {
  const float4 x = *reinterpret_cast<const float4*>(&r);
  f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
}
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& r,
                                                      float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Stage rows [r0, r0 + ROWS) of a (S, D) slice into shared memory as f32
// with row stride STRIDE, times `scale` when SCALE; rows at or past S are
// zero. Each thread issues up to kLoadBatch 16-byte loads before storing.
template <typename T, int D, int STRIDE, int ROWS, bool SCALE>
__device__ __forceinline__ void stage(const T* __restrict__ src, int r0,
                                      int S, float* dst, float scale) {
  constexpr int kVec = 16 / sizeof(T);  // elements a 16-byte load
  constexpr int kRowVecs = D / kVec;
  constexpr int kN = ROWS * kRowVecs;
  const int tid = threadIdx.x;
  for (int v0 = 0; v0 < kN; v0 += kThreads * kLoadBatch) {
    uint4 r[kLoadBatch];
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int vi = v0 + tid + u * kThreads;
      const int row = vi / kRowVecs, c = vi % kRowVecs;
      r[u] = make_uint4(0u, 0u, 0u, 0u);
      if (vi < kN && r0 + row < S)
        r[u] = *reinterpret_cast<const uint4*>(
            src + static_cast<size_t>(r0 + row) * D + c * kVec);
    }
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int vi = v0 + tid + u * kThreads;
      if (vi < kN) {
        const int row = vi / kRowVecs, c = vi % kRowVecs;
        float f[kVec];
        unpack<T>(r[u], f);
        if (SCALE) {
#pragma unroll
          for (int e = 0; e < kVec; ++e) f[e] = __fmul_rn(f[e], scale);
        }
        float4* d4 = reinterpret_cast<float4*>(dst + row * STRIDE + c * kVec);
#pragma unroll
        for (int e = 0; e < kVec / 4; ++e)
          d4[e] = make_float4(f[4 * e], f[4 * e + 1], f[4 * e + 2],
                              f[4 * e + 3]);
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ out, int S, int causal,
          float sm_scale) {
  using C = Tile<D>;
  extern __shared__ __align__(16) float smem[];
  float* q_sh = smem;                   // kBQ x QS  scaled q
  float* k_sh = q_sh + kBQ * C::QS;     // kBK x QS  keys
  float* v_sh = k_sh + kBK * C::QS;     // kBK x D   values
  float* p_sh = v_sh + kBK * D;         // kBK x kPS probabilities, transposed
  float* a_sh = p_sh + kBK * kPS;       // kBQ       this tile's alpha a row
  float* l_sh = a_sh + kBQ;             // kBQ       final l a row

  const int tid = threadIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const size_t base = static_cast<size_t>(blockIdx.x) * S * D;
  const T* qb = q + base;
  const T* kb = k + base;
  const T* vb = v + base;

  // scores: row group sr holds rows sr*4 .. +3, key group sc keys sc + 16j
  const int sr = tid >> 4, sc = tid & 15;
  // p @ v: rows orow .. +RO, float4 columns oc + TC*j
  const int orow = (tid / C::TC) * C::RO, oc = tid % C::TC;

  stage<T, D, C::QS, kBQ, true>(qb, q0, S, q_sh, sm_scale);

  float m[kRS], l[kRS];
#pragma unroll
  for (int i = 0; i < kRS; ++i) {
    m[i] = kMask;
    l[i] = 0.0f;
  }
  float acc[C::RO][4 * C::CV];
#pragma unroll
  for (int i = 0; i < C::RO; ++i)
#pragma unroll
    for (int c = 0; c < 4 * C::CV; ++c) acc[i][c] = 0.0f;

  // keys this tile of rows sees: up to its last row when causal
  const int kend = causal ? min(S, q0 + kBQ) : S;
  const int nkt = (kend + kBK - 1) / kBK;
  for (int t = 0; t < nkt; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's k, v and p are consumed
    stage<T, D, C::QS, kBK, false>(kb, k0, S, k_sh, 1.0f);
    stage<T, D, D, kBK, false>(vb, k0, S, v_sh, 1.0f);
    __syncthreads();

    float s[kRS][kKS];
#pragma unroll
    for (int i = 0; i < kRS; ++i)
#pragma unroll
      for (int j = 0; j < kKS; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[kRS], kv[kKS];
#pragma unroll
      for (int i = 0; i < kRS; ++i)
        qv[i] = *reinterpret_cast<const float4*>(q_sh + (sr * kRS + i) *
                                                 C::QS + d);
#pragma unroll
      for (int j = 0; j < kKS; ++j)
        kv[j] = *reinterpret_cast<const float4*>(k_sh + (sc + 16 * j) *
                                                 C::QS + d);
#pragma unroll
      for (int i = 0; i < kRS; ++i)
#pragma unroll
        for (int j = 0; j < kKS; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }
    // only a tile that crosses the diagonal, or passes S, is masked
    if ((causal && k0 + kBK - 1 > q0) || k0 + kBK > S) {
#pragma unroll
      for (int i = 0; i < kRS; ++i)
#pragma unroll
        for (int j = 0; j < kKS; ++j) {
          const int qp = q0 + sr * kRS + i, kp = k0 + sc + 16 * j;
          if (kp >= S || (causal && kp > qp)) s[i][j] = kMask;
        }
    }
    // online softmax; the 16 lanes of a row group share its rows
#pragma unroll
    for (int i = 0; i < kRS; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < kKS; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kKS; ++j) {
        const float p = expf(s[i][j] - m_new);
        s[i][j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float alpha = expf(m[i] - m_new);
      l[i] = fmaf(l[i], alpha, sum);
      m[i] = m_new;
      if (sc == 0) a_sh[sr * kRS + i] = alpha;
    }
#pragma unroll
    for (int j = 0; j < kKS; ++j)
      *reinterpret_cast<float4*>(p_sh + (sc + 16 * j) * kPS + sr * kRS) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // acc = acc * alpha + p @ v over this tile's live keys (p of a key at
    // or past kend is exactly 0)
#pragma unroll
    for (int i = 0; i < C::RO; ++i) {
      const float a = a_sh[orow + i];
#pragma unroll
      for (int c = 0; c < 4 * C::CV; ++c) acc[i][c] *= a;
    }
    const int kn = min(kBK, kend - k0);
#pragma unroll 4
    for (int kk = 0; kk < kn; ++kk) {
      float pr[C::RO];
      if constexpr (C::RO == 4) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(p_sh + kk * kPS + orow);
        pr[0] = p4.x; pr[1] = p4.y; pr[2] = p4.z; pr[3] = p4.w;
      } else {
#pragma unroll
        for (int i = 0; i < C::RO; ++i) pr[i] = p_sh[kk * kPS + orow + i];
      }
#pragma unroll
      for (int j = 0; j < C::CV; ++j) {
        const float4 vv = *reinterpret_cast<const float4*>(
            v_sh + kk * D + 4 * (oc + C::TC * j));
#pragma unroll
        for (int i = 0; i < C::RO; ++i) {
          acc[i][4 * j] = fmaf(pr[i], vv.x, acc[i][4 * j]);
          acc[i][4 * j + 1] = fmaf(pr[i], vv.y, acc[i][4 * j + 1]);
          acc[i][4 * j + 2] = fmaf(pr[i], vv.z, acc[i][4 * j + 2]);
          acc[i][4 * j + 3] = fmaf(pr[i], vv.w, acc[i][4 * j + 3]);
        }
      }
    }
  }
  if (sc == 0) {
#pragma unroll
    for (int i = 0; i < kRS; ++i) l_sh[sr * kRS + i] = l[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < C::RO; ++i) {
    const int row = q0 + orow + i;
    if (row < S) {
      const float den = fmaxf(l_sh[orow + i], 1e-20f);
      T* o = out + base + static_cast<size_t>(row) * D;
#pragma unroll
      for (int j = 0; j < C::CV; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          store(o + 4 * (oc + C::TC * j) + e, acc[i][4 * j + e] / den);
    }
  }
}

template <typename T, int D>
int launch_d(const T* q, const T* k, const T* v, T* out, int BH, int S,
             int causal, float sm_scale, cudaStream_t stream) {
  constexpr size_t smem = Tile<D>::kSmem;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(BH, (S + kBQ - 1) / kBQ);
  flash_fwd<T, D><<<grid, kThreads, smem, stream>>>(q, k, v, out, S, causal,
                                                    sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* q, const T* k, const T* v, T* out, int BH, int S, int D,
           int causal, float sm_scale, void* stream) {
  if (BH <= 0 || S <= 0 || (S + kBQ - 1) / kBQ > 65535 ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) %
          16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_d<T, 16>(q, k, v, out, BH, S, causal, sm_scale, st);
    case 32: return launch_d<T, 32>(q, k, v, out, BH, S, causal, sm_scale, st);
    case 64: return launch_d<T, 64>(q, k, v, out, BH, S, causal, sm_scale, st);
    case 128:
      return launch_d<T, 128>(q, k, v, out, BH, S, causal, sm_scale, st);
    case 256:
      return launch_d<T, 256>(q, k, v, out, BH, S, causal, sm_scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C interface. Pointers are device pointers of contiguous (BH, S, D)
// arrays (the Python wrapper checks shapes, types, devices, contiguity
// and alignment). `causal` is 0 or 1; `stream` is a cudaStream_t. Each
// returns cudaGetLastError() after the launch: 0 when the kernel was
// accepted.

extern "C" int flash_attention_f32(const float* q, const float* k,
                                   const float* v, float* out, int BH, int S,
                                   int D, int causal, float sm_scale,
                                   void* stream) {
  return launch<float>(q, k, v, out, BH, S, D, causal, sm_scale, stream);
}

extern "C" int flash_attention_bf16(const __nv_bfloat16* q,
                                    const __nv_bfloat16* k,
                                    const __nv_bfloat16* v,
                                    __nv_bfloat16* out, int BH, int S, int D,
                                    int causal, float sm_scale,
                                    void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, BH, S, D, causal, sm_scale,
                               stream);
}
