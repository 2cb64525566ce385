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
//     s  = (q . k_c) * (1/sqrt(D))   -1e30 where c > r (causal) or c >= S
//     m' = max(m, max s);  p = exp(s - m');  a = exp(m - m')
//     l' = l * a + sum p;  acc' = acc * a + p @ v
//     out = acc / max(l, 1e-20)
// A masked key contributes p = 0, so a row never computes -inf - (-inf).
// The kernel's tiles are its own (BQ query rows, BK keys; exported by
// `flash_attention_tiles` for the wrapper's plan); the JAX tile sizes
// bq/bk change nothing but float summation order.
//
// Bound: operations at the shapes that call it. A causal (BH, S, D) call
// does 4·D·S(S+1)/2·BH flops (q·k and p·v over the lower triangle) and
// moves 4·BH·S·D elements: at BH = 4, S = 1024, D = 128 in f32 that is
// 1.075 GFLOP against 8.39 MB, 0.0160 ms at the f32 peak (67 TFLOP/s);
// in bf16 the tensor cores' 989 TFLOP/s make it a bytes bound at the
// shapes measured (gemma-2b's prefill call: 4.19 MB, 1.25 us).
//
// Design. The grid is (c, BH, number of q tiles), clusters of c CTAs
// along x, the longest q tiles (nearest the diagonal when causal) first.
// The key range of a q tile, nkt key tiles, is split over the c CTAs of its
// cluster: CTA r takes key tiles [r·nkt/c, (r+1)·nkt/c), so the tile
// nearest the diagonal is no longer one CTA's work; the wrapper picks c
// (kernels/flash_attention.py `flash_split`) so that the grid fills the
// card about twice (at most 8). The CTAs' partial (m, l, acc) are merged in
// the cluster through distributed shared memory (softmax_merge.cuh). Key
// and value tiles come through a two-stage cp.async ring: tile t+1 loads
// while tile t computes. Tiles wholly above the diagonal are never loaded.
//
// - bf16, tensor cores: 4 warps, each owning 16 q rows (BQ = 64); BK = 64
//   keys (32 at D = 256, where the output alone is 128 f32 registers a
//   thread). q, k and v stay bf16 in shared memory (rows padded by 16
//   bytes, so ldmatrix reads are free of bank conflicts). s = q·k by
//   mma.sync m16n8k16 on unscaled bf16 (the products are exact in f32),
//   scaled in f32; the online softmax runs on the accumulator fragments
//   with quad shuffles; p·v splits p into p_hi = bf16(p) and p_lo =
//   bf16(p - p_hi) and issues two mmas against the same V fragments
//   (ldmatrix.trans), keeping p to about 2^-17 as `_flash_kernel` keeps it
//   in f32.
// - f32, CUDA cores (the contract is f32 arithmetic; TF32 would keep three
//   digits): 4 warps over BQ = 32 rows; BK = 64 keys (32 at D >= 128, so
//   that two CTAs fit an SM); each thread a 4-row × BK/16-key block of the
//   scores and 4 rows × D/16 columns of the output.
//
// What holds it back (PERF.md, H100 80GB HBM3 at 700 W; measured by
// `python -m repro_torch.kernels.probe`): the bf16 kernel reaches about a
// third of SDPA's rate at long S, where a key tile's chain (wait for its
// load, q·k, softmax, p·v, barrier) runs with one or two warps a
// scheduler and nothing else in flight. At gemma-2b's prefill shape about
// half of the call is the floor of a call (launch, cluster scheduling and
// syncs, the q tile's load, the merge).
//
// The operands must be 16-byte aligned. Built without --use_fast_math:
// expf and IEEE division.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "softmax_merge.cuh"

namespace {

using softmax_merge::cp_async16_zfill;
using softmax_merge::cp_async_commit;
using softmax_merge::cp_async_wait;

constexpr int kF32Threads = 128;  // the f32 kernel's (bf16: BF16Tile)
constexpr int kW = softmax_merge::kMaxCluster + 1;
constexpr int kMaxSmem = 232448;  // bytes a block may opt into on sm_90
constexpr float kMask = -1e30f;

// Copy rows [r0, r0 + ROWS) of a (S, D) slice into shared memory with row
// stride STRIDE (elements), 16 bytes a cp.async; rows at or past S are
// zero-filled. Commits nothing.
template <typename T, int D, int STRIDE, int ROWS, int NT>
__device__ __forceinline__ void load_rows(const T* __restrict__ src, int r0,
                                          int S, T* dst) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kRowVecs = D / kVec;
  for (int i = threadIdx.x; i < ROWS * kRowVecs; i += NT) {
    const int row = i / kRowVecs, cv = i % kRowVecs;
    const bool valid = r0 + row < S;
    const T* s = valid ? src + static_cast<size_t>(r0 + row) * D + cv * kVec
                       : src;
    cp_async16_zfill(dst + row * STRIDE + cv * kVec, s, valid);
  }
}

// This CTA's q tile, key range and base offset: grid (c, BH, nq), the
// cluster along x, q tiles in reverse so that the longest run first.
struct Work {
  int q0, kend, t_lo, t_hi;  // keys [0, kend) in key tiles [t_lo, t_hi)
  size_t base;
};

template <int BQ, int BK>
__device__ __forceinline__ Work work(int S, int causal) {
  const int tile = gridDim.z - 1 - blockIdx.z;
  const int q0 = tile * BQ;
  const int kend = causal ? min(S, q0 + BQ) : S;
  const int nkt = (kend + BK - 1) / BK;
  const int c = gridDim.x, r = blockIdx.x;
  return {q0, kend, r * nkt / c, (r + 1) * nkt / c,
          static_cast<size_t>(blockIdx.y) * S};
}

// --------------------------------------------------------------------------
// float32 on CUDA cores
// --------------------------------------------------------------------------
template <int D>
struct F32Tile {
  static constexpr int BQ = 32, BK = D >= 128 ? 32 : 64;
  static constexpr int QS = D + 4;                  // q/k row stride (floats)
  static constexpr int kRS = BQ / 8;                // score rows a thread
  static constexpr int kKS = BK / 16;               // score keys a thread
  static constexpr int PS = BQ + 4;                 // row stride of p^T
  static constexpr int TC = D / 4 < 16 ? D / 4 : 16;  // column groups of p@v
  static constexpr int TR = kF32Threads / TC;       // row groups of p@v
  static constexpr int RO = BQ / TR;                // output rows a thread
  static constexpr int CV = D / (4 * TC);           // float4 columns a thread
  static constexpr int kRing = 2 * BK * QS + 2 * BK * D;  // k, v: 2 stages
  static constexpr int kFloats =
      BQ * QS + kRing + BK * PS + BQ + 2 * BQ + BQ * kW;
  static constexpr size_t kSmem = sizeof(float) * kFloats;
  static_assert(kRS == 4, "p^T is stored a float4 of rows at a time");
  static_assert(TR * RO == BQ && TC * CV * 4 == D, "tiling");
  static_assert(BQ * D <= kRing, "the partial acc reuses the ring");
  static_assert(kSmem <= kMaxSmem, "shared memory");
};

template <int D>
__global__ void __launch_bounds__(kF32Threads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out, int S,
              int causal, float sm_scale) {
  using C = F32Tile<D>;
  constexpr int BQ = C::BQ, BK = C::BK, kRS = C::kRS, kKS = C::kKS;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_sh = reinterpret_cast<float*>(smem);  // BQ x QS   scaled q
  float* ring = q_sh + BQ * C::QS;       // 2 x (BK x QS keys, BK x D values)
  float* p_sh = ring + C::kRing;         // BK x PS   p, transposed
  float* a_sh = p_sh + BK * C::PS;       // BQ        this tile's alpha a row
  float* m_sh = a_sh + BQ;               // BQ        partial m, l
  float* l_sh = m_sh + BQ;
  float* w_sh = l_sh + BQ;               // BQ x kW   merge weights

  const Work wk = work<BQ, BK>(S, causal);
  const int q0 = wk.q0;
  const size_t base = wk.base * D;
  const float* kb = k + base;
  const float* vb = v + base;
  const int tid = threadIdx.x;
  // scores: row group sr holds rows sr*4 .. +3, key group sc keys sc + 16j
  const int sr = tid >> 4, sc = tid & 15;
  // p @ v: rows orow .. +RO, float4 columns oc + TC*j
  const int orow = (tid / C::TC) * C::RO, oc = tid % C::TC;

  auto load_kv = [&](int t, int st) {
    float* ks = ring + st * (BK * C::QS + BK * D);
    load_rows<float, D, C::QS, BK, kF32Threads>(kb, t * BK, S, ks);
    load_rows<float, D, D, BK, kF32Threads>(vb, t * BK, S, ks + BK * C::QS);
  };
  if (wk.t_lo < wk.t_hi) load_kv(wk.t_lo, 0);
  cp_async_commit();
  if (wk.t_lo + 1 < wk.t_hi) load_kv(wk.t_lo + 1, 1);
  cp_async_commit();
  // q, scaled once (as `_flash_kernel`), while the first tiles load
  for (int i = tid; i < BQ * D / 4; i += kF32Threads) {
    const int row = i / (D / 4), c4 = i % (D / 4);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + row < S)
      x = *reinterpret_cast<const float4*>(q + base +
                                           static_cast<size_t>(q0 + row) * D +
                                           4 * c4);
    *reinterpret_cast<float4*>(q_sh + row * C::QS + 4 * c4) =
        make_float4(__fmul_rn(x.x, sm_scale), __fmul_rn(x.y, sm_scale),
                    __fmul_rn(x.z, sm_scale), __fmul_rn(x.w, sm_scale));
  }

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

  for (int t = wk.t_lo; t < wk.t_hi; ++t) {
    const int k0 = t * BK, st = (t - wk.t_lo) & 1;
    const float* k_sh = ring + st * (BK * C::QS + BK * D);
    const float* v_sh = k_sh + BK * C::QS;
    cp_async_wait<1>();  // tile t has landed (t+1 may be in flight)
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
    if ((causal && k0 + BK - 1 > q0) || k0 + BK > S) {
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
        const float p = s[i][j] > kMask ? expf(s[i][j] - m_new) : 0.0f;
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
      *reinterpret_cast<float4*>(p_sh + (sc + 16 * j) * C::PS + sr * kRS) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // acc = acc * alpha + p @ v over this tile's keys below kend (p of a
    // masked key is exactly 0)
#pragma unroll
    for (int i = 0; i < C::RO; ++i) {
      const float a = a_sh[orow + i];
#pragma unroll
      for (int c = 0; c < 4 * C::CV; ++c) acc[i][c] *= a;
    }
    const int kn = min(BK, wk.kend - k0);
#pragma unroll 4
    for (int kk = 0; kk < kn; ++kk) {
      float pr[C::RO];
      if constexpr (C::RO == 4) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(p_sh + kk * C::PS + orow);
        pr[0] = p4.x; pr[1] = p4.y; pr[2] = p4.z; pr[3] = p4.w;
      } else {
#pragma unroll
        for (int i = 0; i < C::RO; ++i) pr[i] = p_sh[kk * C::PS + orow + i];
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
    __syncthreads();  // stage st, p and alpha are consumed
    if (t + 2 < wk.t_hi) load_kv(t + 2, st);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it takes this CTA's partial acc
  float* acc_sh = ring;  // BQ x D
#pragma unroll
  for (int i = 0; i < C::RO; ++i)
#pragma unroll
    for (int j = 0; j < C::CV; ++j)
      *reinterpret_cast<float4*>(acc_sh + (orow + i) * D +
                                 4 * (oc + C::TC * j)) =
          make_float4(acc[i][4 * j], acc[i][4 * j + 1], acc[i][4 * j + 2],
                      acc[i][4 * j + 3]);
  if (sc == 0) {
#pragma unroll
    for (int i = 0; i < kRS; ++i) {
      m_sh[sr * kRS + i] = m[i];
      l_sh[sr * kRS + i] = l[i];
    }
  }
  float* o = out + base;
  const int rows = min(BQ, S - q0);
  softmax_merge::cluster_merge<kF32Threads>(
      m_sh, l_sh, acc_sh, rows, D, D, w_sh,
      [o, q0](int row, int col, const float* x, int n) {
        softmax_merge::store_n(o + static_cast<size_t>(q0 + row) * D + col,
                               x, n);
      });
}

// --------------------------------------------------------------------------
// bfloat16 on tensor cores (mma.sync m16n8k16, f32 accumulators)
// --------------------------------------------------------------------------
template <int D>
struct BF16Tile {
  static constexpr int kThreads = 128;  // 4 warps of 16 q rows
  static constexpr int BQ = 64, BK = D == 256 ? 32 : 64;
  static constexpr int QS = D + 8;    // row stride (bf16): 16 bytes of padding
  static constexpr int AS = D + 8;    // row stride (f32) of the partial acc
  static constexpr int kStage = 2 * BK * QS;  // k then v, one stage
  static constexpr size_t kTiles = sizeof(__nv_bfloat16) *
                                   (BQ * QS + 2 * kStage);
  static constexpr size_t kSmem = kTiles + sizeof(float) * (2 * BQ + BQ * kW);
  static_assert(sizeof(float) * BQ * AS <= kTiles,
                "the partial acc reuses the tiles");
  static_assert(kSmem <= kMaxSmem, "shared memory");
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16x16, row) * b (16x8, col); bf16 in, f32 accumulate. Not
// volatile: the compiler may interleave independent products.
__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// p split as p_hi = bf16(p) and p_lo = bf16(p - p_hi), two elements a word
__device__ __forceinline__ void split_bf16(float x, float y, unsigned& hi,
                                           unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = *reinterpret_cast<const unsigned*>(&l);
}

template <int D>
__global__ void __launch_bounds__(BF16Tile<D>::kThreads)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ out, int S, int causal,
               float sm_scale) {
  using C = BF16Tile<D>;
  using bf16 = __nv_bfloat16;
  constexpr int NT = C::kThreads;
  constexpr int BQ = C::BQ, BK = C::BK, QS = C::QS, AS = C::AS;
  constexpr int NS = BK / 8;  // n-blocks of 8 keys in a score row
  constexpr int NO = D / 8;   // n-blocks of 8 columns in an output row
  constexpr bool kSplitK = NS <= 4;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_sh = reinterpret_cast<bf16*>(smem);     // BQ x QS
  bf16* ring = q_sh + BQ * QS;                    // 2 x (BK x QS k, v)
  float* m_sh = reinterpret_cast<float*>(smem + C::kTiles);  // BQ
  float* l_sh = m_sh + BQ;                                    // BQ
  float* w_sh = l_sh + BQ;                                    // BQ x kW

  const Work wk = work<BQ, BK>(S, causal);
  const int q0 = wk.q0;
  const size_t base = wk.base * D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp * 16;  // this warp's 16 q rows
  const int g = lane >> 2, tg = lane & 3;  // the mma fragment's row, pair
  const int row_a = q0 + wr + g, row_b = row_a + 8;

  auto load_kv = [&](int t, int st) {
    bf16* ks = ring + st * C::kStage;
    load_rows<bf16, D, QS, BK, NT>(k + base, t * BK, S, ks);
    load_rows<bf16, D, QS, BK, NT>(v + base, t * BK, S, ks + BK * QS);
  };
  load_rows<bf16, D, QS, BQ, NT>(q + base, q0, S, q_sh);
  if (wk.t_lo < wk.t_hi) load_kv(wk.t_lo, 0);
  cp_async_commit();
  if (wk.t_lo + 1 < wk.t_hi) load_kv(wk.t_lo + 1, 1);
  cp_async_commit();

  float m_a = kMask, m_b = kMask, l_a = 0.0f, l_b = 0.0f;
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;

  // ldmatrix row addresses of this lane: A (q) rows lane % 16, columns
  // + 8 for lanes 16..31; B from k, keys (lane / 16) * 8 + lane % 8,
  // columns + 8 for lanes 8..15 and 24..31; B from v (transposed), keys
  // ((lane / 8) % 2) * 8 + lane % 8, columns + 8 for lanes 16..31
  const bf16* qa = q_sh + (wr + (lane & 15)) * QS + (lane >> 4) * 8;
  const int kr = (lane >> 4) * 8 + (lane & 7), kc = ((lane >> 3) & 1) * 8;
  const int vr = ((lane >> 3) & 1) * 8 + (lane & 7), vc = (lane >> 4) * 8;

  for (int t = wk.t_lo; t < wk.t_hi; ++t) {
    const int k0 = t * BK, st = (t - wk.t_lo) & 1;
    const bf16* k_sh = ring + st * C::kStage;
    const bf16* v_sh = k_sh + BK * QS;
    cp_async_wait<1>();  // q and tile t have landed (t+1 may be in flight)
    __syncthreads();
    // a warp whose rows all lie above this key tile skips it (causal)
    if (!(causal && k0 > q0 + wr + 15)) {
      // s = q k^T; with few key blocks (NS <= 4) the depth goes over two
      // sets of accumulators (even and odd steps), so that twice as many
      // products are in flight
      float s[NS][4], s2[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = s2[n][e] = 0.0f;
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        unsigned a[4];
        ldmatrix_x4(a, qa + kd * 16);
#pragma unroll
        for (int n2 = 0; n2 < NS / 2; ++n2) {
          unsigned b[4];
          ldmatrix_x4(b, k_sh + (n2 * 16 + kr) * QS + kd * 16 + kc);
          if (kSplitK && (kd & 1)) {
            mma_bf16(s2[2 * n2], a, b[0], b[1]);
            mma_bf16(s2[2 * n2 + 1], a, b[2], b[3]);
          } else {
            mma_bf16(s[2 * n2], a, b[0], b[1]);
            mma_bf16(s[2 * n2 + 1], a, b[2], b[3]);
          }
        }
      }
      const bool edge = (causal && k0 + BK - 1 > q0 + wr) || k0 + BK > S;
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (kSplitK) s[n][e] += s2[n][e];
          s[n][e] *= sm_scale;
          if (edge) {
            const int kp = k0 + n * 8 + 2 * tg + (e & 1);
            const int qp = e < 2 ? row_a : row_b;
            if (kp >= S || (causal && kp > qp)) s[n][e] = kMask;
          }
        }
      // online softmax on the fragments: a quad (4 lanes) shares a row
      float mx_a = kMask, mx_b = kMask;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        mx_a = fmaxf(mx_a, fmaxf(s[n][0], s[n][1]));
        mx_b = fmaxf(mx_b, fmaxf(s[n][2], s[n][3]));
      }
#pragma unroll
      for (int x = 1; x < 4; x <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, x));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, x));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float mn = e < 2 ? mn_a : mn_b;
          const float p = s[n][e] > kMask ? expf(s[n][e] - mn) : 0.0f;
          s[n][e] = p;
          if (e < 2) sum_a += p; else sum_b += p;
        }
#pragma unroll
      for (int x = 1; x < 4; x <<= 1) {
        sum_a += __shfl_xor_sync(0xffffffffu, sum_a, x);
        sum_b += __shfl_xor_sync(0xffffffffu, sum_b, x);
      }
      const float al_a = expf(m_a - mn_a), al_b = expf(m_b - mn_b);
      l_a = fmaf(l_a, al_a, sum_a);
      l_b = fmaf(l_b, al_b, sum_b);
      m_a = mn_a;
      m_b = mn_b;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][0] *= al_a;
        o[n][1] *= al_a;
        o[n][2] *= al_b;
        o[n][3] *= al_b;
      }
      // o += p_hi @ v + p_lo @ v, 16 keys a step
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        unsigned ph[4], pl[4];
        split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
        split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
        split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
        split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int n2 = 0; n2 < NO / 2; ++n2) {
          unsigned b[4];
          ldmatrix_x4_trans(b, v_sh + (kk * 16 + vr) * QS + n2 * 16 + vc);
          mma_bf16(o[2 * n2], ph, b[0], b[1]);
          mma_bf16(o[2 * n2 + 1], ph, b[2], b[3]);
          mma_bf16(o[2 * n2], pl, b[0], b[1]);
          mma_bf16(o[2 * n2 + 1], pl, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // stage st is consumed
    if (t + 2 < wk.t_hi) load_kv(t + 2, st);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();  // the tiles are free: they take the partial acc
  float* acc_sh = reinterpret_cast<float*>(smem);  // BQ x AS
  const int ra = wr + g;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int col = n * 8 + 2 * tg;
    *reinterpret_cast<float2*>(acc_sh + ra * AS + col) =
        make_float2(o[n][0], o[n][1]);
    *reinterpret_cast<float2*>(acc_sh + (ra + 8) * AS + col) =
        make_float2(o[n][2], o[n][3]);
  }
  if (tg == 0) {
    m_sh[ra] = m_a;
    l_sh[ra] = l_a;
    m_sh[ra + 8] = m_b;
    l_sh[ra + 8] = l_b;
  }
  bf16* op = out + base;
  const int rows = min(BQ, S - q0);
  softmax_merge::cluster_merge<NT>(
      m_sh, l_sh, acc_sh, rows, D, AS, w_sh,
      [op, q0](int row, int col, const float* x, int n) {
        softmax_merge::store_n(op + static_cast<size_t>(q0 + row) * D + col,
                               x, n);
      });
}

// --------------------------------------------------------------------------
template <typename T, int D>
struct Kernel;
template <int D>
struct Kernel<float, D> {
  using Tile = F32Tile<D>;
  static constexpr int kThreads = kF32Threads;
  static constexpr auto fn = flash_fwd_f32<D>;
};
template <int D>
struct Kernel<__nv_bfloat16, D> {
  using Tile = BF16Tile<D>;
  static constexpr int kThreads = BF16Tile<D>::kThreads;
  static constexpr auto fn = flash_fwd_bf16<D>;
};

template <typename T, int D>
int launch_d(const T* q, const T* k, const T* v, T* out, int BH, int S,
             int causal, int cluster, float sm_scale, cudaStream_t stream) {
  using Tile = typename Kernel<T, D>::Tile;
  const int nq = (S + Tile::BQ - 1) / Tile::BQ;
  if (nq > 65535) return static_cast<int>(cudaErrorInvalidValue);
  return softmax_merge::launch_cluster(Kernel<T, D>::fn,
                                       dim3(cluster, BH, nq),
                                       Kernel<T, D>::kThreads,
                                       Tile::kSmem, stream, cluster, q, k, v,
                                       out, S, causal, sm_scale);
}

template <typename T>
int launch(const T* q, const T* k, const T* v, T* out, int BH, int S, int D,
           int causal, int cluster, float sm_scale, void* stream) {
  if (BH <= 0 || BH > 65535 || S <= 0 || cluster < 1 ||
      cluster > softmax_merge::kMaxCluster || D % cluster ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) %
          16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch_d<T, 16>(q, k, v, out, BH, S, causal, cluster,
                             sm_scale, st);
    case 32:
      return launch_d<T, 32>(q, k, v, out, BH, S, causal, cluster,
                             sm_scale, st);
    case 64:
      return launch_d<T, 64>(q, k, v, out, BH, S, causal, cluster,
                             sm_scale, st);
    case 128:
      return launch_d<T, 128>(q, k, v, out, BH, S, causal, cluster,
                              sm_scale, st);
    case 256:
      return launch_d<T, 256>(q, k, v, out, BH, S, causal, cluster,
                              sm_scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int D>
int tiles_d(int* bq, int* bk) {
  *bq = Kernel<T, D>::Tile::BQ;
  *bk = Kernel<T, D>::Tile::BK;
  return 0;
}

template <typename T>
int tiles(int D, int* bq, int* bk) {
  switch (D) {
    case 16: return tiles_d<T, 16>(bq, bk);
    case 32: return tiles_d<T, 32>(bq, bk);
    case 64: return tiles_d<T, 64>(bq, bk);
    case 128: return tiles_d<T, 128>(bq, bk);
    case 256: return tiles_d<T, 256>(bq, bk);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The kernel's tiles for an element size (4: f32, 2: bf16) and head dim
// D: BQ query rows and BK keys, which the wrapper's plan (`flash_split`)
// reads from here. Returns 0, or cudaErrorInvalidValue for a size or head
// dim the kernel is not built for.
extern "C" int flash_attention_tiles(int esize, int D, int* bq, int* bk) {
  if (esize == 4) return tiles<float>(D, bq, bk);
  if (esize == 2) return tiles<__nv_bfloat16>(D, bq, bk);
  return static_cast<int>(cudaErrorInvalidValue);
}

// C interface. Pointers are device pointers of contiguous (BH, S, D)
// arrays (the Python wrapper checks shapes, types, devices, contiguity
// and alignment). `causal` is 0 or 1; `cluster` comes from the wrapper's
// plan (`flash_split`): 1..8 CTAs a q tile, dividing D. `stream` is a
// cudaStream_t. Each returns the launch's error: 0 when the kernel was
// accepted.

extern "C" int flash_attention_f32(const float* q, const float* k,
                                   const float* v, float* out, int BH, int S,
                                   int D, int causal, int cluster,
                                   float sm_scale, void* stream) {
  return launch<float>(q, k, v, out, BH, S, D, causal, cluster, sm_scale,
                       stream);
}

extern "C" int flash_attention_bf16(const __nv_bfloat16* q,
                                    const __nv_bfloat16* k,
                                    const __nv_bfloat16* v,
                                    __nv_bfloat16* out, int BH, int S, int D,
                                    int causal, int cluster, float sm_scale,
                                    void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, BH, S, D, causal, cluster,
                               sm_scale, stream);
}
