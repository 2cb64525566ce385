// Mamba2's chunked SSD (state-space duality), forward and backward, on
// CUDA cores in float32: kernel set B5 of the port.
//
// It replaces no TPU kernel: the JAX package runs the SSD as XLA
// (`repro/models/mixers.py::_ssd_chunked`). Its plain PyTorch form
// (`kernels/ref.py::ssd_chunked_ref`) materialises three float32 blocks of
// shape (B, nc, L, L, H) a call (the decays, their masked exponent and the
// weights) and runs them through broadcasting passes; at mamba2-1.3b's
// chunk of 256 each is 268 MB a layer. Here no (L, L) block of a head
// reaches device memory: a CTA forms G = C·Bᵀ once for all of its heads
// in shared memory (G does not depend on the head) and builds each head's
// decay from `cum`, the chunk-local running sum of A·dt. On the diagonal
// 64 x 64 tile the decay is exp(cum_l − cum_m) with the exponent masked
// above the diagonal before the exp (C4: finite gradients at chunk 256);
// off it the decay splits at a pivot q between the tiles,
// exp(cum_l − cum_q)·exp(cum_q − cum_m), both factors at most 1, so those
// tiles multiply G itself by operand rows scaled once. Tiles above the
// diagonal are skipped.
//
// What bounds it: float32 FMAs. Per (batch, chunk, head) with L positions,
// P channels and N states, the forward does about L²·P/2 (the masked
// product) + 2·L·P·N (the chunk state and its read-out) multiply-adds
// plus L²·N/2 per (batch, chunk) for C·Bᵀ; the backward about twice that.
// Operands that are the model's activations (x, B, C, dy) may be bfloat16:
// they are loaded 16 bytes at a time and widened. Everything formed here
// (cum, the decays, the weights, the states) stays float32, and every sum
// too. Tiles are 64 x 64 in shared memory, 256 threads a CTA, each thread a
// 4 x 4 block of the output in registers (FFMA, no tensor cores); the two
// kernels with one CTA an SM (`scan`, `bwd_dx`) load each phase's global
// operand into registers while the product before it runs.
//
// Kernels (all names start with `ssd_chunk_`, which the benchmark's
// `ssd_ms` reads):
//   forward   cumsum   cum (B, T, H) and cd (B, nc, H) = exp(cum at the chunk's end)
//             state    S_c[p, n] = Σ_l dt_l·exp(cum_end − cum_l)·x_lp·B_ln
//             pass     the recurrence over chunks, h ← h·cd_c + S_c, in
//                      place: hs[c] becomes the state entering chunk c
//             scan     y = exp(cum_l)·C_l·hs[c]ᵀ + Σ_{m≤l} G_lm·decay·dt_m·x_m
//   backward  state    dHi[c] = Σ_l exp(cum_l)·dy_l ⊗ C_l (mode 1)
//             pass_bwd the reversed recurrence: dS_c, and d(cd_c)'s part of each CTA
//             bwd_bc   dB from the states, dC from the read-out: one GEMM
//                      over (head, channel) a (batch, chunk)
//             bwd_dx   dx (the masked product's transpose and the states),
//                      the state and read-out terms of dt and cum
//             bwd_dg   dW = dy·xᵀ on the lower triangle: the cum and dt
//                      terms of the masked product, and dG summed over the
//                      CTA's heads
//             bwd_gbc  dB += dGᵀ·C and dC += dG·B, dG summed over the head groups
//             bwd_dt   da = the reversed running sum of dcum; ddt += A·da,
//                      dA's part of each (batch, chunk, head)
// The backward is deterministic: no atomics. Where several CTAs add to one value, each
// writes its part to a slot of its own in a workspace, and one later kernel sums the
// slots in a fixed order; so one input gives the same bits on every run.
// The skip D·x stays in PyTorch (`kernels/ssd.py`).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // threads a CTA, each a 4 x 4 block of a 64 x 64 tile
constexpr int TS = 68;   // floats a row of a 64-wide tile in shared memory (rows stay 16-byte aligned)
constexpr int HG_SCAN = 8;   // heads a CTA of `scan` and `bwd_dx` (they share its C·Bᵀ band)
constexpr int HG_DG = 16;    // heads a CTA of `bwd_dg` (they share its C·Bᵀ tile)

struct Ops {
  const void* x; long long xb, xt;    // x (B, T, H·P): batch and token strides, channels contiguous
  const void* bm; long long bb, bt;   // B (B, T, N)
  const void* cm; long long cb, ct;   // C (B, T, N)
  const void* dy;                     // dy (B, T, H·P), contiguous
  const float* dt;                    // (B, T, H)
  const float* A;                     // (H)
  float* cum;                         // (B, T, H)
  float* cd;                          // (B, nc, H)
  float* hs;                          // (B, nc, H, P, N)
  int Bn, T, H, P, N, L, nc;
};

// 4 consecutive elements, rounded to bfloat16 or kept float (8 or 16 bytes, aligned)
__device__ __forceinline__ void st4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, const float v[4]) {
  uint2 u;
  u.x = (unsigned)__bfloat16_as_ushort(__float2bfloat16(v[0])) |
        ((unsigned)__bfloat16_as_ushort(__float2bfloat16(v[1])) << 16);
  u.y = (unsigned)__bfloat16_as_ushort(__float2bfloat16(v[2])) |
        ((unsigned)__bfloat16_as_ushort(__float2bfloat16(v[3])) << 16);
  *reinterpret_cast<uint2*>(p) = u;
}

// A thread's 4 x 4 block of a 64 x 64 tile: rows ty·4.., columns tx·4... A warp covers
// 32 rows x 16 columns.
__device__ __forceinline__ int tile_x() { return ((threadIdx.x >> 5) & 3) * 4 + (threadIdx.x & 3); }
__device__ __forceinline__ int tile_y() { return (threadIdx.x >> 7) * 8 + ((threadIdx.x >> 2) & 7); }

// acc[i][j] += Σ_k A(k, ty·4+i)·B(k, tx·4+j), k < K; A(k, i) = A[k·lda + i], B likewise
__device__ __forceinline__ void mm_kk(const float* A, int lda, const float* B, int ldb,
                                      int K, float acc[4][4]) {
  const int tx = tile_x(), ty = tile_y();
  const float* a = A + ty * 4;
  const float* b = B + tx * 4;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(a + k * lda);
    const float4 bv = *reinterpret_cast<const float4*>(b + k * ldb);
    const float ar[4] = {av.x, av.y, av.z, av.w};
    const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
  }
}

// the same with A stored the other way: A(k, i) = A[i·lda + k]
__device__ __forceinline__ void mm_ik(const float* A, int lda, const float* B, int ldb,
                                      int K, float acc[4][4]) {
  const int tx = tile_x(), ty = tile_y();
  const float* a = A + ty * 4 * lda;
  const float* b = B + tx * 4;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float4 bv = *reinterpret_cast<const float4*>(b + k * ldb);
    const float ar[4] = {a[k], a[lda + k], a[2 * lda + k], a[3 * lda + k]};
    const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
  }
}

// 8 consecutive elements of a row as loaded (bfloat16: one 16-byte load; float: two)
template <class E> struct Raw8;
template <> struct Raw8<__nv_bfloat16> {
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    u = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void get(float v[8]) const {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[2 * j] = __uint_as_float(w[j] << 16);
      v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
};
template <> struct Raw8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = *reinterpret_cast<const float4*>(p);
    b = *reinterpret_cast<const float4*>(p + 4);
  }
  __device__ __forceinline__ void get(float v[8]) const {
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
};

// A thread's share of a tile of K ≤ 64 rows and TW columns read along its global rows,
// held in registers between `load` and `store`, so that a product can run while the
// loads are in flight. row(k) points at row k's first element (16-byte aligned), or is
// null for a row of zeros; only its first W columns (a multiple of 8) hold data, the
// rest of the tile is zero. `store` writes dst[k·ld + i] = s(k)·row(k)[i]; a thread moves
// 8 elements at a time, neighbouring threads along the row.
template <int TW, class E> struct RowTile {
  static constexpr int G = TW / 8, IT = 64 * G / NT;
  Raw8<E> r[IT];
  unsigned ok;
  template <class Row>
  __device__ __forceinline__ void load(int K, int W, Row row) {
    const int g = threadIdx.x % G;
    ok = 0;
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int k = threadIdx.x / G + it * (NT / G);
      const E* p = k < K && g * 8 < W ? row(k) : nullptr;
      if (p != nullptr) {
        r[it].load(p + g * 8);
        ok |= 1u << it;
      }
    }
  }
  template <class Scale>
  __device__ __forceinline__ void store(float* dst, int ld, int K, Scale s) const {
    const int g = threadIdx.x % G;
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int k = threadIdx.x / G + it * (NT / G);
      if (k >= K) continue;
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (ok >> it & 1u) {
        r[it].get(v);
        const float sc = s(k);
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] *= sc;
      }
      float4* d = reinterpret_cast<float4*>(dst + k * ld + g * 8);
      d[0] = make_float4(v[0], v[1], v[2], v[3]);
      d[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
};

// A thread's share of a tile read along 64 global rows i and stored transposed:
// `store` writes dst[k·ld + i] = s(k, i)·row(i)[k] for k < K (a multiple of 8, at most
// KMAX). row(i) points at row i's first element (16-byte aligned), or is null for zeros;
// s is asked once for each 8 consecutive k. A thread moves 8 elements of one row,
// neighbouring threads on neighbouring rows.
template <int KMAX, class E> struct ColTile {
  static constexpr int IT = 8 * KMAX / NT;
  Raw8<E> r[IT];
  unsigned ok;
  template <class Row>
  __device__ __forceinline__ void load(int K, Row row) {
    ok = 0;
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int e = threadIdx.x + it * NT;
      const E* p = e < 8 * K ? row(e & 63) : nullptr;
      if (p != nullptr) {
        r[it].load(p + (e >> 6) * 8);
        ok |= 1u << it;
      }
    }
  }
  template <class Scale>
  __device__ __forceinline__ void store(float* dst, int ld, int K, Scale s) const {
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int e = threadIdx.x + it * NT;
      if (e >= 8 * K) continue;
      const int i = e & 63, k = (e >> 6) * 8;
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (ok >> it & 1u) {
        r[it].get(v);
        const float sc = s(k, i);
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] *= sc;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) dst[(k + j) * ld + i] = v[j];
    }
  }
};

// a RowTile loaded and stored at once
template <int TW, class E, class Row, class Scale>
__device__ __forceinline__ void fill_rows(float* dst, int ld, int K, int W, Row row, Scale s) {
  RowTile<TW, E> t;
  t.load(K, W, row);
  t.store(dst, ld, K, s);
}

// a ColTile (K ≤ 128) loaded and stored at once
template <class E, class Row, class Scale>
__device__ __forceinline__ void fill_cols(float* dst, int ld, int K, Row row, Scale s) {
  ColTile<128, E> t;
  t.load(K, row);
  t.store(dst, ld, K, s);
}

// dst[k·ld + i] = f(k, i) for a 64 x 64 tile computed in place (no global loads)
template <class F>
__device__ __forceinline__ void fill64(float* dst, int ld, F f) {
#pragma unroll 4
  for (int e = threadIdx.x; e < 64 * 64; e += NT) dst[(e >> 6) * ld + (e & 63)] = f(e >> 6, e & 63);
}

__device__ __forceinline__ float one(int) { return 1.f; }
__device__ __forceinline__ float one2(int, int) { return 1.f; }

// the sum of v over a warp, in every lane
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NT) ssd_chunk_cumsum(Ops o) {
  const int idx = blockIdx.x * NT + threadIdx.x;  // (b, c, h), h fastest
  if (idx >= o.Bn * o.nc * o.H) return;
  const int h = idx % o.H, bc = idx / o.H, c = bc % o.nc, b = bc / o.nc;
  const long long base = ((long long)b * o.T + (long long)c * o.L) * o.H + h;
  const float a = o.A[h];
  float s = 0.f;
  for (int l0 = 0; l0 < o.L; l0 += 8) {
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = l0 + j < o.L ? o.dt[base + (long long)(l0 + j) * o.H] : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (l0 + j < o.L) {
        s = __fadd_rn(s, __fmul_rn(a, v[j]));
        o.cum[base + (long long)(l0 + j) * o.H] = s;
      }
    }
  }
  o.cd[idx] = expf(s);
}

// MODE 0: out = S_c (x, B, dt·exp(cum_end − cum_l)); MODE 1: out = dHi (dy, C, exp(cum_l)).
// grid (P tiles · N tiles, B·nc, H)
template <class E, int MODE>
__global__ void __launch_bounds__(NT, 2) ssd_chunk_state(Ops o, float* out) {
  __shared__ __align__(16) float As[64 * TS];
  __shared__ __align__(16) float Bs[64 * TS];
  __shared__ float sv[256];  // the row scales
  const int H = o.H, P = o.P, N = o.N, L = o.L;
  const int nNt = (N + 63) / 64;
  const int p0 = (blockIdx.x / nNt) * 64, n0 = (blockIdx.x % nNt) * 64;
  const int b = blockIdx.y / o.nc, c = blockIdx.y % o.nc, h = blockIdx.z;
  const long long t0 = (long long)c * L;
  const float* cum = o.cum + ((long long)b * o.T + t0) * H + h;
  const float* dt = o.dt + ((long long)b * o.T + t0) * H + h;
  const float last = cum[(long long)(L - 1) * H];
  const E* xs;
  const E* ys;
  long long xt, yt;
  if (MODE == 0) {
    xs = (const E*)o.x + b * o.xb + t0 * o.xt + h * P + p0;
    xt = o.xt;
    ys = (const E*)o.bm + b * o.bb + t0 * o.bt + n0;
    yt = o.bt;
  } else {
    xt = (long long)H * P;
    xs = (const E*)o.dy + ((long long)b * o.T + t0) * xt + h * P + p0;
    ys = (const E*)o.cm + b * o.cb + t0 * o.ct + n0;
    yt = o.ct;
  }
  for (int l = threadIdx.x; l < L; l += NT) {
    const float cl = cum[(long long)l * H];
    sv[l] = MODE == 0 ? dt[(long long)l * H] * expf(last - cl) : expf(cl);
  }
  __syncthreads();
  const int wp = min(64, P - p0), wn = min(64, N - n0);
  float acc[4][4] = {};
  for (int l0 = 0; l0 < L; l0 += 64) {
    const int kl = min(64, L - l0);
    fill_rows<64, E>(As, TS, kl, wp, [&](int k) { return xs + (l0 + k) * xt; },
                     [&](int k) { return sv[l0 + k]; });
    fill_rows<64, E>(Bs, TS, kl, wn, [&](int k) { return ys + (l0 + k) * yt; }, one);
    __syncthreads();
    mm_kk(As, TS, Bs, TS, kl, acc);
    __syncthreads();
  }
  const int tx = tile_x(), ty = tile_y();
  float* dst = out + (((long long)b * o.nc + c) * H + h) * (long long)P * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = p0 + ty * 4 + i, n = n0 + tx * 4;
    if (p < P && n < N) st4(dst + (long long)p * N + n, acc[i]);
  }
}

// hs holds S_c on entry and the state entering chunk c on exit; grid (⌈P·N/256⌉, B·H)
__global__ void __launch_bounds__(NT) ssd_chunk_pass(Ops o, float* hfin) {
  const int PN = o.P * o.N;
  const int e = blockIdx.x * NT + threadIdx.x;
  if (e >= PN) return;
  const int b = blockIdx.y / o.H, h = blockIdx.y % o.H;
  float run = 0.f;
  for (int c0 = 0; c0 < o.nc; c0 += 4) {
    float sv[4], dv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long bch = ((long long)b * o.nc + c0 + j) * o.H + h;
      sv[j] = c0 + j < o.nc ? o.hs[bch * PN + e] : 0.f;
      dv[j] = c0 + j < o.nc ? o.cd[bch] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (c0 + j < o.nc) {
        o.hs[(((long long)b * o.nc + c0 + j) * o.H + h) * PN + e] = run;
        run = __fadd_rn(__fmul_rn(run, dv[j]), sv[j]);
      }
    }
  }
  hfin[((long long)b * o.H + h) * PN + e] = run;
}

// y for 64 rows (l0..l0+63) of a chunk and up to HG_SCAN heads; grid (⌈L/64⌉, B·nc,
// ⌈H/HG_SCAN⌉). Left of the diagonal tile the decay splits at the pivot l0:
// exp(cum_l − cum_m) = exp(cum_l − cum_l0)·exp(cum_l0 − cum_m), both factors at most 1, so
// those tiles multiply G itself by x scaled by rows, and only the diagonal tile forms
// its masked weights.
template <class E>
__global__ void __launch_bounds__(NT) ssd_chunk_scan(Ops o, E* y) {
  extern __shared__ __align__(16) float sm[];
  const int H = o.H, P = o.P, N = o.N, L = o.L;
  const int nLp = (L + 63) / 64 * 64, KN = max(N, 64);
  float* CsT = sm;               // [N][TS]: CsT[n][i] = C[l0 + i][n]
  float* Bop = CsT + N * TS;     // [KN][TS]: the second operand
  float* GT = Bop + KN * TS;     // [nLp][TS]: GT[m][i] = G[l0 + i][m]
  float* Wb = GT + nLp * TS;     // [64][TS]: the diagonal tile's weights, Wb[m − l0][l − l0]
  float* cs = Wb + 64 * TS;      // [nLp] cum of the head
  float* sc = cs + nLp;          // [nLp] dt_m·exp(cum_l0 − cum_m) left of the tile, dt_m on it
  float* er = sc + nLp;          // [64] exp(cum_l − cum_l0) of the tile's rows
  const int l0 = blockIdx.x * 64;
  const int b = blockIdx.y / o.nc, c = blockIdx.y % o.nc;
  const int h0 = blockIdx.z * HG_SCAN, h1 = min(H, h0 + HG_SCAN);
  const long long t0 = (long long)c * L;
  const long long HP = (long long)H * P;
  const E* xg = (const E*)o.x + b * o.xb + t0 * o.xt;
  const E* bg = (const E*)o.bm + b * o.bb + t0 * o.bt;
  const E* cg = (const E*)o.cm + b * o.cb + t0 * o.ct;
  const int lend = min(L, l0 + 64);
  const int tx = tile_x(), ty = tile_y();

  fill_cols<E>(CsT, TS, N, [&](int i) -> const E* {
    return l0 + i < L ? cg + (l0 + i) * o.ct : nullptr;
  }, one2);
  for (int m0 = 0; m0 < lend; m0 += 64) {  // G's band, the diagonal tile included
    fill_cols<E>(Bop, TS, N, [&](int j) -> const E* {
      return m0 + j < L ? bg + (m0 + j) * o.bt : nullptr;
    }, one2);
    __syncthreads();
    float g[4][4] = {};
    mm_kk(CsT, TS, Bop, TS, N, g);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) GT[(m0 + tx * 4 + j) * TS + ty * 4 + i] = g[i][j];
    __syncthreads();
  }

  // A step is a (head, 64 channels). Each phase's global operand is loaded into
  // registers while the product before it runs: the state read-out's hs, then the x
  // tiles of the masked product, then the next step's hs.
  ColTile<128, float> hsr;
  RowTile<64, E> xr;
  auto load_hs = [&](int h, int p0) {
    const float* hsh = o.hs + (((long long)b * o.nc + c) * H + h) * (long long)P * N;
    const int wp = min(64, P - p0);
    hsr.load(N, [&](int j) -> const float* {
      return j < wp ? hsh + (long long)(p0 + j) * N : nullptr;
    });
  };
  auto load_x = [&](int h, int p0, int m0) {
    xr.load(64, min(64, P - p0), [&](int k) -> const E* {
      return m0 + k < L ? xg + (m0 + k) * o.xt + h * P + p0 : nullptr;
    });
  };
  if (h0 < h1) load_hs(h0, 0);
  for (int h = h0; h < h1; ++h) {
    const float* cumh = o.cum + ((long long)b * o.T + t0) * H + h;
    const float* dth = o.dt + ((long long)b * o.T + t0) * H + h;
    const float piv = cumh[(long long)l0 * H];
    for (int m = threadIdx.x; m < lend; m += NT) {
      const float cm = cumh[(long long)m * H], dtm = dth[(long long)m * H];
      cs[m] = cm;
      sc[m] = m < l0 ? dtm * expf(piv - cm) : dtm;
      if (m >= l0) er[m - l0] = expf(cm - piv);
    }
    for (int p0 = 0; p0 < P; p0 += 64) {
      float acc[4][4] = {};
      // the read-out of the state entering the chunk, times exp(cum_l)
      hsr.store(Bop, TS, N, one2);
      __syncthreads();
      load_x(h, p0, 0);  // the first tile of the masked product
      mm_kk(CsT, TS, Bop, TS, N, acc);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = l0 + ty * 4 + i;
        const float e = l < L ? expf(cs[l]) : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= e;
      }
      if (l0 > 0) {  // the tiles left of the diagonal
        float a2[4][4] = {};
        for (int m0 = 0; m0 < l0; m0 += 64) {
          xr.store(Bop, TS, 64, [&](int k) { return sc[m0 + k]; });
          __syncthreads();
          load_x(h, p0, m0 + 64);  // the next tile: at m0 + 64 = l0, the diagonal one
          mm_kk(GT + m0 * TS, TS, Bop, TS, 64, a2);
          __syncthreads();
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float e = er[ty * 4 + i];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(e, a2[i][j], acc[i][j]);
        }
      }
      // the diagonal tile, its exponent masked above the diagonal
      fill64(Wb, TS, [&](int k, int i) {
        const int m = l0 + k, l = l0 + i;
        return (m <= l && l < L) ? GT[m * TS + i] * expf(cs[l] - cs[m]) * sc[m] : 0.f;
      });
      xr.store(Bop, TS, 64, one);
      __syncthreads();
      if (p0 + 64 < P) {
        load_hs(h, p0 + 64);
      } else if (h + 1 < h1) {
        load_hs(h + 1, 0);
      }
      mm_kk(Wb, TS, Bop, TS, 64, acc);
      __syncthreads();
      E* yh = y + ((long long)b * o.T + t0) * HP + h * P;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = l0 + ty * 4 + i, p = p0 + tx * 4;
        if (l < L && p < P) st4(yh + l * HP + p, acc[i]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------
// ds holds dHi on entry and dS_c (the gradient of the state after chunk c) on exit;
// dcdp[(b, c, h), blockIdx.x] = Σ over the CTA's (p, n) of dS_c·hs[c], the CTA's part of
// d(cd_c). grid (⌈P·N/256⌉, B·H)
__global__ void __launch_bounds__(NT) ssd_chunk_pass_bwd(Ops o, const float* dhf, float* ds,
                                                          float* dcdp) {
  __shared__ float red[4][NT / 32];
  const int PN = o.P * o.N;
  const int e = blockIdx.x * NT + threadIdx.x;
  const bool on = e < PN;
  const int b = blockIdx.y / o.H, h = blockIdx.y % o.H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float g = (on && dhf != nullptr) ? dhf[((long long)b * o.H + h) * PN + e] : 0.f;
  for (int c1 = o.nc; c1 > 0; c1 -= 4) {  // chunks c1 − 1 down to c1 − 4
    float dv[4], hv[4], cv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c1 - 1 - j;
      const long long at = (((long long)b * o.nc + c) * o.H + h) * PN + e;
      dv[j] = (on && c >= 0) ? ds[at] : 0.f;
      hv[j] = (on && c >= 0) ? o.hs[at] : 0.f;
      cv[j] = c >= 0 ? o.cd[((long long)b * o.nc + c) * o.H + h] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c1 - 1 - j;
      if (on && c >= 0) ds[(((long long)b * o.nc + c) * o.H + h) * PN + e] = g;
      const float part = warp_sum(g * hv[j]);
      if (lane == 0) red[j][warp] = part;
      g = fmaf(g, cv[j], dv[j]);
    }
    __syncthreads();
    if (threadIdx.x < 4 && c1 - 1 - (int)threadIdx.x >= 0) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < NT / 32; ++w) s += red[threadIdx.x][w];
      dcdp[(((long long)b * o.nc + c1 - 1 - threadIdx.x) * o.H + h) * gridDim.x + blockIdx.x] = s;
    }
    __syncthreads();
  }
}

// dB (which 0) from the states and dC (which 1) from the read-out, for 64 rows and
// 64 state channels of a chunk, summed over (head, channel); plain stores, before
// `bwd_dg` adds to them. grid (⌈L/64⌉·⌈N/64⌉, B·nc, 2)
template <class E>
__global__ void __launch_bounds__(NT, 2) ssd_chunk_bwd_bc(Ops o, const float* dS, float* dB,
                                                          float* dC) {
  __shared__ __align__(16) float As[64 * TS];
  __shared__ __align__(16) float Bs[64 * TS];
  __shared__ float sv[4 * 64];  // the row scales of the (at most 4) heads of a K tile
  const int H = o.H, P = o.P, N = o.N, L = o.L;
  const int lgP = __ffs(P) - 1;
  const int nNt = (N + 63) / 64;
  const int m0 = (blockIdx.x / nNt) * 64, n0 = (blockIdx.x % nNt) * 64;
  const int b = blockIdx.y / o.nc, c = blockIdx.y % o.nc, which = blockIdx.z;
  const long long t0 = (long long)c * L;
  const int HP = H * P;
  const E* xs;
  long long xt;
  if (which == 0) {
    xs = (const E*)o.x + b * o.xb + t0 * o.xt;
    xt = o.xt;
  } else {
    xs = (const E*)o.dy + ((long long)b * o.T + t0) * HP;
    xt = HP;
  }
  const float* Z = (which == 0 ? dS : o.hs) + ((long long)b * o.nc + c) * (long long)HP * N;
  const float* cum = o.cum + ((long long)b * o.T + t0) * H;
  const float* dt = o.dt + ((long long)b * o.T + t0) * H;
  const int wn = min(64, N - n0);
  float acc[4][4] = {};
  for (int k0 = 0; k0 < HP; k0 += 64) {
    const int kc = min(64, HP - k0), hlo = k0 >> lgP;
    {
      const int j = threadIdx.x >> 6, i = threadIdx.x & 63, h = hlo + j, m = m0 + i;
      if (h < H && m < L) {
        const float cm = cum[(long long)m * H + h];
        sv[threadIdx.x] = which == 0
                              ? dt[(long long)m * H + h] * expf(cum[(long long)(L - 1) * H + h] - cm)
                              : expf(cm);
      }
    }
    __syncthreads();
    fill_cols<E>(As, TS, kc, [&](int i) -> const E* {
      return m0 + i < L ? xs + (m0 + i) * xt + k0 : nullptr;
    }, [&](int k, int i) { return sv[(((k0 + k) >> lgP) - hlo) * 64 + i]; });
    fill_rows<64, float>(Bs, TS, kc, wn, [&](int k) { return Z + (long long)(k0 + k) * N + n0; },
                         one);
    __syncthreads();
    mm_kk(As, TS, Bs, TS, kc, acc);
    __syncthreads();
  }
  const int tx = tile_x(), ty = tile_y();
  float* out = (which == 0 ? dB : dC) + ((long long)b * o.T + t0) * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i, n = n0 + tx * 4;
    if (m < L && n < N) st4(out + (long long)m * N + n, acc[i]);
  }
}

// dx for 64 rows (sources m0..m0+63) of a chunk and up to HG_SCAN heads, and the state
// and read-out terms of ddt and dcum, stored: this CTA alone writes them at its rows.
// dlast[m] = dw·w is the term that row m adds to dcum at the chunk's last position,
// which `bwd_dt` sums. grid (⌈L/64⌉, B·nc, ⌈H/HG_SCAN⌉). Below
// the diagonal tile the decay splits at the pivot q, the tile's last row:
// exp(cum_l − cum_m) = exp(cum_l − cum_q)·exp(cum_q − cum_m), both factors at most 1.
template <class E, int NPT>
__global__ void __launch_bounds__(NT) ssd_chunk_bwd_dx(Ops o, const float* dS, E* dx,
                                                        float* dcum, float* ddt,
                                                        float* dlast) {
  extern __shared__ __align__(16) float sm[];
  const int H = o.H, P = o.P, N = o.N, L = o.L;
  const int nLp = (L + 63) / 64 * 64, KN = max(N, 64);
  const int LD1 = NPT * 64 + 4;
  const int R1N = max(64 * LD1, KN * TS);
  float* BsT = sm;             // [N][TS]: BsT[n][i] = B[m0 + i][n]
  float* GB = BsT + N * TS;    // [nLp][TS]: GB[l − m0][i] = G[l][m0 + i]
  float* Wb = GB + nLp * TS;   // [64][TS]: the diagonal tile's weights, Wb[l − m0][m − m0]
  float* R1 = Wb + 64 * TS;    // dy rows [64][LD1], then C rows transposed [N][TS]
  float* R2 = R1 + R1N;        // [KN][TS]: dS or hs transposed
  float* cs = R2 + KN * TS;    // [nLp]
  float* dts = cs + nLp;       // [nLp]
  float* er = dts + nLp;       // [nLp] exp(cum_l − cum_q) below the tile
  float* pw = er + nLp;        // [16][64]: a thread's part of Σ_p x·U for its rows
  float* pz = pw + 16 * 64;    // [16][64]: of Σ_p dy·(C·hsᵀ)
  const int m0 = blockIdx.x * 64;
  const int q = min(m0 + 63, L - 1);
  const int b = blockIdx.y / o.nc, c = blockIdx.y % o.nc;
  const int h0 = blockIdx.z * HG_SCAN, h1 = min(H, h0 + HG_SCAN);
  const long long t0 = (long long)c * L;
  const long long HP = (long long)H * P;
  const E* xg = (const E*)o.x + b * o.xb + t0 * o.xt;
  const E* bg = (const E*)o.bm + b * o.bb + t0 * o.bt;
  const E* cg = (const E*)o.cm + b * o.cb + t0 * o.ct;
  const E* dyg = (const E*)o.dy + ((long long)b * o.T + t0) * HP;
  const int tx = tile_x(), ty = tile_y();

  fill_cols<E>(BsT, TS, N, [&](int i) -> const E* {
    return m0 + i < L ? bg + (m0 + i) * o.bt : nullptr;
  }, one2);
  for (int l0 = m0; l0 < L; l0 += 64) {  // G's band, the diagonal tile included
    fill_cols<E>(R2, TS, N, [&](int j) -> const E* {
      return l0 + j < L ? cg + (l0 + j) * o.ct : nullptr;
    }, one2);
    __syncthreads();
    float g[4][4] = {};
    mm_kk(BsT, TS, R2, TS, N, g);  // g[i][j] = G[l0 + tx·4 + j][m0 + ty·4 + i]
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) GB[(l0 - m0 + tx * 4 + j) * TS + ty * 4 + i] = g[i][j];
    __syncthreads();
  }

  // Each phase's global operand is loaded into registers while the product before it
  // runs: dy's rows at and below the tile, then C's rows and dS, hs, and the next
  // head's dy.
  RowTile<NPT * 64, E> dyr;
  ColTile<128, E> cr;
  ColTile<128, float> sr;
  auto load_dy = [&](int h, int l0) {
    dyr.load(64, P, [&](int k) -> const E* {
      return l0 + k < L ? dyg + (l0 + k) * HP + h * P : nullptr;
    });
  };
  auto load_s = [&](const float* base, int p0) {
    sr.load(N, [&](int j) -> const float* {
      return p0 + j < P ? base + (long long)(p0 + j) * N : nullptr;
    });
  };
  // after the dy rows from l0 on: the next ones, or C's rows and the first dS
  auto load_after = [&](int h, int l0, const float* dSh) {
    if (l0 < L) {
      load_dy(h, l0);
    } else {
      cr.load(N, [&](int i) -> const E* { return m0 + i < L ? cg + (m0 + i) * o.ct : nullptr; });
      load_s(dSh, 0);
    }
  };
  if (h0 < h1) load_dy(h0, m0);
  for (int h = h0; h < h1; ++h) {
    const float* cumh = o.cum + ((long long)b * o.T + t0) * H + h;
    const float* dth = o.dt + ((long long)b * o.T + t0) * H + h;
    const float piv = cumh[(long long)q * H];
    const long long bch = ((long long)b * o.nc + c) * H + h;
    const float* dSh = dS + bch * (long long)P * N;
    const float* hsh = o.hs + bch * (long long)P * N;
    for (int l = threadIdx.x; l < L; l += NT) {
      const float cl = cumh[(long long)l * H];
      cs[l] = cl;
      dts[l] = dth[(long long)l * H];
      er[l] = l > q ? expf(cl - piv) : 0.f;
    }
    __syncthreads();
    const float last = cs[L - 1];
    float adx[NPT][4][4] = {};
    // the diagonal tile, its exponent masked above the diagonal
    fill64(Wb, TS, [&](int k, int i) {
      const int l = m0 + k, m = m0 + i;
      return (m <= l && l < L) ? GB[k * TS + i] * expf(cs[l] - cs[m]) * dts[m] : 0.f;
    });
    dyr.store(R1, LD1, 64, one);
    __syncthreads();
    load_after(h, m0 + 64, dSh);
#pragma unroll
    for (int pt = 0; pt < NPT; ++pt) mm_kk(Wb, TS, R1 + pt * 64, LD1, 64, adx[pt]);
    __syncthreads();
    if (m0 + 64 < L) {  // the tiles below it
      float ao[NPT][4][4] = {};
      for (int l0 = m0 + 64; l0 < L; l0 += 64) {
        dyr.store(R1, LD1, 64, [&](int k) { return er[l0 + k]; });
        __syncthreads();
        load_after(h, l0 + 64, dSh);
#pragma unroll
        for (int pt = 0; pt < NPT; ++pt)
          mm_kk(GB + (l0 - m0) * TS, TS, R1 + pt * 64, LD1, 64, ao[pt]);
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + ty * 4 + i;
        const float f = m < L ? expf(piv - cs[m]) * dts[m] : 0.f;
#pragma unroll
        for (int pt = 0; pt < NPT; ++pt)
#pragma unroll
          for (int j = 0; j < 4; ++j) adx[pt][i][j] = fmaf(f, ao[pt][i][j], adx[pt][i][j]);
      }
    }
    cr.store(R1, TS, N, one2);  // C's rows of the tile, transposed
    float dwp[4] = {}, dzp[4] = {};
#pragma unroll
    for (int pt = 0; pt < NPT; ++pt) {
      const int p0 = pt * 64;
      sr.store(R2, TS, N, one2);  // dS, transposed
      __syncthreads();
      load_s(hsh, p0);
      float u[4][4] = {};
      mm_kk(BsT, TS, R2, TS, N, u);  // U[m][p] = Σ_n B[m][n]·dS[p][n]
      __syncthreads();
      sr.store(R2, TS, N, one2);  // hs, transposed
      __syncthreads();
      if (pt + 1 < NPT) {
        load_s(dSh, p0 + 64);
      } else if (h + 1 < h1) {
        load_dy(h + 1, m0);
      }
      float z[4][4] = {};
      mm_kk(R1, TS, R2, TS, N, z);   // Z[r][p] = Σ_n C[r][n]·hs[p][n]
      __syncthreads();
      const int p = p0 + tx * 4;
      if (p < P) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = m0 + ty * 4 + i;
          if (m >= L) continue;
          const float w = dts[m] * expf(last - cs[m]);
          float xv[8], dv[8], out[4];
          // 8 elements from p & ~7: the thread's 4 are the half at p & 4
          Raw8<E> xr, dr;
          xr.load(xg + m * o.xt + h * P + (p & ~7));
          dr.load(dyg + m * HP + h * P + (p & ~7));
          xr.get(xv);
          dr.get(dv);
          const int o4 = p & 4;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            dwp[i] = fmaf(xv[o4 + j], u[i][j], dwp[i]);
            dzp[i] = fmaf(dv[o4 + j], z[i][j], dzp[i]);
            out[j] = fmaf(w, u[i][j], adx[pt][i][j]);
          }
          st4(dx + ((long long)b * o.T + t0 + m) * HP + h * P + p, out);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      pw[tx * 64 + ty * 4 + i] = dwp[i];
      pz[tx * 64 + ty * 4 + i] = dzp[i];
    }
    __syncthreads();
    if (threadIdx.x < 64) {
      const int m = m0 + threadIdx.x;
      if (m < L) {
        float dw = 0.f, dz = 0.f;
#pragma unroll
        for (int t = 0; t < 16; ++t) {
          dw += pw[t * 64 + threadIdx.x];
          dz += pz[t * 64 + threadIdx.x];
        }
        const float e = expf(last - cs[m]), w = dts[m] * e;
        const long long at = ((long long)b * o.T + t0 + m) * H + h;
        ddt[at] = dw * e;
        dcum[at] = expf(cs[m]) * dz - dw * w;
        dlast[at] = dw * w;
      }
    }
    __syncthreads();
  }
}

// One 64 x 64 tile (rows l, sources m ≤ l, the tile (lt, qd)) of a chunk over up to
// HG_DG heads: dW = dy·xᵀ, the masked product's terms of dcum and ddt, and
// dG = Σ_h dW·decay·dt over the CTA's heads. Each is stored in a slot of its own:
// dcum's terms at a position of tile k in slot j of `dcum_t` (j < k: the row's term from
// the tile (k, j); j > k: the source's from (j, k); j = k: both, from the diagonal tile),
// ddt's at a source of tile k in slot lt ≥ k of `ddt_t`, and dG in `dgw` by (batch,
// chunk), tile and head group. grid (tiles on and below the diagonal, B·nc, ⌈H/HG_DG⌉).
// Below the diagonal the decay splits at the pivot l0.
template <class E>
__global__ void __launch_bounds__(NT, 2) ssd_chunk_bwd_dg(Ops o, float* dcum_t, float* ddt_t,
                                                          float* dgw) {
  extern __shared__ __align__(16) float sm[];
  const int H = o.H, P = o.P, N = o.N, L = o.L;
  const int KM = max(max(N, P), 64);
  float* R1 = sm;               // [KM][TS]
  float* R2 = R1 + KM * TS;     // [KM][TS]
  float* cl = R2 + KM * TS;     // [64] cum at the rows
  float* cmv = cl + 64;         // [64] cum at the sources
  float* dtm = cmv + 64;        // [64] dt at the sources
  float* er = dtm + 64;         // [64] exp(cum_l − cum_l0) (below the diagonal)
  float* ec = er + 64;          // [64] exp(cum_l0 − cum_m) (below the diagonal)
  float* pr = ec + 64;          // [16][64]: a thread's part of the row sums of dW·W
  float* pq = pr + 16 * 64;     // [16][64]: of the column sums of dW·W
  float* pg = pq + 16 * 64;     // [16][64]: of the column sums of dW·G·decay
  int qd = blockIdx.x, lt = 0;
  while (qd > lt) {
    qd -= lt + 1;
    ++lt;
  }
  const bool diag = qd == lt;
  const int l0 = lt * 64, m0 = qd * 64;
  const int b = blockIdx.y / o.nc, c = blockIdx.y % o.nc;
  const int h0 = blockIdx.z * HG_DG, h1 = min(H, h0 + HG_DG);
  const long long t0 = (long long)c * L;
  const long long HP = (long long)H * P;
  const E* xg = (const E*)o.x + b * o.xb + t0 * o.xt;
  const E* bg = (const E*)o.bm + b * o.bb + t0 * o.bt;
  const E* cgm = (const E*)o.cm + b * o.cb + t0 * o.ct;
  const E* dyg = (const E*)o.dy + ((long long)b * o.T + t0) * HP;
  const long long row0 = ((long long)b * o.T + t0) * H;  // (b, t0, 0) in (B, T, H)
  const long long bth = (long long)o.Bn * o.T * H;       // floats a slot
  const int tx = tile_x(), ty = tile_y();

  fill_cols<E>(R1, TS, N, [&](int i) -> const E* {
    return l0 + i < L ? cgm + (l0 + i) * o.ct : nullptr;
  }, one2);
  fill_cols<E>(R2, TS, N, [&](int j) -> const E* {
    return m0 + j < L ? bg + (m0 + j) * o.bt : nullptr;
  }, one2);
  __syncthreads();
  float g[4][4] = {};
  mm_kk(R1, TS, R2, TS, N, g);  // g[i][j] = G[l0 + ty·4 + i][m0 + tx·4 + j]
  __syncthreads();

  float dg[4][4] = {};
  for (int h = h0; h < h1; ++h) {
    if (threadIdx.x < 64) {
      const int t = threadIdx.x, l = l0 + t, m = m0 + t;
      const float piv = o.cum[row0 + (long long)l0 * H + h];
      const float cl_ = l < L ? o.cum[row0 + (long long)l * H + h] : 0.f;
      const float cm_ = m < L ? o.cum[row0 + (long long)m * H + h] : 0.f;
      cl[t] = cl_;
      cmv[t] = cm_;
      dtm[t] = m < L ? o.dt[row0 + (long long)m * H + h] : 0.f;
      if (!diag) {
        er[t] = l < L ? expf(cl_ - piv) : 0.f;
        ec[t] = expf(piv - cm_);
      }
    }
    fill_cols<E>(R1, TS, P, [&](int i) -> const E* {
      return l0 + i < L ? dyg + (l0 + i) * HP + h * P : nullptr;
    }, one2);
    fill_cols<E>(R2, TS, P, [&](int j) -> const E* {
      return m0 + j < L ? xg + (m0 + j) * o.xt + h * P : nullptr;
    }, one2);
    __syncthreads();
    float dw[4][4] = {};
    mm_kk(R1, TS, R2, TS, P, dw);  // dW[l][m] = Σ_p dy[l][p]·x[m][p]
    float rs[4] = {}, sq[4] = {}, sg[4] = {};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = l0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = m0 + tx * 4 + j;
        if (l < L && m <= l) {
          const float dec = diag ? expf(cl[ty * 4 + i] - cmv[tx * 4 + j])
                                 : er[ty * 4 + i] * ec[tx * 4 + j];
          const float gd = g[i][j] * dec, dtv = dtm[tx * 4 + j];
          const float qv = dw[i][j] * gd * dtv;
          rs[i] += qv;
          sq[j] += qv;
          sg[j] = fmaf(dw[i][j], gd, sg[j]);
          dg[i][j] = fmaf(dw[i][j] * dec, dtv, dg[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) pr[tx * 64 + ty * 4 + i] = rs[i];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      pq[ty * 64 + tx * 4 + j] = sq[j];
      pg[ty * 64 + tx * 4 + j] = sg[j];
    }
    __syncthreads();
    if (threadIdx.x < 64) {
      const int t = threadIdx.x, l = l0 + t, m = m0 + t;
      float r = 0.f, cq = 0.f, cgs = 0.f;
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        r += pr[u * 64 + t];
        cq += pq[u * 64 + t];
        cgs += pg[u * 64 + t];
      }
      if (diag) {  // l = m: the row's and the source's terms in the one slot
        if (l < L) dcum_t[lt * bth + row0 + (long long)l * H + h] = r - cq;
      } else {
        if (l < L) dcum_t[qd * bth + row0 + (long long)l * H + h] = r;
        if (m < L) dcum_t[lt * bth + row0 + (long long)m * H + h] = -cq;
      }
      if (m < L) ddt_t[lt * bth + row0 + (long long)m * H + h] = cgs;
    }
    __syncthreads();
  }

  float* dst = dgw + (((long long)blockIdx.y * gridDim.x + blockIdx.x) * gridDim.z + blockIdx.z) * 64 * 64;
#pragma unroll
  for (int i = 0; i < 4; ++i) st4(dst + (ty * 4 + i) * 64 + tx * 4, dg[i]);
}

// dB (which 0) for the sources of tile k, dB += Σ_{lt ≥ k} dG(lt, k)ᵀ·C, or dC (which 1)
// for the rows of tile k, dC += Σ_{qd ≤ k} dG(k, qd)·B, over 64 state channels; each dG
// is `bwd_dg`'s tiles summed over the head groups in order. Adds to `bwd_bc`'s stores.
// grid (⌈L/64⌉·⌈N/64⌉, B·nc, 2)
template <class E>
__global__ void __launch_bounds__(NT, 2) ssd_chunk_bwd_gbc(Ops o, const float* dgw, float* dB,
                                                           float* dC) {
  __shared__ __align__(16) float Gs[64 * TS];  // Gs[l − l0][m − m0] = dG
  __shared__ __align__(16) float Rs[64 * TS];  // C's rows (which 0) or B's (which 1)
  const int L = o.L, N = o.N;
  const int nLt = (L + 63) / 64, nNt = (N + 63) / 64, nG = (o.H + HG_DG - 1) / HG_DG;
  const int k = blockIdx.x / nNt, n0 = (blockIdx.x % nNt) * 64, which = blockIdx.z;
  const int b = blockIdx.y / o.nc, c = blockIdx.y % o.nc;
  const long long t0 = (long long)c * L;
  const E* rows = which == 0 ? (const E*)o.cm + b * o.cb + t0 * o.ct
                             : (const E*)o.bm + b * o.bb + t0 * o.bt;
  const long long rt = which == 0 ? o.ct : o.bt;
  const int wn = min(64, N - n0);
  float acc[4][4] = {};
  const int j0 = which == 0 ? k : 0, j1 = which == 0 ? nLt - 1 : k;
  for (int j = j0; j <= j1; ++j) {
    const int lt = which == 0 ? j : k, qd = which == 0 ? k : j;
    const float* g = dgw + (((long long)blockIdx.y * (nLt * (nLt + 1) / 2) + lt * (lt + 1) / 2 + qd)
                            * nG) * 64 * 64;
    for (int e = threadIdx.x * 4; e < 64 * 64; e += NT * 4) {
      float4 v = *reinterpret_cast<const float4*>(g + e);
      for (int gi = 1; gi < nG; ++gi) {
        const float4 u = *reinterpret_cast<const float4*>(g + (long long)gi * 64 * 64 + e);
        v.x += u.x; v.y += u.y; v.z += u.z; v.w += u.w;
      }
      *reinterpret_cast<float4*>(Gs + (e >> 6) * TS + (e & 63)) = v;
    }
    const int r0 = (which == 0 ? lt : qd) * 64;
    fill_rows<64, E>(Rs, TS, 64, wn, [&](int kk) -> const E* {
      return r0 + kk < L ? rows + (r0 + kk) * rt + n0 : nullptr;
    }, one);
    __syncthreads();
    if (which == 0) {
      mm_kk(Gs, TS, Rs, TS, 64, acc);  // dB[m][n] += Σ_l dG[l][m]·C[l][n]
    } else {
      mm_ik(Gs, TS, Rs, TS, 64, acc);  // dC[l][n] += Σ_m dG[l][m]·B[m][n]
    }
    __syncthreads();
  }
  const int tx = tile_x(), ty = tile_y();
  float* out = (which == 0 ? dB : dC) + ((long long)b * o.T + t0) * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k * 64 + ty * 4 + i, n = n0 + tx * 4;
    if (r < L && n < N) {
      float4* p = reinterpret_cast<float4*>(out + (long long)r * N + n);
      float4 v = *p;
      v.x += acc[i][0]; v.y += acc[i][1]; v.z += acc[i][2]; v.w += acc[i][3];
      *p = v;
    }
  }
}

// da = the reversed running sum of dcum over a chunk, where dcum at a position is the
// sum of `bwd_dx`'s term and `bwd_dg`'s slots, and the chunk's last position also
// gathers every row's dlast and the chunk decay's gradient (the sum of `pass_bwd`'s
// parts) times the decay; ddt = `bwd_dx`'s term + `bwd_dg`'s slots + A·da, and
// dAp[(b, c, h)] = Σ dt·da. One warp a (b, c, h): lane i takes the positions
// [i·K, i·K + K), K = ⌈L/32⌉ ≤ 8, and the lanes' sums combine by shuffles in a fixed order.
__global__ void __launch_bounds__(NT) ssd_chunk_bwd_dt(Ops o, const float* dcum,
                                                        const float* dlast, const float* dcum_t,
                                                        const float* ddt_t, const float* dcdp,
                                                        int nbx, float* ddt, float* dAp) {
  const int w = (blockIdx.x * NT + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (w >= o.Bn * o.nc * o.H) return;  // whole warps: NT is a multiple of 32
  const int h = w % o.H, bc = w / o.H, c = bc % o.nc, b = bc / o.nc;
  const long long base = ((long long)b * o.T + (long long)c * o.L) * o.H + h;
  const long long bth = (long long)o.Bn * o.T * o.H;
  const int nLt = (o.L + 63) / 64, K = (o.L + 31) / 32, l0 = lane * K;
  float dc[8], sc = 0.f, st = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int l = l0 + i;
    dc[i] = 0.f;
    if (i < K && l < o.L) {
      const long long at = base + (long long)l * o.H;
      float v = dcum[at];
      for (int j = 0; j < nLt; ++j) v += dcum_t[j * bth + at];
      dc[i] = v;
      sc += v;
      st += dlast[at];
    }
  }
  float part = 0.f;
  for (int j = lane; j < nbx; j += 32) part += dcdp[(long long)w * nbx + j];
  // the sum of sc over the lanes above this one: an inclusive suffix sum, shifted
  float suf = sc;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float v = __shfl_down_sync(0xffffffffu, suf, d);
    if (lane + d < 32) suf += v;
  }
  float above = __shfl_down_sync(0xffffffffu, suf, 1);
  if (lane == 31) above = 0.f;
  float s = fmaf(warp_sum(part), o.cd[w], warp_sum(st)) + above;
  const float a = o.A[h];
  float acc = 0.f;
#pragma unroll
  for (int i = 7; i >= 0; --i) {
    const int l = l0 + i;
    if (i < K && l < o.L) {
      const long long at = base + (long long)l * o.H;
      s += dc[i];
      float dd = ddt[at];
      for (int j = l >> 6; j < nLt; ++j) dd += ddt_t[j * bth + at];
      ddt[at] = fmaf(a, s, dd);
      acc = fmaf(o.dt[at], s, acc);
    }
  }
  acc = warp_sum(acc);
  if (lane == 0) dAp[w] = acc;
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
template <class... KA, class... Args>
int launch(void (*k)(KA...), dim3 grid, size_t smem, cudaStream_t s, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  k<<<grid, NT, smem, s>>>(args...);
  return (int)cudaGetLastError();
}

size_t scan_smem(const Ops& o) {
  const int nLp = (o.L + 63) / 64 * 64, KN = o.N > 64 ? o.N : 64;
  return sizeof(float) * ((size_t)(o.N + KN + nLp + 64) * TS + 2 * nLp + 64);
}

size_t dx_smem(const Ops& o, int npt) {
  const int nLp = (o.L + 63) / 64 * 64, KN = o.N > 64 ? o.N : 64;
  const int r1 = 64 * (npt * 64 + 4) > KN * TS ? 64 * (npt * 64 + 4) : KN * TS;
  return sizeof(float) * ((size_t)(o.N + nLp + 64 + KN) * TS + r1 + 3 * nLp + 2 * 16 * 64);
}

size_t dg_smem(const Ops& o) {
  int km = o.N > o.P ? o.N : o.P;
  km = km > 64 ? km : 64;
  return sizeof(float) * ((size_t)2 * km * TS + 5 * 64 + 3 * 16 * 64);
}

Ops make_ops(const void* x, long long xb, long long xt, const void* bm, long long bb,
             long long bt, const void* cm, long long cb, long long ct, const float* dt,
             const float* A, float* cum, float* cd, float* hs, int Bn, int T, int H, int P,
             int N, int L) {
  Ops o;
  o.x = x; o.xb = xb; o.xt = xt;
  o.bm = bm; o.bb = bb; o.bt = bt;
  o.cm = cm; o.cb = cb; o.ct = ct;
  o.dy = nullptr; o.dt = dt; o.A = A;
  o.cum = cum; o.cd = cd; o.hs = hs;
  o.Bn = Bn; o.T = T; o.H = H; o.P = P; o.N = N; o.L = L; o.nc = T / L;
  return o;
}

bool shapes_ok(const Ops& o) {
  auto pow2_16_128 = [](int v) { return v == 16 || v == 32 || v == 64 || v == 128; };
  return pow2_16_128(o.P) && pow2_16_128(o.N) && o.L >= 1 && o.L <= 256 && o.T % o.L == 0 &&
         o.H >= 1 && o.Bn >= 1 && (long long)o.Bn * o.nc <= 65535 && o.H <= 65535;
}

template <class E>
int fwd(const Ops& o, E* y, float* hfin, cudaStream_t s) {
  const int bch = o.Bn * o.nc * o.H;
  const int pn = o.P * o.N;
  int rc;
  if ((rc = launch(ssd_chunk_cumsum, dim3((bch + NT - 1) / NT), 0, s, o))) return rc;
  const dim3 gs(((o.P + 63) / 64) * ((o.N + 63) / 64), o.Bn * o.nc, o.H);
  if ((rc = launch(ssd_chunk_state<E, 0>, gs, 0, s, o, o.hs))) return rc;
  if ((rc = launch(ssd_chunk_pass, dim3((pn + NT - 1) / NT, o.Bn * o.H), 0, s, o, hfin)))
    return rc;
  const dim3 gy((o.L + 63) / 64, o.Bn * o.nc, (o.H + HG_SCAN - 1) / HG_SCAN);
  return launch(ssd_chunk_scan<E>, gy, scan_smem(o), s, o, y);
}

// The backward's workspace, in floats, each part a multiple of 4 (16 bytes): dcum and
// dlast (B·T·H each), `bwd_dg`'s slots of dcum and of ddt (⌈L/64⌉·B·T·H each),
// `pass_bwd`'s parts of d(cd) (B·nc·H·⌈P·N/256⌉) and the dG tiles (B·nc, the tiles on and
// below the diagonal, the head groups; 64·64 each). `kernels/ssd.py::ws_floats` sizes it
// the same way; the backward refuses a smaller one.
struct Work {
  long long bth, nlt, nbx, slots, parts, tiles;
  explicit Work(const Ops& o)
      : bth(((long long)o.Bn * o.T * o.H + 3) / 4 * 4),
        nlt((o.L + 63) / 64),
        nbx((o.P * o.N + NT - 1) / NT),
        slots(nlt * bth),
        parts(((long long)o.Bn * o.nc * o.H * nbx + 3) / 4 * 4),
        tiles((long long)o.Bn * o.nc * (nlt * (nlt + 1) / 2) * ((o.H + HG_DG - 1) / HG_DG) * 64 *
              64) {}
  long long floats() const { return 2 * bth + 2 * slots + parts + tiles; }
};

template <class E>
int bwd(const Ops& o, const float* dhf, E* dx, float* dS, float* ws, float* dB, float* dC,
        float* ddt, float* dAp, cudaStream_t s) {
  const Work w(o);
  float* dcum = ws;
  float* dlast = dcum + w.bth;
  float* dcum_t = dlast + w.bth;
  float* ddt_t = dcum_t + w.slots;
  float* dcdp = ddt_t + w.slots;
  float* dgw = dcdp + w.parts;
  const int bch = o.Bn * o.nc * o.H, nLt = (int)w.nlt;
  int rc;
  const dim3 gs(((o.P + 63) / 64) * ((o.N + 63) / 64), o.Bn * o.nc, o.H);
  if ((rc = launch(ssd_chunk_state<E, 1>, gs, 0, s, o, dS))) return rc;
  if ((rc = launch(ssd_chunk_pass_bwd, dim3((int)w.nbx, o.Bn * o.H), 0, s, o, dhf, dS, dcdp)))
    return rc;
  const dim3 gb(nLt * ((o.N + 63) / 64), o.Bn * o.nc, 2);
  if ((rc = launch(ssd_chunk_bwd_bc<E>, gb, 0, s, o, (const float*)dS, dB, dC))) return rc;
  const dim3 gx(nLt, o.Bn * o.nc, (o.H + HG_SCAN - 1) / HG_SCAN);
  if (o.P > 64) {
    if ((rc = launch(ssd_chunk_bwd_dx<E, 2>, gx, dx_smem(o, 2), s, o, (const float*)dS, dx, dcum,
                     ddt, dlast)))
      return rc;
  } else if ((rc = launch(ssd_chunk_bwd_dx<E, 1>, gx, dx_smem(o, 1), s, o, (const float*)dS, dx,
                          dcum, ddt, dlast))) {
    return rc;
  }
  const dim3 gg(nLt * (nLt + 1) / 2, o.Bn * o.nc, (o.H + HG_DG - 1) / HG_DG);
  if ((rc = launch(ssd_chunk_bwd_dg<E>, gg, dg_smem(o), s, o, dcum_t, ddt_t, dgw))) return rc;
  if ((rc = launch(ssd_chunk_bwd_gbc<E>, gb, 0, s, o, (const float*)dgw, dB, dC))) return rc;
  return launch(ssd_chunk_bwd_dt, dim3((bch * 32 + NT - 1) / NT), 0, s, o, (const float*)dcum,
                (const float*)dlast, (const float*)dcum_t, (const float*)ddt_t,
                (const float*)dcdp, (int)w.nbx, ddt, dAp);
}

}  // namespace

// The forward: y (B, T, H·P) in x's type, without the skip; hfin (B, H, P, N) the
// final state; cum (B, T, H), cd (B, nc, H) and hs (B, nc, H, P, N), the states
// entering each chunk, kept for the backward. x, B, C and y are bfloat16 (`_bf16`) or
// float (`_f32`). Returns 0 or the CUDA error of the first launch that failed (-1:
// shapes the kernels do not take).
#define SSD_FWD(NAME, E)                                                                   \
  extern "C" int NAME(const void* x, long long xb, long long xt, const void* bm,          \
                      long long bb, long long bt, const void* cm, long long cb, long long ct, \
                      const float* dt, const float* A, float* cum, float* cd, float* hs,   \
                      float* hfin, void* y, int Bn, int T, int H, int P, int N, int L,     \
                      void* stream) {                                                      \
    const Ops o = make_ops(x, xb, xt, bm, bb, bt, cm, cb, ct, dt, A, cum, cd, hs, Bn, T, H, \
                           P, N, L);                                                       \
    if (!shapes_ok(o)) return -1;                                                          \
    return fwd(o, (E*)y, hfin, (cudaStream_t)stream);                                      \
  }
SSD_FWD(ssd_chunked_fwd_bf16, __nv_bfloat16)
SSD_FWD(ssd_chunked_fwd_f32, float)

// The backward from dy (B, T, H·P) in x's type, contiguous, and dhf (B, H, P, N) float32
// (null: no gradient reached the final state). Writes dx (B, T, H·P) in x's type, dB
// and dC (B, T, N) float32, ddt (B, T, H) float32 and dAp (B, nc, H) float32, whose sum
// over (B, nc) is dA. dS (B, nc, H, P, N) float32 and `ws` (`ws_floats` floats, at least
// `Work`'s; -2 if fewer) are scratch; nothing needs zeroing.
#define SSD_BWD(NAME, E)                                                                   \
  extern "C" int NAME(const void* x, long long xb, long long xt, const void* bm,          \
                      long long bb, long long bt, const void* cm, long long cb, long long ct, \
                      const float* dt, const float* A, float* cum, float* cd, float* hs,   \
                      const void* dy, const float* dhf, void* dx, float* dS, float* ws,    \
                      long long ws_floats, float* dB, float* dC, float* ddt, float* dAp,   \
                      int Bn, int T, int H, int P, int N, int L, void* stream) {           \
    Ops o = make_ops(x, xb, xt, bm, bb, bt, cm, cb, ct, dt, A, cum, cd, hs, Bn, T, H, P, N, \
                     L);                                                                   \
    if (!shapes_ok(o)) return -1;                                                          \
    if (ws_floats < Work(o).floats()) return -2;                                           \
    o.dy = dy;                                                                             \
    return bwd(o, dhf, (E*)dx, dS, ws, dB, dC, ddt, dAp, (cudaStream_t)stream);            \
  }
SSD_BWD(ssd_chunked_bwd_bf16, __nv_bfloat16)
SSD_BWD(ssd_chunked_bwd_f32, float)
