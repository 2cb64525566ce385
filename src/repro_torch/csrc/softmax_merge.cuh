// The merge of partial online-softmax results across the CTAs of a thread
// block cluster, shared by paged_attention.cu (B3) and flash_attention.cu
// (B4), and the cp.async helpers both kernels stage their tiles with.
//
// CTA i of a cluster of c holds, for the same `rows` output rows, a partial
// (m_i, l_i, acc_i) over a key range disjoint from its peers': the running
// max of the scores, the sum of exp(s - m_i), and the sum of
// exp(s - m_i) * v over its keys. The merge computes
//     M   = max_i m_i
//     l   = sum_i exp(m_i - M) * l_i
//     acc = sum_i exp(m_i - M) * acc_i
//     out = acc / max(l, 1e-20)
// An empty range contributes m = -1e30, l = 0, acc = 0, so the merge never
// computes -inf - (-inf), and a row whose ranges are all empty gives 0.
//
// Each CTA leaves its partial in its own shared memory and the cluster
// syncs; CTA r then merges its 1/c slice of the D columns of every row,
// reading its peers' partials through distributed shared memory
// (cluster.map_shared_rank), writes that slice of the output, and syncs
// again so that no CTA leaves while a peer still reads its partial. No
// workspace in device memory, no second launch. With c = 1 the merge is
// acc / max(l, 1e-20).

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace softmax_merge {

namespace cg = cooperative_groups;

constexpr int kMaxCluster = 8;  // the portable cluster size limit
constexpr float kEmptyM = -1e30f;

// Write n (1 or 4) consecutive outputs from f32, rounding once.
__device__ __forceinline__ void store_n(float* p, const float* x, int n) {
  if (n == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    for (int j = 0; j < n; ++j) p[j] = x[j];
  }
}
__device__ __forceinline__ void store_n(__nv_bfloat16* p, const float* x,
                                        int n) {
  if (n == 4) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(x[2], x[3]);
    *reinterpret_cast<uint2*>(p) =
        make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                   *reinterpret_cast<const unsigned*>(&hi));
  } else {
    for (int j = 0; j < n; ++j) p[j] = __float2bfloat16_rn(x[j]);
  }
}

// Merge V columns at a time (V = 4: 16-byte reads of the peers' partials).
// Every peer's read is issued before the sums, so the distributed shared
// memory latency is paid once per group, not once per peer.
template <int V, int kThreads, typename Store>
__device__ __forceinline__ void merge_columns(float* const* peer,
                                              const float* w, int c,
                                              int rows, int cols, int col0,
                                              int stride, Store& store) {
  constexpr int kW = kMaxCluster + 1;
  const int per_row = cols / V;
  for (int e = threadIdx.x; e < rows * per_row; e += kThreads) {
    const int row = e / per_row, col = col0 + (e - row * per_row) * V;
    float x[kMaxCluster][V];
#pragma unroll
    for (int i = 0; i < kMaxCluster; ++i) {
      if (i < c) {
        const float* src = peer[i] + row * stride + col;
        if constexpr (V == 4) {
          const float4 f = *reinterpret_cast<const float4*>(src);
          x[i][0] = f.x; x[i][1] = f.y; x[i][2] = f.z; x[i][3] = f.w;
        } else {
          x[i][0] = src[0];
        }
      }
    }
    float a[V];
#pragma unroll
    for (int j = 0; j < V; ++j) a[j] = 0.0f;
#pragma unroll
    for (int i = 0; i < kMaxCluster; ++i) {
      if (i < c) {
        const float wi = w[row * kW + i];
#pragma unroll
        for (int j = 0; j < V; ++j) a[j] = fmaf(wi, x[i][j], a[j]);
      }
    }
    const float den = w[row * kW + kMaxCluster];
#pragma unroll
    for (int j = 0; j < V; ++j) a[j] = a[j] / den;
    store(row, col, a, V);
  }
}

// m, l: `rows` floats; acc: row r's D columns at acc + r * stride (a
// multiple of 4); all in this CTA's shared memory. w: rows * (kMaxCluster
// + 1) floats of scratch in shared memory. store(row, col, x, n) writes the
// n outputs x[0..n) of row `row` from column `col` on.
template <int kThreads, typename Store>
__device__ __forceinline__ void cluster_merge(float* m, float* l,
                                              float* acc, int rows, int D,
                                              int stride, float* w,
                                              Store store) {
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.num_blocks());
  const int r = static_cast<int>(cluster.block_rank());
  constexpr int kW = kMaxCluster + 1;
  cluster.sync();  // every CTA's partial is in its shared memory
  float* pm[kMaxCluster];
  float* pl[kMaxCluster];
  float* pa[kMaxCluster];
#pragma unroll
  for (int i = 0; i < kMaxCluster; ++i) {
    pm[i] = pl[i] = pa[i] = nullptr;
    if (i < c) {
      pm[i] = cluster.map_shared_rank(m, i);
      pl[i] = cluster.map_shared_rank(l, i);
      pa[i] = cluster.map_shared_rank(acc, i);
    }
  }
  for (int row = threadIdx.x; row < rows; row += kThreads) {
    float mi[kMaxCluster], li[kMaxCluster];
    float M = kEmptyM;
#pragma unroll
    for (int i = 0; i < kMaxCluster; ++i) {
      if (i < c) {
        mi[i] = pm[i][row];
        li[i] = pl[i][row];
      }
    }
#pragma unroll
    for (int i = 0; i < kMaxCluster; ++i)
      if (i < c) M = fmaxf(M, mi[i]);
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < kMaxCluster; ++i) {
      if (i < c) {
        const float a = expf(mi[i] - M);
        w[row * kW + i] = a;
        sum = fmaf(a, li[i], sum);
      }
    }
    w[row * kW + kMaxCluster] = fmaxf(sum, 1e-20f);
  }
  __syncthreads();
  const int cols = D / c, col0 = r * cols;
  if (cols % 4 == 0)
    merge_columns<4, kThreads>(pa, w, c, rows, cols, col0, stride, store);
  else
    merge_columns<1, kThreads>(pa, w, c, rows, cols, col0, stride, store);
  cluster.sync();  // the peers have read this CTA's partial
}

// 16-byte asynchronous copies from device to shared memory (sm_80+).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// As cp_async16, but fills the 16 bytes with zeros when `valid` is false
// (src must still be a valid address).
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Launch `kernel` on `grid` in clusters of c CTAs along x (gridDim.x a
// multiple of c, c <= kMaxCluster). Returns the launch's error, or
// cudaGetLastError() after it: 0 when the kernel was accepted.
template <typename... Params, typename... Args>
inline int launch_cluster(void (*kernel)(Params...), dim3 grid, int threads,
                          size_t smem, cudaStream_t stream, int c,
                          Args... args) {
  if (c < 1 || c > kMaxCluster || grid.x % c)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace softmax_merge
