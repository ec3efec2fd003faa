// Row helpers of the grouped (depthwise) kernels: B2
// (grouped_rss_matmul.cu, the shared-weight product and its pair entry)
// and B4 (bin_grouped_matmul.cu, the public-weight product).
//
// Both multiply an (S, C, M, K) stack of patch rows, read through its
// element strides, by per-channel (K, N) slabs, K = kh·kw <= 25 and N = 1
// in the nets.  A thread owns one "row": V neighbouring channels of one
// output position m, all K words of each.  Where the channel axis is the
// contiguous one (the im2col (S, M, K, C) buffer viewed as (S, C, M, K))
// and C, the strides and the base are multiples of V words, a row's K
// loads are V-word vector loads (16 bytes at V = 4, 8 at V = 2) and its
// output one V-word store; otherwise V = 1 and neighbouring threads take
// neighbouring channels (or rows, in the (S, C, M, K) layout), so loads
// coalesce either way.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace grouped_rows {

constexpr size_t SMEM_DEFAULT = 48 * 1024;

// V lanes of consecutive words
template <int V>
__device__ __forceinline__ void load_global(uint32_t (&r)[V],
                                            const uint32_t* p) {
  if constexpr (V == 4) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    r[0] = q.x; r[1] = q.y; r[2] = q.z; r[3] = q.w;
  } else if constexpr (V == 2) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    r[0] = q.x; r[1] = q.y;
  } else {
    r[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void load_shared(uint32_t (&r)[V],
                                            const uint32_t* p) {
  if constexpr (V == 4) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    r[0] = q.x; r[1] = q.y; r[2] = q.z; r[3] = q.w;
  } else if constexpr (V == 2) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    r[0] = q.x; r[1] = q.y;
  } else {
    r[0] = *p;
  }
}

// a row's V output words: one vector store where ``vec`` (channel stride
// 1, aligned), else one word a channel ``szc`` apart
template <int V>
__device__ __forceinline__ void store_row(uint32_t* p,
                                          const uint32_t (&r)[V], bool vec,
                                          long long szc) {
  if constexpr (V == 4) {
    if (vec) {
      *reinterpret_cast<uint4*>(p) = make_uint4(r[0], r[1], r[2], r[3]);
      return;
    }
  } else if constexpr (V == 2) {
    if (vec) {
      *reinterpret_cast<uint2*>(p) = make_uint2(r[0], r[1]);
      return;
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) p[v * szc] = r[v];
}

// the first channel c and the position m of row t, ``groups`` rows of V
// channels a position: channel groups fastest in the channel-contiguous
// layout, positions fastest otherwise
template <int V>
__device__ __forceinline__ void locate(long long t, int groups, long long M,
                                       bool c_fast, int& c, long long& m) {
  if (c_fast) {
    c = (int)(t % groups) * V;
    m = t / groups;
  } else {
    m = t % M;
    c = (int)(t / M) * V;
  }
}

__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Host side.

// Whether V-word loads hold for x (and its neighbour stack xn, if any):
// channels contiguous, C, the other strides and the bases multiples of V.
inline bool vec_x(int V, bool c_fast, int C, long long sxs, long long sxc,
                  long long sxm, long long sxk, const void* x,
                  const void* xn = nullptr) {
  const uintptr_t b = 4u * V;
  return c_fast && sxc == 1 && C % V == 0 && sxs % V == 0 && sxm % V == 0
      && sxk % V == 0 && (uintptr_t)x % b == 0
      && (xn == nullptr || (uintptr_t)xn % b == 0);
}

// Whether a row's V output words take one V-word store (N = 1 or the n
// stride a multiple of V).
inline bool vec_z(int V, int N, long long szs, long long szc, long long szm,
                  long long szn, const void* z) {
  return szc == 1 && szs % V == 0 && szm % V == 0 && (N == 1 || szn % V == 0)
      && (uintptr_t)z % (4u * V) == 0;
}

// Launch ``kernel`` over ``rows`` rows, ``threads`` a block, with
// ``grid_y`` rows of blocks.  Blocks are capped at ``per_sm`` an SM
// (0: as many as are resident at once, so every thread strides over the
// rows and keeps its next row in flight); past the cap the blocks stride
// over the rows.  Opts in to more than 48 KB of shared memory where
// ``smem`` asks for it.
template <typename Args>
int launch(void (*kernel)(const Args), const Args& a, long long rows,
           int threads, int per_sm, unsigned grid_y, size_t smem,
           cudaStream_t st) {
  if (smem > SMEM_DEFAULT) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (per_sm == 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, threads, smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) per_sm = 1;
  }
  long long cap = (long long)per_sm * sms / grid_y;
  if (cap < 1) cap = 1;
  long long blocks = (rows + threads - 1) / threads;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  void* args[] = {(void*)&a};
  return (int)cudaLaunchKernel((const void*)kernel,
                               dim3((unsigned)blocks, grid_y), dim3(threads),
                               args, smem, st);
}

}  // namespace grouped_rows
