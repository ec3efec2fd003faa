// The ring-product tile loop shared by ring_matmul.cu (B5, 32-bit words on
// both sides) and binary_matmul.cu's bin_weight_matmul (B6, int8 weights):
// C = A · B mod 2^32, A (M, K) 32-bit words, B (K, N) of element type WT.
//
// A 32-bit IMAD product wraps mod 2^32, so the words are multiplied
// directly and accumulated in uint32_t, whose wrap is the ring arithmetic.
// An int8 weight is sign-extended on load (the bits of the reference's
// int8 -> uint32 cast), which is exact for any int8 weight.
//
// Layout: one block per (64-row, 64-col) output tile, as in rss_matmul.cu,
// and per product of a batch along grid z (B5's batched entry: the z-th
// product reads a + z·M·K and b + z·K·N and writes c + z·M·N; a 2-D launch
// has one z).
// A K loop stages 16-deep slabs of A and B in shared memory; each of the
// 256 threads owns a 4 x 4 block of outputs, strided by 16 so shared-memory
// reads are conflict-free.  Ragged M/K/N edges are masked in the loads and
// the stores: no padding and no small-shape fallback, every shape launches
// the kernel.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ring_tile {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;   // outputs per thread along M (stride 16)
constexpr int TN = 4;   // outputs per thread along N (stride 16)
constexpr int THREADS = 256;

__device__ __forceinline__ uint32_t widen(uint32_t v) { return v; }
__device__ __forceinline__ uint32_t widen(int8_t v) {
  return (uint32_t)(int32_t)v;
}

template <typename WT>
__global__ void __launch_bounds__(THREADS)
ring_tile_kernel(const uint32_t* __restrict__ a,
                 const WT* __restrict__ b,
                 uint32_t* __restrict__ c,
                 long long M, int K, int N) {
  // +1 column: the transposed A stores hit distinct banks
  __shared__ uint32_t as[BK][BM + 1];
  __shared__ uint32_t bs[BK][BN];

  const long long bz = blockIdx.z;
  a += bz * M * K;
  b += bz * K * N;
  c += bz * M * N;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  uint32_t acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0u;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A slab: BM x BK, k fastest across threads (coalesced rows)
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK;
      const int col = e % BK;
      const long long gm = m0 + r;
      const int gk = k0 + col;
      as[col][r] = (gm < M && gk < K) ? a[gm * K + gk] : 0u;
    }
    // B slab: BK x BN, n fastest across threads
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int r = e / BN;
      const int col = e % BN;
      const int gk = k0 + r;
      const int gn = n0 + col;
      bs[r][col] = (gk < K && gn < N) ? widen(b[(long long)gk * N + gn]) : 0u;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      uint32_t x[TM], y[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) x[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) y[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += x[i] * y[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N) c[gm * N + gn] = acc[i][j];
    }
  }
}

inline dim3 tile_grid(long long M, int N, int batch = 1) {
  return dim3((unsigned)((M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN),
              (unsigned)batch);
}

}  // namespace ring_tile
