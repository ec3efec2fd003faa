// Binarized products (Hopper, sm_90a): two entry points.
//
// bin_weight_matmul replaces the TPU kernel
// repro/kernels/binary_matmul.py::_bin_matmul_kernel (pallas_call in
// _binary_weight_matmul_jit):  C = A · W mod 2^32, A (M, K) ring words, W
// (K, N) int8 (±1 or {0, 1} in the reference's use).  The TPU kernel split
// A into 4 balanced int8 limbs for 4 int8 MXU dots.  Here each word is
// multiplied by the sign-extended weight with IMAD and accumulated in
// uint32_t, whose wrap is the ring arithmetic: exact for any int8 weight.
//
// bin_bin_matmul replaces _bb_kernel (pallas_call in binary_binary_matmul):
// the plaintext BNN layer, int8 A (M, K) times int8 W (K, N) into int32.
// K is packed 4 bytes to a word and contracted with __dp4a (four signed
// byte products and their sum per instruction), accumulating in int32 with
// wraparound, as the reference's int32 accumulator does.
//
// Layout: bin_weight_matmul is ring_tile.cuh's tile loop (shared with
// ring_matmul.cu) on int8 weights.  bin_bin_matmul has the same tiling: one
// block per (64-row, 64-col) output tile, 256 threads owning 4 x 4 outputs
// each, strided by 16 so shared-memory reads are conflict-free, a K loop
// staging slabs of both operands in shared memory.  Ragged M/K/N edges are
// masked in the loads (zero bytes) and the stores: no padding, every shape
// launches the kernel.
//
// What bounds them: at the classifier's shapes, bytes (each input read once,
// the output written once, over 3.35 TB/s) or, for the deepest fc layer,
// the int8 operation count the TPU route needs (4 dots a cell for
// bin_weight_matmul, 1 for bin_bin_matmul).  CUDA-core issue limits these
// first versions; the int8 tensor cores (wgmma .s8) are the redesign.

#include "ring_tile.cuh"

namespace {

using ring_tile::BM;
using ring_tile::BN;
using ring_tile::TM;
using ring_tile::TN;
using ring_tile::THREADS;
using ring_tile::tile_grid;

// ---------------------------------------------------------------------------
// int8 x int8 -> int32 with __dp4a over 4-packed K
// ---------------------------------------------------------------------------

constexpr int BK_B = 64;          // K per slab
constexpr int GK = BK_B / 4;      // packed words per slab row

__device__ __forceinline__ uint32_t pack_byte(int8_t v, int t) {
  return (uint32_t)(uint8_t)v << (8 * t);
}

__global__ void __launch_bounds__(THREADS)
bin_bin_matmul_kernel(const int8_t* __restrict__ a,
                      const int8_t* __restrict__ w,
                      int32_t* __restrict__ c,
                      long long M, int K, int N) {
  __shared__ int32_t as[GK][BM + 1];   // 4 consecutive k of one row
  __shared__ int32_t ws[GK][BN];       // 4 consecutive k of one column

  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  int32_t acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += BK_B) {
    for (int e = tid; e < BM * GK; e += THREADS) {
      const int r = e / GK;
      const int g = e % GK;
      const long long gm = m0 + r;
      uint32_t word = 0u;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int gk = k0 + 4 * g + t;
        if (gm < M && gk < K) word |= pack_byte(a[gm * K + gk], t);
      }
      as[g][r] = (int32_t)word;
    }
    for (int e = tid; e < GK * BN; e += THREADS) {
      const int g = e / BN;
      const int col = e % BN;
      const int gn = n0 + col;
      uint32_t word = 0u;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int gk = k0 + 4 * g + t;
        if (gk < K && gn < N)
          word |= pack_byte(w[(long long)gk * N + gn], t);
      }
      ws[g][col] = (int32_t)word;
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < GK; ++g) {
      int32_t x[TM], y[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) x[i] = as[g][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) y[j] = ws[g][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = __dp4a(x[i], y[j], acc[i][j]);
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

}  // namespace

// a: (M, K) 32-bit words, w: (K, N) int8, c: (M, N) 32-bit words.
extern "C" int bin_weight_matmul_launch(const void* a, const void* w, void* c,
                                        long long M, int K, int N,
                                        void* stream) {
  ring_tile::ring_tile_kernel<int8_t>
      <<<tile_grid(M, N), THREADS, 0, (cudaStream_t)stream>>>(
          (const uint32_t*)a, (const int8_t*)w, (uint32_t*)c, M, K, N);
  return (int)cudaGetLastError();
}

// a: (M, K) int8, w: (K, N) int8, c: (M, N) int32.
extern "C" int bin_bin_matmul_launch(const void* a, const void* w, void* c,
                                     long long M, int K, int N,
                                     void* stream) {
  bin_bin_matmul_kernel<<<tile_grid(M, N), THREADS, 0,
                          (cudaStream_t)stream>>>(
      (const int8_t*)a, (const int8_t*)w, (int32_t*)c, M, K, N);
  return (int)cudaGetLastError();
}
