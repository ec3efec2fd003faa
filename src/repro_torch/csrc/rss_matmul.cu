// Fused 3-party RSS matmul, all parties in one launch (Hopper, sm_90a).
//
// Replaces the TPU kernel repro/kernels/rss_matmul.py::_rss_matmul_kernel
// (pallas_call in _rss_matmul_call).  For every party p it computes the
// fused-operand Alg-2 additive product
//
//     z_p = x_p · wf_p + x_{(p+1) % S} · ws_p      (mod 2^32)
//
// with wf_p = w_p + w_{p+1} cached at model setup.  Two routes, chosen by
// shape in the wrapper (kernels/limbs.py::limb_mma_plan), never as a
// fallback:
//
//  * tensor cores (K > 16): limb_mma.cuh with two operands, the K-major
//    int8 limbs of wf_p and ws_p (WeightLimbs.wt).  Each of the 10 limb
//    pairs with p + q <= 3 is a wgmma m64n64k32 u8 x s8, 20 a k32 step
//    and 64 x 64 tile, added per shift into four int32 accumulator sets;
//    split-K by int32 atomics where the (party, m, n) tiles leave SMs idle
//    (the M = 32 fc layers) or fill a last wave poorly.  The parties of a
//    tile are adjacent in the grid, so x_{p+1} is mostly an L2 hit.
//  * CUDA cores (K <= 16, where a k32 step would be mostly padding): the
//    32-bit shares multiplied with IMAD and accumulated in uint32_t, whose
//    wrap is the ring arithmetic.  One block per (64-row, 64-col) output
//    tile of one party; a K loop stages 16-deep tiles of x_p, x_{p+1}, wf_p
//    and ws_p in shared memory; each of the 256 threads owns a 4 x 4 block
//    of outputs, strided by 16 so shared-memory reads are conflict-free.
//
// Ragged M/K/N edges are masked (the limb cache is padded instead): every
// shape the secure path produces (pointwise K = 3, fc N = 10) launches.
//
// What bounds it: at the conv shapes of the deep nets, the int8 operations
// (40·S·M·K·N at 1,979 TOP/s) about as much as the bytes of x; at M = 32,
// the bytes of the weight limbs (2·S·K·N words' worth) over 3.35 TB/s.

#include "limb_mma.cuh"

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;   // outputs per thread along M (stride 16)
constexpr int TN = 4;   // outputs per thread along N (stride 16)
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
rss_matmul_kernel(const uint32_t* __restrict__ x,
                  const uint32_t* __restrict__ wf,
                  const uint32_t* __restrict__ ws,
                  uint32_t* __restrict__ z,
                  int S, long long M, int K, int N) {
  // +1 column: the transposed x stores hit distinct banks
  __shared__ uint32_t xs[BK][BM + 1];
  __shared__ uint32_t xns[BK][BM + 1];
  __shared__ uint32_t wfs[BK][BN];
  __shared__ uint32_t wss[BK][BN];

  const int p = blockIdx.z;
  const int pn = (p + 1) % S;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  const uint32_t* xp = x + (long long)p * M * K;
  const uint32_t* xnp = x + (long long)pn * M * K;
  const uint32_t* wfp = wf + (long long)p * K * N;
  const uint32_t* wsp = ws + (long long)p * K * N;

  uint32_t acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0u;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tiles: BM x BK, k fastest across threads (coalesced rows)
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK;
      const int c = e % BK;
      const long long gm = m0 + r;
      const int gk = k0 + c;
      const bool in = gm < M && gk < K;
      xs[c][r] = in ? xp[gm * K + gk] : 0u;
      xns[c][r] = in ? xnp[gm * K + gk] : 0u;
    }
    // weight tiles: BK x BN, n fastest across threads
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int r = e / BN;
      const int c = e % BN;
      const int gk = k0 + r;
      const int gn = n0 + c;
      const bool in = gk < K && gn < N;
      wfs[r][c] = in ? wfp[(long long)gk * N + gn] : 0u;
      wss[r][c] = in ? wsp[(long long)gk * N + gn] : 0u;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      uint32_t a[TM], an[TM], b[TN], bn[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        a[i] = xs[kk][ty + 16 * i];
        an[i] = xns[kk][ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        b[j] = wfs[kk][tx + 16 * j];
        bn[j] = wss[kk][tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * b[j] + an[i] * bn[j];
    }
    __syncthreads();
  }

  uint32_t* zp = z + (long long)p * M * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N) zp[gm * N + gn] = acc[i][j];
    }
  }
}

}  // namespace

// x: (S, M, K), wf / ws: (S, K, N), z: (S, M, N) contiguous 32-bit words;
// wt: (S, 2, 4, Np, Kp) int8, the K-major limbs of wf and ws.  tensor_core
// selects the route; per_split is the K stages of a split-K block.
extern "C" int rss_matmul_launch(const void* x, const void* wf, const void* ws,
                                 const void* wt, void* z, int S, long long M,
                                 int K, int N, int Kp, int Np,
                                 int tensor_core, int per_split,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (tensor_core)
    return limb_mma::launch<2, 4>(x, wt, z, S, M, K, N, Kp, Np,
                                  2LL * 4 * Np * Kp, per_split, st);
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN),
            (unsigned)S);
  rss_matmul_kernel<<<grid, THREADS, 0, st>>>(
      (const uint32_t*)x, (const uint32_t*)wf, (const uint32_t*)ws,
      (uint32_t*)z, S, M, K, N);
  return (int)cudaGetLastError();
}
