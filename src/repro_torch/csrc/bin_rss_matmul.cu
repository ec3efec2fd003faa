// Public-weight dense product for every held share slot (Hopper, sm_90a).
//
// Replaces the TPU kernel repro/kernels/bin_rss_matmul.py::_make_bin_kernel
// (pallas_call in _bin_rss_matmul_call).  Under public weights every party
// holds W, so each share slot's product is local:
//
//     z_s = x_s · W      (mod 2^32),   s = 0 .. S-1
//
// Two routes, chosen by shape in the wrapper (kernels/limbs.py::
// limb_mma_plan), never as a fallback:
//
//  * tensor cores (K > 16): limb_mma.cuh with one operand, the K-major
//    minimal limbs of W (PublicWeightLimbs.wt, L = n_limbs, 1..4) shared
//    by every slot.  The pairs of x's four unsigned byte limbs with W's L
//    limbs whose shifts stay below 32 bits are u8 x s8 products,
//    Σ_{q<L}(4 − q) wgmma m64n64k32 a k32 step and 64 x 64 tile (7 at
//    the served paths' L = 2); split-K by int32 atomics where the (slot,
//    m, n) tiles leave SMs idle (the M = 32 fc layers) or fill a last wave
//    poorly.
//  * CUDA cores (K <= 16, where a k32 step would be mostly padding): the
//    32-bit encoding multiplied with IMAD and accumulated in uint32_t.  One
//    block per (64-row, BN-col) output tile computes that tile for ALL S
//    slots, staging each W tile once; a K loop stages 16-deep tiles of
//    every slot's x and of W; each of the 256 threads owns a 4 x TN block
//    of outputs per slot, strided by 16 so shared-memory reads are
//    conflict-free or broadcast.  BN is 16, 32 or 64: the caller's (the
//    autotuner's launch choice), or by N when it passes 0.
//
// Ragged M/K/N edges are masked (the limb cache is padded instead): every
// shape runs.
//
// What bounds it: bytes.  Each x word is read once and the contraction is
// shallow, so the floor is 4·S·M·K + L·K·N + 4·S·M·N bytes (x, the limbs,
// z) over 3.35 TB/s.

#include "limb_mma.cuh"

namespace {

constexpr int MAX_S = 3;
constexpr int BM = 64;
constexpr int BK = 16;
constexpr int TM = 4;   // outputs per thread along M (stride 16)
constexpr int THREADS = 256;

template <int TN>
__global__ void __launch_bounds__(THREADS)
bin_rss_matmul_kernel(const uint32_t* __restrict__ x,
                      const uint32_t* __restrict__ w,
                      uint32_t* __restrict__ z,
                      int S, long long M, int K, int N) {
  constexpr int BN = 16 * TN;
  // +1 column: the transposed x stores spread over the banks
  __shared__ uint32_t xs[MAX_S][BK][BM + 1];
  __shared__ uint32_t wsh[BK][BN];

  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  uint32_t acc[MAX_S][TM][TN];
#pragma unroll
  for (int s = 0; s < MAX_S; ++s)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[s][i][j] = 0u;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tiles of every slot: BM x BK each, k fastest across threads
    for (int e = tid; e < S * BM * BK; e += THREADS) {
      const int s = e / (BM * BK);
      const int r = (e / BK) % BM;
      const int c = e % BK;
      const long long gm = m0 + r;
      const int gk = k0 + c;
      xs[s][c][r] = (gm < M && gk < K) ? x[((long long)s * M + gm) * K + gk]
                                       : 0u;
    }
    // the public weight tile, once for all slots: BK x BN, n fastest
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int r = e / BN;
      const int c = e % BN;
      const int gk = k0 + r;
      const int gn = n0 + c;
      wsh[r][c] = (gk < K && gn < N) ? w[(long long)gk * N + gn] : 0u;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      uint32_t b[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = wsh[kk][tx + 16 * j];
#pragma unroll
      for (int s = 0; s < MAX_S; ++s) {
        if (s < S) {
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const uint32_t a = xs[s][kk][ty + 16 * i];
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[s][i][j] += a * b[j];
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int s = 0; s < MAX_S; ++s) {
    if (s >= S) break;
    uint32_t* zs = z + (long long)s * M * N;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const long long gm = m0 + ty + 16 * i;
      if (gm >= M) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int gn = n0 + tx + 16 * j;
        if (gn < N) zs[gm * N + gn] = acc[s][i][j];
      }
    }
  }
}

template <int TN>
int launch(const void* x, const void* w, void* z, int S, long long M, int K,
           int N, cudaStream_t stream) {
  constexpr int BN = 16 * TN;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN));
  bin_rss_matmul_kernel<TN><<<grid, THREADS, 0, stream>>>(
      (const uint32_t*)x, (const uint32_t*)w, (uint32_t*)z, S, M, K, N);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (S, M, K) contiguous, S <= 3; w: (K, N) contiguous; z: (S, M, N)
// contiguous; 32-bit words.  wt: (L, Np, Kp) int8, the K-major limbs of w.
// tensor_core selects the route; per_split is the K stages of a split-K
// block; bn the CUDA-core route's tile width (16, 32, 64; 0: by N).
extern "C" int bin_rss_matmul_launch(const void* x, const void* w,
                                     const void* wt, void* z, int S,
                                     long long M, int K, int N, int Kp,
                                     int Np, int L, int tensor_core,
                                     int per_split, int bn, void* stream) {
  if (S < 1 || S > MAX_S) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (tensor_core) {
    switch (L) {
      case 1: return limb_mma::launch<1, 1>(x, wt, z, S, M, K, N, Kp, Np, 0,
                                            per_split, st);
      case 2: return limb_mma::launch<1, 2>(x, wt, z, S, M, K, N, Kp, Np, 0,
                                            per_split, st);
      case 3: return limb_mma::launch<1, 3>(x, wt, z, S, M, K, N, Kp, Np, 0,
                                            per_split, st);
      case 4: return limb_mma::launch<1, 4>(x, wt, z, S, M, K, N, Kp, Np, 0,
                                            per_split, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (bn == 0) bn = N <= 16 ? 16 : N <= 32 ? 32 : 64;
  switch (bn) {
    case 16: return launch<1>(x, w, z, S, M, K, N, st);
    case 32: return launch<2>(x, w, z, S, M, K, N, st);
    case 64: return launch<4>(x, w, z, S, M, K, N, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
