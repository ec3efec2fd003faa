// One ring product C = A · B mod 2^32 (Hopper, sm_90a).
//
// Replaces the TPU kernel repro/kernels/ring_matmul.py::_ring_matmul_kernel
// (pallas_call in ring_matmul_impl).  It is the per-dot route of the linear
// protocols (kernels/ops.py::rss_matmul_dot): one launch for each per-party
// product of a secure layer, 6 per layer under the fused-operand matmul
// mode and 9 under the paper's Algorithm 2.
//
// The TPU kernel split both operands into 4 balanced int8 limbs per call
// and ran the 10 limb products that survive the modulus.  Two routes here,
// chosen by shape in the wrapper (kernels/limbs.py::limb_mma_plan), never
// as a fallback:
//
//  * tensor cores (K > 16): B3's limb_mma.cuh instantiation <1, 4> with
//    one slot.  x's four bytes are its unsigned limbs, split in registers
//    by limb_mma.cuh; b is split per call by split_limbs_kernel below into
//    its four balanced int8 limbs, K-major and 128-padded (the layout of
//    PublicWeightLimbs.wt), in one pass over b.  The 10 pairs with
//    p + q <= 3 are u8 x s8 wgmma; split-K by int32 atomics where the
//    tiles leave SMs idle (the M = 32 fc layers).
//  * CUDA cores (K <= 16, where a k32 step would be mostly padding):
//    ring_tile.cuh's IMAD tile loop, the words multiplied directly (the
//    kernel's first design, which chip_smoke.py also times at every shape
//    beside the other route).
//
// The split.  A balanced limb is a byte of w + 0x80808080 minus 128: adding
// 128 to every byte turns the digits in [-128, 127] into bytes in [0, 255],
// and the carries between the bytes are the balanced carries.  So the
// limbs are the bytes of (w + 0x80808080) ^ 0x80808080, read as int8; the
// padding (w = 0) splits to zero limbs.  One block transposes a 64 x 64
// word tile of b through shared memory and writes each limb plane's 64-byte
// K runs as 4-byte stores.
//
// What bounds it: at MnistNet4's shapes, bytes (4·(M·K + K·N + M·N) over
// 3.35 TB/s; the limb planes, K·N bytes a plane, are written and read back
// once more, mostly through L2).
//
// The batched entry (ring_matmul_batched_launch): Bt independent products
// (Bt, M, K) x (Bt, K, N) -> (Bt, M, N), the secure attention's share x
// share products batched over (party, head), in one split pass and one
// product launch for the whole batch.  limb_mma.cuh's slot axis carries the
// batch as it is: with one operand (OPS = 1) slot s multiplies x_s by its
// own weight limbs at s · w_slot_stride, so each product is a slot whose
// limb planes the split pass writes at z · 4 · Np · Kp (grid z = the
// product).  The CUDA-core route takes the batch on grid z as well.  At the
// secure decode step's shapes (M = 1, K and N of 16-128) every product is
// one or two tiles: the launch floor and the 64-row tile's padding bound
// it, not the bytes.

#include "limb_mma.cuh"
#include "ring_tile.cuh"

namespace {

constexpr int SPLIT_T = 64;        // a split block's tile: 64 k x 64 n
constexpr int SPLIT_THREADS = 256;

// b (K, N) 32-bit words -> wt (4, Np, Kp) int8, wt[p][n][k] = limb p of
// b[k][n], zero past K and N; grid z walks a batch of such pairs, b at
// z · K · N words and wt at z · 4 planes
__global__ void __launch_bounds__(SPLIT_THREADS)
split_limbs_kernel(const uint32_t* __restrict__ b, uint32_t* __restrict__ wt,
                   int K, int N, int Kp, long long plane) {
  __shared__ uint32_t v[SPLIT_T][SPLIT_T + 1];   // [n][k], split words
  b += (long long)blockIdx.z * K * N;
  wt += (long long)blockIdx.z * plane;           // 4 planes of plane bytes
  const int k0 = blockIdx.x * SPLIT_T, n0 = blockIdx.y * SPLIT_T;
  const int tid = threadIdx.x;
#pragma unroll
  for (int j = 0; j < SPLIT_T * SPLIT_T / SPLIT_THREADS; ++j) {
    const int e = tid + j * SPLIT_THREADS;
    const int kk = e / SPLIT_T, nn = e % SPLIT_T;   // n fastest: coalesced
    const int gk = k0 + kk, gn = n0 + nn;
    const uint32_t w = (gk < K && gn < N) ? b[(long long)gk * N + gn] : 0u;
    v[nn][kk] = (w + 0x80808080u) ^ 0x80808080u;
  }
  __syncthreads();
  // each thread: 4 consecutive k of one n -> one 4-byte word a limb plane
#pragma unroll
  for (int j = 0; j < SPLIT_T * SPLIT_T / 4 / SPLIT_THREADS; ++j) {
    const int e = tid + j * SPLIT_THREADS;
    const int nn = e / (SPLIT_T / 4), g = e % (SPLIT_T / 4);
    const uint4 q = make_uint4(v[nn][4 * g], v[nn][4 * g + 1],
                               v[nn][4 * g + 2], v[nn][4 * g + 3]);
    uint32_t a[4][4];
    limb_mma::split_limbs(q, a, 0);
    const long long off = ((long long)(n0 + nn) * Kp + k0 + 4 * g) / 4;
#pragma unroll
    for (int p = 0; p < 4; ++p) wt[p * (plane / 4) + off] = a[p][0];
  }
}

}  // namespace

// a: (M, K), b: (K, N), c: (M, N) contiguous 32-bit words; wt: (4, Np, Kp)
// int8 scratch (Kp, Np multiples of 128, >= K, N).  route 0: split b into
// wt, then the tensor-core product with per_split K stages a split-K
// block; 1: the CUDA-core product (wt unused); 2: the split alone.
extern "C" int ring_matmul_launch(const void* a, const void* b, void* wt,
                                  void* c, long long M, int K, int N, int Kp,
                                  int Np, int route, int per_split,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (route == 1) {
    ring_tile::ring_tile_kernel<uint32_t>
        <<<ring_tile::tile_grid(M, N), ring_tile::THREADS, 0, st>>>(
            (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)c, M, K, N);
    return (int)cudaGetLastError();
  }
  if (route != 0 && route != 2) return (int)cudaErrorInvalidValue;
  if (Kp % 128 || Np % 128 || Kp < K || Np < N)
    return (int)cudaErrorInvalidValue;
  split_limbs_kernel<<<dim3(Kp / SPLIT_T, Np / SPLIT_T), SPLIT_THREADS, 0,
                       st>>>((const uint32_t*)b, (uint32_t*)wt, K, N, Kp,
                             (long long)Np * Kp);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || route == 2) return (int)e;
  return limb_mma::launch<1, 4>(a, wt, c, 1, M, K, N, Kp, Np, 0, per_split,
                                st);
}

// The batched entry: a (Bt, M, K), b (Bt, K, N), c (Bt, M, N) contiguous
// 32-bit words; wt (Bt, 4, Np, Kp) int8 scratch.  Routes as above: 0 splits
// every b into wt, then one tensor-core launch over all Bt products (a slot
// each); 1 the CUDA-core product on grid z; 2 the split alone.
extern "C" int ring_matmul_batched_launch(const void* a, const void* b,
                                          void* wt, void* c, int Bt,
                                          long long M, int K, int N, int Kp,
                                          int Np, int route, int per_split,
                                          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (Bt < 1 || Bt > 65535) return (int)cudaErrorInvalidValue;
  if (route == 1) {
    ring_tile::ring_tile_kernel<uint32_t>
        <<<ring_tile::tile_grid(M, N, Bt), ring_tile::THREADS, 0, st>>>(
            (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)c, M, K, N);
    return (int)cudaGetLastError();
  }
  if (route != 0 && route != 2) return (int)cudaErrorInvalidValue;
  if (Kp % 128 || Np % 128 || Kp < K || Np < N)
    return (int)cudaErrorInvalidValue;
  const long long plane = (long long)Np * Kp;
  split_limbs_kernel<<<dim3(Kp / SPLIT_T, Np / SPLIT_T, Bt), SPLIT_THREADS,
                       0, st>>>((const uint32_t*)b, (uint32_t*)wt, K, N, Kp,
                                plane);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || route == 2) return (int)e;
  return limb_mma::launch<1, 4>(a, wt, c, Bt, M, K, N, Kp, Np, 4 * plane,
                                per_split, st);
}
