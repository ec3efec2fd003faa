// Public-weight grouped (depthwise) product for every held share slot
// (Hopper, sm_90a).
//
// Replaces the TPU kernel
// repro/kernels/bin_rss_matmul.py::_make_grouped_public_kernel
// (pallas_call in _grouped_public_call).  Per share slot s and channel c:
//
//     z_s[c] = x_s[c] · W[c]      (mod 2^32)
//
// with x_s[c] an (M, K) patch matrix (K = kh·kw <= 25) and W[c] the public
// (K, N) slab (N = 1: depthwise multiplier 1).  The TPU kernel decomposed
// the words into int8 limbs (adaptive L for the public side) for its MXU;
// here each thread owns one (slot, channel, m) output row and runs a K loop
// of 32-bit IMADs, accumulating in uint32_t (wrap = ring arithmetic).
// Tensor-core tiles would be mostly padding at K <= 25, N = 1.
//
// What bounds it: bytes.  Every x word is read once and used for one
// multiply-add, so the floor is the x read (plus the z write and the small
// W slab) over 3.35 TB/s.  The design keeps it there: the public slab
// (C·K·N words, a few KB) is staged once per block in shared memory and
// serves every channel of the block; x is read through its own strides, so
// the secure path hands the kernel the im2col output in its natural
// (S, M, K, C) layout as an (S, C, M, K) view and no transpose is ever
// materialised (the TPU path's _fold_grouped); when the channel axis is
// the contiguous one, neighbouring threads take neighbouring channels and
// every x load and z store is coalesced.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;

__global__ void __launch_bounds__(THREADS)
bin_grouped_matmul_kernel(const uint32_t* __restrict__ x,
                          const uint32_t* __restrict__ w,
                          uint32_t* __restrict__ z,
                          int C, long long M, int K, int N,
                          long long sxs, long long sxc, long long sxm,
                          long long sxk, long long szs, long long szc,
                          long long szm, long long szn) {
  extern __shared__ uint32_t wsh[];  // the public slab, (C, K, N)
  const int s = blockIdx.y;
  const int ckn = C * K * N;
  for (int e = threadIdx.x; e < ckn; e += blockDim.x) wsh[e] = w[e];
  __syncthreads();

  const bool c_fast = sxc <= sxm;  // channel-contiguous layout
  const long long total = M * C;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    int c;
    long long m;
    if (c_fast) {
      c = (int)(t % C);
      m = t / C;
    } else {
      m = t % M;
      c = (int)(t / M);
    }
    const uint32_t* xo = x + s * sxs + c * sxc + m * sxm;
    const uint32_t* wc = wsh + c * K * N;
    uint32_t* zo = z + s * szs + c * szc + m * szm;
    for (int n = 0; n < N; ++n) {
      uint32_t acc = 0u;
      for (int k = 0; k < K; ++k) acc += xo[k * sxk] * wc[k * N + n];
      zo[n * szn] = acc;
    }
  }
}

}  // namespace

// x: (S, C, M, K) with element strides sx*; w: contiguous (C, K, N);
// z: (S, C, M, N) with element strides sz*.  Shared memory: 4·C·K·N bytes
// (the wrapper keeps it within the 48 KB default).
extern "C" int bin_grouped_matmul_launch(
    const void* x, const void* w, void* z, int S, int C, long long M, int K,
    int N, long long sxs, long long sxc, long long sxm, long long sxk,
    long long szs, long long szc, long long szm, long long szn,
    void* stream) {
  const long long total = M * C;
  long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  dim3 grid((unsigned)blocks, (unsigned)S);
  const size_t smem = (size_t)C * K * N * sizeof(uint32_t);
  bin_grouped_matmul_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)w, (uint32_t*)z, C, M, K, N, sxs,
      sxc, sxm, sxk, szs, szc, szm, szn);
  return (int)cudaGetLastError();
}
