// One ring product C = A · B mod 2^32 (Hopper, sm_90a).
//
// Replaces the TPU kernel repro/kernels/ring_matmul.py::_ring_matmul_kernel
// (pallas_call in ring_matmul_impl).  It is the per-dot route of the linear
// protocols (kernels/ops.py::rss_matmul_dot): one launch for each per-party
// product of a secure layer, 6 per layer under the fused-operand matmul
// mode and 9 under the paper's Algorithm 2.
//
// The TPU kernel split both operands into 4 balanced int8 limbs and ran the
// 10 limb products that survive the modulus, because the MXU has no 32-bit
// integer multiply.  Hopper's CUDA cores do (IMAD), and a 32-bit product
// wraps mod 2^32, so this kernel multiplies the words directly and
// accumulates in uint32_t, whose wrap is the ring arithmetic.
//
// Layout and masking: ring_tile.cuh, the tile loop this kernel shares with
// binary_matmul.cu's bin_weight_matmul (B5 keeps its own entry point and
// launch counter).
//
// What bounds it: at the per-dot shapes the product is shallow (K <= 3136)
// and the bound is bytes (4·(M·K + K·N + M·N) over 3.35 TB/s) or, for the
// deep fc layers, the int8-limb operation count the TPU route needs.  IMAD
// issue and the serial K loop limit this first version, and at M = 32 (the
// fc layers at batch 32) only N / 64 blocks run; split-K would fix that.

#include "ring_tile.cuh"

// a: (M, K), b: (K, N), c: (M, N); contiguous 32-bit words.
extern "C" int ring_matmul_launch(const void* a, const void* b, void* c,
                                  long long M, int K, int N, void* stream) {
  ring_tile::ring_tile_kernel<uint32_t>
      <<<ring_tile::tile_grid(M, N), ring_tile::THREADS, 0,
         (cudaStream_t)stream>>>(
          (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)c, M, K, N);
  return (int)cudaGetLastError();
}
