// Causal GQA flash attention (Hopper, sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_flash_kernel
// (pallas_call in flash_attention).  It is the flash_impl of the LM prefill
// step (kernels/ops.py::flash_attention_op): one launch per attention layer.
//
// q (B, S, H, hd), k/v (B, S, Hkv, hd), float32 or bfloat16, read through
// their strides (the last dim contiguous); out (B, S, H, hd) contiguous, in
// q's dtype.  All arithmetic is float32.
//
// Design: one block per (q tile of BQ rows, head, batch), one thread per
// query row.  A thread keeps its scaled query row, the running max m, sum
// l and output accumulator of the online softmax in registers (the
// Pallas kernel's (m, l, acc) carry); the block walks the K/V tiles up to
// its causal frontier min(S, (tile + 1) * BQ), staging BK keys and values
// at a time in shared memory as float32 (bf16 is converted while staging),
// and ends with acc / max(l, 1e-30).  The score tile never leaves the SM.
// GQA: the kv head is h / (H / Hkv), so K/V are never repeated per q head.
// The ragged last tile is masked, so every S launches (the reference falls
// back to its oracle when S is not a multiple of its tile).  Tiles are
// walked longest first (the last q tile has the most keys).
//
// What bounds it: the work is 4 * B * H * hd * S(S+1)/2 flops; at the
// TinyLlama shape (2, 2048, 32, 4, 64) in bf16 the tensor cores would take
// ~35 us for it.  This first version multiplies on the CUDA cores in
// float32 (two FMAs per shared-memory float4, broadcast across the warp),
// so it is bound by the FP32 pipe and shared-memory issue, far above
// that; wgmma on bf16 tiles is the redesign.  Head widths 32 and 64 are
// instantiated (64 takes 241 registers a thread, no spill); 128 would keep
// 2 x 128 floats per thread and spill, and no path uses it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;   // query rows of a block, one thread each
constexpr int BK = 32;   // keys staged in shared memory at a time

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);   // round to nearest even, as torch's cast
}

template <typename T, int HD>
__global__ void __launch_bounds__(BQ) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int S, int H, int Hkv,
    long long sqb, long long sqs, long long sqh, long long skb,
    long long sks, long long skh, long long svb, long long svs,
    long long svh, float scale) {
  __shared__ __align__(16) float ks[BK][HD];
  __shared__ __align__(16) float vs[BK][HD];
  const int qt = gridDim.x - 1 - blockIdx.x;   // longest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int row = qt * BQ + threadIdx.x;
  const bool valid = row < S;

  float qr[HD], acc[HD];
  const T* qp = q + b * sqb + (long long)(valid ? row : 0) * sqs + h * sqh;
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    qr[d] = valid ? to_f(qp[d]) * scale : 0.f;
    acc[d] = 0.f;
  }
  // The mask constant does not matter under causal masking: key 0 is in
  // every row's first tile, so m is finite from then on, and a masked
  // score (-inf) contributes exp(-inf - m) = 0.  Rows past S (the ragged
  // tile) compute on zeros and are not stored.
  float m = -INFINITY, l = 0.f;

  const int n_keys = min(S, (qt + 1) * BQ);   // causal frontier of the tile
  const T* kb = k + b * skb + hk * skh;
  const T* vb = v + b * svb + hk * svh;
  for (int k0 = 0; k0 < n_keys; k0 += BK) {
    __syncthreads();   // the previous tile's readers are done
    for (int idx = threadIdx.x; idx < BK * HD; idx += BQ) {
      const int j = idx / HD, d = idx % HD;
      const int key = k0 + j;
      ks[j][d] = key < S ? to_f(kb[key * sks + d]) : 0.f;
      vs[j][d] = key < S ? to_f(vb[key * svs + d]) : 0.f;
    }
    __syncthreads();
    float s[BK];
    float m_new = m;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < HD; d += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(&ks[j][d]);
        dot = fmaf(qr[d], kk.x, dot);
        dot = fmaf(qr[d + 1], kk.y, dot);
        dot = fmaf(qr[d + 2], kk.z, dot);
        dot = fmaf(qr[d + 3], kk.w, dot);
      }
      s[j] = (k0 + j <= row) ? dot : -INFINITY;
      m_new = fmaxf(m_new, s[j]);
    }
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = expf(s[j] - m_new);
      l += p;
#pragma unroll
      for (int d = 0; d < HD; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(&vs[j][d]);
        acc[d] = fmaf(p, vv.x, acc[d]);
        acc[d + 1] = fmaf(p, vv.y, acc[d + 1]);
        acc[d + 2] = fmaf(p, vv.z, acc[d + 2]);
        acc[d + 3] = fmaf(p, vv.w, acc[d + 3]);
      }
    }
    m = m_new;
  }
  if (valid) {
    T* op = o + (((long long)b * S + row) * H + h) * HD;
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int d = 0; d < HD; ++d) store(op + d, acc[d] / den);
  }
}

template <typename T, int HD>
void launch(const void* q, const void* k, const void* v, void* o, int B,
            int S, int H, int Hkv, long long sqb, long long sqs,
            long long sqh, long long skb, long long sks, long long skh,
            long long svb, long long svs, long long svh, float scale,
            cudaStream_t stream) {
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_kernel<T, HD><<<grid, BQ, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, S, H, Hkv, sqb, sqs,
      sqh, skb, sks, skh, svb, svs, svh, scale);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; hd in {32, 64}; strides in
// elements of (batch, seq, head) for q, k, v.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int S,
    int H, int Hkv, int hd, int dtype, long long sqb, long long sqs,
    long long sqh, long long skb, long long sks, long long skh,
    long long svb, long long svs, long long svh, float scale,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define FLASH_CASE(T, HD)                                                 \
  launch<T, HD>(q, k, v, o, B, S, H, Hkv, sqb, sqs, sqh, skb, sks, skh,   \
                svb, svs, svh, scale, st)
#define FLASH_DIMS(T)                      \
  switch (hd) {                            \
    case 32: FLASH_CASE(T, 32); break;     \
    case 64: FLASH_CASE(T, 64); break;     \
    default: return (int)cudaErrorInvalidValue; \
  }
  if (dtype == 0) {
    FLASH_DIMS(float)
  } else if (dtype == 1) {
    FLASH_DIMS(__nv_bfloat16)
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef FLASH_DIMS
#undef FLASH_CASE
  return (int)cudaGetLastError();
}
